"""Fused log-mel frontend (frame + window + DFT + power + mel + log), kernel K3.

Counterpart of ``conformer_tpu/ops/pallas/mel_frontend.py``. ``logmel_fwd`` is
the kernel wrapper: a CPU tensor takes the plain PyTorch version
``logmel_plain``; a CUDA tensor launches the hand-written kernel in
``csrc/mel_frontend.cu`` (which says what bounds it on the H100) or raises.
The kernel runs both products in 3xTF32 on the tensor cores; its operands,
the DFT matrix and the filterbank split into TF32 hi and lo parts and packed
in the kernel's fragment order, are built once by ``k3_operands`` (the
frontend does it when it is built). ``logmel_fwd_op`` is the custom op
``conformer_tpu_torch::logmel_fwd`` (``torch.library``: the wrapper on the
card, the plain version on the CPU) that the frontend calls, so that
``torch.export`` keeps the kernel as a node of the graph.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from conformer_tpu_torch.ops.cuda import build

BINS_PER_CHUNK = 16   # 4 DFT n-tiles of 8 interleaved [re | im] columns
STEP_PAD = 10         # the k-steps are padded to a multiple of this, which
                      # every ring stage of the kernel's tilings divides


def logmel_plain(padded_audio: torch.Tensor, dft: torch.Tensor,
                 fb: torch.Tensor, hop: int, n_fft: int, n_frames: int,
                 clamp: float = 1e-5) -> torch.Tensor:
    """padded_audio (B, S_pad) reflect-padded fp32 -> (B, n_frames, n_mels).
    Frame t is padded_audio[:, t*hop : t*hop + n_fft], zeros past the end."""
    need = (n_frames - 1) * hop + n_fft
    if padded_audio.shape[-1] < need:
        padded_audio = torch.nn.functional.pad(
            padded_audio, (0, need - padded_audio.shape[-1]))
    frames = padded_audio.unfold(-1, n_fft, hop)[:, :n_frames]
    proj = frames @ dft
    n_bins = dft.shape[1] // 2
    re, im = proj[..., :n_bins], proj[..., n_bins:]
    mel = (re * re + im * im) @ fb
    return torch.log(torch.clamp(mel, min=clamp))


def split_tf32(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """fp32 x -> (hi, lo), each a TF32 value (10 mantissa bits) in fp32:
    hi = x rounded to nearest, ties away from zero (``cvt.rna.tf32.f32``),
    lo = x - hi (exact in fp32) rounded the same way."""
    def rna(a: np.ndarray) -> np.ndarray:
        bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    hi = rna(x)
    return hi, rna(np.asarray(x, np.float32) - hi)


class K3Operands(NamedTuple):
    """The kernel's operands: ``dft`` (n_chunks, s_pad, 4, 32, 4) and ``fb``
    (2 * n_chunks, n_mel_tiles, 32, 4) fp32, each lane's (b0_hi, b1_hi,
    b0_lo, b1_lo) of an m16n8k8 B fragment; ``n_steps`` real 8-sample
    k-steps of ``s_pad``."""
    dft: torch.Tensor
    fb: torch.Tensor
    n_steps: int
    s_pad: int
    n_chunks: int
    n_mel_tiles: int


def _fragments(w: np.ndarray) -> np.ndarray:
    """(steps, 8 depth, tiles, 8 columns) -> (steps, tiles, 32 lanes, 4):
    lane 4g + t takes (hi, lo) of depth t and t + 4 at column g."""
    hi, lo = split_tf32(w)
    parts = [x[:, rows] for x in (hi, lo) for rows in (slice(0, 4), slice(4, 8))]
    # each (steps, t, tiles, g) -> (steps, tiles, g, t)
    b0h, b1h, b0l, b1l = (p.transpose(0, 2, 3, 1) for p in parts)
    frag = np.stack([b0h, b1h, b0l, b1l], axis=-1)
    return frag.reshape(w.shape[0], w.shape[2], 32, 4)


def k3_operands(dft: torch.Tensor, fb: torch.Tensor, hop: int,
                n_fft: int) -> K3Operands:
    """Split the (n_fft, 2*n_bins) DFT matrix and the (n_bins, n_mels)
    filterbank into TF32 hi and lo parts and pack them in K3's fragment
    order, on the tensors' device.

    The DFT's k-steps follow the audio's hop rows: row i of a frame (its
    samples i*hop ..) takes ceil(hop / 8) steps and the remainder n_fft %
    hop its own, each step's samples past its row zero, so a step never
    crosses a row; the steps are padded to a multiple of STEP_PAD.
    Its columns are interleaved per bin, [re_k | im_k], and padded to
    chunks of BINS_PER_CHUNK bins; the filterbank's rows are padded alike
    and its columns to 10 (n_mels <= 80) or 16 (<= 128) tiles of 8."""
    d = dft.detach().cpu().numpy().astype(np.float32)
    f = fb.detach().cpu().numpy().astype(np.float32)
    n_bins, n_mels = f.shape
    if d.shape != (n_fft, 2 * n_bins):
        raise ValueError(f"dft must be ({n_fft}, {2 * n_bins}), got {d.shape}")
    if n_mels > 128:
        raise ValueError(f"K3 takes at most 128 mels, got {n_mels}")
    n_mel_tiles = 10 if n_mels <= 80 else 16
    spr = -(-hop // 8)
    whole, rem = divmod(n_fft, hop)
    n_steps = whole * spr + -(-rem // 8)
    s_pad = -(-n_steps // STEP_PAD) * STEP_PAD
    n_chunks = -(-n_bins // BINS_PER_CHUNK)

    step = np.arange(s_pad)[:, None]
    row, col = step // spr, (step % spr) * 8 + np.arange(8)[None, :]
    valid = (step < n_steps) & (col < np.where(row < whole, hop, rem))
    sample = np.where(valid, row * hop + col, 0)           # (s_pad, 8)
    cols = np.arange(n_chunks * 2 * BINS_PER_CHUNK)        # interleaved
    bins, imag = cols // 2, cols % 2
    src = np.where(bins < n_bins, bins + imag * n_bins, 0)
    w = d[sample[:, :, None], src[None, None, :]]
    w = np.where(valid[:, :, None] & (bins < n_bins)[None, None, :], w, 0.0)
    # (s_pad, 8, chunks * 4 tiles, 8) -> (s_pad, chunks * 4, 32, 4)
    frag = _fragments(w.reshape(s_pad, 8, n_chunks * 4, 8).astype(np.float32))
    frag = frag.reshape(s_pad, n_chunks, 4, 32, 4).transpose(1, 0, 2, 3, 4)

    fbp = np.zeros((n_chunks * BINS_PER_CHUNK, n_mel_tiles * 8), np.float32)
    fbp[:n_bins, :n_mels] = f
    fb_frag = _fragments(fbp.reshape(2 * n_chunks, 8, n_mel_tiles, 8))
    dev = dft.device
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return K3Operands(as_t(frag), as_t(fb_frag), int(n_steps), int(s_pad),
                      int(n_chunks), n_mel_tiles)


def logmel_fwd(padded_audio: torch.Tensor, dft: torch.Tensor,
               fb: torch.Tensor, hop: int, n_fft: int, n_frames: int,
               clamp: float = 1e-5,
               operands: Optional[K3Operands] = None) -> torch.Tensor:
    """Kernel wrapper: the arguments and result of logmel_plain, and on a
    CUDA tensor ``operands``, ``k3_operands(dft, fb, hop, n_fft)`` built
    once by the caller. CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``logmel_fwd.launches``) or raise."""
    if padded_audio.device.type == "cpu":
        return logmel_plain(padded_audio, dft, fb, hop, n_fft, n_frames, clamp)
    if padded_audio.device.type != "cuda":
        raise ValueError(f"no kernel for device {padded_audio.device}")
    b, s_pad = padded_audio.shape
    n_bins, n_mels = fb.shape
    dev = padded_audio.device
    for name, x, shape in (("padded_audio", padded_audio, (b, s_pad)),
                           ("dft", dft, (n_fft, 2 * n_bins)),
                           ("fb", fb, (n_bins, n_mels))):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous with shape {shape}, "
                             f"got {tuple(x.shape)}")
    if operands is None:
        raise ValueError("K3 needs its operands: pass operands=k3_operands("
                         "dft, fb, hop, n_fft), built once")
    ops = operands
    if ops.dft.device != dev or ops.fb.device != dev:
        raise ValueError(f"K3 operands must be on {dev}")
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=dev)
    lib = build.load("mel_frontend")
    layout = (ctypes.c_int * 2)()
    lib.logmel_layout(layout)
    if layout[0] != BINS_PER_CHUNK or ops.s_pad % layout[1]:
        raise RuntimeError(f"K3's operands (chunks of {BINS_PER_CHUNK} bins, "
                           f"{ops.s_pad} k-steps) do not fit its kernel's "
                           f"layout {tuple(layout)}")
    fn = lib.logmel_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(padded_audio.data_ptr(), b, s_pad, ops.dft.data_ptr(),
                 ops.fb.data_ptr(), out.data_ptr(), n_frames, hop, n_fft,
                 ops.n_steps, ops.s_pad, ops.n_chunks, n_mels,
                 ops.n_mel_tiles, clamp, stream)
    build.check(lib, "mel_frontend", err)
    build.count(logmel_fwd, "launches")
    return out


logmel_fwd.launches = 0


@torch.library.custom_op("conformer_tpu_torch::logmel_fwd", mutates_args=(),
                         device_types="cuda")
def logmel_fwd_op(padded_audio: torch.Tensor, dft: torch.Tensor,
                  fb: torch.Tensor, hop: int, n_fft: int, n_frames: int,
                  clamp: float, op_dft: torch.Tensor, op_fb: torch.Tensor,
                  n_steps: int, s_pad: int, n_chunks: int,
                  n_mel_tiles: int) -> torch.Tensor:
    """K3 as a custom op, its operands (K3Operands) spelled out: the
    wrapper, looked up when called, so that patching this module's name
    reroutes it."""
    return logmel_fwd(padded_audio, dft, fb, hop, n_fft, n_frames, clamp,
                      operands=K3Operands(op_dft, op_fb, n_steps, s_pad,
                                          n_chunks, n_mel_tiles))


@logmel_fwd_op.register_kernel("cpu")
def _(padded_audio, dft, fb, hop, n_fft, n_frames, clamp, *operands):
    return logmel_plain(padded_audio, dft, fb, hop, n_fft, n_frames, clamp)


@logmel_fwd_op.register_fake
def _(padded_audio, dft, fb, hop, n_fft, n_frames, clamp, *operands):
    return padded_audio.new_empty((padded_audio.shape[0], n_frames,
                                   fb.shape[1]))
