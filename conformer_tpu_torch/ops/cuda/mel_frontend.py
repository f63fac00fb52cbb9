"""Fused log-mel frontend (frame + window + DFT + power + mel + log), kernel K3.

Counterpart of ``conformer_tpu/ops/pallas/mel_frontend.py``. ``logmel_fwd`` is
the kernel wrapper: a CPU tensor takes the plain PyTorch version
``logmel_plain``; a CUDA tensor launches the hand-written kernel in
``csrc/mel_frontend.cu`` (which says what bounds it on the H100) or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conformer_tpu_torch.ops.cuda import build


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


def logmel_fwd(padded_audio: torch.Tensor, dft: torch.Tensor,
               fb: torch.Tensor, hop: int, n_fft: int, n_frames: int,
               clamp: float = 1e-5) -> torch.Tensor:
    """Kernel wrapper: same arguments and result as logmel_plain. CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in ``logmel_fwd.launches``) or raise."""
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
    out = torch.empty((b, n_frames, n_mels), dtype=torch.float32, device=dev)
    lib = build.load("mel_frontend")
    fn = lib.logmel_fwd
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(padded_audio.data_ptr(), b, s_pad, dft.data_ptr(),
                 fb.data_ptr(), out.data_ptr(), n_frames, hop, n_fft, n_bins,
                 n_mels, clamp, stream)
    build.check(lib, "mel_frontend", err)
    logmel_fwd.launches += 1
    return out


logmel_fwd.launches = 0
