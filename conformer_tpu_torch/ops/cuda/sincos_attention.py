"""Fused shift-free relative-position attention: forward K1 (with its
in-kernel dropout mask K1-drop) and backward K2.

Counterpart of ``conformer_tpu/ops/pallas/sincos_attention.py``. The
Transformer-XL position score ``qv_i . p(i - j)`` is rewritten with the
angle-addition identity as ``alpha_i . cos(j w) + beta_i . sin(j w)``, where
``a_i = qv_i . W_h`` and alpha/beta mix a's sin and cos halves with the query
row's sin/cos: two products against constant (L, D/2) tables instead of a
(B, H, L, 2L-1) score tensor and a rel-shift.

Kernel wrappers, each with a plain PyTorch version of the same signature:

- ``sincos_attention_fwd`` (K1, ``csrc/sincos_attention.cu``): the output
  and, for the backward, each query row's softmax max and sum;
- ``sincos_attention_bwd`` (K2, ``csrc/sincos_attention_bwd.cu``): dqu, dqv,
  dk, dv and the gradient of the per-head position operand.

Each has two kernels, picked by ``attention_variant`` from (dtype, H, dh,
D): "wgmma", the bf16 Hopper kernels at dh 64 with D/2 a multiple of 64 and
D <= 512 (production width), and "general", mma.sync kernels for every
other shape the JAX kernels take (any head width up to 128, odd head
counts, D > 512) and for fp32 (3xTF32). ``general_geometry`` mirrors the
general kernels' tiling and scratch on the host. A CPU tensor takes the
plain version; a CUDA tensor launches one of the two kernels or raises,
never the plain version. ``rel_attention_sincos_packed`` is the public
entry: under autograd it runs both through one ``torch.autograd.Function``,
otherwise (serving, ``torch.inference_mode``) just the forward, through the
custom op ``conformer_tpu_torch::sincos_attention_fwd`` (``torch.library``:
the wrapper on the card, the plain version on the CPU), so that
``torch.export`` keeps the kernel as a node of the graph.

Dropout on the probabilities is the JAX kernel's stateless hash
(``_dropout_keep``): the mask of query row i, key j depends on the seed, the
batch row, the head, the JAX q-tile index ``i // tq`` and the row in that
tile ``i % tq``, for the JAX kernel's tile rows ``tq`` (``hash_tq``), so
forward and backward regenerate the same mask and it never exists in device
memory.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from conformer_tpu_torch.models.dropout import M32, finalize, mul32, threshold
from conformer_tpu_torch.ops.cuda import build

NEG_INF = float(np.finfo(np.float32).min)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (d_model, dtype, device) -> the longest (sin, cos) pair built so far; a
# shorter length takes its leading rows, which are the same numbers.
_tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def sincos_tables(length: int, d_model: int, dtype=torch.float32,
                  device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape (length, d_model//2): sin(i*w_k) and
    cos(i*w_k), built in float64 and cast to ``dtype`` (cached)."""
    key = (d_model, dtype, str(device))
    if key not in _tables or _tables[key][0].shape[0] < length:
        if torch.compiler.is_compiling():
            # a table built while tracing would be a traced value, not the
            # constant that the cache and the traced program both need
            raise RuntimeError("sincos_tables: build the tables before "
                               "tracing (one eager forward at this length)")
        inv_freq = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                          * -(np.log(10000.0) / d_model))
        ang = np.arange(length, dtype=np.float64)[:, None] * inv_freq[None, :]
        # normal tensors even when first built while serving, so that a
        # later training step may save them for its backward
        with torch.inference_mode(False):
            _tables[key] = tuple(torch.from_numpy(f(ang)).to(device=device,
                                                             dtype=dtype)
                                 for f in (np.sin, np.cos))
    sin_t, cos_t = _tables[key]
    return sin_t[:length], cos_t[:length]


def prep_pos_kernel(pos_kernel: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(D, H * dh) position-projection kernel (flax (in, out) layout; a
    rank's heads under a mesh) -> (H, dh, D) per-head operand with the
    embedding axis permuted to [sin coefficients (D/2) | cos coefficients
    (D/2)]. Differentiable, so the operand's gradient flows back to the
    kernel."""
    d = pos_kernel.shape[0]
    dh = pos_kernel.shape[1] // n_heads
    wh = pos_kernel.reshape(d, n_heads, dh).permute(1, 2, 0)
    dev = pos_kernel.device
    perm = torch.cat([torch.arange(0, d, 2, device=dev),
                      torch.arange(1, d, 2, device=dev)])
    return wh[:, :, perm].contiguous()


def auto_tq(l: int) -> int:
    """The JAX kernel's default q-tile rows: the padded length when it fits
    256, else 128 (``_auto_tq``)."""
    l_pad = ((l + 127) // 128) * 128
    return l_pad if l_pad <= 256 else 128


def hash_tq(l: int, tq: Optional[int] = None) -> int:
    """The q-tile rows the JAX kernel hashes with for length ``l``:
    ``min(tq or auto, round_up(l, 8))``."""
    return min(tq or auto_tq(l), ((l + 7) // 8) * 8)


def dropout_keep(seed: int, b: int, h: int, rows: int, cols: int, tq: int,
                 rate: float, device="cpu") -> torch.Tensor:
    """(b, h, rows, cols) keep mask of the attention probabilities, bit for
    bit the JAX kernel's ``_dropout_keep`` over all its q-tiles: element
    (bi, hi, i, j) hashes (seed, bi, hi, i // tq, i % tq, j)."""
    i64 = dict(dtype=torch.int64, device=device)
    bi = torch.arange(b, **i64).view(b, 1, 1, 1)
    hi = torch.arange(h, **i64).view(1, h, 1, 1)
    i = torch.arange(rows, **i64).view(1, 1, rows, 1)
    col = torch.arange(cols, **i64).view(1, 1, 1, cols)
    base = (mul32(torch.tensor(int(seed) & M32, **i64), 0x9E3779B9)
            + mul32(bi, 0x85EBCA6B) + mul32(hi, 0xC2B2AE35)
            + mul32(i // tq, 0x27D4EB2F)) & M32
    x = (base + col + mul32(i % tq, 0x01000193)) & M32
    return finalize(x) >= threshold(rate)


def _split_f32(x: torch.Tensor, h: int) -> torch.Tensor:
    b, l, d = x.shape
    return x.reshape(b, l, h, d // h).transpose(1, 2).float()


def _scores_plain(qu, qv, k, wh, lengths, sin_t, cos_t):
    """-> (masked fp32 scores (B, H, L, L), fp32 sin, cos) as the kernels
    compute them: alpha/beta rounded to the input dtype, masked keys at
    float32.min."""
    b, l, d = qu.shape
    h = wh.shape[0]
    d2 = wh.shape[2] // 2
    dt = qu.dtype
    sq, cq = sin_t.float(), cos_t.float()
    content = _split_f32(qu, h) @ _split_f32(k, h).transpose(-1, -2)
    a = torch.einsum("bhld,hdx->bhlx", _split_f32(qv, h), wh.float())
    a_s, a_c = a[..., :d2], a[..., d2:]
    alpha = (a_s * sq + a_c * cq).to(dt).float()
    beta = (-a_s * cq + a_c * sq).to(dt).float()
    scores = content + alpha @ cq.T + beta @ sq.T
    length = torch.clamp(lengths.to(torch.int64), max=l)
    valid = torch.arange(l, device=qu.device)[None, :] < length[:, None]
    return torch.where(valid[:, None, None, :], scores, NEG_INF), sq, cq


def sincos_attention_plain(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                           rate: float = 0.0, seed: int = 0, tq: int = 0,
                           stats: bool = False):
    """Plain PyTorch version of K1, rounding where it rounds.

    qu/qv/k/v: (B, L, D) packed, head h in columns [h*dh, (h+1)*dh), with the
    score scale already folded into qu/qv; wh: (H, dh, Dp); lengths: (B,)
    int; sin_t/cos_t: (L, Dp/2) in the input dtype (Dp, the position
    width, is D on one device and the whole model's width on a rank that a
    mesh gives H/tp heads); rate/seed/tq: the
    probability dropout (``tq`` 0 = ``hash_tq(L)``). Products take fp32 sums
    of the input-dtype operands; alpha/beta and the (dropped, rescaled)
    probabilities are rounded to the input dtype before their products, and
    the row sum is over the undropped probabilities. -> out (B, L, D), and
    with ``stats`` also (B, H, L, 2) fp32 [row max, row sum]."""
    b, l, d = qu.shape
    h = wh.shape[0]
    dt = v.dtype
    scores, _, _ = _scores_plain(qu, qv, k, wh, lengths, sin_t, cos_t)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    s = e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        keep = dropout_keep(seed, b, h, l, l, tq or hash_tq(l), rate,
                            qu.device)
        e = torch.where(keep, e * (1.0 / (1.0 - rate)), 0.0)
    out = (e.to(dt).float() @ _split_f32(v, h)) * (1.0 / torch.clamp(s, min=1e-9))
    out = out.transpose(1, 2).reshape(b, l, d).to(dt)
    if stats:
        return out, torch.cat([m, s], dim=-1)
    return out


def sincos_attention_bwd_plain(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                               stats, dout, rate: float = 0.0, seed: int = 0,
                               tq: int = 0):
    """Plain PyTorch version of K2, following the JAX ``_bwd_kernel``'s math
    and rounding in whole-row form (``stats`` is not needed: the
    probabilities and delta = sum p * dp are recomputed).
    -> (dqu, dqv, dk, dv) (B, L, D) and dwh (H, dh, Dp), in the input dtype."""
    b, l, d = qu.shape
    h, dh = wh.shape[0], wh.shape[1]
    d2 = wh.shape[2] // 2
    dt = qu.dtype
    scores, sq, cq = _scores_plain(qu, qv, k, wh, lengths, sin_t, cos_t)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-9)
    do = _split_f32(dout, h)
    dov = do @ _split_f32(v, h).transpose(-1, -2)
    if rate > 0.0:
        keep = dropout_keep(seed, b, h, l, l, tq or hash_tq(l), rate,
                            qu.device)
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dov * inv, 0.0)
        p_drop = torch.where(keep, p * inv, 0.0)
    else:
        dp, p_drop = dov, p
    delta = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dv = p_drop.to(dt).float().transpose(-1, -2) @ do
    dqu = ds @ _split_f32(k, h)
    dk = ds.transpose(-1, -2) @ _split_f32(qu, h)
    dalpha, dbeta = ds @ cq, ds @ sq
    da = torch.cat([dalpha * sq - dbeta * cq, dalpha * cq + dbeta * sq],
                   dim=-1).to(dt).float()                    # (B, H, L, Dp)
    dqv = torch.einsum("bhlx,hdx->bhld", da, wh.float())
    dwh = torch.einsum("bhld,bhlx->hdx", _split_f32(qv, h), da)
    pack = lambda x: x.transpose(1, 2).reshape(b, l, d).to(dt)
    return pack(dqu), pack(dqv), pack(dk), pack(dv), dwh.to(dt)


def _check(name: str, x: torch.Tensor, shape, dtype, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


VARIANTS = ("wgmma", "general")
MAX_GENERAL_DH = 128


def attention_variant(dtype, h: int, dh: int, d: int,
                      dp: Optional[int] = None) -> str:
    """The kernel a CUDA call with these shapes launches: "wgmma" (bf16,
    dh 64, Dp/2 a multiple of 64, Dp <= 512) or "general" (fp32, and bf16
    at every other head width up to 128). ``dp``: the position width (wh's
    last axis), D unless a mesh gives the call a rank's heads. Raises for a
    shape no kernel takes: another dtype, h * dh != D, an odd D or Dp (the
    JAX kernels' sin/cos halves need an even width too) or dh past 128."""
    dp = d if dp is None else dp
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if h < 1 or dh < 1 or h * dh != d or d % 2 or dp % 2 or dp < 2:
        raise ValueError(f"kernel needs D = H * dh with D and Dp even, got "
                         f"H={h}, dh={dh}, D={d}, Dp={dp}")
    if dh > MAX_GENERAL_DH:
        raise ValueError(f"kernel takes head widths up to {MAX_GENERAL_DH}, "
                         f"got dh={dh}")
    if (dtype == torch.bfloat16 and dh == 64 and (dp // 2) % 64 == 0
            and dp <= 512):
        return "wgmma"
    return "general"


def _check_common(qu, qv, k, v, wh, lengths, sin_t, cos_t):
    """Shapes, dtypes and layout the kernels take.
    -> (b, l, h, dh, dp, dtype code, variant code)."""
    if qu.device.type != "cuda":
        raise ValueError(f"no kernel for device {qu.device}")
    b, l, d = qu.shape
    h, dh, dp = wh.shape
    variant = attention_variant(qu.dtype, h, dh, d, dp)
    dev, dt = qu.device, qu.dtype
    for name, x in (("qu", qu), ("qv", qv), ("k", k), ("v", v)):
        _check(name, x, (b, l, d), dt, dev)
    _check("wh", wh, (h, dh, dp), dt, dev)
    _check("sin_t", sin_t, (l, dp // 2), dt, dev)
    _check("cos_t", cos_t, (l, dp // 2), dt, dev)
    _check("lengths", lengths, (b,), torch.int32, dev)
    return b, l, h, dh, dp, _DTYPE_CODES[dt], VARIANTS.index(variant)


def _scratch_bytes(lib, name: str, b: int, l: int, h: int, dh: int,
                   dp: int, code: int, variant: int) -> int:
    """The bytes of device scratch the library's ``<name>_scratch_bytes``
    asks for."""
    size = getattr(lib, f"{name}_scratch_bytes")
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 7
    return int(size(b, l, h, dh, dp, code, variant))


# The general kernels' tiling, as csrc/attention_general.cuh computes it.
GENERAL_TK = 64              # keys (or rows) per streamed tile
GENERAL_XW = 32              # alpha | beta columns per prologue step
GENERAL_SMS = 132            # an H100's SMs
GENERAL_SMEM_LIMIT = 232448  # a block's shared memory on sm_90


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _align256(n: int) -> int:
    return _round_up(n, 256)


def general_geometry(dtype, b: int, l: int, h: int, dh: int,
                     dp: Optional[int] = None) -> dict:
    """The general kernels' tiling for these shapes (``dp``: the position
    width, default H * dh), the host's copy of
    ``attn::gen::make_geo``/``query_rows``/``query_stages`` and the
    backward's scratch layout: the padded head and half widths (16), the
    copy width in bytes (the widest of 16, 8, 4 that divides dh and D/2 in
    bytes; 2 for a bf16 shape that none does), the score chunks, the query
    rows per CTA, ring stages and shared memory of the forward
    (``fwd_rows``, ``fwd_stages``, ``fwd_smem``) and of the backward's
    query pass (``bwd_*``; rows 0 = no tile fits), the dwh pass's row
    splits and the backward's scratch bytes."""
    esz = 4 if dtype == torch.float32 else 2
    d = h * dh if dp is None else dp       # the position width
    d2 = d // 2
    pa, pb = 16 // esz, 8
    dhp, d2p = _round_up(dh, 16), _round_up(d2, 16)
    ep = dhp + 2 * d2p
    dvp = next(w for w in (16, 32, 64, 128) if dh <= w) if dh <= 128 else 0
    vb = 16
    while vb > esz and ((dh * esz) % vb or (d2 * esz) % vb):
        vb //= 2
    ss = max(64, dvp) + pa

    def smem(rows: int, stages: int, bwd: bool) -> int:
        tile = rows * (ep + pa) * esz
        if bwd:
            tile += rows * (dvp + pa) * esz + 2 * rows * 4
        ring = stages * GENERAL_TK * ss * esz
        pro = (rows * (dhp + pa) + 4 * dhp * (GENERAL_XW + pb)) * esz
        comb = rows * 2 * (4 + dvp // 2) * 4
        return tile + max(ring, pro, comb)

    def stages_for(rows: int, bwd: bool) -> int:
        return next((st for st in (4, 3)
                     if smem(rows, st, bwd) <= GENERAL_SMEM_LIMIT), 0)

    def rows_for(bwd: bool) -> int:
        rows = 64
        while rows >= 16 and not stages_for(rows, bwd):
            rows //= 2
        if rows < 16:
            return 0
        while rows > 16 and b * h * -(-l // rows) < GENERAL_SMS:
            rows //= 2
        return rows

    geo = {"dhp": dhp, "d2p": d2p, "vec_bytes": vb,
           "chunks": -(-dhp // 64) + 2 * -(-d2p // 64)}
    for key, bwd in (("fwd", False), ("bwd", True)):
        rows = rows_for(bwd)
        stages = stages_for(rows, bwd) if rows else 0
        geo.update({f"{key}_rows": rows, f"{key}_stages": stages,
                    f"{key}_smem": smem(rows, stages, bwd) if rows else 0})
    nqt = -(-l // GENERAL_TK)
    base = -(-d // 64) * h * b
    splits = min(max(1, -(-2 * GENERAL_SMS // base)), nqt)
    lp = _round_up(l, 8)
    geo["dwh_splits"] = splits
    geo["bwd_scratch"] = (2 * _align256(b * h * l * lp * esz)
                          + _align256(b * h * l * d * esz)
                          + _align256(b * splits * h * dh * d * 4))
    return geo


def split_tf32_trunc(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """fp32 x -> (hi, lo) as the general kernels' 3xTF32 products read them
    (``tf32::split_trunc``): hi = x with its low 13 bits cleared, lo =
    x - hi (exact in fp32) with the low 13 bits the tensor cores ignore
    cleared too."""
    mask = np.uint32(0xFFFFE000)
    x = np.ascontiguousarray(x, np.float32)
    hi = (x.view(np.uint32) & mask).view(np.float32)
    lo = ((x - hi).view(np.uint32) & mask).view(np.float32)
    return hi, lo


def library_geometry(dtype, b: int, l: int, h: int, dh: int,
                     dp: Optional[int] = None) -> dict:
    """The same keys of ``general_geometry`` (all but the dwh splits) as
    the built forward library computes them
    (``sincos_attention_general_geometry``) and the backward library's
    scratch bytes: a check on the card that the host's copy is the
    kernels' own."""
    lib = build.load("sincos_attention")
    fn = lib.sincos_attention_general_geometry
    fn.restype = None
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.c_void_p]
    out = (ctypes.c_longlong * 10)()
    code = _DTYPE_CODES[dtype]
    dp = h * dh if dp is None else dp
    fn(b, l, h, dh, dp, code, ctypes.addressof(out))
    keys = ("dhp", "d2p", "vec_bytes", "fwd_rows", "fwd_stages", "fwd_smem",
            "bwd_rows", "bwd_stages", "bwd_smem", "chunks")
    geo = dict(zip(keys, (int(x) for x in out)))
    geo["bwd_scratch"] = _scratch_bytes(
        build.load("sincos_attention_bwd"), "sincos_attention_bwd", b, l, h,
        dh, dp, code, VARIANTS.index("general"))
    return geo


def _check_fits(dtype, b: int, l: int, h: int, dh: int, dp: int,
                variant: int, key: str) -> None:
    """Raise where the general kernel's query tile does not fit in shared
    memory even at 16 rows (Dp past ~3000 in fp32, ~6000 in bf16)."""
    if VARIANTS[variant] == "general" and not general_geometry(
            dtype, b, l, h, dh, dp)[key]:
        raise ValueError(f"no query tile of the general kernel fits for "
                         f"H={h}, dh={dh}, {dtype}")


def _dropout_args(rate: float, seed: int, tq: int, l: int):
    """(threshold, 1/(1-rate) as fp32, seed as uint32, tq) for the kernels;
    rate 0 sends a zero threshold and takes the kernels' no-dropout path."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    if rate == 0.0:
        return 0, 1.0, 0, 1
    return threshold(rate), 1.0 / (1.0 - rate), int(seed) & M32, tq or hash_tq(l)


def sincos_attention_fwd(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                         rate: float = 0.0, seed: int = 0, tq: int = 0,
                         stats: bool = False):
    """Kernel wrapper (K1): same arguments and result as
    sincos_attention_plain. CPU tensors take the plain version; CUDA tensors
    launch the kernel of ``attention_variant`` (counted in
    ``sincos_attention_fwd.launches``, the general one also in
    ``.general_launches`` and, in fp32, ``.general_fp32_launches``) or
    raise."""
    if qu.device.type == "cpu":
        return sincos_attention_plain(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                                      rate, seed, tq, stats)
    b, l, h, dh, dp, code, variant = _check_common(qu, qv, k, v, wh, lengths,
                                                   sin_t, cos_t)
    _check_fits(qu.dtype, b, l, h, dh, dp, variant, "fwd_rows")
    thresh, inv_keep, seed32, tq = _dropout_args(rate, seed, tq, l)
    out = torch.empty_like(qu)
    st = (torch.empty((b, h, l, 2), dtype=torch.float32, device=qu.device)
          if stats else None)
    lib = build.load("sincos_attention")
    fn = lib.sincos_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(qu.device):
        stream = torch.cuda.current_stream(qu.device).cuda_stream
        err = fn(qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(),
                 wh.data_ptr(), sin_t.data_ptr(), cos_t.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(),
                 st.data_ptr() if st is not None else None,
                 None, b, l, h, dh, dp, code, variant,
                 seed32, thresh, inv_keep, tq, stream)
    build.check(lib, "sincos_attention", err)
    counters = ["launches"]
    if VARIANTS[variant] == "general":
        counters += ["general_launches"] + ["general_fp32_launches"] * (code == 0)
    if thresh:
        counters.append("dropout_launches")
    build.count(sincos_attention_fwd, *counters)
    return (out, st) if stats else out


sincos_attention_fwd.launches = 0
sincos_attention_fwd.dropout_launches = 0   # of those, with dropout (K1-drop)
sincos_attention_fwd.general_launches = 0   # of those, the general kernel
sincos_attention_fwd.general_fp32_launches = 0   # ... in fp32


@torch.library.custom_op("conformer_tpu_torch::sincos_attention_fwd",
                         mutates_args=(), device_types="cuda")
def sincos_attention_fwd_op(qu: torch.Tensor, qv: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor,
                            wh: torch.Tensor, lengths: torch.Tensor,
                            sin_t: torch.Tensor, cos_t: torch.Tensor,
                            rate: float, seed: int, tq: int) -> torch.Tensor:
    """K1 as a custom op (the output only): the wrapper, looked up when
    called, so that patching this module's name reroutes it."""
    return sincos_attention_fwd(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                                rate, seed, tq)


@sincos_attention_fwd_op.register_kernel("cpu")
def _(qu, qv, k, v, wh, lengths, sin_t, cos_t, rate, seed, tq):
    return sincos_attention_plain(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                                  rate, seed, tq)


@sincos_attention_fwd_op.register_fake
def _(qu, qv, k, v, wh, lengths, sin_t, cos_t, rate, seed, tq):
    return torch.empty_like(qu)


def bwd_scratch_bytes(b: int, l: int, h: int, dh: int, dtype,
                      dp: Optional[int] = None) -> int:
    """Bytes of device scratch K2 takes at these shapes (wgmma: ds and
    p_drop (B*H, L, L) and da (B*H, L, Dp) in bf16, as its library computes
    them; general: ``general_geometry``'s, ds, p_drop and da in the input
    dtype and the dwh partials in fp32), so they grow with L^2 and not in
    shared memory. ``dp``: the position width, default H * dh."""
    dp = h * dh if dp is None else dp
    variant = attention_variant(dtype, h, dh, h * dh, dp)
    if variant == "general":
        return general_geometry(dtype, b, l, h, dh, dp)["bwd_scratch"]
    return _scratch_bytes(build.load("sincos_attention_bwd"),
                          "sincos_attention_bwd", b, l, h, dh, dp,
                          _DTYPE_CODES[dtype], VARIANTS.index(variant))


def sincos_attention_bwd(qu, qv, k, v, wh, lengths, sin_t, cos_t, stats,
                         dout, rate: float = 0.0, seed: int = 0, tq: int = 0):
    """Kernel wrapper (K2): same arguments and result as
    sincos_attention_bwd_plain. CPU tensors take the plain version; CUDA
    tensors launch the kernel of ``attention_variant`` (counted in
    ``sincos_attention_bwd.launches``, the general one also in
    ``.general_launches`` and, in fp32, ``.general_fp32_launches``) or
    raise. ``stats`` are K1's row statistics."""
    if qu.device.type == "cpu":
        return sincos_attention_bwd_plain(qu, qv, k, v, wh, lengths, sin_t,
                                          cos_t, stats, dout, rate,
                                          seed, tq)
    b, l, h, dh, dp, code, variant = _check_common(qu, qv, k, v, wh, lengths,
                                                   sin_t, cos_t)
    dev, dt = qu.device, qu.dtype
    _check("dout", dout, (b, l, h * dh), dt, dev)
    _check("stats", stats, (b, h, l, 2), torch.float32, dev)
    _check_fits(dt, b, l, h, dh, dp, variant, "bwd_rows")
    thresh, inv_keep, seed32, tq = _dropout_args(rate, seed, tq, l)
    lib = build.load("sincos_attention_bwd")
    dqu, dqv, dk, dv = (torch.empty_like(qu) for _ in range(4))
    dwh = torch.empty_like(wh)
    scratch = torch.empty(_scratch_bytes(lib, "sincos_attention_bwd", b, l,
                                         h, dh, dp, code, variant),
                          dtype=torch.uint8, device=dev)
    run = lib.sincos_attention_bwd
    run.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 7
                    + [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p])
    run.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = run(*(x.data_ptr() for x in (
            qu, qv, k, v, wh, sin_t, cos_t, lengths, stats, dout,
            dqu, dqv, dk, dv, dwh, scratch)), b, l, h, dh, dp, code, variant,
            seed32, thresh, inv_keep, tq, stream)
    build.check(lib, "sincos_attention_bwd", err)
    counters = ["launches"]
    if VARIANTS[variant] == "general":
        counters += ["general_launches"] + ["general_fp32_launches"] * (code == 0)
    build.count(sincos_attention_bwd, *counters)
    return dqu, dqv, dk, dv, dwh


sincos_attention_bwd.launches = 0
sincos_attention_bwd.general_launches = 0   # of those, the general kernels
sincos_attention_bwd.general_fp32_launches = 0   # ... in fp32


class SincosAttention(torch.autograd.Function):
    """K1 forward, K2 backward (their plain versions on CPU tensors). The
    wrappers are looked up at call time, so a caller can route both through
    their plain versions by patching this module's names."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, wh, lengths, sin_t, cos_t, rate, seed, tq):
        out, stats = sincos_attention_fwd(qu, qv, k, v, wh, lengths, sin_t,
                                          cos_t, rate, seed, tq, stats=True)
        ctx.save_for_backward(qu, qv, k, v, wh, lengths, sin_t, cos_t, stats)
        ctx.dropout = (rate, seed, tq)
        return out

    @staticmethod
    def backward(ctx, dout):
        saved = ctx.saved_tensors
        grads = sincos_attention_bwd(*saved, dout.contiguous(), *ctx.dropout)
        return (*grads, None, None, None, None, None, None)


def rel_attention_sincos_packed(qu, qv, k, v, wh, lengths: Optional[torch.Tensor],
                                scale: float, dropout_rate: float = 0.0,
                                seed: int = 0, tq: Optional[int] = None):
    """Fused shift-free relative attention, packed (B, L, D) layout.

    qu = q + content_bias, qv = q + position_bias; k, v: (B, L, D); wh:
    (H, dh, Dp) from prep_pos_kernel (Dp: the position width, the model's
    whole width also when a mesh gives this call a rank's heads); lengths: (B,) valid key counts or None;
    seed: the int32 dropout seed; tq: the JAX kernel's q-tile rows (None =
    auto), which the dropout mask depends on. The scale, rounded to qu's
    dtype, is folded into qu/qv outside the kernels, so autograd restores it
    in dqu/dqv, and the sin/cos tables are cast to that dtype, as the JAX
    wrapper does."""
    b, l, d = qu.shape
    s = torch.tensor(scale, dtype=qu.dtype).item()   # a host scalar: no copy
    sin_t, cos_t = sincos_tables(l, wh.shape[2], qu.dtype, qu.device)
    if lengths is None:
        lengths = torch.full((b,), l, dtype=torch.int32, device=qu.device)
    args = ((qu * s).contiguous(), (qv * s).contiguous(), k.contiguous(),
            v.contiguous(), wh, lengths.to(torch.int32).contiguous(),
            sin_t, cos_t, float(dropout_rate), int(seed), hash_tq(l, tq))
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (qu, qv, k, v, wh)):
        return SincosAttention.apply(*args)
    return sincos_attention_fwd_op(*args)
