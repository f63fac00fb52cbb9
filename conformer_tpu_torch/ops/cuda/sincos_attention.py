"""Fused shift-free relative-position attention (forward), kernel K1.

Counterpart of ``conformer_tpu/ops/pallas/sincos_attention.py``. The
Transformer-XL position score ``qv_i . p(i - j)`` is rewritten with the
angle-addition identity as ``alpha_i . cos(j w) + beta_i . sin(j w)``, where
``a_i = qv_i . W_h`` and alpha/beta mix a's sin and cos halves with the query
row's sin/cos: two products against constant (L, D/2) tables instead of a
(B, H, L, 2L-1) score tensor and a rel-shift.

``sincos_attention_fwd`` is the kernel wrapper: a CPU tensor takes the plain
PyTorch version ``sincos_attention_plain``; a CUDA tensor launches the
hand-written kernel in ``csrc/sincos_attention.cu`` (which says what bounds
it on the H100) or raises. Dropout on the probabilities is not implemented
yet: it comes with the backward kernel.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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
        inv_freq = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                          * -(np.log(10000.0) / d_model))
        ang = np.arange(length, dtype=np.float64)[:, None] * inv_freq[None, :]
        _tables[key] = tuple(torch.from_numpy(f(ang)).to(device=device,
                                                         dtype=dtype)
                             for f in (np.sin, np.cos))
    sin_t, cos_t = _tables[key]
    return sin_t[:length], cos_t[:length]


def prep_pos_kernel(pos_kernel: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(D, D) position-projection kernel (flax (in, out) layout) -> (H, dh, D)
    per-head operand with the embedding axis permuted to
    [sin coefficients (D/2) | cos coefficients (D/2)]."""
    d = pos_kernel.shape[0]
    dh = d // n_heads
    wh = pos_kernel.reshape(d, n_heads, dh).permute(1, 2, 0)
    dev = pos_kernel.device
    perm = torch.cat([torch.arange(0, d, 2, device=dev),
                      torch.arange(1, d, 2, device=dev)])
    return wh[:, :, perm].contiguous()


def sincos_attention_plain(qu, qv, k, v, wh, lengths, sin_t, cos_t):
    """Plain PyTorch version of the kernel, rounding where it rounds.

    qu/qv/k/v: (B, L, D) packed, head h in columns [h*dh, (h+1)*dh), with the
    score scale already folded into qu/qv; wh: (H, dh, D); lengths: (B,)
    int; sin_t/cos_t: (L, D/2) in the input dtype. Products take fp32 sums
    of the input-dtype operands; alpha/beta and the probabilities are
    rounded to the input dtype before their products. -> (B, L, D)."""
    b, l, d = qu.shape
    h, dh = wh.shape[0], wh.shape[1]
    d2 = d // 2
    dt = v.dtype
    f32 = torch.float32
    split = lambda x: x.reshape(b, l, h, dh).transpose(1, 2).to(f32)
    qu_, qv_, k_, v_ = split(qu), split(qv), split(k), split(v)
    sq, cq = sin_t.to(f32), cos_t.to(f32)
    content = qu_ @ k_.transpose(-1, -2)                      # (B,H,L,L)
    a = torch.einsum("bhld,hdx->bhlx", qv_, wh.to(f32))       # (B,H,L,D)
    a_s, a_c = a[..., :d2], a[..., d2:]
    alpha = (a_s * sq + a_c * cq).to(dt).to(f32)
    beta = (-a_s * cq + a_c * sq).to(dt).to(f32)
    scores = content + alpha @ cq.T + beta @ sq.T
    length = torch.clamp(lengths.to(torch.int64), max=l)
    valid = torch.arange(l, device=qu.device)[None, :] < length[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    s = e.sum(dim=-1, keepdim=True)
    out = (e.to(dt).to(f32) @ v_) * (1.0 / torch.clamp(s, min=1e-9))
    return out.transpose(1, 2).reshape(b, l, d).to(dt)


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


def sincos_attention_fwd(qu, qv, k, v, wh, lengths, sin_t, cos_t):
    """Kernel wrapper: same arguments and result as sincos_attention_plain.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (counted in ``sincos_attention_fwd.launches``) or raise."""
    if qu.device.type == "cpu":
        return sincos_attention_plain(qu, qv, k, v, wh, lengths, sin_t, cos_t)
    if qu.device.type != "cuda":
        raise ValueError(f"no kernel for device {qu.device}")
    b, l, d = qu.shape
    h, dh = wh.shape[0], wh.shape[1]
    if dh != 64 or h * dh != d or (d // 2) % 64:
        raise ValueError(f"kernel needs dh = 64 and D/2 a multiple of 64, "
                         f"got H={h}, dh={dh}, D={d}")
    if qu.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {qu.dtype}")
    dev, dt = qu.device, qu.dtype
    for name, x in (("qu", qu), ("qv", qv), ("k", k), ("v", v)):
        _check(name, x, (b, l, d), dt, dev)
    _check("wh", wh, (h, dh, d), dt, dev)
    _check("sin_t", sin_t, (l, d // 2), dt, dev)
    _check("cos_t", cos_t, (l, d // 2), dt, dev)
    _check("lengths", lengths, (b,), torch.int32, dev)
    out = torch.empty_like(qu)
    lib = build.load("sincos_attention")
    fn = lib.sincos_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(),
                 wh.data_ptr(), sin_t.data_ptr(), cos_t.data_ptr(),
                 lengths.data_ptr(), out.data_ptr(), b, l, h,
                 _DTYPE_CODES[dt], stream)
    build.check(lib, "sincos_attention", err)
    sincos_attention_fwd.launches += 1
    return out


sincos_attention_fwd.launches = 0


def rel_attention_sincos_packed(qu, qv, k, v, wh, lengths: Optional[torch.Tensor],
                                scale: float, dropout_rate: float = 0.0):
    """Fused shift-free relative attention, packed (B, L, D) layout.

    qu = q + content_bias, qv = q + position_bias; k, v: (B, L, D); wh:
    (H, dh, D) from prep_pos_kernel; lengths: (B,) valid key counts or None.
    The scale, rounded to qu's dtype, is folded into qu/qv, and the sin/cos
    tables are cast to that dtype, as the JAX wrapper does."""
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "attention dropout needs the backward kernel (training slice)")
    b, l, d = qu.shape
    s = torch.tensor(scale, dtype=qu.dtype).item()   # a host scalar: no copy
    sin_t, cos_t = sincos_tables(l, d, qu.dtype, qu.device)
    if lengths is None:
        lengths = torch.full((b,), l, dtype=torch.int32, device=qu.device)
    return sincos_attention_fwd((qu * s).contiguous(), (qv * s).contiguous(),
                                k.contiguous(), v.contiguous(), wh,
                                lengths.to(torch.int32).contiguous(),
                                sin_t, cos_t)
