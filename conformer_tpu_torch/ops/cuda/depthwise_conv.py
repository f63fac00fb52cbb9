"""Depthwise same-pad conv1d over (B, L, C): the forward K4a and the weight
gradient K4b.

Counterpart of ``conformer_tpu/ops/pallas/depthwise_conv.py``. Kernel
wrappers, each with a plain PyTorch version beside it:

- ``depthwise_conv_fwd`` (K4a, ``csrc/depthwise_conv.cu``): out = bias + the
  taps in order 0..K-1, x read as 0 outside [0, L), with an explicit left
  pad; in bf16 every product and every add is rounded to bf16, as the Pallas
  kernel rounds, so the kernel, ``depthwise_conv_plain`` and the JAX kernel
  in interpret mode agree bit for bit;
- ``depthwise_conv_dw`` (K4b): the weight gradient in fp32.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``depthwise_conv1d`` is the autograd Function, the counterpart of
the JAX ``custom_vjp``: dx is K4a on g with the taps flipped, a zero bias and
the left pad K - 1 - pad, which is the exact gradient for every K (the JAX
``_bwd`` keeps the forward's pad, exact only for odd K).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from conformer_tpu_torch.ops.cuda import build
from conformer_tpu_torch.ops.cuda.sincos_attention import _DTYPE_CODES


def depthwise_conv_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                         pad: int) -> torch.Tensor:
    """x (B, L, C), w (K, C), bias (C,) of one dtype -> (B, L, C): bias plus
    x[:, i + k - pad] * w[k] for k = 0..K-1 in order, one rounding to the
    dtype per product and per add."""
    l, k = x.shape[1], w.shape[0]
    xp = F.pad(x, (0, 0, pad, k - 1 - pad))
    acc = bias.expand_as(x)
    for i in range(k):
        acc = acc + xp[:, i:i + l] * w[i]
    return acc


def depthwise_conv_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int,
                            pad: int) -> torch.Tensor:
    """x, g (B, L, C) -> dw (K, C) fp32: dw[i] = sum over batch and frames of
    x[:, t + i - pad] * g[:, t], in fp32."""
    l = x.shape[1]
    xp = F.pad(x.float(), (0, 0, pad, k - 1 - pad))
    gf = g.float()
    return torch.stack([(xp[:, i:i + l] * gf).sum(dim=(0, 1))
                        for i in range(k)])


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}, "
                         f"got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous with shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")


def _check_x(x: torch.Tensor, k: int, pad: int):
    """-> (b, l, c, dtype code) for a CUDA tensor the kernels take."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, L, C), got {tuple(x.shape)}")
    if not 0 <= pad < k:
        raise ValueError(f"left pad must be in [0, {k}), got {pad}")
    b, l, c = x.shape
    _check("x", x, (b, l, c), x.dtype, x.device)
    return b, l, c, _DTYPE_CODES[x.dtype]


def depthwise_conv_fwd(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       pad: int) -> torch.Tensor:
    """Kernel wrapper (K4a): same arguments and result as
    depthwise_conv_plain. CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``depthwise_conv_fwd.launches``) or
    raise."""
    if x.device.type == "cpu":
        return depthwise_conv_plain(x, w, bias, pad)
    k = w.shape[0]
    b, l, c, code = _check_x(x, k, pad)
    _check("w", w, (k, c), x.dtype, x.device)
    _check("bias", bias, (c,), x.dtype, x.device)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = build.load("depthwise_conv")
    fn = lib.depthwise_conv_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 b, l, c, k, pad, code, stream)
    build.check(lib, "depthwise_conv", err)
    depthwise_conv_fwd.launches += 1
    return out


depthwise_conv_fwd.launches = 0


def depthwise_conv_dw(x: torch.Tensor, g: torch.Tensor, k: int,
                      pad: int) -> torch.Tensor:
    """Kernel wrapper (K4b): same arguments and result as
    depthwise_conv_dw_plain. CPU tensors take the plain version; CUDA
    tensors launch the kernel (counted in ``depthwise_conv_dw.launches``)
    or raise."""
    if x.device.type == "cpu":
        return depthwise_conv_dw_plain(x, g, k, pad)
    b, l, c, code = _check_x(x, k, pad)
    _check("g", g, (b, l, c), x.dtype, x.device)
    dw = torch.empty((k, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return dw.zero_()
    lib = build.load("depthwise_conv")
    size = lib.depthwise_conv_dw_scratch_bytes
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 4
    scratch = torch.empty(int(size(b, l, c, k)), dtype=torch.uint8,
                          device=x.device)
    fn = lib.depthwise_conv_dw
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), g.data_ptr(), scratch.data_ptr(), dw.data_ptr(),
                 b, l, c, k, pad, code, stream)
    build.check(lib, "depthwise_conv", err)
    depthwise_conv_dw.launches += 1
    return dw


depthwise_conv_dw.launches = 0


class DepthwiseConv1d(torch.autograd.Function):
    """K4a forward; backward: dx by K4a with flipped taps, dw by K4b rounded
    to w's dtype (as the JAX ``.astype(w.dtype)``), db the fp32 sum of g
    over batch and frames in b's dtype. The wrappers are looked up at call
    time, so a caller can route all of it through the plain versions by
    patching this module's names."""

    @staticmethod
    def forward(ctx, x, w, bias):
        pad = (w.shape[0] - 1) // 2
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = bias.dtype
        return depthwise_conv_fwd(x, w, bias, pad)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, c = w.shape
        pad = (k - 1) // 2
        g = g.contiguous()
        dx = depthwise_conv_fwd(g, w.flip(0).contiguous(),
                                torch.zeros(c, dtype=w.dtype, device=w.device),
                                k - 1 - pad)
        dw = depthwise_conv_dw(x, g, k, pad).to(w.dtype)
        db = g.float().sum(dim=(0, 1)).to(ctx.bias_dtype)
        return dx, dw, db


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """Depthwise same-pad conv1d: x (B, L, C), w (K, C), bias (C,), all of
    the compute dtype -> (B, L, C). Differentiable in all three."""
    return DepthwiseConv1d.apply(x.contiguous(), w.contiguous(),
                                 bias.contiguous())
