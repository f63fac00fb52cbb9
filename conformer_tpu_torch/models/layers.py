"""Conformer building blocks (counterpart of conformer_tpu/models/layers.py).

- FFN: LN -> Linear d->4d -> swish -> Linear 4d->d.
- Conv module: LN -> pointwise 2x expand -> GLU -> (zero pad frames) ->
  depthwise conv (same pad) -> masked BatchNorm (or, with
  ``conv_norm='group'``, a one-group GroupNorm) -> swish -> pointwise.
- Subsampling: two valid 3x3 stride-2 convs + ReLU over (B, 1, T, F), the
  output flattened as (B, T', F' * C) like the JAX (B, T', F', C) layout.

Parameters are fp32 and are cast to the compute dtype at use, as flax does
with ``dtype=bf16, param_dtype=fp32``. Dropout sites are where the JAX
modules have them (models/dropout.py): after the FFN's swish and its output,
and after the conv module's output. Each takes its seed words from the
caller; with none (evaluation) it drops nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from conformer_tpu_torch.models.dropout import Dropout
from conformer_tpu_torch.ops.cuda.depthwise_conv import depthwise_conv1d

# Config dtype names (optim.compute_dtype, model.attention_score_dtype).
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``; no op at all when it already is (an exported
    program then holds no cast node for it)."""
    return x if x.dtype == dtype else x.to(dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def glu(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


class Dense(nn.Linear):
    """nn.Linear whose fp32 parameters are cast to ``dtype`` at use."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt),
                        cast(self.bias, dt))


class LayerNorm(nn.LayerNorm):
    """flax LayerNorm: eps 1e-6, statistics in fp32, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


class FeedForwardModule(nn.Module):
    def __init__(self, d_model: int, expansion: int = 4,
                 dtype: torch.dtype = torch.float32, dropout_rate: float = 0.0,
                 dropout_impl: str = "hash"):
        super().__init__()
        self.norm = LayerNorm(d_model, dtype)
        self.hidden = Dense(d_model, expansion * d_model, dtype)
        self.out = Dense(expansion * d_model, d_model, dtype)
        self.dropout = Dropout(dropout_rate, dropout_impl)

    def forward(self, x: torch.Tensor,
                seeds: Optional[Sequence] = None) -> torch.Tensor:
        """seeds: None, or the seed words of its two dropout sites."""
        s_hidden, s_out = seeds if seeds is not None else (None, None)
        x = self.dropout(swish(self.hidden(self.norm(x))), s_hidden)
        return self.dropout(self.out(x), s_out)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) with an optional validity mask.

    Normalises with the biased batch variance; the running statistics take
    the unbiased estimate with momentum 0.1 (torch BatchNorm1d semantics),
    updated only in training mode and while ``update_stats`` is set (a
    checkpointed block clears it for the recomputation in the backward, so
    the statistics move once per forward)."""

    def __init__(self, features: int, momentum: float = 0.1,
                 epsilon: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.epsilon, self.compute_dtype = momentum, epsilon, dtype
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = True) -> torch.Tensor:
        """x: (B, L, C); mask: (B, L) bool, True at valid frames."""
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            xf = x.float()
            if mask is not None:
                m = mask[..., None].float()
                count = m.sum()
                total = (xf * m).sum(dim=(0, 1))
                total_sq = (xf * xf * m).sum(dim=(0, 1))
            else:
                count = torch.full((), float(x.shape[0] * x.shape[1]),
                                   device=x.device)
                total = xf.sum(dim=(0, 1))
                total_sq = (xf * xf).sum(dim=(0, 1))
            count = torch.clamp(count, min=1.0)
            mean = total / count
            var = torch.clamp(total_sq / count - mean * mean, min=0.0)
            if self.training and self.update_stats:
                with torch.no_grad():
                    unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                    self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                    self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)
        inv = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x.float() - mean) * inv + self.bias).to(self.compute_dtype)


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(num_groups=1)`` over (B, L, C): per batch row, the
    mean and variance of every frame and channel (padded frames included,
    as in the JAX package), in fp32 (``E[x^2] - E[x]^2``, clamped at 0),
    eps 1e-6; a per-channel scale and bias; output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.epsilon, self.compute_dtype = 1e-6, dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 2), keepdim=True)
                          - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * self.weight)
        return (y + self.bias).to(self.compute_dtype)


class DepthwiseConv1d(nn.Module):
    """Depthwise same-pad conv1d over (B, L, C). Weight (C, 1, K), bias (C,).

    ``impl='xla'`` is ``F.conv1d(groups=C)``, as the JAX package leaves it to
    XLA; ``impl='pallas'`` runs the depthwise-conv kernels K4a/K4b
    (``ops/cuda/depthwise_conv.py``), which round in the compute dtype after
    every product and add as the Pallas kernel does. Both take the same
    parameters."""

    def __init__(self, channels: int, kernel_size: int, impl: str = "xla",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if impl not in ("xla", "pallas"):
            raise ValueError(f"unknown conv_impl {impl!r}; 'xla' or 'pallas'")
        self.impl = impl
        self.kernel_size, self.compute_dtype = kernel_size, dtype
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.impl == "pallas":
            return depthwise_conv1d(x.to(dt), self.weight[:, 0].t().to(dt),
                                    self.bias.to(dt))
        k = self.kernel_size
        left = (k - 1) // 2
        xt = F.pad(x.to(dt).transpose(1, 2), (left, k - 1 - left))
        out = F.conv1d(xt, self.weight.to(dt), self.bias.to(dt),
                       groups=x.shape[-1])
        return out.transpose(1, 2)


class ConvolutionModule(nn.Module):
    def __init__(self, channels: int, kernel_size: int,
                 conv_norm: str = "batch", conv_impl: str = "xla",
                 mask_pad: bool = True, dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, dropout_impl: str = "hash"):
        super().__init__()
        if conv_norm not in ("batch", "group"):
            raise ValueError(f"unknown conv_norm {conv_norm!r}; 'batch' or "
                             "'group'")
        self.mask_pad, self.conv_norm = mask_pad, conv_norm
        self.norm = LayerNorm(channels, dtype)
        self.pointwise1 = Dense(channels, 2 * channels, dtype)
        self.depthwise = DepthwiseConv1d(channels, kernel_size, conv_impl, dtype)
        if conv_norm == "batch":
            self.bn = MaskedBatchNorm(channels, dtype=dtype)
        else:
            self.group_norm = GroupNorm(channels, dtype)
        self.pointwise2 = Dense(channels, channels, dtype)
        self.dropout = Dropout(dropout_rate, dropout_impl)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seed: Optional[Sequence[int]] = None) -> torch.Tensor:
        """x: (B, L, C); mask: (B, L) True at valid frames; seed: the output
        dropout's seed words, or None."""
        x = glu(self.pointwise1(self.norm(x)), dim=-1)
        if not self.mask_pad:
            mask = None
        if mask is not None:
            x = torch.where(mask[..., None], x, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
        x = self.depthwise(x)
        if self.conv_norm == "batch":
            x = self.bn(x, mask=mask, use_running_average=not self.training)
        else:
            x = self.group_norm(x)
        return self.dropout(self.pointwise2(swish(x)), seed)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose fp32 parameters are cast to ``dtype`` at use."""

    def __init__(self, *args, dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt))


class ConvolutionSubsampling(nn.Module):
    """(B, T, F) log-mels -> (B, T', F' * channels); impl 'conv2d' (two
    dense 3x3 stride-2 convs) or 'separable' (second conv as depthwise 3x3
    + pointwise 1x1)."""

    def __init__(self, channels: int, impl: str = "conv2d",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.impl = impl
        self.conv1 = Conv2d(1, channels, 3, stride=2, dtype=dtype)
        if impl == "separable":
            self.conv2_dw = Conv2d(channels, channels, 3, stride=2,
                                   groups=channels, dtype=dtype)
            self.conv2_pw = Conv2d(channels, channels, 1, dtype=dtype)
        elif impl == "conv2d":
            self.conv2 = Conv2d(channels, channels, 3, stride=2, dtype=dtype)
        else:
            raise ValueError(f"unknown subsample_impl {impl!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.conv1(x[:, None]))                 # (B, C, T, F)
        if self.impl == "separable":
            x = self.conv2_pw(self.conv2_dw(x))
        else:
            x = self.conv2(x)
        x = F.relu(x)
        b, c, t, f = x.shape
        return x.permute(0, 2, 3, 1).reshape(b, t, f * c)
