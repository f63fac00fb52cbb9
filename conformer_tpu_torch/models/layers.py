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

Under a mesh (parallel/mesh.py::shard_model sets ``mesh`` and ``split``)
the FFN and the conv module are split over the model group when their
width divides by tp: the first product column-parallel (hidden units; the
conv module's value and gate channels, so that the GLU, the depthwise conv
and its norm stay on the rank's C/tp channels), the last row-parallel, its
bias added after the reduction. With a SeqShard (``sp``) their input and
output are the rank's rows of the sequence. A module that is not split
runs whole on every rank. MaskedBatchNorm sums its statistics over the
data group; a split GroupNorm sums its per-row statistics over the model
group. Dropout masks are the rank's part of the global array's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from conformer_tpu_torch.models.dropout import Dropout
from conformer_tpu_torch.ops.cuda.depthwise_conv import depthwise_conv1d
from conformer_tpu_torch.parallel.collectives import (all_reduce_sum,
                                                      copy_to_model,
                                                      reduce_from_model)

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

    def partial(self, x: torch.Tensor) -> torch.Tensor:
        """The product without the bias: a row-parallel part."""
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt))


def column_in(x: torch.Tensor, mesh, sp) -> torch.Tensor:
    """The input of a column-parallel product: the whole sequence gathered
    from the ranks' rows (sp), or x, whose gradient the model group sums."""
    return sp.gather(x) if sp is not None else copy_to_model(x, mesh.model_group)


def row_out(y: torch.Tensor, dense: Dense, mesh, sp) -> torch.Tensor:
    """A row-parallel product's partial ``y`` summed over the model group
    (this rank's rows of the sum under sp), plus ``dense``'s bias."""
    y = (sp.reduce_scatter(y) if sp is not None
         else reduce_from_model(y, mesh.model_group))
    return y + cast(dense.bias, y.dtype)


def row_offsets(mesh, sp, rows: int):
    """Dropout offsets of a (B, L, D) tensor that holds ``rows`` batch rows
    of each data rank (and, under sp, the rank's part of the sequence)."""
    if mesh is None:
        return None
    return (mesh.batch_offset(rows), sp.offset if sp is not None else 0, 0)


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
        self.mesh, self.split = None, False

    def forward(self, x: torch.Tensor, seeds: Optional[Sequence] = None,
                sp=None) -> torch.Tensor:
        """seeds: None, or the seed words of its two dropout sites; sp: the
        forward's SeqShard (x is then the rank's rows), or None."""
        s_hidden, s_out = seeds if seeds is not None else (None, None)
        mesh = self.mesh
        if not self.split:
            if sp is not None:
                return sp.scatter(self._whole(sp.gather_replicated(x),
                                              s_hidden, s_out))
            return self._whole(x, s_hidden, s_out)
        b = x.shape[0]
        h = swish(self.hidden(column_in(self.norm(x), mesh, sp)))
        h = self.dropout(h, s_hidden, (mesh.batch_offset(b), 0,
                                       mesh.model_index * h.shape[-1]))
        y = row_out(self.out.partial(h), self.out, mesh, sp)
        return self.dropout(y, s_out, row_offsets(mesh, sp, b))

    def _whole(self, x: torch.Tensor, s_hidden, s_out) -> torch.Tensor:
        off = row_offsets(self.mesh, None, x.shape[0])
        x = self.dropout(swish(self.hidden(self.norm(x))), s_hidden, off)
        return self.dropout(self.out(x), s_out, off)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) with an optional validity mask; under a
    mesh, over the global batch (count, sum and sum of squares summed over
    the data group, gradients through the sum).

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
        self.mesh = None

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
            if self.mesh is not None:
                # cross-replica statistics, as the JAX psum over axis_name
                c = total.shape[0]
                stats = all_reduce_sum(torch.cat([count.reshape(1), total,
                                                  total_sq]),
                                       self.mesh.data_group)
                count, total, total_sq = stats[0], stats[1:1 + c], stats[1 + c:]
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
        self.mesh, self.split = None, False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L, C); split: C is this rank's channels, and each row's
        sums run over the model group's."""
        xf = x.float()
        if self.split:
            n = xf.shape[1] * xf.shape[2] * self.mesh.tp
            sums = all_reduce_sum(torch.stack([xf.sum(dim=(1, 2)),
                                               (xf * xf).sum(dim=(1, 2))]),
                                  self.mesh.model_group)
            mean = (sums[0] / n)[:, None, None]
            var = torch.clamp((sums[1] / n)[:, None, None] - mean * mean,
                              min=0.0)
        else:
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
        self.mesh, self.split = None, False

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                seed: Optional[Sequence[int]] = None, sp=None) -> torch.Tensor:
        """x: (B, L, C); mask: (B, L) True at valid frames; seed: the output
        dropout's seed words, or None; sp: the forward's SeqShard (x is
        then the rank's rows; mask stays whole), or None."""
        mesh, whole, out_sp = self.mesh, not self.split, None
        if whole and sp is not None:     # runs whole on every rank
            x, out_sp, sp = sp.gather_replicated(x), sp, None
        x = self.norm(x)
        if not whole:
            x = column_in(x, mesh, sp)
        x = glu(self.pointwise1(x), dim=-1)
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
        x = swish(x)
        b = x.shape[0]
        if whole:
            y = self.dropout(self.pointwise2(x), seed, row_offsets(mesh, None, b))
            return out_sp.scatter(y) if out_sp is not None else y
        y = row_out(self.pointwise2.partial(x), self.pointwise2, mesh, sp)
        return self.dropout(y, seed, row_offsets(mesh, sp, b))


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
