"""Relative-position multi-head self-attention, Transformer-XL style
(counterpart of conformer_tpu/models/attention.py).

score = ((q+u).k^T + rel_shift((q+v).p^T)) / sqrt(d_head), PAD keys masked
to float32.min before an fp32 softmax. ``impl='pallas'`` takes the fused
shift-free kernels (``ops/cuda/sincos_attention.py``: K1 forward with its
in-kernel dropout mask, K2 backward) in the packed (B, L, D) layout;
``impl='xla'`` is the dense (B, H, L, L) rel-shift path. Dropout, as in the
JAX module, drops the attention probabilities and the module's output.

Under a mesh whose tp divides the heads (``rel_attention_sincos_sharded``
and ``shardable_axes`` of the JAX package), q/k/v, the two biases and the
position projection are column-parallel over heads: each rank runs K1/K2
on its (B/dp, L, D/tp) operands with its H/tp heads, and ``out`` is
row-parallel. The kernels' dropout seed is mixed with the rank's data and
model indices as the JAX shard_map body mixes it. Otherwise the module runs
whole on every rank of the model group, as the JAX body does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from conformer_tpu_torch.models.dropout import M32, Dropout
from conformer_tpu_torch.models.layers import (Dense, LayerNorm, column_in,
                                               row_offsets, row_out)
from conformer_tpu_torch.ops.cuda.sincos_attention import (
    prep_pos_kernel, rel_attention_sincos_packed)
from conformer_tpu_torch.ops.rel_shift import rel_shift


class RelativeMultiHeadAttention(nn.Module):
    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32, impl: str = "xla",
                 score_dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, dropout_impl: str = "hash"):
        super().__init__()
        if impl not in ("xla", "pallas"):
            raise ValueError(f"unknown attention_impl {impl!r}")
        self.dropout = Dropout(dropout_rate, dropout_impl)
        self.d_model, self.n_heads = d_model, n_heads
        self.compute_dtype, self.impl, self.score_dtype = dtype, impl, score_dtype
        dh = d_model // n_heads
        self.query = Dense(d_model, d_model, dtype)
        self.key = Dense(d_model, d_model, dtype)
        self.value = Dense(d_model, d_model, dtype)
        self.out = Dense(d_model, d_model, dtype)
        # The pos projection: the kernel path reads its weight directly; its
        # bias shifts every score of a row equally, so softmax ignores it.
        self.pos = Dense(d_model, d_model, dtype)
        self.content_bias = nn.Parameter(torch.empty(n_heads, dh))
        self.position_bias = nn.Parameter(torch.empty(n_heads, dh))
        self.mesh, self.split = None, False

    def kernel_seed(self, word: int) -> int:
        """The kernels' int32 dropout seed from the site's first word: under
        a mesh, mixed as the JAX shard_map body mixes it,
        ``seed + data_index * 40503 + model_index * 2654435`` with int32
        wrap-around (each index where its axis shards the call)."""
        seed = word & 0x7FFFFFFF
        mesh = self.mesh
        if mesh is not None:
            if mesh.dp > 1:
                seed += mesh.data_index * 40503
            if self.split:
                seed += mesh.model_index * 2654435
            seed &= M32
            seed -= (seed >> 31) << 32
        return seed

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                seed: Optional[Sequence[int]] = None) -> torch.Tensor:
        """x: (B, L, D); pos_emb: (2L-1, D) (xla path only); mask:
        (B, 1, 1, L) True at PAD; lengths: (B,) valid keys; seed: the
        probability dropout's seed words, or None. The kernel path hashes
        with kernel_seed of the first word. Split over the model group, the
        result is this rank's row-parallel part, without ``out``'s bias."""
        b, l, _ = x.shape
        h, dh = self.content_bias.shape       # this rank's heads
        dt = self.compute_dtype
        q, k, v = self.query(x), self.key(x), self.value(x)
        u = self.content_bias.to(dt)
        vb = self.position_bias.to(dt)
        scale = 1.0 / float(np.sqrt(dh))
        if lengths is None and mask is not None:
            lengths = (~mask[:, 0, 0, :]).sum(dim=-1)

        if self.impl == "pallas":
            # self.pos.weight is (out, in); the flax kernel is (in, out).
            wh = prep_pos_kernel(self.pos.weight.to(dt).T, h)
            rate = self.dropout.rate if seed is not None else 0.0
            context = rel_attention_sincos_packed(
                q + u.reshape(-1), q + vb.reshape(-1), k, v, wh, lengths, scale,
                rate, self.kernel_seed(seed[0]) if rate > 0.0 else 0)
        else:
            q = q.reshape(b, l, h, dh)
            k = k.reshape(b, l, h, dh)
            v = v.reshape(b, l, h, dh)
            p = self.pos(pos_emb).reshape(-1, h, dh)
            f32 = torch.float32
            sdt = self.score_dtype
            content = torch.einsum("blhd,bmhd->bhlm", (q + u).to(f32),
                                   k.to(f32)).to(sdt)
            pos = torch.einsum("blhd,mhd->bhlm", (q + vb).to(f32),
                               p.to(f32)).to(sdt)
            scores = ((content + rel_shift(pos)) * scale).to(f32)
            if mask is not None:
                scores = torch.where(mask, torch.finfo(f32).min, scores)
            off = None
            if self.mesh is not None:
                off = (self.mesh.batch_offset(b),
                       self.mesh.model_index * h if self.split else 0, 0, 0)
            weights = self.dropout(torch.softmax(scores, dim=-1), seed, off)
            context = torch.einsum("bhlm,bmhd->blhd", weights.to(dt).to(f32),
                                   v.to(f32))
        context = context.reshape(b, l, h * dh).to(dt)
        return self.out.partial(context) if self.split else self.out(context)


class MHSAModule(nn.Module):
    """Pre-LN wrapper around RelativeMultiHeadAttention."""

    def __init__(self, d_model: int, n_heads: int,
                 dtype: torch.dtype = torch.float32, impl: str = "xla",
                 score_dtype: torch.dtype = torch.float32,
                 dropout_rate: float = 0.0, dropout_impl: str = "hash"):
        super().__init__()
        self.norm = LayerNorm(d_model, dtype)
        self.attention = RelativeMultiHeadAttention(
            d_model, n_heads, dtype, impl, score_dtype, dropout_rate,
            dropout_impl)
        self.dropout = Dropout(dropout_rate, dropout_impl)

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                seeds: Optional[Sequence] = None, sp=None) -> torch.Tensor:
        """seeds: None, or the seed words of (the probabilities, the
        output); sp: the forward's SeqShard (x is then the rank's rows),
        or None."""
        s_attn, s_out = seeds if seeds is not None else (None, None)
        att = self.attention
        mesh = att.mesh
        if not att.split:
            whole = sp.gather_replicated(x) if sp is not None else x
            y = att(self.norm(whole), pos_emb, mask, lengths, s_attn)
            y = self.dropout(y, s_out, row_offsets(mesh, None, y.shape[0]))
            return sp.scatter(y) if sp is not None else y
        h = column_in(self.norm(x), mesh, sp)
        y = row_out(att(h, pos_emb, mask, lengths, s_attn), att.out, mesh, sp)
        return self.dropout(y, s_out, row_offsets(mesh, sp, y.shape[0]))
