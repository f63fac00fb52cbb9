"""Relative-position multi-head self-attention, Transformer-XL style
(counterpart of conformer_tpu/models/attention.py).

score = ((q+u).k^T + rel_shift((q+v).p^T)) / sqrt(d_head), PAD keys masked
to float32.min before an fp32 softmax. ``impl='pallas'`` takes the fused
shift-free kernels (``ops/cuda/sincos_attention.py``: K1 forward with its
in-kernel dropout mask, K2 backward) in the packed (B, L, D) layout;
``impl='xla'`` is the dense (B, H, L, L) rel-shift path. Dropout, as in the
JAX module, drops the attention probabilities and the module's output.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from conformer_tpu_torch.models.dropout import Dropout
from conformer_tpu_torch.models.layers import Dense, LayerNorm
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

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor],
                mask: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                seed: Optional[Sequence[int]] = None) -> torch.Tensor:
        """x: (B, L, D); pos_emb: (2L-1, D) (xla path only); mask:
        (B, 1, 1, L) True at PAD; lengths: (B,) valid keys; seed: the
        probability dropout's seed words, or None. The kernel path hashes
        with the first word as its int32 seed."""
        b, l, _ = x.shape
        h, dh = self.n_heads, self.d_model // self.n_heads
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
                rate, seed[0] & 0x7FFFFFFF if rate > 0.0 else 0)
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
            weights = self.dropout(torch.softmax(scores, dim=-1), seed)
            context = torch.einsum("bhlm,bmhd->blhd", weights.to(dt).to(f32),
                                   v.to(f32))
        context = context.reshape(b, l, self.d_model).to(dt)
        return self.out(context)


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
                seeds: Optional[Sequence] = None) -> torch.Tensor:
        """seeds: None, or the seed words of (the probabilities, the
        output)."""
        s_attn, s_out = seeds if seeds is not None else (None, None)
        x = self.attention(self.norm(x), pos_emb, mask, lengths, s_attn)
        return self.dropout(x, s_out)
