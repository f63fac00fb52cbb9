"""Conformer encoder: subsample -> project -> dropout -> N macaron blocks
(counterpart of conformer_tpu/models/encoder.py).

Each block: [0.5*ffn + x] -> [mhsa + x] -> [conv + x] -> [0.5*ffn + x] ->
LayerNorm. The stack is an unrolled loop over ``blocks``; the JAX package's
scan option changes how XLA compiles it, not what it computes, and has no
effect here. ``use_remat`` is honoured in training: each block runs under
``torch.utils.checkpoint`` and is recomputed in the backward, as
``nn.remat`` does (its BatchNorm statistics move once, in the forward).

Dropout draws no random numbers inside the model: the caller passes one
integer seed per forward, and ``dropout_seed_words`` expands it on the host
into the seed words of every site (7 per block: 6 hash sites and the
attention kernel's seed), so a checkpointed block's recomputation and a
resumed run draw the same masks.

Under a mesh (parallel/mesh.py) with ``model.seq_shard`` and tp > 1 the
stack runs sequence-parallel (Megatron-SP, the counterpart of the JAX
``seq_shard_constraint`` pins at each block's ends): the input is split
along L over the model group (padded to a multiple of tp), LayerNorm,
dropout and the residuals run on the rank's rows, each split module
gathers L before its column-parallel product and reduce-scatters after its
row-parallel one, and the output is gathered whole again.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from conformer_tpu_torch.config import ModelConfig
from conformer_tpu_torch.models.attention import MHSAModule
from conformer_tpu_torch.models.dropout import Dropout
from conformer_tpu_torch.models.layers import (DTYPES, ConvolutionModule,
                                               ConvolutionSubsampling, Dense,
                                               FeedForwardModule, LayerNorm,
                                               MaskedBatchNorm)
from conformer_tpu_torch.models.position import relative_positional_encoding
from conformer_tpu_torch.parallel.mesh import seq_shard
from conformer_tpu_torch.utils.masking import (attention_pad_mask,
                                               padding_mask, subsampled_length)

SITES_PER_BLOCK = 7   # ffn1 x2, attention probabilities, mhsa out, conv, ffn2 x2


def dropout_seed_words(seed: int, n_blocks: int
                       ) -> Tuple[List[int], List[List[List[int]]]]:
    """-> (input projection's two words, per block SITES_PER_BLOCK pairs of
    uint32 words), drawn on the CPU from a generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    words = torch.randint(0, 2 ** 32, (1 + n_blocks * SITES_PER_BLOCK, 2),
                          generator=gen, dtype=torch.int64).tolist()
    return words[0], [words[1 + i * SITES_PER_BLOCK: 1 + (i + 1) * SITES_PER_BLOCK]
                      for i in range(n_blocks)]


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.d_model
        drop = (cfg.dropout_rate, cfg.dropout_impl)
        self.ffn1 = FeedForwardModule(d, cfg.ffn_expansion, dtype, *drop)
        self.mhsa = MHSAModule(d, cfg.n_heads, dtype, cfg.attention_impl,
                               DTYPES[cfg.attention_score_dtype], *drop)
        self.conv = ConvolutionModule(d, cfg.kernel_size, cfg.conv_norm,
                                      cfg.conv_impl, cfg.conv_mask_pad, dtype,
                                      *drop)
        self.ffn2 = FeedForwardModule(d, cfg.ffn_expansion, dtype, *drop)
        self.final_norm = LayerNorm(d, dtype)

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor],
                attn_mask: Optional[torch.Tensor],
                frame_mask: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor],
                seeds: Optional[List[List[int]]] = None,
                sp=None) -> torch.Tensor:
        """seeds: None (no dropout) or this block's SITES_PER_BLOCK words;
        sp: the forward's SeqShard (x is then the rank's rows), or None."""
        s = seeds if seeds is not None else [None] * SITES_PER_BLOCK
        x = 0.5 * self.ffn1(x, s[0:2] if seeds else None, sp) + x
        x = self.mhsa(x, pos_emb, attn_mask, lengths,
                      s[2:4] if seeds else None, sp) + x
        x = self.conv(x, frame_mask, s[4], sp) + x
        x = 0.5 * self.ffn2(x, s[5:7] if seeds else None, sp) + x
        return self.final_norm(x)


@contextmanager
def _frozen_stats(module: nn.Module):
    """Hold the BatchNorm running statistics of ``module`` still."""
    norms = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def _remat(block: ConformerBlock, *args) -> torch.Tensor:
    """Run ``block`` under torch.utils.checkpoint; its recomputation in the
    backward leaves the BatchNorm statistics alone."""
    calls = []

    def run(*a):
        if calls:
            with _frozen_stats(block):
                return block(*a)
        calls.append(1)
        return block(*a)

    return checkpoint(run, *args, use_reentrant=False)


def apply_block_stack(blocks: nn.ModuleList, x: torch.Tensor,
                      pos_emb: Optional[torch.Tensor],
                      attn_mask: Optional[torch.Tensor],
                      frame_mask: Optional[torch.Tensor],
                      lengths: Optional[torch.Tensor],
                      seeds: Optional[List] = None,
                      remat: bool = False, sp=None) -> torch.Tensor:
    """Apply the N-block stack in order; ``remat`` checkpoints each block;
    sp: the forward's SeqShard, or None."""
    for i, block in enumerate(blocks):
        args = (x, pos_emb, attn_mask, frame_mask, lengths,
                seeds[i] if seeds is not None else None, sp)
        x = _remat(block, *args) if remat else block(*args)
    return x


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.compute_dtype = dtype
        d = cfg.d_model
        self.subsample = ConvolutionSubsampling(d, cfg.subsample_impl, dtype)
        freq = ((cfg.n_mel_channels - 1) // 2 - 1) // 2
        self.input_proj = Dense(d * freq, d, dtype)
        self.dropout = Dropout(cfg.dropout_rate, cfg.dropout_impl)
        self.blocks = nn.ModuleList(ConformerBlock(cfg, dtype)
                                    for _ in range(cfg.n_blocks))
        self.mesh = None

    def forward(self, mels: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """mels: (B, T, n_mels); lengths: (B,) valid frames; dropout_seed:
        None (no dropout) or this forward's seed.
        -> (B, T', d_model) encodings and subsampled lengths."""
        input_seed = block_seeds = None
        if dropout_seed is not None and self.cfg.dropout_rate > 0.0:
            input_seed, block_seeds = dropout_seed_words(dropout_seed,
                                                         self.cfg.n_blocks)
        x = self.input_proj(self.subsample(mels))
        off = None if self.mesh is None else (
            self.mesh.batch_offset(x.shape[0]), 0, 0)
        x = self.dropout(x, input_seed, off)
        l = x.shape[1]
        attn_mask = frame_mask = out_lengths = None
        if lengths is not None:
            out_lengths = subsampled_length(lengths)
            frame_mask = padding_mask(out_lengths, l)
            attn_mask = attention_pad_mask(out_lengths, l)
        pos_emb = None
        if self.cfg.attention_impl == "xla":
            pos_emb = relative_positional_encoding(l, self.cfg.d_model,
                                                   self.compute_dtype, x.device)
        remat = (self.cfg.use_remat and self.training
                 and torch.is_grad_enabled())
        sp = seq_shard(self.mesh, self.cfg, l)
        if sp is not None:
            x = sp.scatter(x)
        x = apply_block_stack(self.blocks, x, pos_emb, attn_mask, frame_mask,
                              out_lengths, block_seeds, remat, sp)
        if sp is not None:
            x = sp.gather_replicated(x)
        return x, out_lengths
