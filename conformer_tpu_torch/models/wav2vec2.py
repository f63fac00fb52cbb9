"""wav2vec2-style contrastive pretraining of the Conformer encoder
(counterpart of conformer_tpu/models/wav2vec2.py).

  subsample -> [target branch: Gumbel-quantize the *unmasked* features,
                project to proj_dim]
            -> [context branch: input projection (no dropout after it),
                masked frames replaced by a learned embedding, the conformer
                blocks, project to proj_dim]
  loss = InfoNCE (context at the masked steps against the quantized
         targets) + a diversity penalty on codebook use (train/pretrain.py).

The module names are ``ConformerEncoder``'s (``subsample``, ``input_proj``,
``blocks``), so the encoder transfer (train/pretrain.py::transfer_encoder)
goes by name. The blocks run through models/encoder.py::apply_block_stack:
the attention kernels under ``attention_impl='pallas'``, remat, hash
dropout, as in the supervised encoder.

The random draws (mask starts, Gumbel noise, sampled negatives) come from
the caller's generators; each can be given instead, so that a test feeds
the JAX package's draws.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from conformer_tpu_torch.config import ModelConfig, PretrainConfig
from conformer_tpu_torch.models.encoder import (ConformerBlock,
                                                apply_block_stack,
                                                dropout_seed_words)
from conformer_tpu_torch.models.layers import ConvolutionSubsampling, Dense
from conformer_tpu_torch.models.position import relative_positional_encoding
from conformer_tpu_torch.models.quantizer import GumbelQuantizer
from conformer_tpu_torch.utils.masking import (attention_pad_mask,
                                               padding_mask, subsampled_length)


def sample_mask_starts(generator: torch.Generator, batch: int, length: int,
                       mask_prob: float) -> torch.Tensor:
    """(B, T) bool on the CPU: Bernoulli(mask_prob) span starts."""
    return torch.rand((batch, length), generator=generator) < mask_prob


def dilate_mask_starts(starts: torch.Tensor, span: int,
                       valid_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(B, T) starts -> (B, T) span mask: frame j is masked when a start
    lies in (j - span, j] (a cumulative max of the start positions), and
    only where ``valid_mask`` is True."""
    idx = torch.arange(starts.shape[1], device=starts.device)
    start_idx = torch.where(starts, idx, torch.full_like(idx, -span - 1))
    best = torch.cummax(start_idx, dim=1).values
    mask = (idx - best) < span
    if valid_mask is not None:
        mask = mask & valid_mask
    return mask


def sample_mask_spans(generator: torch.Generator, batch: int, length: int,
                      mask_prob: float, span: int,
                      valid_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(B, T) bool span mask: Bernoulli(mask_prob) starts dilated to
    ``span`` frames, on ``valid_mask``'s device (the CPU without one)."""
    starts = sample_mask_starts(generator, batch, length, mask_prob)
    if valid_mask is not None:
        starts = starts.to(valid_mask.device)
    return dilate_mask_starts(starts, span, valid_mask)


def sample_negatives(generator: torch.Generator, batch: int, length: int,
                     num_negatives: int, device) -> torch.Tensor:
    """(B, T, K) int64 negative indices, uniform over the other T - 1 steps
    of the utterance: ``randint(0, T - 1) + (raw >= own)``; ``generator``
    lives on ``device``."""
    raw = torch.randint(0, length - 1, (batch, length, num_negatives),
                        generator=generator, device=device)
    own = torch.arange(length, device=device)[:, None]
    return raw + (raw >= own).long()


class Wav2Vec2Pretrain(nn.Module):
    def __init__(self, cfg: ModelConfig, pre: PretrainConfig,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.compute_dtype = cfg, dtype
        d = cfg.d_model
        freq = ((cfg.n_mel_channels - 1) // 2 - 1) // 2
        self.subsample = ConvolutionSubsampling(d, cfg.subsample_impl, dtype)
        self.quantizer = GumbelQuantizer(d * freq, pre.num_groups,
                                         pre.num_vars, pre.proj_dim, dtype)
        self.target_proj = Dense(pre.proj_dim, pre.proj_dim, dtype)
        self.input_proj = Dense(d * freq, d, dtype)
        self.mask_embedding = nn.Parameter(torch.empty(d))
        self.blocks = nn.ModuleList(ConformerBlock(cfg, dtype)
                                    for _ in range(cfg.n_blocks))
        self.context_proj = Dense(d, pre.proj_dim, dtype)

    def forward(self, mels: torch.Tensor, lengths: Optional[torch.Tensor],
                mask_time_indices: torch.Tensor, temperature: float = 2.0,
                dropout_seed: Optional[int] = None,
                gumbels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """mels (B, T, n_mels); mask_time_indices (B, T') from
        sample_mask_spans; dropout_seed: None (no dropout) or this
        forward's seed; gumbels / generator: the quantizer's noise in
        training. -> (context (B, T', proj) fp32, target (B, T', proj)
        fp32, perplexity)."""
        features = self.subsample(mels)
        t = features.shape[1]
        quantized, perplexity = self.quantizer(
            features, mask_time_indices, temperature, gumbels, generator)
        target = self.target_proj(quantized)

        x = self.input_proj(features)
        x = torch.where(mask_time_indices[..., None],
                        self.mask_embedding.to(x.dtype), x)
        attn_mask = frame_mask = out_lengths = None
        if lengths is not None:
            out_lengths = subsampled_length(lengths)
            frame_mask = padding_mask(out_lengths, t)
            attn_mask = attention_pad_mask(out_lengths, t)
        pos_emb = None
        if self.cfg.attention_impl == "xla":
            pos_emb = relative_positional_encoding(t, self.cfg.d_model,
                                                   self.compute_dtype, x.device)
        block_seeds = None
        if dropout_seed is not None and self.cfg.dropout_rate > 0.0:
            # the input projection's words go unused: no dropout after it
            _, block_seeds = dropout_seed_words(dropout_seed, self.cfg.n_blocks)
        remat = (self.cfg.use_remat and self.training
                 and torch.is_grad_enabled())
        x = apply_block_stack(self.blocks, x, pos_emb, attn_mask, frame_mask,
                              out_lengths, block_seeds, remat)
        context = self.context_proj(x)
        return context.float(), target.float(), perplexity


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def contrastive_loss(context: torch.Tensor, target: torch.Tensor,
                     mask_time_indices: torch.Tensor,
                     num_negatives: int = 100, temperature: float = 0.1,
                     negatives_impl: str = "sampled",
                     negatives: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """InfoNCE over the masked steps with in-utterance negatives, on cosine
    logits over ``temperature``. context/target (B, T, D) fp32;
    mask_time_indices (B, T) bool. -> (mean loss over the masked steps,
    accuracy).

    ``negatives_impl='all'``: every step of the utterance is a candidate
    (one (B, T, T) product); candidates whose target equals the positive's
    (cosine > 1 - 1e-5) are masked, the positive itself never; padded
    steps stay candidates, as in the JAX package. ``'sampled'``: K
    negatives per step, ``negatives`` (B, T, K) or drawn from ``generator``
    (on the context's device), the same-target ones masked."""
    b, t, _ = context.shape
    ctx_n, tgt_n = _unit(context), _unit(target)
    m = mask_time_indices.float()
    denom = torch.clamp(m.sum(), min=1.0)
    if negatives_impl == "all":
        cos_all = torch.einsum("btd,bsd->bts", ctx_n, tgt_n)
        with torch.no_grad():
            tgt_sim = torch.einsum("btd,bsd->bts", tgt_n, tgt_n)
        eye = torch.eye(t, dtype=torch.bool, device=context.device)[None]
        same = (tgt_sim > 1.0 - 1e-5) & ~eye
        logits = torch.where(same, torch.full_like(cos_all, -torch.inf),
                             cos_all / temperature)
        # the positive logit is the row dot (no diagonal gather)
        pos = torch.einsum("btd,btd->bt", ctx_n, tgt_n) / temperature
        losses = torch.logsumexp(logits, dim=-1) - pos
        loss = (losses * m).sum() / denom
        hits = logits.argmax(dim=-1) == torch.arange(t, device=context.device)
        return loss, (hits.float() * m).sum() / denom
    if negatives_impl != "sampled":
        raise ValueError(f"unknown negatives_impl: {negatives_impl!r}")
    if negatives is None:
        if generator is None:
            raise ValueError("sampled negatives: give negatives or a "
                             "generator")
        negatives = sample_negatives(generator, b, t, num_negatives,
                                     context.device)
    cos_all = torch.einsum("btd,bsd->bts", ctx_n, tgt_n)
    pos = torch.einsum("btd,btd->bt", ctx_n, tgt_n)
    neg = torch.gather(cos_all, 2, negatives)
    logits = torch.cat([pos[:, :, None], neg], dim=2) / temperature
    with torch.no_grad():
        tgt_sim = torch.einsum("btd,bsd->bts", tgt_n, tgt_n)
        same_neg = torch.gather(tgt_sim, 2, negatives) > 1.0 - 1e-5
    same = torch.cat([torch.zeros_like(same_neg[:, :, :1]), same_neg], dim=2)
    logits = torch.where(same, torch.full_like(logits, -torch.inf), logits)
    losses = -torch.log_softmax(logits, dim=-1)[..., 0]
    loss = (losses * m).sum() / denom
    return loss, ((logits.argmax(dim=-1) == 0).float() * m).sum() / denom
