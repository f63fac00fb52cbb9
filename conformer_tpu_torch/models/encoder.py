"""Conformer encoder: subsample -> project -> N macaron blocks
(counterpart of conformer_tpu/models/encoder.py).

Each block: [0.5*ffn + x] -> [mhsa + x] -> [conv + x] -> [0.5*ffn + x] ->
LayerNorm. The stack is an unrolled loop over ``blocks``; the JAX package's
scan and remat options change how XLA compiles it, not what it computes,
and have no effect here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from conformer_tpu_torch.config import ModelConfig
from conformer_tpu_torch.models.attention import MHSAModule
from conformer_tpu_torch.models.layers import (DTYPES, ConvolutionModule,
                                               ConvolutionSubsampling, Dense,
                                               FeedForwardModule, LayerNorm)
from conformer_tpu_torch.models.position import relative_positional_encoding
from conformer_tpu_torch.utils.masking import (attention_pad_mask,
                                               padding_mask, subsampled_length)

class ConformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ffn1 = FeedForwardModule(d, cfg.ffn_expansion, dtype)
        self.mhsa = MHSAModule(d, cfg.n_heads, dtype, cfg.attention_impl,
                               DTYPES[cfg.attention_score_dtype])
        self.conv = ConvolutionModule(d, cfg.kernel_size, cfg.conv_norm,
                                      cfg.conv_impl, cfg.conv_mask_pad, dtype)
        self.ffn2 = FeedForwardModule(d, cfg.ffn_expansion, dtype)
        self.final_norm = LayerNorm(d, dtype)

    def forward(self, x: torch.Tensor, pos_emb: Optional[torch.Tensor],
                attn_mask: Optional[torch.Tensor],
                frame_mask: Optional[torch.Tensor],
                lengths: Optional[torch.Tensor]) -> torch.Tensor:
        x = 0.5 * self.ffn1(x) + x
        x = self.mhsa(x, pos_emb, attn_mask, lengths) + x
        x = self.conv(x, frame_mask) + x
        x = 0.5 * self.ffn2(x) + x
        return self.final_norm(x)


def apply_block_stack(blocks: nn.ModuleList, x: torch.Tensor,
                      pos_emb: Optional[torch.Tensor],
                      attn_mask: Optional[torch.Tensor],
                      frame_mask: Optional[torch.Tensor],
                      lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Apply the N-block stack in order."""
    for block in blocks:
        x = block(x, pos_emb, attn_mask, frame_mask, lengths)
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
        self.blocks = nn.ModuleList(ConformerBlock(cfg, dtype)
                                    for _ in range(cfg.n_blocks))

    def forward(self, mels: torch.Tensor,
                lengths: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """mels: (B, T, n_mels); lengths: (B,) valid frames.
        -> (B, T', d_model) encodings and subsampled lengths."""
        x = self.input_proj(self.subsample(mels))
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
        x = apply_block_stack(self.blocks, x, pos_emb, attn_mask, frame_mask,
                              out_lengths)
        return x, out_lengths
