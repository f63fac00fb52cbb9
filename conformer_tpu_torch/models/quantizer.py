"""Gumbel-softmax vector quantizer for wav2vec2-style pretraining
(counterpart of conformer_tpu/models/quantizer.py).

Grouped codebooks (G groups x V codes, ``codevector_dim / G`` wide each), a
linear projection from the subsampled feature width to G * V logits, the
hard Gumbel-softmax with a straight-through gradient in training and the
argmax one-hot in evaluation, and the diversity perplexity of the mean
code distribution over the masked steps (the softmax of the logits without
noise in training, the one-hot in evaluation).

The Gumbel noise is an input: by default it is drawn on the features'
device from the caller's generator (``gumbel_noise``); a test passes the
JAX package's draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from conformer_tpu_torch.models.layers import Dense


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel draws in fp32, ``-log(-log(u))`` with u uniform in
    [tiny, 1) as ``jax.random.gumbel`` takes it; ``generator`` lives on
    ``device``."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class GumbelQuantizer(nn.Module):
    def __init__(self, input_dim: int, num_groups: int = 2,
                 num_vars: int = 320, codevector_dim: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if codevector_dim % num_groups:
            raise ValueError("codevector_dim must divide num_groups")
        self.num_groups, self.num_vars = num_groups, num_vars
        self.codevector_dim = codevector_dim
        self.weight_proj = Dense(input_dim, num_groups * num_vars, dtype)
        self.codevectors = nn.Parameter(
            torch.empty(num_groups * num_vars, codevector_dim // num_groups))

    def forward(self, features: torch.Tensor,
                mask_time_indices: Optional[torch.Tensor] = None,
                temperature: float = 2.0,
                gumbels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """features (B, T, input_dim) -> (codevectors (B, T, codevector_dim)
        fp32, perplexity scalar). In training, ``gumbels`` (B, T, G, V) or,
        without it, draws from ``generator`` (on the features' device)."""
        b, t, _ = features.shape
        g, v = self.num_groups, self.num_vars
        logits = self.weight_proj(features).reshape(b, t, g, v).float()
        if self.training:
            if gumbels is None:
                if generator is None:
                    raise ValueError("training draws Gumbel noise: give "
                                     "gumbels or a generator")
                gumbels = gumbel_noise(logits.shape, generator, logits.device)
            y_soft = torch.softmax((logits + gumbels) / temperature, dim=-1)
            y_hard = F.one_hot(y_soft.argmax(dim=-1), v).float()
            # straight-through: the forward value is (up to rounding) the
            # one-hot, the gradient the soft sample's
            probs = y_hard + y_soft - y_soft.detach()
            soft_dist = torch.softmax(logits, dim=-1)
        else:
            probs = F.one_hot(logits.argmax(dim=-1), v).float()
            soft_dist = probs

        if mask_time_indices is not None:
            m = mask_time_indices.float()[..., None, None]
            marginal = (soft_dist * m).sum(dim=(0, 1)) / torch.clamp(
                m.sum(), min=1.0)
        else:
            marginal = soft_dist.mean(dim=(0, 1))
        perplexity = torch.exp(
            -(marginal * torch.log(marginal + 1e-7)).sum(dim=-1)).sum()

        codebook = self.codevectors.reshape(g, v, -1)
        quantized = torch.einsum("btgv,gvd->btgd", probs, codebook)
        return quantized.reshape(b, t, self.codevector_dim), perplexity
