"""Top-level Conformer CTC model: encoder -> LSTM decoder -> fp32 logits
(counterpart of conformer_tpu/models/conformer.py).

``Conformer(cfg, compute_dtype)(mels (B, T, n_mels), lengths) ->
(logits (B, T', vocab) fp32, subsampled lengths)``; in ``train()`` mode with
a ``dropout_seed`` it drops as the JAX train model does. ``init_weights`` gives
seeded random weights with the JAX package's initialiser families.
``build_model`` builds the model of ``model.arch`` ('ctc' here, 'transducer'
in models/transducer.py) with its seeded random weights.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn

from conformer_tpu_torch.config import ModelConfig
from conformer_tpu_torch.models.attention import RelativeMultiHeadAttention
from conformer_tpu_torch.models.decoder import LSTMDecoder, LSTMLayer
from conformer_tpu_torch.models.encoder import ConformerEncoder
from conformer_tpu_torch.models.layers import (DTYPES, Conv2d, Dense,
                                               DepthwiseConv1d, GroupNorm,
                                               LayerNorm, MaskedBatchNorm)
from conformer_tpu_torch.utils.masking import padding_mask

class Conformer(nn.Module):
    def __init__(self, cfg: ModelConfig, compute_dtype: str = "float32"):
        super().__init__()
        if cfg.arch != "ctc":
            raise ValueError(f"Conformer is the CTC model; model.arch="
                             f"{cfg.arch!r} is built by build_model")
        self.cfg = cfg
        dtype = DTYPES[compute_dtype]
        self.encoder = ConformerEncoder(cfg, dtype)
        self.decoder = LSTMDecoder(cfg.d_model, cfg.vocab_size,
                                   cfg.lstm_hidden_dim, cfg.n_lstm_layers, dtype)

    def forward(self, mels: torch.Tensor,
                lengths: Optional[torch.Tensor] = None,
                dropout_seed: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """dropout_seed: None (no dropout) or the seed of this forward's
        dropout masks (models/encoder.py). BatchNorm uses batch statistics
        in training mode."""
        enc, out_lengths = self.encoder(mels, lengths, dropout_seed)
        frame_mask = None
        if out_lengths is not None and self.cfg.decoder_norm_masked:
            frame_mask = padding_mask(out_lengths, enc.shape[1])
        logits = self.decoder(enc, frame_mask)
        return logits.float(), out_lengths


def build_model(cfg: ModelConfig, compute_dtype: str = "float32",
                seed: Optional[int] = 0) -> nn.Module:
    """The model of ``cfg.arch`` ('ctc' or 'transducer') on the CPU, with
    seeded random weights, or with ``seed=None`` uninitialised (for weights
    that are loaded next)."""
    if cfg.arch == "ctc":
        model, init = Conformer(cfg, compute_dtype), init_weights
    elif cfg.arch == "transducer":
        from conformer_tpu_torch.models import transducer

        model = transducer.Transducer(cfg, compute_dtype)
        init = transducer.init_weights
    else:
        raise ValueError(f"unknown model.arch {cfg.arch!r}: 'ctc' or "
                         "'transducer'")
    return model if seed is None else init(model, seed)


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Truncated normal (2 std) with variance 1/fan_in, flax's lecun_normal."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    x = torch.randn(shape, generator=gen)
    while True:
        bad = x.abs() > 2.0
        if not bad.any():
            return x * std
        x[bad] = torch.randn(int(bad.sum()), generator=gen)


def orthogonal(rows: int, cols: int, gen: torch.Generator) -> torch.Tensor:
    a = torch.randn(max(rows, cols), min(rows, cols), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return (q if rows >= cols else q.T).float()


@torch.no_grad()
def init_weights(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights drawn on the CPU (so every device gets the same
    numbers): lecun-normal kernels, xavier-uniform attention biases, an
    orthogonal LSTM recurrence, zero biases, unit norm scales."""
    gen = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        new = {}
        if isinstance(mod, Dense):
            new["weight"] = lecun_normal(mod.weight.shape, mod.in_features, gen)
            new["bias"] = torch.zeros_like(mod.bias)
        elif isinstance(mod, Conv2d):
            fan_in = mod.weight[0].numel()
            new["weight"] = lecun_normal(mod.weight.shape, fan_in, gen)
            new["bias"] = torch.zeros_like(mod.bias)
        elif isinstance(mod, DepthwiseConv1d):
            new["weight"] = lecun_normal(mod.weight.shape, mod.kernel_size, gen)
            new["bias"] = torch.zeros_like(mod.bias)
        elif isinstance(mod, RelativeMultiHeadAttention):
            h, dh = mod.content_bias.shape
            limit = math.sqrt(6.0 / (h + dh))
            for name in ("content_bias", "position_bias"):
                new[name] = (torch.rand((h, dh), generator=gen) * 2 - 1) * limit
        elif isinstance(mod, LSTMLayer):
            new["weight_ih"] = lecun_normal(mod.weight_ih.shape,
                                             mod.weight_ih.shape[1], gen)
            new["bias_ih"] = torch.zeros_like(mod.bias_ih)
            new["weight_hh"] = orthogonal(mod.hidden_dim, 4 * mod.hidden_dim,
                                           gen).T
        elif isinstance(mod, (LayerNorm, MaskedBatchNorm, GroupNorm)):
            for name, p in mod.named_parameters(recurse=False):
                new[name] = (torch.zeros_like(p) if name == "bias"
                             else torch.ones_like(p))
        for name, value in new.items():
            getattr(mod, name).copy_(value)
    return model
