"""Relative shift for Transformer-XL attention scores
(counterpart of conformer_tpu/ops/rel_shift.py).

Turns raw position scores ``raw[..., i, k] = q_i . p_k`` (row k of the
(2L-1)-row table <-> relative position L-1-k) into aligned scores
``out[..., i, j] = raw[..., i, j - i + L - 1]`` with the pad/reshape trick.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_shift(pos_score: torch.Tensor) -> torch.Tensor:
    """(..., L, 2L-1) -> (..., L, L) shifted scores."""
    *lead, l, m = pos_score.shape
    padded = F.pad(pos_score, (1, 0))                        # (..., L, 2L)
    padded = padded.reshape(*lead, m + 1, l)                 # (..., 2L, L)
    shifted = padded[..., 1:, :].reshape(*lead, l, m)        # drop first row
    return shifted[..., :, : m // 2 + 1]


def rel_shift_reference(pos_score: torch.Tensor) -> torch.Tensor:
    """Naive gather formulation, for the tests."""
    *lead, l, m = pos_score.shape
    i = torch.arange(l)[:, None]
    j = torch.arange(l)[None, :]
    idx = (j - i + (l - 1)).to(pos_score.device).expand(*lead, l, l)
    return torch.gather(pos_score, -1, idx)
