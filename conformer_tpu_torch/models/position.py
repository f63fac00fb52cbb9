"""Transformer-XL relative sinusoidal positional encoding
(counterpart of conformer_tpu/models/position.py).

For length L, a (2L-1, d) table whose row j encodes relative position L-1-j:
the flipped sinusoid of [L-1 .. 0] followed by the sinusoid of the negated
angles [-1 .. -(L-1)].
"""

from __future__ import annotations

import numpy as np
import torch


def relative_positional_encoding(length: int, d_model: int,
                                 dtype=torch.float32,
                                 device="cpu") -> torch.Tensor:
    """-> (2*length - 1, d_model) relative PE table; row j <-> position L-1-j."""
    inv_freq = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * -(np.log(10000.0) / d_model))
    angles = np.arange(length, dtype=np.float64)[:, None] * inv_freq[None, :]
    pe_pos = np.zeros((length, d_model))
    pe_pos[:, 0::2] = np.sin(angles)
    pe_pos[:, 1::2] = np.cos(angles)
    pe_neg = np.zeros((length, d_model))
    pe_neg[:, 0::2] = np.sin(-angles)
    pe_neg[:, 1::2] = np.cos(-angles)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    return torch.from_numpy(pe).to(device=device, dtype=dtype)
