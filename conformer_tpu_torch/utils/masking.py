"""Length and mask arithmetic (counterpart of conformer_tpu/utils/masking.py).

- frames after the mel frontend: ``samples // hop + 1``;
- frames after the two stride-2 subsampling convs: ``((n - 1) // 2 - 1) // 2``,
  clamped at 0;
- padding masks are True at *valid* positions; the attention mask is True at
  PAD keys.
"""

from __future__ import annotations

from typing import Union

import torch

IntOrTensor = Union[int, torch.Tensor]


def mel_frame_length(num_samples: IntOrTensor, hop_length: int) -> IntOrTensor:
    """Frames produced by a centred STFT with win == n_fft and the given hop."""
    return num_samples // hop_length + 1


def subsampled_length(lengths: IntOrTensor) -> IntOrTensor:
    """Frames surviving two stride-2 valid 3x3 convolutions, clamped at 0."""
    raw = ((lengths - 1) // 2 - 1) // 2
    if isinstance(raw, int):
        return max(raw, 0)
    return torch.clamp(raw, min=0)


def padding_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_length) bool, True where the position is valid."""
    positions = torch.arange(max_length, device=lengths.device)[None, :]
    return lengths[:, None] > positions


def attention_pad_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """(B,) lengths -> (B, 1, 1, L) bool, True at PAD key positions."""
    return (~padding_mask(lengths, max_length))[:, None, None, :]
