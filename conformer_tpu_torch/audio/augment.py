"""SpecAugment (counterpart of conformer_tpu/audio/augment.py).

Masks are drawn per example: width ~ U{0..mask_param}, capped at
``prob * axis_len``, then start ~ U{0..axis_len - width - 1} (at least the
first frame); masked cells are set to zero, or to the example's mean when
``zero_masking`` is off. The draws come from a ``torch.Generator`` on the
CPU, so they are not the JAX package's numbers: the law and the structure
are the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from conformer_tpu_torch.config import AugmentConfig


def _axis_masks(gen: torch.Generator, b: int, n_masks: int, mask_param: int,
                axis_len: int, prob: float) -> torch.Tensor:
    """-> (B, axis_len) bool on the CPU, True where masked."""
    widths = torch.randint(0, mask_param + 1, (b, n_masks), generator=gen)
    widths = torch.clamp(widths, max=int(prob * axis_len))
    high = torch.clamp(axis_len - widths, min=1)
    starts = (torch.rand((b, n_masks), generator=gen, dtype=torch.float64)
              * high).long()
    pos = torch.arange(axis_len)[None, None, :]
    in_mask = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return in_mask.any(dim=1)


def spec_augment(gen: torch.Generator, mel: torch.Tensor, cfg: AugmentConfig,
                 lengths: Optional[torch.Tensor] = None,
                 rows: Optional[slice] = None,
                 global_rows: Optional[int] = None) -> torch.Tensor:
    """Apply SpecAugment to a (B, T, F) log-mel batch. Time-mask starts are
    drawn over the padded axis; masking padded frames is harmless. Under a
    mesh, ``mel`` is the ``rows`` of a global batch of ``global_rows``: the
    masks are drawn for the whole of it, as one device draws them, and the
    rank keeps its own."""
    if not cfg.enabled:
        return mel
    b, t, f = mel.shape
    n = b if global_rows is None else global_rows
    tmask = _axis_masks(gen, n, cfg.n_time_masks, cfg.time_mask_param, t,
                        cfg.prob)
    fmask = _axis_masks(gen, n, cfg.n_freq_masks, cfg.freq_mask_param, f,
                        cfg.prob)
    if rows is not None:
        tmask, fmask = tmask[rows], fmask[rows]
    masked = (tmask[:, :, None] | fmask[:, None, :]).to(mel.device)
    if cfg.zero_masking:
        fill = torch.zeros((), dtype=mel.dtype, device=mel.device)
    else:
        fill = mel.mean(dim=(1, 2), keepdim=True)
    return torch.where(masked, fill, mel)
