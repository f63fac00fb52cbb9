"""Greedy CTC decoding (counterpart of conformer_tpu/ops/ctc.py).

Argmax per frame, then the reference's collapse rules: blank and ``<UNK>``
frames are dropped *without* updating the previous-token state, so a token
repeated across a blank gap is still collapsed. Vectorised with a cummax
forward fill; returns fixed-shape left-packed token buffers and counts.
The CTC loss comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from conformer_tpu_torch.utils.masking import padding_mask


def greedy_collapse(ids: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                    blank_id: int = 0, unk_id: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ids: (B, T) int. -> (tokens (B, T) left-packed, blank-padded;
    counts (B,))."""
    b, t = ids.shape
    ids = ids.to(torch.int64)
    emittable = ids != blank_id
    if unk_id is not None:
        emittable &= ids != unk_id
    if lengths is not None:
        emittable &= padding_mask(lengths, t)
    pos = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    last_idx = torch.cummax(torch.where(emittable, pos, -1), dim=1).values
    prev_idx = torch.cat([torch.full((b, 1), -1, device=ids.device),
                          last_idx[:, :-1]], dim=1)
    prev_id = torch.where(prev_idx >= 0,
                          torch.gather(ids, 1, prev_idx.clamp(min=0)), -1)
    keep = emittable & (ids != prev_id)
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(ids, 1, order)
    counts = keep.sum(dim=1)
    packed = torch.where(padding_mask(counts, t), packed, blank_id)
    return packed.to(torch.int32), counts.to(torch.int32)


def greedy_decode(logits: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                  blank_id: int = 0, unk_id: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) logits -> (collapsed token buffer (B, T), counts (B,))."""
    return greedy_collapse(torch.argmax(logits, dim=-1), lengths, blank_id,
                           unk_id)
