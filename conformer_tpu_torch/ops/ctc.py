"""CTC loss and greedy CTC decoding (counterpart of conformer_tpu/ops/ctc.py).

Loss: fp32 log-softmax, blank 0, each sequence's negative log-likelihood
divided by its label length, then a mean over the rows that ``row_mask``
keeps (dummy padding rows are left out). The dynamic program is
``F.ctc_loss(reduction="none")``: the JAX one is an XLA scan, not a Pallas
kernel. ``zero_infinity`` zeroes a row no alignment fits (more labels than
frames); the JAX lattice uses a finite log-zero (-1e5), so there such a row
keeps a loss of about 1e5 instead (ROADMAP.md, faults).

Greedy decoding: argmax per frame, then the reference's collapse rules:
blank and ``<UNK>`` frames are dropped *without* updating the previous-token
state, so a token repeated across a blank gap is still collapsed. Vectorised
with a cummax forward fill; returns fixed-shape left-packed token buffers
and counts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from conformer_tpu_torch.utils.masking import padding_mask


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank_id: int = 0, zero_infinity: bool = True,
             row_mask: Optional[torch.Tensor] = None,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CTC loss. logits: (B, T, V) unnormalised; logit_lengths: (B,);
    labels: (B, N) int; label_lengths: (B,); row_mask: optional (B,) bool,
    rows where False are left out of the mean; count: optional, the number
    of such rows in the global batch of a mesh (the rows' sum over it: the
    data group then sums the ranks' losses to the global mean)."""
    log_probs = torch.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    per_seq = F.ctc_loss(log_probs, labels.long(), logit_lengths.long(),
                         label_lengths.long(), blank=blank_id,
                         reduction="none", zero_infinity=zero_infinity)
    per_seq = per_seq / torch.clamp(label_lengths.float(), min=1.0)
    if row_mask is not None:
        w = row_mask.float()
        n = w.sum() if count is None else count
        return (per_seq * w).sum() / torch.clamp(n, min=1.0)
    return per_seq.mean()


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
