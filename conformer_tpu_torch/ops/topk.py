"""Exact top-k in ``jax.lax.top_k``'s order (counterpart of
conformer_tpu/ops/topk.py).

The device beam searches rank candidates by score and break ties by
position, lowest first, as ``lax.top_k`` and a stable ``argsort`` do; a
different tie order changes which beams survive, not only their order.
``torch.topk`` documents no tie order, so it is not used.

``topk_lastaxis``: k passes of ``max`` over the last axis (which returns
the first maximal index) and masking that one element, as the JAX function
does: for a small k over the vocabulary. ``topk_stable``: one stable
descending sort, for a k near the axis' size (the RNN-T survivor choice,
190 of 1520). Both add 0.0 to the keys first, so that -0.0 ties +0.0 as it
does in ``lax.sort``'s comparator.
"""

from __future__ import annotations

from typing import Tuple

import torch

NEG = -1e30


def topk_lastaxis(x: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest along the last axis,
    descending, ties lowest index first, for inputs >= NEG (the decode
    convention for masked lanes): the mask sentinel 2 * NEG lies below
    every live lane, so each pass removes exactly one element."""
    iota = torch.arange(x.shape[-1], device=x.device)
    cur = x + 0.0
    vals, idxs = [], []
    for _ in range(k):
        m, i = cur.max(dim=-1)
        vals.append(m)
        idxs.append(i)
        cur = torch.where(iota == i[..., None], 2.0 * NEG, cur)
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def topk_stable(x: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(x, k)`` along the last axis by one stable descending
    sort: the same values and indices as topk_lastaxis."""
    values, indices = torch.sort(x + 0.0, dim=-1, descending=True,
                                 stable=True)
    return values[..., :k], indices[..., :k]


def argsort_desc(x: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(-x)`` along the last axis (stable: ties keep their
    order)."""
    return torch.sort(x + 0.0, dim=-1, descending=True, stable=True).indices
