"""Dropout with the stateless hash mask (counterpart of
conformer_tpu/models/dropout.py).

``impl='hash'`` derives the keep mask from a murmur3-style finaliser of the
element coordinates and per-site seed words, bit for bit the JAX package's
``hash_keep``. torch has little uint32 arithmetic, so the hash runs in int64
with every product and sum cut back to 32 bits; the values then stay
non-negative and the right shifts are logical. ``impl='prng'`` is
``F.dropout``: the JAX PRNG path matches no other generator either.

The seed-independent part of the hash (the sum of each coordinate times its
axis multiplier) is cached per shape and device, so a call costs the seed
mix and the finaliser. This is plain PyTorch on every device: XLA fuses the
chain on the TPU, and a fused kernel for it is later work.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_AXIS_MULTS = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x01000193,
               0x61C88647, 0x9E3779B9)
M32 = 0xFFFFFFFF
# (shape, device) -> int64 tensor of sum_axis(index * multiplier) mod 2^32
_coord_cache: Dict[tuple, torch.Tensor] = {}


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant or
    int64 tensor c in [0, 2^32), in two 16-bit halves of c so no product
    leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def finalize(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def threshold(rate: float) -> int:
    """Keep where hash >= this: P(keep) = 1 - rate."""
    return int(rate * 4294967296.0) & M32


def _coords(shape: Sequence[int], device) -> torch.Tensor:
    key = (tuple(shape), str(device))
    if key not in _coord_cache:
        # a normal tensor even under inference_mode: training reuses it
        with torch.inference_mode(False):
            x = torch.zeros(shape, dtype=torch.int64, device=device)
            for axis, n in enumerate(shape):
                idx = torch.arange(n, dtype=torch.int64, device=device)
                view = [1] * len(shape)
                view[axis] = n
                x = (x + mul32(idx, _AXIS_MULTS[axis % len(_AXIS_MULTS)])
                     .view(view)) & M32
        _coord_cache[key] = x
    return _coord_cache[key]


def hash_keep(shape: Sequence[int], seed_words: Sequence[int], rate: float,
              device="cpu", offsets: Optional[Sequence[int]] = None
              ) -> torch.Tensor:
    """Boolean keep mask of ``shape``, P(keep) = 1 - rate; seed_words: the
    uint32 words mixed into the hash, as Python ints. ``offsets``: where
    the tensor starts in a larger one on each axis (a rank's part of the
    global array under a mesh): the mask is then that part of the larger
    one's. The coordinate sum is linear in each index, so the offsets add
    one constant to the hash input. The first axis's offset may also be a
    (shape[0],) int64 tensor, one offset a row (rows that are not one
    contiguous run of the larger array)."""
    h = 0x9E3779B9
    for w in seed_words:
        h = (h * 0x01000193 + (int(w) & M32)) & M32
    rows = None
    for axis, off in enumerate(offsets or ()):
        mult = _AXIS_MULTS[axis % len(_AXIS_MULTS)]
        if isinstance(off, torch.Tensor):
            rows = mul32(off.to(device) & M32, mult).view(
                (-1,) + (1,) * (len(shape) - 1))
        else:
            h = (h + int(off) * mult) & M32
    x = (_coords(shape, device) + h) & M32
    if rows is not None:
        x = (x + rows) & M32
    return finalize(x) >= threshold(rate)


class Dropout(nn.Module):
    """``forward(x, seed_words[, offsets])``: identity when ``seed_words``
    is None (no mask drawn: evaluation) or the rate is 0."""

    def __init__(self, rate: float, impl: str = "hash"):
        super().__init__()
        if impl not in ("hash", "prng"):
            raise ValueError(f"unknown dropout_impl {impl!r}")
        self.rate, self.impl = float(rate), impl

    def forward(self, x: torch.Tensor,
                seed_words: Optional[Sequence[int]],
                offsets: Optional[Sequence[int]] = None) -> torch.Tensor:
        """offsets: as hash_keep's."""
        if seed_words is None or self.rate == 0.0:
            return x
        if self.impl == "prng":
            return F.dropout(x, self.rate, training=True)
        keep = hash_keep(x.shape, seed_words, self.rate, x.device, offsets)
        # the scale is rounded to x's dtype first, as jnp.asarray(.., x.dtype)
        scale = torch.tensor(1.0 / (1.0 - self.rate), dtype=x.dtype).item()
        return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))
