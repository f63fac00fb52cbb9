"""What a training step draws from its seed, worked out again for the
reference: SpecAugment's masks, the dropout seeds of a forward, the
stateless hash masks of every dropout site and of the attention
probabilities.

Frozen copies, so that a later change to the program cannot move what the
reference computes:

- ``step_generator``, the draw order of a step: conformer_tpu_torch/train/
  steps.py:42-47 and :122-135;
- ``axis_masks``, ``spec_augment_masks``: conformer_tpu_torch/audio/
  augment.py:20-57;
- ``seed_words``: conformer_tpu_torch/models/encoder.py:47-55;
- ``mul32``, ``finalize``, ``threshold``, ``hash_keep``:
  conformer_tpu_torch/models/dropout.py:24-101 (no mesh offsets);
- ``attention_keep``, ``hash_tq``: conformer_tpu_torch/ops/cuda/
  sincos_attention.py:141-174, and the kernel seed of
  models/attention.py:64-79 (no mesh).

Imports only torch.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

M32 = 0xFFFFFFFF
AXIS_MULTS = (0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F, 0x01000193,
              0x61C88647, 0x9E3779B9)
SITES_PER_BLOCK = 7


def step_generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed(
        ((int(seed) & M32) << 32) | (int(step) & M32))


def axis_masks(gen: torch.Generator, b: int, n_masks: int, mask_param: int,
               axis_len: int, prob: float) -> torch.Tensor:
    """-> (B, axis_len) bool on the CPU, True where masked."""
    widths = torch.randint(0, mask_param + 1, (b, n_masks), generator=gen)
    widths = torch.clamp(widths, max=int(prob * axis_len))
    high = torch.clamp(axis_len - widths, min=1)
    starts = (torch.rand((b, n_masks), generator=gen, dtype=torch.float64)
              * high).long()
    pos = torch.arange(axis_len)[None, None, :]
    hit = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return hit.any(dim=1)


def spec_augment_masks(gen: torch.Generator, b: int, t: int, f: int,
                       augment: dict) -> torch.Tensor:
    """-> (B, T, F) bool, True where SpecAugment zeroes the log-mels."""
    tmask = axis_masks(gen, b, augment["n_time_masks"],
                       augment["time_mask_param"], t, augment["prob"])
    fmask = axis_masks(gen, b, augment["n_freq_masks"],
                       augment["freq_mask_param"], f, augment["prob"])
    return tmask[:, :, None] | fmask[:, None, :]


def step_draws(seed: int, step: int, b: int, t: int, f: int, augment: dict
               ) -> Tuple[torch.Tensor, int]:
    """-> (SpecAugment mask or None, the forward's dropout seed): a step's
    draws in the program's order (one micro-batch)."""
    gen = step_generator(seed, step)
    mask = (spec_augment_masks(gen, b, t, f, augment)
            if augment["enabled"] else None)
    dropout_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen)[0])
    return mask, dropout_seed


def seed_words(seed: int, n_blocks: int
               ) -> Tuple[List[int], List[List[List[int]]]]:
    """-> (the input projection's two words, each block's 7 pairs)."""
    gen = torch.Generator().manual_seed(int(seed))
    words = torch.randint(0, 2 ** 32, (1 + n_blocks * SITES_PER_BLOCK, 2),
                          generator=gen, dtype=torch.int64).tolist()
    return words[0], [words[1 + i * SITES_PER_BLOCK:
                            1 + (i + 1) * SITES_PER_BLOCK]
                      for i in range(n_blocks)]


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def finalize(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def threshold(rate: float) -> int:
    return int(rate * 4294967296.0) & M32


def hash_keep(shape: Sequence[int], words: Sequence[int], rate: float,
              device) -> torch.Tensor:
    """Keep mask of a dropout site: murmur3's finaliser of the sum of each
    coordinate times its axis multiplier plus the mixed seed words."""
    h = 0x9E3779B9
    for w in words:
        h = (h * 0x01000193 + (int(w) & M32)) & M32
    x = torch.zeros(tuple(shape), dtype=torch.int64, device=device)
    for axis, n in enumerate(shape):
        idx = torch.arange(n, dtype=torch.int64, device=device)
        view = [1] * len(shape)
        view[axis] = n
        x = (x + mul32(idx, AXIS_MULTS[axis % len(AXIS_MULTS)]).view(view)) \
            & M32
    return finalize((x + h) & M32) >= threshold(rate)


def hash_tq(l: int) -> int:
    l_pad = ((l + 127) // 128) * 128
    auto = l_pad if l_pad <= 256 else 128
    return min(auto, ((l + 7) // 8) * 8)


def attention_keep(word: int, b: int, h: int, l: int, rate: float,
                   device) -> torch.Tensor:
    """(B, H, L, L) keep mask of the attention probabilities: (batch row,
    head, query tile, row in the tile, key) hashed with the kernel seed of
    the site's first word."""
    seed = int(word) & 0x7FFFFFFF
    tq = hash_tq(l)
    i64 = dict(dtype=torch.int64, device=device)
    bi = torch.arange(b, **i64).view(b, 1, 1, 1)
    hi = torch.arange(h, **i64).view(1, h, 1, 1)
    i = torch.arange(l, **i64).view(1, 1, l, 1)
    col = torch.arange(l, **i64).view(1, 1, 1, l)
    base = (mul32(torch.tensor(seed & M32, **i64), 0x9E3779B9)
            + mul32(bi, 0x85EBCA6B) + mul32(hi, 0xC2B2AE35)
            + mul32(i // tq, 0x27D4EB2F)) & M32
    x = (base + col + mul32(i % tq, 0x01000193)) & M32
    return finalize(x) >= threshold(rate)
