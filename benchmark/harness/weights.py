"""Seeded weights, made on the device by the benchmark and handed to the
program and to the reference alike.

One ``torch.Generator`` on the device, one normal draw for every matrix
and tensor of the model together, then views: a tensor of two or more
dimensions ~ N(0, 1 / fan_in) (fan_in: the product of all dimensions but
the first); a norm's scale and a running variance 1; biases and running
means 0. Names and shapes are the program's state dict's (its layout);
the numbers are the benchmark's.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _kind(name: str, shape: Tuple[int, ...]) -> str:
    if len(shape) >= 2:
        return "normal"
    if name.endswith((".weight", ".scale", ".var")):
        return "ones"
    return "zeros"


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    names = sorted(shapes)
    normal = [n for n in names if _kind(n, shapes[n]) == "normal"]
    total = sum(math.prod(shapes[n]) for n in normal)
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        kind = _kind(n, shape)
        if kind == "normal":
            size = math.prod(shape)
            out[n] = flat[off:off + size].view(shape) / math.sqrt(
                math.prod(shape[1:]))
            off += size
        elif kind == "ones":
            out[n] = torch.ones(shape, device=device)
        else:
            out[n] = torch.zeros(shape, device=device)
    return out
