"""The mesh's collectives, written out (the port's counterpart of what GSPMD
and ``shard_map`` insert for the JAX package).

Plain helpers (``all_reduce_``, ``all_gather``, ``reduce_scatter``) and the
Megatron-style autograd Functions built on them:

- ``copy_to_model``: identity forward, all-reduce of the gradient over the
  model group (the input of a column-parallel product);
- ``reduce_from_model``: all-reduce forward, identity backward (the output
  of a row-parallel product);
- ``gather_from_model`` / ``scatter_to_model``: all-gather along a dimension
  forward and take this rank's part backward, and the converse;
- ``gather_seq`` / ``reduce_scatter_seq``: sequence parallelism's pair, an
  all-gather along L whose backward reduce-scatters, and a reduce-scatter
  whose backward all-gathers;
- ``all_reduce_sum``: an all-reduce whose backward all-reduces too (the
  statistics of a cross-replica BatchNorm, whose consumers are split).

NCCL groups take NCCL's own all-gather and reduce-scatter. gloo has
neither for CUDA tensors, and no reduce-scatter at all; for a gloo group
only, an all-gather is built from one all-reduce of a zero buffer into which
each rank writes its part (x + 0 is exact), and a reduce-scatter is an
all-reduce followed by this rank's slice. gloo moves half-precision tensors
as float32 (exact both ways). Every collective runs on the tensors' own
device: nothing is moved to the CPU here.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


def _gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """The tensor as the group's backend moves it: gloo moves bf16/fp16 as
    fp32."""
    if _gloo(group) and t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    return t


def capturable(group) -> bool:
    """Whether a CUDA graph can hold the collectives of ``group``: NCCL's
    run on the card's stream and can be captured; gloo's stage CUDA
    tensors through the host and cannot."""
    return dist.get_backend(group) == "nccl"


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd); -> t. Over an NCCL
    group of fp32 tensors this is one collective that a CUDA graph can
    capture (the device beam searches' LM probe sums)."""
    w = _wire(t, group)
    dist.all_reduce(w, op=dist.ReduceOp.SUM, group=group)
    if w is not t:
        t.copy_(w)
    return t


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """-> the sum of ``t`` over ``group`` (a new tensor)."""
    return all_reduce_(t.clone(), group)


def all_gather_stack(t: torch.Tensor, group) -> torch.Tensor:
    """-> (n, *t.shape): every rank's ``t`` in group-rank order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    w = _wire(t.contiguous(), group)
    if _gloo(group) and w.is_cuda:
        buf = w.new_zeros((n,) + tuple(w.shape))
        buf[r] = w
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    elif _gloo(group):
        parts: List[torch.Tensor] = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=group)
        buf = torch.stack(parts)
    else:
        buf = w.new_empty((n,) + tuple(w.shape))
        dist.all_gather_into_tensor(buf, w, group=group)
    return buf.to(t.dtype)


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """-> every rank's ``t`` concatenated along ``dim`` in group-rank
    order."""
    return torch.cat(all_gather_stack(t, group).unbind(0), dim=dim)


def reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """-> this rank's part (along ``dim``, split evenly in group-rank order)
    of the sum of ``t`` over ``group``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not split into {n}")
    if _gloo(group):
        return all_reduce(t, group).chunk(n, dim)[r].contiguous()
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def own_part(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's part of ``t`` split evenly along ``dim``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return t.chunk(n, dim)[r].contiguous()


# ---------------------------------------------------------------------------
# Autograd Functions.
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: this rank's part of the gradient
    (``reduce`` False: the consumer is replicated, every rank holds the
    whole gradient) or a reduce-scatter of it (``reduce`` True: each rank's
    consumer saw its own columns, the gradients are partial sums)."""

    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            return reduce_scatter(g, ctx.group, ctx.dim), None, None, None
        return own_part(g, ctx.group, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's part along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return own_part(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """Reduce-scatter along ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather whose backward takes this rank's part."""
    return _Gather.apply(x, group, dim, False)


def scatter_to_model(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _Scatter.apply(x, group, dim)


def gather_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """All-gather whose backward reduce-scatters (the input of a
    column-parallel product under sequence parallelism)."""
    return _Gather.apply(x, group, dim, True)


def reduce_scatter_seq(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ReduceScatter.apply(x, group, dim)
