"""Optimizer, learning-rate schedule and parameter count (counterpart of
conformer_tpu/train/state.py).

The JAX package chains optax transformations: optional global-norm
clipping, then Adam (AdamW when ``weight_decay > 0``) scaled by a staircase
exponential decay, with an optional linear warmup in front. Here the update
is ``torch.optim.Adam`` / ``AdamW`` (the same formulas: bias-corrected
moments, ``eps`` outside the square root, decoupled weight decay scaled by
the learning rate), the schedule is evaluated at the count of updates made
so far as optax's is, and clipping is done the optax way,
``g / ||g|| * c`` where ``||g|| >= c`` (not ``clip_grad_norm_``, which adds
1e-6 to the norm).

Under a mesh (parallel/mesh.py) the optimizer sums the gradients over the
data group (each rank's loss is its rows' sum over the global count, so the
sum is the gradient of the global mean), and over the model group those of
the parameters that sequence parallelism leaves partial; the global norm
sums squares over the model group for the split parameters and counts a
replicated one once, so clipping is the single-device clipping. With
``zero`` (ZeRO-1, ``parallel.zero``) each data rank keeps Adam's moments for
its slice of each parameter (the dimension ``mesh.zero_dim`` picks), updates
that slice, and the slices are gathered back into the parameters: the
numbers of the unsharded update, with the moments' memory cut by dp.
``state_dict`` gives, and ``load_state_dict`` takes, the single-device
format.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

from conformer_tpu_torch.config import OptimConfig
from conformer_tpu_torch.parallel import collectives as cc
from conformer_tpu_torch.parallel.mesh import (gather_tensors, shard_tensor,
                                               zero_dim)


def make_schedule(cfg: OptimConfig, steps_per_epoch: Optional[int] = None
                  ) -> Callable[[int], float]:
    """-> lr(count): ``optax.exponential_decay(staircase=True)`` every
    ``lr_decay_every_steps`` (or every epoch), behind ``optax.join_schedules``
    with a linear warmup from 0 when ``warmup_steps > 0``."""
    interval = cfg.lr_decay_every_steps or (steps_per_epoch or 1000)

    def decay(count: int) -> float:
        return cfg.learning_rate * cfg.lr_decay_gamma ** (count // interval)

    def schedule(count: int) -> float:
        if cfg.warmup_steps > 0:
            if count < cfg.warmup_steps:
                return cfg.learning_rate * count / cfg.warmup_steps
            return decay(count - cfg.warmup_steps)
        return decay(count)

    return schedule


def lr_at_step(cfg: OptimConfig, step: int,
               steps_per_epoch: Optional[int] = None) -> float:
    """The learning rate of the update made at ``step`` (0-based)."""
    return make_schedule(cfg, steps_per_epoch)(step)


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place, through one flat buffer."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    cc.all_reduce_(flat, group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()


class Optimizer:
    """make_optimizer's result: ``step()`` fills absent gradients with zeros
    (JAX gradients are dense: an unused parameter, such as the attention's
    position bias on the kernel path, gets 0), under a mesh sums them,
    takes the global norm before clipping, clips, sets the scheduled rate
    and updates."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                 steps_per_epoch: Optional[int] = None, mesh=None,
                 zero: bool = False):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.clip = cfg.grad_clip_norm
        self.mesh = mesh
        self.zero_dims = [None] * len(self.params)
        if mesh is not None and zero:
            self.zero_dims = [zero_dim(p.shape, getattr(p, "tp_spec", None),
                                       mesh.dp) for p in self.params]
        # what Adam updates: the parameters, or their ZeRO-1 slices
        self.targets = [p if z is None
                        else torch.nn.Parameter(self._own(p.detach(), z).clone())
                        for p, z in zip(self.params, self.zero_dims)]
        kwargs = dict(lr=self.schedule(0), betas=(cfg.beta1, cfg.beta2),
                      eps=cfg.eps)
        if cfg.weight_decay > 0:
            self.opt = torch.optim.AdamW(self.targets,
                                         weight_decay=cfg.weight_decay, **kwargs)
        else:
            self.opt = torch.optim.Adam(self.targets, **kwargs)
        self.count = 0

    def _own(self, t: torch.Tensor, z: int) -> torch.Tensor:
        return t.chunk(self.mesh.dp, z)[self.mesh.data_index].contiguous()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """-> the gradients' global norm before clipping (a device scalar)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.mesh is not None:
            partial = [g for p, g in zip(self.params, grads)
                       if getattr(p, "sp_partial", False)]
            if partial:
                _all_reduce_flat(partial, self.mesh.model_group)
            _all_reduce_flat(grads, self.mesh.data_group)
        norm = self._global_norm(grads)
        if self.clip > 0:
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        zs = [(p, t, z) for p, t, z in zip(self.params, self.targets,
                                           self.zero_dims) if z is not None]
        for p, t, z in zs:
            t.data.copy_(self._own(p.detach(), z))
            t.grad = self._own(p.grad, z)
        self.opt.step()
        if zs:
            self._gather_slices(zs)
        self.count += 1
        return norm

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares of every element, in fp32."""
        norms = [torch.linalg.vector_norm(g.float()) for g in grads]
        split = [i for i, p in enumerate(self.params)
                 if getattr(p, "tp_spec", None) is not None]
        if self.mesh is not None and split:
            sq = torch.stack([norms[i] * norms[i] for i in split])
            sq = torch.sqrt(cc.all_reduce_(sq, self.mesh.model_group))
            for j, i in enumerate(split):
                norms[i] = sq[j]
        return torch.linalg.vector_norm(torch.stack(norms))

    def _gather_slices(self, zs) -> None:
        """Every data rank's updated slices -> the whole parameters."""
        full = gather_tensors([t.detach() for _, t, _ in zs],
                              [z for _, _, z in zs], self.mesh.data_group)
        for (p, _, _), f in zip(zs, full):
            p.data.copy_(f)

    def state_dict(self) -> Dict:
        """The single-device format (under a mesh a collective: every rank
        calls it)."""
        state = self.opt.state_dict()
        if self.mesh is not None:
            # the moments: ZeRO-1's slices over the data group, then the
            # split parameters' over the model group, each in one gather
            keys = [(i, k) for i, entry in state["state"].items()
                    for k, v in entry.items()
                    if torch.is_tensor(v) and v.dim() > 0]
            vals = [state["state"][i][k] for i, k in keys]
            vals = gather_tensors(vals, [self.zero_dims[i] for i, _ in keys],
                                  self.mesh.data_group)
            vals = gather_tensors(
                vals, [getattr(self.params[i], "tp_spec", None)
                       for i, _ in keys], self.mesh.model_group)
            whole = {i: dict(entry) for i, entry in state["state"].items()}
            for (i, k), v in zip(keys, vals):
                whole[i][k] = v
            state = {"state": whole, "param_groups": state["param_groups"]}
        return {"opt": state, "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        opt = state["opt"]
        if self.mesh is not None:
            mesh = self.mesh
            parts = {}
            for i, entry in opt["state"].items():
                p, z = self.params[int(i)], self.zero_dims[int(i)]
                parts[i] = {}
                for k, v in entry.items():
                    if torch.is_tensor(v) and v.dim() > 0:
                        v = shard_tensor(v, getattr(p, "tp_spec", None),
                                         mesh.model_index, mesh.tp)
                        if z is not None:
                            v = self._own(v, z)
                    parts[i][k] = v
            opt = {"state": parts, "param_groups": opt["param_groups"]}
        self.opt.load_state_dict(opt)
        self.count = int(state["count"])


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: Optional[int] = None, mesh=None,
                   zero: bool = False) -> Optimizer:
    """Adam + exponential LR decay (reference: train.py:188-189, Adam
    lr=2e-5, ExponentialLR gamma=0.9999 stepped per epoch); per-epoch when
    ``lr_decay_every_steps == 0``, else every N steps. Warmup, clipping and
    weight decay are optional; ``mesh`` and ``zero`` as Optimizer's."""
    return Optimizer(params, cfg, steps_per_epoch, mesh, zero)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
