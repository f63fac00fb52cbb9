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
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

from conformer_tpu_torch.config import OptimConfig


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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))


class Optimizer:
    """make_optimizer's result: ``step()`` fills absent gradients with zeros
    (JAX gradients are dense: an unused parameter, such as the attention's
    position bias on the kernel path, gets 0), takes the global norm before
    clipping, clips, sets the scheduled rate and updates."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cfg: OptimConfig,
                 steps_per_epoch: Optional[int] = None):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = make_schedule(cfg, steps_per_epoch)
        self.clip = cfg.grad_clip_norm
        kwargs = dict(lr=self.schedule(0), betas=(cfg.beta1, cfg.beta2),
                      eps=cfg.eps)
        if cfg.weight_decay > 0:
            self.opt = torch.optim.AdamW(self.params,
                                         weight_decay=cfg.weight_decay, **kwargs)
        else:
            self.opt = torch.optim.Adam(self.params, **kwargs)
        self.count = 0

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """-> the gradients' global norm before clipping (a device scalar)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        if self.clip > 0:
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            for g in grads:
                g.mul_(scale.to(g.dtype))
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.opt.load_state_dict(state["opt"])
        self.count = int(state["count"])


def make_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter],
                   steps_per_epoch: Optional[int] = None) -> Optimizer:
    """Adam + exponential LR decay (reference: train.py:188-189, Adam
    lr=2e-5, ExponentialLR gamma=0.9999 stepped per epoch); per-epoch when
    ``lr_decay_every_steps == 0``, else every N steps. Warmup, clipping and
    weight decay are optional."""
    return Optimizer(params, cfg, steps_per_epoch)


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
