"""Checkpoints with keep-N rotation and resume (counterpart of
conformer_tpu/train/checkpoint.py, which uses orbax).

One ``torch.save`` file per saved step, ``ckpt_<step>.pt``, holding the
model state (parameters and BatchNorm statistics), the optimizer state, the
step and the epoch. A save writes a temporary file and renames it, so a
checkpoint on disk is always whole. Which checkpoints exist, and so which
are the newest N to keep, is read from the directory, not remembered.

Under a mesh (parallel/mesh.py) the checkpoint keeps the single-device
format: every rank joins in gathering the split parameters and the ZeRO-1
moments, rank 0 writes, and a restore splits them again for the mesh it
loads into, whatever mesh (or none) wrote them. Every rank reads the
directory, so several nodes need it on a shared file system.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from conformer_tpu_torch.parallel.mesh import (full_state_dict,
                                               load_full_state_dict)

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep, self.mesh = keep, mesh

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        """Saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, model: torch.nn.Module, optimizer, step: int,
             epoch: int = 0) -> None:
        payload = {"model": full_state_dict(model, self.mesh),
                   "optimizer": optimizer.state_dict(),
                   "step": int(step), "epoch": int(epoch)}
        if self.mesh is None or self.mesh.rank == 0:
            path = self._path(step)
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(payload, tmp)
            os.replace(tmp, path)
            for old in self.steps()[:-self.keep] if self.keep > 0 else []:
                os.remove(self._path(old))
        if self.mesh is not None:
            dist.barrier()

    def restore(self, model: torch.nn.Module, optimizer=None,
                step: Optional[int] = None) -> Tuple[int, int]:
        """Load the checkpoint of ``step`` (default: the newest) into model
        and, when given, optimizer. -> (step, epoch)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device)
        load_full_state_dict(model, payload["model"], self.mesh)
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])
        return int(payload["step"]), int(payload["epoch"])
