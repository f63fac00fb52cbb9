"""Checkpoints with keep-N rotation and resume (counterpart of
conformer_tpu/train/checkpoint.py, which uses orbax).

One ``torch.save`` file per saved step, ``ckpt_<step>.pt``, holding the
model state (parameters and BatchNorm statistics), the optimizer state, the
step and the epoch. A save writes a temporary file and renames it, so a
checkpoint on disk is always whole. Which checkpoints exist, and so which
are the newest N to keep, is read from the directory, not remembered.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

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
        payload = {"model": model.state_dict(),
                   "optimizer": optimizer.state_dict(),
                   "step": int(step), "epoch": int(epoch)}
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            os.remove(self._path(old))

    def restore(self, model: torch.nn.Module, optimizer,
                step: Optional[int] = None) -> Tuple[int, int]:
        """Load the checkpoint of ``step`` (default: the newest) into model
        and optimizer. -> (step, epoch)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device)
        model.load_state_dict(payload["model"])
        optimizer.load_state_dict(payload["optimizer"])
        return int(payload["step"]), int(payload["epoch"])
