"""Checkpoints with keep-N rotation and resume, written asynchronously
(counterpart of conformer_tpu/train/checkpoint.py, which uses orbax).

One ``torch.save`` file per saved step, ``ckpt_<step>.pt``, holding the
model state (parameters and BatchNorm statistics), the optimizer state, the
step and the epoch. ``save`` takes a host snapshot of that payload on the
calling thread and returns; one background thread writes it (a temporary
file, then a rename, so a checkpoint on disk is always whole) and rotates
the old ones. At most one write is in flight: a save first waits for the
one before it, as orbax's does. ``wait`` (and ``close``) block until the
write in flight is on disk; ``steps``, ``latest_step`` and ``restore``
wait first, so a restore right after a save reads that save. A write that
fails raises at the next ``save``, ``wait`` or ``close``. Which
checkpoints exist, and so which are the newest N to keep, is read from the
directory, not remembered.

The snapshot is a copy, since the next optimizer step updates the
parameters and moments in place: CUDA tensors are copied into page-locked
host buffers, reused from save to save, on the current stream (so the copy
is ordered before the next step's kernels; the writer waits on an event
before it reads them), CPU tensors are cloned.

Under a mesh (parallel/mesh.py) the checkpoint keeps the single-device
format: every rank joins in gathering the split parameters and the ZeRO-1
moments inside ``save``, rank 0's write goes to the thread, and ``wait``
ends in a barrier, so every rank reads the directory only after the write.
A restore splits them again for the mesh it loads into, whatever mesh (or
none) wrote them. Every rank reads the directory, so several nodes need it
on a shared file system.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from conformer_tpu_torch.parallel.mesh import (full_state_dict,
                                               load_full_state_dict)

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    """``log`` records one entry per save: its ``step``, the seconds the
    calling thread waited for the write before it (``wait_s``) and spent in
    ``save`` in all (``held_s``), and, once written, the file's ``bytes``
    and the seconds the write took on its thread (``write_s``)."""

    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep, self.mesh = keep, mesh
        self.log: List[dict] = []
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._host: List[torch.Tensor] = []     # pinned snapshot buffers

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def _join(self) -> None:
        """Wait for this process's write in flight; raise its failure."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(
                f"writing a checkpoint to {self.directory} failed") from error

    def wait(self, barrier: bool = True) -> None:
        """Block until the write in flight is on disk. Under a mesh a
        collective (every rank calls it) unless ``barrier`` is false, as on
        a path where this rank alone may have raised."""
        self._join()
        if self.mesh is not None and barrier:
            dist.barrier()

    def close(self) -> None:
        self.wait()

    def steps(self) -> List[int]:
        """Saved steps, oldest first."""
        self._join()
        return self._on_disk()

    def _on_disk(self) -> List[int]:
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, model: torch.nn.Module, optimizer, step: int,
             epoch: int = 0) -> None:
        """Snapshot the state and return; the write runs on a thread (under
        a mesh a collective: every rank calls it)."""
        t0 = time.perf_counter()
        self.wait()
        waited = time.perf_counter() - t0
        payload = {"model": full_state_dict(model, self.mesh),
                   "optimizer": optimizer.state_dict(),
                   "step": int(step), "epoch": int(epoch)}
        if self.mesh is not None and self.mesh.rank != 0:
            return
        copied: List[torch.Tensor] = []
        payload = self._snapshot(payload, copied)
        events = []
        for device in {t.device for t in copied}:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            events.append(event)
        entry = {"step": int(step), "wait_s": waited,
                 "held_s": time.perf_counter() - t0}
        self.log.append(entry)
        self._writer = threading.Thread(
            target=self._write, args=(payload, int(step), events, entry),
            name=f"checkpoint-{step}")
        self._writer.start()

    def _snapshot(self, obj, copied: List[torch.Tensor]):
        """``obj`` with every tensor copied to the host (see the module
        docstring); ``copied`` collects the CUDA sources."""
        if torch.is_tensor(obj):
            t = obj.detach()
            if not t.is_cuda:
                return t.clone()
            i = len(copied)
            copied.append(t)
            if i == len(self._host):
                self._host.append(None)
            buf = self._host[i]
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                buf = self._host[i] = torch.empty(t.shape, dtype=t.dtype,
                                                  pin_memory=True)
            buf.copy_(t, non_blocking=True)
            return buf
        if isinstance(obj, dict):
            out = type(obj)((k, self._snapshot(v, copied))
                            for k, v in obj.items())
            if hasattr(obj, "_metadata"):       # a module's state_dict
                out._metadata = obj._metadata
            return out
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._snapshot(v, copied) for v in obj)
        return obj

    def _write(self, payload: Dict, step: int, events: list,
               entry: dict) -> None:
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            for event in events:
                event.synchronize()
            t0 = time.perf_counter()
            torch.save(payload, tmp)
            os.replace(tmp, path)
            entry.update(write_s=time.perf_counter() - t0,
                         bytes=os.path.getsize(path))
            for old in self._on_disk()[:-self.keep] if self.keep > 0 else []:
                os.remove(self._path(old))
        except Exception as e:          # raised by the caller's next wait
            self._error = e
            if os.path.exists(tmp):
                os.remove(tmp)

    def restore(self, model: torch.nn.Module, optimizer=None,
                step: Optional[int] = None) -> Tuple[int, int]:
        """Load the checkpoint of ``step`` (default: the newest) into model
        and, when given, optimizer. -> (step, epoch)."""
        self._join()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        device = next(model.parameters()).device
        payload = torch.load(self._path(step), map_location=device)
        load_full_state_dict(model, payload["model"], self.mesh)
        if optimizer is not None:
            optimizer.load_state_dict(payload["optimizer"])
        return int(payload["step"]), int(payload["epoch"])
