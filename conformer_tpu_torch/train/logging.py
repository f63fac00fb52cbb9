"""Metrics logging: JSONL file + stdout (counterpart of
conformer_tpu/train/logging.py).

The reference logs four scalars to wandb when --logging is set
(reference: train.py:78-81,265-269). Here every run writes structured JSONL
locally (greppable, no network dependency). wandb is not installed where
the port runs, so asking for it raises. Also provides a step timer for
throughput (audio-seconds/s) and early stopping.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, directory: Optional[str] = None, use_wandb: bool = False):
        if use_wandb:
            raise NotImplementedError(
                "wandb logging is not available in this package; the "
                "metrics go to <checkpoint-dir>/metrics.jsonl")
        self._file = None
        if directory:
            os.makedirs(directory, exist_ok=True)
            self._file = open(os.path.join(directory, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                record[key] = float(v)
            except (TypeError, ValueError):
                record[key] = v
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()


class EarlyStopping:
    """Patience-based early stopping on a monitored metric.

    A working version of the reference's dead code (reference:
    manager.py:51-77 — defined, never instantiated): `update(value)` returns
    True when training should stop; `mode='min'` for losses/WER.
    """

    def __init__(self, patience: int = 3, mode: str = "min",
                 min_delta: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        self.patience = patience
        self.mode = mode
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad_count = 0
        self.should_stop = False

    def update(self, value: float) -> bool:
        improved = (self.best is None
                    or (self.mode == "min" and value < self.best - self.min_delta)
                    or (self.mode == "max" and value > self.best + self.min_delta))
        if improved:
            self.best = value
            self.bad_count = 0
        else:
            self.bad_count += 1
            if self.bad_count >= self.patience:
                self.should_stop = True
        return self.should_stop


class Throughput:
    """Sliding throughput meter: audio seconds/s and steps/s."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self._steps = 0
        self._audio_seconds = 0.0

    def update(self, audio_seconds: float) -> None:
        self._steps += 1
        self._audio_seconds += audio_seconds

    def snapshot(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {
            "steps_per_s": self._steps / dt,
            "audio_seconds_per_s": self._audio_seconds / dt,
        }
