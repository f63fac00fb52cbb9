"""Device time of a call on the GPU, by CUDA events.

A kernel wrapper spends tens of microseconds of host time per call (checks,
allocation, the ctypes call), more than a small kernel runs on the device.
Events recorded around calls enqueued one by one would then time the host.
``device_ms`` enqueues the timed calls behind a spin kernel, so they are all
queued before the device reaches them and the events time the device alone.
"""

from __future__ import annotations

from typing import Callable

import torch

# ~25 ms at the H100's 1980 MHz: longer than the host takes to enqueue the
# timed calls of any kernel wrapper.
SPIN_CYCLES = 50_000_000


def device_ms(fn: Callable[[], object], iters: int = 20,
              warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back calls,
    after ``warmup`` calls. Calls that launch more kernels than the spin
    covers, or than the launch queue holds, time the host's pace too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
