"""The frame loops of the device beam searches: eager on the CPU, CUDA graphs
on the card (the port's counterpart of ``jax.jit`` over ``lax.scan``).

``run_frames(step, carry, frames, ...)`` runs ``carry, out = step(carry,
frames[t], t, inputs)`` for t = 0..T-1 and returns the last carry and the
outputs stacked over frames. A frame step of the beam searches is a few
hundred small ops (a top-k, two multi-key sorts, LM probes, gathers), so run
eagerly it is bound by the host's launches. The step is written so that
CUDA can capture it: static shapes, no ``.item()``, no ``nonzero``, no host
copy, no Python branch on a tensor's value; inactive frames are masked with
``torch.where``.

On a CUDA tensor the first call for a static key captures ``unroll`` frame
steps into a ``torch.cuda.CUDAGraph``: the carry, the per-call inputs, a
window of ``unroll`` frames and the frame index live in static buffers, the
index advances on the device, and the call copies its frames in and
replays the graph once a window (three launches a window, whatever the
step holds). The cache of graphs (the JAX jit cache's role) is keyed by
the caller's static key, the shapes and dtypes of the carry, frames and
inputs, ``unroll``, and the identity of ``consts``: the tensors and
functions the step reads besides its arguments (LM tables, model
functions), which the cached graph holds and reads by address. A tensor
const changed in place (its version counter moved) makes a new graph.
Graphs are captured and replayed under one lock, so threads that share the
card take turns.

No fallback: a capture or replay that fails on the card raises. The eager
loop runs on the card only inside ``eager()``, which a check uses to hold
the graph against it, or when the caller passes ``graph=False``: the
sharded searches do so for a step that sums over a gloo group, whose
collectives go through the host (parallel/collectives.py::capturable),
and never after a failed capture. On the CPU the loop is always eager.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Callable, List, Sequence, Tuple

import torch

# graphs kept at once; each holds its own memory pool
CACHE_SIZE = 16
_LOCK = threading.Lock()
_CACHE: "OrderedDict[tuple, _Graph]" = OrderedDict()
_LOCAL = threading.local()

Step = Callable[[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor,
                 Tuple[torch.Tensor, ...]],
                Tuple[Tuple[torch.Tensor, ...], torch.Tensor]]


@contextmanager
def eager():
    """Run frame loops eagerly on the card as well, in this thread."""
    before = getattr(_LOCAL, "eager", False)
    _LOCAL.eager = True
    try:
        yield
    finally:
        _LOCAL.eager = before


def clear_cache() -> None:
    """Drop every captured graph (and its memory pool)."""
    with _LOCK:
        _CACHE.clear()


def capture_seconds() -> List[float]:
    """Host seconds each cached graph took to warm up and capture, oldest
    first."""
    with _LOCK:
        return [g.capture_s for g in _CACHE.values()]


class _Graph:
    """One captured window of frame steps and its static buffers."""

    def __init__(self, step: Step, carry, frames, inputs, unroll: int,
                 consts):
        t0 = time.perf_counter()
        dev = frames.device
        self.consts = consts           # read by address inside the graph
        self.carry = tuple(c.clone() for c in carry)
        self.inputs = tuple(x.clone() for x in inputs)
        self.frames = torch.zeros((unroll,) + tuple(frames.shape[1:]),
                                  dtype=frames.dtype, device=dev)
        n = min(unroll, frames.shape[0])
        self.frames[:n].copy_(frames[:n])
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        # warm up on a side stream (lazy initialisation, library
        # workspaces), as capture requires
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step(self.carry, self.frames[0], self.t, self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            cur, outs = self.carry, []
            for u in range(unroll):
                cur, out = step(cur, self.frames[u], self.t, self.inputs)
                outs.append(out)
                self.t.add_(1)
            for buf, new in zip(self.carry, cur):
                buf.copy_(new)
            self.outs = torch.stack(outs)
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0

    def run(self, carry, frames, inputs):
        unroll, total = self.frames.shape[0], frames.shape[0]
        for buf, c in zip(self.carry, carry):
            buf.copy_(c)
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.t.zero_()
        windows = -(-total // unroll)
        outs = torch.empty((windows * unroll,) + tuple(self.outs.shape[1:]),
                           dtype=self.outs.dtype, device=frames.device)
        for w in range(windows):
            lo, hi = w * unroll, min(total, (w + 1) * unroll)
            # frames past the end keep the last window's values: the steps
            # mask every frame at or past each row's length
            self.frames[: hi - lo].copy_(frames[lo:hi])
            self.graph.replay()
            outs[lo: lo + unroll].copy_(self.outs)
        return tuple(b.clone() for b in self.carry), outs[:total]


def _identity(obj):
    if isinstance(obj, torch.Tensor):
        try:
            version = obj._version
        except RuntimeError:           # an inference tensor: immutable
            version = 0
        return id(obj), version
    return id(obj)


def _signature(tensors: Sequence[torch.Tensor]) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in tensors)


def run_frames(step: Step, carry: Sequence[torch.Tensor],
               frames: torch.Tensor, inputs: Sequence[torch.Tensor] = (),
               key: tuple = (), consts: Sequence = (), unroll: int = 1,
               graph: bool = True
               ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Scan ``step`` over the leading (time) axis of ``frames`` (T, ...)
    -> (the last carry, the outputs (T, ...)). ``step(carry, frame, t,
    inputs)`` gets the carry tuple, frame t, t as a 0-dim int64 tensor on
    the device and the per-call ``inputs``, and returns (the new carry,
    one tensor). ``key``: what else fixes the step (its static
    arguments); ``consts``: the tensors and functions it reads besides
    its arguments. T must be at least 1. ``graph=False`` runs the steps
    eagerly on the card too. Runs under inference mode (the static buffers
    of a graph are inference tensors)."""
    carry, inputs = tuple(carry), tuple(inputs)
    if frames.shape[0] < 1:
        raise ValueError("run_frames needs at least one frame")
    with torch.inference_mode():
        return _run(step, carry, frames, inputs, key, consts, unroll, graph)


def _run(step, carry, frames, inputs, key, consts, unroll, graph):
    if (frames.device.type != "cuda" or not graph
            or getattr(_LOCAL, "eager", False)):
        t = torch.zeros((), dtype=torch.int64, device=frames.device)
        outs = []
        for i in range(frames.shape[0]):
            carry, out = step(carry, frames[i], t, inputs)
            outs.append(out)
            t = t + 1
        return carry, torch.stack(outs)
    full_key = (key, _signature(carry), tuple(frames.shape[1:]),
                frames.dtype, _signature(inputs), unroll,
                str(frames.device), tuple(_identity(c) for c in consts))
    with _LOCK:
        graph = _CACHE.get(full_key)
        if graph is None:
            graph = _Graph(step, carry, frames, inputs, unroll, tuple(consts))
            _CACHE[full_key] = graph
            while len(_CACHE) > CACHE_SIZE:
                _CACHE.popitem(last=False)
        else:
            _CACHE.move_to_end(full_key)
        return graph.run(carry, frames, inputs)
