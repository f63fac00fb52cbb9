"""Named spans at the boundaries of the training step's layers, recorded
into whatever ``torch.profiler`` session is running.

``span(name)`` is a context manager. While spans are off (the default) it
is one shared null context: a module-global check, nothing allocated and
no dispatcher call. Inside ``with on():`` it enters
``torch.profiler.record_function(name)``, so the span lands in the running
profiler's trace as a ``user_annotation`` event, on the same clock as the
trace's ``cpu_op``, ``cuda_runtime`` and ``kernel`` events. There is no
recorder here: the profiler keeps the events and writes them out. While
spans are on, a ``gc.callbacks`` hook also opens a ``host.gc`` span around
each garbage collection.

The spans (each is read by a metric, PERF.md §3): ``train.forward``,
``train.backward``, ``train.optimizer`` (train/steps.py),
``model.lstm_head`` (models/decoder.py), ``model.dropout``
(models/dropout.py), ``loader.wait`` (data/dataset.py) and ``host.gc``.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Iterator

from torch.profiler import record_function

_NULL = contextlib.nullcontext()
_on = False
# thread id -> the host.gc span open on that thread
_gc_open: dict = {}


def span(name: str):
    """A context manager: ``record_function(name)`` while spans are on,
    else a null context."""
    return record_function(name) if _on else _NULL


def _gc_hook(phase: str, info: dict) -> None:
    tid = threading.get_ident()
    if phase == "start":
        rf = record_function("host.gc")
        rf.__enter__()
        _gc_open[tid] = rf
    else:
        rf = _gc_open.pop(tid, None)
        if rf is not None:
            rf.__exit__(None, None, None)


@contextlib.contextmanager
def on() -> Iterator[None]:
    """Spans on for the block, and the GC hook registered; the previous
    state after it."""
    global _on
    was = _on
    _on = True
    if not was:
        gc.callbacks.append(_gc_hook)
    try:
        yield
    finally:
        _on = was
        if not was:
            gc.callbacks.remove(_gc_hook)
