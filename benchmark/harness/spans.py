"""The program's spans in a traced slice (conformer_tpu_torch/utils/spans.py:
``record_function`` ranges, exported as ``user_annotation`` events on the
clock of the trace's host and device events).

What it reads, from the complete events of harness/trace.py::profile:

- each span's time: the union of its intervals, on every thread;
- the main thread's coverage: the union of the four spans that the step
  loop opens in turn (forward, backward, optimizer, the loader's queue);
- kernel time by span: each kernel joined to the runtime call that
  launched it by ``args.correlation``, then put down to the innermost span
  open on the launching thread at the launch;
- idle time by span: the gaps between the merged kernel and copy intervals
  as harness/trace.py::read finds them, each put down to the innermost span
  open at its middle (on any thread: the one that opened last).
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from benchmark.harness.trace import ANNOTATION, _merged, union_us

SPANS = ("train.forward", "train.backward", "train.optimizer",
         "model.lstm_head", "model.dropout", "loader.wait", "host.gc")
MAIN = ("train.forward", "train.backward", "train.optimizer", "loader.wait")
NONE = "(no span)"


def _iv(e) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))


class _Timeline:
    """The innermost span open at each moment on one thread (spans on one
    thread nest)."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.bounds: List[float] = []
        self.open: List[Optional[Tuple[str, float]]] = []
        stack: List[Tuple[float, float, str]] = []
        for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= s:
                self._close(stack)
            stack.append((s, e, name))
            self.bounds.append(s)
            self.open.append((name, s))
        while stack:
            self._close(stack)

    def _close(self, stack) -> None:
        end = stack.pop()[1]
        self.bounds.append(end)
        self.open.append((stack[-1][2], stack[-1][0]) if stack else None)

    def at(self, t: float) -> Optional[Tuple[str, float]]:
        """-> (name, start) of the innermost span open at ``t``, or None."""
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.open[i] if i >= 0 else None


def read(events: list) -> dict:
    """-> span_s {span: s}, main_s, kernel_s {innermost span at the launch:
    device s}, kernels_s, idle_s {innermost span at the gap's middle: s},
    all in seconds; spans that never opened are left out."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in SPANS]
    by_thread: Dict[tuple, list] = collections.defaultdict(list)
    by_name: Dict[str, list] = collections.defaultdict(list)
    for e in marks:
        s, t = _iv(e)
        by_thread[(e.get("pid"), e.get("tid"))].append((s, t, e["name"]))
        by_name[e["name"]].append((s, t))
    lines = {k: _Timeline(v) for k, v in by_thread.items()}

    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and corr is not None:
            launches[corr] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    kernel_us: Dict[str, float] = collections.Counter()
    for k in kernels:
        name = NONE
        hit = launches.get((k.get("args") or {}).get("correlation"))
        if hit is not None and hit[0] in lines:
            found = lines[hit[0]].at(hit[1])
            name = found[0] if found else NONE
        kernel_us[name] += float(k.get("dur", 0))

    # the gaps as trace.read finds them
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    slice_marks = [e for e in events if e.get("name") == ANNOTATION]
    bounds = [_iv(e) for e in kernels + copies + slice_marks]
    idle_us: Dict[str, float] = collections.Counter()
    prev = min(a for a, _ in bounds) if bounds else 0.0
    for s, e in _merged(_iv(x) for x in kernels + copies):
        if s > prev:
            mid = (prev + s) / 2
            found = [f for f in (tl.at(mid) for tl in lines.values()) if f]
            idle_us[max(found, key=lambda f: f[1])[0] if found
                    else NONE] += s - prev
        prev = max(prev, e)
    return {
        "span_s": {n: union_us(v) / 1e6 for n, v in by_name.items()},
        "main_s": union_us(iv for n in MAIN for iv in by_name.get(n, ()))
        / 1e6,
        "kernel_s": {n: us / 1e6 for n, us in kernel_us.items()},
        "kernels_s": sum(kernel_us.values()) / 1e6,
        "idle_s": {n: us / 1e6 for n, us in idle_us.items()},
    }
