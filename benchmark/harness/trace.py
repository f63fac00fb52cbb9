"""The traced slice: a few steps or batches under ``torch.profiler`` (CPU
and CUDA activities), exported as a Chrome trace and read back.

What it reads: the slice's span (its annotation and every device event),
the device's busy time as the union of its kernels' intervals (kernels of
two streams are not counted twice: the union arithmetic is a frozen copy
of conformer_tpu_torch/tools/trace_step.py:135-152), each kernel's group
by the kernel group files (spec.py), the device time of each group and of
each operation the groups name, the longest idle gaps by what the host
was doing meanwhile (the innermost CPU operation open at the gap's
middle), and the kernels that took most time.

The table of peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
from typing import Callable, Dict, List

from benchmark.harness.spec import classify

PEAK_BF16_FLOPS = 989e12        # bf16 dense, tensor cores
PEAK_HBM_BYTES = 3.35e12        # HBM3 bytes/s
ANNOTATION = "bench.slice"


def union_us(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile(run: Callable[[], None], path: str) -> list:
    """Run ``run`` (which synchronises) under the profiler, export the
    trace to ``path``, and return its complete events."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        with record_function(ANNOTATION):
            run()
    prof.export_chrome_trace(path)
    with open(path, encoding="utf8") as f:
        data = json.load(f)
    os.remove(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def read(events: list, groups: List[dict]) -> dict:
    """-> busy_s, window_s, kernels, op_s {operation: device s},
    breakdown {device_ops, idle_gaps}."""
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    marks = [e for e in events if e.get("name") == ANNOTATION]
    iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
    bounds = [iv(e) for e in kernels + copies + marks]
    span = (max(b for _, b in bounds) - min(a for a, _ in bounds)
            if bounds else 0.0)
    busy = union_us(iv(e) for e in kernels)

    by_name: Dict[str, float] = collections.Counter()
    for e in kernels + copies:
        by_name[e["name"]] += float(e.get("dur", 0))
    group_us: Dict[str, float] = collections.Counter()
    op_us: Dict[str, float] = collections.Counter()
    name_group = {}
    for name, us in by_name.items():
        g = classify(name, groups)
        label = g["name"] if g else "other"
        name_group[name] = label
        group_us[label] += us
        if g and g.get("operation"):
            op_us[g["operation"]] += us

    # idle gaps between merged busy intervals, named by the host's
    # innermost CPU operation open at each gap's middle
    cpu = sorted((iv(e) + (e["name"],) for e in events
                  if e.get("cat") == "cpu_op"), key=lambda x: x[0])
    starts = [c[0] for c in cpu]
    gaps, prev = [], (min(a for a, _ in bounds) if bounds else 0.0)
    for s, e in _merged(iv(e) for e in kernels + copies):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    gap_us: Dict[str, float] = collections.Counter()
    for s, e in gaps:
        mid = (s + e) / 2
        name = "(no host op)"
        first = bisect.bisect_right(starts, mid) - 1
        for k in range(first, max(first - 2000, -1), -1):
            if cpu[k][1] >= mid:
                name = cpu[k][2]
                break
        gap_us[name] += e - s
    top_groups = sorted(group_us.items(), key=lambda x: -x[1])[:5]
    top_kernels = sorted(by_name.items(), key=lambda x: -x[1])[:5]
    breakdown = {
        "device_ops": ([[f"group {g}", us / 1e6] for g, us in top_groups]
                       + [[f"{name_group[n]}: {n[:120]}", us / 1e6]
                          for n, us in top_kernels]),
        "idle_gaps": [[n[:120], us / 1e6] for n, us in
                      sorted(gap_us.items(), key=lambda x: -x[1])[:10]],
    }
    return {"busy_s": busy / 1e6, "window_s": span / 1e6,
            "kernels": len(kernels),
            "op_s": {k: v / 1e6 for k, v in op_us.items()},
            "breakdown": breakdown}
