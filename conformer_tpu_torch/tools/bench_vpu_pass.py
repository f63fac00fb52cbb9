"""Measure the cost of ONE elementwise or row-reduction pass over a
score-tile-shaped fp32 buffer on the GPU, per op (add / mul / where / exp /
exp2 / exp_raw / max / sum), by timing kernel K5 (``csrc/vpu_pass.cu``) at
two pass counts and fitting the slope.

    python -m conformer_tpu_torch.tools.bench_vpu_pass

Counterpart of ``tools/bench_vpu_pass.py``, at its production tile: (256,
199) per CTA like the 8 s bucket's attention score tile, 448 CTAs (B 56 x
H 8), n = 64 and 320 passes. Each op's slope is printed beside its bound:
the op's issue rate on the card (add, mul and where on the FP32 pipe, the
exponentials on the MUFU unit) at the card's maximum SM clock, as
``nvidia-smi`` reports it. Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from conformer_tpu_torch.ops.cuda.vpu_pass import OPS, vpu_pass

ROWS, COLS, GRID = 256, 199, 448
N_LO, N_HI = 64, 320
# Per element and pass: (instructions, unit); units issue LANES_PER_SM
# per SM per clock on Hopper (CUDA C++ Programming Guide, arithmetic
# instruction throughput, compute capability 9.0). max and sum add the
# row's acc[:, 0], reduce and add the result back: three FP32 operations.
OP_COST = {"add": (1, "fp32"), "mul": (1, "fp32"), "where": (1, "fp32"),
           "exp": (1, "mufu"), "exp2": (1, "mufu"), "exp_raw": (1, "mufu"),
           "max": (3, "fp32"), "sum": (3, "fp32")}
LANES_PER_SM = {"fp32": 128, "mufu": 16}


def tile_input(rows: int, cols: int, grid: int, device="cuda") -> torch.Tensor:
    """The JAX tool's input: uniform [0, 1) from numpy's generator seed 0."""
    x = np.random.default_rng(0).random((grid * rows, cols), np.float32)
    return torch.from_numpy(x).to(device)


def run(op: str, n: int, rows: int, cols: int, grid: int, reps: int = 30,
        x: Optional[torch.Tensor] = None) -> float:
    """-> mean device seconds of one K5 launch (op, n passes) over grid
    tiles of (rows, cols), by CUDA events over ``reps`` launches."""
    if x is None:
        x = tile_input(rows, cols, grid)
    if x.device.type != "cuda":
        raise RuntimeError("the per-pass benchmark times the GPU kernel; "
                           "it needs a CUDA device")
    vpu_pass(x, op, n, rows)                    # warm-up (and build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        vpu_pass(x, op, n, rows)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / reps


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, from ``nvidia-smi``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def pass_bound_s(op: str, elems: int, clock_hz: float, n_sms: int) -> float:
    """Least time of one pass of ``op`` over ``elems`` elements: its
    instructions over its unit's issue rate on every SM."""
    count, unit = OP_COST[op]
    return elems * count / (n_sms * LANES_PER_SM[unit] * clock_hz)


def main(reps: int = 10) -> Dict[str, dict]:
    """Fit and print the per-pass slope of every op; -> {op: result}."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark times the GPU")
    elems = ROWS * COLS * GRID
    clock = max_sm_clock_hz()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    x = tile_input(ROWS, COLS, GRID)
    print(f"tile ({ROWS},{COLS}) x {GRID} CTAs = {elems / 1e6:.1f} M elems "
          f"(slope over {N_HI - N_LO} passes; {n_sms} SMs at "
          f"{clock / 1e6:.0f} MHz)")
    results = {}
    for op in OPS:
        t_lo = run(op, N_LO, ROWS, COLS, GRID, reps, x)
        t_hi = run(op, N_HI, ROWS, COLS, GRID, reps, x)
        per_pass = (t_hi - t_lo) / (N_HI - N_LO)
        bound = pass_bound_s(op, elems, clock, n_sms)
        results[op] = {"us_per_pass": per_pass * 1e6,
                       "gelem_per_s": elems / per_pass / 1e9,
                       "bound_us_per_pass": bound * 1e6,
                       "bound_unit": OP_COST[op][1],
                       f"ms_n{N_LO}": t_lo * 1e3, f"ms_n{N_HI}": t_hi * 1e3}
        print(f"{op:8s}: {per_pass * 1e6:9.2f} us/pass  "
              f"({elems / per_pass / 1e9:7.1f} Gelem/s; bound "
              f"{bound * 1e6:.2f} us on {OP_COST[op][1]})  "
              f"[n={N_LO}: {t_lo * 1e3:.3f} ms, n={N_HI}: {t_hi * 1e3:.3f} ms]")
    return results


if __name__ == "__main__":
    main()
