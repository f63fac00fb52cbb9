"""The readings that a cell's correctness limits are set from (not run by
the benchmark's own runs).

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 ...
        [--control-seeds 1 2 3] [--witness-seeds 1 2] [--detail]
        [--out chiprun_out/readings.json]

For each seed, in one process: the cell's set-up and checked steps, then
the program's numbers against the float32 reference (the lower readings);
for each control seed also the control's (the reference in float8 against
the float32 reference: the upper reading) and the planted faults' that a
cell's traffic can have (the reference over half of each batch); for each
witness seed the reference rounded to bfloat16 at the program's rounding
points and the program again in float32 (where a gap comes from).
``--detail`` keeps every leaf's gaps in --out. Prints one JSON line a seed
(without the leaves) and writes them all to --out.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402


def main(argv=None, require_card: bool = True, root=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    p.add_argument("--detail", action="store_true")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    spec = Spec(root)
    device = "cuda" if require_card else "cpu"
    if require_card:
        import torch

        if not torch.cuda.is_available():
            sys.exit("readings: no CUDA card")
        print(json.dumps({"card": run.card()}), flush=True)
    results = []
    for seed in args.seeds:
        base = os.environ.get("TMPDIR") or tempfile.gettempdir()
        tmp = tempfile.mkdtemp(prefix="readings-", dir=base)
        t0 = time.perf_counter()
        try:
            ctx = run.Context(spec, args.workload, seed, 0.0, False, device,
                              tmp)
            variants = (("fp8", "half_batch") if seed in args.control_seeds
                        else ())
            witness = seed in args.witness_seeds
            if witness:
                variants += ("bf16",)
            r = spec.driver(ctx.traffic["entry"]).readings(
                ctx, variants, witness, args.detail)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        r["seed"], r["seconds"] = seed, time.perf_counter() - t0
        results.append(r)
        print(json.dumps({k: ({n: x for n, x in v.items()
                                if n != "per_leaf"}
                               if isinstance(v, dict) else v)
                          for k, v in r.items()}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
