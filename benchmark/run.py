"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's configuration, traffic mix, entry driver, per-layer metrics,
kernel groups and correctness limits are files under benchmark/, found by
the names in BENCHMARK.json (harness/spec.py). The run needs a CUDA card
(as many as the cell asks for) and refuses to start without one. Set-up
builds everything from the seed and warms every shape the mix uses; the
window measures for --seconds; with --trace 1 a short profiled slice
follows it, and the per-layer metrics are printed in place of the
end-to-end ones. Then the program's state is freed and the reference
decides ``correct``. The last line of standard output is the result; the
numbers compared, each with its limit, close standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)
os.environ.setdefault("USE_FLAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "conformer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: conformer_tpu_torch is the program, not the package)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a driver gets: the cell's files, the run's arguments, a
    temporary directory, the clock's start."""

    def __init__(self, spec, cell: str, seed: int, seconds: float,
                 trace: bool, device: str, tmp: str):
        self.spec, self.cell = spec, spec.cell(cell)
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.limits = spec.limits(cell)
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.tmp, self.t_start = device, tmp, T_START

    def check_imports(self) -> None:
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)


class ForbiddenImport(RuntimeError):
    pass


def card() -> dict:
    import torch

    name = torch.cuda.get_device_name(0)
    limit = "unknown"
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"kind": name, "count": torch.cuda.device_count(),
            "power_limit": limit}


def result_line(ctx, m: dict) -> dict:
    """The driver's measurements -> the printed result."""
    spec, name = ctx.spec, ctx.cell["name"]
    metrics = {}
    if ctx.trace:
        for entry in spec.per_layer(name):
            value = spec.reader(entry["name"]).read(m)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    else:
        for entry in spec.end_to_end(name):
            value = (m["setup_s"] if entry["name"] == "setup_s"
                     else m["e2e"][entry["name"]])
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    device = {"platform": "gpu" if ctx.device == "cuda" else ctx.device,
              "kind": m.get("kind", "cpu"), "count": ctx.cell["chips"],
              "memory_peak_bytes": m["memory_peak_bytes"]}
    out = {"correct": all(v <= lim for v, lim in m["checks"].values()),
           "attempted": m["attempted"], "failed": m["failed"],
           "metrics": metrics, "device": device}
    if ctx.trace and m.get("trace"):
        device["busy_s"] = m["trace"]["busy_s"]
        device["window_s"] = m["trace"]["window_s"]
        out["breakdown"] = m["trace"]["breakdown"]
    if "checked_shapes" in m.get("readings", {}):
        out["checked_batches"] = m["readings"]["checked_shapes"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in m["checks"].items()}
    return out


def main(argv=None, require_card: bool = True, root=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness.spec import Spec

    spec = Spec(root)
    cell = spec.cell(args.workload)
    device = "cuda"
    info = {}
    if require_card:
        import torch

        if not torch.cuda.is_available():
            print("benchmark: no CUDA card; this benchmark runs on the card "
                  "only", file=sys.stderr)
            sys.exit(2)
        if torch.cuda.device_count() < cell["chips"]:
            print(f"benchmark: {cell['name']} needs {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} visible", file=sys.stderr)
            sys.exit(2)
        info = card()
        print(json.dumps({"command": [sys.executable] + sys.argv,
                          "card": info}), flush=True)
    else:
        device = "cpu"
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    tmp = tempfile.mkdtemp(prefix="benchmark-", dir=base)
    try:
        ctx = Context(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, tmp)
        driver = spec.driver(ctx.traffic["entry"])
        try:
            m = driver.run(ctx)
            ctx.check_imports()
        except ForbiddenImport as e:
            print(f"benchmark: loaded {', '.join(e.args[0])}: the program "
                  "must not use JAX or the JAX package", file=sys.stderr)
            sys.exit(3)
        m["kind"] = info.get("kind", "cpu")
        out = result_line(ctx, m)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if "readings" in m:
        r = m["readings"]
        print(f"benchmark: worst leaves: grad {r['grad_leaves'][0][0]}, "
              f"change {r['change_leaves'][0][0]}; {r['leaves']} leaves "
              f"compared, {r['leaves_out']} left out; checked batches "
              f"(rows, samples) {r.get('checked_shapes')}", file=sys.stderr)
    if "window_s" in m:
        print(f"benchmark: window {m['window_s']!r} s, {m['attempted']} "
              f"steps, loader wait {m.get('loader_wait_s')!r} s, set-up "
              f"{m['setup_s']!r} s", file=sys.stderr)
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
