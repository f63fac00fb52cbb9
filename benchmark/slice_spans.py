"""A training cell's window and traced slice with the program's spans and
the loader's counters read (not run by the benchmark's own runs).

    python3 benchmark/slice_spans.py --workload ctc_train.bucketed
        --seed <n> [--seconds 51] [--cost-steps 8] [--cost-passes 4]
        [--out spans.jsonl]

Set-up is the cell's run's (the entry driver's ``Session``). Then:

1. the window, as the run's (``--seconds``), with ``BucketedLoader.wait_s``
   and ``busy_s`` read before and after it: their shares of the window,
   beside the feed's own wait (``loader_wait.train``);
2. the cell's traced slice under ``torch.profiler`` as the run's
   ``--trace 1`` takes it, with the spans on (``utils/spans.py::on``),
   read by harness/trace.py and harness/spans.py: each span's share of
   the slice, the share of the slice that the step loop's four spans
   cover, dropout's share of the kernel time, the idle seconds by span;
3. the spans' cost: the same ``--cost-steps`` batches trained
   ``--cost-passes`` times with the spans off and as often on, in turn
   (off, on, on, off, ...), each pass ended by a synchronise: the wall
   milliseconds a step, and the host's milliseconds a step inside the
   step function.

Prints one JSON line (the shares in %, as a metric would print them) and
appends it to ``--out``.
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
from benchmark.harness import spans as span_reader  # noqa: E402
from benchmark.harness import trace  # noqa: E402
from benchmark.harness.spec import Spec  # noqa: E402

# share of the slice's span -> the span it reads
HOST_SHARES = {"host_forward.train": "train.forward",
               "host_backward.train": "train.backward",
               "host_optimizer.train": "train.optimizer",
               "lstm_head.train": "model.lstm_head",
               "gc_pause.train": "host.gc"}


def shares(tr: dict, sp: dict) -> dict:
    """trace.read's and spans.read's numbers of one slice -> the shares."""
    out = {}
    if tr["window_s"]:
        for metric, name in HOST_SHARES.items():
            if name in sp["span_s"]:
                out[metric] = 100.0 * sp["span_s"][name] / tr["window_s"]
        out["main_spans_cover"] = 100.0 * sp["main_s"] / tr["window_s"]
        out["device_idle.train"] = 100.0 * (1 - tr["busy_s"]
                                            / tr["window_s"])
    if sp["kernels_s"] and "model.dropout" in sp["kernel_s"]:
        out["dropout_device.train"] = (100.0 * sp["kernel_s"]["model.dropout"]
                                       / sp["kernels_s"])
    idle = sum(sp["idle_s"].values())
    if idle:
        out["idle_unattributed.train"] = (
            100.0 * sp["idle_s"].get(span_reader.NONE, 0.0) / idle)
    return out


def _sync(dev: str) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _cost(s, steps: int, passes: int, dev: str) -> dict:
    """Wall and in-step host ms a step, spans off against on, on the same
    batches."""
    from conformer_tpu_torch.utils import spans

    tr = s.trainer
    batches = list(s.feed.take(steps))
    inner = tr.train_step
    held = {"s": 0.0}

    def timed(*args):
        t = time.perf_counter()
        out = inner(*args)
        held["s"] += time.perf_counter() - t
        return out

    tr.train_step = timed
    got = {"off": [], "on": []}
    order = [("off", "on")[(k + 1) // 2 % 2] for k in range(2 * passes)]
    try:
        for mode in order:
            held["s"] = 0.0
            t = time.perf_counter()
            if mode == "on":
                with spans.on():
                    tr.train_epoch(iter(batches), 0)
            else:
                tr.train_epoch(iter(batches), 0)
            _sync(dev)
            wall = time.perf_counter() - t
            got[mode].append((1e3 * wall / steps, 1e3 * held["s"] / steps))
    finally:
        tr.train_step = inner
    return {mode: {"wall_ms_per_step": [w for w, _ in v],
                   "host_ms_per_step": [h for _, h in v]}
            for mode, v in got.items()} | {"order": order, "steps": steps}


def measure(ctx, cost_steps: int, cost_passes: int) -> dict:
    from conformer_tpu_torch.utils import spans

    driver = ctx.spec.driver(ctx.traffic["entry"])
    s = driver.Session(ctx)
    dev, sr = ctx.device, s.cfg.audio.sample_rate
    out = {"setup_s": time.perf_counter() - ctx.t_start}
    loader = s.feed.loader
    s.feed.mark()
    wait0, busy0 = loader.wait_s, loader.busy_s
    t0 = time.perf_counter()
    s.trainer.train_epoch(s.feed.until(t0 + ctx.seconds), 0)
    _sync(dev)
    window_s = time.perf_counter() - t0
    win = s.feed.batches
    out.update({
        "window_s": window_s, "steps": len(win),
        "train_audio_per_s": sum(sum(b["samples"]) for b in win) / sr
        / window_s,
        "loader_wait.train": 100.0 * s.feed.wait_s / window_s,
        "loader_queue_wait.train": 100.0 * (loader.wait_s - wait0)
        / window_s,
        "loader_busy.train": 100.0 * (loader.busy_s - busy0) / window_s})
    with spans.on():
        events = trace.profile(
            lambda: (s.trainer.train_epoch(
                s.feed.take(ctx.traffic["trace_steps"]), 0), _sync(dev)),
            os.path.join(ctx.tmp, "trace.json"))
    tr = trace.read(events, ctx.spec.kernel_groups())
    sp = span_reader.read(events)
    del events
    out.update(shares(tr, sp))
    out["slice"] = {"window_s": tr["window_s"], "busy_s": tr["busy_s"],
                    "kernels": tr["kernels"], **sp,
                    "idle_gaps": tr["breakdown"]["idle_gaps"]}
    if cost_steps and cost_passes:
        out["cost"] = _cost(s, cost_steps, cost_passes, dev)
    ctx.check_imports()
    return out


def main(argv=None, require_card: bool = True, root=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--cost-steps", type=int, default=8)
    p.add_argument("--cost-passes", type=int, default=4)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    spec = Spec(root)
    device = "cuda" if require_card else "cpu"
    info = {}
    if require_card:
        import torch

        if not torch.cuda.is_available():
            sys.exit("slice_spans: no CUDA card")
        info = run.card()
    base = os.environ.get("TMPDIR") or tempfile.gettempdir()
    tmp = tempfile.mkdtemp(prefix="slice-spans-", dir=base)
    try:
        ctx = run.Context(spec, args.workload, args.seed, args.seconds,
                          True, device, tmp)
        out = measure(ctx, args.cost_steps, args.cost_passes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out.update(workload=args.workload, seed=args.seed, card=info)
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
