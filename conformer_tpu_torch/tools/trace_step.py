"""Op-level attribution of a step from a torch.profiler device trace
(counterpart of tools/trace_step.py).

Runs one of the JAX tool's operating points on the card: three warm calls,
then ``--steps`` calls under ``torch.profiler`` (CPU and CUDA activities),
synchronised inside the traced window; exports the window as a Chrome trace
and reads that trace back: the device span of the window, the device's busy
time as the union of the kernels' intervals (kernels on two streams are
not counted twice) and its idle share, memcpy and memset time apart, the
kernels grouped by a fixed, ordered table of patterns over their demangled
names (``GROUPS``: the port's kernels K1-K5 by namespace and name, cuBLAS
and CUTLASS GEMMs, convolutions, reductions, copies, indexing,
elementwise), and the top kernels. Component timing (profile_step.py)
cannot see inside a step, and the host's launch time hides the device's
share of it: this is the device's own breakdown.

    python -m conformer_tpu_torch.tools.trace_step [--mode train]
        [--arch ctc|transducer] [--batch 48] [--audio-s 8] [--steps 5]
        [--conv xla|pallas] [--remat] [--device cuda|cpu]
    python -m conformer_tpu_torch.tools.trace_step --trace-dir DIR

``--trace-dir`` reads an exported trace (``trace.json`` or any ``*.json``
/ ``*.json.gz`` Chrome trace under DIR) instead of running. Prints the
card's name and power limit first; ``main`` also returns the report as a
dict, with the kernel wrappers' launch counts over the window
(``wrapper_launches``). A kernel inside a replayed CUDA graph
(ops/frame_graph.py) is a row of its own in the trace when the profiler
records graph nodes one by one; the report counts the graph launches and
the kernels they ran, and says so when none were recorded.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import subprocess
import tempfile
from typing import Callable, List, Optional

import numpy as np
import torch

from conformer_tpu_torch.tools.timing import sync

# Every kernel of the port lies in a top-level anonymous namespace; PyTorch's
# own lie under at::native (some in anonymous namespaces inside it). The
# port's groups are anchored at the start of the demangled name, so that
# K5's (anonymous namespace)::elementwise_kernel is never PyTorch's
# at::native::elementwise_kernel, nor the other way round.
_PORT = r"^(?:void )?\(anonymous namespace\)::"
# (group, pattern) in order, the first match wins; the port's patterns are
# case-sensitive, the others not.
GROUPS = [
    ("memcpy/memset", re.compile(r"^mem(?:cpy|set)\b", re.I)),
    ("K1-drop", re.compile(_PORT + r"hopper::fwd_kernel<true>")),
    ("K1", re.compile(_PORT + r"hopper::fwd_kernel<")),
    ("K1 general", re.compile(_PORT + r"general::fwd_kernel<")),
    ("K2", re.compile(
        _PORT + r"hopper::(?:q_pass|k_pass|da_pass|dwh_pass)\b")),
    ("K2 general", re.compile(_PORT + r"general::(?:q_pass|k_pass|da_pass"
                                      r"|dwh_partial|dwh_reduce)\b")),
    ("K3", re.compile(_PORT + r"logmel_kernel\b")),
    ("K4a", re.compile(_PORT + r"dwconv_(?:fwd|window)_kernel\b")),
    ("K4b", re.compile(
        _PORT + r"dwconv_dw_(?:partial|reduce|window)_kernel\b")),
    ("K5", re.compile(_PORT + r"(?:elementwise|row)_kernel\b")),
    # implicit-GEMM convolutions carry "gemm" in their names: before GEMM
    ("conv (cuDNN, ATen)", re.compile(
        r"cudnn|conv(?!ert)|fprop|dgrad|wgrad|nchwtonhwc|nhwctonchw", re.I)),
    ("GEMM (cuBLAS, CUTLASS)", re.compile(
        r"gemm|gemv|cutlass|cublas|nvjet|splitkreduce|sm\d+_xmma", re.I)),
    ("reduce/norm", re.compile(
        r"reduce|norm(?!al)|softmax|moments|welford|gammabeta", re.I)),
    ("copy/transpose/cat", re.compile(
        r"copy|transpose|catarray|\bcat\b|permute|_pad|flip|\broll", re.I)),
    ("gather/scatter/index", re.compile(
        r"gather|scatter|\bindex|embedding|\btake|\bput_|masked_select",
        re.I)),
    ("elementwise", re.compile(
        r"elementwise|unrolled|vectorized|pointwise|functor|fill|"
        r"distribution|launch_", re.I)),
]
OTHER = "other"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "trace_step.window"
TRACE_FILE = "trace.json"
CORPUS_WORDS = ["XIN", "CHÀO", "BẠN", "CẢM", "ƠN", "TẠM", "BIỆT", "LỖI",
                "KHÔNG", "CÓ", "GÌ", "ĐÂU", "NHÉ", "ANH", "EM", "TÔI"]


def classify(name: str) -> str:
    for label, pat in GROUPS:
        if pat.search(name):
            return label
    return OTHER


def kernel_rows(averages) -> list:
    """``prof.key_averages()`` -> the device rows the trace's DEVICE_CATS
    hold: kernels, memcpy and memset. An aten op's row repeats the time of
    the kernels it launched, the port's kernels have no aten op above them,
    and a range annotation (the optimizer's step) spans kernels already
    counted, so only the device's own rows are kept."""
    return [e for e in averages
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]


# ---------------------------------------------------------------------------
# The report: a Chrome trace -> totals, groups, top kernels
# ---------------------------------------------------------------------------

def _trace_path(trace_dir: str) -> str:
    paths = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise SystemExit(f"no Chrome trace (*.json) under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def load_events(trace_dir: str) -> list:
    path = _trace_path(trace_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf8") as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _interval(e: dict) -> tuple:
    start = float(e["ts"])
    return start, start + float(e.get("dur", 0))


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def report(trace_dir: str, top: int = 40, quiet: bool = False) -> dict:
    """Read the trace under ``trace_dir`` and print (unless ``quiet``) and
    return its three blocks. The window's span runs from its annotation
    (``WINDOW``) or, in a trace without one, the first device event, to the
    end of the later of the two."""
    events = [e for e in load_events(trace_dir) if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") in DEVICE_CATS[1:]]
    window = [e for e in events if e.get("name") == WINDOW
              and e.get("cat") == "user_annotation"]
    bounds = [_interval(e) for e in kernels + copies + window]
    span_us = (max(b for _, b in bounds) - min(a for a, _ in bounds)
               if bounds else 0.0)
    busy_us = _union_us(_interval(e) for e in kernels)
    kernel_us = sum(float(e.get("dur", 0)) for e in kernels)

    time_us = collections.Counter()
    count = collections.Counter()
    for e in kernels + copies:
        time_us[e["name"]] += float(e.get("dur", 0))
        count[e["name"]] += 1
    groups_us, groups_n = collections.Counter(), collections.Counter()
    for name, us in time_us.items():
        groups_us[classify(name)] += us
        groups_n[classify(name)] += count[name]
    graph_ids = {e["args"].get("correlation") for e in events
                 if e.get("name") == "cudaGraphLaunch" and "args" in e}
    graph_kernels = sum(1 for e in kernels
                        if e.get("args", {}).get("correlation") in graph_ids)

    def ms(us):
        return us / 1e3

    out = {
        "totals": {
            "span_ms": ms(span_us), "busy_ms": ms(busy_us),
            "busy_share": busy_us / span_us if span_us else 0.0,
            "idle_share": 1 - busy_us / span_us if span_us else 0.0,
            "kernel_ms": ms(kernel_us), "kernels": len(kernels),
            "streams": len({(e.get("pid"), e.get("tid")) for e in kernels}),
            "memcpy_ms": ms(sum(float(e.get("dur", 0)) for e in copies
                                if e["cat"] == "gpu_memcpy")),
            "memset_ms": ms(sum(float(e.get("dur", 0)) for e in copies
                                if e["cat"] == "gpu_memset")),
            "memcpy_memset": len(copies),
            "graph_launches": len(graph_ids), "graph_kernels": graph_kernels},
        "groups": [{"group": g, "ms": ms(us), "launches": groups_n[g],
                    "share": (None if g == "memcpy/memset" or not kernel_us
                              else us / kernel_us)}
                   for g, us in groups_us.most_common()],
        "top": [{"name": n, "ms": ms(us), "count": count[n],
                 "group": classify(n)}
                for n, us in time_us.most_common(top)]}
    if not quiet:
        _print_report(out, top)
    return out


def _print_report(out: dict, top: int) -> None:
    t = out["totals"]
    print(f"\n== totals: span {t['span_ms']:.2f} ms | busy (union of "
          f"{t['kernels']} kernels on {t['streams']} streams) "
          f"{t['busy_ms']:.2f} ms | idle {t['idle_share']:.3f} | kernel sum "
          f"{t['kernel_ms']:.2f} ms | memcpy {t['memcpy_ms']:.2f} ms, memset "
          f"{t['memset_ms']:.2f} ms apart ==")
    if t["graph_launches"]:
        print(f"   {t['graph_launches']} CUDA graph launches ran "
              f"{t['graph_kernels']} of these kernels"
              + ("" if t["graph_kernels"] else
                 ": the profiler recorded none of a graph's kernels one by "
                 "one, so the busy time leaves the graphs out"))
    print("== groups (% of kernel time) ==")
    for g in out["groups"]:
        pct = "    -" if g["share"] is None else f"{100 * g['share']:5.1f}"
        print(f"{g['ms']:10.3f} ms  {pct}%  x{g['launches']:<6d} {g['group']}")
    print(f"\n== top {top} kernels ==")
    for k in out["top"]:
        print(f"{k['ms']:10.3f} ms  x{k['count']:<6d} {k['name'][:110]}")


# ---------------------------------------------------------------------------
# Running a mode under the profiler
# ---------------------------------------------------------------------------

def trace_window(fn: Callable[[int], object], steps: int, trace_dir: str,
                 device: torch.device, warmup: int = 3) -> dict:
    """``warmup`` calls of fn(i), then ``steps`` under the profiler,
    synchronised inside the window; the trace goes to
    ``trace_dir/trace.json``. -> the kernel wrappers' launch counts over
    the window."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    for i in range(warmup):
        fn(i)
    sync(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    reset_launch_counts()
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            for i in range(steps):
                fn(warmup + i)
            sync(device)
    counts = launch_counts()
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
    return counts


def config(args, base=None):
    """``base`` (Config() when None) with the JAX tool's knobs
    (BENCH_REMAT, BENCH_SCORE, BENCH_ATTN, BENCH_CONV) from the flags."""
    from conformer_tpu_torch.config import Config

    over = {"model.use_remat": args.remat,
            "model.attention_score_dtype": args.score,
            "model.attention_impl": args.attn}
    if args.conv:
        over["model.conv_impl"] = args.conv
    return (base or Config()).override(**over)


def _synthetic(cfg, batch: int, num_samples: int, device, seed: int = 0):
    from conformer_tpu_torch.data.dataset import synthetic_batch

    b = synthetic_batch(batch, num_samples, cfg.model.vocab_size,
                        max_tokens=cfg.data.max_tokens, seed=seed)
    lengths = np.full((batch,), num_samples, np.int32)
    return [torch.from_numpy(np.asarray(x)).to(device)
            for x in (b.audio, lengths, b.tokens, b.token_lengths)]


def train_fn(cfg, batch: int, num_samples: int, device):
    """The train step of ``model.arch`` (the transducer at U 96)."""
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_train_step

    if cfg.model.arch != "ctc":
        cfg = cfg.override(**{"data.max_tokens": 96})
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0).to(device)
    step = make_train_step(cfg, model, make_optimizer(
        cfg.optim, model.parameters(), steps_per_epoch=1000))
    args = _synthetic(cfg, batch, num_samples, device)
    return lambda i: step(*args, i)


def pretrain_fn(cfg, method: str, batch: int, num_samples: int, device):
    """The wav2vec2 or BYOL step at the recorded pretraining point (remat
    on)."""
    from conformer_tpu_torch.train.pretrain import (build_pretrain_model,
                                                    make_pretrain_step)
    from conformer_tpu_torch.train.state import make_optimizer

    cfg = cfg.override(**{"model.use_remat": True,
                          "pretrain.method": method})
    model = build_pretrain_model(cfg, seed=0).to(device)
    step = make_pretrain_step(cfg, model, make_optimizer(
        cfg.optim, model.parameters(), steps_per_epoch=1000))
    rng = np.random.default_rng(0)
    audio = torch.from_numpy((rng.standard_normal((batch, num_samples))
                              * 0.1).astype(np.float32)).to(device)
    lengths = torch.full((batch,), num_samples, dtype=torch.int32,
                         device=device)
    return lambda i: step(audio, lengths, i)


def synthetic_lm(root: str, order: int = 5) -> str:
    """A word ``order``-gram built from 2000 seeded lines of CORPUS_WORDS
    (the JAX tool's corpus) -> its ARPA path."""
    from conformer_tpu_torch.lm.ngram import build_arpa

    corpus = os.path.join(root, "corpus.txt")
    rng = np.random.default_rng(0)
    with open(corpus, "w", encoding="utf8") as f:
        for _ in range(2000):
            f.write(" ".join(rng.choice(CORPUS_WORDS, rng.integers(3, 9)))
                    + "\n")
    arpa = os.path.join(root, "lm.arpa")
    build_arpa(corpus, arpa, order)
    return arpa


def beam_device_fn(cfg, width: int, batch: int, num_samples: int, device,
                   root: str):
    """The forward and the device CTC beam search at W ``width``, K 8,
    alpha 2.1, beta 9.2, with the word 5-gram of ``synthetic_lm``."""
    from conformer_tpu_torch.decode.pipeline import device_lm_kwargs
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops.beam_search_device import \
        ctc_beam_search_device
    from conformer_tpu_torch.text.tokenizer import load_tokenizer
    from conformer_tpu_torch.train.steps import make_forward

    tok = load_tokenizer("vi")
    cfg = cfg.override(**{"decode.lm_path": synthetic_lm(root),
                          "decode.beam_width": width,
                          "decode.device_top_k": 8, "decode.alpha": 2.1,
                          "decode.beta": 9.2})
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0)
    forward = make_forward(cfg, model.to(device))
    kw = device_lm_kwargs(cfg, tok, device, word_fallback=True)
    audio, lengths, _, _ = _synthetic(cfg, batch, num_samples, device)

    def decode(i):
        logits, out_lengths = forward(audio, lengths)
        lp = torch.log_softmax(logits.float(), dim=-1)
        return ctc_beam_search_device(
            lp, out_lengths, beam_width=width, top_k=8, blank_id=tok.pad_id,
            unk_id=tok.unk_id, max_len=cfg.data.max_tokens, **kw)
    return decode


def transducer_beam_fn(cfg, width: int, batch: int, num_samples: int,
                       device):
    """The frontend, the transducer's encoder and its device beam search
    (W 8 unless ``--width`` is given)."""
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops.rnnt import rnnt_beam_search
    from conformer_tpu_torch.train.steps import make_forward

    cfg = cfg.override(**{"model.arch": "transducer",
                          "data.max_tokens": 96})
    width = width if width != 190 else 8
    model = build_model(cfg.model, cfg.optim.compute_dtype,
                        seed=0).to(device).eval()
    forward = make_forward(cfg, model)
    audio, lengths, _, _ = _synthetic(cfg, batch, num_samples, device)

    def decode(i):
        enc, enc_lengths = forward(audio, lengths)
        joint_fn, pred_step_fn = model.frame_fns()
        return rnnt_beam_search(
            joint_fn, enc, enc_lengths, pred_step_fn,
            model.predict_init(batch, device), beam_width=width,
            top_k=cfg.decode.rnnt_top_k,
            max_symbols=cfg.decode.rnnt_max_symbols,
            max_len=cfg.data.max_tokens)
    return decode


def step_fn(args, cfg, device, root: str):
    """The call that ``--mode`` traces: fn(i) runs step i."""
    n = int(args.audio_s * cfg.audio.sample_rate)
    if args.mode in ("pretrain", "pretrain_byol"):
        method = "wav2vec2" if args.mode == "pretrain" else "byol"
        return pretrain_fn(cfg, method, args.batch, n, device)
    if args.mode == "beam_device":
        return beam_device_fn(cfg, args.width, args.batch, n, device, root)
    if args.mode == "transducer_beam":
        return transducer_beam_fn(cfg, args.width, args.batch, n, device)
    return train_fn(cfg.override(**{"model.arch": args.arch}), args.batch,
                    n, device)


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--audio-s", type=float, default=8.0)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--mode", default="train",
                    choices=["train", "pretrain", "pretrain_byol",
                             "beam_device", "transducer_beam"],
                    help="which step to trace (pretrain = wav2vec2; "
                         "beam_device = forward + device beam + word LM)")
    ap.add_argument("--width", type=int, default=190,
                    help="beam width for --mode beam_device")
    ap.add_argument("--arch", default="ctc", choices=["ctc", "transducer"],
                    help="model arch for --mode train (transducer: U 96)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each block in the backward (BENCH_REMAT)")
    ap.add_argument("--attn", default="pallas", choices=["pallas", "xla"],
                    help="attention_impl (BENCH_ATTN)")
    ap.add_argument("--score", default="bfloat16",
                    help="attention_score_dtype (BENCH_SCORE)")
    ap.add_argument("--conv", default=None, choices=["xla", "pallas"],
                    help="conv_impl (BENCH_CONV; Config()'s when not given)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--trace-dir", default=None,
                    help="read an exported trace instead of running")
    return ap


def main(argv: Optional[List[str]] = None, cfg=None) -> dict:
    """-> the report; when it ran, also the kernel wrappers' launch counts
    over the window (``wrapper_launches``) and the directory that keeps the
    trace (``trace_dir``). ``cfg`` replaces Config() (the knobs still apply
    to it)."""
    args = parser().parse_args(argv)
    if args.trace_dir is not None:
        return report(args.trace_dir, args.top)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("trace_step needs a CUDA device (or --device "
                             "cpu)")
        print(card(), flush=True)
    device = torch.device(args.device)
    cfg = config(args, cfg)
    trace_dir = tempfile.mkdtemp(prefix="conformer_trace_")
    counts = trace_window(step_fn(args, cfg, device, trace_dir), args.steps,
                          trace_dir, device)
    print(f"trace written to {trace_dir}", flush=True)
    out = report(trace_dir, args.top)
    out.update(wrapper_launches=counts, trace_dir=trace_dir, mode={
        "mode": args.mode, "arch": args.arch, "batch": args.batch,
        "audio_s": args.audio_s, "steps": args.steps,
        "conv_impl": cfg.model.conv_impl, "remat": cfg.model.use_remat})
    return out


if __name__ == "__main__":
    main()
