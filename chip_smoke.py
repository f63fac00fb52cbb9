#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``conformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

1. build   -- compile every kernel source in conformer_tpu_torch/csrc/ with
              nvcc (one process per source, all at once) into build/.
2. kernels -- hold each kernel against its plain PyTorch version on the card
              at the shapes the serving path gives it, and time the kernel,
              the plain version and, where one exists, the one PyTorch call
              that computes the same function.
3. model   -- the production Config() model (17 blocks, d_model 512, 8
              heads, kernel 31, LSTM 640, vocab 370) with seeded random
              weights, on 8 s and 24 s batches of 8: once through the
              kernels, once through their plain versions.
4. serve   -- WAV files of 3, 8, 16 and 24 s transcribed through
              ``conformer_tpu_torch.cli.infer.main(... --device cuda)`` in
              two batches; per-batch latency, RTF and the kernels' launch
              counts over that run.

Then the card's name and power limit, the ``kernels`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
ok line; so does a machine with no CUDA device.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

PHASES = ("build", "kernels", "model", "serve")
OPTIONAL_PHASES = ("profile",)
# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
TOL_K1 = {"float32": 1e-4, "bfloat16": 3e-2}
TOL_K3 = 1e-4
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype: str) -> "tuple[float, str]":
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phase 1: build.
# ---------------------------------------------------------------------------

def phase_build():
    from conformer_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    log = build.build_all()
    ptxas = {name: [ln.strip() for ln in entry["ptxas"].splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, entry in log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {n: e["seconds"] for n, e in log.items()},
          "ptxas": ptxas})


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ---------------------------------------------------------------------------

def k1_case(torch, b: int, l: int, dtype, seed: int, time_it: bool):
    """K1 at (b, l) packed, H = 8, dh = 64, D = 512."""
    import numpy as np

    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    h, dh = 8, 64
    d = h * dh
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen)
    dev = torch.device(DEVICE)
    qu, qv, k, v = (mk(b, l, d).to(dev, dtype) for _ in range(4))
    wh = sa.prep_pos_kernel((mk(d, d) / math.sqrt(d)).to(dev, dtype), h)
    # full, partial and empty rows
    lens = [l, l - 1, l // 2, 1, 0, l, 3 * l // 4, 7][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 1.0 / math.sqrt(dh)
    s = torch.tensor(scale, dtype=dtype, device=dev)
    qu_s, qv_s = (qu * s).contiguous(), (qv * s).contiguous()
    sin_t, cos_t = sa.sincos_tables(l, d, dtype, dev)
    args = (qu_s, qv_s, k, v, wh, lengths, sin_t, cos_t)
    got = sa.sincos_attention_fwd(*args)
    want = sa.sincos_attention_plain(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    finite = bool(torch.isfinite(got.float()).all())
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    case = {"b": b, "l": l, "dtype": name, "max_abs_err": err,
            "tolerance": TOL_K1[name], "finite": finite,
            "ok": finite and err <= TOL_K1[name]}
    if time_it:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        flops = 2.0 * b * h * l * l * (dh + d + dh) + 2.0 * b * h * l * dh * d
        nbytes = (5 * b * l * d + h * dh * d + l * d) * itemsize + 4 * b
        bms, by = bound_ms(flops, nbytes, name)
        # Yardstick: one SDPA call on the augmented operands
        # [qu | alpha | beta] . [k | cos | sin]^T (never used by the port).
        d2 = d // 2
        split = lambda x: x.reshape(b, l, h, dh).transpose(1, 2)
        a = torch.einsum("bhld,hdx->bhlx", split(qv_s).float(), wh.float())
        sq, cq = sin_t.float(), cos_t.float()
        alpha = (a[..., :d2] * sq + a[..., d2:] * cq).to(dtype)
        beta = (-a[..., :d2] * cq + a[..., d2:] * sq).to(dtype)
        q_aug = torch.cat([split(qu_s), alpha, beta], dim=-1).contiguous()
        k_aug = torch.cat([split(k), cos_t.expand(b, h, l, d2),
                           sin_t.expand(b, h, l, d2)], dim=-1).contiguous()
        v_h = split(v).contiguous()
        mask = (torch.arange(l, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q_aug, k_aug, v_h, attn_mask=mask, scale=1.0)
        case.update({
            "ms": cuda_ms(torch, lambda: sa.sincos_attention_fwd(*args)),
            "plain_ms": cuda_ms(torch, lambda: sa.sincos_attention_plain(*args)),
            "library_ms": cuda_ms(torch, sdpa),
            "bound_ms": bms, "bound_by": by,
        })
    return case


def k3_case(torch, b: int, n_samples: int, seed: int, time_it: bool):
    """K3 on b rows of n_samples (one silent row, one quiet row)."""
    from conformer_tpu_torch.audio.mel import MelFrontend, reflect_pad
    from conformer_tpu_torch.config import AudioConfig
    from conformer_tpu_torch.ops.cuda import mel_frontend as mf

    cfg = AudioConfig()
    dev = torch.device(DEVICE)
    fe = MelFrontend(cfg, device=dev)
    gen = torch.Generator().manual_seed(seed)
    audio = torch.randn(b, n_samples, generator=gen) * 0.1
    audio[0] = 0.0
    if b > 1:
        audio[1] *= 1e-3
    audio = audio.to(dev)
    padded = reflect_pad(audio, cfg.n_fft // 2).contiguous()
    n_frames = n_samples // cfg.hop_length + 1
    args = (padded, fe._dft, fe._fb, cfg.hop_length, cfg.n_fft, n_frames,
            cfg.log_clamp_min)
    got = mf.logmel_fwd(*args)
    want = mf.logmel_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    case = {"b": b, "n_frames": n_frames, "frames_in_last_tile": n_frames % 64,
            "max_abs_err": err, "tolerance": TOL_K3, "finite": finite,
            "ok": finite and err <= TOL_K3}
    if time_it:
        n_bins, n_mels = fe._fb.shape
        flops = 2.0 * b * n_frames * (cfg.n_fft * 2 * n_bins + n_bins * n_mels)
        nbytes = 4.0 * (padded.numel() + fe._dft.numel() + fe._fb.numel()
                        + b * n_frames * n_mels)
        bms, by = bound_ms(flops, nbytes, "float32")
        case.update({
            "ms": cuda_ms(torch, lambda: mf.logmel_fwd(*args)),
            "plain_ms": cuda_ms(torch, lambda: mf.logmel_plain(*args)),
            # No single PyTorch call computes frame+DFT+mel+log.
            "library_ms": None,
            "bound_ms": bms, "bound_by": by,
        })
    return case


def phase_kernels(torch):
    """-> kernel entries for the final line; prints the phase line."""
    k1_cases = [k1_case(torch, 8, l, dt, seed=i, time_it=(dt == torch.bfloat16))
                for i, (l, dt) in enumerate([(199, torch.float32),
                                             (599, torch.float32),
                                             (199, torch.bfloat16),
                                             (599, torch.bfloat16)])]
    k3_cases = [k3_case(torch, 8, 16 * 16000, seed=10, time_it=True),
                k3_case(torch, 8, 24 * 16000, seed=11, time_it=True),
                k3_case(torch, 3, 7321 * 17, seed=12, time_it=False)]
    emit({"phase": "kernels", "sincos_attention_fwd": k1_cases,
          "logmel_fwd": k3_cases})
    bad = [c for c in k1_cases + k3_cases if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    main_k1 = k1_cases[3]            # bf16, B 8, L 599: the 24 s serve batch
    main_k3 = k3_cases[1]            # B 8, 2401 frames: the 24 s serve batch
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return [
        {"name": "sincos_attention_fwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:181",
         "shape": "B=8 L=599 D=512 H=8 bfloat16",
         **{k: main_k1[k] for k in keys}},
        {"name": "logmel_fwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/mel_frontend.cu",
         "replaces": "conformer_tpu/ops/pallas/mel_frontend.py:43",
         "shape": "B=8 n_frames=2401 float32",
         **{k: main_k3[k] for k in keys}},
    ]


# ---------------------------------------------------------------------------
# Phase 3: the production-width model, kernels against plain versions.
# ---------------------------------------------------------------------------

def _noise_batch(torch, b: int, seconds: float, seed: int):
    """(b, S) seeded noise, the rows cut to decreasing lengths (zeros after)."""
    n = int(seconds * 16000)
    gen = torch.Generator().manual_seed(seed)
    audio = torch.randn(b, n, generator=gen) * 0.1
    lengths = torch.tensor([n - (n // (2 * b)) * i for i in range(b)])
    audio[torch.arange(n)[None, :] >= lengths[:, None]] = 0.0
    return audio, lengths


def _plain_versions():
    """Route the model through the kernels' plain versions (on the card)."""
    from conformer_tpu_torch.audio import mel
    from conformer_tpu_torch.ops.cuda import mel_frontend as mf
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    return [mock.patch.object(sa, "sincos_attention_fwd",
                              sa.sincos_attention_plain),
            mock.patch.object(mel, "logmel_fwd", mf.logmel_plain)]


def _run(torch, fn, patches=()):
    for p in patches:
        p.start()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    finally:
        for p in patches:
            p.stop()


# bf16: the two runs round at other places (online vs one-pass softmax in
# K1, another summation order in K3), and a flipped bf16 rounding (2^-9
# relative) propagates through 17 residual blocks and the LSTM; fp32: the
# kernels agree with their plain versions to ~1e-5 per call.
TOL_MODEL = {"bfloat16": {"max_abs_rel": 0.25, "token_agreement": 0.95},
             "float32": {"max_abs": 1e-3, "token_agreement": 0.999}}


def phase_model(torch):
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import Conformer, init_weights
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.train.steps import make_forward

    dev = torch.device(DEVICE)
    results = []
    for dtype in ("bfloat16", "float32"):
        cfg = Config().override(**{"optim.compute_dtype": dtype})
        model = init_weights(Conformer(cfg.model, dtype), seed=0).to(dev).eval()
        forward = make_forward(cfg, model)
        for seconds in (8, 24):
            audio, lengths = _noise_batch(torch, 8, seconds, seed=seconds)
            audio, lengths = audio.to(dev), lengths.to(dev)
            forward(audio, lengths)                       # warm-up
            reset_launch_counts()
            (k_logits, k_len), k_ms = _run(torch, lambda: forward(audio, lengths))
            counts = launch_counts()
            (p_logits, p_len), p_ms = _run(torch, lambda: forward(audio, lengths),
                                           _plain_versions())
            valid = (torch.arange(k_logits.shape[1], device=dev)[None, :]
                     < k_len[:, None])
            agree = float((k_logits.argmax(-1) == p_logits.argmax(-1))[valid]
                          .float().mean())
            diff = float((k_logits - p_logits).abs().max())
            scale = float(p_logits.abs().max())
            tol = TOL_MODEL[dtype]
            ok = (bool(torch.isfinite(k_logits).all())
                  and torch.equal(k_len, p_len)
                  and tuple(k_logits.shape) == (8, (seconds * 50 - 1) // 2, 370)
                  and agree >= tol["token_agreement"]
                  and (diff <= tol["max_abs"] if "max_abs" in tol
                       else diff <= tol["max_abs_rel"] * scale)
                  and counts["sincos_attention_fwd"] == cfg.model.n_blocks
                  and counts["logmel_fwd"] == (1 if seconds >= 16 else 0))
            results.append({"dtype": dtype, "seconds": seconds,
                            "logits_shape": list(k_logits.shape),
                            "max_abs_diff": diff, "max_abs_logit": scale,
                            "token_agreement": agree, "tolerance": tol,
                            "kernel_forward_ms": k_ms,
                            "plain_forward_ms": p_ms,
                            "launches": counts, "ok": ok})
        del model, forward
    emit({"phase": "model", "config": "Config() production, seeded random "
          "weights, B=8", "runs": results})
    if not all(r["ok"] for r in results):
        raise SystemExit("model phase failed")


# ---------------------------------------------------------------------------
# Phase 4: serve WAV files through the CLI.
# ---------------------------------------------------------------------------

SERVE_SECONDS = [3, 8, 3, 8, 3, 8, 3, 8, 16, 24, 16, 24, 16, 24, 16, 24]


def phase_serve(torch, tmp: str):
    """-> launch counts of the one driven run."""
    import numpy as np
    from scipy.io import wavfile

    from conformer_tpu_torch.cli import infer
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    rng = np.random.default_rng(0)
    paths = []
    for i, sec in enumerate(SERVE_SECONDS):
        path = os.path.join(tmp, f"utt{i:02d}_{sec}s.wav")
        wav = np.clip(rng.standard_normal(sec * 16000) * 0.1, -1, 1)
        wavfile.write(path, 16000, (wav * 32767).astype(np.int16))
        paths.append(path)
    out_csv = os.path.join(tmp, "out.csv")
    reset_launch_counts()
    t0 = time.perf_counter()
    pipe = infer.main(["--audio", *paths, "--batch-size", "8",
                       "--device", DEVICE, "--output", out_csv])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    with open(out_csv, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    audio_s = sum(b["audio_s"] for b in pipe.batch_log)
    busy_s = sum(b["seconds"] for b in pipe.batch_log)
    emit({"phase": "serve", "files": len(paths), "batches": pipe.batch_log,
          "rtf": busy_s / audio_s, "main_wall_s": wall,
          "launches": counts, "transcripts": len(rows) - 1})
    if rows[0] != ["path", "prediction"] or len(rows) != len(paths) + 1:
        raise SystemExit("serve phase wrote a malformed CSV")
    if not all(counts.values()):
        raise SystemExit(f"a kernel of the serving path never launched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# Optional phase: where the time of one 24 s forward goes.
# ---------------------------------------------------------------------------

def phase_profile(torch):
    from torch.profiler import ProfilerActivity, profile

    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import Conformer, init_weights
    from conformer_tpu_torch.train.steps import make_forward

    cfg = Config()
    dev = torch.device(DEVICE)
    model = init_weights(Conformer(cfg.model, "bfloat16"), 0).to(dev).eval()
    forward = make_forward(cfg, model)
    out = {}
    for seconds in (8, 24):
        audio, lengths = _noise_batch(torch, 8, seconds, seed=seconds)
        audio, lengths = audio.to(dev), lengths.to(dev)
        forward(audio, lengths)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forward(audio, lengths)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # Kernel rows only: an aten op's row repeats the time of the kernels
        # it launched, and the port's own kernels have no aten op above them.
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = lambda e: e.self_device_time_total
        total_us = sum(dev_us(e) for e in events)
        top = sorted(events, key=dev_us, reverse=True)[:12]
        out[f"{seconds}s"] = {
            "wall_ms": wall_ms, "device_busy_ms": total_us / 1e3,
            "device_idle_share": max(0.0, 1 - total_us / 1e3 / wall_ms),
            "top": [{"name": e.key[:80], "device_ms": dev_us(e) / 1e3,
                     "count": e.count} for e in top]}
    emit({"phase": "profile", "config": "Config() bf16, B=8", **out})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--phases", default=",".join(PHASES),
                   help="comma-separated subset of "
                        + ",".join(PHASES + OPTIONAL_PHASES))
    args = p.parse_args(argv)
    phases = [x for x in args.phases.split(",") if x]
    unknown = set(phases) - set(PHASES + OPTIONAL_PHASES)
    if unknown:
        raise SystemExit(f"unknown phases: {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import conformer_tpu_torch  # noqa: F401  (fails outside a checkout)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    entries = []
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        entries = phase_kernels(torch)
    if "model" in phases:
        phase_model(torch)
    if "serve" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            counts = phase_serve(torch, tmp)
        for entry in entries:
            entry["launches"] = counts[entry["name"]]
    if "profile" in phases:
        phase_profile(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
