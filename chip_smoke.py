#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``conformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

1. build   -- compile every kernel source in conformer_tpu_torch/csrc/ with
              nvcc (one process per source, all at once) into build/.
2. kernels -- hold each kernel against its plain PyTorch version on the card
              at the shapes the serving and training paths give it (K1 with
              and without dropout, K2 at rates 0 and 0.1, K3, the depthwise
              conv K4a/K4b and its autograd Function at K 31 and 4, K5 for
              every op), and time the kernel, the plain version, the bound
              and, where one exists, the one PyTorch call that computes the
              same function; bf16 K2 at its longest L, and one key past it
              (must raise); K4a at L 2400; K5's per-pass slopes through
              ``conformer_tpu_torch.tools.bench_vpu_pass.main``.
   tolerance -- K1 and K2 again over 8 more seeds: each check's largest
              reading beside its limit.
3. model   -- the production Config() model (17 blocks, d_model 512, 8
              heads, kernel 31, LSTM 640, vocab 370) with seeded random
              weights, on 8 s and 24 s batches of 8, with the depthwise conv
              through F.conv1d (conv_impl xla) and through K4 (pallas): a
              forward, and one train step (dropout 0.1, SpecAugment, remat),
              once through the kernels, once through their plain versions;
              and an fp32 forward of both conv_impls on the same weights.
4. serve   -- WAV files of 3, 8, 16 and 24 s transcribed through
              ``conformer_tpu_torch.cli.infer.main(... --device cuda)`` in
              two batches; per-batch latency, RTF and the kernels' launch
              counts over that run.
5. train   -- 16 WAVs (7.5 s and 23.5 s) trained on through
              ``conformer_tpu_torch.cli.train.main(... --device cuda)`` for
              4 steps with checkpoints, then resumed to step 6; per-step
              time, audio-s/s, loss, grad norm, peak memory and launches.
6. evaluate -- with conv_impl pallas: the train phase's WAVs trained on for
              2 steps through ``cli.train`` with a validation manifest
              (validation every 2 steps), the checkpoint evaluated through
              ``cli.test.main(... --device cuda)`` (WER, CER, loss, results
              CSV), again through the plain versions (the loss must agree),
              and the validation WAVs served through ``cli.infer``.

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

PHASES = ("build", "kernels", "tolerance", "model", "serve", "train",
          "evaluate")
OPTIONAL_PHASES = ("profile",)
# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
TOL_K1 = {"float32": 1e-4, "bfloat16": 3e-2}
# K2, per gradient: max |kernel - plain| over each (batch row, head) slice
# (dwh: each head) against that slice's own max |plain|, the scale floored
# at K2_FLOOR of the gradient's max, so that no row sets the scale of
# another (a row with one key has a dv of up to ~100, a full row ~0.5).
# fp32: summation order only; bf16: ds, da and p_drop are rounded to bf16
# before their products and the outputs to bf16, and a flipped rounding
# moves a value by one bf16 ulp, 2^-8 to 2^-7 of a slice's max: 4 ulps.
TOL_K2 = {"float32": 1e-4, "bfloat16": 3e-2}
K2_FLOOR = 1e-3
K2_GRADS = ("dqu", "dqv", "dk", "dv", "dwh")
# K1's row statistics, relative: fp32 sums in another order; bf16 also flips
# roundings of alpha/beta, which move a score by a bf16 ulp of its term.
TOL_STATS = {"float32": 1e-4, "bfloat16": 4e-3}
# The tolerance phase runs K1 and K2 again over these seeds.
SWEEP_SEEDS = tuple(range(200, 208))
DROPOUT_SEED = 1234567
TOL_K3 = 1e-4
# K4a rounds after every product and add exactly as its plain version does:
# it must be equal; the reading is the largest difference in units in the
# last place of the dtype, and one is the most PERF.md may explain.
TOL_K4A_ULPS = 1
# K4b's fp32 sums run in another order than the plain version's: max |diff|
# over max |dw|; rounded to bf16, one bf16 ulp per element.
TOL_K4B = 1e-5
TOL_K4B_BF16_ULPS = 1
# The autograd Function against autograd through the plain per-tap loop,
# per gradient, max |diff| over max |grad|: fp32 sums in another order;
# bf16 also rounds each sum in another order (31 rounded adds).
TOL_K4_GRAD = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_K5 = 1e-5
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

def _attention_inputs(torch, b: int, l: int, dtype, seed: int):
    """Packed attention operands at H = 8, dh = 64, D = 512, scale folded
    into qu/qv, key lengths full, partial and 0."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    h, dh = 8, 64
    d = h * dh
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen)
    dev = torch.device(DEVICE)
    qu, qv, k, v = (mk(b, l, d).to(dev, dtype) for _ in range(4))
    wh = sa.prep_pos_kernel((mk(d, d) / math.sqrt(d)).to(dev, dtype), h)
    lens = [l, l - 1, l // 2, 1, 0, l, 3 * l // 4, 7][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    s = torch.tensor(1.0 / math.sqrt(dh), dtype=dtype, device=dev)
    sin_t, cos_t = sa.sincos_tables(l, d, dtype, dev)
    dout = mk(b, l, d).to(dev, dtype)
    return ((qu * s).contiguous(), (qv * s).contiguous(), k, v, wh, lengths,
            sin_t, cos_t), dout


def _augmented(torch, args):
    """SDPA operands [qu | alpha | beta], [k | cos | sin], v per head, and
    the key mask: the yardstick library call for K1 and K2 (never used by
    the port)."""
    qu_s, qv_s, k, v, wh, lengths, sin_t, cos_t = args
    b, l, d = qu_s.shape
    h, dh = wh.shape[0], wh.shape[1]
    d2 = d // 2
    split = lambda x: x.reshape(b, l, h, dh).transpose(1, 2)
    a = torch.einsum("bhld,hdx->bhlx", split(qv_s).float(), wh.float())
    sq, cq = sin_t.float(), cos_t.float()
    alpha = (a[..., :d2] * sq + a[..., d2:] * cq).to(qu_s.dtype)
    beta = (-a[..., :d2] * cq + a[..., d2:] * sq).to(qu_s.dtype)
    q_aug = torch.cat([split(qu_s), alpha, beta], dim=-1).contiguous()
    k_aug = torch.cat([split(k), cos_t.expand(b, h, l, d2),
                       sin_t.expand(b, h, l, d2)], dim=-1).contiguous()
    mask = (torch.arange(l, device=qu_s.device)[None, :]
            < lengths[:, None])[:, None, None, :]
    return q_aug, k_aug, split(v).contiguous(), mask


def k1_case(torch, b: int, l: int, dtype, seed: int, time_it: bool,
            rate: float = 0.0):
    """K1 at (b, l), H = 8, dh = 64, D = 512; output and row statistics."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    h, dh, d = 8, 64, 512
    args, _ = _attention_inputs(torch, b, l, dtype, seed)
    drop = (rate, DROPOUT_SEED, sa.hash_tq(l))
    got, got_st = sa.sincos_attention_fwd(*args, *drop, stats=True)
    want, want_st = sa.sincos_attention_plain(*args, *drop, stats=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    # the row max is exact; the row sum is summed online, tile by tile
    st_err = float(((got_st - want_st).abs() / want_st.abs().clamp(min=1.0))
                   .max())
    finite = bool(torch.isfinite(got.float()).all())
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    case = {"b": b, "l": l, "dtype": name, "rate": rate, "max_abs_err": err,
            "tolerance": TOL_K1[name], "stats_rel_err": st_err,
            "stats_tolerance": TOL_STATS[name], "finite": finite,
            "ok": finite and err <= TOL_K1[name] and st_err <= TOL_STATS[name]}
    if time_it:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        flops = 2.0 * b * h * l * l * (dh + d + dh) + 2.0 * b * h * l * dh * d
        nbytes = (5 * b * l * d + h * dh * d + l * d) * itemsize + 4 * b
        bms, by = bound_ms(flops, nbytes, name)
        q_aug, k_aug, v_h, mask = _augmented(torch, args)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q_aug, k_aug, v_h, attn_mask=mask, scale=1.0,
            dropout_p=rate)
        case.update({
            "ms": cuda_ms(torch, lambda: sa.sincos_attention_fwd(*args, *drop)),
            "plain_ms": cuda_ms(torch,
                                lambda: sa.sincos_attention_plain(*args, *drop)),
            "library_ms": cuda_ms(torch, sdpa),
            "bound_ms": bms, "bound_by": by,
        })
    return case


def _slices(x, key: str, h: int):
    """|x| with one row per (batch row, head) slice of a (B, L, D)
    gradient, or per head of dwh (H, dh, D)."""
    x = x.float().abs()
    if key == "dwh":
        return x.reshape(x.shape[0], -1)
    b, l, d = x.shape
    return x.reshape(b, l, h, d // h).transpose(1, 2).reshape(b * h, -1)


def k2_rel_err(got, want, key: str, h: int) -> float:
    """max over slices of max |got - want| / max(max |want| in the slice,
    K2_FLOOR * max |want|)."""
    diff = _slices(got.float() - want.float(), key, h).amax(dim=1)
    scale = _slices(want, key, h).amax(dim=1)
    floor = max(float(scale.max()) * K2_FLOOR, 1e-30)
    return float((diff / scale.clamp(min=floor)).max())


def k2_case(torch, b: int, l: int, dtype, seed: int, rate: float,
            time_it: bool):
    """K2 against its plain version, each gradient held per slice
    (k2_rel_err), and two controls that must exceed the limit: the kernel's
    gradients with slice (batch row 0, a full row; head 0) scaled by
    1 + 2 * limit, and, with dropout, the plain backward under another
    seed."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    h, dh, d = 8, 64, 512
    args, dout = _attention_inputs(torch, b, l, dtype, seed)
    drop = (rate, DROPOUT_SEED, sa.hash_tq(l))
    out, stats = sa.sincos_attention_fwd(*args, *drop, stats=True)
    bwd_args = (*args, stats, dout, *drop)
    got = sa.sincos_attention_bwd(*bwd_args)
    want = sa.sincos_attention_bwd_plain(*bwd_args)
    torch.cuda.synchronize()
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    tol = TOL_K2[name]
    rel, controls, err = {}, {}, 0.0
    for key, g_, w_ in zip(K2_GRADS, got, want):
        err = max(err, float((g_.float() - w_.float()).abs().max()))
        rel[key] = k2_rel_err(g_, w_, key, h)
        scaled = g_.float().clone()
        (scaled[0] if key == "dwh"
         else scaled.view(b, l, h, dh)[0, :, 0]).mul_(1 + 2 * tol)
        controls[f"{key}_slice_scaled"] = k2_rel_err(scaled, w_, key, h)
    if rate > 0:
        other = sa.sincos_attention_bwd_plain(*args, stats, dout, rate,
                                              DROPOUT_SEED + 1, drop[2])
        controls["other_seed"] = max(k2_rel_err(g_, o_, key, h) for key, g_, o_
                                     in zip(K2_GRADS, got, other))
    finite = all(bool(torch.isfinite(g_.float()).all()) for g_ in got)
    case = {"b": b, "l": l, "dtype": name, "rate": rate, "max_abs_err": err,
            "rel_err": rel,
            "max_rel_err": max(rel.values()), "tolerance": tol,
            "controls": controls, "finite": finite,
            "ok": (finite and max(rel.values()) <= tol
                   and min(controls.values()) > tol)}
    if time_it:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        flops = (2.0 * b * h * l * l * (2 * d + 5 * dh)
                 + 3 * 2.0 * b * h * l * dh * d)
        nbytes = ((9 * b * l * d + 2 * h * dh * d + l * d) * itemsize
                  + 8 * b * h * l + 4 * b)
        bms, by = bound_ms(flops, nbytes, name)
        q_aug, k_aug, v_h, mask = _augmented(torch, args)
        q_aug.requires_grad_(True)
        k_aug.requires_grad_(True)
        v_h.requires_grad_(True)
        g_out = dout.reshape(b, l, h, dh).transpose(1, 2).contiguous()

        def sdpa_fwd_bwd():
            o = torch.nn.functional.scaled_dot_product_attention(
                q_aug, k_aug, v_h, attn_mask=mask, scale=1.0, dropout_p=rate)
            o.backward(g_out)

        out_aug = torch.nn.functional.scaled_dot_product_attention(
            q_aug, k_aug, v_h, attn_mask=mask, scale=1.0, dropout_p=rate)
        sdpa_bwd = lambda: torch.autograd.grad(
            out_aug, (q_aug, k_aug, v_h), g_out, retain_graph=True)
        case.update({
            "ms": cuda_ms(torch, lambda: sa.sincos_attention_bwd(*bwd_args)),
            "plain_ms": cuda_ms(torch, lambda: sa.sincos_attention_bwd_plain(
                *bwd_args), iters=5),
            "library_ms": cuda_ms(torch, sdpa_bwd),
            "library_call": "SDPA backward alone on [qu|alpha|beta], "
                            "[k|cos|sin], v",
            "library_fwd_bwd_ms": cuda_ms(torch, sdpa_fwd_bwd),
            "bound_ms": bms, "bound_by": by,
        })
    return case


def k2_length_limit(torch):
    """bf16 K2 keeps ds for every key in shared memory: at the longest L it
    takes (768 at H = 8) it must agree with its plain version, and one key
    further it must raise ValueError before launching."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    at_limit = k2_case(torch, 1, 768, torch.bfloat16, seed=40, rate=0.1,
                       time_it=False)
    args, dout = _attention_inputs(torch, 1, 769, torch.bfloat16, seed=41)
    stats = torch.zeros(1, 8, 769, 2, device=DEVICE)
    try:
        sa.sincos_attention_bwd(*args, stats, dout)
        message = None
    except ValueError as e:
        message = str(e)
    return {"at_768": at_limit, "error_at_769": message,
            "ok": at_limit["ok"] and message is not None
            and "L <= 768" in message}


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


def _dtype_name(torch, dtype) -> str:
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def ulps(torch, got, want) -> float:
    """Largest |got - want| in units in the last place of want's dtype at
    want's magnitude (float32 24 significand bits, bfloat16 8)."""
    bits = 8 if want.dtype == torch.bfloat16 else 24
    _, exp = torch.frexp(want.float())
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exp - bits)
    return float(((got.float() - want.float()).abs() / ulp).max())


def _conv_inputs(torch, b: int, l: int, c: int, k: int, dtype, seed: int):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to(DEVICE, dtype)
    return mk(b, l, c), (torch.randn(k, c, generator=gen) / math.sqrt(k)).to(
        DEVICE, dtype), mk(c), mk(b, l, c)


def k4a_case(torch, b: int, l: int, dtype, seed: int, time_it: bool,
             c: int = 512, k: int = 31):
    """K4a at (b, l, c), k taps, same pad: equal to its plain version."""
    import torch.nn.functional as F

    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc

    x, w, bias, _ = _conv_inputs(torch, b, l, c, k, dtype, seed)
    pad = (k - 1) // 2
    before = dc.depthwise_conv_fwd.launches
    got = dc.depthwise_conv_fwd(x, w, bias, pad)
    launched = dc.depthwise_conv_fwd.launches - before
    want = dc.depthwise_conv_plain(x, w, bias, pad)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got.float()).all())
    ulp = ulps(torch, got, want)
    case = {"b": b, "l": l, "c": c, "k": k, "dtype": _dtype_name(torch, dtype),
            "equal": bool(torch.equal(got, want)),
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_ulps": ulp, "tolerance_ulps": TOL_K4A_ULPS,
            "launched": launched, "finite": finite,
            "ok": finite and launched == 1 and ulp <= TOL_K4A_ULPS}
    if time_it:
        itemsize = x.element_size()
        flops = 2.0 * b * l * c * k
        nbytes = (2 * b * l * c + k * c + c) * itemsize
        bms, by = bound_ms(flops, nbytes, case["dtype"])
        w_conv = w.t().unsqueeze(1).contiguous()          # (C, 1, K)
        conv = lambda: F.conv1d(x.transpose(1, 2), w_conv, bias, padding=pad,
                                groups=c)
        case.update({
            "ms": cuda_ms(torch, lambda: dc.depthwise_conv_fwd(x, w, bias, pad)),
            "plain_ms": cuda_ms(torch, lambda: dc.depthwise_conv_plain(
                x, w, bias, pad), iters=5),
            "library_ms": cuda_ms(torch, conv),
            "library_call": "F.conv1d(groups=C) on x.transpose(1, 2)",
            "bound_ms": bms, "bound_by": by})
    return case


def k4b_case(torch, b: int, l: int, dtype, seed: int, time_it: bool,
             c: int = 512, k: int = 31):
    """K4b (fp32 dw) against its plain version, relative to max |dw|, and
    rounded to bf16 within one bf16 ulp per element."""
    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc

    x, _, _, g = _conv_inputs(torch, b, l, c, k, dtype, seed)
    pad = (k - 1) // 2
    got = dc.depthwise_conv_dw(x, g, k, pad)
    want = dc.depthwise_conv_dw_plain(x, g, k, pad)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    bf16_ulps = ulps(torch, got.to(torch.bfloat16), want.to(torch.bfloat16))
    finite = bool(torch.isfinite(got).all())
    case = {"b": b, "l": l, "c": c, "k": k, "dtype": _dtype_name(torch, dtype),
            "max_abs_err": float((got - want).abs().max()), "rel_err": rel,
            "tolerance": TOL_K4B, "bf16_max_ulps": bf16_ulps,
            "bf16_tolerance_ulps": TOL_K4B_BF16_ULPS, "finite": finite,
            "ok": (finite and got.dtype == torch.float32 and rel <= TOL_K4B
                   and bf16_ulps <= TOL_K4B_BF16_ULPS)}
    if time_it:
        itemsize = x.element_size()
        flops = 2.0 * b * l * c * k
        nbytes = 2 * b * l * c * itemsize + 4 * k * c
        bms, by = bound_ms(flops, nbytes, case["dtype"])
        w_conv = torch.zeros(c, 1, k, device=DEVICE, dtype=dtype)
        xt, gt = x.transpose(1, 2), g.transpose(1, 2)
        weight_grad = lambda: torch.ops.aten.convolution_backward(
            gt, xt, w_conv, None, [1], [pad], [1], False, [0], c,
            [False, True, False])
        case.update({
            "ms": cuda_ms(torch, lambda: dc.depthwise_conv_dw(x, g, k, pad)),
            "plain_ms": cuda_ms(torch, lambda: dc.depthwise_conv_dw_plain(
                x, g, k, pad), iters=5),
            "library_ms": cuda_ms(torch, weight_grad),
            "library_call": "aten.convolution_backward, weight gradient only",
            "bound_ms": bms, "bound_by": by})
    return case


def k4_grad_case(torch, k: int, dtype, seed: int, b: int = 8, l: int = 599,
                 c: int = 512):
    """The autograd Function (K4a forward and dx, K4b dw) against autograd
    through the plain per-tap loop, per gradient, relative to its max. At
    even k, a control: dx under the forward's left pad (the JAX ``_bwd``)
    must miss."""
    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc

    x, w, bias, g = _conv_inputs(torch, b, l, c, k, dtype, seed)
    pad = (k - 1) // 2
    grads = []
    for fn in (lambda *a: dc.depthwise_conv1d(*a),
               lambda *a: dc.depthwise_conv_plain(*a, pad)):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        fn(*leaves).backward(g)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    name = _dtype_name(torch, dtype)
    rel = {key: float((a.float() - e.float()).abs().max()
                      / e.float().abs().max())
           for key, a, e in zip(("dx", "dw", "db"), *grads)}
    case = {"k": k, "b": b, "l": l, "c": c, "dtype": name, "rel_err": rel,
            "tolerance": TOL_K4_GRAD[name],
            "ok": max(rel.values()) <= TOL_K4_GRAD[name]}
    if k % 2 == 0:
        shifted = dc.depthwise_conv_fwd(
            g, w.flip(0).contiguous(), torch.zeros_like(bias), pad)
        exact = grads[1][0]
        case["control_forward_pad_dx_rel_err"] = float(
            (shifted.float() - exact.float()).abs().max()
            / exact.float().abs().max())
        case["ok"] = case["ok"] and (case["control_forward_pad_dx_rel_err"]
                                     > TOL_K4_GRAD[name])
    return case


def k5_checks(torch):
    """K5 for every op at n = 4 on the production tile against its plain
    version (relative), then the per-pass slopes through the benchmark's
    main() with the launch counts set to 0 just before. -> (phase entry,
    kernels-line entry, launches of the benchmark run)."""
    from conformer_tpu_torch.ops.cuda.vpu_pass import (OPS, vpu_pass,
                                                       vpu_pass_plain)
    from conformer_tpu_torch.tools import bench_vpu_pass as bench

    x = bench.tile_input(bench.ROWS, bench.COLS, bench.GRID)
    checks = {}
    for op in OPS:
        got = vpu_pass(x, op, 4, bench.ROWS)
        want = vpu_pass_plain(x, op, 4)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        checks[op] = {"rel_err": rel, "ok": rel <= TOL_K5
                      and bool(torch.isfinite(got).all())}
    vpu_pass.launches = 0
    slopes = bench.main()
    launches = vpu_pass.launches
    n, elems = bench.N_HI, x.numel()
    clock = bench.max_sm_clock_hz()
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_ms = n * bench.pass_bound_s("add", elems, clock, n_sms) * 1e3
    bytes_ms = 8.0 * elems / PEAK_BYTES_PER_S * 1e3
    entry = {"op": "add", "n": n, "shape": "(256, 199) x 448 fp32",
             "max_abs_err": float((vpu_pass(x, "add", n, bench.ROWS)
                                   - vpu_pass_plain(x, "add", n)).abs().max()),
             "ms": slopes["add"][f"ms_n{n}"],
             "plain_ms": cuda_ms(torch, lambda: vpu_pass_plain(x, "add", n),
                                 iters=3),
             "bound_ms": max(ops_ms, bytes_ms),
             "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
             "library_ms": None}
    phase = {"checks_n4": checks, "tolerance": TOL_K5, "slopes": slopes,
             "sm_clock_mhz": clock / 1e6, "sms": n_sms,
             "ok": all(c["ok"] for c in checks.values())}
    return phase, entry, launches


def phase_kernels(torch):
    """-> (kernel entries for the final line, launches of the runs driven
    here); prints the phase line."""
    shapes = [(199, torch.float32), (599, torch.float32),
              (199, torch.bfloat16), (599, torch.bfloat16)]
    k1_cases = [k1_case(torch, 8, l, dt, seed=i, time_it=(dt == torch.bfloat16))
                for i, (l, dt) in enumerate(shapes)]
    k1_drop = [k1_case(torch, 8, l, dt, seed=20 + i, rate=0.1,
                       time_it=(dt == torch.bfloat16))
               for i, (l, dt) in enumerate(shapes)]
    k2_cases = [k2_case(torch, 8, l, dt, seed=30 + i, rate=rate,
                        time_it=(dt == torch.bfloat16 and rate > 0))
                for i, (l, dt) in enumerate(shapes) for rate in (0.0, 0.1)]
    limit = k2_length_limit(torch)
    k3_cases = [k3_case(torch, 8, 16 * 16000, seed=10, time_it=True),
                k3_case(torch, 8, 24 * 16000, seed=11, time_it=True),
                k3_case(torch, 3, 7321 * 17, seed=12, time_it=False)]
    conv_shapes = [(l, dt) for dt in (torch.float32, torch.bfloat16)
                   for l in (199, 599)]
    k4a_cases = [k4a_case(torch, 8, l, dt, seed=50 + i, time_it=True)
                 for i, (l, dt) in enumerate(conv_shapes)]
    # past the JAX kernel's 12 MB VMEM budget, where it falls back to XLA
    k4a_long = k4a_case(torch, 8, 2400, torch.float32, seed=55, time_it=False)
    k4b_cases = [k4b_case(torch, 8, l, dt, seed=60 + i, time_it=True)
                 for i, (l, dt) in enumerate(conv_shapes)]
    k4_grads = [k4_grad_case(torch, k, dt, seed=70 + k)
                for k in (31, 4) for dt in (torch.float32, torch.bfloat16)]
    k5, k5_entry, k5_launches = k5_checks(torch)
    emit({"phase": "kernels", "sincos_attention_fwd": k1_cases,
          "sincos_attention_fwd_dropout": k1_drop,
          "sincos_attention_bwd": k2_cases,
          "sincos_attention_bwd_length_limit": limit, "logmel_fwd": k3_cases,
          "depthwise_conv_fwd": k4a_cases,
          "depthwise_conv_fwd_l2400": k4a_long,
          "depthwise_conv_dw": k4b_cases, "depthwise_conv1d_grads": k4_grads,
          "vpu_pass": k5})
    bad = [c for c in k1_cases + k1_drop + k2_cases + [limit] + k3_cases
           + k4a_cases + [k4a_long] + k4b_cases + k4_grads + [k5]
           if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    pick = lambda case, **extra: {**{k: case[k] for k in keys if k in case},
                                  **extra}
    main_k2 = k2_cases[7]            # bf16, L 599, rate 0.1: the 24 s train batch
    return [
        {"name": "sincos_attention_fwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:181",
         "shape": "B=8 L=599 D=512 H=8 bfloat16",
         **pick(k1_cases[3])},
        {"name": "sincos_attention_fwd_dropout", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:157",
         "shape": "B=8 L=599 D=512 H=8 bfloat16 rate=0.1",
         **pick(k1_drop[3])},
        {"name": "sincos_attention_bwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention_bwd.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:254",
         "shape": "B=8 L=599 D=512 H=8 bfloat16 rate=0.1",
         **pick(main_k2),
         "library_fwd_bwd_ms": main_k2["library_fwd_bwd_ms"]},
        {"name": "logmel_fwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/mel_frontend.cu",
         "replaces": "conformer_tpu/ops/pallas/mel_frontend.py:43",
         "shape": "B=8 n_frames=2401 float32",
         **pick(k3_cases[1])},
        {"name": "depthwise_conv_fwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/depthwise_conv.cu",
         "replaces": "conformer_tpu/ops/pallas/depthwise_conv.py:39",
         "shape": "B=8 L=599 C=512 K=31 bfloat16",
         **pick(k4a_cases[3])},
        {"name": "depthwise_conv_dw", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/depthwise_conv.cu",
         "replaces": "conformer_tpu/ops/pallas/depthwise_conv.py:85",
         "shape": "B=8 L=599 C=512 K=31 bfloat16",
         **pick(k4b_cases[3])},
        {"name": "vpu_pass", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/vpu_pass.cu",
         "replaces": "tools/bench_vpu_pass.py:33",
         **k5_entry},
    ], {"vpu_pass": k5_launches}


def phase_tolerance(torch):
    """K1 and K2 again at every shape, dtype and rate of the kernels phase,
    over SWEEP_SEEDS: each check's largest reading beside its limit, and the
    smallest reading of K2's controls (which must exceed it)."""
    rows = []
    for l, dt in [(199, torch.float32), (599, torch.float32),
                  (199, torch.bfloat16), (599, torch.bfloat16)]:
        name = "bfloat16" if dt == torch.bfloat16 else "float32"
        for rate in (0.0, 0.1):
            k1 = [k1_case(torch, 8, l, dt, seed, False, rate)
                  for seed in SWEEP_SEEDS]
            k2 = [k2_case(torch, 8, l, dt, seed, rate, False)
                  for seed in SWEEP_SEEDS]
            rows.append({
                "l": l, "dtype": name, "rate": rate,
                "k1_max_abs_err": max(c["max_abs_err"] for c in k1),
                "k1_tolerance": TOL_K1[name],
                "k1_stats_rel_err": max(c["stats_rel_err"] for c in k1),
                "k1_stats_tolerance": TOL_STATS[name],
                "k2_rel_err": {key: max(c["rel_err"][key] for c in k2)
                               for key in K2_GRADS},
                "k2_tolerance": TOL_K2[name],
                "k2_controls_min": min(min(c["controls"].values())
                                       for c in k2),
                "ok": all(c["ok"] for c in k1 + k2)})
    emit({"phase": "tolerance", "seeds": list(SWEEP_SEEDS), "cases": rows})
    if not all(r["ok"] for r in rows):
        raise SystemExit("a kernel disagrees with its plain version at "
                         "another seed")


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
    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
    from conformer_tpu_torch.ops.cuda import mel_frontend as mf
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    return [mock.patch.object(sa, "sincos_attention_fwd",
                              sa.sincos_attention_plain),
            mock.patch.object(sa, "sincos_attention_bwd",
                              sa.sincos_attention_bwd_plain),
            mock.patch.object(mel, "logmel_fwd", mf.logmel_plain),
            mock.patch.object(dc, "depthwise_conv_fwd",
                              dc.depthwise_conv_plain),
            mock.patch.object(dc, "depthwise_conv_dw",
                              dc.depthwise_conv_dw_plain)]


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


def _forward_case(torch, cfg, forward, dtype: str, seconds: int):
    """One forward of an 8-row batch through the kernels (counted) and
    through their plain versions."""
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    dev = torch.device(DEVICE)
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
    n_blocks = cfg.model.n_blocks
    pallas = cfg.model.conv_impl == "pallas"
    ok = (bool(torch.isfinite(k_logits).all())
          and torch.equal(k_len, p_len)
          and tuple(k_logits.shape) == (8, (seconds * 50 - 1) // 2, 370)
          and agree >= tol["token_agreement"]
          and (diff <= tol["max_abs"] if "max_abs" in tol
               else diff <= tol["max_abs_rel"] * scale)
          and counts["sincos_attention_fwd"] == n_blocks
          and counts["depthwise_conv_fwd"] == (n_blocks if pallas else 0)
          and counts["logmel_fwd"] == (1 if seconds >= 16 else 0))
    return k_logits, {"dtype": dtype, "conv_impl": cfg.model.conv_impl,
                      "seconds": seconds, "logits_shape": list(k_logits.shape),
                      "max_abs_diff": diff, "max_abs_logit": scale,
                      "token_agreement": agree, "tolerance": tol,
                      "kernel_forward_ms": k_ms, "plain_forward_ms": p_ms,
                      "launches": counts, "ok": ok}


def phase_model(torch):
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import Conformer, init_weights
    from conformer_tpu_torch.train.steps import make_forward

    dev = torch.device(DEVICE)
    results, impl_diffs = [], []
    for dtype in ("bfloat16", "float32"):
        logits = {}
        state = None
        for impl in ("xla", "pallas"):
            cfg = Config().override(**{"optim.compute_dtype": dtype,
                                       "model.conv_impl": impl})
            model = init_weights(Conformer(cfg.model, dtype), seed=0)
            if state is None:
                state = model.state_dict()
            model.load_state_dict(state)           # the same weights
            model = model.to(dev).eval()
            forward = make_forward(cfg, model)
            for seconds in (8, 24):
                logits[impl, seconds], case = _forward_case(
                    torch, cfg, forward, dtype, seconds)
                results.append(case)
            del model, forward
        if dtype == "float32":
            # the same function by two routes: F.conv1d's depthwise conv and K4a
            for seconds in (8, 24):
                diff = float((logits["pallas", seconds]
                              - logits["xla", seconds]).abs().max())
                tol = TOL_MODEL["float32"]["max_abs"]
                impl_diffs.append({"seconds": seconds, "max_abs_diff": diff,
                                   "tolerance": tol, "ok": diff <= tol})
        del logits
    train_runs = [train_step_case(torch, dtype, seconds)
                  for dtype in ("bfloat16", "float32") for seconds in (8, 24)]
    train_runs += [train_step_case(torch, dtype, 24, conv_impl="pallas")
                   for dtype in ("bfloat16", "float32")]
    emit({"phase": "model", "config": "Config() production, seeded random "
          "weights, B=8", "runs": results,
          "float32_pallas_vs_xla_conv": impl_diffs, "train_steps": train_runs})
    if not all(r["ok"] for r in results + impl_diffs + train_runs):
        raise SystemExit("model phase failed")


# One train step through the kernels against the plain versions: the loss
# and grad norm relative to the plain run's, and per parameter max |dg| over
# max |g|. fp32: the kernels agree with their plain versions to ~1e-6 per
# call; bf16: flipped roundings (K2's are 4 ulps of a gradient) travel
# through 17 blocks and their backward, as in the forward comparison above.
# The parameters whose exact gradient is 0 are held against the grad norm:
# 1e-6 of it is ~1 % of an average element's share (~1e-4 over ~1e8
# parameters), so a K2 whose dk no longer sums to 0 over the keys (the key
# bias's gradient) fails.
TOL_TRAIN = {"bfloat16": {"loss": 2e-2, "grad_norm": 5e-2, "param": 0.25,
                          "zero_gradient": 1e-6},
             "float32": {"loss": 1e-4, "grad_norm": 1e-3, "param": 1e-2,
                         "zero_gradient": 1e-6}}


def _tokens(torch, b: int, n: int, seed: int):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, 370, (b, n), generator=gen)
    lengths = torch.tensor([n - 3 * i for i in range(b)])
    tokens[torch.arange(n)[None, :] >= lengths[:, None]] = 0
    return tokens, lengths


def train_step_case(torch, dtype: str, seconds: int, conv_impl: str = "xla"):
    """One production train step (dropout 0.1 hash, SpecAugment, remat,
    Adam at learning rate 0 so both runs see the same weights), through the
    kernels and through their plain versions, with the same seeds. Under
    remat K4a runs three times per block (forward, recomputation, dx) and
    K4b once."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import Conformer, init_weights
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_train_step

    dev = torch.device(DEVICE)
    cfg = Config().override(**{"optim.compute_dtype": dtype,
                               "optim.learning_rate": 0.0,
                               "model.conv_impl": conv_impl})
    model = init_weights(Conformer(cfg.model, dtype), seed=0).to(dev)
    opt = make_optimizer(cfg.optim, model.parameters())
    step = make_train_step(cfg, model, opt)
    audio, lengths = _noise_batch(torch, 8, seconds, seed=100 + seconds)
    tokens, token_lengths = _tokens(torch, 8, 60, seed=seconds)
    args = [x.to(dev) for x in (audio, lengths, tokens, token_lengths)]
    runs = {}
    for name, patches in (("kernels", ()), ("plain", _plain_versions())):
        reset_launch_counts()
        metrics, ms = _run(torch, lambda: step(*args, 7), patches)
        runs[name] = {"loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "grads": {n: p.grad.detach().float().clone()
                                for n, p in model.named_parameters()},
                      "ms": ms, "launches": launch_counts()}
    k, p = runs["kernels"], runs["plain"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    # Three kinds of parameter have an exact gradient of 0: the attention's
    # key and position biases (softmax ignores a shift shared by a row's
    # scores) and the depthwise conv's bias (the batch-statistics BatchNorm
    # after it removes it). Theirs is rounding noise in both runs; it is
    # held against the grad norm instead.
    zero = [n for n in p["grads"] if n.endswith(
        ("attention.key.bias", "attention.pos.bias", "conv.depthwise.bias"))]
    param_err = {n: float((k["grads"][n] - g).abs().max())
                 / max(float(g.abs().max()), 1e-30)
                 for n, g in p["grads"].items() if n not in zero}
    zero_grad_max = max(float(k["grads"][n].abs().max()) for n in zero)
    top = sorted(param_err, key=param_err.get, reverse=True)[:3]
    worst = top[0]
    tol = TOL_TRAIN[dtype]
    n_blocks = cfg.model.n_blocks
    ok = (all(torch.isfinite(torch.tensor([k["loss"], k["grad_norm"]])))
          and rel(k["loss"], p["loss"]) <= tol["loss"]
          and rel(k["grad_norm"], p["grad_norm"]) <= tol["grad_norm"]
          and param_err[worst] <= tol["param"]
          and zero_grad_max / k["grad_norm"] <= tol["zero_gradient"]
          and k["launches"]["sincos_attention_fwd"] == 2 * n_blocks
          and k["launches"]["sincos_attention_fwd_dropout"] == 2 * n_blocks
          and k["launches"]["sincos_attention_bwd"] == n_blocks
          and k["launches"]["depthwise_conv_fwd"]
          == (3 * n_blocks if conv_impl == "pallas" else 0)
          and k["launches"]["depthwise_conv_dw"]
          == (n_blocks if conv_impl == "pallas" else 0))
    return {"dtype": dtype, "conv_impl": conv_impl, "seconds": seconds,
            "loss": k["loss"],
            "plain_loss": p["loss"], "grad_norm": k["grad_norm"],
            "plain_grad_norm": p["grad_norm"],
            "loss_rel_diff": rel(k["loss"], p["loss"]),
            "grad_norm_rel_diff": rel(k["grad_norm"], p["grad_norm"]),
            "max_param_rel_diff": param_err[worst],
            "worst_params": {n: param_err[n] for n in top},
            "zero_gradient_params": len(zero),
            "zero_gradient_max_over_grad_norm": zero_grad_max / k["grad_norm"],
            "tolerance": tol, "kernel_step_ms": k["ms"],
            "plain_step_ms": p["ms"], "launches": k["launches"], "ok": ok}


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
    if not (counts["sincos_attention_fwd"] and counts["logmel_fwd"]):
        raise SystemExit(f"a kernel of the serving path never launched: {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 5: train through the CLI, checkpoint, resume.
# ---------------------------------------------------------------------------

VI_WORDS = ("xin chào các bạn hôm nay trời rất đẹp chúng tôi đi học ở "
            "trường người việt nam yêu quê hương đất nước một hai ba bốn "
            "năm sáu bảy tám chín mười").split()
TRAIN_SECONDS = [7.5] * 8 + [23.5] * 8


def _transcript(rng, n_chars: int = 60) -> str:
    words = []
    while len(" ".join(words)) < n_chars:
        words.append(VI_WORDS[rng.integers(len(VI_WORDS))])
    return " ".join(words)


def _write_manifest(tmp: str, name: str, seconds, seed: int):
    """Seeded noise WAVs of the given lengths with Vietnamese transcripts,
    and a (path, text) CSV of them. -> (manifest path, WAV paths)."""
    import numpy as np
    from scipy.io import wavfile

    rng = np.random.default_rng(seed)
    manifest = os.path.join(tmp, f"{name}.csv")
    paths = []
    with open(manifest, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i, sec in enumerate(seconds):
            path = os.path.join(tmp, f"{name}{i:02d}.wav")
            wav = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
            wavfile.write(path, 16000, (wav * 32767).astype(np.int16))
            w.writerow([path, _transcript(rng)])
            paths.append(path)
    return manifest, paths


def phase_train(torch, tmp: str):
    """-> launch counts of the two driven runs."""
    from conformer_tpu_torch.cli import train
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    manifest, _ = _write_manifest(tmp, "train", TRAIN_SECONDS, seed=1)
    ck = os.path.join(tmp, "ck")
    argv = ["--train-manifest", manifest, "--checkpoint-dir", ck,
            "--device", DEVICE, "--set", "data.batch_size=8",
            "--set", "train.checkpoint_every_steps=2",
            "--set", "train.log_every_steps=1",
            "--set", "train.num_epochs=100"]
    runs, total = [], {}
    for num_steps in (4, 6):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = train.main(argv + ["--set", f"train.num_steps={num_steps}"])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        steps = trainer.step - trainer.start_step
        runs.append({"num_steps": num_steps, "start_step": trainer.start_step,
                     "end_step": trainer.step, "wall_s": wall,
                     "launches": counts,
                     "launches_per_step": {k: v / max(steps, 1)
                                           for k, v in counts.items()},
                     "checkpoints": sorted(os.listdir(ck))})
    with open(os.path.join(ck, "metrics.jsonl"), encoding="utf8") as f:
        records = [json.loads(ln) for ln in f]
    steps = [{"step": r["step"], "loss": r["train/ctc_loss"],
              "grad_norm": r["train/grad_norm"],
              "step_seconds": r["train/step_seconds"],
              "audio_seconds": r["train/audio_seconds"],
              "audio_s_per_s": r["train/audio_seconds"] / r["train/step_seconds"],
              "peak_memory_gb": r.get("train/peak_memory_gb")}
             for r in records if "train/ctc_loss" in r]
    n_blocks = 17
    ok = (runs[0]["start_step"] == 0 and runs[0]["end_step"] == 4
          and runs[1]["start_step"] == 4 and runs[1]["end_step"] == 6
          and [s_["step"] for s_ in steps] == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])
                  for s_ in steps)
          and all(r["launches_per_step"]["sincos_attention_fwd"] == 2 * n_blocks
                  and r["launches_per_step"]["sincos_attention_fwd_dropout"]
                  == 2 * n_blocks
                  and r["launches_per_step"]["sincos_attention_bwd"] == n_blocks
                  and r["launches"]["logmel_fwd"] > 0 for r in runs))
    emit({"phase": "train", "config": "Config() production (dropout 0.1 "
          "hash, SpecAugment, remat, bf16, Adam), B=8, 7.5 s and 23.5 s WAVs",
          "runs": runs, "steps": steps, "ok": ok})
    if not ok:
        raise SystemExit("train phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 6: conv_impl pallas through training with validation, the evaluate
# CLI and serving.
# ---------------------------------------------------------------------------

VAL_SECONDS = [7.5] * 3 + [23.5] * 3
PALLAS = ["--set", "model.conv_impl=pallas"]


def phase_evaluate(torch, tmp: str):
    """-> launch counts of the driven runs (training, evaluation through the
    kernels, serving)."""
    from conformer_tpu_torch.cli import infer, train
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.config import DataConfig
    from conformer_tpu_torch.data.dataset import BucketedLoader, ManifestDataset
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    train_csv, _ = _write_manifest(tmp, "train", TRAIN_SECONDS, seed=1)
    val_csv, val_paths = _write_manifest(tmp, "val", VAL_SECONDS, seed=2)
    ck = os.path.join(tmp, "ck")
    # the loader's eval batches of the validation set: (all, >= 16 s)
    batches = [b.audio.shape[1] for b in BucketedLoader(
        ManifestDataset(val_csv), load_tokenizer("vi"),
        DataConfig(batch_size=8), training=False).epoch(0)]
    n_val, n_long = len(batches), sum(s >= 16 * 16000 for s in batches)
    n_blocks = 17

    total, runs = {}, {}

    def driven(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        runs[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": launch_counts()}
        for key, n in runs[name]["launches"].items():
            total[key] = total.get(key, 0) + n
        return out

    trainer = driven("train", lambda: train.main(
        ["--train-manifest", train_csv, "--val-manifest", val_csv,
         "--checkpoint-dir", ck, "--device", DEVICE, *PALLAS,
         "--set", "data.batch_size=8", "--set", "train.num_steps=2",
         "--set", "train.val_every_steps=2", "--set", "train.log_every_steps=1",
         "--set", "train.num_epochs=100"]))
    with open(os.path.join(ck, "metrics.jsonl"), encoding="utf8") as f:
        records = [json.loads(ln) for ln in f]
    val = [r for r in records if "val/loss" in r]
    results = os.path.join(tmp, "results.csv")
    argv = ["--manifest", val_csv, "--checkpoint-dir", ck, "--device", DEVICE,
            *PALLAS, "--results", results]
    metrics = driven("test", lambda: cli_test.main(argv))
    with open(results, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    plain, plain_ms = _run(torch, lambda: cli_test.main(argv),
                           _plain_versions())
    driven("serve", lambda: infer.main(["--audio", *val_paths, "--device",
                                        DEVICE, *PALLAS, "--batch-size", "8"]))
    rel = abs(metrics["loss"] - plain["loss"]) / abs(plain["loss"])
    tol = TOL_TRAIN["bfloat16"]["loss"]
    # Training: 2 steps (K4a 3 per block per step under remat, K4b 1), and
    # validation at step 2 and again at the epoch's end, 17 K4a/K1 each.
    n_eval = 2 * n_val
    t, e, s_ = (runs[k]["launches"] for k in ("train", "test", "serve"))
    launches_ok = {
        "train": (t["depthwise_conv_fwd"] == 2 * 3 * n_blocks + n_eval * n_blocks
                  and t["depthwise_conv_dw"] == 2 * n_blocks
                  and t["sincos_attention_fwd"]
                  == 2 * 2 * n_blocks + n_eval * n_blocks
                  and t["sincos_attention_bwd"] == 2 * n_blocks
                  and t["logmel_fwd"] > 0),
        "test": (e["depthwise_conv_fwd"] == n_val * n_blocks
                 and e["sincos_attention_fwd"] == n_val * n_blocks
                 and e["depthwise_conv_dw"] == 0
                 and e["logmel_fwd"] == n_long > 0),
        "serve": (s_["depthwise_conv_fwd"] == n_blocks
                  and s_["sincos_attention_fwd"] == n_blocks)}
    ok = (trainer.step == 2 and len(val) == 2
          and all(math.isfinite(r["val/loss"]) for r in val)
          and all(math.isfinite(metrics[k]) for k in ("wer", "cer", "loss"))
          and rows[0] == ["label", "prediction"]
          and len(rows) == len(VAL_SECONDS) + 1
          and rel <= tol and all(launches_ok.values()))
    emit({"phase": "evaluate", "config": "Config() production, "
          "conv_impl pallas, B=8; train 16 WAVs (7.5 s, 23.5 s) for 2 steps, "
          "validate and evaluate 6 WAVs", "val_batches": n_val,
          "val_records": val, "metrics": metrics, "plain_metrics": plain,
          "plain_test_ms": plain_ms, "loss_rel_diff": rel,
          "loss_tolerance": tol, "results_rows": len(rows) - 1,
          "runs": runs, "launches_ok": launches_ok, "ok": ok})
    if not ok:
        raise SystemExit("evaluate phase failed")
    return total


# ---------------------------------------------------------------------------
# Optional phase: where the time of one 24 s forward goes.
# ---------------------------------------------------------------------------

def _profiled(torch, fn):
    """-> (host wall ms, device busy ms, kernel rows) of one fn() call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an aten op's row repeats the time of the kernels it
    # launched, the port's own kernels have no aten op above them, and a
    # range annotation (the optimizer's step) spans kernels already counted.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    total_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    return {"wall_ms": wall_ms, "device_busy_ms": total_us / 1e3,
            "device_idle_share": max(0.0, 1 - total_us / 1e3 / wall_ms),
            "kernel_launches": sum(e.count for e in events),
            "top": [{"name": e.key[:80],
                     "device_ms": e.self_device_time_total / 1e3,
                     "count": e.count} for e in top],
            # the convolutions' rows: PyTorch's, cuDNN's and the depthwise kernels K4
            "conv_rows": [{"name": e.key[:80],
                           "device_ms": e.self_device_time_total / 1e3,
                           "count": e.count} for e in events
                          if "conv" in e.key.lower()]}


def phase_profile(torch):
    """One bf16 forward (serving) and one bf16 train step (dropout 0.1,
    SpecAugment, remat, Adam) of Config() at B = 8, 8 s and 24 s, warm,
    with the depthwise conv through F.conv1d (conv_impl xla) and through K4
    (pallas)."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import Conformer, init_weights
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_forward, make_train_step

    dev = torch.device(DEVICE)
    out = {}
    for impl in ("xla", "pallas"):
        cfg = Config().override(**{"model.conv_impl": impl})
        model = init_weights(Conformer(cfg.model, "bfloat16"), 0).to(dev)
        forward = make_forward(cfg, model)
        train = make_train_step(cfg, model, make_optimizer(cfg.optim,
                                                           model.parameters()))
        for seconds in (8, 24):
            audio, lengths = _noise_batch(torch, 8, seconds, seed=seconds)
            tokens, token_lengths = _tokens(torch, 8, 60, seed=seconds)
            args = [x.to(dev) for x in (audio, lengths, tokens, token_lengths)]
            forward(*args[:2])
            out[f"{impl}_forward_{seconds}s"] = _profiled(
                torch, lambda: forward(*args[:2]))
            train(*args, 0)
            out[f"{impl}_train_step_{seconds}s"] = _profiled(
                torch, lambda: train(*args, 1))
        del model, forward, train
    emit({"phase": "profile", "config": "Config() bf16, B=8, conv_impl "
          "xla and pallas", **out})


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

    entries, launches = [], {}
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        entries, launches = phase_kernels(torch)
    if "tolerance" in phases:
        phase_tolerance(torch)
    if "model" in phases:
        phase_model(torch)
    for name, run in (("serve", phase_serve), ("train", phase_train),
                      ("evaluate", phase_evaluate)):
        if name in phases:
            with tempfile.TemporaryDirectory() as tmp:
                for key, n in run(torch, tmp).items():
                    launches[key] = launches.get(key, 0) + n
    for entry in entries:
        entry["launches"] = launches.get(entry["name"], 0)
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
