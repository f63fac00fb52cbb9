#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``conformer_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase
    python3 chip_smoke.py --phases build,kernels

Phases, each printing one JSON line:

1. build   -- compile every kernel source in conformer_tpu_torch/csrc/ with
              nvcc (one process per source, all at once) into build/.
2. kernels -- hold each kernel against its plain PyTorch version on the card
              at the shapes the serving and training paths give it (K1 with
              and without dropout, and bf16 K1 at the lengths
              K1_EDGE_LENGTHS and at every (B, L) the serving front
              launches (serving_shapes), K2 at rates 0 and 0.1, K3 (also at
              the serving front's shapes past 1600 frames), the depthwise
              conv K4a/K4b and its autograd Function at K 31 and 4 (K4a also
              at a stream window, B 1), K1, K3 and K4a at every shape the
              export phase's programs launch (export_shapes), K5 for
              every op), and time the kernel, the plain version, the bound
              and, where one exists, the one PyTorch call that computes the
              same function (SDPA under each backend that takes it, the
              fastest as the yardstick); bf16 K2 at L 768, 769 and
              L_LONG, and two K2 calls that must give the same bits; the
              general attention kernels at GENERAL_SHAPES in both dtypes,
              GENERAL_WIDE in bf16 and the tiny phase's shape GENERAL_TINY
              in bf16; K4a at L 2400, at K 7 and 4, and
              on inputs chosen for bf16 rounding ties and subnormals; K4b
              at K 7 and 4, at L 1, 63, 65 and 2400, at B 3, at C 520, 36
              and 100, at the widths K4B_WIDE_C (clusters of 3 CTAs or
              fewer), and two calls that must give the same bits; K3's
              reading on a loud tone over faint noise; K5's per-pass slopes
              through ``conformer_tpu_torch.tools.bench_vpu_pass.main``.
   tolerance -- K1 and K2 again over 8 more seeds: each check's largest
              reading beside its limit.
3. model   -- the production Config() model (17 blocks, d_model 512, 8
              heads, kernel 31, LSTM 640, vocab 370) with seeded random
              weights, on 8 s and 24 s batches of 8, with the depthwise conv
              through F.conv1d (conv_impl xla) and through K4 (pallas): a
              forward, and one train step (dropout 0.1, SpecAugment, remat),
              once through the kernels, once through their plain versions;
              and an fp32 forward of both conv_impls on the same weights.
   tools   -- the port's measuring tools (conformer_tpu_torch/tools/) at
              Config()'s width: ``trace_step`` on the train step (B 8 x
              24 s, conv_impl pallas, 2 traced steps), where K1-drop, K2,
              K3, K4a and K4b must each show time in its own group, and on
              the transducer train step, the wav2vec2 and BYOL steps, the
              forward with the device CTC beam (K1) and the transducer's
              device beam, each a busy share in (0, 1] and a group table;
              in every traced window each kernel group's launches equal
              the wrappers' counts times the kernels a call launches
              (expected_group_launches); ``profile_step`` at B 8 x 8 s
              (every component a wall and a device time);
              ``sweep_streaming`` over 16 s (chunk 2 s / context 6 s and
              1 s / 2 s, greedy: RTF and divergence); ``bench_audio_io``
              on the host (2 files x 10 s).
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
              and with the host beam search at the reference operating
              point and one hotword over an ARPA that ``cli.create_lm``
              builds from the train transcripts (``--lm --decode beam``);
              each batch's beam-decode seconds, and
              the native decoder held against the Python one (with the
              Python n-gram scorer) at beam 16 on the card's log-probs of
              one batch and on a contended seeded 8 x 599 batch; then the
              validation WAVs
              served through ``cli.infer``.
7. tiny     -- ``ModelConfig.tiny`` (d_model 64, 2 heads of 32) trained 2
              steps through ``cli.train`` and served through ``cli.infer``
              on the card: every attention launch on the general kernels.
8. stream   -- the production model behind ``cli.serve.make_server`` on an
              ephemeral port: 10 concurrent uploads to /transcribe (WAV and
              FLAC twins of 6, 12, 20 and 28 s, two also as 8 kHz WAVs),
              each text held against the pipeline on that signal alone,
              then the WAVs alone; two concurrent /stream sessions (l16,
              f32) on a 24 s WAV against ``cli.infer --streaming``; a
              1.8 s utterance streamed against offline; transcribers
              pipelined, synchronous and with the host beam (190, LM,
              hotword), one window profiled; ``cli.infer --streaming`` with
              the beam and with conv_impl=pallas. Latencies, RTFs and the
              window's idle share on a line of their own.
9. transducer -- configs/production_vi_transducer.json (17 blocks, d_model
              512, prediction and joint 320, vocab 370, bf16, hash dropout
              0.1, the lattice-free scan loss) at batch 8 (its 72 cut for
              time), seeded random weights: ``cli.train --device cuda`` on
              the train phase's WAVs for 4 steps with checkpoints, resumed
              to 6 (34 K1 and K1-drop and 17 K2 launches a step, K3 on the
              23.5 s batches); one train step through the kernels against
              their plain versions; ``rnnt_loss_scan`` against the lattice
              loss in fp32 (B 8 x 8 s) and both timed at 24 s;
              ``rnnt_alpha_final`` on a peaked 24 s lattice against a
              float64 DP; the checkpoint through ``cli.test`` (greedy);
              then a copy whose joint is rescaled so that the greedy decode
              mixes blanks and emissions (mixing_copy; the validation rows'
              share of emitting rounds and in-frame stops checked) through ``cli.infer`` and ``cli.infer
              --streaming`` (a one-chunk utterance against the offline
              decode of the same window); the greedy decode of a B 8 x
              24 s batch (one CUDA graph a frame) against its eager run
              bit for bit, the capturing call and a replay after an
              encoder forward, both timed, their kernel launches counted.
10. export  -- (run after pretrain; its cli.export processes start ahead:
              the CTC ones before serve, the transducer's after the
              transducer phase) the production Config() with conv_impl
              pallas, cut to EXPORT_BLOCKS blocks, through
              ``cli.export --device cuda`` at 8 and 24 s, batch 1 and 8,
              each program against the live forward (bf16 tolerance) with
              K1, K3 (24 s) and K4a counted while it runs; a tiny program
              exported on the CPU and moved to the card against the live
              model; the transducer phase's mixing checkpoint exported
              greedy at 4 s, batch 1: the live greedy tokens; the beam
              programs (``--decode beam``, W 190, the word 5-gram and
              the hotword): the CTC model's at 8 s, batch 8, against the
              live device search on the log-probs of the logits program
              of that bucket, the transducer's at 4 s, batch 8, against
              the live search on the live encoder (equal rows, or a
              near-tie under 1e-3; every row emitting, the transducer's
              on the mixing checkpoint). Every frame loop of a program
              is one while_loop: its graph nodes (counted after each
              export) do not grow with the bucket (24 s holds fewer
              extra nodes than extra frames).
              The kernels phase holds every shape these programs launch
              (export_shapes). Export seconds, load seconds, program
              bytes and nodes, program against live forward ms, a beam
              program's wall against the live search's (graph, eager).

11. beam_device -- the device beam searches at the reference's operating
              point (beam 190, 8 candidates a frame, alpha 2.1, beta 9.2,
              one hotword) with word-level fusion from an ARPA that
              ``cli.create_lm`` builds: the CTC search on a contended 8 x
              599 batch through its CUDA graph against the eager step on
              the card (bit for bit) and against the port's search on the
              CPU (in a process of its own, meanwhile: equal texts or a
              near-tie); a peaked batch against the host beam search
              (native, nothing pruned); ``cli.test --lm --decode auto``
              (beam_auto -> beam_device), a token-level
              ``decode.device_lm_path``, ``cli.infer --streaming --decode
              beam_device``, ``cli.serve --decode beam_auto`` and
              ``cli.pseudo_label --decode beam_device``; the RNN-T search
              on the transducer phase's mixing checkpoint (B 8 x 8 s, graph
              against eager bit for bit; 24 s), ``cli.test --decode beam``
              and ``cli.infer --decode beam``, offline and ``--streaming``.
              Walls, capture seconds, launches a frame, the host search's
              seconds on the contended batch.
12. pretrain -- self-supervised pretraining at the production width
              (Config(), pretrain defaults): one wav2vec2 step at B 8 x 8 s
              and one at 24 s (K3) and one BYOL step at B 8 x 8 s (16 rows
              a tower, conv_impl pallas: K4a/K4b), each warm, timed
              (median of 3) and counted through the kernels and held
              against their plain versions on the same draws (loss, grad
              norm; ``--phases profile`` profiles them);
              ``cli.pretrain`` on configs/pretrain_wav2vec2.json (batch 32
              -> 8) over the train phase's WAVs in a path-only manifest,
              4 steps with checkpoints every 2, resumed to 6; then
              ``cli.train --init-encoder-from`` for 2 steps, its encoder
              held against the checkpoint's, bit for bit, before step 1.
13. parallel -- multi-device training, decoding and pretraining
              (parallel/mesh.py) on the one card: two NCCL ranks on card
              0, which NCCL refuses (recorded); four ranks of this script
              (``--worker``) in a gloo group of CUDA tensors on a dp 2 x tp
              2 mesh of Config() cut to PARALLEL_BLOCKS blocks, conv_impl
              pallas, ZeRO-1 and SP: the fp32 agreement steps against this
              process's, then ``cli.train`` for 4 steps with checkpoints,
              resumed to 6; ``cli.test --dp 2 --tp 2 --lm --decode
              beam_device`` (fp32) against this process's metrics and
              results file; the sharded CTC search (the contended 8 x 599
              batch) and RNN-T search (the transducer's mixing checkpoint,
              B 8 x 8 s) at beam 190 with the word LM and the hotword,
              each rank's stripe against this process's, the frame steps
              eager over gloo; the wav2vec2 and BYOL steps on the mesh
              against this process's; ``cli.pretrain --dp 2 --tp 2`` for 4
              steps, resumed at dp 1 to 6, then ``cli.train
              --init-encoder-from`` it, the encoder held against the
              checkpoint's; the mesh's checkpoint resumed at dp 1 and
              scored by ``cli.test``; K1, K1-drop, K2, K4a and K4b at a
              rank's shapes against their plain versions, timed; one mesh
              step over a world-1 NCCL group against the meshless step, bit
              for bit, and the CTC search with its LM probe sum over that
              group captured in the frame graph, bit for bit. Each rank's
              step wall, peak memory and search walls (four ranks on one
              card: correctness, not scaling).

Then each phase's wall seconds (``phase_seconds``), the card's name and
power limit, the ``kernels`` line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without the
ok line; so does a machine with no CUDA device.
"""

from __future__ import annotations

import argparse
import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

PHASES = ("build", "kernels", "tolerance", "model", "tools", "serve", "train",
          "evaluate", "tiny", "stream", "transducer", "beam_device",
          "pretrain", "export", "parallel")
OPTIONAL_PHASES = ("profile",)
# Published dense peaks of one H100 SXM (NVIDIA data sheet) at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_TF32 = 495e12
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
# bf16 K1 at lengths that cross its 128-row query tiles and 64-key tiles.
K1_EDGE_LENGTHS = (1, 63, 65, 127, 129, 257, 768)
# bf16 K2 past the earlier design's limit of 768: ~48 s of audio.
L_LONG = 1200
# SDPA backends timed as the attention kernels' yardstick (flash attention
# takes no head width of 576 and no mask); each that accepts the call is
# timed, and the fastest is library_ms.
SDPA_BACKENDS = ("EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")
TOL_K3 = 1e-4
# K4a rounds after every product and add exactly as its plain version does:
# it must be equal; the reading is the largest difference in units in the
# last place of the dtype, and one is the most PERF.md may explain.
TOL_K4A_ULPS = 1
# K4b against its plain version, which sums in float64 (the exact sum,
# rounded once to fp32): max |diff| over max |dw|; rounded to bf16, one
# bf16 ulp per element.
TOL_K4B = 1e-5
TOL_K4B_BF16_ULPS = 1
# K4b's window kernel at these (B, L) past the timed B 8, L 199 and 599.
K4B_EDGES = ((8, 1), (8, 63), (8, 65), (8, 2400), (3, 599))
# K4b's window kernel at widths past d_model 512, where fewer CTAs a
# cluster fit on the card in one wave: a cluster of 3 or fewer gives each
# CTA more of the final sum than it has threads.
K4B_WIDE_C = (1024, 1184, 1536, 2400)
# The autograd Function against autograd through the plain per-tap loop,
# per gradient, max |diff| over max |grad|: fp32 sums in another order;
# bf16 also rounds each sum in another order (31 rounded adds).
TOL_K4_GRAD = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_K5 = 1e-5
DEVICE = "cuda"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_name_and_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls
    queued behind a spin kernel (``tools.timing.device_ms``), so that a
    wrapper's host time does not stand in for its kernel's."""
    from conformer_tpu_torch.tools.timing import device_ms

    return device_ms(fn, iters, warmup)


def sdpa_times(torch, setup, iters: int = 20):
    """-> ({backend: ms}, fastest backend) of the call that ``setup()``
    returns, set up and timed under each of SDPA_BACKENDS that accepts it."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel(getattr(SDPBackend, name)), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")   # why the others refuse
                times[name.lower()] = cuda_ms(torch, setup(), iters=iters)
        except RuntimeError:       # the backend refuses these operands
            continue
    return times, min(times, key=times.get)


def bound_ms(flops: float, nbytes: float, dtype: str) -> "tuple[float, str]":
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def attention_bounds(flops: float, nbytes: float, dtype: str) -> dict:
    """K1's or K2's bound: bf16 on the bf16 tensor-core rate; fp32 the
    lesser of 3xTF32 (three TF32 products per fp32 one, as the general
    kernels take them) and the fp32 FMA rate, that one reported beside."""
    bms, by = bound_ms(flops, nbytes, dtype)
    if dtype == "bfloat16":
        return {"bound_ms": bms, "bound_by": by, "bound_ops": "bf16"}
    ops_ms = 3 * flops / PEAK_TF32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    tf32_ms = max(ops_ms, bytes_ms)
    return {"bound_ms": min(tf32_ms, bms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops": "3xTF32" if tf32_ms <= bms else "fp32 FMA",
            "bound_fp32_fma_ms": bms}


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

def _attention_inputs(torch, b: int, l: int, dtype, seed: int, h: int = 8,
                      dh: int = 64, dp: int = 0):
    """Packed attention operands (production width H = 8, dh = 64, D = 512
    by default; ``dp``: the position width, D unless a mesh gives the call
    a rank's heads), scale folded into qu/qv, key lengths full, partial and
    0."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    d = h * dh
    dp = dp or d
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen)
    dev = torch.device(DEVICE)
    qu, qv, k, v = (mk(b, l, d).to(dev, dtype) for _ in range(4))
    wh = sa.prep_pos_kernel((mk(dp, d) / math.sqrt(dp)).to(dev, dtype), h)
    lens = [l, l - 1, l // 2, 1, 0, l, 3 * l // 4, 7][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    s = torch.tensor(1.0 / math.sqrt(dh), dtype=dtype, device=dev)
    sin_t, cos_t = sa.sincos_tables(l, dp, dtype, dev)
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
    d2 = wh.shape[2] // 2
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


def _sub_frames(cfg, n: int) -> int:
    """Samples -> subsampled frames (decode/streaming.py::_sub_frames)."""
    return ((n // cfg.hop_length) // 2 - 1) // 2


def serving_shapes():
    """-> (K1's (B, L), K3's (B, samples), a stream window's L): every
    shape ``cli.serve`` with its defaults (as the stream phase runs it)
    gives the two kernels: each batch rung at each bucket and a stream
    window (context plus chunk) at B 1, K3 where the frontend takes it
    (MelFrontend.impl_for)."""
    from conformer_tpu_torch.audio.mel import MelFrontend
    from conformer_tpu_torch.cli import serve
    from conformer_tpu_torch.config import AudioConfig

    args = serve.parse_args([])
    cfg = AudioConfig()
    fe = MelFrontend(cfg)
    sub = lambda n: _sub_frames(cfg, n)
    stride = 4 * cfg.hop_length
    window = sum(int(sec * cfg.sample_rate) // stride * stride
                 for sec in (args.stream_context_seconds,
                             args.stream_chunk_seconds))
    shapes = [(b, int(sec * cfg.sample_rate))
              for b in serve.batch_rungs(args.max_batch)
              for sec in args.buckets]
    if (1, window) not in shapes:
        shapes.append((1, window))
    k1 = sorted({(b, sub(n)) for b, n in shapes})
    k3 = [(b, n) for b, n in shapes if fe.impl_for(n) == "pallas"]
    return k1, k3, sub(window)


def export_shapes():
    """-> (K1's (B, L), K4a's (B, L), K3's (B, samples), each with the
    (h, dh) or (c, k) and dtype name of its model): every shape the
    export phase's programs give the kernels, each program padded to its
    bucket: the production CTC model (conv_impl pallas) at each of
    EXPORT_BATCHES x EXPORT_SECONDS and its beam program at
    CTC_BEAM_EXPORT, the transducer (conv_impl xla) at TRANSDUCER_EXPORT
    (greedy) and RNNT_BEAM_EXPORT (beam) and the tiny program moved from
    the CPU at
    TINY_EXPORT; K3 where the frontend takes it (MelFrontend.impl_for)."""
    from conformer_tpu_torch.audio.mel import MelFrontend

    ctc, tiny = _export_cfg(), _tiny_export_cfg()
    t_b, t_s = TRANSDUCER_EXPORT
    tiny_b, tiny_s = TINY_EXPORT
    programs = ([(ctc, b, s) for b in EXPORT_BATCHES for s in EXPORT_SECONDS]
                + [(ctc, *CTC_BEAM_EXPORT), (_transducer_cfg(), t_b, t_s),
                   (_transducer_cfg(), *RNNT_BEAM_EXPORT),
                   (tiny, tiny_b, tiny_s)])
    k1, k4a, k3 = set(), set(), set()
    for cfg, b, seconds in programs:
        m, audio = cfg.model, cfg.audio
        n = int(seconds * audio.sample_rate)
        l, dt = _sub_frames(audio, n), cfg.optim.compute_dtype
        k1.add((b, l, m.n_heads, m.d_model // m.n_heads, dt))
        if m.conv_impl == "pallas":
            k4a.add((b, l, m.d_model, m.kernel_size, dt))
        if MelFrontend(audio).impl_for(n) == "pallas":
            k3.add((b, n))
    return sorted(k1), sorted(k4a), sorted(k3)


def k1_case(torch, b: int, l: int, dtype, seed: int, time_it: bool,
            rate: float = 0.0, h: int = 8, dh: int = 64, dp: int = 0):
    """K1 at (b, l, h, dh), production width by default (``dp``: the
    position width, as _attention_inputs); output and row statistics, and
    the kernel the selector picked (its launch counted in that kernel's
    counter)."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    d = h * dh
    dp = dp or d
    args, _ = _attention_inputs(torch, b, l, dtype, seed, h, dh, dp)
    drop = (rate, DROPOUT_SEED, sa.hash_tq(l))
    variant = sa.attention_variant(dtype, h, dh, d, dp)
    general_before = sa.sincos_attention_fwd.general_launches
    got, got_st = sa.sincos_attention_fwd(*args, *drop, stats=True)
    general = sa.sincos_attention_fwd.general_launches - general_before
    want, want_st = sa.sincos_attention_plain(*args, *drop, stats=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    # the row max is exact; the row sum is summed online, tile by tile
    st_err = float(((got_st - want_st).abs() / want_st.abs().clamp(min=1.0))
                   .max())
    finite = bool(torch.isfinite(got.float()).all())
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    case = {"b": b, "l": l, "h": h, "dh": dh, "dp": dp, "dtype": name,
            "rate": rate, "variant": variant, "max_abs_err": err,
            "tolerance": TOL_K1[name], "stats_rel_err": st_err,
            "stats_tolerance": TOL_STATS[name], "finite": finite,
            "ok": (finite and err <= TOL_K1[name] and st_err <= TOL_STATS[name]
                   and general == (variant == "general"))}
    if time_it:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        flops = (2.0 * b * h * l * l * (dh + dp + dh)
                 + 2.0 * b * h * l * dh * dp)
        nbytes = (5 * b * l * d + h * dh * dp + l * dp) * itemsize + 4 * b
        bounds = attention_bounds(flops, nbytes, name)
        q_aug, k_aug, v_h, mask = _augmented(torch, args)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q_aug, k_aug, v_h, attn_mask=mask, scale=1.0,
            dropout_p=rate)
        backends, best = sdpa_times(torch, lambda: sdpa)
        case.update({
            "ms": cuda_ms(torch, lambda: sa.sincos_attention_fwd(*args, *drop)),
            "plain_ms": cuda_ms(torch,
                                lambda: sa.sincos_attention_plain(*args, *drop)),
            "library_ms": backends[best], "library_backend": best,
            "library_backends_ms": backends, **bounds,
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
            time_it: bool, h: int = 8, dh: int = 64, dp: int = 0):
    """K2 at (b, l, h, dh) against its plain version, each gradient held per
    slice (k2_rel_err), and two controls that must exceed the limit: the
    kernel's gradients with slice (batch row 0, a full row; head 0) scaled
    by 1 + 2 * limit, and, with dropout, the plain backward under another
    seed."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    d = h * dh
    dp = dp or d
    args, dout = _attention_inputs(torch, b, l, dtype, seed, h, dh, dp)
    drop = (rate, DROPOUT_SEED, sa.hash_tq(l))
    variant = sa.attention_variant(dtype, h, dh, d, dp)
    out, stats = sa.sincos_attention_fwd(*args, *drop, stats=True)
    bwd_args = (*args, stats, dout, *drop)
    general_before = sa.sincos_attention_bwd.general_launches
    got = sa.sincos_attention_bwd(*bwd_args)
    general = sa.sincos_attention_bwd.general_launches - general_before
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
    case = {"b": b, "l": l, "h": h, "dh": dh, "dp": dp, "dtype": name,
            "rate": rate, "variant": variant, "max_abs_err": err,
            "rel_err": rel,
            "max_rel_err": max(rel.values()), "tolerance": tol,
            "controls": controls, "finite": finite,
            "ok": (finite and max(rel.values()) <= tol
                   and min(controls.values()) > tol
                   and general == (variant == "general"))}
    if time_it:
        itemsize = torch.tensor([], dtype=dtype).element_size()
        flops = (2.0 * b * h * l * l * (2 * dp + 5 * dh)
                 + 3 * 2.0 * b * h * l * dh * dp)
        nbytes = ((9 * b * l * d + 2 * h * dh * dp + l * dp) * itemsize
                  + 8 * b * h * l + 4 * b)
        bounds = attention_bounds(flops, nbytes, name)
        q_aug, k_aug, v_h, mask = _augmented(torch, args)
        q_aug.requires_grad_(True)
        k_aug.requires_grad_(True)
        v_h.requires_grad_(True)
        g_out = dout.reshape(b, l, h, dh).transpose(1, 2).contiguous()

        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q_aug, k_aug, v_h, attn_mask=mask, scale=1.0, dropout_p=rate)

        def sdpa_fwd_bwd():
            sdpa().backward(g_out)

        def sdpa_bwd():
            # the forward runs under the backend being timed, which then
            # serves its backward
            out_aug = sdpa()
            return lambda: torch.autograd.grad(
                out_aug, (q_aug, k_aug, v_h), g_out, retain_graph=True)

        backends, best = sdpa_times(torch, sdpa_bwd)
        both, best_both = sdpa_times(torch, lambda: sdpa_fwd_bwd)
        case.update({
            "ms": cuda_ms(torch, lambda: sa.sincos_attention_bwd(*bwd_args)),
            "plain_ms": cuda_ms(torch, lambda: sa.sincos_attention_bwd_plain(
                *bwd_args), iters=5),
            "library_ms": backends[best], "library_backend": best,
            "library_backends_ms": backends,
            "library_call": "SDPA backward alone on [qu|alpha|beta], "
                            "[k|cos|sin], v",
            "library_fwd_bwd_ms": both[best_both],
            "library_fwd_bwd_backends_ms": both, **bounds,
            "scratch_bytes": sa.bwd_scratch_bytes(b, l, h, dh, dtype, dp),
        })
    return case


def k2_long_lengths(torch):
    """bf16 K2 has no length limit: it agrees with its plain version per
    slice at L 768 and 769 (where the earlier design's shared-memory limit
    fell) and at L_LONG, ~48 s of audio, with one row ragged."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    cases = [k2_case(torch, 1, 768, torch.bfloat16, seed=40, rate=0.1,
                     time_it=False),
             k2_case(torch, 1, 769, torch.bfloat16, seed=41, rate=0.1,
                     time_it=False),
             k2_case(torch, 2, L_LONG, torch.bfloat16, seed=42, rate=0.1,
                     time_it=False)]
    return {"cases": cases, "scratch_bytes_l%d_b2" % L_LONG:
            sa.bwd_scratch_bytes(2, L_LONG, 8, 64, torch.bfloat16),
            "ok": all(c["ok"] for c in cases)}


# The general attention kernels' check shapes, (H, dh): ModelConfig.tiny,
# head widths other than 64, odd head counts, D/2 not a multiple of 64, and
# Conformer-S (Gulati et al. 2020: d_model 144, 4 heads), whose head width
# (36), D/2 (72) and head offsets are not multiples of 16 bytes in bf16; in
# fp32 and bf16. bf16 also at (12, 64), D 768, past the wgmma kernels' 512.
GENERAL_SHAPES = ((2, 32), (3, 16), (4, 32), (3, 64), (4, 36))
GENERAL_WIDE = (12, 64)
# Two lengths: a ragged 64-row tile and three 64-key tiles with a ragged
# last one; batch rows of full, length - 1 and half length.
GENERAL_LENGTHS = (77, 199)
# The shape the tiny phase gives them: its 23.5 s batch, ModelConfig.tiny's
# width in bf16, B 8 with ragged rows.
GENERAL_TINY = (8, 599, 2, 32)


def general_attention_cases(torch):
    """K1 and K2 through their general kernels at every GENERAL_SHAPES shape
    (fp32, bf16) and GENERAL_WIDE (bf16), rates 0 and 0.1, B 3, and at
    GENERAL_TINY in bf16, against the plain versions with the limits of the
    production cases; the bf16 cases at L 199 and GENERAL_TINY's at rate
    0.1 are timed (kernel, plain, bound, SDPA); each shape's tiling checked
    against the host's copy. -> (K1 cases, K2 cases, geometry checks)."""
    shapes = [(h, dh, dt) for h, dh in GENERAL_SHAPES
              for dt in (torch.float32, torch.bfloat16)]
    shapes.append((*GENERAL_WIDE, torch.bfloat16))
    runs = [(3, l, h, dh, dt, rate, dt == torch.bfloat16 and l == 199
             and rate == 0.1, 300 + 10 * i + l % 7 + int(rate * 10))
            for i, (h, dh, dt) in enumerate(shapes)
            for l in GENERAL_LENGTHS for rate in (0.0, 0.1)]
    b, l, h, dh = GENERAL_TINY
    runs += [(b, l, h, dh, torch.bfloat16, rate, rate > 0, 400 + i)
             for i, rate in enumerate((0.0, 0.1))]
    k1, k2, geometry = [], [], []
    for b, l, h, dh, dt, rate, time_it, seed in runs:
        k1.append(k1_case(torch, b, l, dt, seed, time_it, rate, h, dh))
        k2.append(k2_case(torch, b, l, dt, seed, rate, time_it, h, dh))
        if rate == 0.0:
            geometry.append(geometry_case(torch, b, l, h, dh, dt))
    return k1, k2, geometry


def geometry_case(torch, b: int, l: int, h: int, dh: int, dtype):
    """The host's copy of the general kernels' tiling and scratch
    (``general_geometry``, tested on the CPU) against the built libraries'
    own."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    host = sa.general_geometry(dtype, b, l, h, dh)
    lib = sa.library_geometry(dtype, b, l, h, dh)
    return {"b": b, "l": l, "h": h, "dh": dh,
            "dtype": _dtype_name(torch, dtype), "library": lib,
            "ok": all(host[k] == v for k, v in lib.items())}


def same_bits(torch, first, second) -> bool:
    """True when two tuples of tensors hold the same bits, NaNs included."""
    return len(first) == len(second) and all(
        a.shape == b.shape and a.dtype == b.dtype
        and torch.equal(a.contiguous().view(torch.uint8),
                        b.contiguous().view(torch.uint8))
        for a, b in zip(first, second))


def k2_determinism(torch):
    """Two K2 calls on the same inputs (B 8, L 599, rate 0.1) give the same
    bits in all five gradients, bf16 and fp32: no atomics, fixed sum
    orders."""
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    runs = {}
    for dtype in (torch.bfloat16, torch.float32):
        args, dout = _attention_inputs(torch, 8, 599, dtype, seed=43)
        drop = (0.1, DROPOUT_SEED, sa.hash_tq(599))
        _, stats = sa.sincos_attention_fwd(*args, *drop, stats=True)
        first = sa.sincos_attention_bwd(*args, stats, dout, *drop)
        second = sa.sincos_attention_bwd(*args, stats, dout, *drop)
        torch.cuda.synchronize()
        runs[_dtype_name(torch, dtype)] = same_bits(torch, first, second)
    return {"same_bits": runs, "ok": all(runs.values())}


def k3_case(torch, b: int, n_samples: int, seed: int, time_it: bool):
    """K3 on b rows of n_samples (past one row, one silent and one quiet)."""
    from conformer_tpu_torch.audio.mel import MelFrontend, reflect_pad
    from conformer_tpu_torch.config import AudioConfig
    from conformer_tpu_torch.ops.cuda import mel_frontend as mf

    cfg = AudioConfig()
    dev = torch.device(DEVICE)
    fe = MelFrontend(cfg, device=dev)
    gen = torch.Generator().manual_seed(seed)
    audio = torch.randn(b, n_samples, generator=gen) * 0.1
    if b > 1:            # one silent row and one quiet row
        audio[0] = 0.0
        audio[1] *= 1e-3
    audio = audio.to(dev)
    padded = reflect_pad(audio, cfg.n_fft // 2).contiguous()
    n_frames = n_samples // cfg.hop_length + 1
    args = (padded, fe._dft, fe._fb, cfg.hop_length, cfg.n_fft, n_frames,
            cfg.log_clamp_min)
    got = mf.logmel_fwd(*args, operands=fe._k3)
    want = mf.logmel_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    case = {"b": b, "n_frames": n_frames, "frames_in_last_tile": n_frames % 128,
            "max_abs_err": err, "tolerance": TOL_K3, "finite": finite,
            "ok": finite and err <= TOL_K3}
    if time_it:
        n_bins, n_mels = fe._fb.shape
        flops = 2.0 * b * n_frames * (cfg.n_fft * 2 * n_bins + n_bins * n_mels)
        nbytes = 4.0 * (padded.numel() + fe._dft.numel() + fe._fb.numel()
                        + b * n_frames * n_mels)
        fma_ms, _ = bound_ms(flops, nbytes, "float32")
        # fp32 accuracy at the least cost: three TF32 products per fp32 one
        # on the tensor cores, as the kernel does it
        ops_ms = 3 * flops / PEAK_TF32 * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        tf32_ms = max(ops_ms, bytes_ms)
        by = "operations" if ops_ms >= bytes_ms else "bytes"
        case.update({
            "ms": cuda_ms(torch, lambda: mf.logmel_fwd(*args,
                                                       operands=fe._k3)),
            "plain_ms": cuda_ms(torch, lambda: mf.logmel_plain(*args)),
            # No single PyTorch call computes frame+DFT+mel+log.
            "library_ms": None,
            "bound_ms": min(tf32_ms, fma_ms), "bound_by": by,
            "bound_ops": "3xTF32" if tf32_ms <= fma_ms else "fp32 FMA",
            "bound_fp32_fma_ms": fma_ms,
        })
    return case


def k3_tone_reading(torch):
    """K3 on a loud tone over faint noise (bins ~80 dB apart in a frame),
    B 2, 24 s: the largest |kernel - plain| of the log-mels, reported beside
    TOL_K3 and not gated (both sum in fp32, in other orders)."""
    from conformer_tpu_torch.audio.mel import MelFrontend, reflect_pad
    from conformer_tpu_torch.config import AudioConfig
    from conformer_tpu_torch.ops.cuda import mel_frontend as mf

    cfg = AudioConfig()
    fe = MelFrontend(cfg, device=DEVICE)
    n = 24 * 16000
    gen = torch.Generator().manual_seed(13)
    tone = 0.5 * torch.sin(torch.arange(n) * (2 * math.pi * 440.0 / 16000))
    audio = torch.stack([tone + 1e-4 * torch.randn(n, generator=gen),
                         tone]).to(DEVICE)
    padded = reflect_pad(audio, cfg.n_fft // 2).contiguous()
    args = (padded, fe._dft, fe._fb, cfg.hop_length, cfg.n_fft,
            n // cfg.hop_length + 1, cfg.log_clamp_min)
    diff = (mf.logmel_fwd(*args, operands=fe._k3)
            - mf.logmel_plain(*args)).abs()
    return {"max_abs_err": float(diff.max()),
            "p99_abs_err": float(diff.flatten().kthvalue(
                int(0.99 * diff.numel())).values),
            "tolerance_of_the_gated_cases": TOL_K3}


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


# Values that put K4a's bf16 products and sums on rounding ties and into
# bf16's subnormals (2^-133 .. 2^-126): x * w lands on half-ulps (1 + 2^-8
# after an add of 2^-8 to 1), on exact subnormals (2^-130 * 0.5) and below
# the smallest one (2^-133 * 0.5 = 2^-134, a tie between 0 and 2^-133).
TIE_X = (0.0, 1.0, 1.5, 1.0 + 2 ** -7, 2 ** -4, 3 * 2 ** -9, 2 ** -8,
         2 ** -126, 2 ** -130, 2 ** -133, 3 * 2 ** -133, 2 ** 100)
TIE_W = (1.0, 0.5, 0.75, 2 ** -4, 1.0 + 2 ** -7, 2 ** -7, 3.0, 2 ** -100)


def _tie_inputs(torch, b: int, l: int, c: int, k: int, seed: int):
    """bf16 x, w, bias drawn from TIE_X, TIE_W, TIE_X with random signs."""
    gen = torch.Generator().manual_seed(seed)

    def draw(pool, *shape):
        vals = torch.tensor(pool, dtype=torch.float32)
        pick = vals[torch.randint(len(pool), shape, generator=gen)]
        sign = torch.randint(2, shape, generator=gen) * 2 - 1
        return (pick * sign).to(DEVICE, torch.bfloat16)

    return draw(TIE_X, b, l, c), draw(TIE_W, k, c), draw(TIE_X, c)


def k4a_case(torch, b: int, l: int, dtype, seed: int, time_it: bool,
             c: int = 512, k: int = 31, ties: bool = False):
    """K4a at (b, l, c), k taps, same pad, against its plain version: bf16
    bit for bit (the same bits, signed zeros included), fp32 within
    TOL_K4A_ULPS; ``ties``: bf16 inputs from _tie_inputs."""
    import torch.nn.functional as F

    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc

    if ties:
        x, w, bias = _tie_inputs(torch, b, l, c, k, seed)
    else:
        x, w, bias, _ = _conv_inputs(torch, b, l, c, k, dtype, seed)
    pad = (k - 1) // 2
    variant = dc.conv_variant(dtype, k, c)
    before = dc.depthwise_conv_fwd.launches
    window_before = dc.depthwise_conv_fwd.window_launches
    got = dc.depthwise_conv_fwd(x, w, bias, pad)
    launched = dc.depthwise_conv_fwd.launches - before
    window = dc.depthwise_conv_fwd.window_launches - window_before
    want = dc.depthwise_conv_plain(x, w, bias, pad)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got.float()).all())
    ulp = ulps(torch, got, want)
    bits = same_bits(torch, (got,), (want,))
    name = _dtype_name(torch, dtype)
    case = {"b": b, "l": l, "c": c, "k": k, "dtype": name, "ties": ties,
            "variant": variant, "equal": bool(torch.equal(got, want)),
            "same_bits": bits,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "max_ulps": ulp, "tolerance_ulps": TOL_K4A_ULPS,
            "launched": launched, "finite": finite,
            "ok": (finite and launched == 1
                   and window == (variant == "window")
                   and (bits if name == "bfloat16" else ulp <= TOL_K4A_ULPS))}
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
    rounded to bf16 within one bf16 ulp per element; the kernel launched
    must be the one ``conv_variant`` names, the window kernel with no
    scratch. A window case records the CTAs a cluster (``window_splits``)."""
    import ctypes

    from conformer_tpu_torch.ops.cuda import build
    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc

    x, _, _, g = _conv_inputs(torch, b, l, c, k, dtype, seed)
    pad = (k - 1) // 2
    variant = dc.conv_variant(dtype, k, c)
    before = dc.depthwise_conv_dw.launches
    window_before = dc.depthwise_conv_dw.window_launches
    got = dc.depthwise_conv_dw(x, g, k, pad)
    launched = dc.depthwise_conv_dw.launches - before
    window = dc.depthwise_conv_dw.window_launches - window_before
    want = dc.depthwise_conv_dw_plain(x, g, k, pad)
    torch.cuda.synchronize()
    rel = float((got - want).abs().max() / want.abs().max())
    bf16_ulps = ulps(torch, got.to(torch.bfloat16), want.to(torch.bfloat16))
    finite = bool(torch.isfinite(got).all())
    size = build.load("depthwise_conv").depthwise_conv_dw_scratch_bytes
    size.restype = ctypes.c_longlong
    size.argtypes = [ctypes.c_int] * 5
    scratch = int(size(b, l, c, k, dc.CONV_VARIANTS.index(variant)))
    case = {"b": b, "l": l, "c": c, "k": k, "dtype": _dtype_name(torch, dtype),
            "variant": variant, "launched": launched,
            "scratch_bytes": scratch,
            "max_abs_err": float((got - want).abs().max()), "rel_err": rel,
            "tolerance": TOL_K4B, "bf16_max_ulps": bf16_ulps,
            "bf16_tolerance_ulps": TOL_K4B_BF16_ULPS, "finite": finite,
            "ok": (finite and got.dtype == torch.float32 and rel <= TOL_K4B
                   and bf16_ulps <= TOL_K4B_BF16_ULPS and launched == 1
                   and window == (variant == "window")
                   and (scratch == 0) == (variant == "window"))}
    if variant == "window":
        splits = build.load("depthwise_conv").depthwise_conv_dw_window_splits
        splits.argtypes, splits.restype = [ctypes.c_int] * 2, ctypes.c_int
        case["window_splits"] = splits(c, 1 if dtype == torch.bfloat16 else 0)
        case["ok"] = case["ok"] and 1 <= case["window_splits"] <= 8
    if time_it:
        # the kernel runs on fp32 FMAs whatever its input dtype
        flops = 2.0 * b * l * c * k
        nbytes = 2 * b * l * c * x.element_size() + 4 * k * c
        bms, by = bound_ms(flops, nbytes, "float32")
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
            "bound_ms": bms, "bound_by": by,
            "bound_fp32_fma_ms": flops / PEAK_FLOPS["float32"] * 1e3,
            "bound_bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3})
    return case


def k4b_checks(torch):
    """K4b past the timed cases: the runtime-K kernel at K 7 and 4; the
    window kernel at the edge lengths 1, 63, 65 and 2400, at B 3 (its
    eighths of the frames cross batch rows), at channel counts that are no
    multiple of its 32-channel slice (and one no multiple of 8, which the
    runtime-K kernel takes); and two calls giving the same bits. And the
    window kernel at K4B_WIDE_C in both dtypes, with the CTAs a cluster each
    gets, of which at least one must be 3 or fewer."""
    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc

    bf16, fp32 = torch.bfloat16, torch.float32
    cases = [k4b_case(torch, 8, 599, dt, seed=61 + k, time_it=False, k=k)
             for k in (7, 4) for dt in (fp32, bf16)]
    cases += [k4b_case(torch, b, l, dt, seed=63 + i, time_it=False)
              for i, (b, l) in enumerate(K4B_EDGES) for dt in (fp32, bf16)]
    cases += [k4b_case(torch, 8, 599, dt, seed=67, time_it=False, c=c)
              for c, dt in ((520, bf16), (36, fp32), (100, bf16))]
    runs = []
    for dt in (fp32, bf16):
        x, _, _, g = _conv_inputs(torch, 8, 599, 512, 31, dt, seed=68)
        first = dc.depthwise_conv_dw(x, g, 31, 15)
        second = dc.depthwise_conv_dw(x, g, 31, 15)
        torch.cuda.synchronize()
        runs.append({"dtype": _dtype_name(torch, dt),
                     "same_bits": same_bits(torch, (first,), (second,))})
    wide = [k4b_case(torch, 8, 599, dt, seed=69, time_it=False, c=c)
            for c in K4B_WIDE_C for dt in (fp32, bf16)]
    splits = {f"C={w['c']} {w['dtype']}": w.get("window_splits")
              for w in wide}
    print("K4b window kernel, CTAs a cluster by width: " + json.dumps(splits),
          flush=True)
    wide_ok = (all(w["ok"] and w["variant"] == "window" for w in wide)
               and min(splits.values()) <= 3)
    return (cases, {"runs": runs, "ok": all(r["same_bits"] for r in runs)},
            {"cases": wide, "splits": splits, "ok": wide_ok})


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
    # bf16 timed at both lengths, fp32 (the general kernels at production
    # width) at L 599
    timed = lambda l, dt: dt == torch.bfloat16 or l == 599
    k1_cases = [k1_case(torch, 8, l, dt, seed=i, time_it=timed(l, dt))
                for i, (l, dt) in enumerate(shapes)]
    k1_drop = [k1_case(torch, 8, l, dt, seed=20 + i, rate=0.1,
                       time_it=timed(l, dt))
               for i, (l, dt) in enumerate(shapes)]
    k1_edges = [k1_case(torch, 8, l, torch.bfloat16, seed=80 + i, rate=rate,
                        time_it=False)
                for i, l in enumerate(K1_EDGE_LENGTHS) for rate in (0.0, 0.1)]
    # every (B, L) and K3 (B, samples) the serving front launches
    k1_shapes, k3_shapes, window_l = serving_shapes()
    k1_serving = [k1_case(torch, b, l, torch.bfloat16, seed=90 + i,
                          time_it=False)
                  for i, (b, l) in enumerate(k1_shapes)]
    k2_cases = [k2_case(torch, 8, l, dt, seed=30 + i, rate=rate,
                        time_it=timed(l, dt))
                for i, (l, dt) in enumerate(shapes) for rate in (0.0, 0.1)]
    long_k2 = k2_long_lengths(torch)
    deterministic = k2_determinism(torch)
    k1_general, k2_general, geometry = general_attention_cases(torch)
    k3_cases = [k3_case(torch, 8, 16 * 16000, seed=10, time_it=True),
                k3_case(torch, 8, 24 * 16000, seed=11, time_it=True),
                k3_case(torch, 3, 7321 * 17, seed=12, time_it=False)]
    k3_serving = [k3_case(torch, b, n, seed=130 + i, time_it=False)
                  for i, (b, n) in enumerate(k3_shapes)]
    k3_tone = k3_tone_reading(torch)
    # every (B, L) and K3 (B, samples) the export phase's programs launch
    e_k1, e_k4a, e_k3 = export_shapes()
    dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    k1_export = [k1_case(torch, b, l, dtypes[dt], seed=140 + i,
                         time_it=False, h=h, dh=dh)
                 for i, (b, l, h, dh, dt) in enumerate(e_k1)]
    k4a_export = [k4a_case(torch, b, l, dtypes[dt], seed=150 + i,
                           time_it=False, c=c, k=k)
                  for i, (b, l, c, k, dt) in enumerate(e_k4a)]
    k3_export = [k3_case(torch, b, n, seed=160 + i, time_it=False)
                 for i, (b, n) in enumerate(e_k3)]
    conv_shapes = [(l, dt) for dt in (torch.float32, torch.bfloat16)
                   for l in (199, 599)]
    k4a_cases = [k4a_case(torch, 8, l, dt, seed=50 + i, time_it=True)
                 for i, (l, dt) in enumerate(conv_shapes)]
    # past the JAX kernel's 12 MB VMEM budget, where it falls back to XLA
    k4a_long = k4a_case(torch, 8, 2400, torch.float32, seed=55, time_it=False)
    # the runtime-K kernel (K 7 in ModelConfig.tiny, 4 in the dx check) and
    # rounding ties and subnormals through the window kernel, bit for bit
    k4a_other = [k4a_case(torch, 8, 599, torch.bfloat16, seed=56 + k,
                          time_it=False, k=k) for k in (7, 4)]
    k4a_ties = [k4a_case(torch, 8, l, torch.bfloat16, seed=58 + k,
                         time_it=False, k=k, ties=True)
                for l, k in ((599, 31), (199, 7))]
    # a stream window (B 1) with conv_impl=pallas
    k4a_stream = k4a_case(torch, 1, window_l, torch.bfloat16, seed=54,
                          time_it=False)
    k4b_cases = [k4b_case(torch, 8, l, dt, seed=60 + i, time_it=True)
                 for i, (l, dt) in enumerate(conv_shapes)]
    k4b_other, k4b_same, k4b_wide = k4b_checks(torch)
    k4_grads = [k4_grad_case(torch, k, dt, seed=70 + k)
                for k in (31, 4) for dt in (torch.float32, torch.bfloat16)]
    k5, k5_entry, k5_launches = k5_checks(torch)
    emit({"phase": "kernels", "sincos_attention_fwd": k1_cases,
          "sincos_attention_fwd_dropout": k1_drop,
          "sincos_attention_fwd_edges": k1_edges,
          "sincos_attention_fwd_serving": k1_serving,
          "sincos_attention_fwd_export": k1_export,
          "sincos_attention_bwd": k2_cases,
          "sincos_attention_bwd_long": long_k2,
          "sincos_attention_bwd_determinism": deterministic,
          "sincos_attention_fwd_general": k1_general,
          "sincos_attention_bwd_general": k2_general,
          "general_geometry": geometry,
          "logmel_fwd": k3_cases, "logmel_fwd_tone": k3_tone,
          "logmel_fwd_serving": k3_serving, "logmel_fwd_export": k3_export,
          "depthwise_conv_fwd": k4a_cases,
          "depthwise_conv_fwd_l2400": k4a_long,
          "depthwise_conv_fwd_other_k": k4a_other,
          "depthwise_conv_fwd_ties": k4a_ties,
          "depthwise_conv_fwd_stream": k4a_stream,
          "depthwise_conv_fwd_export": k4a_export,
          "depthwise_conv_dw": k4b_cases, "depthwise_conv_dw_other": k4b_other,
          "depthwise_conv_dw_determinism": k4b_same,
          "depthwise_conv_dw_wide_c": k4b_wide,
          "depthwise_conv1d_grads": k4_grads,
          "vpu_pass": k5})
    bad = [c for c in k1_cases + k1_drop + k1_edges + k1_serving + k1_export
           + k2_cases
           + [long_k2, deterministic] + k1_general + k2_general + geometry
           + k3_cases + k3_serving + k3_export
           + k4a_cases + [k4a_long, k4a_stream] + k4a_other + k4a_ties
           + k4a_export
           + k4b_cases
           + k4b_other + [k4b_same, k4b_wide] + k4_grads + [k5]
           if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel disagrees with its plain version: {bad}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_ops", "bound_fp32_fma_ms", "library_ms", "library_backend")
    pick = lambda case, **extra: {**{k: case[k] for k in keys if k in case},
                                  **extra}
    main_k2 = k2_cases[7]            # bf16, L 599, rate 0.1: the 24 s train batch
    # the general kernels at the tiny phase's shape, rate 0.1
    tiny_k1, tiny_k2 = (next(c for c in cases if "ms" in c
                             and (c["b"], c["l"]) == GENERAL_TINY[:2])
                        for cases in (k1_general, k2_general))
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
        {"name": "sincos_attention_fwd_general", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:181",
         "shape": "B=8 L=599 D=64 H=2 dh=32 bfloat16 rate=0.1",
         **pick(tiny_k1)},
        {"name": "sincos_attention_bwd_general", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention_bwd.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:254",
         "shape": "B=8 L=599 D=64 H=2 dh=32 bfloat16 rate=0.1",
         **pick(tiny_k2)},
        {"name": "sincos_attention_fwd_general_fp32", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:181",
         "shape": "B=8 L=599 D=512 H=8 float32 rate=0",
         **pick(k1_cases[1])},
        {"name": "sincos_attention_bwd_general_fp32", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/sincos_attention_bwd.cu",
         "replaces": "conformer_tpu/ops/pallas/sincos_attention.py:254",
         "shape": "B=8 L=599 D=512 H=8 float32 rate=0.1",
         **pick(k2_cases[3])},
        {"name": "logmel_fwd", "route": "cuda",
         "source": "conformer_tpu_torch/csrc/mel_frontend.cu",
         "replaces": "conformer_tpu/ops/pallas/mel_frontend.py:43",
         "shape": "B=8 n_frames=2401 float32",
         **pick(k3_cases[1]),
         "bound_ops": k3_cases[1]["bound_ops"],
         "bound_fp32_fma_ms": k3_cases[1]["bound_fp32_fma_ms"]},
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
    """Route the model through the kernels' plain versions (on the card):
    the wrappers' module names, which the autograd Functions and the custom
    ops look up when called."""
    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
    from conformer_tpu_torch.ops.cuda import mel_frontend as mf
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    return [mock.patch.object(sa, "sincos_attention_fwd",
                              sa.sincos_attention_plain),
            mock.patch.object(sa, "sincos_attention_bwd",
                              sa.sincos_attention_bwd_plain),
            mock.patch.object(mf, "logmel_fwd",
                              lambda *a, operands: mf.logmel_plain(*a)),
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
    """-> the kernels' launches in the forwards and train steps driven
    through them (the fp32 ones are the main path's fp32 runs)."""
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
    total = {}
    for case in results + train_runs:
        for key, n in case["launches"].items():
            total[key] = total.get(key, 0) + n
    return total


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


def train_step_case(torch, dtype: str, seconds: int, conv_impl: str = "xla",
                    base=None):
    """One production train step (dropout 0.1 hash, SpecAugment, remat,
    Adam at learning rate 0 so both runs see the same weights), through the
    kernels and through their plain versions, with the same seeds. Under
    remat K4a runs three times per block (forward, recomputation, dx) and
    K4b once. ``base``: the config (default ``Config()``, the CTC model;
    the transducer phase gives its own)."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_train_step

    dev = torch.device(DEVICE)
    cfg = (base or Config()).override(**{"optim.compute_dtype": dtype,
                                         "optim.learning_rate": 0.0,
                                         "model.conv_impl": conv_impl})
    model = build_model(cfg.model, dtype, seed=0).to(dev)
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


def _save_report(runs: list, steps: list) -> dict:
    """The train phase's checkpoint writes: every save written whole (its
    bytes and write seconds recorded), the newest three kept, and the step
    seconds of the steps that followed a save (its snapshot and the write
    beside them) against the other steps."""
    saves = [e for r in runs for e in r["saves"]]
    firsts = {r["start_step"] + 1 for r in runs}
    after = {e["step"] + 1 for e in saves}
    pick = lambda keep: [s_["step_seconds"] for s_ in steps
                         if s_["step"] not in firsts and keep(s_["step"])]
    want = [["ckpt_00000002.pt", "ckpt_00000004.pt"],
            ["ckpt_00000002.pt", "ckpt_00000004.pt", "ckpt_00000006.pt"]]
    listed = [[n for n in r["checkpoints"] if n.startswith("ckpt_")]
              for r in runs]
    # every 2 steps and at each epoch's end (2 steps an epoch: so twice a
    # step, the second waiting for the first's write)
    ok = (listed == want
          and [e["step"] for e in saves] == [2, 2, 4, 4, 6, 6]
          and all(e.get("bytes", 0) > 0 and "write_s" in e for e in saves))
    return {"bytes": max(e.get("bytes", 0) for e in saves),
            "saves": saves,
            "step_seconds_after_a_save": pick(lambda n: n in after),
            "step_seconds_other": pick(lambda n: n not in after),
            "checkpoints": listed, "ok": ok}


def phase_train(torch, tmp: str):
    """-> launch counts of the two driven runs. Also reports the
    asynchronous checkpoint writes: each save's bytes, the seconds it held
    the training thread and the seconds its write took on the writer's
    thread, and the step seconds of the steps a save ran in against the
    others (each run's first step, which builds, aside)."""
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
                     "checkpoints": sorted(os.listdir(ck)),
                     "saves": list(trainer.ckpt.log)})
    with open(os.path.join(ck, "metrics.jsonl"), encoding="utf8") as f:
        records = [json.loads(ln) for ln in f]
    steps = [{"step": r["step"], "loss": r["train/ctc_loss"],
              "grad_norm": r["train/grad_norm"],
              "step_seconds": r["train/step_seconds"],
              "audio_seconds": r["train/audio_seconds"],
              "audio_s_per_s": r["train/audio_seconds"] / r["train/step_seconds"],
              "peak_memory_gb": r.get("train/peak_memory_gb")}
             for r in records if "train/ctc_loss" in r]
    saves = _save_report(runs, steps)
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
                  and r["launches"]["logmel_fwd"] > 0 for r in runs)
          and saves["ok"])
    emit({"phase": "train", "config": "Config() production (dropout 0.1 "
          "hash, SpecAugment, remat, bf16, Adam), B=8, 7.5 s and 23.5 s WAVs",
          "runs": runs, "steps": steps, "ok": ok})
    emit({"phase": "train_checkpoints", "card": gpu_name_and_limit(),
          **saves})
    if not ok:
        raise SystemExit("train phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 6: conv_impl pallas through training with validation, the evaluate
# CLI and serving.
# ---------------------------------------------------------------------------

VAL_SECONDS = [7.5] * 3 + [23.5] * 3
PALLAS = ["--set", "model.conv_impl=pallas"]
# The host beam search at the reference's operating point (DecodeConfig:
# beam 190, alpha 2.1, beta 9.2, prune -20, hotword weight 9.0) with one
# hotword, and the width at which the Python decoder is held against the
# native one on the card's log-probs.
HOTWORD = "VIỆT NAM"
BEAM_CHECK_WIDTH = 16


def build_lm(tmp: str, manifest: str) -> str:
    """An ARPA from a manifest's transcripts through the port's
    ``cli.create_lm``. -> its path."""
    from conformer_tpu_torch.cli import create_lm

    with open(manifest, newline="", encoding="utf8") as f:
        texts = [row["text"] for row in csv.DictReader(f)]
    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w", encoding="utf8") as f:
        f.write("\n".join(texts))
    out = os.path.join(tmp, "lm")
    create_lm.main(["--text", corpus, "--out", out])
    return os.path.join(out, "lm.arpa")


def beam_batches(torch, ck: str, manifest: str, arpa: str) -> dict:
    """The checkpoint through ``InferencePipeline(decode="beam")`` on the
    card at the reference operating point with HOTWORD: each batch's wall
    and beam-decode seconds; and on the card's log-probs of the shortest
    batch and on a contended seeded batch, the native decoder's texts
    against the Python decoder's (the plain version, with the Python n-gram
    scorer) at BEAM_CHECK_WIDTH."""
    import dataclasses

    import numpy as np

    from conformer_tpu_torch.config import Config, DataConfig
    from conformer_tpu_torch.data.dataset import BucketedLoader, ManifestDataset
    from conformer_tpu_torch.decode.beam_search import BeamSearchDecoder
    from conformer_tpu_torch.decode.pipeline import InferencePipeline
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    tok = load_tokenizer("vi")
    cfg = Config.from_json(os.path.join(ck, "config.json")).override(
        **{"decode.lm_path": arpa, "decode.hotwords": [HOTWORD]})
    pipe = InferencePipeline(cfg, tok, decode="beam", device=DEVICE,
                             checkpoint_dir=ck)
    metrics, _ = pipe.evaluate(manifest)
    batch = min(BucketedLoader(ManifestDataset(manifest), tok,
                               DataConfig(batch_size=8),
                               training=False).epoch(0),
                key=lambda b: b.audio.shape[1])
    out, _ = pipe.run_batch(batch.audio, batch.audio_lengths)
    log_probs = out["log_probs"].float().cpu().numpy()
    lengths = out["lengths"].cpu().numpy()
    small = dataclasses.replace(pipe.cfg.decode, beam_width=BEAM_CHECK_WIDTH)
    # A briefly trained model puts nearly every frame on the blank, which
    # leaves the search little to do; a batch of 8 x 599 frames of contended
    # seeded log-probs makes it choose, so the decoders are held against
    # each other there too, and the native decoder's time on it at the
    # operating point times the search itself.
    contended = contended_log_probs(tok.vocab_size, tok.pad_id, 8, 599, seed=9)
    contended_lengths = np.full(8, 599, np.int32)
    check = {"beam_width": BEAM_CHECK_WIDTH}
    for name, lp, ln in (("checkpoint", log_probs, lengths),
                         ("contended", contended, contended_lengths)):
        t0 = time.perf_counter()
        native = BeamSearchDecoder(tok, small).decode_batch(lp, ln)
        t1 = time.perf_counter()
        plain = BeamSearchDecoder(tok, small, native=False).decode_batch(lp, ln)
        t2 = time.perf_counter()
        check[name] = {"frames": [int(n) for n in ln],
                       "native_texts": native, "plain_texts": plain,
                       "native_s": t1 - t0, "plain_s": t2 - t1,
                       "words": sum(len(t.split()) for t in native),
                       "same": native == plain}
    check["same"] = all(check[n]["same"] for n in ("checkpoint", "contended"))
    decoder = BeamSearchDecoder(tok, pipe.cfg.decode)
    t3 = time.perf_counter()
    decoder.decode_batch(contended, contended_lengths)
    t4 = time.perf_counter()
    return {"operating_point": dataclasses.asdict(pipe.cfg.decode),
            "metrics": metrics, "batches": pipe.batch_log, "check": check,
            "contended_batch_8x599_s": t4 - t3}


def contended_log_probs(vocab: int, blank: int, b: int, t: int, seed: int):
    """(b, t, vocab) fp32 log-softmax rows around a random token path, a
    third of the frames favouring the blank: the generator of the JAX
    package's native-against-Python beam test, at any shape."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lp = rng.normal(-6.0, 1.5, size=(b, t, vocab)).astype(np.float32)
    path = rng.integers(0, vocab, size=(b, t))
    rows, cols = np.meshgrid(np.arange(b), np.arange(t), indexing="ij")
    lp[rows, cols, path] += rng.uniform(2.0, 6.0, size=(b, t))
    lp[..., blank] += np.where(rng.uniform(size=(b, t)) < 0.3, 5.0, 0.0)
    return (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32)


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
    # The host beam search with an n-gram LM built from the train
    # transcripts, through cli.test and through the pipeline (--lm with
    # --decode auto, the device search on the card: the beam_device phase).
    arpa = build_lm(tmp, train_csv)
    beam_csv = os.path.join(tmp, "beam_results.csv")
    beam_argv = ["--manifest", val_csv, "--checkpoint-dir", ck, "--device",
                 DEVICE, *PALLAS, "--lm", arpa, "--decode", "beam",
                 "--set", f'decode.hotwords=["{HOTWORD}"]',
                 "--results", beam_csv]
    beam_metrics = driven("test_beam", lambda: cli_test.main(beam_argv))
    with open(beam_csv, newline="", encoding="utf8") as f:
        beam_rows = list(csv.reader(f))
    beam = driven("beam_batches",
                  lambda: beam_batches(torch, ck, val_csv, arpa))
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
        "test_beam": runs["test_beam"]["launches"] == e,
        "serve": (s_["depthwise_conv_fwd"] == n_blocks
                  and s_["sincos_attention_fwd"] == n_blocks)}
    ok = (trainer.step == 2 and len(val) == 2
          and all(math.isfinite(r["val/loss"]) for r in val)
          and all(math.isfinite(metrics[k]) for k in ("wer", "cer", "loss"))
          and rows[0] == ["label", "prediction"]
          and len(rows) == len(VAL_SECONDS) + 1
          and rel <= tol and all(launches_ok.values())
          and all(math.isfinite(beam_metrics[k]) for k in ("wer", "cer", "loss"))
          and math.isclose(beam_metrics["loss"], metrics["loss"], rel_tol=1e-6)
          and beam_rows[0] == ["label", "prediction"]
          and len(beam_rows) == len(VAL_SECONDS) + 1
          and beam["check"]["same"] and beam["check"]["contended"]["words"] > 0
          and len(beam["batches"]) == n_val + 1)
    emit({"phase": "evaluate", "config": "Config() production, "
          "conv_impl pallas, B=8; train 16 WAVs (7.5 s, 23.5 s) for 2 steps, "
          "validate and evaluate 6 WAVs", "val_batches": n_val,
          "val_records": val, "metrics": metrics, "plain_metrics": plain,
          "plain_test_ms": plain_ms, "loss_rel_diff": rel,
          "loss_tolerance": tol, "results_rows": len(rows) - 1,
          "beam_decode_s_per_batch": [b["decode_s"] for b in beam["batches"]],
          "beam_metrics": beam_metrics, "beam_results_rows": len(beam_rows) - 1,
          "beam": beam,
          "runs": runs, "launches_ok": launches_ok, "ok": ok})
    if not ok:
        raise SystemExit("evaluate phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 7: ModelConfig.tiny through training and serving: the general
# attention kernels on the main path.
# ---------------------------------------------------------------------------

def phase_tiny(torch, tmp: str):
    """ModelConfig.tiny (d_model 64, 2 heads of 32, kernel 7, LSTM 80,
    attention_impl pallas, bf16) trained for 2 steps through ``cli.train``,
    then that checkpoint served through ``cli.infer --checkpoint-dir`` (its
    config.json, the step-2 checkpoint) on a parquet manifest of 8 of the
    WAVs, both with ``--device cuda``; every attention launch goes to the
    general kernels. -> launch counts."""
    import contextlib
    import io

    import pyarrow as pa
    import pyarrow.parquet as pq

    from conformer_tpu_torch.cli import infer, train
    from conformer_tpu_torch.config import Config, ModelConfig
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa

    cfg = Config(model=ModelConfig.tiny(vocab_size=370))
    model = cfg.model
    variant = sa.attention_variant(torch.bfloat16, model.n_heads,
                                   model.d_model // model.n_heads,
                                   model.d_model)
    config = os.path.join(tmp, "tiny.json")
    cfg.to_json(config)
    manifest, paths = _write_manifest(tmp, "tiny", TRAIN_SECONDS, seed=3)
    ck = os.path.join(tmp, "ck_tiny")
    served = [*paths[:4], *paths[-4:]]
    parquet = os.path.join(tmp, "tiny_serve.parquet")
    pq.write_table(pa.table({"path": served}), parquet)
    out_csv = os.path.join(tmp, "tiny_served.csv")
    said = io.StringIO()
    runs, total = {}, {}
    for name, fn in (
            ("train", lambda: train.main(
                ["--train-manifest", manifest, "--checkpoint-dir", ck,
                 "--config", config, "--device", DEVICE,
                 "--set", "data.batch_size=8", "--set", "train.num_steps=2",
                 "--set", "train.log_every_steps=1",
                 "--set", "train.num_epochs=100"])),
            ("serve", lambda: infer.main(
                ["--manifest", parquet, "--checkpoint-dir", ck,
                 "--device", DEVICE, "--batch-size", "8",
                 "--output", out_csv]))):
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(said if name == "serve"
                                        else sys.stdout):
            out = fn()
        runs[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": launch_counts()}
        for key, n in runs[name]["launches"].items():
            total[key] = total.get(key, 0) + n
        if name == "train":
            steps = out.step
    with open(os.path.join(ck, "metrics.jsonl"), encoding="utf8") as f:
        losses = [json.loads(ln)["train/ctc_loss"] for ln in f
                  if "train/ctc_loss" in ln]
    print(said.getvalue(), end="", flush=True)
    with open(out_csv, newline="", encoding="utf8") as f:
        served_rows = [r["path"] for r in csv.DictReader(f)]
    restored = f"restored step 2 from {ck}" in said.getvalue()
    t, s_ = runs["train"]["launches"], runs["serve"]["launches"]
    n_blocks = model.n_blocks
    ok = (variant == "general" and steps == 2 and len(losses) == 2
          and restored and served_rows == served
          and all(math.isfinite(x) for x in losses)
          and t["sincos_attention_fwd"] == 2 * n_blocks
          and t["sincos_attention_fwd_general"] == 2 * n_blocks
          and t["sincos_attention_bwd"] == 2 * n_blocks
          and t["sincos_attention_bwd_general"] == 2 * n_blocks
          and s_["sincos_attention_fwd"] == s_["sincos_attention_fwd_general"]
          == n_blocks)
    emit({"phase": "tiny", "config": "ModelConfig.tiny(370): 2 blocks, "
          "d_model 64, 2 heads (dh 32), kernel 7, LSTM 80, pallas attention, "
          "bf16; train 16 WAVs (7.5 s, 23.5 s) for 2 steps, serve 8 from "
          "the step-2 checkpoint and a parquet manifest",
          "variant": variant, "losses": losses, "restored_step_2": restored,
          "runs": runs, "ok": ok})
    if not ok:
        raise SystemExit("tiny phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 8: the serving front: HTTP uploads, stream sessions, streaming CLI.
# ---------------------------------------------------------------------------

# Upload lengths (s): the 8, 16 and 30 s buckets (801, 1601 and 3001 mel
# frames; K3 at the last two); the ones at STREAM_8K_UPLOADS are also sent as
# 8 kHz WAVs, resampled by the server.
STREAM_UPLOAD_SECONDS = (6.0, 12.0, 20.0, 28.0)
STREAM_8K_UPLOADS = (0, 2)
# The batching window of the phase's server: long enough that concurrent
# uploads meet in one batch however the host schedules their decoding.
STREAM_WINDOW_MS = 200
STREAM_SECONDS = 24.0
STREAM_BLOCK_S = 0.5
STREAM_SHORT_S = 1.8


def _percentiles(values) -> dict:
    import numpy as np

    if not values:
        return {"n": 0}
    return {"n": len(values), "p50": float(np.percentile(values, 50)),
            "p95": float(np.percentile(values, 95)), "max": float(max(values))}


def _http(url: str, data=None, ctype=None):
    """-> (JSON reply, wall ms) of one request to the phase's server."""
    import urllib.request

    req = urllib.request.Request(url, data=data)
    if ctype:
        req.add_header("Content-Type", ctype)
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        body = json.loads(r.read())
    return body, (time.perf_counter() - t0) * 1e3


def _concurrently(fns):
    """Run each fn in its own thread; re-raise the first failure."""
    import threading

    errors = []

    def run(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def _serve_uploads(server, base: str, uploads):
    """POST every upload at once; hold each served text against the
    pipeline's run on that signal alone (batch 1, the same bucket), and,
    where the texts differ, the row's log-probs of the two runs against the
    model phase's bf16 tolerance."""
    import numpy as np

    from conformer_tpu_torch.audio import io as aio
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    pipe, batcher = server.pipe, server.batcher
    logged = len(pipe.batch_log)
    pipe.keep_outputs = True
    replies = {}

    def client(name, raw):
        replies[name] = _http(f"{base}/transcribe", raw)

    reset_launch_counts()
    t0 = time.perf_counter()
    _concurrently([lambda n=n, r=r: client(n, r) for n, r in uploads])
    wall = time.perf_counter() - t0
    counts = launch_counts()
    pipe.keep_outputs = False
    served = pipe.batch_log[logged:]
    stats, _ = _http(f"{base}/stats")
    tol = TOL_MODEL["bfloat16"]
    rows = []
    for name, raw in uploads:
        sig, sr = aio.decode_audio_bytes(raw)
        sig = aio.resample(sig.mean(axis=0) if sig.ndim == 2 else sig, sr,
                           16000)
        n = len(sig)
        bucket = batcher.bucket_for(n)
        batch, row = next((b, i) for b in served
                          for i in range(b["batch_size"])
                          if b["audio_lengths"][i] == n
                          and np.array_equal(b["audio"][i, :n], sig))
        audio = np.zeros((1, bucket), np.float32)
        audio[0, :n] = sig
        out, texts = pipe.run_batch(audio, np.array([n]))
        want_lp = out["log_probs"][0].float().cpu()
        t = int(out["lengths"][0])
        got_lp = batch["log_probs"][row]
        diff = float((got_lp[:t] - want_lp[:t]).abs().max())
        scale = float(want_lp[:t].abs().max())
        agree = float((got_lp[:t].argmax(-1) == want_lp[:t].argmax(-1))
                      .float().mean())
        text = replies[name][0]["text"]
        same_text = text == texts[0]
        logits_ok = (int(batch["lengths"][row]) == t
                     and diff <= tol["max_abs_rel"]
                     * scale and agree >= tol["token_agreement"])
        rows.append({"upload": name, "audio_s": n / 16000,
                     "bucket_s": bucket / 16000,
                     "served_batch": batch["batch_size"],
                     "latency_ms": replies[name][1],
                     "same_text": same_text,
                     "held_by": "text" if same_text else "log_probs",
                     "log_prob_max_abs_diff": diff, "log_prob_scale": scale,
                     "token_agreement": agree,
                     "ok": bool(text) and (same_text or logits_ok)})
    return {"uploads": rows, "wall_s": wall, "stats": stats,
            "latency_ms": _percentiles([r["latency_ms"] for r in rows]),
            "launches": counts}


def _stream_sessions(base: str, pcm):
    """Two concurrent sessions on the same utterance, fed in STREAM_BLOCK_S
    blocks: one in audio/l16, one in audio/f32. -> {encoding: result}."""
    import numpy as np

    block = int(STREAM_BLOCK_S * 16000)
    bodies = {"l16": (pcm.astype("<i2"), "audio/l16"),
              "f32": ((pcm.astype(np.float32) / 32768.0).astype("<f4"),
                      "audio/f32")}
    # a window runs when a feed completes a chunk: every 4th 0.5 s block
    per_chunk = int(round(2.0 / STREAM_BLOCK_S))
    results = {}

    def session(name):
        samples, ctype = bodies[name]
        t0 = time.perf_counter()
        sid = _http(f"{base}/stream/start", b"")[0]["session"]
        feed_ms = []
        for i in range(0, len(samples), block):
            _, ms = _http(f"{base}/stream/{sid}",
                          samples[i: i + block].tobytes(), ctype)
            feed_ms.append(ms)
        final, finish_ms = _http(f"{base}/stream/{sid}/finish", b"")
        wall = time.perf_counter() - t0
        chunk_ms = feed_ms[per_chunk - 1::per_chunk]
        results[name] = {"text": final["text"], "feeds": len(feed_ms),
                         "feed_ms": _percentiles(feed_ms),
                         "chunk_feed_ms": _percentiles(chunk_ms),
                         "finish_ms": finish_ms, "wall_s": wall,
                         "rtf": wall / (len(samples) / 16000)}

    _concurrently([lambda n=n: session(n) for n in bodies])
    return results


def _infer_text(argv) -> "tuple[str, float]":
    """-> (the one transcript, wall s) of ``cli.infer.main(argv)``."""
    from conformer_tpu_torch.cli import infer

    t0 = time.perf_counter()
    infer.main(argv)
    wall = time.perf_counter() - t0
    out = argv[argv.index("--output") + 1]
    with open(out, newline="", encoding="utf8") as f:
        rows = list(csv.DictReader(f))
    return rows[0]["prediction"], wall


def _stream_short(pipe):
    """A <= 2 s utterance streamed (one window) against the offline run
    padded to the same window: the same log-probs, the same text."""
    import numpy as np

    from conformer_tpu_torch.decode.streaming import StreamingTranscriber

    rng = np.random.default_rng(17)
    audio = np.clip(rng.standard_normal(int(STREAM_SHORT_S * 16000)) * 0.1,
                    -1, 1).astype(np.float32)
    st = StreamingTranscriber(pipe.cfg, pipe.tok, pipe.model, pipe.frontend,
                              keep_windows=True)
    st.feed(audio)
    st.finish()
    window = np.zeros((1, st.ctx + st.chunk), np.float32)
    window[0, : len(audio)] = audio
    out, texts = pipe.run_batch(window, np.array([len(audio)]))
    t = int(out["lengths"][0])
    streamed = st.windows[0]
    same_frames = streamed.shape[0] == t
    diff = (float((streamed - out["log_probs"][0][:t].cpu()).abs().max())
            if same_frames else math.inf)
    return {"audio_s": STREAM_SHORT_S, "windows": len(st.windows),
            "frames": t, "streamed_frames": streamed.shape[0],
            "log_prob_max_abs_diff": diff, "text_equal": st.text == texts[0],
            "ok": len(st.windows) == 1 and diff == 0.0
            and st.text == texts[0]}


def _conv_impls(pipe, audio):
    """The streaming utterance through transcribers over the same weights,
    the depthwise conv through F.conv1d (``pipe``'s model, conv_impl xla)
    and through K4a (pallas): each window's log-probs held against the
    model phase's bf16 tolerance (the two round differently)."""
    from conformer_tpu_torch.decode.streaming import StreamingTranscriber
    from conformer_tpu_torch.models.conformer import Conformer

    cfg = pipe.cfg.override(**{"model.conv_impl": "pallas"})
    pallas = Conformer(cfg.model, cfg.optim.compute_dtype)
    pallas.load_state_dict(pipe.model.state_dict())
    pallas = pallas.to(pipe.device).eval()
    windows = {}
    for name, c, model in (("xla", pipe.cfg, pipe.model),
                           ("pallas", cfg, pallas)):
        st = StreamingTranscriber(c, pipe.tok, model, pipe.frontend,
                                  keep_windows=True)
        st.feed(audio)
        st.finish()
        windows[name] = st.windows
    pairs = list(zip(windows["xla"], windows["pallas"]))
    rel = max(float((p - x).abs().max() / x.abs().max()) for x, p in pairs)
    agree = min(float((p.argmax(-1) == x.argmax(-1)).float().mean())
                for x, p in pairs)
    tol = TOL_MODEL["bfloat16"]
    return {"windows": len(pairs), "log_prob_max_rel_diff": rel,
            "min_token_agreement": agree,
            "ok": (len(windows["xla"]) == len(windows["pallas"])
                   and all(x.shape == p.shape for x, p in pairs)
                   and rel <= tol["max_abs_rel"]
                   and agree >= tol["token_agreement"])}


def _stream_timing(torch, pipe, pcm, arpa: str):
    """The streaming utterance fed in STREAM_BLOCK_S blocks through
    transcribers over ``pipe``'s model: greedy pipelined and synchronous
    (the same text), and the host beam at 190 with the LM and the hotword;
    each one's wall time and RTF. Then one synchronous 2 s chunk (one
    window) under the profiler: the device's busy and idle share."""
    import dataclasses

    import numpy as np

    from conformer_tpu_torch.decode.streaming import StreamingTranscriber

    audio = pcm.astype(np.float32) / 32768.0
    block = int(STREAM_BLOCK_S * 16000)
    beam_cfg = dataclasses.replace(pipe.cfg.decode, lm_path=arpa,
                                   beam_width=190, hotwords=(HOTWORD,))
    runs = {
        "pipelined": pipe.streaming_transcriber(),
        "synchronous": pipe.streaming_transcriber(pipeline_chunks=False),
        "beam_190": StreamingTranscriber(
            pipe.cfg, pipe.tok, pipe.model, pipe.frontend, decode="beam",
            decode_cfg=beam_cfg)}
    out = {}
    for name, st in runs.items():
        st.feed(audio[:block])           # warm-up: the allocator's blocks
        st.finish()
        st.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, len(audio), block):
            st.feed(audio[i: i + block])
        st.finish()
        wall = time.perf_counter() - t0
        out[name] = {"wall_s": wall, "rtf": wall / STREAM_SECONDS,
                     "windows": -(-len(audio) // st.chunk)}
        out[name]["text_chars"] = len(st.text)
        if name != "beam_190":
            out[name]["text"] = st.text
    st = runs["synchronous"]
    st.reset()
    st.feed(audio[: st.chunk])           # the first window, untimed
    out["window_profile"] = {k: v for k, v in _profiled(
        torch, lambda: st.feed(audio[st.chunk: 2 * st.chunk])).items()
        if k != "conv_rows"}
    out["ok"] = out["pipelined"]["text"] == out["synchronous"]["text"]
    return out


def phase_stream(torch, tmp: str):
    """The production model (Config(), seeded weights, bf16) behind the
    port's HTTP server and its streaming CLI: concurrent WAV / FLAC / 8 kHz
    uploads to /transcribe, two concurrent /stream sessions (l16, f32)
    against ``cli.infer --streaming``, a short utterance streamed against
    offline, double buffering against synchronous emission, the host beam
    (beam 190, one hotword, an ARPA from ``cli.create_lm``) and
    conv_impl=pallas through ``cli.infer --streaming`` (its text equal to
    the xla run's, or, where it differs, each window's log-probs of the
    two conv_impls on the same weights within the bf16 tolerance). The
    threaded runs' launch counts are exact (the wrappers count under a
    lock) but depend on how requests batched, so they are held as > 0. ->
    launch counts of the driven runs."""
    import io as _io
    import threading

    import numpy as np
    from scipy.io import wavfile

    from conformer_tpu_torch.audio import io as aio
    from conformer_tpu_torch.audio.flac import encode_flac_bytes
    from conformer_tpu_torch.cli import create_lm, serve
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    rng = np.random.default_rng(7)
    pcm = lambda sec, sr: np.round(np.clip(
        rng.standard_normal(int(sec * sr)) * 0.1, -1, 1) * 32767
    ).astype(np.int16)

    def wav_bytes(x, sr):
        buf = _io.BytesIO()
        wavfile.write(buf, sr, x)
        return buf.getvalue()

    uploads, twins = [], []
    for i, sec in enumerate(STREAM_UPLOAD_SECONDS):
        x = pcm(sec, 16000)
        wav, flac = wav_bytes(x, 16000), encode_flac_bytes(
            x.astype(np.int64), 16000)
        twins.append(np.array_equal(aio.decode_audio_bytes(wav)[0],
                                    aio.decode_audio_bytes(flac)[0]))
        uploads += [(f"wav_{sec:g}s", wav), (f"flac_{sec:g}s", flac)]
        if i in STREAM_8K_UPLOADS:
            uploads.append((f"wav8k_{sec:g}s", wav_bytes(pcm(sec, 8000),
                                                          8000)))
    totals = {}

    def add(counts):
        for key, n in counts.items():
            totals[key] = totals.get(key, 0) + n

    t0 = time.perf_counter()
    server = serve.make_server(serve.parse_args(
        ["--device", DEVICE, "--port", "0", "--warmup",
         "--window-ms", str(STREAM_WINDOW_MS)]))
    build_s = time.perf_counter() - t0
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    corpus = os.path.join(tmp, "stream_corpus.txt")
    with open(corpus, "w", encoding="utf8") as f:
        f.write("\n".join(_transcript(rng) for _ in range(20)))
    create_lm.main(["--text", corpus, "--out", os.path.join(tmp, "slm")])
    arpa = os.path.join(tmp, "slm", "lm.arpa")
    utterance = pcm(STREAM_SECONDS, 16000)
    path = os.path.join(tmp, "stream24.wav")
    wavfile.write(path, 16000, utterance)
    try:
        served = _serve_uploads(server, base, uploads)
        add(served["launches"])
        # the WAVs alone: no FLAC decoding holds the host
        wav_only = _serve_uploads(server, base,
                                  [u for u in uploads if "flac" not in u[0]])
        add(wav_only["launches"])
        reset_launch_counts()
        sessions = _stream_sessions(base, utterance)
        session_counts = launch_counts()
        add(session_counts)
        short = _stream_short(server.pipe)
        timing = _stream_timing(torch, server.pipe, utterance, arpa)
        conv_impls = _conv_impls(server.pipe,
                                 utterance.astype(np.float32) / 32768.0)
    finally:
        server.shutdown()
        server.server_close()
    del server
    torch.cuda.empty_cache()

    out_csv = os.path.join(tmp, "stream.csv")
    stream = ["--audio", path, "--streaming", "--device", DEVICE,
              "--output", out_csv]
    reset_launch_counts()
    cli_text, cli_wall = _infer_text(stream)
    cli_counts = launch_counts()
    add(cli_counts)
    reset_launch_counts()
    beam_text, beam_wall = _infer_text(
        stream + ["--decode", "beam", "--lm", arpa,
                  "--set", "decode.beam_width=190",
                  "--set", f'decode.hotwords=["{HOTWORD}"]'])
    beam_counts = launch_counts()
    add(beam_counts)
    reset_launch_counts()
    pallas_text, pallas_wall = _infer_text(stream + PALLAS)
    pallas_counts = launch_counts()
    add(pallas_counts)

    finals = {k: v["text"] for k, v in sessions.items()}
    stats = served["stats"]
    ok = (all(twins) and all(r["ok"] for r in served["uploads"])
          and stats["max_batch_seen"] > 1
          and stats["requests"] == len(uploads)
          and all(t == cli_text for t in finals.values())
          and all(r["ok"] for r in wav_only["uploads"])
          and short["ok"] and timing["ok"]
          and served["launches"]["sincos_attention_fwd"] > 0
          and served["launches"]["logmel_fwd"] > 0
          and session_counts["sincos_attention_fwd"] > 0
          and cli_counts["sincos_attention_fwd"] > 0
          and beam_counts["sincos_attention_fwd"] > 0
          and pallas_counts["sincos_attention_fwd"] > 0
          and pallas_counts["depthwise_conv_fwd"] > 0
          and (pallas_text == cli_text or conv_impls["ok"]))
    emit({"phase": "stream", "config": "Config() production, seeded random "
          "weights, bf16; serve buckets 2/4/8/16/30 s, batch rungs 1/2/4/8, "
          f"window {STREAM_WINDOW_MS} ms; streams of 2 s chunks, 6 s context",
          "server_build_s": build_s, "wav_flac_twins_equal": twins,
          "transcribe": served, "transcribe_wav_only": wav_only,
          "sessions": sessions,
          "session_launches": session_counts,
          # the CLIs' wall times include building the model and reading
          # the file; the transcribers' timings below do not
          "cli_streaming": {"wall_s": cli_wall,
                            "equals_sessions": {k: t == cli_text
                                                for k, t in finals.items()},
                            "launches": cli_counts},
          "short_utterance": short, "transcriber_timing": timing,
          "cli_beam": {"width": 190, "hotword": HOTWORD, "wall_s": beam_wall,
                       "text_chars": len(beam_text),
                       "launches": beam_counts},
          "pallas": {"wall_s": pallas_wall,
                     "same_text_as_xla": pallas_text == cli_text,
                     "held_by": ("text" if pallas_text == cli_text
                                 else "log_probs"),
                     "log_probs_against_xla": conv_impls,
                     "launches": pallas_counts},
          "ok": ok})
    # the figures of PERF.md, each on a line of its own
    emit({"stream_figures": {
        "transcribe_latency_ms": served["latency_ms"],
        "transcribe_wav_only_latency_ms": wav_only["latency_ms"],
        "stream_feed_ms": {k: v["feed_ms"] for k, v in sessions.items()},
        "stream_chunk_feed_ms": {k: v["chunk_feed_ms"]
                                 for k, v in sessions.items()},
        "stream_session_rtf": {k: v["rtf"] for k, v in sessions.items()},
        "streaming_rtf": {k: timing[k]["rtf"] for k in
                          ("pipelined", "synchronous", "beam_190")},
        "stream_window_device_idle_share":
            timing["window_profile"]["device_idle_share"]}})
    if not ok:
        raise SystemExit("stream phase failed")
    return totals


# ---------------------------------------------------------------------------
# Optional phase: where the time of one 24 s forward goes.
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 9: the transducer (RNN-T) of configs/production_vi_transducer.json.
# ---------------------------------------------------------------------------

TRANSDUCER_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "configs", "production_vi_transducer.json")
# The one cut of the shipped config: its batch of 72, for the phase's time.
TRANSDUCER_CUT = {"data.batch_size": 8}
# rnnt_loss_scan against rnnt_loss_from_logits in fp32 on the same inputs:
# the two compute the same planes by other routes (logsumexp against
# log_softmax, chunks of frames against the whole lattice), so the value
# (relative) and each gradient (max |diff| over its max) agree to fp32
# rounding.
TOL_RNNT = {"value": 1e-5, "grad": 1e-4}
# A stream of one chunk (cli.infer's 2 s) against the offline decode of
# the same window.
TRANSDUCER_STREAM_S = 2.0
# The decode checks (served, streamed, exported, the timed decode) run a
# copy of the trained checkpoint made to mix blanks and emissions
# (mixing_copy): MIX_TOKENS_PER_FRAME tokens a frame on average over the
# validation rows and the stream's utterance, so that a 23.5 s row (586
# frames) stays below the cap of data.max_tokens (96).
MIX_TOKENS_PER_FRAME = 0.1
# The validation rows' share of active rounds that emit must lie within
# this, each row's count within (0, cap), and some frame must stop on a
# blank after emitting.
MIX_SHARE = (0.02, 0.5)
# rnnt_alpha_final on a peaked lattice at 24 s against the float64
# frame-by-frame DP: (B, T', U), and the blank log-prob off the alignment.
ALPHA_PEAKED = (8, 599, 60)
ALPHA_OFF = -20.0


def _transducer_cfg():
    from conformer_tpu_torch.config import Config

    return Config.from_json(TRANSDUCER_CONFIG).override(**TRANSDUCER_CUT)


def _wall_ms(torch, fn, iters: int = 3) -> float:
    """Mean host wall ms of fn() with the device synchronised around it:
    the time of launch-bound work, which a device clock would not see."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def rnnt_loss_case(torch):
    """rnnt_loss_scan against rnnt_loss_from_logits on the card in fp32 at
    B 8 x 8 s (T' 199, up to 60 labels, J 320, V 370) on seeded factors:
    the value and every gradient. Then both losses' forward + backward
    timed at B 8 x 24 s (T' 599) with bf16 factors, as training gives
    them."""
    import torch.nn.functional as F

    from conformer_tpu_torch.ops import rnnt

    dev = torch.device(DEVICE)
    gen = torch.Generator().manual_seed(31)

    def inputs(frames: int, dtype):
        e = torch.randn(8, frames, 320, generator=gen)
        p = torch.randn(8, 61, 320, generator=gen)
        w = torch.randn(370, 320, generator=gen) * 320 ** -0.5
        b = torch.randn(370, generator=gen) * 0.1
        labels, u_len = _tokens(torch, 8, 60, seed=frames)
        t_len = torch.tensor([frames - 9 * i for i in range(8)])
        grads = [x.to(dev, dt).requires_grad_(True) for x, dt in
                 ((e, dtype), (p, dtype), (w, torch.float32),
                  (b, torch.float32))]
        return grads, [x.to(dev) for x in (labels, t_len, u_len)]

    def run(impl, args):
        (e, p, w, b), (labels, t_len, u_len) = args
        if impl == "scan":
            loss = rnnt.rnnt_loss_scan(e, p, w, b, labels, t_len, u_len,
                                       row_mask=u_len > 0)
        else:
            lattice = F.linear(torch.tanh(e[:, :, None] + p[:, None]).float(),
                               w, b)
            loss = rnnt.rnnt_loss_from_logits(lattice, labels, t_len, u_len,
                                              row_mask=u_len > 0)
        return loss.detach(), torch.autograd.grad(loss, (e, p, w, b))

    args = inputs(199, torch.float32)
    (scan, g_scan), (lattice, g_lat) = run("scan", args), run("lattice", args)
    value = abs(float(scan) - float(lattice)) / abs(float(lattice))
    grads = {n: float((a - b).abs().max()) / float(b.abs().max())
             for n, a, b in zip(("e", "p", "out_weight", "out_bias"),
                                g_scan, g_lat)}
    args24 = inputs(599, torch.bfloat16)
    times = {f"{impl}_fwd_bwd_ms": _wall_ms(torch, lambda: run(impl, args24))
             for impl in ("scan", "lattice")}
    ok = (math.isfinite(float(scan)) and value <= TOL_RNNT["value"]
          and all(g <= TOL_RNNT["grad"] for g in grads.values()))
    return {"shape": "B=8 T'=199 U<=60 J=320 V=370 float32", "loss": float(scan),
            "value_rel_diff": value, "grad_rel_diff": grads,
            "tolerance": TOL_RNNT, "timed_shape": "B=8 T'=599 U<=60 bfloat16",
            **times, "ok": ok}


def _lae(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    return max(a, b) + math.log1p(math.exp(-abs(a - b)))


def _dp64(blank, emit, t_len: int, u_len: int):
    """One row of the RNN-T lattice frame by frame in float64 (numpy
    planes (T, U+1) and (T, U)): -> (log P(y | x), its gradients in blank
    and emit), the gradients as occupation probabilities (alpha + step +
    beta - log P)."""
    import numpy as np

    blank, emit = blank.astype(np.float64), emit.astype(np.float64)
    alpha = np.full((t_len, u_len + 1), -np.inf)
    beta = np.full((t_len + 1, u_len + 2), -np.inf)
    for t in range(t_len):
        for u in range(u_len + 1):
            a = 0.0 if t == u == 0 else -math.inf
            if t > 0:
                a = _lae(a, alpha[t - 1, u] + blank[t - 1, u])
            if u > 0:
                a = _lae(a, alpha[t, u - 1] + emit[t, u - 1])
            alpha[t, u] = a
    beta[t_len, u_len] = 0.0          # past the final blank
    for t in range(t_len - 1, -1, -1):
        for u in range(u_len, -1, -1):
            beta[t, u] = _lae(beta[t + 1, u] + blank[t, u],
                              beta[t, u + 1] + emit[t, u]
                              if u < u_len else -math.inf)
    ll = beta[0, 0]
    g_blank, g_emit = np.zeros_like(blank), np.zeros_like(emit)
    g_blank[:t_len, :u_len + 1] = np.exp(
        alpha + blank[:t_len, :u_len + 1] + beta[1:t_len + 1, :u_len + 1]
        - ll)
    g_emit[:t_len, :u_len] = np.exp(
        alpha[:, :u_len] + emit[:t_len, :u_len] + beta[:t_len, 1:u_len + 1]
        - ll)
    return ll, g_blank, g_emit


def alpha_peaked_case(torch):
    """rnnt_alpha_final on the card (fp32 planes) against _dp64 at
    ALPHA_PEAKED, on the planes of a confident model: near 0 along one
    diagonal alignment and around ALPHA_OFF off it, so that a column's
    blank log-probs sum to thousands before the alignment reaches it. The
    value (relative) and both gradients (absolute; they are occupation
    probabilities) within TOL_RNNT."""
    import numpy as np

    from conformer_tpu_torch.ops import rnnt

    b, t, u = ALPHA_PEAKED
    rng = np.random.default_rng(37)
    k = np.minimum(u, (np.arange(1, t + 1) * u) // t)[:, None]
    pos = np.arange(u + 1)[None, :]
    on = lambda: -rng.uniform(0.0, 0.05, (b, t, u + 1))
    off = lambda: ALPHA_OFF + rng.uniform(-2.0, 2.0, (b, t, u + 1))
    lp_blank = np.where(pos == k, on(), off()).astype(np.float32)
    lp_emit = np.where(pos < k, on(), off())[:, :, :u].astype(np.float32)
    # rows end on the alignment at other lengths
    t_len = np.array([t - 37 * i for i in range(b)])
    u_len = k[t_len - 1, 0]
    dev = torch.device(DEVICE)
    blank = torch.from_numpy(lp_blank).to(dev).requires_grad_(True)
    emit = torch.from_numpy(lp_emit).to(dev).requires_grad_(True)
    ll = rnnt.rnnt_alpha_final(blank, emit, torch.from_numpy(t_len).to(dev),
                               torch.from_numpy(u_len).to(dev))
    g_blank, g_emit = torch.autograd.grad(ll.sum(), (blank, emit))
    ll, g_blank, g_emit = (x.detach().cpu().numpy()
                           for x in (ll, g_blank, g_emit))
    value, grads = 0.0, {"blank": 0.0, "emit": 0.0}
    for i in range(b):
        want, w_blank, w_emit = _dp64(lp_blank[i], lp_emit[i], t_len[i],
                                      u_len[i])
        want = float(want)
        value = max(value, abs(float(ll[i]) - want) / abs(want))
        grads["blank"] = max(grads["blank"],
                             float(np.abs(g_blank[i] - w_blank).max()))
        grads["emit"] = max(grads["emit"],
                            float(np.abs(g_emit[i] - w_emit).max()))
    col_sum = float(np.where(pos == k, 0.0, lp_blank[0]).sum(0).min())
    return {"shape": f"B={b} T'={t} U={u} float32 planes, blank {ALPHA_OFF} "
            "off the alignment", "log_likelihood": ll.tolist(),
            "min_column_blank_sum": col_sum, "value_rel_diff": value,
            "grad_abs_diff": grads, "tolerance": TOL_RNNT,
            "ok": (bool(np.isfinite(ll).all()) and value <= TOL_RNNT["value"]
                   and all(g <= TOL_RNNT["grad"] for g in grads.values()))}


def _greedy(torch, model, cfg, enc, enc_len, max_len=None):
    """The model's greedy decode of encodings, as the eval step runs it."""
    from conformer_tpu_torch.ops.rnnt import rnnt_greedy_decode

    joint_fn, pred_step_fn = model.frame_fns()
    return rnnt_greedy_decode(
        joint_fn, enc, enc_len, pred_step_fn,
        model.predict_init(enc.shape[0], enc.device),
        max_symbols=cfg.decode.rnnt_max_symbols, max_len=max_len)


def _encode(torch, model, cfg, audio, lengths):
    from conformer_tpu_torch.audio.mel import MelFrontend

    dev = torch.device(DEVICE)
    frontend = MelFrontend(cfg.audio, device=dev)
    with torch.inference_mode():
        return model.eval().encode(frontend(audio.to(dev)),
                                   frontend.frame_lengths(lengths.to(dev)))


def _prediction_states(torch, model, seed: int):
    """The prediction network's outputs (B 8 x 61, H) after seeded labels."""
    gen = torch.Generator().manual_seed(seed)
    labels = torch.randint(1, model.cfg.vocab_size, (8, 60), generator=gen)
    with torch.inference_mode():
        return model.prediction(labels.to(DEVICE)).flatten(0, 1)


def _centre(torch, dense, x) -> None:
    """Rescale the Dense layer in place so that its outputs on the rows of
    x have zero mean and unit spread (the mean of the features' std)."""
    with torch.no_grad():
        y = x.float() @ dense.weight.float().t() + dense.bias.float()
        mu, sd = y.mean(0), y.std(0).mean()
        dense.weight.div_(sd)
        dense.bias.copy_((dense.bias - mu) / sd)


def mixing_copy(torch, model, cfg, batches, iters: int = 18) -> dict:
    """Make the model's greedy decode mix blanks and emissions, in place.
    At production depth the random encoder's frames differ little (the
    joint's margin between blank and the best token moves by ~0.01 from
    frame to frame and utterance to utterance, so a blank bias alone makes
    every frame emit or none), so the joint's two halves are centred and
    scaled to unit spread, the encoder half over the frames of ``batches``
    ((audio, lengths) pairs), the prediction half over prediction states
    after seeded labels; then the blank's bias (joint.out.bias[0]) is
    bisected until the rows of ``batches`` emit MIX_TOKENS_PER_FRAME
    tokens a frame on average (each row weighing alike), uncapped.
    -> the bias and the rate it gives."""
    encs = [_encode(torch, model, cfg, *b_) for b_ in batches]
    frames = torch.cat([enc[i, : int(n)] for enc, lens in encs
                        for i, n in enumerate(lens)])
    joint = model.joint
    _centre(torch, joint.enc_proj, frames)
    _centre(torch, joint.pred_proj, _prediction_states(torch, model, seed=47))
    bias = joint.out.bias

    def rate(value):
        with torch.no_grad():
            bias[0] = value
        with torch.inference_mode():
            per_row = [(_greedy(torch, model, cfg, enc, lens)[1].float()
                        / lens.float()) for enc, lens in encs]
        return float(torch.cat(per_row).mean())

    lo, hi = -30.0, 30.0
    for _ in range(iters):
        mid = (lo + hi) / 2
        if rate(mid) > MIX_TOKENS_PER_FRAME:
            lo = mid                   # emits too often: raise the blank
        else:
            hi = mid
    at = rate((lo + hi) / 2)
    return {"blank_bias": float(bias[0].detach()), "tokens_per_frame": at,
            "target_tokens_per_frame": MIX_TOKENS_PER_FRAME}


def decode_mix(torch, model, cfg, audio, lengths) -> dict:
    """The greedy decode of a batch at the eval step's cap
    (data.max_tokens), each round's argmax recorded: each row's count;
    the share of active rounds that emit (a frame's rounds run until its
    first blank, at most decode.rnnt_max_symbols); the share of frames
    that emit; and of those, the share that stop on a blank before their
    last round. The share must lie within MIX_SHARE, every count within
    (0, cap), and some emitting frame must stop on a blank."""
    enc, enc_len = _encode(torch, model, cfg, audio, lengths)
    cap, symbols = cfg.data.max_tokens, cfg.decode.rnnt_max_symbols
    joint_fn, pred_step_fn = model.frame_fns()
    argmaxes = []

    def recording(enc_t, pred):
        logits = joint_fn(enc_t, pred)
        argmaxes.append(logits.argmax(dim=-1))
        return logits

    from conformer_tpu_torch.ops import frame_graph
    from conformer_tpu_torch.ops.rnnt import rnnt_greedy_decode

    # eagerly: a CUDA graph would call recording only while it captures
    with torch.inference_mode(), frame_graph.eager():
        _, counts = rnnt_greedy_decode(
            recording, enc, enc_len, pred_step_fn,
            model.predict_init(enc.shape[0], enc.device),
            max_symbols=symbols, max_len=cap)
        t = enc.shape[1]
        emits = torch.stack(argmaxes).view(t, symbols, -1) != 0
        # tokens a frame (B, T): the rounds before the frame's first blank
        lead = emits.int().cumprod(dim=1).sum(dim=1).t()
        valid = (torch.arange(t, device=enc.device)[None, :]
                 < enc_len[:, None])
        lead = lead[valid]
    emitted, rounds = int(lead.sum()), int((lead + (lead < symbols)).sum())
    emitting = int((lead > 0).sum())
    stops = int(((lead > 0) & (lead < symbols)).sum())
    share = emitted / rounds
    return {"counts": counts.tolist(), "frames": enc_len.tolist(),
            "cap": cap, "emit_share": share, "share_limits": MIX_SHARE,
            "frames_emitting": emitting / lead.numel(),
            "emitting_frames_stopping_on_a_blank": stops / max(emitting, 1),
            "ok": (MIX_SHARE[0] <= share <= MIX_SHARE[1] and stops > 0
                   and 0 < int(counts.min()) and int(counts.max()) < cap)}


def greedy_case(torch, model, cfg):
    """The greedy decode of one B 8 x 24 s batch (T' 599 frames, all
    decode.rnnt_max_symbols rounds of each) on the model's encodings, as
    the live path runs it (one CUDA graph a frame, ops/frame_graph.py)
    and eagerly (``frame_graph.eager()``), which the capturing call and a
    later replay (after an encoder forward has reused the freed memory)
    must equal bit for bit: wall ms (synchronised) of each, the graph's
    capture seconds, and the CUDA kernels each launches and the device's
    busy time, by torch.profiler."""
    from conformer_tpu_torch.ops import frame_graph

    enc, enc_len = _encode(torch, model, cfg,
                           *_noise_batch(torch, 8, 24, seed=41))
    symbols = cfg.decode.rnnt_max_symbols
    with torch.inference_mode():
        def decode():
            return _greedy(torch, model, cfg, enc, enc_len,
                           max_len=cfg.data.max_tokens)

        frame_graph.clear_cache()
        graph_out, first_ms = _run(torch, decode)
        capture_s = frame_graph.capture_seconds()
        _encode(torch, model, cfg, *_noise_batch(torch, 8, 24, seed=42))
        replay_out = decode()
        ms = _wall_ms(torch, decode, iters=2)
        prof = _profiled(torch, decode)
        with frame_graph.eager():
            eager_out, eager_ms = _run(torch, decode)
            eager_prof = _profiled(torch, decode)
    rounds = enc.shape[1] * symbols
    return {"shape": "B=8 24 s", "frames": enc.shape[1], "rounds": rounds,
            "graph_equals_eager_bit_for_bit": all(
                torch.equal(x, y) for out in (graph_out, replay_out)
                for x, y in zip(out, eager_out)),
            "first_call_ms": first_ms, "capture_s": capture_s,
            "ms": ms, "ms_per_round": ms / rounds, "eager_ms": eager_ms,
            "kernel_launches": prof["kernel_launches"],
            "launches_per_round": prof["kernel_launches"] / rounds,
            "device_busy_ms": prof["device_busy_ms"],
            "profiled_wall_ms": prof["wall_ms"],
            "device_idle_share": prof["device_idle_share"],
            "eager_kernel_launches": eager_prof["kernel_launches"],
            "eager_device_idle_share": eager_prof["device_idle_share"],
            "tokens_per_row": graph_out[1].tolist()}


def phase_transducer(torch, tmp: str):
    """configs/production_vi_transducer.json at full width (17 blocks,
    d_model 512, prediction and joint 320, vocab 370, bf16, hash dropout
    0.1, the scan loss) with seeded random weights, at batch 8: trained 4
    steps through ``cli.train --device cuda`` with checkpoints and resumed
    to 6; one train step through the kernels against their plain versions;
    the scan loss against the lattice loss; rnnt_alpha_final on a peaked
    24 s lattice against a float64 DP; the checkpoint evaluated through
    ``cli.test`` (greedy) and served through ``cli.infer``, offline and
    ``--streaming`` (a one-chunk utterance's text against the offline
    decode of the same window); the greedy decode of a 24 s batch timed and
    its launches counted. The decode checks after cli.test run a copy of
    the checkpoint made to mix blanks and emissions (mixing_copy;
    decode_mix holds the validation rows to it), kept
    in ``tmp/ck_mixed`` for the export phase. -> launch counts of the
    driven runs."""
    import numpy as np
    from scipy.io import wavfile

    from conformer_tpu_torch.cli import infer, train
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.decode.pipeline import InferencePipeline
    from conformer_tpu_torch.decode.streaming import StreamingTranscriber
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    train_csv, _ = _write_manifest(tmp, "train", TRAIN_SECONDS, seed=1)
    val_csv, val_paths = _write_manifest(tmp, "val", VAL_SECONDS, seed=2)
    ck = os.path.join(tmp, "ck")
    argv = ["--config", TRANSDUCER_CONFIG, "--train-manifest", train_csv,
            "--checkpoint-dir", ck, "--device", DEVICE,
            "--set", "data.batch_size=8",
            "--set", "train.checkpoint_every_steps=2",
            "--set", "train.log_every_steps=1",
            "--set", "train.num_epochs=100"]
    n_blocks = _transducer_cfg().model.n_blocks
    total, runs, train_runs = {}, {}, []

    def driven(name, fn):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        runs[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": launch_counts()}
        for key, n in runs[name]["launches"].items():
            total[key] = total.get(key, 0) + n
        return out

    for num_steps in (4, 6):
        trainer = driven(f"train_{num_steps}", lambda: train.main(
            argv + ["--set", f"train.num_steps={num_steps}"]))
        counts = runs[f"train_{num_steps}"]["launches"]
        steps = trainer.step - trainer.start_step
        train_runs.append({
            "num_steps": num_steps, "start_step": trainer.start_step,
            "end_step": trainer.step,
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
    step_case = train_step_case(torch, "bfloat16", 24, base=_transducer_cfg())
    loss_case = rnnt_loss_case(torch)
    alpha_case = alpha_peaked_case(torch)

    results = os.path.join(tmp, "results.csv")
    metrics = driven("test", lambda: cli_test.main(
        ["--manifest", val_csv, "--checkpoint-dir", ck, "--device", DEVICE,
         "--results", results]))
    with open(results, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    # the decode checks' copy of the checkpoint (mixing_copy, on the
    # validation rows and the stream's one-chunk utterance in its window),
    # in ck_mixed/ for cli.infer and the export phase
    latest = sorted(n for n in os.listdir(ck) if n.endswith(".pt"))[-1]
    payload = torch.load(os.path.join(ck, latest), map_location="cpu")
    cfg_json = os.path.join(ck, "config.json")
    t_cfg = Config.from_json(cfg_json)
    model = build_model(t_cfg.model, t_cfg.optim.compute_dtype, seed=None)
    model.load_state_dict(payload["model"])
    model = model.to(DEVICE)
    rng = np.random.default_rng(17)
    short = np.clip(rng.standard_normal(int(TRANSDUCER_STREAM_S * 16000))
                    * 0.1, -1, 1)
    short_wav = os.path.join(tmp, "short.wav")
    wavfile.write(short_wav, 16000, (short * 32767).astype(np.int16))
    signals = [wavfile.read(p_)[1].astype(np.float32) / 32768.0
               for p_ in (*val_paths, short_wav)]
    st = StreamingTranscriber(t_cfg, load_tokenizer("vi"), model)
    window = np.zeros((1, st.ctx + st.chunk), np.float32)
    window[0, : len(signals[-1])] = signals[-1]
    val_batch = np.zeros((len(val_paths), max(map(len, signals))),
                         np.float32)
    for i, a in enumerate(signals[:-1]):
        val_batch[i, : len(a)] = a
    val_lengths = torch.tensor([len(a) for a in signals[:-1]])
    mixing = mixing_copy(torch, model, t_cfg, [
        (torch.from_numpy(val_batch), val_lengths),
        (torch.from_numpy(window), torch.tensor([len(signals[-1])]))])
    mix = {**decode_mix(torch, model, t_cfg, torch.from_numpy(val_batch),
                        val_lengths), **mixing}
    payload["model"] = {k: v.cpu() for k, v in model.state_dict().items()}
    del model, st
    ck_mixed = os.path.join(tmp, "ck_mixed")
    os.makedirs(ck_mixed)
    shutil.copy(cfg_json, ck_mixed)
    torch.save(payload, os.path.join(ck_mixed, latest))
    serve_csv = os.path.join(tmp, "served.csv")
    driven("serve", lambda: infer.main(
        ["--checkpoint-dir", ck_mixed, "--audio", *val_paths,
         "--device", DEVICE, "--batch-size", "8", "--output", serve_csv]))
    with open(serve_csv, newline="", encoding="utf8") as f:
        served = list(csv.DictReader(f))
    stream_text, stream_s = driven("stream", lambda: _infer_text(
        ["--checkpoint-dir", ck_mixed, "--audio", short_wav,
         "--device", DEVICE, "--streaming", "--output",
         os.path.join(tmp, "stream.csv")]))
    pipe = InferencePipeline(Config.from_json(cfg_json), load_tokenizer("vi"),
                             checkpoint_dir=ck_mixed, device=DEVICE)
    offline_text = pipe.transcribe_batch(window,
                                         np.array([len(signals[-1])]))[0]
    greedy = greedy_case(torch, pipe.model, pipe.cfg)

    per_step = lambda r, k: r["launches_per_step"].get(k, 0)
    t_runs = [runs[f"train_{n}"]["launches"] for n in (4, 6)]
    launches_ok = {
        "train": all(per_step(r, "sincos_attention_fwd") == 2 * n_blocks
                     and per_step(r, "sincos_attention_fwd_dropout")
                     == 2 * n_blocks
                     and per_step(r, "sincos_attention_bwd") == n_blocks
                     for r in train_runs)
        and all(c["logmel_fwd"] > 0 for c in t_runs),
        "test": (runs["test"]["launches"]["sincos_attention_fwd"] > 0
                 and runs["test"]["launches"]["logmel_fwd"] > 0),
        "serve": runs["serve"]["launches"]["sincos_attention_fwd"] > 0}
    ok = (train_runs[0]["start_step"] == 0 and train_runs[0]["end_step"] == 4
          and train_runs[1]["start_step"] == 4
          and train_runs[1]["end_step"] == 6
          and [s_["step"] for s_ in steps] == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])
                  for s_ in steps)
          and step_case["ok"] and loss_case["ok"] and alpha_case["ok"]
          and mix["ok"] and greedy["graph_equals_eager_bit_for_bit"]
          and all(math.isfinite(metrics[k]) for k in ("wer", "cer", "loss"))
          and rows[0] == ["label", "prediction"]
          and len(rows) == len(VAL_SECONDS) + 1
          and len(served) == len(VAL_SECONDS)
          and all(r["prediction"] for r in served)
          and stream_text == offline_text and stream_text
          and all(launches_ok.values()))
    emit({"phase": "transducer", "config": "configs/production_vi_transducer"
          ".json (17 blocks, d_model 512, pred/joint 320, vocab 370, bf16, "
          "hash dropout 0.1, attention pallas, scan loss), seeded random "
          "weights", "reduced": {"data.batch_size": [72, 8]},
          "train_runs": train_runs, "steps": steps,
          "train_step_kernels_vs_plain": step_case, "loss_scan_vs_lattice":
          loss_case, "alpha_final_peaked_vs_dp64": alpha_case,
          "test_metrics": metrics, "results_rows": len(rows) - 1,
          "decode_mix": mix, "served": served,
          "stream": {
              "audio_s": TRANSDUCER_STREAM_S, "text": stream_text,
              "offline_text": offline_text, "wall_s": stream_s,
              "equal": stream_text == offline_text},
          "greedy_decode": greedy, "runs": runs,
          "launches_ok": launches_ok, "ok": ok})
    if not ok:
        raise SystemExit("transducer phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 10: export: torch.export programs with the kernels as custom ops.
# ---------------------------------------------------------------------------

# The export phase's programs: the production CTC model at each batch and
# bucket, the transducer greedy at one (batch, seconds), and a tiny model
# exported on the CPU at one. export_shapes() gives the kernels phase
# every shape these launch.
EXPORT_BATCHES = (1, 8)
EXPORT_SECONDS = (8, 24)
# The exported CTC model at the production width, its depth cut from 17
# blocks for time: each program's weights and nodes (~980 MB, ~71 s to
# export and ~36 s to load at 17) scale with it, the shapes do not.
EXPORT_BLOCKS = 6
# the transducer's greedy program at batch 1 and 4 s: cut from 8 s for
# time when the greedy rounds were unrolled (at 2 s the mixing copy emits
# nothing on this seed, which the check refuses)
TRANSDUCER_EXPORT = (1, 4)
TINY_EXPORT = (2, 2)
# the beam programs (cli.export --decode beam) at (batch, seconds), at
# beam_device's operating point (Config()'s DecodeConfig: W 190, K 8,
# alpha 2.1, beta 9.2, HOTWORD) with beam_device's word 5-gram; the
# transducer's at W RNNT_BEAM_WIDTH
CTC_BEAM_EXPORT = (8, 8)
RNNT_BEAM_EXPORT = (8, 4)
# a beam program's best beam may differ from the live search's only where
# the live search's top two scores lie closer than this (a near-tie)
TOL_EXPORT_TIE = 1e-3


def _export_cfg():
    from conformer_tpu_torch.config import Config

    return Config().override(**{"model.conv_impl": "pallas",
                                "model.n_blocks": EXPORT_BLOCKS})


def _tiny_export_cfg():
    from conformer_tpu_torch.config import Config, ModelConfig

    return Config(model=ModelConfig.tiny(370)).override(
        **{"optim.compute_dtype": "float32", "model.conv_impl": "pallas"})


def _artifact_bytes(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(directory, n))
               for n in os.listdir(directory) if n.endswith(".pt2"))


def _logits_agree(torch, got, want, lengths, tol: dict) -> dict:
    """The model phase's comparison: finite, the max |diff| within the
    tolerance (absolute, or relative to the largest logit), and the
    framewise argmax agreeing on the valid frames."""
    valid = (torch.arange(got.shape[1], device=got.device)[None, :]
             < lengths[:, None])
    agree = float((got.argmax(-1) == want.argmax(-1))[valid].float().mean())
    diff = float((got - want).abs().max())
    scale = float(want.abs().max())
    ok = (bool(torch.isfinite(got).all()) and agree >= tol["token_agreement"]
          and (diff <= tol["max_abs"] if "max_abs" in tol
               else diff <= tol["max_abs_rel"] * scale))
    return {"max_abs_diff": diff, "max_abs_logit": scale,
            "token_agreement": agree, "tolerance": tol, "ok": ok}


# cli.export processes started ahead of the export phase (name -> (process,
# log, out directory, start time)): tracing and saving is host work, which
# runs beside the phases in between on the host's other cores
_EXPORTS: dict = {}


def _export_checkpoint(cfg, directory: str):
    """A checkpoint of cli.train's kind with seeded weights -> the model."""
    from conformer_tpu_torch.cli.common import save_config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.train.checkpoint import CheckpointManager
    from conformer_tpu_torch.train.state import make_optimizer

    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0)
    mgr = CheckpointManager(directory)
    mgr.save(model, make_optimizer(cfg.optim, model.parameters()), step=0)
    mgr.close()
    save_config(cfg, directory)
    return model


def program_nodes(out_dir: str) -> dict:
    """Graph nodes (the top graph's and every while_loop subgraph's) of
    each .pt2 program in ``out_dir``, read back by torch.export.load,
    keyed by bucket seconds (the file name's)."""
    import torch

    nodes = {}
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".pt2"):
            exported = torch.export.load(os.path.join(out_dir, name))
            nodes[name[:-len(".pt2")].rsplit("_", 1)[1]] = sum(
                len(m.graph.nodes) for m in exported.graph_module.modules()
                if isinstance(m, torch.fx.GraphModule))
    return nodes


# a process of _start_export: cli.export, then the programs' graph nodes
# into nodes.json beside them (host work, off the phases' path)
_EXPORT_THEN_COUNT = (
    "import json, os, sys\n"
    "import chip_smoke\n"
    "from conformer_tpu_torch.cli.export import main\n"
    "main(sys.argv[2:])\n"
    "with open(os.path.join(sys.argv[1], 'nodes.json'), 'w') as f:\n"
    "    json.dump(chip_smoke.program_nodes(sys.argv[1]), f)\n")


def _start_export(tmp: str, name: str, ck: str, *flags) -> None:
    out = os.path.join(tmp, name)
    log = open(os.path.join(tmp, f"{name}.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-c", _EXPORT_THEN_COUNT, out,
         "--checkpoint-dir", ck, "--out", out, "--device", DEVICE, *flags],
        stdout=log, stderr=subprocess.STDOUT,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    _EXPORTS[name] = (proc, log, out, time.perf_counter())


def _export_lm(tmp: str) -> str:
    """beam_device's word 5-gram (_beam_lm on the same seed), built once in
    ``tmp`` -> its ARPA."""
    import numpy as np

    arpa = os.path.join(tmp, "lm", "lm.arpa")
    if not os.path.exists(arpa):
        _beam_lm(tmp, np.random.default_rng(5))
    return arpa


def _beam_flags(tmp: str) -> list:
    """cli.export's flags of a beam program: the word LM and HOTWORD."""
    return ["--decode", "beam", "--set", f"decode.lm_path={_export_lm(tmp)}",
            "--set", f'decode.hotwords=["{HOTWORD}"]']


def start_ctc_exports(tmp: str) -> None:
    """The CTC programs' cli.export runs (a seeded checkpoint in ``tmp``),
    batch 1 and 8, both buckets each, and the beam program at
    CTC_BEAM_EXPORT."""
    ck = os.path.join(tmp, "ck")
    _export_checkpoint(_export_cfg(), ck)
    for b in EXPORT_BATCHES:
        _start_export(tmp, f"ctc_b{b}", ck, "--batch-size", str(b),
                      "--audio-seconds", *[str(s_) for s_ in EXPORT_SECONDS])
    b, seconds = CTC_BEAM_EXPORT
    _start_export(tmp, "ctc_beam", ck, "--batch-size", str(b),
                  "--audio-seconds", str(seconds), *_beam_flags(tmp))


def _export_transducer_ck(tmp: str) -> "tuple[str, bool]":
    """The transducer phase's mixing checkpoint, or (run without it) a
    seeded one in ``tmp`` -> (its directory, whether from the phase)."""
    t_ck = os.path.join(os.path.dirname(tmp), "transducer", "ck_mixed")
    if os.path.isdir(t_ck):
        return t_ck, True
    t_ck = os.path.join(tmp, "transducer_ck")
    if not os.path.isdir(t_ck):
        _export_checkpoint(_transducer_cfg(), t_ck)
    return t_ck, False


def start_transducer_export(tmp: str) -> None:
    """The transducer's greedy and beam programs' cli.export runs."""
    t_ck = _export_transducer_ck(tmp)[0]
    for name, (b, seconds), flags in (
            ("transducer", TRANSDUCER_EXPORT, ()),
            ("transducer_beam", RNNT_BEAM_EXPORT, (
                *_beam_flags(tmp),
                "--set", f"decode.beam_width={RNNT_BEAM_WIDTH}"))):
        _start_export(tmp, name, t_ck, "--batch-size", str(b),
                      "--audio-seconds", str(seconds), *flags)


def stop_exports() -> None:
    """Kill the cli.export runs still going (a phase failed)."""
    for proc, log, _, _ in _EXPORTS.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    _EXPORTS.clear()


def _beam_agreement(torch, got, live, need_tokens: bool) -> dict:
    """A beam program's best beams (tokens, counts) against the live
    search's (prefixes, plens, scores) on the same inputs: every row equal,
    or where a row differs, the live search's top two scores for it within
    TOL_EXPORT_TIE (a near-tie); with ``need_tokens`` every row of the
    program's emits a token (two searches that emit nothing agree on
    nothing)."""
    tokens, counts = (x.cpu() for x in got)
    prefixes, plens, scores = (x.cpu() for x in live)
    rows = [i for i in range(counts.shape[0])
            if int(counts[i]) != int(plens[i, 0])
            or not torch.equal(tokens[i], prefixes[i, 0])]
    gaps = {str(i): float(scores[i, 0] - scores[i, 1]) for i in rows}
    return {"counts": counts.tolist(), "live_counts": plens[:, 0].tolist(),
            "rows_differing": rows, "live_top_two_gaps": gaps,
            "near_tie_limit": TOL_EXPORT_TIE, "tokens_needed": need_tokens,
            "ok": (all(g < TOL_EXPORT_TIE for g in gaps.values())
                   and (int(counts.min()) > 0 or not need_tokens))}


def phase_export(torch, tmp: str):
    """The production ``Config()`` with conv_impl=pallas (seeded random
    weights, a checkpoint of cli.train's kind) exported by ``cli.export
    --device cuda`` at the 8 and 24 s buckets, batch 1 and 8, loaded with
    ``ExportedModel`` and held against the live forward on the same batch
    (the model phase's bf16 tolerance), the kernels K1, K3 (24 s) and K4a
    counted while the programs run; a ``ModelConfig.tiny`` program
    exported on the CPU and moved to the card against the live tiny model;
    the transducer phase's checkpoint (its decode checks' copy, which
    mixes blanks and emissions; run alone, seeded weights) exported greedy
    at TRANSDUCER_EXPORT's 4 s, batch 1, against the live greedy tokens;
    the beam programs (``cli.export --decode beam`` at beam_device's
    operating point with its word 5-gram and HOTWORD): the CTC model's at
    CTC_BEAM_EXPORT against the live device search (its CUDA graph) on the
    log-probs of the logits program of the same bucket, the transducer's
    at RNNT_BEAM_EXPORT (W RNNT_BEAM_WIDTH) against the live search on
    the live encoder, each with _beam_agreement (every row emitting, the
    transducer's where its checkpoint is the mixing copy). The five ``cli.export``
    runs are processes of their own (tracing and saving is host work),
    which main() starts ahead (the CTC ones before the serve phase, the
    transducer's after the transducer phase; run alone, the phase starts
    them) and which are killed if the phase fails. Export seconds
    (meta.json), program bytes, load seconds, graph nodes (every frame
    loop one while_loop: the 24 s bucket holds fewer extra nodes than
    extra frames), and the programs' walls beside the live forward's, and
    a beam program's beside the live search's, graph and eager. -> launch
    counts of the programs' runs."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.export import ExportedModel, export_model
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops import frame_graph
    from conformer_tpu_torch.ops.beam_search_device import \
        ctc_beam_search_device
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.ops.rnnt import rnnt_beam_search
    from conformer_tpu_torch.text.tokenizer import load_tokenizer
    from conformer_tpu_torch.train.checkpoint import CheckpointManager
    from conformer_tpu_torch.train.steps import make_eval_step, make_forward

    dev = torch.device(DEVICE)
    tok = load_tokenizer("vi")
    total = {}

    def finish(name):
        proc, log, out, t0 = _EXPORTS[name]
        rc = proc.wait()
        process_s = time.perf_counter() - t0
        log.close()
        if rc != 0:
            with open(log.name, encoding="utf8") as f:
                raise SystemExit(f"cli.export {name} exited {rc}:\n"
                                 + f.read()[-4000:])
        with open(os.path.join(out, "meta.json")) as f:
            export_s = json.load(f)["export_seconds"]
        with open(os.path.join(out, "nodes.json")) as f:
            nodes = json.load(f)
        t0 = time.perf_counter()
        program = ExportedModel(out, device=DEVICE)
        return program, {"export_s": export_s, "process_s": process_s,
                         "load_s": time.perf_counter() - t0,
                         "bytes": _artifact_bytes(out), "nodes": nodes}

    def counted(fn):
        reset_launch_counts()
        out, ms = _run(torch, fn)
        counts = launch_counts()
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        return out, ms, counts

    def search_walls(search):
        """The live search's walls (s): its first call (the graph's
        capture), one graph replay and one eager run."""
        frame_graph.clear_cache()
        out, first_ms = _run(torch, search)
        _, graph_ms = _run(torch, search)
        with frame_graph.eager():
            _, eager_ms = _run(torch, search)
        return out, {"live_first_call_s": first_ms / 1e3,
                     "live_graph_s": graph_ms / 1e3,
                     "live_eager_s": eager_ms / 1e3}

    cfg = _export_cfg()
    n_blocks = cfg.model.n_blocks
    # the runs main() started ahead, or (the phase run alone) now
    if "ctc_b1" not in _EXPORTS:
        start_ctc_exports(tmp)
    if "transducer" not in _EXPORTS:
        start_transducer_export(tmp)
    arpa = _export_lm(tmp)
    lm_set = {"decode.lm_path": arpa, "decode.hotwords": [HOTWORD]}
    # the exported checkpoint's seeded weights, rebuilt
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0)
    t_ck, from_phase = _export_transducer_ck(tmp)
    t_b, t_s = TRANSDUCER_EXPORT
    tiny_b, tiny_s = TINY_EXPORT
    beam_b, beam_s = CTC_BEAM_EXPORT
    try:
        # meanwhile: a tiny program exported on the CPU, moved to the card
        tcfg = _tiny_export_cfg()
        tiny = build_model(tcfg.model, "float32", seed=0).eval()
        tiny_dir = os.path.join(tmp, "tiny_cpu")
        export_model(tcfg, tiny, tiny_dir, batch_size=tiny_b,
                     audio_seconds=(float(tiny_s),))
        with open(os.path.join(tiny_dir, "meta.json")) as f:
            tiny_meta = json.load(f)
        moved = ExportedModel(tiny_dir, device=DEVICE)
        audio, lengths = _noise_batch(torch, tiny_b, tiny_s, seed=61)
        audio, lengths = audio.to(dev), lengths.to(dev)
        (logits, _), _, tiny_counts = counted(lambda: moved(audio, lengths))
        want, want_len = make_forward(tcfg, tiny.to(dev))(audio, lengths)
        tiny_case = {"exported_on": tiny_meta["device"],
                     "export_s": tiny_meta["export_seconds"],
                     "bytes": _artifact_bytes(tiny_dir),
                     "nodes": program_nodes(tiny_dir),
                     "launches": tiny_counts,
                     **_logits_agree(torch, logits, want, want_len,
                                     TOL_MODEL["float32"])}
        tiny_case["ok"] = (tiny_case["ok"] and tiny_meta["device"] == "cpu"
                           and tiny_counts["sincos_attention_fwd"] == 2
                           and tiny_counts["depthwise_conv_fwd"] == 2)
        del moved, tiny

        model = model.to(dev).eval()
        forward = make_forward(cfg, model)
        ctc, beam_input = [], None
        for b in EXPORT_BATCHES:
            program, info = finish(f"ctc_b{b}")
            for seconds in EXPORT_SECONDS:
                audio, lengths = _noise_batch(torch, b, seconds,
                                              seed=50 + seconds)
                audio, lengths = audio.to(dev), lengths.to(dev)
                program(audio, lengths)                  # warm-up
                (logits, out_len), _, counts = counted(
                    lambda: program(audio, lengths))
                want, want_len = forward(audio, lengths)
                case = _logits_agree(torch, logits, want, want_len,
                                     TOL_MODEL["bfloat16"])
                case.update(
                    batch=b, seconds=seconds, launches=counts,
                    program_forward_ms=_wall_ms(
                        torch, lambda: program(audio, lengths)),
                    live_forward_ms=_wall_ms(
                        torch, lambda: forward(audio, lengths)),
                    lengths_equal=torch.equal(out_len, want_len))
                case["ok"] = (case["ok"] and case["lengths_equal"]
                              and counts["sincos_attention_fwd"] == n_blocks
                              and counts["depthwise_conv_fwd"] == n_blocks
                              and counts["logmel_fwd"] == int(seconds >= 16))
                ctc.append({**info, **case})
                if (b, seconds) == CTC_BEAM_EXPORT:
                    beam_input = (audio, lengths, torch.log_softmax(
                        logits.float(), dim=-1), out_len)
            del program
        del model, forward
        # every frame loop one while_loop: a program's nodes do not grow
        # with its frames (unrolled, each frame added a copy of the LSTM
        # step); the buckets' frontends differ by a few (K3 from 1600
        # frames, the matmul DFT below)
        grown = _sub_frames(cfg.audio, EXPORT_SECONDS[-1] * 16000) \
            - _sub_frames(cfg.audio, EXPORT_SECONDS[0] * 16000)
        rolled = all(max(c["nodes"].values()) - min(c["nodes"].values())
                     < grown for c in ctc)

        # the CTC beam program against the live search on the log-probs
        # of the logits program of the same bucket
        program, info = finish("ctc_beam")
        audio, lengths, lp, out_len = beam_input
        (tokens, counts_), ms, b_counts = counted(
            lambda: program(audio, lengths))
        kw = _ctc_beam_kwargs(torch, Config().override(**lm_set), tok, dev)
        live, walls = search_walls(
            lambda: ctc_beam_search_device(lp, out_len, **kw))
        ctc_beam = {**info, "batch": beam_b, "seconds": beam_s,
                    "beam_width": kw["beam_width"], "top_k": kw["top_k"],
                    "launches": b_counts, "program_s": ms / 1e3,
                    "program_again_s": _run(
                        torch, lambda: program(audio, lengths))[1] / 1e3,
                    **walls, **_beam_agreement(torch, (tokens, counts_),
                                               live, True)}
        ctc_beam["ok"] = (ctc_beam["ok"]
                          and b_counts["sincos_attention_fwd"] == n_blocks
                          and b_counts["depthwise_conv_fwd"] == n_blocks)
        del program

        # the transducer, greedy decode and beam search baked in
        program, info = finish("transducer")
        beam_program, beam_info = finish("transducer_beam")
    finally:
        stop_exports()
    tcfg = Config.from_json(os.path.join(t_ck, "config.json"))
    t_model = build_model(tcfg.model, tcfg.optim.compute_dtype, seed=None)
    CheckpointManager(t_ck).restore(t_model)
    t_model = t_model.to(dev).eval()
    step = make_eval_step(tcfg, t_model)
    audio, lengths = _noise_batch(torch, t_b, t_s, seed=71)
    audio, lengths = audio.to(dev), lengths.to(dev)
    program(audio, lengths)                              # warm-up
    (tokens, counts_), ms, t_counts = counted(lambda: program(audio, lengths))
    live = step(audio, lengths)
    cap = tcfg.data.max_tokens
    transducer = {**info, "checkpoint": (
        "transducer phase, mixing copy" if from_phase
        else "seeded weights"), "launches": t_counts, "cap": cap,
                  "program_ms": ms,
                  "live_ms": _wall_ms(torch, lambda: step(audio, lengths), 1),
                  "counts": counts_.tolist(),
                  "live_counts": live["counts"].tolist(),
                  "tokens_equal": torch.equal(tokens, live["tokens"])
                  and torch.equal(counts_, live["counts"])}
    transducer["ok"] = (transducer["tokens_equal"]
                        and (0 < int(counts_.min()) < cap or not from_phase)
                        and t_counts["sincos_attention_fwd"]
                        == tcfg.model.n_blocks)

    # the transducer's beam program against the live search on the live
    # encoder (the checkpoint's config at W RNNT_BEAM_WIDTH with the LM)
    r_cfg = tcfg.override(**lm_set,
                          **{"decode.beam_width": RNNT_BEAM_WIDTH})
    r_b, r_s = RNNT_BEAM_EXPORT
    audio, lengths = _noise_batch(torch, r_b, r_s, seed=72)
    audio, lengths = audio.to(dev), lengths.to(dev)
    (tokens, counts_), ms, r_counts = counted(
        lambda: beam_program(audio, lengths))
    enc, enc_len = _encode(torch, t_model, tcfg, audio, lengths)
    joint_fn, pred_step_fn = t_model.frame_fns()
    r_kw = _rnnt_beam_kwargs(r_cfg, tok, dev)
    live, walls = search_walls(lambda: rnnt_beam_search(
        joint_fn, enc, enc_len, pred_step_fn,
        t_model.predict_init(r_b, dev), **r_kw))
    rnnt_beam = {**beam_info, "batch": r_b, "seconds": r_s,
                 "beam_width": r_kw["beam_width"], "top_k": r_kw["top_k"],
                 "launches": r_counts, "program_s": ms / 1e3,
                 "program_again_s": _run(
                     torch, lambda: beam_program(audio, lengths))[1] / 1e3,
                 **walls, **_beam_agreement(torch, (tokens, counts_), live,
                                            from_phase)}
    rnnt_beam["ok"] = (rnnt_beam["ok"] and r_counts["sincos_attention_fwd"]
                       == tcfg.model.n_blocks)
    ok = (all(c["ok"] for c in ctc) and rolled and tiny_case["ok"]
          and transducer["ok"] and ctc_beam["ok"] and rnnt_beam["ok"])
    smi = gpu_name_and_limit()
    emit({"phase": "export", "card": smi, "config": f"Config() production "
          f"width at {n_blocks} blocks, conv_impl pallas, seeded random "
          "weights; ModelConfig.tiny fp32 exported on the CPU; "
          "configs/production_vi_transducer.json greedy and beam; beams at "
          "beam_device's operating point with its word 5-gram and HOTWORD",
          "ctc": ctc, "nodes_grow_by_less_than_the_frames": rolled,
          "tiny_moved_from_cpu": tiny_case, "transducer_greedy": transducer,
          "ctc_beam": ctc_beam, "transducer_beam": rnnt_beam, "ok": ok})
    if not ok:
        raise SystemExit("export phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 11: the device beam searches (CTC and RNN-T) through CUDA graphs.
# ---------------------------------------------------------------------------

# The contended CTC batch (contended_log_probs, B x T' frames), the peaked
# batch's beam against the host's (unpruned, every token a candidate), the
# near-tie a CPU text may differ by, and the RNN-T batches' seconds.
BEAM_CONTENDED = (8, 599)
BEAM_PEAKED = (8, 64)
TOL_NEAR_TIE = 1e-4
RNNT_BEAM_SECONDS = (8, 24)
RNNT_BEAM_WIDTH = 190
# threads of the CPU search's process, beside the card's runs
CPU_BEAM_THREADS = 4
# frames of the profiled CTC runs (a third of them for the RNN-T)
PROFILE_FRAMES = 30


def _beam_texts(tok, prefixes, plens):
    """Best beams -> texts, as the pipeline assembles them."""
    return [tok.spec_decode(tok.collapsed_ids_to_text(
        prefixes[i, 0].tolist(), int(plens[i, 0]))).strip()
        for i in range(prefixes.shape[0])]


def _ctc_beam_kwargs(torch, cfg, tok, device, mesh=None):
    from conformer_tpu_torch.decode.pipeline import device_lm_kwargs

    dc = cfg.decode
    return dict(beam_width=dc.beam_width, top_k=dc.device_top_k,
                blank_id=tok.pad_id, unk_id=tok.unk_id,
                max_len=cfg.data.max_tokens,
                **device_lm_kwargs(cfg, tok, device, word_fallback=True,
                                   mesh=mesh))


def _rnnt_beam_kwargs(t_cfg, tok, device, mesh=None):
    from conformer_tpu_torch.decode.pipeline import device_lm_kwargs

    dc = t_cfg.decode
    return dict(beam_width=dc.beam_width, top_k=dc.rnnt_top_k,
                max_symbols=dc.rnnt_max_symbols,
                max_len=t_cfg.data.max_tokens, unk_id=tok.unk_id,
                **device_lm_kwargs(t_cfg, tok, device, word_fallback=True,
                                   mesh=mesh))


def _beam_lm(tmp: str, rng) -> "tuple[str, str]":
    """The word 5-gram and the token 5-gram that ``cli.create_lm`` builds
    from 300 transcripts drawn from ``rng`` -> (word ARPA, token ARPA)."""
    from conformer_tpu_torch.cli import create_lm

    corpus = os.path.join(tmp, "corpus.txt")
    with open(corpus, "w", encoding="utf8") as f:
        f.write("\n".join(_transcript(rng) for _ in range(300)))
    lm_dir = os.path.join(tmp, "lm")
    create_lm.main(["--text", corpus, "--out", lm_dir, "--token-level"])
    return (os.path.join(lm_dir, "lm.arpa"),
            os.path.join(lm_dir, "lm_tokens.arpa"))


def cpu_beam_search(arpa: str, out: str, b: int, t: int) -> None:
    """The contended batch (b x t) through the port's search on the CPU
    (its eager loop) at the operating point, in a process of its own: ->
    ``out`` (npz of the results and the seconds)."""
    import numpy as np
    import torch

    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.ops.beam_search_device import \
        ctc_beam_search_device
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    torch.set_num_threads(CPU_BEAM_THREADS)
    tok = load_tokenizer("vi")
    cfg = Config().override(**{"decode.lm_path": arpa,
                               "decode.hotwords": [HOTWORD]})
    lp = torch.from_numpy(contended_log_probs(tok.vocab_size, tok.pad_id, b,
                                              t, seed=9))
    kw = _ctc_beam_kwargs(torch, cfg, tok, torch.device("cpu"))
    t0 = time.perf_counter()
    prefixes, plens, scores = ctc_beam_search_device(lp, **kw)
    np.savez(out, prefixes=prefixes.numpy(), plens=plens.numpy(),
             scores=scores.numpy(), seconds=time.perf_counter() - t0)


def _peaked_batch(tok, b: int, seed: int):
    """(b, T, V) log-softmax of spelled transcripts (each token two frames
    then a blank, the rest at -9), zero-padded, and the lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(b):
        seq = []
        for t_ in tok.encode(tok.clean_text(_transcript(rng, 12).upper())):
            seq += [t_, t_, tok.pad_id]
        rows.append(seq)
    t = max(map(len, rows))
    lp = np.full((b, t, tok.vocab_size), -9.0, np.float32)
    for i, seq in enumerate(rows):
        lp[i, np.arange(len(seq)), seq] = -0.05
    lp -= np.log(np.exp(lp).sum(-1, keepdims=True))
    return lp.astype(np.float32), np.array([len(r) for r in rows], np.int32)


def _walls(torch, fn, n: int = 3):
    """Host wall seconds of n synchronised runs of fn()."""
    out = []
    for _ in range(n):
        out.append(_run(torch, fn)[1] / 1e3)
    return out


def _transducer_ck(torch, tmp: str):
    """The transducer phase's mixing checkpoint when it ran in this call;
    else the shipped config with seeded weights made to mix the same way
    (mixing_copy on a seeded 8 s batch). -> (checkpoint dir, where it came
    from)."""
    from conformer_tpu_torch.cli.common import save_config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.train.checkpoint import CheckpointManager
    from conformer_tpu_torch.train.state import make_optimizer

    ck = os.path.join(os.path.dirname(tmp), "transducer", "ck_mixed")
    if os.path.isdir(ck):
        return ck, "transducer phase, mixing copy"
    cfg = _transducer_cfg()
    model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0).to(DEVICE)
    mixing_copy(torch, model, cfg, [_noise_batch(torch, 8, 8, seed=81)])
    ck = os.path.join(tmp, "ck_mixed")
    mgr = CheckpointManager(ck)
    mgr.save(model, make_optimizer(cfg.optim, model.parameters()), step=0)
    mgr.close()
    save_config(cfg, ck)
    return ck, "seeded weights, mixing copy"


def phase_beam_device(torch, tmp: str):
    """The device beam searches at the reference's operating point
    (DecodeConfig: beam 190, 8 candidates a frame, alpha 2.1, beta 9.2,
    HOTWORD at 9.0) with word-level fusion from an ARPA that
    ``cli.create_lm`` builds from seeded transcripts. CTC: the contended
    8 x 599 batch through the CUDA graph against the eager step on the card
    (bit for bit) and against the port's search on the CPU (run meanwhile
    in a process of its own: equal texts, or a near-tie); a peaked batch
    against the host beam search (native) with no pruning; the walls,
    capture seconds, launches a frame, the host search's seconds on the
    contended batch; ``cli.test --lm --decode auto`` (beam_auto ->
    beam_device) and with a token-level ``decode.device_lm_path``,
    ``cli.infer --streaming --decode beam_device`` on a 24 s WAV, each
    window's feed timed, ``cli.serve --decode beam_auto`` answering
    /transcribe and ``cli.pseudo_label --decode beam_device``. RNN-T
    (configs/production_vi_transducer.json, the transducer phase's mixing
    checkpoint): B 8 x 8 s through the graph against eager (bit for bit),
    the walls, the graph at 24 s, ``cli.test --decode beam``, ``cli.infer
    --decode beam``, offline and ``--streaming``. -> launch counts of the
    driven runs."""
    import multiprocessing
    import threading

    import numpy as np
    from scipy.io import wavfile

    from conformer_tpu_torch.cli import pseudo_label, serve
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.decode.beam_search import BeamSearchDecoder
    from conformer_tpu_torch.decode.pipeline import InferencePipeline
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops import frame_graph
    from conformer_tpu_torch.ops.beam_search_device import \
        ctc_beam_search_device
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.ops.rnnt import rnnt_beam_search
    from conformer_tpu_torch.text.tokenizer import load_tokenizer
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    dev = torch.device(DEVICE)
    tok = load_tokenizer("vi")
    total, runs, sections = {}, {}, {}
    t_phase = time.perf_counter()

    def driven(name, fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        runs[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": launch_counts()}
        for key, n in runs[name]["launches"].items():
            total[key] = total.get(key, 0) + n
        return out

    def section(name):
        """Host seconds since the phase began, at the end of a section."""
        sections[name] = time.perf_counter() - t_phase

    rng = np.random.default_rng(5)
    arpa, token_arpa = _beam_lm(tmp, rng)
    hot = ["--set", f'decode.hotwords=["{HOTWORD}"]']
    cfg = Config().override(**{"decode.lm_path": arpa,
                               "decode.hotwords": [HOTWORD]})
    cpu_out = os.path.join(tmp, "cpu_beam.npz")
    b, t = BEAM_CONTENDED
    proc = multiprocessing.get_context("spawn").Process(
        target=cpu_beam_search, args=(arpa, cpu_out, b, t))
    proc.start()
    try:
        # -- CTC: the contended batch, graph against eager on the card
        lp_np = contended_log_probs(tok.vocab_size, tok.pad_id, b, t, seed=9)
        lp = torch.from_numpy(lp_np).to(dev)
        kw = _ctc_beam_kwargs(torch, cfg, tok, dev)
        search = lambda: ctc_beam_search_device(lp, **kw)
        # the profiles take the first PROFILE_FRAMES frames (the same
        # graph): a trace of every frame is ~500,000 kernels
        part = lambda: ctc_beam_search_device(lp[:, :PROFILE_FRAMES], **kw)
        frame_graph.clear_cache()
        graph_out, first_ms = _run(torch, search)
        capture_s = frame_graph.capture_seconds()
        graph_walls = _walls(torch, search)
        graph_prof = _profiled(torch, part)
        with frame_graph.eager():     # one timed run: it is slow
            eager_out, eager_ms = _run(torch, search)
            eager_walls = [eager_ms / 1e3]
            eager_prof = _profiled(torch, part)
        bits = all(torch.equal(x, y) for x, y in zip(graph_out, eager_out))
        card_texts = _beam_texts(tok, graph_out[0].cpu(), graph_out[1].cpu())
        card_scores = graph_out[2].cpu().numpy()
        t0 = time.perf_counter()
        BeamSearchDecoder(tok, cfg.decode).decode_batch(
            lp_np, np.full(b, t, np.int32))
        host_s = time.perf_counter() - t0
        ctc = {"shape": f"B={b} T'={t} V={tok.vocab_size}",
               "operating_point": {
                   "beam_width": cfg.decode.beam_width,
                   "top_k": cfg.decode.device_top_k,
                   "alpha": cfg.decode.alpha, "beta": cfg.decode.beta,
                   "hotwords": [HOTWORD],
                   "hotword_weight": cfg.decode.hotword_weight},
               "graph_equals_eager_bit_for_bit": bits,
               "first_call_s": first_ms / 1e3, "capture_s": capture_s,
               "graph_s": graph_walls, "eager_s": eager_walls,
               "graph_median_s": float(np.median(graph_walls)),
               "eager_median_s": float(np.median(eager_walls)),
               "eager_launches_per_frame":
                   eager_prof["kernel_launches"] / PROFILE_FRAMES,
               "profiled_frames": PROFILE_FRAMES,
               "graph_profile": {k: graph_prof[k] for k in (
                   "wall_ms", "device_busy_ms", "device_idle_share",
                   "kernel_launches")},
               "eager_profile": {k: eager_prof[k] for k in (
                   "wall_ms", "device_busy_ms", "device_idle_share",
                   "kernel_launches")},
               "host_beam_decode_s": host_s,
               "words": sum(len(x.split()) for x in card_texts)}

        section("ctc_contended")
        # -- CTC: a peaked batch against the host beam, nothing pruned
        pb, width = BEAM_PEAKED
        p_lp, p_len = _peaked_batch(tok, pb, seed=13)
        p_cfg = cfg.override(**{"decode.beam_width": width,
                                "decode.device_top_k": tok.vocab_size - 1,
                                "decode.beam_prune_logp": -1e9,
                                "decode.token_min_logp": -1e9})
        p_out = ctc_beam_search_device(
            torch.from_numpy(p_lp).to(dev), torch.from_numpy(p_len).to(dev),
            **_ctc_beam_kwargs(torch, p_cfg, tok, dev))
        p_device = _beam_texts(tok, p_out[0].cpu(), p_out[1].cpu())
        p_host = BeamSearchDecoder(tok, p_cfg.decode).decode_batch(p_lp,
                                                                  p_len)
        peaked = {"shape": f"B={pb} T'={p_lp.shape[1]}", "beam_width": width,
                  "top_k": tok.vocab_size - 1, "device_texts": p_device,
                  "host_texts": p_host, "equal": p_device == p_host}

        section("ctc_peaked")
        # -- CTC through the CLIs (Config(), seeded weights, bf16)
        manifest, eval_wavs = _write_manifest(tmp, "eval",
                                              [7.5, 7.5, 23.5, 23.5], seed=3)
        auto = driven("test_lm_auto", lambda: cli_test.main(
            ["--manifest", manifest, "--device", DEVICE, "--lm", arpa,
             *hot]))
        token = driven("test_device_lm", lambda: cli_test.main(
            ["--manifest", manifest, "--device", DEVICE, "--decode",
             "beam_device", "--set", f"decode.device_lm_path={token_arpa}"]))
        wav24 = os.path.join(tmp, "s24.wav")
        wavfile.write(wav24, 16000, (np.clip(rng.standard_normal(
            int(STREAM_SECONDS * 16000)) * 0.1, -1, 1) * 32767).astype(
            np.int16))
        stream_text, stream_s = driven("stream", lambda: _infer_text(
            ["--audio", wav24, "--device", DEVICE, "--streaming", "--decode",
             "beam_device", "--lm", arpa, *hot, "--output",
             os.path.join(tmp, "stream.csv")]))
        pipe = InferencePipeline(cfg, tok, decode="beam_device",
                                 device=DEVICE)
        st = pipe.streaming_transcriber()
        audio = wavfile.read(wav24)[1].astype(np.float32) / 32768.0
        feeds = []
        for i in range(0, len(audio), st.chunk):
            t0 = time.perf_counter()
            st.feed(audio[i: i + st.chunk])
            st.text                   # the device work done, read back
            feeds.append((time.perf_counter() - t0) * 1e3)
        st.finish()
        del pipe, st
        # cli.serve with beam_auto (-> beam_device) answers /transcribe;
        # cli.pseudo_label labels the manifest through the device beam
        server = serve.make_server(serve.parse_args(
            ["--decode", "beam_auto", "--device", DEVICE, "--port", "0",
             "--lm", arpa, *hot]))
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            with open(eval_wavs[0], "rb") as f:
                served, served_ms = driven("serve", lambda: _http(
                    f"http://127.0.0.1:{server.server_address[1]}"
                    "/transcribe", f.read(), "audio/wav"))
            serve_decode = server.pipe.decode
        finally:
            server.shutdown()
            server.server_close()
        del server
        labelled = driven("pseudo_label", lambda: pseudo_label.main(
            ["--manifest", manifest, "--output",
             os.path.join(tmp, "labels.csv"), "--device", DEVICE,
             "--decode", "beam_device", "--lm", arpa, *hot]))
        clis = {"test_lm_auto": auto, "test_device_lm": token,
                "stream_text": stream_text, "stream_wall_s": stream_s,
                "stream_feed_ms": feeds, "serve_decode": serve_decode,
                "served": served, "served_ms": served_ms,
                "pseudo_labelled": labelled}

        section("ctc_clis")
        # -- RNN-T
        frame_graph.clear_cache()
        ck, ck_from = _transducer_ck(torch, tmp)
        # the shipped config's beam is 8 wide: the reference's 190 here
        wide = ["--set", f"decode.beam_width={RNNT_BEAM_WIDTH}"]
        t_cfg = Config.from_json(os.path.join(ck, "config.json")).override(
            **{"decode.lm_path": arpa, "decode.hotwords": [HOTWORD],
               "decode.beam_width": RNNT_BEAM_WIDTH})
        model = build_model(t_cfg.model, t_cfg.optim.compute_dtype,
                            seed=None)
        CheckpointManager(ck).restore(model)
        model = model.to(dev).eval()
        joint_fn, pred_step_fn = model.frame_fns()
        dc = t_cfg.decode
        r_kw = _rnnt_beam_kwargs(t_cfg, tok, dev)
        rnnt = {"checkpoint": ck_from, "beam_width": dc.beam_width,
                "top_k": dc.rnnt_top_k, "max_symbols": dc.rnnt_max_symbols}
        for seconds in RNNT_BEAM_SECONDS:
            enc, enc_len = _encode(torch, model, t_cfg,
                                   *_noise_batch(torch, 8, seconds,
                                                 seed=90 + seconds))
            r_search = lambda: rnnt_beam_search(
                joint_fn, enc, enc_len, pred_step_fn,
                model.predict_init(8, dev), **r_kw)
            r_out, r_first = _run(torch, r_search)
            # 24 s timed once, for time (~3.2 s a run)
            case = {"frames": enc.shape[1], "first_call_s": r_first / 1e3,
                    "graph_s": _walls(torch, r_search,
                                      3 if seconds == RNNT_BEAM_SECONDS[0]
                                      else 1)}
            if seconds == RNNT_BEAM_SECONDS[0]:
                r_part = lambda: rnnt_beam_search(
                    joint_fn, enc[:, :PROFILE_FRAMES // 3],
                    enc_len.clamp(max=PROFILE_FRAMES // 3), pred_step_fn,
                    model.predict_init(8, dev), **r_kw)
                case["graph_profile"] = {k: v for k, v in _profiled(
                    torch, r_part).items() if k in (
                    "wall_ms", "device_busy_ms", "device_idle_share",
                    "kernel_launches")}
                with frame_graph.eager():     # one run: it is slow
                    r_eager, r_eager_ms = _run(torch, r_search)
                    case["eager_s"] = [r_eager_ms / 1e3]
                    prof = _profiled(torch, r_part)
                case["eager_launches_per_frame"] = \
                    prof["kernel_launches"] / (PROFILE_FRAMES // 3)
                case["eager_idle_share"] = prof["device_idle_share"]
                case["graph_equals_eager_bit_for_bit"] = all(
                    torch.equal(x, y) for x, y in zip(r_out, r_eager))
            case["counts"] = r_out[1][:, 0].tolist()
            rnnt[f"{seconds}s"] = case
        rnnt["capture_s"] = frame_graph.capture_seconds()
        del model
        section("rnnt_search")
        r_test = driven("rnnt_test", lambda: cli_test.main(
            ["--manifest", manifest, "--checkpoint-dir", ck, "--device",
             DEVICE, "--decode", "beam", "--lm", arpa, *hot, *wide]))
        wav8 = os.path.join(tmp, "s8.wav")
        wavfile.write(wav8, 16000, (audio[: 8 * 16000] * 32767).astype(
            np.int16))
        r_offline, r_offline_s = driven("rnnt_infer", lambda: _infer_text(
            ["--audio", wav8, "--checkpoint-dir", ck, "--device", DEVICE,
             "--decode", "beam", *wide, "--output",
             os.path.join(tmp, "rnnt_infer.csv")]))
        r_stream, r_stream_s = driven("rnnt_stream", lambda: _infer_text(
            ["--audio", wav8, "--checkpoint-dir", ck, "--device", DEVICE,
             "--streaming", "--decode", "beam", *wide, "--output",
             os.path.join(tmp, "rnnt_stream.csv")]))
        rnnt.update(test=r_test, infer_text=r_offline,
                    infer_wall_s=r_offline_s, stream_text=r_stream,
                    stream_wall_s=r_stream_s)

        section("rnnt_clis")
        # -- the CPU search's texts against the card's
        proc.join(timeout=600)
        if proc.exitcode != 0:
            raise SystemExit(f"the CPU beam search failed ({proc.exitcode})")
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join()
    with np.load(cpu_out) as cpu:
        cpu_texts = _beam_texts(tok, cpu["prefixes"], cpu["plens"])
        cpu_scores, cpu_s = cpu["scores"], float(cpu["seconds"])
    differing = [{"row": i, "card": card_texts[i], "cpu": cpu_texts[i],
                  "card_top2": card_scores[i, :2].tolist(),
                  "cpu_top2": cpu_scores[i, :2].tolist()}
                 for i in range(b) if card_texts[i] != cpu_texts[i]]
    near_ties = all(
        abs(d["card_top2"][0] - d["card_top2"][1]) <= TOL_NEAR_TIE
        or abs(d["cpu_top2"][0] - d["cpu_top2"][1]) <= TOL_NEAR_TIE
        for d in differing)
    ctc["cpu"] = {"seconds": cpu_s, "threads": CPU_BEAM_THREADS,
                  "rows_differing": differing, "near_tie_limit": TOL_NEAR_TIE,
                  "max_score_diff": float(np.abs(cpu_scores[:, 0]
                                                 - card_scores[:, 0]).max())}
    finite = lambda m: all(math.isfinite(m[k]) for k in ("wer", "cer",
                                                         "loss"))
    ok = (ctc["graph_equals_eager_bit_for_bit"] and near_ties
          and peaked["equal"] and ctc["words"] > 0
          and finite(auto) and finite(token) and finite(r_test)
          and isinstance(stream_text, str) and isinstance(r_stream, str)
          and isinstance(r_offline, str) and serve_decode == "beam_device"
          and isinstance(served.get("text"), str) and labelled >= 0
          and runs["serve"]["launches"]["sincos_attention_fwd"] > 0
          and rnnt[f"{RNNT_BEAM_SECONDS[0]}s"]["graph_equals_eager_bit_for_bit"]
          and all(sum(rnnt[f"{s_}s"]["counts"]) > 0
                  for s_ in RNNT_BEAM_SECONDS)
          and runs["test_lm_auto"]["launches"]["sincos_attention_fwd"] > 0
          and runs["rnnt_test"]["launches"]["sincos_attention_fwd"] > 0)
    smi = gpu_name_and_limit()
    emit({"phase": "beam_device", "card": smi, "config":
          "Config() and configs/production_vi_transducer.json, "
          "DecodeConfig's operating point, word LM from cli.create_lm",
          "ctc": ctc, "peaked_vs_host": peaked, "clis": clis, "rnnt": rnnt,
          "runs": runs, "sections_s": sections, "ok": ok})
    if not ok:
        raise SystemExit("beam_device phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 12: self-supervised pretraining (wav2vec2, BYOL) and the encoder
# transfer into supervised training.
# ---------------------------------------------------------------------------

PRETRAIN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "configs", "pretrain_wav2vec2.json")
# (method, seconds, conv_impl) at B 8: the 24 s batch takes K3 (2401 mel
# frames), BYOL's 16 rows a tower take K4a/K4b under conv_impl pallas.
PRETRAIN_CASES = (("wav2vec2", 8, "xla"), ("wav2vec2", 24, "xla"),
                  ("byol", 8, "pallas"))


def _pretrain_launches(method: str, seconds: int, conv_impl: str,
                       n_blocks: int) -> dict:
    """The kernels' launches in one production pretrain step under remat:
    the online blocks' forward and recomputation (K1 with dropout), their
    backward (K2) and, for BYOL, the target's forward (K1 without)."""
    target = n_blocks if method == "byol" else 0
    pallas = conv_impl == "pallas"
    return {"sincos_attention_fwd": 2 * n_blocks + target,
            "sincos_attention_fwd_dropout": 2 * n_blocks,
            "sincos_attention_bwd": n_blocks,
            "logmel_fwd": 1 if seconds >= 16 else 0,
            "depthwise_conv_fwd": (3 * n_blocks + target) if pallas else 0,
            "depthwise_conv_dw": n_blocks if pallas else 0}


def _pretrain_setup(torch, method: str, seconds: int, conv_impl: str):
    """-> (config, model on the card, its step, audio, lengths): Config()
    with pretrain.method, Adam at learning rate 0, a seeded B 8 batch."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.train.pretrain import (build_pretrain_model,
                                                    make_pretrain_step)
    from conformer_tpu_torch.train.state import make_optimizer

    dev = torch.device(DEVICE)
    cfg = Config().override(**{"pretrain.method": method,
                               "model.conv_impl": conv_impl,
                               "optim.learning_rate": 0.0})
    model = build_pretrain_model(cfg, seed=0).to(dev)
    step = make_pretrain_step(cfg, model,
                              make_optimizer(cfg.optim, model.parameters()))
    audio, lengths = _noise_batch(torch, 8, seconds, seed=300 + seconds)
    return cfg, model, step, audio.to(dev), lengths.to(dev)


def pretrain_step_case(torch, method: str, seconds: int, conv_impl: str):
    """One production pretrain step (Config(): bf16, dropout 0.1, remat,
    SpecAugment for BYOL, Adam at learning rate 0) from the same state and
    the same draws: warm-up, then through the kernels three times (the
    first counted, the median wall kept; peak memory beside what was
    allocated before) and through their plain versions. The profile phase
    profiles it."""
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cfg, model, step, audio, lengths = _pretrain_setup(torch, method,
                                                       seconds, conv_impl)
    start = {k: v.clone() for k, v in model.state_dict().items()}

    def run(patches=()):
        model.load_state_dict(start)
        out, ms = _run(torch, lambda: step(audio, lengths, 7), patches)
        return {k: float(v) for k, v in out.items()}, ms

    run()                                          # warm-up
    before_gb = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    k, first_ms = run()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    walls = sorted([first_ms] + [run()[1] for _ in range(2)])
    k_ms = walls[1]                                # the median of three
    p, p_ms = run(_plain_versions())
    del model, step, start
    torch.cuda.empty_cache()
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    tol = TOL_TRAIN["bfloat16"]
    want = _pretrain_launches(method, seconds, conv_impl,
                              cfg.model.n_blocks)
    ok = (all(math.isfinite(v) for v in k.values())
          and rel(k["loss"], p["loss"]) <= tol["loss"]
          and rel(k["grad_norm"], p["grad_norm"]) <= tol["grad_norm"]
          and all(counts[n] == want[n] for n in want))
    return {"method": method, "seconds": seconds, "conv_impl": conv_impl,
            "kernels": k, "plain": p,
            "loss_rel_diff": rel(k["loss"], p["loss"]),
            "grad_norm_rel_diff": rel(k["grad_norm"], p["grad_norm"]),
            "tolerance": {"loss": tol["loss"], "grad_norm": tol["grad_norm"]},
            "step_ms": k_ms, "step_ms_runs": walls, "plain_step_ms": p_ms,
            "audio_s_per_s": k["audio_seconds"] / (k_ms / 1e3),
            "peak_memory_gb": peak_gb, "allocated_before_gb": before_gb,
            "launches": counts,
            "expected_launches": want, "ok": ok}


def _encoder_equals_checkpoint(torch, model, ck: str) -> dict:
    """The supervised model's encoder parameters against the newest
    wav2vec2 checkpoint in ``ck`` (its subsample, input_proj, blocks)."""
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(ck)
    saved = torch.load(mgr._path(mgr.latest_step()), map_location="cpu",
                       weights_only=True)["model"]
    params = dict(model.encoder.named_parameters())
    equal = [torch.equal(p.detach().cpu(), saved[n])
             for n, p in params.items()]
    return {"checkpoint_step": mgr.latest_step(), "parameters": len(params),
            "equal": sum(equal), "all_equal": all(equal)}


def phase_pretrain(torch, tmp: str):
    """-> launch counts of the driven runs."""
    from conformer_tpu_torch.cli import pretrain, train
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.train import trainer as trainer_mod

    total = {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    cases = [pretrain_step_case(torch, *case) for case in PRETRAIN_CASES]
    for case in cases:
        add(case["launches"])
    manifest, paths = _write_manifest(tmp, "train", TRAIN_SECONDS, seed=1)
    unlabelled = os.path.join(tmp, "unlabelled.csv")
    with open(unlabelled, "w", newline="", encoding="utf8") as f:
        csv.writer(f).writerows([["path"]] + [[p] for p in paths])
    ck = os.path.join(tmp, "pre")
    argv = ["--manifest", unlabelled, "--method", "wav2vec2",
            "--config", PRETRAIN_CONFIG, "--checkpoint-dir", ck,
            "--device", DEVICE, "--set", "data.batch_size=8",
            "--set", "train.checkpoint_every_steps=2",
            "--set", "train.log_every_steps=1",
            "--set", "train.num_epochs=100"]
    runs = []
    for num_steps in (4, 6):
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        runner = pretrain.main(argv + ["--set", f"train.num_steps={num_steps}"])
        wall = time.perf_counter() - t0
        counts = launch_counts()
        add(counts)
        runs.append({"num_steps": num_steps, "start_step": runner.start_step,
                     "end_step": runner.step, "wall_s": wall,
                     "launches": counts,
                     "checkpoints": sorted(os.listdir(ck))})
        del runner
    with open(os.path.join(ck, "metrics.jsonl"), encoding="utf8") as f:
        records = [json.loads(ln) for ln in f]
    steps = [{"step": r["step"],
              **{k: r.get(f"pretrain/{k}") for k in (
                  "loss", "contrastive", "diversity", "accuracy",
                  "perplexity", "grad_norm", "step_seconds",
                  "audio_seconds", "peak_memory_gb")}}
             for r in records if "pretrain/loss" in r]
    for s_ in steps:
        s_["audio_s_per_s"] = s_["audio_seconds"] / s_["step_seconds"]

    # the transfer: cli.train from the pretrain checkpoint, 2 steps; the
    # encoder is held against the checkpoint before step 1
    transfer = {}
    first_epoch = trainer_mod.Trainer.train_epoch

    def checked_epoch(self, *args, **kwargs):
        if not transfer:
            transfer.update(_encoder_equals_checkpoint(torch, self.model, ck))
            print(f"[pretrain phase] encoder before step 1 equals the "
                  f"checkpoint's: {transfer['all_equal']} "
                  f"({transfer['equal']}/{transfer['parameters']})",
                  flush=True)
        return first_epoch(self, *args, **kwargs)

    reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(trainer_mod.Trainer, "train_epoch", checked_epoch):
        trainer = train.main([
            "--train-manifest", manifest, "--checkpoint-dir",
            os.path.join(tmp, "sup"), "--device", DEVICE,
            "--init-encoder-from", ck, "--init-method", "wav2vec2",
            "--set", "data.batch_size=8", "--set", "train.num_steps=2",
            "--set", "train.log_every_steps=1",
            "--set", "train.num_epochs=100"])
    sup = {"wall_s": time.perf_counter() - t0, "end_step": trainer.step,
           "launches": launch_counts(), **transfer}
    add(sup["launches"])
    del trainer
    torch.cuda.empty_cache()
    ok = (all(c["ok"] for c in cases)
          and [(r["start_step"], r["end_step"]) for r in runs]
          == [(0, 4), (4, 6)]
          and [s_["step"] for s_ in steps] == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(s_["loss"]) and math.isfinite(s_["grad_norm"])
                  for s_ in steps)
          and all(r["launches"]["logmel_fwd"] > 0 for r in runs)
          and sup["end_step"] == 2 and sup.get("all_equal") is True
          and sup["launches"]["sincos_attention_bwd"] > 0)
    emit({"phase": "pretrain", "config": "Config() production (17 blocks, "
          "d_model 512, bf16, remat, dropout 0.1), pretrain defaults (proj "
          "256, 2 x 320 codes, negatives 'all', predictor 1024), B=8; "
          "cli.pretrain on configs/pretrain_wav2vec2.json, batch 32 -> 8",
          "steps_kernels_vs_plain": cases, "cli_pretrain": {
              "runs": runs, "steps": steps}, "cli_train_transfer": sup,
          "ok": ok})
    if not ok:
        raise SystemExit("pretrain phase failed")
    return total


# ---------------------------------------------------------------------------
# Phase 13: the mesh (parallel/mesh.py): DP x TP with SP, ZeRO-1 and
# cross-replica BatchNorm, four ranks on the one card.
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 4
# Config() at the production width; its depth cut from 17 to
# PARALLEL_BLOCKS blocks for time (the shard shapes do not depend on it)
PARALLEL_BLOCKS = 4
PARALLEL_MESH = ["--dp", "2", "--tp", "2", "--set", "model.conv_impl=pallas",
                 "--set", "parallel.zero=true", "--set", "model.seq_shard=true",
                 "--set", f"model.n_blocks={PARALLEL_BLOCKS}"]
# The agreement check: fp32 at the production widths, dropout 0, on the
# mesh and in one process on the same weights and batch; its depth cut to
# AGREE_BLOCKS for time (the shard shapes do not depend on it). The
# gradients of step 1 are held directly; the parameters after 2 steps of
# Adam at a learning rate of 1e-3 with eps 1.0: Adam's update of an element
# whose gradient is near zero moves by lr * dg / eps for a gradient
# difference dg, and this random model's fp32 gradients (norm ~2e4) differ
# by up to ~1e-4 between two summation orders (at eps 1e-3 the parameters
# read 2.1e-4 apart on an H100, the losses 1.6e-6).
AGREE_BLOCKS = 2
AGREE = {"optim.compute_dtype": "float32", "model.dropout_rate": 0.0,
         "model.conv_impl": "pallas", "parallel.zero": True,
         "model.seq_shard": True, "model.n_blocks": AGREE_BLOCKS,
         "optim.learning_rate": 1e-3, "optim.eps": 1.0,
         "model.vocab_size": 370}
AGREE_ROWS, AGREE_SECONDS = 8, 8.0
# Parameters as the CPU tests hold the mesh. Step 1's gradients relative
# to each tensor's largest element (floored, see phase_parallel): fp32
# sums over the batch's positions taken in another order (two data ranks'
# partial sums, SP's reduce-scatters), 8.4e-5 at most on an H100, where a
# missing or doubled reduction reads 0.5 or more. The BatchNorm
# statistics relative to each tensor's largest (global sums of x and x^2
# in another order: E[x^2] - E[x]^2 cancels).
TOL_AGREE = {"loss_rtol": 2e-4, "grad_rtol": 1e-3, "param_atol": 1e-5,
             "stats_rtol": 1e-4}
# A rank's shapes at dp 2 x tp 2 on the train phase's batches of 8 in the
# 24 s bucket: 4 rows, L 599 (K1/K2: H 4 of dh 64, packed D 256, position
# width 512; K4a/K4b: C 256).
SHARD_B, SHARD_L, SHARD_H, SHARD_C = 4, 599, 4, 256
NCCL_TIMEOUT_S = 120
WORKER_TIMEOUT_S = 900
# A sharded search's scores against one process's: bit for bit expected
# (exactly one rank adds a non-zero term to each probe sum); otherwise at
# most this, as tests/test_device_lm.py holds the JAX package's.
TOL_SHARDED_SCORE = 1e-5
# The mesh's fp32 log-probs against one process's: another summation order
# (the row-parallel products' sums over the model group) and other kernels
# for another batch size round differently.
TOL_LAYOUT_LOG_PROBS = 1e-4


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_ranks(kind: str, ranks: int, tmp: str, extra: dict) -> list:
    """Start ``ranks`` worker processes of this script (``--worker``), each
    with a spec, a log and a result file in ``tmp``."""
    port, procs = _free_port(), []
    for r in range(ranks):
        spec = {"kind": kind, "rank": r, "world": ranks, "port": port,
                "out": os.path.join(tmp, f"{kind}{r}.json"), **extra}
        path = os.path.join(tmp, f"{kind}{r}.spec.json")
        with open(path, "w", encoding="utf8") as f:
            json.dump(spec, f)
        log = open(os.path.join(tmp, f"{kind}{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", path],
            stdout=log, stderr=subprocess.STDOUT), log, spec["out"]))
    return procs


def _finish_ranks(procs: list, timeout: float) -> list:
    """-> the started ranks' results (None where a rank wrote none); a rank
    still running at ``timeout`` is killed."""
    t_end, results = time.monotonic() + timeout, []
    for proc, log, out in procs:
        try:
            proc.wait(timeout=max(t_end - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        result = None
        if os.path.exists(out):
            with open(out, encoding="utf8") as f:
                result = json.load(f)
        results.append(result)
    return results


def _tail(tmp: str, name: str, n: int = 1500) -> str:
    with open(os.path.join(tmp, name), encoding="utf8", errors="replace") as f:
        return f.read()[-n:]


def _agree_batch(torch):
    """Seeded audio and transcripts of the agreement check, on the card."""
    import numpy as np

    rng = np.random.default_rng(17)
    n = int(AGREE_SECONDS * 16000)
    audio = (rng.standard_normal((AGREE_ROWS, n)) * 0.1).astype(np.float32)
    lengths = rng.integers(n // 2, n + 1, AGREE_ROWS)
    audio[np.arange(n)[None] >= lengths[:, None]] = 0.0
    token_lengths = rng.integers(10, 40, AGREE_ROWS)
    tokens = rng.integers(1, 370, (AGREE_ROWS, 40))
    tokens[np.arange(40)[None] >= token_lengths[:, None]] = 0
    return audio, lengths, tokens, token_lengths


def _agree_steps(torch, mesh):
    """Two fp32 steps of AGREE on the agreement batch (this rank's stripe
    under ``mesh``) -> (global losses, the single-device state_dict on the
    CPU, step 1's whole gradients on the CPU)."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.parallel.mesh import (batch_stripe,
                                                   full_state_dict,
                                                   gather_tensor,
                                                   shard_model)
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_train_step

    cfg = Config().override(**AGREE)
    model = build_model(cfg.model, "float32", seed=0)
    if mesh is not None:
        shard_model(model, mesh, cfg.model)
    model = model.to(DEVICE)
    opt = make_optimizer(cfg.optim, model.parameters(), 10, mesh,
                         zero=cfg.parallel.zero)
    step = make_train_step(cfg, model, opt, mesh=mesh)
    args = [torch.from_numpy(a).to(DEVICE)
            for a in batch_stripe(_agree_batch(torch), mesh)]
    losses = [float(step(*args, 0)["loss"])]
    grads = {n: (p.grad if mesh is None else gather_tensor(
        p.grad, p.tp_spec, mesh.model_group)).cpu()
        for n, p in model.named_parameters()}
    losses.append(float(step(*args, 1)["loss"]))
    state = {k: v.detach().cpu() for k, v in
             full_state_dict(model, mesh).items()}
    return losses, state, grads


def _mesh_cli_runs(torch, spec: dict) -> list:
    """This rank's share of ``cli.train`` on the 2 x 2 mesh: 4 steps with a
    checkpoint every 2, then resumed to 6; each run's launches (counts set
    to 0 just before it), wall, steps and peak memory."""
    from conformer_tpu_torch.cli import train
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    argv = ["--train-manifest", spec["manifest"], "--checkpoint-dir",
            spec["ck"], "--device", DEVICE, "--set", "data.batch_size=8",
            "--set", "train.checkpoint_every_steps=2",
            "--set", "train.log_every_steps=1",
            "--set", "train.num_epochs=100", *PARALLEL_MESH]
    from conformer_tpu_torch.train.trainer import Trainer

    fit = Trainer.fit

    def timed_fit(self):        # the training loop alone, set-up aside
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(self)
        torch.cuda.synchronize()
        self.fit_seconds = time.perf_counter() - t0

    runs = []
    for num_steps in (4, 6):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(Trainer, "fit", timed_fit):
            trainer = train.main(argv + ["--set",
                                         f"train.num_steps={num_steps}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        steps = trainer.step - trainer.start_step
        runs.append({"num_steps": num_steps, "start_step": trainer.start_step,
                     "end_step": trainer.step, "wall_s": wall,
                     "fit_s": trainer.fit_seconds,
                     "step_wall_s": trainer.fit_seconds / max(steps, 1),
                     "peak_memory_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "launches": counts})
        del trainer
        torch.cuda.empty_cache()
    return runs


# The mesh for decoding and pretraining: the pretraining steps'
# agreement at AGREE's settings (fp32, dropout 0, 2 blocks, K4 on channel
# shards, ZeRO-1, SP), Config()'s pretrain defaults otherwise.
PRETRAIN_AGREE_METHODS = ("wav2vec2", "byol")
PRETRAIN_AGREE_STEPS = 2


def _beam_test_argv(manifest: str, ck: str, arpa: str) -> list:
    """cli.test through the CTC device search with the word LM and the
    hotword, in fp32: bf16 logits differ between layouts (another summation
    order, other kernels for another batch) by more than a random model's
    beam margins."""
    return ["--manifest", manifest, "--checkpoint-dir", ck, "--device",
            DEVICE, "--lm", arpa, "--decode", "beam_device",
            "--set", f'decode.hotwords=["{HOTWORD}"]',
            "--set", "optim.compute_dtype=float32"]


def _cli_test_kept(torch, argv: list):
    """``cli.test.main(argv)`` with the pipeline keeping each batch's
    log-probs and lengths on the host -> (metrics, [(log_probs, lengths)]
    a batch: under a mesh this rank's stripe, the pipeline)."""
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.decode.pipeline import InferencePipeline

    pipes = []
    evaluate = InferencePipeline.evaluate

    def kept(self, *args, **kwargs):
        pipes.append(self)
        return evaluate(self, *args, **kwargs)

    with mock.patch.object(InferencePipeline, "evaluate", kept), \
            mock.patch.object(InferencePipeline, "keep_outputs", True):
        metrics = cli_test.main(argv)
    return metrics, [(e["log_probs"], e["lengths"])
                     for e in pipes[0].batch_log], pipes[0]


def _mesh_cli_test(torch, spec: dict) -> dict:
    """This rank's share of ``cli.test --dp 2 --tp 2 --lm --decode
    beam_device`` on the mesh's checkpoint (rank 0 writes the results);
    its stripes' log-probs go to ``spec["mesh_log_probs"]``."""
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics, kept, _ = _cli_test_kept(
        torch, _beam_test_argv(spec["manifest"], spec["ck"], spec["arpa"])
        + ["--dp", "2", "--tp", "2", "--results", spec["mesh_results"]])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    import torch.distributed as dist

    torch.save(kept, spec["mesh_log_probs"].format(rank=dist.get_rank()))
    return {"metrics": metrics, "wall_s": wall, "launches": launch_counts()}


def _transducer_search_setup(torch, t_ck: str, arpa: str, mesh=None):
    """The transducer's joint, prediction step and beam kwargs at the
    reference's operating point (beam 190, the word LM, the hotword), its
    tables split over ``mesh``'s model group."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.text.tokenizer import load_tokenizer
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    tok = load_tokenizer("vi")
    t_cfg = Config.from_json(os.path.join(t_ck, "config.json")).override(
        **{"decode.lm_path": arpa, "decode.hotwords": [HOTWORD],
           "decode.beam_width": RNNT_BEAM_WIDTH})
    model = build_model(t_cfg.model, t_cfg.optim.compute_dtype, seed=None)
    CheckpointManager(t_ck).restore(model)
    model = model.to(DEVICE).eval()
    return model, _rnnt_beam_kwargs(t_cfg, tok, torch.device(DEVICE), mesh)


def _searches(torch, spec: dict, mesh=None) -> "tuple[dict, dict]":
    """The CTC search on the beam_device phase's contended B 8 x 599 batch
    and the RNN-T search on the transducer's B 8 x 8 s encodings
    (``spec["t_enc"]``), at the reference's operating point: sharded over
    ``mesh`` (this rank's stripe) or in one process. -> (the outputs on the
    CPU, walls and the frame steps' mode)."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.ops.beam_search_device import (
        ctc_beam_search_device_sharded)
    from conformer_tpu_torch.ops.rnnt import rnnt_beam_search_sharded
    from conformer_tpu_torch.parallel.collectives import capturable
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    dev = torch.device(DEVICE)
    tok = load_tokenizer("vi")
    cfg = Config().override(**{"decode.lm_path": spec["arpa"],
                               "decode.hotwords": [HOTWORD]})
    b, t = BEAM_CONTENDED
    lp = torch.from_numpy(contended_log_probs(tok.vocab_size, tok.pad_id, b,
                                              t, seed=9)).to(dev)
    kw = _ctc_beam_kwargs(torch, cfg, tok, dev, mesh)
    out, info = {}, {"frame_steps": "graph"}
    if mesh is not None and not capturable(mesh.model_group):
        info["frame_steps"] = "eager"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["ctc"] = ctc_beam_search_device_sharded(lp, None, mesh=mesh, **kw)
    torch.cuda.synchronize()
    info["ctc_wall_s"] = time.perf_counter() - t0
    model, r_kw = _transducer_search_setup(torch, spec["t_ck"], spec["arpa"],
                                           mesh)
    enc, enc_len = (x.to(dev) for x in torch.load(spec["t_enc"]))
    joint_fn, pred_step_fn = model.frame_fns()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out["rnnt"] = rnnt_beam_search_sharded(
        joint_fn, enc, enc_len, pred_step_fn,
        model.predict_init(enc.shape[0], dev), mesh=mesh, **r_kw)
    torch.cuda.synchronize()
    info["rnnt_wall_s"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    return ({k: [x.cpu() for x in v] for k, v in out.items()}, info)


def _pretrain_agree(torch, mesh=None) -> "tuple[dict, dict]":
    """PRETRAIN_AGREE_STEPS wav2vec2 and BYOL steps at AGREE's settings on
    the agreement batch (this rank's stripe under ``mesh``), every draw at
    the global batch -> ({method: the single-device state_dict on the
    CPU}, {method: losses, step walls, peak memory})."""
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.parallel.mesh import (batch_stripe,
                                                   full_state_dict,
                                                   shard_model)
    from conformer_tpu_torch.train.pretrain import (build_pretrain_model,
                                                    make_pretrain_step)
    from conformer_tpu_torch.train.state import make_optimizer

    audio, lengths = batch_stripe(_agree_batch(torch)[:2], mesh)
    audio = torch.from_numpy(audio).to(DEVICE)
    lengths = torch.from_numpy(lengths).to(DEVICE)
    states, info = {}, {}
    for method in PRETRAIN_AGREE_METHODS:
        cfg = Config().override(**AGREE, **{"pretrain.method": method})
        model = build_pretrain_model(cfg, seed=0)
        if mesh is not None:
            shard_model(model, mesh, cfg.model)
        model = model.to(DEVICE)
        opt = make_optimizer(cfg.optim, model.parameters(), 10, mesh,
                             zero=cfg.parallel.zero)
        step = make_pretrain_step(cfg, model, opt, mesh=mesh)
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for i in range(PRETRAIN_AGREE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(audio, lengths, i)["loss"]))
            walls.append(time.perf_counter() - t0)
        info[method] = {"losses": losses, "step_wall_s": walls,
                        "peak_memory_gb":
                            torch.cuda.max_memory_allocated() / 1e9}
        states[method] = {k: v.detach().cpu() for k, v in
                          full_state_dict(model, mesh).items()}
        del model, opt, step
        torch.cuda.empty_cache()
    return states, info


def _pretrain_argv(spec: dict) -> list:
    """cli.pretrain on configs/pretrain_wav2vec2.json (batch 32 -> 8) at
    PARALLEL_BLOCKS blocks, checkpoints every 2 steps."""
    return ["--manifest", spec["unlabelled"], "--method", "wav2vec2",
            "--config", PRETRAIN_CONFIG, "--checkpoint-dir", spec["pre_ck"],
            "--device", DEVICE, "--set", "data.batch_size=8",
            "--set", "train.checkpoint_every_steps=2",
            "--set", "train.log_every_steps=1",
            "--set", "train.num_epochs=100",
            "--set", f"model.n_blocks={PARALLEL_BLOCKS}"]


def _mesh_pretrain_run(torch, spec: dict) -> dict:
    """This rank's share of ``cli.pretrain --dp 2 --tp 2`` (ZeRO-1, SP) for
    4 steps: its launches, wall, steps and peak memory."""
    from conformer_tpu_torch.cli import pretrain
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    runner = pretrain.main(_pretrain_argv(spec) + [
        "--dp", "2", "--tp", "2", "--set", "parallel.zero=true",
        "--set", "model.seq_shard=true", "--set", "train.num_steps=4"])
    torch.cuda.synchronize()
    run = {"start_step": runner.start_step, "end_step": runner.step,
           "wall_s": time.perf_counter() - t0,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launch_counts()}
    del runner
    torch.cuda.empty_cache()
    return run


def _worker(spec_path: str) -> int:
    """One rank of the parallel phase (``--worker SPEC``): ``nccl`` tries
    NCCL with every rank on card 0; ``mesh`` joins a gloo group of CUDA
    tensors, runs the agreement steps on the 2 x 2 mesh (rank 0 writes the
    state), its share of the cli.train runs and of cli.test with the device
    beam, the sharded CTC and RNN-T searches (each rank writes its
    stripe), the pretraining agreement steps (rank 0 writes the states)
    and its share of cli.pretrain."""
    with open(spec_path, encoding="utf8") as f:
        spec = json.load(f)
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(2)           # four ranks on the host's cores
    init = f"tcp://127.0.0.1:{spec['port']}"
    rank, world = spec["rank"], spec["world"]
    out = {"rank": rank}
    if spec["kind"] == "nccl":
        try:
            dev = torch.device("cuda", 0)
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", init_method=init, rank=rank,
                                    world_size=world, device_id=dev)
            t = torch.ones(1024, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            out.update(refused=False, sum=float(t[0]))
        except Exception as e:  # noqa: BLE001 (the refusal is the finding)
            out.update(refused=True, error=f"{type(e).__name__}: {e}"[:600])
        with open(spec["out"], "w", encoding="utf8") as f:
            json.dump(out, f)
        os._exit(0)       # NCCL may be left unusable: no teardown
    from conformer_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    mesh = make_mesh(2, 2, DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, state, grads = _agree_steps(torch, mesh)
    out["agree_losses"] = losses
    out["agree_wall_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save({"state": state, "grads": grads}, spec["agree_state"])
    del state, grads
    torch.cuda.empty_cache()
    out["runs"] = _mesh_cli_runs(torch, spec)
    out["test"] = _mesh_cli_test(torch, spec)
    searched, out["searches"] = _searches(torch, spec, mesh)
    torch.save(searched, spec["searches"].format(rank=rank))
    states, out["pretrain_agree"] = _pretrain_agree(torch, mesh)
    if rank == 0:
        torch.save(states, spec["pretrain_state"])
    del states
    out["pretrain_run"] = _mesh_pretrain_run(torch, spec)
    dist.barrier()
    dist.destroy_process_group()
    with open(spec["out"], "w", encoding="utf8") as f:
        json.dump(out, f)
    return 0


def _shard_kernels(torch) -> dict:
    """K1 (rates 0 and 0.1), K2 (rate 0.1), K4a and K4b at a rank's shapes,
    bf16 as the mesh runs launch them, and fp32 K1/K2 at the agreement
    check's (the general kernels), against their plain versions at the
    kernels phase's limits, timed beside their bounds."""
    from conformer_tpu_torch.config import AudioConfig

    b, l, h, c = SHARD_B, SHARD_L, SHARD_H, SHARD_C
    bf16, f32 = torch.bfloat16, torch.float32
    agree_l = _sub_frames(AudioConfig(), int(AGREE_SECONDS * 16000))
    return {
        "k1": [k1_case(torch, b, l, bf16, seed=60, time_it=True, h=h, dp=512),
               k1_case(torch, b, l, bf16, seed=61, time_it=True, rate=0.1,
                       h=h, dp=512),
               k1_case(torch, AGREE_ROWS // 2, agree_l, f32, seed=62,
                       time_it=False, h=h, dp=512)],
        "k2": [k2_case(torch, b, l, bf16, seed=63, rate=0.1, time_it=True,
                       h=h, dp=512),
               k2_case(torch, AGREE_ROWS // 2, agree_l, f32, seed=64, rate=0.0,
                       time_it=False, h=h, dp=512)],
        "k4a": [k4a_case(torch, b, l, bf16, seed=65, time_it=True, c=c)],
        "k4b": [k4b_case(torch, b, l, bf16, seed=66, time_it=True, c=c)],
    }


def _nccl_world_one(torch, arpa: str) -> dict:
    """One train step on a dp 1 x tp 1 mesh over a world-1 NCCL group (every
    collective of the step runs, on one rank) against the meshless step,
    from the same weights and batch: production Config() (bf16, dropout
    0.1 hash, SpecAugment, remat) at AGREE_BLOCKS blocks; the meshless step
    twice, so that a difference of the kernels' own between two runs would
    show. Then the CTC device search on the contended batch at the
    reference's operating point with the LM probes' sum over the group
    issued (a TableShard of the whole table over the world-1 model group):
    through the frame graph, the NCCL all-reduce captured in it, against
    the meshless graph, bit for bit."""
    import torch.distributed as dist

    from conformer_tpu_torch.lm.device_table import TableShard
    from conformer_tpu_torch.ops import frame_graph
    from conformer_tpu_torch.ops.beam_search_device import (
        ctc_beam_search_device, frame_mode)
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.parallel.mesh import make_mesh, shard_model
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import make_train_step

    dev = torch.device("cuda", 0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_mesh(1, 1, DEVICE)
        cfg = Config().override(**{"model.n_blocks": AGREE_BLOCKS,
                                   "model.vocab_size": 370})
        args = [torch.from_numpy(a).to(DEVICE) for a in _agree_batch(torch)]
        runs = {}
        for name, m in (("meshless", None), ("mesh", mesh),
                        ("meshless_again", None)):
            model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0)
            if m is not None:
                shard_model(model, m, cfg.model)
            model = model.to(DEVICE)
            opt = make_optimizer(cfg.optim, model.parameters(), 10, m)
            metrics = make_train_step(cfg, model, opt, mesh=m)(*args, 0)
            runs[name] = ([metrics["loss"].cpu(), metrics["grad_norm"].cpu()],
                          {k: v.cpu() for k, v in model.state_dict().items()})
            del model, opt
        torch.cuda.empty_cache()
        tok = load_tokenizer("vi")
        b, t = BEAM_CONTENDED
        lp = torch.from_numpy(contended_log_probs(
            tok.vocab_size, tok.pad_id, b, t, seed=9)).to(DEVICE)
        kw = _ctc_beam_kwargs(torch, Config().override(**{
            "decode.lm_path": arpa, "decode.hotwords": [HOTWORD]}), tok,
            torch.device(DEVICE))
        shard = TableShard(0, kw["lm_tables"].n_slots, mesh.model_group)
        frame_graph.clear_cache()
        meshless = ctc_beam_search_device(lp, **kw)
        graphs = len(frame_graph.capture_seconds())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        summed = ctc_beam_search_device(lp, lm_shard=shard, **kw)
        torch.cuda.synchronize()
        search = {"frame_steps": frame_mode(shard),
                  "graphs_captured": len(frame_graph.capture_seconds())
                  - graphs, "wall_s": time.perf_counter() - t0,
                  "bit_for_bit": all(torch.equal(x, y)
                                     for x, y in zip(summed, meshless))}
        frame_graph.clear_cache()
    finally:
        dist.destroy_process_group()

    def equal(a, b):
        (ma, sa), (mb, sb) = runs[a], runs[b]
        return (all(torch.equal(x, y) for x, y in zip(ma, mb))
                and all(torch.equal(sa[k], sb[k]) for k in sa))

    return {"backend": "nccl", "world": 1, "loss": float(runs["mesh"][0][0]),
            "mesh_equals_meshless": equal("mesh", "meshless"),
            "meshless_twice_equal": equal("meshless", "meshless_again"),
            "ctc_search_sum_captured": search}


def phase_parallel(torch, tmp: str):
    """-> launch counts of the mesh's runs (cli.train, cli.test with the
    device beam, cli.pretrain), over all ranks, and of this process's."""
    import numpy as np

    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.cli import train
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    parts, t_part = {}, time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        parts[name] = now - t_part
        t_part = now

    shard = _shard_kernels(torch)           # timed with the card to itself
    part("shard_kernels")
    manifest, paths = _write_manifest(tmp, "train", TRAIN_SECONDS, seed=1)
    unlabelled = os.path.join(tmp, "unlabelled.csv")
    with open(unlabelled, "w", newline="", encoding="utf8") as f:
        csv.writer(f).writerows([["path"]] + [[p_] for p_ in paths])
    arpa, _ = _beam_lm(tmp, np.random.default_rng(5))
    # the transducer's B 8 x 8 s encodings for the RNN-T searches
    t_ck, t_from = _transducer_ck(torch, tmp)
    t_model, _ = _transducer_search_setup(torch, t_ck, arpa)
    t_enc = os.path.join(tmp, "t_enc.pt")
    torch.save([x.cpu() for x in _encode(
        torch, t_model, Config.from_json(os.path.join(t_ck, "config.json")),
        *_noise_batch(torch, 8, 8, seed=98))], t_enc)
    del t_model
    torch.cuda.empty_cache()
    part("setup")
    # the ranks start while this process takes the single-process reference
    ck = os.path.join(tmp, "ck")
    spec = {"manifest": manifest, "ck": ck, "arpa": arpa,
            "agree_state": os.path.join(tmp, "agree_mesh.pt"),
            "mesh_results": os.path.join(tmp, "results_mesh.csv"),
            "t_ck": t_ck, "t_enc": t_enc,
            "searches": os.path.join(tmp, "searches{rank}.pt"),
            "mesh_log_probs": os.path.join(tmp, "mesh_log_probs{rank}.pt"),
            "pretrain_state": os.path.join(tmp, "pretrain_mesh.pt"),
            "unlabelled": unlabelled, "pre_ck": os.path.join(tmp, "pre")}
    nccl_procs = _start_ranks("nccl", 2, tmp, {})
    mesh_procs = _start_ranks("mesh", PARALLEL_RANKS, tmp, spec)
    ref_losses, ref_state, ref_grads = _agree_steps(torch, None)
    torch.cuda.empty_cache()
    ref_searched, ref_search_info = _searches(torch, spec)
    ref_pre_states, ref_pre = _pretrain_agree(torch)
    nccl = _finish_ranks(nccl_procs, NCCL_TIMEOUT_S)
    nccl_found = {"ranks": nccl, "refused": any(
        r is None or r.get("refused") for r in nccl)}
    ranks = _finish_ranks(mesh_procs, WORKER_TIMEOUT_S)
    part("ranks_and_reference")
    if any(r is None for r in ranks):
        emit({"phase": "parallel", "ok": False, "rank_logs": {
            i: _tail(tmp, f"mesh{i}.log") for i in range(PARALLEL_RANKS)}})
        raise SystemExit("parallel phase failed: a rank did not finish")
    from conformer_tpu_torch.models.conformer import build_model

    saved = torch.load(spec["agree_state"])
    mesh_state, mesh_grads = saved["state"], saved["grads"]
    names = {n for n, _ in build_model(Config().override(**AGREE).model,
                                       "float32", seed=None).named_parameters()}
    errs = {k: float((mesh_state[k].float() - v.float()).abs().max())
            for k, v in ref_state.items()}
    # each gradient relative to its own largest element, floored at
    # K2_FLOOR of the model's largest (a bias before a BatchNorm, or the
    # attention's key bias, has a gradient of 0 up to rounding)
    floor = K2_FLOOR * max(float(g.abs().max()) for g in ref_grads.values())
    grad_rel = {k: float((mesh_grads[k] - g).abs().max())
                / max(float(g.abs().max()), floor)
                for k, g in ref_grads.items()}
    stats_rel = {k: errs[k] / max(float(v.float().abs().max()), 1e-30)
                 for k, v in ref_state.items() if k not in names}
    param_err = max(errs[k] for k in names)
    worst = sorted(names, key=errs.get)[-3:]
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(ranks[0]["agree_losses"], ref_losses))
    agreement = {"config": f"Config() fp32, {AGREE_BLOCKS} blocks, dropout 0, "
                 "conv_impl pallas, zero, seq_shard; B 8 x 8 s, 2 steps",
                 "single_process_losses": ref_losses,
                 "mesh_losses": [r["agree_losses"] for r in ranks],
                 "mesh_wall_s": [r["agree_wall_s"] for r in ranks],
                 "loss_rel_err": loss_rel,
                 "grad_max_rel_err": max(grad_rel.values()),
                 "worst_grads": {k: grad_rel[k] for k in
                                 sorted(grad_rel, key=grad_rel.get)[-3:]},
                 "param_max_abs_err": param_err,
                 "worst_params": {k: errs[k] for k in worst},
                 "stats_max_rel_err": max(stats_rel.values()),
                 **TOL_AGREE,
                 "ok": (loss_rel <= TOL_AGREE["loss_rtol"]
                        and max(grad_rel.values()) <= TOL_AGREE["grad_rtol"]
                        and param_err <= TOL_AGREE["param_atol"]
                        and max(stats_rel.values())
                        <= TOL_AGREE["stats_rtol"])}

    total = {}
    for r in ranks:
        for run in r["runs"]:
            for key, n in run["launches"].items():
                total[key] = total.get(key, 0) + n
    with open(os.path.join(ck, "metrics.jsonl"), encoding="utf8") as f:
        records = [json.loads(ln) for ln in f]
    steps = [{"step": x["step"], "loss": x["train/ctc_loss"],
              "grad_norm": x["train/grad_norm"],
              "step_seconds": x["train/step_seconds"],
              "peak_memory_gb": x.get("train/peak_memory_gb")}
             for x in records if "train/ctc_loss" in x]

    decode = _decode_agreement(torch, tmp, spec, ranks, ref_searched,
                               ref_search_info)
    for r in ranks:
        for key, n in r["test"]["launches"].items():
            total[key] = total.get(key, 0) + n
    part("decode")
    pre = _pretrain_agreement(torch, tmp, spec, ranks, ref_pre_states,
                              ref_pre)
    for key, n in pre.pop("launches").items():
        total[key] = total.get(key, 0) + n
    part("pretrain")

    # resumed at dp 1 in this process, then scored
    reset_launch_counts()
    t0 = time.perf_counter()
    single = train.main(["--train-manifest", manifest, "--checkpoint-dir", ck,
                         "--device", DEVICE, "--dp", "1",
                         "--set", "train.num_steps=7"])
    dp1 = {"start_step": single.start_step, "end_step": single.step,
           "wall_s": time.perf_counter() - t0, "launches": launch_counts()}
    part("resume_dp1")
    del single
    torch.cuda.empty_cache()
    results = os.path.join(tmp, "results.csv")
    scored = cli_test.main(["--manifest", manifest, "--checkpoint-dir", ck,
                            "--device", DEVICE, "--results", results])
    with open(results, newline="", encoding="utf8") as f:
        scored_rows = len(list(csv.reader(f))) - 1
    part("cli_test")

    world_one = _nccl_world_one(torch, arpa)
    part("nccl_world_one")

    kernels_ok = all(case["ok"] for cases in shard.values() for case in cases)
    per_rank = [{"rank": r["rank"], "runs": [
        {k: run[k] for k in ("num_steps", "start_step", "end_step", "wall_s",
                             "fit_s", "step_wall_s", "peak_memory_gb")}
        for run in r["runs"]]} for r in ranks]
    need = ("sincos_attention_fwd", "sincos_attention_fwd_dropout",
            "sincos_attention_bwd", "logmel_fwd", "depthwise_conv_fwd",
            "depthwise_conv_dw")
    ok = (kernels_ok and nccl_found["refused"] and agreement["ok"]
          and all(run["start_step"] == start and run["end_step"] == end
                  for r in ranks
                  for run, (start, end) in zip(r["runs"], ((0, 4), (4, 6))))
          and [s["step"] for s in steps] == [1, 2, 3, 4, 5, 6]
          and all(math.isfinite(s["loss"]) for s in steps)
          and all(total.get(k, 0) > 0 for k in need)
          and (dp1["start_step"], dp1["end_step"]) == (6, 7)
          and dp1["launches"]["sincos_attention_bwd"] > 0
          and scored_rows == len(TRAIN_SECONDS)
          and math.isfinite(scored.get("loss", float("nan")))
          and world_one["mesh_equals_meshless"]
          and world_one["ctc_search_sum_captured"]["bit_for_bit"]
          and world_one["ctc_search_sum_captured"]["frame_steps"] == "graph"
          and world_one["ctc_search_sum_captured"]["graphs_captured"] >= 1
          and decode["ok"] and pre["ok"])
    emit({"phase": "parallel",
          "note": "four ranks share one card: correctness, not scaling",
          "mesh": f"Config() at {PARALLEL_BLOCKS} blocks, dp 2 x tp 2, gloo "
                  "on CUDA tensors (all_gather and reduce_scatter built from "
                  "all_reduce), zero, seq_shard, conv_impl pallas",
          "shard_kernels": shard, "nccl_two_ranks_one_card": nccl_found,
          "agreement": agreement, "per_rank": per_rank, "steps": steps,
          "launches": total, "resumed_dp1": dp1, "seconds": parts,
          "cli_test": {"rows": scored_rows, **{k: scored.get(k) for k in
                                               ("wer", "cer", "loss")}},
          "nccl_world_one": world_one, "decode": decode, "pretrain": pre,
          "transducer_checkpoint": t_from, "ok": ok})
    if not ok:
        raise SystemExit("parallel phase failed")
    return total


def _decode_agreement(torch, tmp: str, spec: dict, ranks: list,
                      ref_searched: dict, ref_info: dict) -> dict:
    """The mesh's searches and cli.test against this process's: every
    rank's stripe of the CTC and RNN-T outputs (prefixes and lengths equal,
    scores bit for bit or within TOL_SHARDED_SCORE), and ``cli.test --lm
    --decode beam_device`` in one process (graph) against the mesh's
    metrics and results file (or, where a row differs, the mesh's text
    against the one-process search on the mesh's own log-probs)."""
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    searches = {}
    for kind in ("ctc", "rnnt"):
        worst, same, bits = 0.0, True, True
        for r in range(PARALLEL_RANKS):
            got = torch.load(spec["searches"].format(rank=r))[kind]
            b = ref_searched[kind][0].shape[0] // 2
            rows = slice((r // 2) * b, (r // 2 + 1) * b)
            want = [x[rows] for x in ref_searched[kind]]
            same = (same and torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]))
            bits = bits and torch.equal(got[2], want[2])
            worst = max(worst, float((got[2] - want[2]).abs().max()))
        searches[kind] = {
            "prefixes_and_lengths_equal": same, "scores_bit_for_bit": bits,
            "scores_max_abs_diff": worst,
            "rank_walls_s": [r["searches"][f"{kind}_wall_s"] for r in ranks],
            "one_process_wall_s": ref_info[f"{kind}_wall_s"],
            "ok": same and worst <= TOL_SHARDED_SCORE}
    one_results = os.path.join(tmp, "results_one.csv")
    reset_launch_counts()
    t0 = time.perf_counter()
    one, one_kept, one_pipe = _cli_test_kept(
        torch, _beam_test_argv(spec["manifest"], spec["ck"], spec["arpa"])
        + ["--results", one_results])
    one_run = {"wall_s": time.perf_counter() - t0,
               "launches": launch_counts(), "metrics": one}
    with open(one_results, encoding="utf8") as f, \
            open(spec["mesh_results"], encoding="utf8") as g:
        one_rows, mesh_rows = list(csv.reader(f)), list(csv.reader(g))
    mesh_metrics = [r["test"]["metrics"] for r in ranks]
    same = (one_rows == mesh_rows and all(
        m["wer"] == one["wer"] and m["cer"] == one["cer"]
        and abs(m["loss"] - one["loss"]) <= 1e-4 * abs(one["loss"])
        for m in mesh_metrics))
    test = {"one_process": one_run, "mesh_metrics": mesh_metrics,
            "mesh_walls_s": [r["test"]["wall_s"] for r in ranks],
            "results_equal": one_rows == mesh_rows, "metrics_equal": same}
    test.update(_mesh_texts_from_rounding(torch, spec, one_pipe, one_kept,
                                          mesh_rows))
    del one_pipe
    # equal; or, where a row differs, the mesh's text is the one-process
    # search's on the mesh's own log-probs, which differ from one process's
    # by the layouts' fp32 rounding alone
    test["ok"] = same or (test["rounding_explains"]
                          and test["log_prob_max_abs_diff"]
                          <= TOL_LAYOUT_LOG_PROBS)
    return {"frame_steps": [r["searches"]["frame_steps"] for r in ranks],
            "operating_point": "beam 190, K 8, alpha 2.1, beta 9.2, "
                               f"hotword {HOTWORD}, the word 5-gram",
            "searches": searches, "cli_test": test,
            "ok": all(x["ok"] for x in searches.values()) and test["ok"]
            and all(r["searches"]["frame_steps"] == "eager" for r in ranks)}


def _mesh_texts_from_rounding(torch, spec: dict, pipe, one_kept: list,
                              mesh_rows: list) -> dict:
    """The mesh's log-probs (data ranks' stripes of each batch, model index
    0) against one process's, and the one-process pipeline's search on
    them: do its texts equal the mesh's results?"""
    stripes = [torch.load(spec["mesh_log_probs"].format(rank=r))
               for r in range(0, PARALLEL_RANKS, 2)]
    worst, texts = 0.0, []
    for i, (one_lp, one_len) in enumerate(one_kept):
        lp = torch.cat([st[i][0] for st in stripes])
        lengths = torch.cat([st[i][1] for st in stripes])
        for row in range(len(lp)):
            n = int(one_len[row])
            if n:
                worst = max(worst, float((lp[row, :n] - one_lp[row, :n])
                                         .abs().max()))
        texts += pipe.texts_from_out({"log_probs": lp.to(DEVICE),
                                      "lengths": lengths.to(DEVICE)})
    hyps = [row[1] for row in mesh_rows[1:]]
    return {"log_prob_max_abs_diff": worst,
            "rows_differing_from_the_redecode": sum(
                a != b for a, b in zip(hyps, texts)),
            "rounding_explains": texts[:len(hyps)] == hyps}


def _pretrain_agreement(torch, tmp: str, spec: dict, ranks: list,
                        ref_states: dict, ref_info: dict) -> dict:
    """The mesh's wav2vec2 and BYOL steps against this process's (losses,
    parameters, the BYOL target's too, and the BatchNorm statistics), then
    the mesh's cli.pretrain checkpoint resumed at dp 1 to step 6 and
    ``cli.train --init-encoder-from`` it, the encoder held against the
    checkpoint's before step 1."""
    from conformer_tpu_torch.cli import pretrain, train
    from conformer_tpu_torch.config import Config
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.train import trainer as trainer_mod
    from conformer_tpu_torch.train.pretrain import build_pretrain_model

    mesh_states = torch.load(spec["pretrain_state"])
    agree = {}
    for method in PRETRAIN_AGREE_METHODS:
        names = {n for n, _ in build_pretrain_model(
            Config().override(**AGREE, **{"pretrain.method": method}),
            seed=None).named_parameters()}
        got, want = mesh_states[method], ref_states[method]
        errs = {k: float((got[k].float() - v.float()).abs().max())
                for k, v in want.items()}
        stats = [errs[k] / max(float(v.float().abs().max()), 1e-30)
                 for k, v in want.items() if k not in names
                 and v.is_floating_point()]
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(
            ranks[0]["pretrain_agree"][method]["losses"],
            ref_info[method]["losses"]))
        param_err = max(errs[k] for k in names)
        agree[method] = {
            "single_process_losses": ref_info[method]["losses"],
            "mesh_losses": [r["pretrain_agree"][method]["losses"]
                            for r in ranks],
            "loss_rel_err": loss_rel, "param_max_abs_err": param_err,
            "worst_params": {k: errs[k] for k in sorted(
                names, key=errs.get)[-3:]},
            "stats_max_rel_err": max(stats, default=0.0),
            "rank_step_wall_s": [r["pretrain_agree"][method]["step_wall_s"]
                                 for r in ranks],
            "rank_peak_memory_gb": [
                r["pretrain_agree"][method]["peak_memory_gb"] for r in ranks],
            "single_step_wall_s": ref_info[method]["step_wall_s"],
            "ok": (loss_rel <= TOL_AGREE["loss_rtol"]
                   and param_err <= TOL_AGREE["param_atol"]
                   and max(stats, default=0.0) <= TOL_AGREE["stats_rtol"])}
    launches = {}
    for r in ranks:
        for key, n in r["pretrain_run"]["launches"].items():
            launches[key] = launches.get(key, 0) + n
    reset_launch_counts()
    t0 = time.perf_counter()
    runner = pretrain.main(_pretrain_argv(spec) + [
        "--dp", "1", "--set", "train.num_steps=6"])
    resumed = {"start_step": runner.start_step, "end_step": runner.step,
               "wall_s": time.perf_counter() - t0}
    del runner
    transfer = {}
    first_epoch = trainer_mod.Trainer.train_epoch

    def checked_epoch(self, *args, **kwargs):
        if not transfer:
            transfer.update(_encoder_equals_checkpoint(torch, self.model,
                                                       spec["pre_ck"]))
        return first_epoch(self, *args, **kwargs)

    with mock.patch.object(trainer_mod.Trainer, "train_epoch", checked_epoch):
        trainer = train.main([
            "--train-manifest", spec["manifest"], "--checkpoint-dir",
            os.path.join(tmp, "sup"), "--device", DEVICE,
            "--init-encoder-from", spec["pre_ck"], "--init-method",
            "wav2vec2", "--set", "data.batch_size=8",
            "--set", f"model.n_blocks={PARALLEL_BLOCKS}",
            "--set", "train.num_steps=1", "--set", "train.num_epochs=100"])
    transfer["end_step"] = trainer.step
    del trainer
    torch.cuda.empty_cache()
    for key, n in launch_counts().items():
        launches[key] = launches.get(key, 0) + n
    runs = [{k: r["pretrain_run"][k] for k in (
        "start_step", "end_step", "wall_s", "peak_memory_gb")}
        for r in ranks]
    with open(os.path.join(spec["pre_ck"], "metrics.jsonl"),
              encoding="utf8") as f:
        steps = [json.loads(ln)["step"] for ln in f
                 if "pretrain/loss" in ln]
    return {"agreement": agree, "mesh_runs": runs, "resumed_dp1": resumed,
            "steps": steps, "transfer": transfer, "launches": launches,
            "ok": (all(a["ok"] for a in agree.values())
                   and all((r["start_step"], r["end_step"]) == (0, 4)
                           for r in runs)
                   and (resumed["start_step"], resumed["end_step"]) == (4, 6)
                   and steps == [1, 2, 3, 4, 5, 6]
                   and transfer.get("all_equal") is True
                   and transfer["end_step"] == 1)}


# ---------------------------------------------------------------------------
# tools: the port's measuring tools at the production width
# ---------------------------------------------------------------------------

# trace_step on the train step: B 8 x 24 s, conv_impl pallas (K3 at 2401 mel
# frames, K4a/K4b), 2 traced steps; its window must show these groups
TOOLS_TRAIN = ["--mode", "train", "--arch", "ctc", "--batch", "8",
               "--audio-s", "24", "--conv", "pallas", "--steps", "2"]
TOOLS_TRAIN_GROUPS = ("K1-drop", "K2", "K3", "K4a", "K4b")
# the other modes, once each: (argv, groups that must show time); the
# forward before the device CTC beam runs K1 without dropout
TOOLS_MODES = (
    (["--mode", "train", "--arch", "transducer", "--batch", "8",
      "--audio-s", "8", "--steps", "1"], ("K1-drop", "K2")),
    (["--mode", "pretrain", "--batch", "8", "--audio-s", "8", "--steps",
      "1"], ("K1-drop", "K2")),
    (["--mode", "pretrain_byol", "--batch", "8", "--audio-s", "8",
      "--steps", "1"], ("K1", "K1-drop", "K2")),
    (["--mode", "beam_device", "--batch", "8", "--audio-s", "8", "--steps",
      "1"], ("K1",)),
    (["--mode", "transducer_beam", "--batch", "8", "--audio-s", "4",
      "--steps", "1"], ("K1",)))
TOOLS_PROFILE = ["--batch", "8", "--audio-s", "8", "--attn", "pallas"]
TOOLS_SWEEPS = (["--total-s", "16", "--chunks", "2", "--contexts", "6"],
                ["--total-s", "16", "--chunks", "1", "--contexts", "2"])
TOOLS_AUDIO = ["--files", "2", "--seconds", "10", "--repeats", "1"]


def expected_group_launches(counts: dict) -> dict:
    """The wrappers' launch counts over a traced window -> the kernels each
    of trace_step's port groups must hold: a K1 call launches one kernel
    (hopper::fwd_kernel<DROP> or general::fwd_kernel), a K2 call four
    (q_pass, k_pass, da_pass, dwh_pass) or, general, five (q_pass, k_pass,
    da_pass, dwh_partial, dwh_reduce), K3 and K4a one, K4b one (the window
    kernel) or two (dwconv_dw_partial_kernel, dwconv_dw_reduce_kernel), K5
    one. The general kernels' launches with dropout are not counted apart,
    so where there are any only the hopper pair's sum is known."""
    fwd, drop = counts["sincos_attention_fwd"], \
        counts["sincos_attention_fwd_dropout"]
    fwd_general = counts["sincos_attention_fwd_general"]
    bwd, bwd_general = counts["sincos_attention_bwd"], \
        counts["sincos_attention_bwd_general"]
    dw, dw_window = counts["depthwise_conv_dw"], \
        counts["depthwise_conv_dw_window"]
    out = ({"K1": fwd - drop, "K1-drop": drop} if fwd_general == 0
           else {"K1 + K1-drop": fwd - fwd_general})
    out.update({"K1 general": fwd_general, "K2": 4 * (bwd - bwd_general),
                "K2 general": 5 * bwd_general, "K3": counts["logmel_fwd"],
                "K4a": counts["depthwise_conv_fwd"],
                "K4b": dw_window + 2 * (dw - dw_window),
                "K5": counts["vpu_pass"]})
    return out


def _traced_groups(report: dict, must_show) -> dict:
    """A trace_step report -> its port groups' launches against the
    wrappers' counts, the groups that must show time, and the totals."""
    groups = {g["group"]: g for g in report["groups"]}
    launches = lambda g: groups.get(g, {}).get("launches", 0)
    want = expected_group_launches(report["wrapper_launches"])
    got = {g: (launches("K1") + launches("K1-drop") if g == "K1 + K1-drop"
               else launches(g)) for g in want}
    shown = {g: groups.get(g, {}).get("ms", 0.0) for g in must_show}
    t = report["totals"]
    return {"mode": report["mode"], "totals": t,
            "groups": report["groups"],
            "top": [{k: (v[:100] if k == "name" else v)
                     for k, v in row.items()} for row in report["top"][:10]],
            "group_launches": got, "expected_launches": want,
            "must_show_ms": shown,
            "ok": (got == want and all(ms > 0 for ms in shown.values())
                   and 0 < t["busy_share"] <= 1 and bool(report["groups"]))}


def phase_tools(torch):
    """-> the kernels' launches in the tools' runs: the traced windows
    (each counted by the trace tool) and the profile and sweep runs."""
    from conformer_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from conformer_tpu_torch.tools import (bench_audio_io, profile_step,
                                           sweep_streaming, trace_step)

    total = {}

    def add(counts: dict) -> None:
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    traces = []
    for argv, must_show in [(TOOLS_TRAIN, TOOLS_TRAIN_GROUPS), *TOOLS_MODES]:
        t0 = time.perf_counter()
        report = trace_step.main(argv + ["--top", "15"])
        shutil.rmtree(report["trace_dir"], ignore_errors=True)
        add(report["wrapper_launches"])
        traces.append({**_traced_groups(report, must_show),
                       "seconds": time.perf_counter() - t0})
    reset_launch_counts()
    profile = profile_step.main(TOOLS_PROFILE)
    add(launch_counts())
    reset_launch_counts()
    sweeps = [row for argv in TOOLS_SWEEPS
              for row in sweep_streaming.main(argv)]
    add(launch_counts())
    audio = bench_audio_io.main(TOOLS_AUDIO)
    for row in sweeps:
        row.pop("text", None)
    profile_ok = all(
        profile[c]["wall_ms"] > 0 and profile[c]["device_ms"] is not None
        and math.isfinite(profile[c]["device_ms"]) and profile[c]["device_ms"]
        > 0 for c in profile_step.COMPONENTS)
    pairs = [r for r in sweeps if "chunk_s" in r]
    sweep_ok = (len(pairs) == len(TOOLS_SWEEPS) and all(
        r.get("rtf", 0) > 0 and "divergence_cer_vs_offline" in r
        for r in pairs))
    audio_ok = all(v > 0 and math.isfinite(v) for v in audio.values())
    ok = (all(t["ok"] for t in traces) and profile_ok and sweep_ok
          and audio_ok)
    emit({"phase": "tools", "config": "Config() bf16, seeded weights",
          "trace_step": traces, "profile_step": {**profile,
                                                 "argv": TOOLS_PROFILE},
          "sweep_streaming": sweeps, "bench_audio_io": audio,
          "profile_ok": profile_ok, "sweep_ok": sweep_ok,
          "audio_ok": audio_ok, "ok": ok})
    if not ok:
        raise SystemExit("tools phase failed")
    return total


def _profiled(torch, fn):
    """-> (host wall ms, device busy ms, kernel rows) of one fn() call."""
    from torch.profiler import ProfilerActivity, profile

    from conformer_tpu_torch.tools.trace_step import kernel_rows

    torch.cuda.synchronize()
    # the device's activity alone: the host's ops add no kernel row, and
    # an eager beam's tens of thousands of them take longer to
    # post-process than its kernels (tools/trace_step.py records both)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # the device's own rows, as the trace tool counts them
    events = kernel_rows(prof.key_averages())
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


def _trace_case(torch, fn) -> dict:
    """One warm call of fn(i), then one traced, read by the trace tool:
    its totals (span, union-busy, idle share, launches), groups and top
    kernels, and the wrappers' counts over the window."""
    from conformer_tpu_torch.tools import trace_step

    with tempfile.TemporaryDirectory() as d:
        counts = trace_step.trace_window(fn, 1, d, torch.device(DEVICE),
                                         warmup=1)
        rep = trace_step.report(d, top=10, quiet=True)
    return {**rep["totals"], "groups": rep["groups"],
            "top": [{**k, "name": k["name"][:100]} for k in rep["top"]],
            "wrapper_launches": {k: n for k, n in counts.items() if n}}


def phase_profile(torch):
    """One bf16 forward (serving) and one bf16 train step (dropout 0.1,
    SpecAugment, remat, Adam) of Config() at B = 8, 8 s and 24 s, warm,
    with the depthwise conv through F.conv1d (conv_impl xla) and through K4
    (pallas); and the pretrain phase's steps (PRETRAIN_CASES); each traced
    and read by ``tools/trace_step.py``."""
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
            out[f"{impl}_forward_{seconds}s"] = _trace_case(
                torch, lambda i: forward(*args[:2]))
            out[f"{impl}_train_step_{seconds}s"] = _trace_case(
                torch, lambda i: train(*args, i))
        del model, forward, train
    for method, seconds, conv_impl in PRETRAIN_CASES:
        _, model, step, audio, lengths = _pretrain_setup(torch, method,
                                                         seconds, conv_impl)
        out[f"{method}_{conv_impl}_step_{seconds}s"] = _trace_case(
            torch, lambda i: step(audio, lengths, i))
        del model, step
    emit({"phase": "profile", "config": "Config() bf16, B=8, conv_impl "
          "xla and pallas; PRETRAIN_CASES", **out})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:            # a rank of the parallel phase
        return _worker(argv[1])
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
    walls = {}                       # each phase's wall seconds

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        return out

    if "build" in phases:
        timed("build", phase_build)
    if "kernels" in phases:
        entries, launches = timed("kernels", phase_kernels, torch)
    if "tolerance" in phases:
        timed("tolerance", phase_tolerance, torch)
    for name, run in (("model", phase_model), ("tools", phase_tools)):
        if name in phases:
            for key, n in timed(name, run, torch).items():
                launches[key] = launches.get(key, 0) + n
    # one directory each, under one root: the export phase exports the
    # transducer phase's checkpoint. Its cli.export runs start ahead and
    # trace on the host's other cores while the phases in between run: the
    # CTC ones now, the transducer's once its phase has made the checkpoint
    # (the export phase runs after pretrain, to give them the time).
    with tempfile.TemporaryDirectory() as root:
        export_tmp = os.path.join(root, "export")
        try:
            if "export" in phases:
                os.makedirs(export_tmp)
                start_ctc_exports(export_tmp)
            for name, run in (("serve", phase_serve), ("train", phase_train),
                              ("evaluate", phase_evaluate),
                              ("tiny", phase_tiny), ("stream", phase_stream),
                              ("transducer", phase_transducer),
                              ("beam_device", phase_beam_device),
                              ("pretrain", phase_pretrain),
                              ("export", phase_export),
                              ("parallel", phase_parallel)):
                if name in phases:
                    tmp = os.path.join(root, name)
                    os.makedirs(tmp, exist_ok=True)
                    for key, n in timed(name, run, torch, tmp).items():
                        launches[key] = launches.get(key, 0) + n
                if name == "transducer" and "export" in phases:
                    start_transducer_export(export_tmp)
        finally:
            stop_exports()
    for entry in entries:
        entry["launches"] = launches.get(entry["name"], 0)
    if "profile" in phases:
        timed("profile", phase_profile, torch)
    emit({"phase_seconds": walls})
    print(gpu_name_and_limit().splitlines()[0], flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
