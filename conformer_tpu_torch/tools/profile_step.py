"""Component-level timing of the train step (counterpart of
tools/profile_step.py).

Times, warm and one after another: the mel frontend, SpecAugment, the
encoder forward and forward+backward, the LSTM decoder forward and
forward+backward, the CTC loss and its forward+backward, and the full
train step of Config() on the port's ``synthetic_batch`` with seeded
weights; and the step's audio seconds a second. Each line gives the
synchronised wall ms a call (the JAX tool's timing) and beside it the
device ms from ``tools/timing.py::device_ms`` (calls queued behind a spin
kernel, so the events time the device, not the host's launches). The two
differ by the host's launch time; where a component's calls launch more
kernels than the spin covers or the launch queue holds, the host catches
up with the device and the two agree (``trace_step``'s union-busy time is
then the device's own).

    python -m conformer_tpu_torch.tools.profile_step [--batch 16]
        [--audio-s 8] [--remat] [--attn xla|pallas] [--score bfloat16]
        [--conv xla|pallas] [--device cuda|cpu]

The flags are the JAX tool's BENCH_REMAT, BENCH_ATTN, BENCH_SCORE and
BENCH_CONV, with its defaults. Prints the card's name and power limit
first; ``main`` returns each component's times and the chain's CTC loss.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from conformer_tpu_torch.tools import trace_step
from conformer_tpu_torch.tools.timing import sync

COMPONENTS = ("mel frontend", "spec_augment", "encoder fwd",
              "encoder fwd+bwd", "decoder fwd", "decoder fwd+bwd", "ctc loss",
              "ctc fwd+bwd", "full train step")


def wall_ms(fn: Callable[[], object], device: torch.device,
            n: int = 10) -> float:
    """Mean synchronised wall ms of n calls after one warm call."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def profile(cfg, batch: int, audio_s: float, device: torch.device,
            model: Optional[torch.nn.Module] = None, tokens: int = 128,
            iters: int = 10, step_iters: int = 5) -> dict:
    """-> {component: {"wall_ms", "device_ms"}} in COMPONENTS' order,
    "audio_s_per_s" and "ctc_loss" (the chain's loss: frontend -> encoder
    -> decoder -> CTC, the model in eval mode), printing a line a
    component. ``model`` (a Conformer on the CPU) replaces the seeded one;
    its weights change in the train step, which runs last."""
    from conformer_tpu_torch.audio.augment import spec_augment
    from conformer_tpu_torch.audio.mel import MelFrontend
    from conformer_tpu_torch.data.dataset import synthetic_batch
    from conformer_tpu_torch.models.conformer import build_model
    from conformer_tpu_torch.ops.ctc import ctc_loss
    from conformer_tpu_torch.tools.timing import device_ms
    from conformer_tpu_torch.train.state import make_optimizer
    from conformer_tpu_torch.train.steps import (make_train_step,
                                                 step_generator)
    from conformer_tpu_torch.utils.masking import subsampled_length

    n = int(audio_s * cfg.audio.sample_rate)
    b = synthetic_batch(batch, n, cfg.model.vocab_size, max_tokens=tokens,
                        seed=0)
    audio, audio_lengths, labels, label_lengths = (
        torch.from_numpy(np.asarray(x)).to(device)
        for x in (b.audio, b.audio_lengths, b.tokens, b.token_lengths))
    if model is None:
        model = build_model(cfg.model, cfg.optim.compute_dtype, seed=0)
    model = model.to(device).eval()
    frontend = MelFrontend(cfg.audio, device=device)
    out = {}

    def record(name: str, fn: Callable[[], object], n_calls: int = iters,
               note: str = "") -> None:
        wall = wall_ms(fn, device, n_calls)
        dev = (device_ms(fn, iters=n_calls, warmup=1)
               if device.type == "cuda" else None)
        out[name] = {"wall_ms": wall, "device_ms": dev}
        dev_s = "not measured" if dev is None else f"{dev:8.2f} ms"
        print(f"{name + ':':19s}{wall:8.2f} ms   device {dev_s}   {note}",
              flush=True)

    with torch.no_grad():
        mels = frontend(audio)
        mel_lengths = frontend.frame_lengths(audio_lengths)
        record("mel frontend", lambda: frontend(audio), note=str(
            tuple(mels.shape)))
        record("spec_augment", lambda: spec_augment(
            step_generator(cfg.train.seed, 0), mels, cfg.augment,
            mel_lengths))
        enc = model.encoder(mels, mel_lengths)[0]
        record("encoder fwd", lambda: model.encoder(mels, mel_lengths),
               note=str(tuple(enc.shape)))
    enc_params = list(model.encoder.parameters())
    record("encoder fwd+bwd", lambda: torch.autograd.grad(
        model.encoder(mels, mel_lengths)[0].float().sum(), enc_params,
        allow_unused=True))
    with torch.no_grad():
        logits = model.decoder(enc).float()
        record("decoder fwd", lambda: model.decoder(enc),
               note=str(tuple(logits.shape)))
    dec_params = list(model.decoder.parameters())
    record("decoder fwd+bwd", lambda: torch.autograd.grad(
        model.decoder(enc).float().sum(), dec_params, allow_unused=True))
    out_lengths = subsampled_length(mel_lengths)
    loss_fn = lambda lg: ctc_loss(lg, out_lengths, labels, label_lengths)
    with torch.no_grad():
        loss = float(loss_fn(logits))
        record("ctc loss", lambda: loss_fn(logits))
    leaf = logits.detach().requires_grad_(True)
    record("ctc fwd+bwd", lambda: torch.autograd.grad(loss_fn(leaf), leaf))
    step = make_train_step(cfg, model, make_optimizer(
        cfg.optim, model.parameters(), steps_per_epoch=1000))
    calls = iter(range(1 << 30))
    record("full train step", lambda: step(
        audio, audio_lengths, labels, label_lengths, next(calls)),
        n_calls=step_iters)
    out["audio_s_per_s"] = batch * audio_s / (
        out["full train step"]["wall_ms"] / 1e3)
    out["ctc_loss"] = loss
    print(f"-> {out['audio_s_per_s']:.0f} audio-s/s", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--audio-s", type=float, default=8.0)
    p.add_argument("--remat", action="store_true",
                   help="recompute each block in the backward (BENCH_REMAT)")
    p.add_argument("--attn", default="xla", choices=["xla", "pallas"],
                   help="attention_impl (BENCH_ATTN)")
    p.add_argument("--score", default="bfloat16",
                   help="attention_score_dtype (BENCH_SCORE)")
    p.add_argument("--conv", default="xla", choices=["xla", "pallas"],
                   help="conv_impl (BENCH_CONV)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("profile_step needs a CUDA device (or --device "
                             "cpu)")
        print(trace_step.card(), flush=True)
    return profile(trace_step.config(args), args.batch, args.audio_s,
                   torch.device(args.device))


if __name__ == "__main__":
    main()
