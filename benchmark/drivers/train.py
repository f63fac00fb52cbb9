"""Entry driver "train": the program's ``Trainer.train_epoch`` over its
``BucketedLoader`` on the seeded manifest.

Set-up: the WAV pool and its manifest, the ``Trainer`` (checkpoints and
logging off, its directory under the run's temporary directory), the
benchmark's seeded weights loaded into its model, then the first
``checked_steps`` steps, one ``train_epoch`` call each through the same
feed as the window (the program's readings are taken between them: each
step's gradient from Adam's first moments, the parameters after the
last), then further steps until every bucket shape of the mix has run
once. The window: one ``train_epoch`` call over the feed, which
stops handing out batches at the deadline, then a synchronise. With
``--trace 1`` a slice of ``trace_steps`` more steps runs under the
profiler. Then the program is freed and the reference follows the checked
steps from the same weights on the same rows (reference/model.py).

The feed wraps the loader's iterator: it times the wait for each batch,
keeps each batch's lengths, and rolls over into the next epoch.
"""

from __future__ import annotations

import gc
import os
import time
from typing import List

import numpy as np
import torch

from benchmark.harness import check, flops, trace, traffic as gen, weights
from benchmark.reference import model as reference


class Feed:
    """The loader's batches, epoch after epoch, with the wait for each."""

    def __init__(self, loader):
        self.loader, self.epoch = loader, 0
        self.it = loader.epoch(0)
        self.wait_s = 0.0
        self.batches: List[dict] = []

    def _next(self):
        for _ in range(2):
            try:
                return next(self.it)
            except StopIteration:
                self.epoch += 1
                self.it = self.loader.epoch(self.epoch)
        raise RuntimeError("the loader made no batch in a whole epoch")

    def _pull(self):
        t = time.perf_counter()
        b = self._next()
        self.wait_s += time.perf_counter() - t
        self.batches.append({"texts": list(b.texts), "shape": b.audio.shape,
                             "samples": b.audio_lengths.tolist(),
                             "tokens": b.token_lengths.tolist()})
        return b

    def take(self, n: int):
        for _ in range(n):
            yield self._pull()

    def until(self, deadline: float):
        while time.perf_counter() < deadline:
            yield self._pull()

    def mark(self):
        """Start counting anew: -> the batches and wait from here on."""
        self.wait_s, self.batches = 0.0, []


def _config(ctx, manifest: str, overrides=None):
    from conformer_tpu_torch.config import Config

    t = ctx.traffic
    cfg = Config.from_dict(ctx.config["config"])
    return cfg.override(**dict(overrides or {}), **{
        "data.train_manifest": manifest,
        "data.bucket_batch_sizes": list(t["bucket_batch_sizes"]),
        "data.seed": t["loader_seed"],
        "train.seed": int(ctx.seed),
        "train.checkpoint_dir": os.path.join(ctx.tmp, "checkpoints"),
        "train.checkpoint_every_steps": 0,
        "train.log_every_steps": 0,
        "train.num_steps": None,
    })


def _shapes(cfg, rows) -> set:
    """The (batch, samples) shapes the loader makes of these rows."""
    sr = cfg.audio.sample_rate
    bounds = [int(b * sr) for b in cfg.data.bucket_boundaries_s]
    if bounds[-1] < int(cfg.data.max_audio_s * sr):
        bounds.append(int(cfg.data.max_audio_s * sr))
    sizes = list(cfg.data.bucket_batch_sizes)
    sizes += [sizes[-1]] * (len(bounds) - len(sizes))
    out = set()
    for r in rows:
        i = next(k for k, b in enumerate(bounds) if r["samples"] <= b)
        out.add((sizes[i], bounds[i]))
    return out


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Session:
    """One process's program: set-up through the checked steps."""

    def __init__(self, ctx, warm: bool = True, overrides=None):
        from conformer_tpu_torch.data.dataset import (BucketedLoader,
                                                      ManifestDataset)
        from conformer_tpu_torch.text.tokenizer import load_tokenizer
        from conformer_tpu_torch.train.trainer import Trainer

        self.ctx = ctx
        t = ctx.traffic
        tree = ctx.config["config"]
        self.tok = load_tokenizer(ctx.config["tokenizer"])
        sr = tree["audio"]["sample_rate"]
        self.rows = gen.make_pool(t, ctx.seed, os.path.join(ctx.tmp, "wav"),
                                  self.tok, tree["data"]["max_tokens"], sr)
        manifest = os.path.join(ctx.tmp, "manifest.csv")
        gen.write_manifest(self.rows, manifest, t.get("repeat", 1))
        self.by_text = {r["text"]: r for r in self.rows}
        cfg = _config(ctx, manifest, overrides)
        self.cfg = cfg
        self.tree = cfg.to_dict()
        if (len(self.rows) * t.get("repeat", 1) // cfg.data.batch_size
                <= t["checked_steps"]):
            raise ValueError("the learning rate would decay inside the "
                             "checked steps")
        self.trainer = Trainer(cfg, self.tok, device=ctx.device)
        model = self.trainer.model
        self.shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        w = weights.make(self.shapes, ctx.seed, ctx.device)
        model.load_state_dict(w)
        del w
        loader = BucketedLoader(ManifestDataset(manifest, sr), self.tok,
                                cfg.data, training=True)
        self.feed = Feed(loader)
        self.prog = self._checked_steps(t["checked_steps"])
        self.checked = list(self.feed.batches)
        if warm:
            self._warm_up(_shapes(cfg, self.rows))
        _sync(ctx.device)

    def _checked_steps(self, n: int) -> dict:
        """-> the checked steps' losses, each step's gradient as Adam got it
        (from its first moments: m_k - beta1 m_(k-1), over 1 - beta1), the
        parameters after the last step."""
        tr = self.trainer
        named = dict(tr.model.named_parameters())
        state = tr.optimizer.opt.state
        beta1 = self.cfg.optim.beta1

        def moment(p):
            # a leaf Adam holds no moment for reads as a zero gradient
            return (state[p]["exp_avg"].detach().clone() if "exp_avg"
                    in state.get(p, {}) else torch.zeros_like(p))

        out: dict = {"losses": [], "grads": []}
        before = {name: torch.zeros_like(p) for name, p in named.items()}
        for k in range(n):
            out["losses"].append(tr.train_epoch(self.feed.take(1), 0))
            now = {name: moment(p) for name, p in named.items()}
            out["grads"].append({
                name: ((now[name] - beta1 * before[name]) / (1 - beta1)
                       ).to("cpu", copy=True) for name in named})
            before = now
        del before
        out["params"] = {name: p.detach().to("cpu", copy=True)
                         for name, p in named.items()}
        return out

    def _warm_up(self, shapes: set) -> None:
        seen = {tuple(b["shape"]) for b in self.feed.batches}
        for _ in range(4 * len(shapes) + 12):
            if shapes <= seen:
                return
            self.trainer.train_epoch(self.feed.take(1), 0)
            seen.add(tuple(self.feed.batches[-1]["shape"]))
        raise RuntimeError(f"warm-up never met the shapes {shapes - seen}")

    def free(self) -> None:
        """Drop the program's state, so that the reference has the card."""
        self.trainer = None
        self.feed = None
        gc.collect()
        if torch.device(self.ctx.device).type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ---------------------------------------------------------
    def reference_batches(self) -> List[dict]:
        """The checked steps' rows, read and padded by the benchmark, with
        the token ids it made."""
        out = []
        for b in self.checked:
            rows = [self.by_text[t] for t in b["texts"]]
            width = b["shape"][1]
            audio = np.zeros((len(rows), width), np.float32)
            n_tok = max(len(r["ids"]) for r in rows)
            tokens = np.zeros((len(rows), n_tok), np.int64)
            for i, r in enumerate(rows):
                x = gen.read_wav(r["path"])[:width]
                audio[i, :len(x)] = x
                tokens[i, :len(r["ids"])] = r["ids"]
            out.append({"audio": audio,
                        "audio_lengths": np.array([min(r["samples"], width)
                                                   for r in rows]),
                        "tokens": tokens,
                        "token_lengths": np.array([len(r["ids"])
                                                   for r in rows])})
        return out

    def checked_shapes(self) -> List[list]:
        """The checked steps' (rows, samples) shapes, in order."""
        return [list(b["shape"]) for b in self.checked]

    def compare(self, variants=(), others=None, leaf_detail=False) -> dict:
        """The checked steps followed by the float32 reference from the same
        weights -> {"program": its numbers against the reference, each
        variant's ('fp8': the control; 'bf16': the reference rounded to
        the configuration's bfloat16 at the same points, a witness;
        'half_batch': a fault planted in the reference) the same way, each
        of ``others`` (more programs' checked steps from the same weights)
        too, "losses": every side's losses}."""
        w = weights.make(self.shapes, self.ctx.seed, self.ctx.device)
        batches = self.reference_batches()
        refs = {}
        for v in ("fp32",) + tuple(variants):
            r = reference.train_steps(
                self.tree, w, batches, self.cfg.train.seed,
                precision=v if v in ("fp8", "bf16") else "fp32",
                half_batch=(v == "half_batch"))
            refs[v] = {"losses": r["losses"], "grads": r["grads"],
                       "change": {k: c.cpu() for k, c in r["change"].items()}}
            del r
        progs = {"program": self.prog, **(others or {})}
        out = {v: check.readings(refs[v], refs["fp32"], leaf_detail)
               for v in variants}
        out["losses"] = {k: v["losses"] for k, v in refs.items()}
        for name, p in progs.items():
            prog = {"losses": p["losses"], "grads": p["grads"],
                    "change": {k: p["params"][k] - w[k].cpu()
                               for k in refs["fp32"]["change"]}}
            out[name] = check.readings(prog, refs["fp32"], leaf_detail)
            out["losses"][name] = prog["losses"]
        return out


def run(ctx) -> dict:
    s = Session(ctx)
    t, dev, sr = ctx.traffic, ctx.device, s.cfg.audio.sample_rate
    setup_s = time.perf_counter() - ctx.t_start
    s.feed.mark()
    t0 = time.perf_counter()
    s.trainer.train_epoch(s.feed.until(t0 + ctx.seconds), 0)
    _sync(dev)
    window_s = time.perf_counter() - t0
    win = s.feed.batches
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(dev).type == "cuda" else 0)
    measured = {
        "setup_s": setup_s, "window_s": window_s, "attempted": len(win),
        "failed": 0, "memory_peak_bytes": int(peak),
        "real_audio_s": sum(sum(b["samples"]) for b in win) / sr,
        "padded_audio_s": sum(b["shape"][0] * b["shape"][1]
                              for b in win) / sr,
        "loader_wait_s": s.feed.wait_s,
        "model_flops": flops.train_flops_rows(
            s.tree, [(a, u) for b in win for a, u in zip(b["samples"],
                                                        b["tokens"])]),
    }
    measured["e2e"] = {"train_audio_per_s":
                       measured["real_audio_s"] / window_s}
    if ctx.trace:
        s.feed.mark()
        events = trace.profile(
            lambda: (s.trainer.train_epoch(s.feed.take(t["trace_steps"]), 0),
                     _sync(dev)),
            os.path.join(ctx.tmp, "trace.json"))
        sl = s.feed.batches
        tr = trace.read(events, ctx.spec.kernel_groups())
        del events
        tr["real_audio_s"] = sum(sum(b["samples"]) for b in sl) / sr
        tr["work"] = {op: flops.attention_work(
            s.tree, [b["samples"] for b in sl], back)
            for op, back in (("attn_fwd", False), ("attn_bwd", True))}
        measured["trace"] = tr
    ctx.check_imports()
    s.free()
    got = s.compare()["program"]
    got["checked_shapes"] = s.checked_shapes()
    measured["readings"] = got
    measured["checks"] = {k: (got[k], lim) for k, lim in ctx.limits.items()
                          if k in got}
    return measured


def readings(ctx, variants, witness: bool = False,
             leaf_detail: bool = False) -> dict:
    """compare()'s numbers for one seed: set-up and the checked steps, no
    window. ``witness``: the program's checked steps again with its compute
    dtype float32 ("program_fp32"), against the same reference."""
    s = Session(ctx, warm=False)
    s.free()
    others = {}
    if witness:
        s32 = Session(ctx, warm=False,
                      overrides={"optim.compute_dtype": "float32"})
        s32.free()
        others["program_fp32"] = s32.prog
    out = s.compare(tuple(variants), others, leaf_detail)
    out["checked_shapes"] = s.checked_shapes()
    return out
