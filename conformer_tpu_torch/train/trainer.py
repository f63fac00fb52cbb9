"""Training orchestration: data -> train steps -> checkpoints -> validation
(counterpart of conformer_tpu/train/trainer.py).

Epoch loop with per-epoch shuffling, periodic checkpoints and resume,
validation with the loss and greedy WER (CTC or transducer, by
``model.arch``), metric logging, and
``num_steps`` / ``log_every_steps`` / ``checkpoint_every_steps`` /
``val_every_steps`` as in the JAX trainer. With ``train.init_encoder_from``
the encoder starts from a pretraining checkpoint's (``transfer_encoder`` in
train/pretrain.py), unless a supervised checkpoint is resumed. It runs on
the CUDA device unless the caller passes ``device="cpu"``, and raises
without a GPU. Refused: warm-up compilation (nothing is compiled ahead
here).

Under a mesh (``mesh=``, or ``parallel.dp * parallel.tp > 1`` over the
launcher's process group; parallel/mesh.py) every rank loads the step's
global batch and takes its data rank's stripe (``multihost``: each node
loads its stripe of the manifest, ``shard_index``/``shard_count`` by node,
and its data ranks split that), the model is split over the model group,
rank 0 alone prints, logs and writes checkpoints (in the single-device
format, which every rank helps gather), and validation decodes each stripe
greedily and gathers the tokens, so WER covers the whole set.
"""

from __future__ import annotations

import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.data.dataset import Batch, BucketedLoader, ManifestDataset
from conformer_tpu_torch.decode.pipeline import resolve_device
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.parallel import collectives as cc
from conformer_tpu_torch.parallel.mesh import (batch_stripe, init_process_group,
                                               loader_layout, local_device,
                                               mesh_from_config, shard_model)
from conformer_tpu_torch.text.metrics import wer
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
from conformer_tpu_torch.train.checkpoint import CheckpointManager
from conformer_tpu_torch.train.logging import EarlyStopping, MetricsLogger, Throughput
from conformer_tpu_torch.train.pretrain import init_encoder_from
from conformer_tpu_torch.train.state import make_optimizer, param_count
from conformer_tpu_torch.train.steps import make_eval_step, make_train_step


def _refuse_unported(cfg: Config) -> None:
    if cfg.train.warmup_compile != "off":
        raise NotImplementedError(
            "train.warmup_compile: this package compiles nothing ahead of "
            "time; set it to 'off'")


class Trainer:
    def __init__(self, cfg: Config, tokenizer: GraphemeTokenizer,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 mesh=None, multihost: bool = False):
        _refuse_unported(cfg)
        cfg = cfg.override(**{"model.vocab_size": tokenizer.vocab_size})
        self.cfg, self.tok = cfg, tokenizer
        self.device = resolve_device(local_device(device))
        if mesh is None and cfg.parallel.dp * cfg.parallel.tp > 1:
            init_process_group(self.device)
            mesh = mesh_from_config(cfg.parallel, self.device)
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        # the ranks of this process's loader: (its first data index, how
        # many data ranks split its batches), and the number of loaders
        self.loader_ranks, self.loaders = loader_layout(mesh, multihost)
        if not self.lead:
            logger = MetricsLogger(None)
        self.logger = logger or MetricsLogger(cfg.train.checkpoint_dir)

        steps_per_epoch = None
        if cfg.data.train_manifest:
            try:
                n = len(ManifestDataset(cfg.data.train_manifest))
                steps_per_epoch = max(n // cfg.data.batch_size, 1)
            except Exception:
                pass
        self.steps_per_epoch = steps_per_epoch

        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                      keep=cfg.train.keep_checkpoints,
                                      mesh=mesh)
        resume = cfg.train.resume and self.ckpt.latest_step() is not None
        model = build_model(cfg.model, cfg.optim.compute_dtype, cfg.train.seed)
        if cfg.train.init_encoder_from and not resume:
            init_encoder_from(cfg, model)
        if mesh is not None:
            shard_model(model, mesh, cfg.model)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(cfg.optim, self.model.parameters(),
                                        steps_per_epoch, mesh,
                                        zero=cfg.parallel.zero)
        self.step, self.epoch = 0, 0
        if resume:
            self.step, self.epoch = self.ckpt.restore(self.model, self.optimizer)
            self.print(f"[trainer] resumed from step {self.step} "
                       f"(epoch {self.epoch})")
        self.start_step = self.step

        frontend = MelFrontend(cfg.audio, device=self.device)
        self.train_step = make_train_step(cfg, self.model, self.optimizer,
                                          frontend, mesh)
        self.eval_step = make_eval_step(cfg, self.model, frontend,
                                        unk_id=tokenizer.unk_id, mesh=mesh)
        where = "" if mesh is None else (
            f", mesh dp {mesh.dp} x tp {mesh.tp}"
            f"{' zero' if cfg.parallel.zero else ''}"
            f"{' seq_shard' if cfg.model.seq_shard else ''}")
        self.print(f"[trainer] params: {param_count(self.model)/1e6:.1f}M "
                   f"a rank, vocab {tokenizer.vocab_size}, device "
                   f"{self.device}{where}")

    def print(self, *args) -> None:
        if self.lead:
            print(*args, flush=True)

    # ------------------------------------------------------------------
    def _device_batch(self, batch: Batch):
        """The batch on the device; under a mesh, this rank's stripe."""
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)
        arrays = batch_stripe(
            (batch.audio, batch.audio_lengths.astype(np.int64),
             batch.tokens.astype(np.int64),
             batch.token_lengths.astype(np.int64)),
            self.mesh, *self.loader_ranks)
        return tuple(to(a) for a in arrays)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save(self, epoch: int) -> None:
        self.ckpt.save(self.model, self.optimizer, self.step, epoch)

    def train_epoch(self, loader: Iterable[Batch], epoch: int,
                    val_fn=None) -> float:
        """One epoch. The step loop reads device values only at log points
        (which synchronise, so ``step_seconds`` there is the device-complete
        wall time since the previous log point, per step); a non-finite loss
        raises.

        val_fn(step): optional mid-epoch validation hook, called every
        cfg.train.val_every_steps steps."""
        cfg = self.cfg
        meter = Throughput()
        device_losses = []
        sr = cfg.audio.sample_rate
        prof, prof_dir = None, None
        if cfg.train.profile_num_steps and self.lead:
            prof_dir = os.path.join(cfg.train.checkpoint_dir, "profile")
        t_log, steps_since = time.perf_counter(), 0
        for batch in loader:
            args = self._device_batch(batch)
            if prof_dir is not None and prof is None \
                    and self.step == cfg.train.profile_start_step:
                prof = torch.profiler.profile()
                prof.__enter__()
            metrics = self.train_step(*args, self.step)
            self.step += 1
            steps_since += 1
            device_losses.append(metrics["loss"])
            meter.update(float(batch.audio_lengths.sum()) * self.loaders / sr)
            if prof is not None and self.step == (cfg.train.profile_start_step
                                                  + cfg.train.profile_num_steps):
                self._sync()
                prof.__exit__(None, None, None)
                os.makedirs(prof_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
                prof, prof_dir = None, None
                self.print("[trainer] wrote profiler trace")
            if cfg.train.log_every_steps and self.step % cfg.train.log_every_steps == 0:
                loss = float(metrics["loss"])          # synchronises
                now = time.perf_counter()
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at step {self.step}")
                record = {"ctc_loss": loss,
                          "grad_norm": float(metrics["grad_norm"]),
                          "step_seconds": (now - t_log) / steps_since,
                          "audio_seconds": float(metrics["audio_seconds"]),
                          **meter.snapshot()}
                if self.device.type == "cuda":
                    record["peak_memory_gb"] = (
                        torch.cuda.max_memory_allocated(self.device) / 1e9)
                self.logger.log(self.step, record, prefix="train/")
                self.print(f"[step {self.step}] loss={loss:.4f} "
                           f"audio_s/s={record['audio_seconds_per_s']:.1f}")
                t_log, steps_since = now, 0
            if (cfg.train.checkpoint_every_steps
                    and self.step % cfg.train.checkpoint_every_steps == 0):
                self.save(epoch)
            if (val_fn is not None and cfg.train.val_every_steps
                    and self.step % cfg.train.val_every_steps == 0):
                val_fn(self.step)
            if cfg.train.num_steps and self.step >= cfg.train.num_steps:
                break
        if prof is not None:
            prof.__exit__(None, None, None)
        losses = (torch.stack(device_losses).double().cpu().numpy()
                  if device_losses else np.zeros(0))
        if losses.size and not np.isfinite(losses).all():
            bad = int(np.flatnonzero(~np.isfinite(losses))[0])
            raise FloatingPointError(
                f"non-finite loss at step {self.step - len(losses) + bad + 1}")
        return float(losses.mean()) if losses.size else float("nan")

    def validate(self, loader: Iterable[Batch]) -> dict:
        """Loss + greedy WER over a validation set (reference:
        train.py:36-81). Under a mesh each rank decodes its stripe and the
        data group gathers the tokens of the batch; over several nodes the
        nodes' texts are gathered too."""
        losses, refs, hyps = [], [], []
        first = self.loader_ranks[0]
        for batch in loader:
            out = self.eval_step(*self._device_batch(batch))
            losses.append(float(out["loss"]))
            tokens, counts = out["tokens"], out["counts"]
            if self.mesh is not None:
                tokens = cc.all_gather(tokens.contiguous(),
                                       self.mesh.data_group, 0)
                counts = cc.all_gather(counts.contiguous(),
                                       self.mesh.data_group, 0)
            tokens, counts = tokens.cpu().numpy(), counts.cpu().numpy()
            row0 = first * (len(tokens) // self.mesh.dp) if first else 0
            for i, text in enumerate(batch.texts or []):
                if not text:
                    continue
                hyps.append(self.tok.collapsed_ids_to_text(tokens[row0 + i],
                                                           counts[row0 + i]))
                refs.append(self.tok.clean_text(text.upper()))
        if self.loaders > 1:        # every node's texts, once a node
            import torch.distributed as dist

            texts = [None] * dist.get_world_size()
            dist.all_gather_object(texts, (hyps, refs))
            local = dist.get_world_size() // self.loaders
            hyps = [h for t in texts[::local] for h in t[0]]
            refs = [r for t in texts[::local] for r in t[1]]
        metrics = {"loss": float(np.mean(losses)) if losses else float("nan")}
        if refs:
            metrics["wer"] = wer(hyps, refs)
        return metrics

    # ------------------------------------------------------------------
    def fit(self) -> None:
        cfg = self.cfg
        train_ds = ManifestDataset(cfg.data.train_manifest,
                                   cfg.audio.sample_rate,
                                   num_examples=cfg.data.num_examples)
        # each node reads its stripe of the manifest (one node: all of it)
        shard = {}
        if self.loaders > 1:
            shard = dict(shard_index=self.loader_ranks[0] // self.loader_ranks[1],
                         shard_count=self.loaders)
        train_loader = BucketedLoader(train_ds, self.tok, cfg.data,
                                      training=True, **shard)
        val_loader = None
        if cfg.data.val_manifest:
            val_ds = ManifestDataset(cfg.data.val_manifest, cfg.audio.sample_rate)
            val_loader = BucketedLoader(val_ds, self.tok, cfg.data,
                                        training=False, **shard)

        early = None
        if cfg.train.early_stop_patience > 0:
            early = EarlyStopping(patience=cfg.train.early_stop_patience,
                                  mode="min")

        val_fn = None
        if val_loader is not None and cfg.train.val_every_steps:
            def val_fn(step, _loader=val_loader):
                val = self.validate(_loader.epoch(0))
                self.print(f"[step {step}] val: {val}")
                self.logger.log(step, val, prefix="val/")

        for epoch in range(self.epoch, cfg.train.num_epochs):
            t0 = time.perf_counter()
            mean_loss = self.train_epoch(train_loader.epoch(epoch), epoch,
                                         val_fn=val_fn)
            self.print(f"[epoch {epoch}] mean_loss={mean_loss:.4f} "
                       f"({time.perf_counter()-t0:.1f}s)")
            self.logger.log(self.step, {"epoch_loss": mean_loss, "epoch": epoch},
                            prefix="train/")
            stop = False
            if val_loader is not None:
                val = self.validate(val_loader.epoch(epoch))
                self.print(f"[epoch {epoch}] val: {val}")
                self.logger.log(self.step, val, prefix="val/")
                if early is not None:
                    metric = val.get(cfg.train.early_stop_metric, val["loss"])
                    if early.update(float(metric)):
                        self.print(f"[trainer] early stop at epoch {epoch} "
                                   f"(best {cfg.train.early_stop_metric}="
                                   f"{early.best:.4f})")
                        stop = True
            self.epoch = epoch + 1
            self.save(self.epoch)
            if stop or (cfg.train.num_steps and self.step >= cfg.train.num_steps):
                break
