"""Self-supervised pretraining (wav2vec2 contrastive or BYOL) and the
encoder transfer into supervised training (counterpart of
conformer_tpu/train/pretrain.py and of the loop of
conformer_tpu/cli/pretrain.py).

Both methods train the parameter structure of ``ConformerEncoder``:
wav2vec2 holds ``subsample``, ``input_proj`` and ``blocks`` at its top,
BYOL's online tower holds a whole encoder under ``encoder``. So
``transfer_encoder`` copies pretrained weights by name into the encoder of
a CTC ``Conformer`` or a ``Transducer``.

Each step draws from the CPU generator of (train.seed, step)
(train/steps.py::step_generator): the span mask's starts, then one seed
each for the Gumbel noise, the sampled negatives and dropout (wav2vec2); the
two SpecAugment views, then the dropout seed (BYOL). The Gumbel noise and
the negatives are drawn on the model's device from generators seeded with
those words, so a step on one device draws the same numbers however the
model computes. ``optim.accum_steps > 1`` raises: splitting the batch would
change the masked-mean losses and the batch statistics, and the JAX
pretraining steps ignore it.

Under a mesh (parallel/mesh.py; the JAX steps are sharding-invariant under
GSPMD) a step takes this rank's stripe of the global batch: every draw is
made at the global batch and the rank keeps its rows (the mask starts, the
Gumbel noise, the negatives, BYOL's two SpecAugment views), so a mesh draws
what one device does; hash dropout takes global coordinates (BYOL's two
views of a stripe through ``Mesh.row_map``); the losses are the rank's
sums over the global counts, the diversity term the global marginal's
(models/quantizer.py), the BatchNorm statistics cross-replica, and the
optimizer sums the gradients over the data group (ZeRO-1 with
``parallel.zero``). The metrics returned are the global ones.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from conformer_tpu_torch.audio.augment import spec_augment
from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.data.dataset import Batch, BucketedLoader, ManifestDataset
from conformer_tpu_torch.decode.pipeline import resolve_device
from conformer_tpu_torch.models import quantizer, wav2vec2
from conformer_tpu_torch.models.byol import BYOLPretrain, byol_loss, ema_update
from conformer_tpu_torch.models.conformer import init_weights
from conformer_tpu_torch.models.layers import DTYPES
from conformer_tpu_torch.models.wav2vec2 import (Wav2Vec2Pretrain,
                                                 contrastive_loss,
                                                 dilate_mask_starts)
from conformer_tpu_torch.parallel.mesh import (batch_stripe,
                                               init_process_group,
                                               loader_layout, local_device,
                                               mesh_from_config, shard_model)
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
from conformer_tpu_torch.train.checkpoint import CheckpointManager
from conformer_tpu_torch.train.logging import MetricsLogger, Throughput
from conformer_tpu_torch.train.state import Optimizer, make_optimizer, param_count
from conformer_tpu_torch.train.steps import step_generator
from conformer_tpu_torch.utils.masking import padding_mask, subsampled_length

METHODS = ("wav2vec2", "byol")


def _method(method: str) -> str:
    if method not in METHODS:
        raise ValueError(f"unknown pretrain method {method!r}; one of "
                         f"{METHODS}")
    return method


def build_pretrain_model(cfg: Config, method: Optional[str] = None,
                         seed: Optional[int] = 0) -> nn.Module:
    """The ``method`` model (default ``pretrain.method``) on the CPU in
    ``optim.compute_dtype``, with seeded random weights (Dense kernels
    lecun-normal as in models/conformer.py::init_weights, the codevectors
    uniform in [0, 1), the mask embedding normal with std 0.02; the BYOL
    target a copy of the online tower), or with ``seed=None``
    uninitialised."""
    method = _method(method or cfg.pretrain.method)
    dtype = DTYPES[cfg.optim.compute_dtype]
    model = (Wav2Vec2Pretrain(cfg.model, cfg.pretrain, dtype)
             if method == "wav2vec2"
             else BYOLPretrain(cfg.model, cfg.pretrain, dtype))
    if seed is None:
        return model
    init_weights(model, seed)
    with torch.no_grad():
        if method == "wav2vec2":
            gen = torch.Generator().manual_seed(seed + 1)
            q = model.quantizer
            q.codevectors.copy_(torch.rand(q.codevectors.shape, generator=gen))
            model.mask_embedding.copy_(
                torch.randn(model.mask_embedding.shape, generator=gen) * 0.02)
        else:
            model.reset_target()
    return model


def gumbel_temperature_at(cfg: Config, step: int) -> float:
    pre = cfg.pretrain
    return max(pre.min_temperature,
               pre.gumbel_temperature * pre.temperature_decay ** step)


def _refuse_accumulation(cfg: Config) -> None:
    if cfg.optim.accum_steps > 1:
        raise NotImplementedError(
            f"optim.accum_steps={cfg.optim.accum_steps}: pretraining takes "
            "each batch whole (micro-batches would change the masked-mean "
            "losses and the batch statistics); set it to 1")


def _device_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded with the next word of ``gen``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def _rows(mesh, b: int):
    """-> (this rank's rows of the global batch, the global batch size)
    for a stripe of ``b`` rows (all of them without a mesh)."""
    if mesh is None:
        return slice(0, b), b
    off = mesh.batch_offset(b)
    return slice(off, off + b), b * mesh.dp


def _global_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """A rank's share -> the data group's sum (no gradient)."""
    return x if mesh is None else mesh.data_count(x)


def make_wav2vec2_step(cfg: Config, model: Wav2Vec2Pretrain,
                       optimizer: Optimizer,
                       frontend: Optional[MelFrontend] = None,
                       mesh=None) -> Callable:
    """-> step(audio (B, S), audio_lengths (B,), step_index) -> {loss,
    contrastive, diversity, accuracy, perplexity, grad_norm,
    audio_seconds} as device scalars. The loss is ``contrastive +
    diversity_weight * (G V - perplexity) / (G V)`` at the Gumbel
    temperature of ``step_index`` (gumbel_temperature_at). Under ``mesh``
    the arguments are this rank's stripe of the global batch."""
    _refuse_accumulation(cfg)
    pre = cfg.pretrain
    device = next(model.parameters()).device
    frontend = frontend or MelFrontend(cfg.audio, device=device)
    gv = pre.num_groups * pre.num_vars
    sr = cfg.audio.sample_rate

    def step(audio: torch.Tensor, audio_lengths: torch.Tensor,
             step_index: int) -> Dict[str, torch.Tensor]:
        model.train()
        gen = step_generator(cfg.train.seed, step_index)
        with torch.no_grad():
            mels = frontend(audio)
        mel_lengths = frontend.frame_lengths(audio_lengths)
        t_sub = subsampled_length(mels.shape[1])
        valid = padding_mask(subsampled_length(mel_lengths), t_sub)
        rows, n = _rows(mesh, mels.shape[0])
        starts = wav2vec2.sample_mask_starts(gen, n, t_sub, pre.mask_prob)
        mask = dilate_mask_starts(starts[rows].to(device), pre.mask_span,
                                  valid)
        gumbel_gen = _device_generator(gen, device)
        negatives_gen = _device_generator(gen, device)
        dropout_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        gumbels = quantizer.gumbel_noise((n, t_sub, pre.num_groups,
                                          pre.num_vars), gumbel_gen, device)
        negatives = None
        if pre.negatives_impl == "sampled":
            negatives = wav2vec2.sample_negatives(
                negatives_gen, n, t_sub, pre.num_negatives, device)[rows]
        optimizer.zero_grad()
        context, target, perplexity = model(
            mels, mel_lengths, mask, gumbel_temperature_at(cfg, step_index),
            dropout_seed=dropout_seed, gumbels=gumbels[rows])
        count = _global_sum(mesh, mask.float().sum())
        c_loss, acc = contrastive_loss(
            context, target, mask, num_negatives=pre.num_negatives,
            temperature=pre.contrastive_temperature,
            negatives_impl=pre.negatives_impl, negatives=negatives,
            count=count)
        d_loss = (gv - perplexity) / gv
        loss = c_loss + pre.diversity_weight * d_loss
        loss.backward()
        grad_norm = optimizer.step()
        c_loss, acc = (_global_sum(mesh, x.detach()) for x in (c_loss, acc))
        return {"loss": c_loss + pre.diversity_weight * d_loss.detach(),
                "contrastive": c_loss, "diversity": d_loss.detach(),
                "accuracy": acc, "perplexity": perplexity.detach(),
                "grad_norm": grad_norm,
                "audio_seconds": _global_sum(mesh, audio_lengths.sum() / sr)}

    return step


def make_byol_step(cfg: Config, model: BYOLPretrain, optimizer: Optimizer,
                   frontend: Optional[MelFrontend] = None,
                   mesh=None) -> Callable:
    """-> step(audio, audio_lengths, step_index) -> {loss, grad_norm,
    audio_seconds}. Both SpecAugment views ride one 2B-row batch through
    each tower (the online BatchNorm normalises over 2B); the loss is the
    symmetric cross-view regression; after the update the target's encoder
    and projector move toward the online ones by ``pretrain.ema_decay``.
    Under ``mesh`` the arguments are this rank's stripe of the global
    batch."""
    _refuse_accumulation(cfg)
    pre = cfg.pretrain
    device = next(model.parameters()).device
    frontend = frontend or MelFrontend(cfg.audio, device=device)
    sr = cfg.audio.sample_rate

    def step(audio: torch.Tensor, audio_lengths: torch.Tensor,
             step_index: int) -> Dict[str, torch.Tensor]:
        model.train()
        gen = step_generator(cfg.train.seed, step_index)
        with torch.no_grad():
            mels = frontend(audio)
        mel_lengths = frontend.frame_lengths(audio_lengths)
        b = mels.shape[0]
        rows, n = _rows(mesh, b)
        view1 = spec_augment(gen, mels, cfg.augment, mel_lengths, rows, n)
        view2 = spec_augment(gen, mels, cfg.augment, mel_lengths, rows, n)
        views = torch.cat([view1, view2])
        lengths2 = torch.cat([mel_lengths, mel_lengths])
        dropout_seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
        with torch.no_grad():
            tgt, out_lengths2 = model.target(views, lengths2)
        tgt1, tgt2 = tgt[:b], tgt[b:]
        frame_mask = padding_mask(out_lengths2[:b], tgt.shape[1])
        count = _global_sum(mesh, frame_mask.float().sum())
        optimizer.zero_grad()
        with _view_rows(mesh, rows, n):
            p, _ = model.online(views, lengths2, dropout_seed)
            # each view's prediction regresses the OTHER view's target
            loss = 0.5 * (byol_loss(p[:b], tgt2, frame_mask, count)
                          + byol_loss(p[b:], tgt1, frame_mask, count))
            loss.backward()
        grad_norm = optimizer.step()
        ema_update(model.target, model.online, pre.ema_decay)
        return {"loss": _global_sum(mesh, loss.detach()),
                "grad_norm": grad_norm,
                "audio_seconds": _global_sum(mesh, audio_lengths.sum() / sr)}

    return step


def _view_rows(mesh, rows: slice, n: int):
    """Under a mesh, the global rows of [view 1 of the stripe; view 2 of
    it] in one device's [view 1; view 2] batch of 2n rows (hash dropout's
    coordinates)."""
    if mesh is None:
        return contextlib.nullcontext()
    own = torch.arange(rows.start, rows.stop)
    return mesh.row_map(torch.cat([own, own + n]))


def make_pretrain_step(cfg: Config, model: nn.Module, optimizer: Optimizer,
                       frontend: Optional[MelFrontend] = None,
                       mesh=None) -> Callable:
    """The step of ``pretrain.method``."""
    make = (make_wav2vec2_step if _method(cfg.pretrain.method) == "wav2vec2"
            else make_byol_step)
    return make(cfg, model, optimizer, frontend, mesh)


# ---------------------------------------------------------------------------
# The pretraining loop
# ---------------------------------------------------------------------------

class Pretrainer:
    """The loop of ``cli.pretrain``: per-epoch shuffled batches of a
    manifest (a ``path`` column is enough), the step of
    ``pretrain.method``, metrics under ``pretrain/`` in metrics.jsonl,
    checkpoints every ``train.checkpoint_every_steps`` and at each epoch's
    end, and resume from the newest checkpoint. Runs on the CUDA device
    unless ``device="cpu"``.

    Under a mesh (``mesh=``, or ``parallel.dp * parallel.tp > 1`` over the
    launcher's process group), as the supervised Trainer: every rank loads
    the global batch and takes its data rank's stripe (``multihost``: each
    node its stripe of the manifest), the model (both BYOL towers) is split
    over the model group, rank 0 alone prints, logs and writes
    checkpoints, and the checkpoints keep the single-device format, so a
    run resumes under another mesh or none."""

    def __init__(self, cfg: Config, tokenizer: GraphemeTokenizer,
                 logger: Optional[MetricsLogger] = None, device="cuda",
                 mesh=None, multihost: bool = False):
        _refuse_accumulation(cfg)
        self.cfg, self.tok = cfg, tokenizer
        self.method = _method(cfg.pretrain.method)
        self.device = resolve_device(local_device(device))
        if mesh is None and cfg.parallel.dp * cfg.parallel.tp > 1:
            init_process_group(self.device)
            mesh = mesh_from_config(cfg.parallel, self.device)
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        self.loader_ranks, self.loaders = loader_layout(mesh, multihost)
        if not self.lead:
            logger = MetricsLogger(None)
        self.logger = logger or MetricsLogger(cfg.train.checkpoint_dir)
        self.dataset = ManifestDataset(cfg.data.train_manifest,
                                       cfg.audio.sample_rate,
                                       num_examples=cfg.data.num_examples)
        steps_per_epoch = max(len(self.dataset) // cfg.data.batch_size, 1)
        model = build_pretrain_model(cfg, seed=cfg.train.seed)
        if mesh is not None:
            shard_model(model, mesh, cfg.model)
        self.model = model.to(self.device)
        self.optimizer = make_optimizer(cfg.optim, self.model.parameters(),
                                        steps_per_epoch, mesh,
                                        zero=cfg.parallel.zero)
        self.step, self.epoch = 0, 0
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir,
                                      keep=cfg.train.keep_checkpoints,
                                      mesh=mesh)
        if cfg.train.resume and self.ckpt.latest_step() is not None:
            self.step, self.epoch = self.ckpt.restore(self.model,
                                                      self.optimizer)
            self.print(f"[pretrain] resumed from step {self.step} "
                       f"(epoch {self.epoch})")
        self.start_step = self.step
        self.train_step = make_pretrain_step(
            cfg, self.model, self.optimizer,
            MelFrontend(cfg.audio, device=self.device), mesh)
        where = "" if mesh is None else (
            f", mesh dp {mesh.dp} x tp {mesh.tp}"
            f"{' zero' if cfg.parallel.zero else ''}"
            f"{' seq_shard' if cfg.model.seq_shard else ''}")
        self.print(f"[pretrain] {self.method}: params "
                   f"{param_count(self.model) / 1e6:.1f}M a rank, device "
                   f"{self.device}{where}")

    def print(self, *args) -> None:
        if self.lead:
            print(*args, flush=True)

    def _device_batch(self, batch: Batch):
        """The batch on the device; under a mesh, this rank's stripe."""
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)
        arrays = batch_stripe((batch.audio,
                               batch.audio_lengths.astype(np.int64)),
                              self.mesh, *self.loader_ranks)
        return tuple(to(a) for a in arrays)

    def save(self, epoch: int) -> None:
        self.ckpt.save(self.model, self.optimizer, self.step, epoch)

    def fit(self) -> None:
        """Train until ``train.num_steps`` or ``train.num_epochs``, then
        wait for the last checkpoint's write (on a raise too). Device
        values are read only at log points (which synchronise, so
        ``step_seconds`` is the device-complete wall per step since the
        last one); a non-finite loss there raises."""
        try:
            self._fit()
        except BaseException:
            self.ckpt.wait(barrier=False)   # this rank alone may have raised
            raise
        self.ckpt.wait()

    def _fit(self) -> None:
        cfg = self.cfg
        shard = {}
        if self.loaders > 1:    # each node reads its stripe of the manifest
            shard = dict(shard_index=self.loader_ranks[0]
                         // self.loader_ranks[1], shard_count=self.loaders)
        loader = BucketedLoader(self.dataset, self.tok, cfg.data,
                                training=True, **shard)
        sr = cfg.audio.sample_rate
        done = False
        for epoch in range(self.epoch, cfg.train.num_epochs):
            meter = Throughput()
            t_log, steps_since = time.perf_counter(), 0
            for batch in loader.epoch(epoch):
                metrics = self.train_step(*self._device_batch(batch),
                                          self.step)
                self.step += 1
                steps_since += 1
                meter.update(float(batch.audio_lengths.sum()) * self.loaders
                             / sr)
                if (cfg.train.log_every_steps
                        and self.step % cfg.train.log_every_steps == 0):
                    scalars = {k: float(v) for k, v in metrics.items()}
                    now = time.perf_counter()
                    if not math.isfinite(scalars["loss"]):
                        raise FloatingPointError(
                            f"non-finite loss at step {self.step}")
                    scalars["step_seconds"] = (now - t_log) / steps_since
                    scalars.update(meter.snapshot())
                    if self.device.type == "cuda":
                        scalars["peak_memory_gb"] = (
                            torch.cuda.max_memory_allocated(self.device) / 1e9)
                    self.logger.log(self.step, scalars, prefix="pretrain/")
                    self.print(f"[{self.method} step {self.step}] "
                               + " ".join(f"{k}={v:.4f}"
                                          for k, v in scalars.items()))
                    t_log, steps_since = now, 0
                if (cfg.train.checkpoint_every_steps
                        and self.step % cfg.train.checkpoint_every_steps == 0):
                    self.save(epoch)
                if cfg.train.num_steps and self.step >= cfg.train.num_steps:
                    done = True
                    break
            self.epoch = epoch + 1
            self.save(self.epoch)
            if done:
                break


# ---------------------------------------------------------------------------
# Weight transfer into the supervised model
# ---------------------------------------------------------------------------

def load_pretrained_params(cfg: Config, directory: str,
                           method: str = "wav2vec2"
                           ) -> Dict[str, torch.Tensor]:
    """The parameters (no buffers) of the newest checkpoint in a pretrain
    checkpoint directory, by name: the wav2vec2 model's, or BYOL's online
    tower's (``encoder.*``, ``projector.*``, ``predictor.*``). The model
    is rebuilt from ``cfg`` to read it, so a checkpoint of another shape
    raises."""
    model = build_pretrain_model(cfg, method, seed=None)
    CheckpointManager(directory).restore(model)
    if method == "byol":
        model = model.online
    return {n: p.detach() for n, p in model.named_parameters()}


def _encoder_units(encoder: nn.Module) -> List[str]:
    """The encoder's parts that transfer whole: its direct children with
    parameters, the block stack as one (the JAX package's scan layout) or,
    under ``use_scan_layers=False``, each block alone."""
    units = [n for n, m in encoder.named_children()
             if n != "blocks" and any(True for _ in m.parameters())]
    if encoder.cfg.use_scan_layers:
        return units + ["blocks"]
    return units + [f"blocks.{i}" for i in range(len(encoder.blocks))]


@torch.no_grad()
def transfer_encoder(pretrained: Dict[str, torch.Tensor], model: nn.Module,
                     method: str = "wav2vec2") -> List[str]:
    """Copy pretrained encoder weights into ``model.encoder`` (a CTC
    ``Conformer`` or a ``Transducer``: the prediction and joint networks
    stay as they are). A part of the encoder transfers when the pretrained
    parameters under its name (``encoder.<part>`` for BYOL, ``<part>`` for
    wav2vec2) are the same names with the same shapes. Only parameters
    move: BatchNorm statistics stay the model's, as in the JAX package.
    -> the parts copied; raises when none is."""
    prefix = "encoder." if _method(method) == "byol" else ""
    params = dict(model.encoder.named_parameters())
    copied = []
    for unit in _encoder_units(model.encoder):
        dst = {n: p for n, p in params.items() if n.startswith(unit + ".")}
        src = {k[len(prefix):]: v for k, v in pretrained.items()
               if k.startswith(prefix + unit + ".")}
        if src.keys() == dst.keys() and all(
                src[n].shape == p.shape for n, p in dst.items()):
            for n, p in dst.items():
                p.copy_(src[n])
            copied.append(unit)
    if not copied:
        raise ValueError("no encoder weights transferred: structure mismatch")
    return copied


def init_encoder_from(cfg: Config, model: nn.Module) -> List[str]:
    """``train.init_encoder_from``'s pretrained encoder (its newest
    checkpoint, by ``train.init_encoder_method``) into ``model``."""
    method = cfg.train.init_encoder_method
    pre = load_pretrained_params(cfg, cfg.train.init_encoder_from, method)
    copied = transfer_encoder(pre, model, method)
    print(f"[trainer] encoder initialized from {cfg.train.init_encoder_from} "
          f"({method}: {', '.join(copied)})")
    return copied
