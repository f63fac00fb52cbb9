"""Train, forward and eval steps: audio -> log-mels -> (SpecAugment) -> model
-> CTC or RNN-T loss / greedy tokens (counterpart of
conformer_tpu/train/steps.py).

PyTorch runs eagerly, so a "step" is a plain function over a model that
holds its weights (and, for training, an optimizer from train/state.py).
Mixed precision as in the JAX package: the compute dtype (bf16 by default)
in the model, fp32 parameters, fp32 logits and loss. ``make_train_step`` and
``make_eval_step`` dispatch on ``model.arch``: the transducer trains on the
lattice-free ``rnnt_loss_scan`` (or, with ``rnnt_loss_impl='lattice'``, on
the full joint lattice) and decodes greedily, or by its beam search
(ops/rnnt.py). Its train step honours ``optim.accum_steps`` as the CTC one
does; the JAX transducer step ignores it.

Under a mesh (parallel/mesh.py) a step takes this rank's stripe of the
global batch: SpecAugment draws for the whole batch and keeps the rank's
rows, each loss is the rank's rows' sum over the global count of rows with
a transcript (so the data group's sum of gradients is the global mean's,
and a stripe without transcripts adds nothing), micro-batches split the
stripe, and the loss and audio seconds returned are the global ones.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from conformer_tpu_torch.audio.augment import spec_augment
from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.ops.ctc import ctc_loss, greedy_decode
from conformer_tpu_torch.ops.rnnt import (rnnt_beam_search_sharded,
                                          rnnt_greedy_decode,
                                          rnnt_loss_from_logits,
                                          rnnt_loss_scan)
from conformer_tpu_torch.train.state import Optimizer


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of train step ``step``: SpecAugment's draws, then
    the dropout seeds. Seeded by (seed, step), so a resumed run draws what
    an uninterrupted one would have."""
    return torch.Generator().manual_seed(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(step) & 0xFFFFFFFF))


def _ctc_train_loss(model, mels, mel_lengths, tokens, token_lengths, seed,
                    count=None):
    logits, out_lengths = model(mels, mel_lengths, dropout_seed=seed)
    return ctc_loss(logits, out_lengths, tokens, token_lengths,
                    row_mask=token_lengths > 0, count=count)


def _global_count(mesh, token_lengths: torch.Tensor):
    """The global batch's count of rows with a transcript, or None without
    a mesh."""
    if mesh is None:
        return None
    return mesh.data_count((token_lengths > 0).float().sum())


def _transducer_train_loss(cfg: Config) -> Callable:
    impl = cfg.model.rnnt_loss_impl
    if impl not in ("scan", "lattice"):
        raise ValueError(f"rnnt_loss_impl must be scan|lattice, got {impl!r}")

    def loss(model, mels, mel_lengths, tokens, token_lengths, seed,
             count=None):
        if impl == "lattice":
            lattice, enc_lengths = model(mels, mel_lengths, tokens,
                                         dropout_seed=seed)
            return rnnt_loss_from_logits(lattice, tokens, enc_lengths,
                                         token_lengths,
                                         row_mask=token_lengths > 0,
                                         count=count)
        (e, p), enc_lengths = model.forward_factors(mels, mel_lengths, tokens,
                                                    dropout_seed=seed)
        out = model.joint.out
        return rnnt_loss_scan(e, p, out.weight, out.bias, tokens, enc_lengths,
                              token_lengths, row_mask=token_lengths > 0,
                              count=count)

    return loss


def make_train_step(cfg: Config, model: torch.nn.Module, optimizer: Optimizer,
                    frontend: Optional[MelFrontend] = None,
                    mesh=None) -> Callable:
    """-> step(audio (B, S) fp32, audio_lengths (B,), tokens (B, N),
    token_lengths (B,), step_index) -> {loss, grad_norm, audio_seconds} as
    device scalars. Order: log-mels (no gradient) -> SpecAugment -> model in
    training mode -> the loss of ``model.arch`` (CTC, or RNN-T) over the
    rows with a transcript -> backward -> optimizer. ``optim.accum_steps >
    1`` runs that many micro-batches in sequence, averages their gradients
    and threads the BatchNorm statistics through them in order. Under
    ``mesh`` the arguments are this rank's stripe of the global batch."""
    loss_fn = (_transducer_train_loss(cfg) if cfg.model.arch == "transducer"
               else _ctc_train_loss)
    device = next(model.parameters()).device
    frontend = frontend or MelFrontend(cfg.audio, device=device)
    accum = max(cfg.optim.accum_steps, 1)
    sr = cfg.audio.sample_rate

    def step(audio: torch.Tensor, audio_lengths: torch.Tensor,
             tokens: torch.Tensor, token_lengths: torch.Tensor,
             step_index: int) -> Dict[str, torch.Tensor]:
        model.train()
        gen = step_generator(cfg.train.seed, step_index)
        with torch.no_grad():
            mels = frontend(audio)
        mel_lengths = frontend.frame_lengths(audio_lengths)
        b = audio.shape[0]
        if mesh is None:
            mels = spec_augment(gen, mels, cfg.augment, mel_lengths)
        else:
            off = mesh.batch_offset(b)
            mels = spec_augment(gen, mels, cfg.augment, mel_lengths,
                                slice(off, off + b), b * mesh.dp)
        seeds = torch.randint(0, 2 ** 62, (accum,), generator=gen).tolist()
        if b % accum:
            raise ValueError(f"batch {b} does not split into {accum} "
                             "micro-batches")
        m = b // accum
        optimizer.zero_grad()
        loss_sum = torch.zeros((), device=audio.device)
        for i in range(accum):
            sl = slice(i * m, (i + 1) * m)
            loss = loss_fn(model, mels[sl], mel_lengths[sl], tokens[sl],
                           token_lengths[sl], seeds[i],
                           _global_count(mesh, token_lengths[sl]))
            (loss / accum).backward()
            loss_sum = loss_sum + loss.detach()
        grad_norm = optimizer.step()
        if mesh is not None:
            sums = mesh.data_count(torch.stack([loss_sum / accum,
                                                audio_lengths.sum() / sr]))
            return {"loss": sums[0], "grad_norm": grad_norm,
                    "audio_seconds": sums[1]}
        return {"loss": loss_sum / accum, "grad_norm": grad_norm,
                "audio_seconds": audio_lengths.sum() / sr}

    return step


def _global_loss(mesh, loss: torch.Tensor) -> torch.Tensor:
    """A rank's share of a loss -> the global loss (the data group's sum)."""
    return loss if mesh is None else mesh.data_count(loss)


def make_forward(cfg: Config, model: torch.nn.Module,
                 frontend: Optional[MelFrontend] = None) -> Callable:
    """-> forward(audio (B, S) fp32, audio_lengths (B,)) -> the model's
    output on its device, without autograd and with the running BatchNorm
    statistics: CTC (logits fp32 (B, T', V), lengths (B,)); the transducer
    (encodings (B, T', D), lengths) from its encoder."""
    device = next(model.parameters()).device
    frontend = frontend or MelFrontend(cfg.audio, device=device)

    @torch.inference_mode()
    def forward(audio: torch.Tensor, audio_lengths: torch.Tensor):
        model.eval()
        mels = frontend(audio)
        run = model.encode if cfg.model.arch == "transducer" else model
        return run(mels, frontend.frame_lengths(audio_lengths))

    return forward


def make_eval_step(cfg: Config, model: torch.nn.Module,
                   frontend: Optional[MelFrontend] = None,
                   unk_id: Optional[int] = None, mesh=None) -> Callable:
    """-> step(audio, audio_lengths[, tokens, token_lengths]) -> {tokens,
    counts, log_probs, lengths} (+ ``loss`` when transcripts are given, over
    the rows that have one): collapsed greedy tokens on the device, text
    assembly left to the host. The transducer's step is
    make_transducer_eval_step's. Under ``mesh`` the arguments are this
    rank's stripe, the tokens its rows', the loss the global one."""
    if cfg.model.arch == "transducer":
        return make_transducer_eval_step(cfg, model, frontend, mesh=mesh)
    forward = make_forward(cfg, model, frontend)

    @torch.inference_mode()
    def step(audio: torch.Tensor, audio_lengths: torch.Tensor,
             tokens: Optional[torch.Tensor] = None,
             token_lengths: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        logits, out_lengths = forward(audio, audio_lengths)
        ids, counts = greedy_decode(logits, out_lengths, unk_id=unk_id)
        out = {"tokens": ids, "counts": counts,
               "log_probs": torch.log_softmax(logits, dim=-1),
               "lengths": out_lengths}
        if tokens is not None:
            out["loss"] = _global_loss(mesh, ctc_loss(
                logits, out_lengths, tokens, token_lengths,
                row_mask=token_lengths > 0,
                count=_global_count(mesh, token_lengths)))
        return out

    return step


def make_transducer_eval_step(cfg: Config, model: torch.nn.Module,
                              frontend: Optional[MelFrontend] = None,
                              decode: str = "greedy",
                              unk_id: Optional[int] = None,
                              lm_kwargs: Optional[dict] = None,
                              mesh=None) -> Callable:
    """-> step(audio, audio_lengths[, tokens, token_lengths]) -> {tokens,
    counts, lengths} (+ ``loss``, the lattice-free RNN-T loss over the rows
    with a transcript, when transcripts are given): the emitted tokens
    under the CTC eval step's keys, so that validation and the pipeline
    assemble texts the same way. ``decode="greedy"``: the greedy decode,
    ``decode.rnnt_max_symbols`` tokens a frame at most, ``data.max_tokens``
    a row. ``decode="beam"``: the best beam of the RNN-T beam search at
    ``decode.beam_width`` (``rnnt_top_k``, ``rnnt_max_symbols``,
    ``rnnt_length_norm``, ``device_scan_unroll``; never ``unk_id``), fused
    by ``lm_kwargs`` (decode/pipeline.py::device_lm_kwargs), and its
    ``scores``. ``mesh``: as make_eval_step's; the beam search then runs
    through ``rnnt_beam_search_sharded`` on the rank's stripe, the LM
    table's buckets split over the model group."""
    if decode not in ("greedy", "beam"):
        raise ValueError(f"transducer decode must be greedy|beam, got "
                         f"{decode!r}")
    forward = make_forward(cfg, model, frontend)
    dc = cfg.decode

    @torch.inference_mode()
    def step(audio: torch.Tensor, audio_lengths: torch.Tensor,
             tokens: Optional[torch.Tensor] = None,
             token_lengths: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
        enc, enc_lengths = forward(audio, audio_lengths)
        joint_fn, pred_step_fn = (model.beam_fns() if decode == "beam"
                                  else model.greedy_fns())
        pred_init = model.predict_init(enc.shape[0], enc.device)
        if decode == "beam":
            prefixes, plens, scores = rnnt_beam_search_sharded(
                joint_fn, enc, enc_lengths, pred_step_fn, pred_init,
                mesh=mesh, striped=True, beam_width=dc.beam_width, top_k=dc.rnnt_top_k,
                max_symbols=dc.rnnt_max_symbols, max_len=cfg.data.max_tokens,
                unk_id=unk_id, length_norm=dc.rnnt_length_norm,
                scan_unroll=dc.device_scan_unroll, **(lm_kwargs or {}))
            out = {"tokens": prefixes[:, 0], "counts": plens[:, 0],
                   "scores": scores[:, 0], "lengths": enc_lengths}
        else:
            ids, counts = rnnt_greedy_decode(
                joint_fn, enc, enc_lengths, pred_step_fn, pred_init,
                max_symbols=dc.rnnt_max_symbols, max_len=cfg.data.max_tokens)
            out = {"tokens": ids, "counts": counts, "lengths": enc_lengths}
        if tokens is not None:
            e, p = model.joint.factors(enc, model.prediction(tokens))
            out["loss"] = _global_loss(mesh, rnnt_loss_scan(
                e, p, model.joint.out.weight, model.joint.out.bias, tokens,
                enc_lengths, token_lengths, row_mask=token_lengths > 0,
                count=_global_count(mesh, token_lengths)))
        return out

    return step
