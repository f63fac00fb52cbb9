"""Model export: the whole audio -> output pipeline as ``torch.export``
programs, one per audio-length bucket (counterpart of conformer_tpu/export.py,
whose artifact is a ``jax.export`` StableHLO bundle).

Artifacts (a directory):
  model_b{B}_{S}s.pt2  one ``torch.export.save`` program per bucket of S
                       seconds at batch B, the weights inside
  config.json          the full Config
  meta.json            the JAX artifact's keys, with "framework":
                       "conformer_tpu_torch", the device exported on and
                       the seconds the export took

A CTC program returns (logits (B, T', V) fp32, lengths); a transducer
program runs the greedy decode too and returns (tokens (B, max_tokens)
int32, counts (B,) int32), as the JAX artifact does. With ``decode="beam"``
a program returns the best beam's (tokens (B, max_tokens) int32, counts
(B,) int32) of the device beam search (ops/beam_search_device.py for CTC,
ops/rnnt.py::rnnt_beam_search for the transducer) at ``cfg.decode``'s
width, fused with the LM of ``decode.device_lm_path`` (token level) or
``decode.lm_path`` (word level, with ``decode.hotwords``): the n-gram,
word-vocabulary and hotword tables are constants of the program. The
kernels K1, K3 and K4a are ``torch.library`` custom ops
(``conformer_tpu_torch::*``), so they are nodes of the program: it runs
them on the card and their plain versions on the CPU. Every frame loop
(the CTC head's LSTM, the transducer's greedy rounds, a beam search's
frame steps and its walk back) is one ``while_loop`` node
(ops/frame_graph.py::exported_loop), so a program's size and its trace
and load times do not grow with its bucket. ``ExportedModel`` loads a
directory on a device of the caller's choice.
"""

from __future__ import annotations

import gc
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.decode.pipeline import (device_lm_kwargs,
                                                 resolve_device)
from conformer_tpu_torch.ops.beam_search_device import ctc_beam_search_device
from conformer_tpu_torch.ops.rnnt import rnnt_beam_search, rnnt_greedy_decode


class _Program(nn.Module):
    """audio (B, S) fp32, lengths (B,) -> the artifact's outputs.
    ``beam``: the device search's settings besides the encoder's outputs
    (its width, the tokenizer's ids, the LM kwargs), or None."""

    def __init__(self, cfg: Config, model: nn.Module, frontend: MelFrontend,
                 beam: Optional[dict] = None):
        super().__init__()
        self.cfg, self.model, self.frontend = cfg, model, frontend
        self.beam = beam

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        mels = self.frontend(audio)
        mel_lengths = self.frontend.frame_lengths(lengths)
        model, beam = self.model, self.beam
        if self.cfg.model.arch != "transducer":
            logits, out_lengths = model(mels, mel_lengths)
            if beam is None:
                return logits, out_lengths
            prefixes, plens, _ = ctc_beam_search_device(
                torch.log_softmax(logits.float(), dim=-1), out_lengths,
                **beam)
            return prefixes[:, 0], plens[:, 0]
        enc, enc_lengths = model.encode(mels, mel_lengths)
        joint_fn, pred_step_fn = model.frame_fns()
        pred_init = model.predict_init(enc.shape[0], enc.device)
        if beam is None:
            return rnnt_greedy_decode(
                joint_fn, enc, enc_lengths, pred_step_fn, pred_init,
                max_symbols=self.cfg.decode.rnnt_max_symbols,
                max_len=self.cfg.data.max_tokens)
        prefixes, plens, _ = rnnt_beam_search(
            joint_fn, enc, enc_lengths, pred_step_fn, pred_init, **beam)
        return prefixes[:, 0], plens[:, 0]


def beam_settings(cfg: Config, tokenizer, device) -> dict:
    """The beam program's search kwargs, as the JAX export's: the width,
    top-k and caps of ``cfg.decode`` and ``cfg.data``, the tokenizer's
    unk id (and pad id as the CTC blank), and device_lm_kwargs's fusion
    with the word-level fallback, the tables on ``device``."""
    dc = cfg.decode
    kw = dict(beam_width=dc.beam_width, unk_id=tokenizer.unk_id,
              max_len=cfg.data.max_tokens,
              **device_lm_kwargs(cfg, tokenizer, device, word_fallback=True))
    if cfg.model.arch == "transducer":
        return dict(kw, top_k=dc.rnnt_top_k, max_symbols=dc.rnnt_max_symbols,
                    length_norm=dc.rnnt_length_norm)
    return dict(kw, top_k=dc.device_top_k, blank_id=tokenizer.pad_id)


def export_model(cfg: Config, model: nn.Module, out_dir: str,
                 batch_size: int = 1,
                 audio_seconds: Tuple[float, ...] = (8.0,),
                 decode: str = "logits", tokenizer=None) -> List[str]:
    """Export ``model`` (on its device, in eval mode) with its frontend, one
    program per bucket of ``audio_seconds``; -> the program files.
    ``decode='beam'`` bakes the LM-fused device beam search into each
    program and needs the ``tokenizer``."""
    if decode not in ("logits", "beam"):
        raise ValueError(f"decode must be logits|beam, got {decode!r}")
    if decode == "beam" and tokenizer is None:
        raise ValueError("decode='beam' export needs the tokenizer")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    device = next(model.parameters()).device
    beam = (beam_settings(cfg, tokenizer, device) if decode == "beam"
            else None)
    program = _Program(cfg, model.eval(), MelFrontend(cfg.audio, device),
                       beam)
    sr = cfg.audio.sample_rate
    files = []
    for seconds in audio_seconds:
        n = int(seconds * sr)
        example = (torch.zeros(batch_size, n, device=device),
                   torch.full((batch_size,), n, dtype=torch.int64,
                              device=device))
        with torch.no_grad():
            program(*example)     # eager: builds the cached constant tables
            gc.disable()          # tracing builds many objects a program
            try:
                exported = torch.export.export(program, example)
            finally:
                gc.enable()
        path = os.path.join(out_dir, f"model_b{batch_size}_{int(seconds)}s.pt2")
        torch.export.save(exported, path)
        files.append(path)
    arch = cfg.model.arch
    cfg.to_json(os.path.join(out_dir, "config.json"))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({
            "framework": "conformer_tpu_torch", "version": torch.__version__,
            "arch": arch,
            "outputs": ("tokens_counts" if arch == "transducer"
                        or decode == "beam" else "logits_lengths"),
            "decode": decode, "batch_size": batch_size,
            "audio_seconds": list(audio_seconds), "sample_rate": sr,
            "vocab_size": cfg.model.vocab_size, "blank_id": 0,
            "device": str(device),
            "export_seconds": time.perf_counter() - t0,
        }, f, indent=2)
    return files


def _samples(exported) -> int:
    """The padded sample count of a program's audio input."""
    name = exported.graph_signature.user_inputs[0]
    node = next(n for n in exported.graph.nodes if n.name == name)
    return int(node.meta["val"].shape[1])


class ExportedModel:
    """Load an exported directory onto ``device`` ('cuda' by default; a
    device that does not exist raises) and run it, without the model's
    code or weights files."""

    def __init__(self, out_dir: str, device="cuda"):
        import conformer_tpu_torch.ops.cuda  # noqa: F401  the custom ops
        from torch.export.passes import move_to_device_pass

        self.device = resolve_device(device)
        with open(os.path.join(out_dir, "meta.json")) as f:
            self.meta = json.load(f)
        self.cfg = Config.from_json(os.path.join(out_dir, "config.json"))
        self._fns: Dict[int, torch.nn.Module] = {}
        for name in sorted(os.listdir(out_dir)):
            if name.endswith(".pt2"):
                exported = move_to_device_pass(
                    torch.export.load(os.path.join(out_dir, name)),
                    self.device)
                self._fns[_samples(exported)] = exported.module()
        if not self._fns:
            raise FileNotFoundError(f"no .pt2 programs in {out_dir}")
        self._sizes = sorted(self._fns)

    def __call__(self, audio, lengths):
        """audio (B, S) fp32 and lengths (B,), numpy or tensors, B the
        exported batch -> the program's outputs on the device. S is padded
        up to the smallest bucket that holds it; past the largest, raises."""
        as_tensor = lambda x, dt: (x if torch.is_tensor(x) else
                                   torch.from_numpy(np.asarray(x))).to(
                                       self.device, dt)
        audio = as_tensor(audio, torch.float32)
        s = audio.shape[1]
        size = next((n for n in self._sizes if s <= n), None)
        if size is None:
            raise ValueError(f"audio longer than largest export bucket "
                             f"({s} > {self._sizes[-1]})")
        audio = torch.nn.functional.pad(audio, (0, size - s))
        with torch.inference_mode():
            return self._fns[size](audio, as_tensor(lengths, torch.int64))
