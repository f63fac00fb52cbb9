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
int32, counts (B,) int32), as the JAX artifact does. The kernels K1, K3 and
K4a are ``torch.library`` custom ops (``conformer_tpu_torch::*``), so they
are nodes of the program: it runs them on the card and their plain versions
on the CPU. The frame loops (the CTC head's LSTM, the transducer's
T' x max_symbols greedy rounds) are unrolled into the program.
``ExportedModel`` loads a directory on a device of the caller's choice.
"""

from __future__ import annotations

import gc
import json
import os
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.decode.pipeline import resolve_device
from conformer_tpu_torch.ops.rnnt import rnnt_greedy_decode

EXPORT_BEAM_NOT_PORTED = (
    "decode='beam' export bakes the device beam search (CTC or RNN-T) into "
    "the program, which is not ported yet: torch.export unrolls its frame "
    "loop (ROADMAP.md §1, item 3); export decode='logits' and run the "
    "device search on the program's outputs")


class _Program(nn.Module):
    """audio (B, S) fp32, lengths (B,) -> the artifact's outputs."""

    def __init__(self, cfg: Config, model: nn.Module, frontend: MelFrontend):
        super().__init__()
        self.cfg, self.model, self.frontend = cfg, model, frontend

    def forward(self, audio: torch.Tensor, lengths: torch.Tensor):
        mels = self.frontend(audio)
        mel_lengths = self.frontend.frame_lengths(lengths)
        if self.cfg.model.arch != "transducer":
            return self.model(mels, mel_lengths)
        model = self.model
        enc, enc_lengths = model.encode(mels, mel_lengths)
        joint_fn, pred_step_fn = model.greedy_fns()
        return rnnt_greedy_decode(
            joint_fn, enc, enc_lengths, pred_step_fn,
            model.predict_init(enc.shape[0], enc.device),
            max_symbols=self.cfg.decode.rnnt_max_symbols,
            max_len=self.cfg.data.max_tokens)


def export_model(cfg: Config, model: nn.Module, out_dir: str,
                 batch_size: int = 1,
                 audio_seconds: Tuple[float, ...] = (8.0,),
                 decode: str = "logits", tokenizer=None) -> List[str]:
    """Export ``model`` (on its device, in eval mode) with its frontend, one
    program per bucket of ``audio_seconds``; -> the program files.
    ``decode='beam'`` raises: a program with the device beam search
    baked in is not ported. ``tokenizer`` is what the beam would need,
    unused until then."""
    del tokenizer
    if decode == "beam":
        raise NotImplementedError(EXPORT_BEAM_NOT_PORTED)
    if decode != "logits":
        raise ValueError(f"decode must be logits|beam, got {decode!r}")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    device = next(model.parameters()).device
    program = _Program(cfg, model.eval(), MelFrontend(cfg.audio, device))
    sr = cfg.audio.sample_rate
    files = []
    for seconds in audio_seconds:
        n = int(seconds * sr)
        example = (torch.zeros(batch_size, n, device=device),
                   torch.full((batch_size,), n, dtype=torch.int64,
                              device=device))
        with torch.no_grad():
            program(*example)     # eager: builds the cached constant tables
            gc.disable()          # tracing builds ~1e5 objects a program
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
                        else "logits_lengths"),
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
