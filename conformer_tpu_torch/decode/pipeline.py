"""Inference pipeline: weights -> batched greedy transcription and
evaluation (counterpart of conformer_tpu/decode/pipeline.py, greedy decode
only).

Runs on the CUDA device unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU it raises. Weights come from a
``torch.save``d state dict (``conformer_tpu_torch.convert`` writes one from
a JAX checkpoint), from the newest checkpoint that training wrote to a
checkpoint directory, or, with neither, from a seeded random init.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from conformer_tpu_torch.audio.io import load_audio, split_segment
from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.data.dataset import BucketedLoader, ManifestDataset
from conformer_tpu_torch.models.conformer import Conformer, init_weights
from conformer_tpu_torch.text.metrics import cer, wer
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
from conformer_tpu_torch.train.checkpoint import CheckpointManager
from conformer_tpu_torch.train.steps import make_eval_step


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device; a CUDA device that does not exist raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


class InferencePipeline:
    """Builds the model on ``device``, transcribes batches greedily and
    evaluates manifests.

    ``batch_log`` records one entry per batch: its size, its audio seconds,
    the padded seconds the model ran on and the wall seconds it took (the
    device synchronised before the clock is read)."""

    def __init__(self, cfg: Config, tokenizer: GraphemeTokenizer,
                 weights: Optional[str] = None, decode: str = "greedy",
                 device="cuda", seed: int = 0,
                 checkpoint_dir: Optional[str] = None):
        if decode != "greedy":
            raise NotImplementedError(
                f"decode={decode!r}: beam search (host and device) and LM "
                "fusion are not ported yet; only 'greedy' runs")
        if weights and checkpoint_dir:
            raise ValueError("give weights or checkpoint_dir, not both")
        self.device = resolve_device(device)
        cfg = cfg.override(**{"model.vocab_size": tokenizer.vocab_size})
        self.cfg, self.tok, self.decode = cfg, tokenizer, decode
        model = Conformer(cfg.model, cfg.optim.compute_dtype)
        ckpt = (CheckpointManager(checkpoint_dir)
                if checkpoint_dir and os.path.isdir(checkpoint_dir) else None)
        if weights:
            state = torch.load(weights, map_location="cpu")
            model.load_state_dict(state)
            print(f"[infer] loaded weights from {weights}")
        elif ckpt is not None and ckpt.latest_step() is not None:
            step, _ = ckpt.restore(model)
            print(f"[infer] restored step {step} from {checkpoint_dir}")
        else:
            where = f"no checkpoint in {checkpoint_dir}" if checkpoint_dir \
                else "no weights given"
            print(f"[infer] WARNING: {where}; seeded random weights "
                  f"(seed {seed})")
            init_weights(model, seed)
        self.model = model.to(self.device).eval()
        self.frontend = MelFrontend(cfg.audio, device=self.device)
        self.eval_step = make_eval_step(cfg, self.model, self.frontend,
                                        unk_id=tokenizer.unk_id)
        self.batch_log: List[dict] = []

    def texts_from_out(self, out: dict) -> List[str]:
        tokens = out["tokens"].cpu().numpy()
        counts = out["counts"].cpu().numpy()
        return [self.tok.collapsed_ids_to_text(tokens[i], counts[i])
                for i in range(len(counts))]

    def _run_batch(self, audio: np.ndarray, audio_lengths: np.ndarray,
                   tokens: Optional[np.ndarray] = None,
                   token_lengths: Optional[np.ndarray] = None
                   ) -> Tuple[dict, List[str]]:
        """One eval step on the device -> (its outputs, texts); logs the
        batch in ``batch_log``."""
        t0 = time.perf_counter()
        to = lambda a, dt: torch.from_numpy(
            np.ascontiguousarray(a, dt)).to(self.device)
        args = [to(audio, np.float32), to(audio_lengths, np.int64)]
        if tokens is not None:
            args += [to(tokens, np.int64), to(token_lengths, np.int64)]
        out = self.eval_step(*args)
        texts = self.texts_from_out(out)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        sr = self.cfg.audio.sample_rate
        self.batch_log.append({
            "batch_size": int(audio.shape[0]),
            "audio_s": float(np.sum(audio_lengths)) / sr,
            "padded_s": float(audio.shape[1]) / sr,
            "seconds": time.perf_counter() - t0})
        return out, texts

    def transcribe_batch(self, audio: np.ndarray, audio_lengths: np.ndarray
                         ) -> List[str]:
        """audio (B, S) float32 zero-padded; audio_lengths (B,) samples."""
        return self._run_batch(audio, audio_lengths)[1]

    def transcribe_files(self, paths: Sequence[str], batch_size: int = 8,
                         channel: Optional[int] = None,
                         segments: Optional[Sequence[Tuple[float, float]]] = None
                         ) -> List[str]:
        """Transcribe audio files in batches of ``batch_size``; ``channel``
        picks one channel of multi-channel files and ``segments`` gives an
        optional (start_s, end_s) span per path."""
        sr = self.cfg.audio.sample_rate
        cache: dict = {}

        def load(idx: int) -> np.ndarray:
            path = paths[idx]
            if path not in cache:
                cache.clear()            # one-file cache
                cache[path] = load_audio(path, sr, channel=channel)
            sig = cache[path]
            if segments is not None:
                sig = split_segment(sig, *segments[idx], sr)
            return sig

        results: List[str] = []
        for i in range(0, len(paths), batch_size):
            signals = [load(j) for j in range(i, min(i + batch_size, len(paths)))]
            size = max(max(len(s) for s in signals), self.cfg.audio.hop_length)
            audio = np.zeros((len(signals), size), np.float32)
            lengths = np.zeros((len(signals),), np.int64)
            for j, s in enumerate(signals):
                audio[j, : len(s)] = s
                lengths[j] = len(s)
            results.extend(self.transcribe_batch(audio, lengths))
        return results

    def transcribe_long(self, path: str, chunk_s: float = 24.0,
                        overlap_s: float = 2.0,
                        channel: Optional[int] = None) -> str:
        """Transcribe long audio in overlapping chunks of ``chunk_s`` seconds,
        trimming each chunk's edge words inside the overlap and stitching."""
        sr = self.cfg.audio.sample_rate
        signal = load_audio(path, sr, channel=channel)
        chunk = int(chunk_s * sr)
        if len(signal) <= chunk:
            return self.transcribe_files([path], channel=channel)[0]
        hop = chunk - int(overlap_s * sr)
        starts = list(range(0, max(len(signal) - int(overlap_s * sr), 1), hop))
        pieces: List[str] = []
        for ci in range(0, len(starts), 8):
            batch_starts = starts[ci: ci + 8]
            audio = np.zeros((len(batch_starts), chunk), np.float32)
            lengths = np.zeros((len(batch_starts),), np.int64)
            for j, s0 in enumerate(batch_starts):
                seg = signal[s0: s0 + chunk]
                audio[j, : len(seg)] = seg
                lengths[j] = len(seg)
            pieces.extend(self.transcribe_batch(audio, lengths))
        stitched: List[str] = []
        for i, text in enumerate(pieces):
            words = text.split()
            if i > 0 and words:
                words = words[1:]
            if i < len(pieces) - 1 and words:
                words = words[:-1]
            stitched.extend(words)
        return " ".join(stitched)

    def evaluate(self, manifest: str, batch_size: Optional[int] = None
                 ) -> Tuple[dict, List[Tuple[str, str]]]:
        """-> (metrics {loss, wer, cer}, [(ref, hyp), ...]) over a CSV
        manifest of (path, text) rows: the mean eval-step CTC loss over the
        batches, and corpus WER/CER x100 against the cleaned, upper-cased
        transcripts. Rows without a transcript count in no metric."""
        data_cfg = self.cfg.data
        ds = ManifestDataset(manifest, self.cfg.audio.sample_rate,
                             num_examples=data_cfg.num_examples)
        loader = BucketedLoader(ds, self.tok, data_cfg, training=False,
                                batch_size=batch_size or data_cfg.batch_size)
        refs, hyps, losses = [], [], []
        for batch in loader.epoch(0):
            out, texts = self._run_batch(batch.audio, batch.audio_lengths,
                                         batch.tokens, batch.token_lengths)
            losses.append(float(out["loss"]))
            for i, ref_text in enumerate(batch.texts or []):
                if not ref_text:
                    continue
                refs.append(self.tok.clean_text(ref_text.upper()))
                hyps.append(texts[i])
        metrics = {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "wer": wer(hyps, refs) * 100 if refs else float("nan"),
            "cer": cer(hyps, refs) * 100 if refs else float("nan"),
        }
        return metrics, list(zip(refs, hyps))
