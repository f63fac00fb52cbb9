"""Inference pipeline: weights -> batched transcription and evaluation with
greedy decode, the host CTC beam search or the device beam searches, each
with n-gram LM fusion, and the streaming transcribers that share its model
(counterpart of conformer_tpu/decode/pipeline.py, on one device).

CTC: ``decode="beam"`` runs the host prefix beam search over the device's
log-softmax; ``"beam_device"`` the prefix beam search on the device
(ops/beam_search_device.py, through CUDA graphs on the card), with
token-level fusion from ``decode.device_lm_path`` or word-level fusion and
hotwords from ``decode.lm_path``; ``"beam_auto"`` is the device search on
the card and the host search on the CPU. ``model.arch='transducer'``
decodes greedily on the device (ops/rnnt.py::rnnt_greedy_decode), or with
any beam mode by the RNN-T beam search (ops/rnnt.py::rnnt_beam_search,
fused as the CTC device search); its eval step returns the emitted tokens
under the CTC step's keys, and the texts come from them as the CTC ones
do.

Runs on the CUDA device unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU it raises. Weights come from a
``torch.save``d state dict (``conformer_tpu_torch.convert`` writes one from
a JAX checkpoint), from the newest checkpoint that training wrote to a
checkpoint directory, or, with neither, from a seeded random init.
"""

from __future__ import annotations

import functools
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from conformer_tpu_torch.audio.io import load_audio, split_segment
from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.data.dataset import BucketedLoader, ManifestDataset
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.text.metrics import cer, wer
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
from conformer_tpu_torch.train.checkpoint import CheckpointManager
from conformer_tpu_torch.train.steps import (make_eval_step,
                                             make_transducer_eval_step)


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device; a CUDA device that does not exist raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return device


def resolve_beam_backend(device: torch.device) -> str:
    """The backend ``decode='beam_auto'`` means on ``device``, as the JAX
    ``resolve_beam_backend`` picks it for a batch: the device beam search
    wherever an accelerator runs the model ("beam_device"), the host beam
    search on the CPU ("beam")."""
    return "beam_device" if device.type == "cuda" else "beam"


def device_lm_kwargs(cfg: Config, tokenizer: GraphemeTokenizer,
                     device: torch.device, word_fallback: bool = False
                     ) -> dict:
    """The device searches' fusion kwargs (the JAX ``_device_lm_kwargs``),
    the tables on ``device``: token-level from ``decode.device_lm_path``
    (a token ARPA, ``cli.create_lm --token-level``); otherwise, with
    ``word_fallback``, word-level from ``decode.lm_path`` (the host
    decoder's word ARPA) with ``decode.hotwords``; else none."""
    from conformer_tpu_torch.lm.device_table import (DeviceHotwords,
                                                     DeviceNgramTable,
                                                     DeviceWordVocab)

    common = dict(lm_alpha=float(cfg.decode.alpha),
                  lm_beta=float(cfg.decode.beta), delim_id=tokenizer.delim_id)
    path = cfg.decode.device_lm_path or (cfg.decode.lm_path if word_fallback
                                         else None)
    if not path:
        return {}
    table = DeviceNgramTable.from_arpa(path)
    kwargs = dict(common, lm_tables=table.device_arrays(device),
                  lm_bos_id=int(table.bos_id),
                  lm_unk_logp=float(table.unk_logp), lm_order=int(table.order))
    if cfg.decode.device_lm_path:
        kwargs["tok2lm"] = torch.tensor(
            [table.vocab.get(s, -1) for s in tokenizer.vocab],
            dtype=torch.int64, device=device)
        return kwargs
    kwargs["word_arrays"] = DeviceWordVocab.build(
        tokenizer.vocab, table.vocab).device_arrays(device)
    if cfg.decode.hotwords and cfg.decode.hotword_weight:
        kwargs.update(hot_arrays=DeviceHotwords.build(
            cfg.decode.hotwords).device_arrays(device),
            hot_weight=float(cfg.decode.hotword_weight))
    return kwargs


class InferencePipeline:
    """Builds the model on ``device``, transcribes batches and evaluates
    manifests. ``decode``: "greedy" (collapse on the device), "beam" (the
    host beam search with ``cfg.decode``'s LM and hotwords over the
    device's log-softmax), "beam_device" (the device search, fused by
    device_lm_kwargs) or "beam_auto" (resolve_beam_backend); a transducer
    runs its beam search for any of the three beam modes.

    ``batch_log`` records one entry per batch: its size, its audio seconds,
    the padded seconds the model ran on, the wall seconds it took (the
    device synchronised before the clock is read) and, of those, the
    seconds the host took to turn the outputs into texts (``decode_s``);
    the oldest half is dropped past BATCH_LOG_MAX entries (a server runs
    for long). With ``keep_outputs`` set, an entry also keeps the batch on
    the host: its ``audio`` and ``audio_lengths`` and the model's fp32
    ``log_probs`` (CTC) or emitted ``tokens`` and ``counts`` (transducer)
    and frame ``lengths`` (for checks that hold served rows against another
    run)."""

    BATCH_LOG_MAX = 4096
    keep_outputs = False

    def __init__(self, cfg: Config, tokenizer: GraphemeTokenizer,
                 weights: Optional[str] = None, decode: str = "greedy",
                 device="cuda", seed: int = 0,
                 checkpoint_dir: Optional[str] = None):
        if weights and checkpoint_dir:
            raise ValueError("give weights or checkpoint_dir, not both")
        self.device = resolve_device(device)
        self.stream_decode = decode     # a stream resolves beam_auto itself
        if decode == "beam_auto":
            decode = resolve_beam_backend(self.device)
            print(f"[infer] beam_auto -> {decode}")
        if decode not in ("greedy", "beam", "beam_device"):
            raise ValueError(f"unknown decode {decode!r}")
        cfg = cfg.override(**{"model.vocab_size": tokenizer.vocab_size})
        self.cfg, self.tok, self.decode = cfg, tokenizer, decode
        model = build_model(cfg.model, cfg.optim.compute_dtype, seed=None)
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
            model = build_model(cfg.model, cfg.optim.compute_dtype, seed)
        self.model = model.to(self.device).eval()
        self.frontend = MelFrontend(cfg.audio, device=self.device)
        self._beam = self._device_beam = None
        self.batch_log: List[dict] = []
        if cfg.model.arch == "transducer":
            beam = decode != "greedy"
            self.eval_step = make_transducer_eval_step(
                cfg, self.model, self.frontend,
                decode="beam" if beam else "greedy", unk_id=tokenizer.unk_id,
                lm_kwargs=device_lm_kwargs(cfg, tokenizer, self.device,
                                           word_fallback=True) if beam
                else None)
            return
        self.eval_step = make_eval_step(cfg, self.model, self.frontend,
                                        unk_id=tokenizer.unk_id)
        if decode == "beam":
            from conformer_tpu_torch.decode.beam_search import BeamSearchDecoder

            self._beam = BeamSearchDecoder(tokenizer, cfg.decode)
        if decode == "beam_device":
            from conformer_tpu_torch.ops.beam_search_device import \
                ctc_beam_search_device

            self._device_beam = functools.partial(
                ctc_beam_search_device, beam_width=cfg.decode.beam_width,
                top_k=cfg.decode.device_top_k, blank_id=tokenizer.pad_id,
                unk_id=tokenizer.unk_id, max_len=cfg.data.max_tokens,
                scan_unroll=cfg.decode.device_scan_unroll,
                **device_lm_kwargs(cfg, tokenizer, self.device,
                                   word_fallback=True))

    def texts_from_out(self, out: dict) -> List[str]:
        """Eval-step outputs -> texts: the device beam search over the
        log-softmax (its best beam), the host beam search (fp32 on the
        host, each row to its true length), or the tokens the eval step
        emitted (greedy collapse; a transducer's best beam)."""
        if self._device_beam is not None:
            with torch.inference_mode():
                prefixes, plens, _ = self._device_beam(out["log_probs"],
                                                       out["lengths"])
            prefixes, plens = prefixes[:, 0].cpu().numpy(), plens[:, 0].cpu()
            # strip: a best beam may end in a delimiter, which the host
            # search renders without a trailing space
            return [self.tok.spec_decode(self.tok.collapsed_ids_to_text(
                        prefixes[i], int(plens[i]))).strip()
                    for i in range(len(prefixes))]
        if self._beam is not None:
            log_probs = out["log_probs"].float().cpu().numpy()
            lengths = out["lengths"].cpu().numpy()
            return self._beam.decode_batch(log_probs, lengths)
        tokens = out["tokens"].cpu().numpy()
        counts = out["counts"].cpu().numpy()
        return [self.tok.collapsed_ids_to_text(tokens[i], counts[i])
                for i in range(len(counts))]

    def run_batch(self, audio: np.ndarray, audio_lengths: np.ndarray,
                  tokens: Optional[np.ndarray] = None,
                  token_lengths: Optional[np.ndarray] = None
                  ) -> Tuple[dict, List[str]]:
        """One eval step on the device -> (its outputs: tokens, counts,
        lengths, log_probs (CTC) and, with transcripts, loss; the texts);
        logs the batch in ``batch_log``."""
        t0 = time.perf_counter()
        to = lambda a, dt: torch.from_numpy(
            np.ascontiguousarray(a, dt)).to(self.device)
        args = [to(audio, np.float32), to(audio_lengths, np.int64)]
        if tokens is not None:
            args += [to(tokens, np.int64), to(token_lengths, np.int64)]
        out = self.eval_step(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        texts = self.texts_from_out(out)
        t2 = time.perf_counter()
        sr = self.cfg.audio.sample_rate
        if len(self.batch_log) >= self.BATCH_LOG_MAX:
            del self.batch_log[: self.BATCH_LOG_MAX // 2]
        entry = {"batch_size": int(audio.shape[0]),
                 "audio_s": float(np.sum(audio_lengths)) / sr,
                 "padded_s": float(audio.shape[1]) / sr,
                 "seconds": t2 - t0, "decode_s": t2 - t1}
        if self.keep_outputs:
            entry.update(audio=np.array(audio, np.float32),
                         audio_lengths=np.array(audio_lengths),
                         lengths=out["lengths"].cpu())
            if "log_probs" in out:
                entry["log_probs"] = out["log_probs"].float().cpu()
            else:
                entry.update(tokens=out["tokens"].cpu(),
                             counts=out["counts"].cpu())
        self.batch_log.append(entry)
        return out, texts

    def transcribe_batch(self, audio: np.ndarray, audio_lengths: np.ndarray
                         ) -> List[str]:
        """audio (B, S) float32 zero-padded; audio_lengths (B,) samples."""
        return self.run_batch(audio, audio_lengths)[1]

    def streaming_transcriber(self, chunk_s: float = 2.0,
                              left_context_s: float = 6.0,
                              decode: Optional[str] = None,
                              pipeline_chunks: bool = True):
        """-> a ``StreamingTranscriber`` over this pipeline's model and
        frontend, with its config's LM and hotwords; ``decode`` defaults to
        the mode the pipeline was asked for (decode/streaming.py resolves
        ``beam_auto`` for a stream)."""
        from conformer_tpu_torch.decode.streaming import StreamingTranscriber

        return StreamingTranscriber(
            self.cfg, self.tok, self.model, self.frontend, chunk_s=chunk_s,
            left_context_s=left_context_s,
            decode=decode or self.stream_decode, decode_cfg=self.cfg.decode,
            pipeline_chunks=pipeline_chunks)

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
        manifest of (path, text) rows: the mean eval-step loss (CTC or
        RNN-T) over the batches, and corpus WER/CER x100 against the cleaned, upper-cased
        transcripts. Rows without a transcript count in no metric."""
        data_cfg = self.cfg.data
        ds = ManifestDataset(manifest, self.cfg.audio.sample_rate,
                             num_examples=data_cfg.num_examples)
        loader = BucketedLoader(ds, self.tok, data_cfg, training=False,
                                batch_size=batch_size or data_cfg.batch_size)
        refs, hyps, losses = [], [], []
        for batch in loader.epoch(0):
            out, texts = self.run_batch(batch.audio, batch.audio_lengths,
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
