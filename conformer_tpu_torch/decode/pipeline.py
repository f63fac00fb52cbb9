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

Under a (dp, tp) mesh (``mesh=``, parallel/mesh.py; the counterpart of the
JAX pipeline under ``jax.set_mesh``) the model is split over the model
group as in training, each data rank runs the eval step on its stripe of a
batch, ``beam_device`` runs ``ctc_beam_search_device_sharded`` and a
transducer's beam ``rnnt_beam_search_sharded`` (the n-gram table's
buckets split over the model group), and ``evaluate`` sums the edit counts
over the data group, so every rank reports the same metrics and pairs.

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
from conformer_tpu_torch.text.metrics import edit_counts
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


def resolve_beam_backend(device: torch.device, mesh=None,
                         streaming: bool = False) -> str:
    """The backend ``decode='beam_auto'`` means, as the JAX
    ``resolve_beam_backend`` picks it: under a mesh the device beam search
    ("beam_device": the logits are split over the ranks and stay there),
    for a stream too; otherwise a stream's is the host search ("beam": at
    batch 1 it wins), and a batch's the device search wherever an
    accelerator runs the model, the host search on the CPU."""
    if mesh is not None:
        return "beam_device"
    if streaming:
        return "beam"
    return "beam_device" if device.type == "cuda" else "beam"


def device_lm_kwargs(cfg: Config, tokenizer: GraphemeTokenizer,
                     device: torch.device, word_fallback: bool = False,
                     mesh=None) -> dict:
    """The device searches' fusion kwargs (the JAX ``_device_lm_kwargs``),
    the tables on ``device``: token-level from ``decode.device_lm_path``
    (a token ARPA, ``cli.create_lm --token-level``); otherwise, with
    ``word_fallback``, word-level from ``decode.lm_path`` (the host
    decoder's word ARPA) with ``decode.hotwords``; else none. Under a mesh
    with tp > 1 each rank keeps its part of the n-gram table's buckets when
    they split evenly (the sharded searches sum the probes over the model
    group), the whole table otherwise."""
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
    part = None
    if mesh is not None and mesh.tp > 1 and table.n_slots % mesh.tp == 0:
        part = (mesh.model_index, mesh.tp)
    kwargs = dict(common, lm_tables=table.device_arrays(device, part),
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
    runs its beam search for any of the three beam modes. ``mesh``: a
    (dp, tp) mesh over the launcher's ranks (module docstring); the model
    then lives on ``device``, this rank's card or the CPU.

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
                 checkpoint_dir: Optional[str] = None, mesh=None):
        if weights and checkpoint_dir:
            raise ValueError("give weights or checkpoint_dir, not both")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.lead = mesh is None or mesh.rank == 0
        self.stream_decode = decode     # a stream resolves beam_auto itself
        if decode == "beam_auto":
            decode = resolve_beam_backend(self.device, mesh)
            self.print(f"[infer] beam_auto -> {decode}")
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
            self.print(f"[infer] loaded weights from {weights}")
        elif ckpt is not None and ckpt.latest_step() is not None:
            step, _ = ckpt.restore(model)
            self.print(f"[infer] restored step {step} from {checkpoint_dir}")
        else:
            where = f"no checkpoint in {checkpoint_dir}" if checkpoint_dir \
                else "no weights given"
            self.print(f"[infer] WARNING: {where}; seeded random weights "
                       f"(seed {seed})")
            model = build_model(cfg.model, cfg.optim.compute_dtype, seed)
        if mesh is not None:
            from conformer_tpu_torch.parallel.mesh import shard_model

            shard_model(model, mesh, cfg.model)
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
                                           word_fallback=True, mesh=mesh)
                if beam else None, mesh=mesh)
            return
        self.eval_step = make_eval_step(cfg, self.model, self.frontend,
                                        unk_id=tokenizer.unk_id, mesh=mesh)
        if decode == "beam":
            from conformer_tpu_torch.decode.beam_search import BeamSearchDecoder

            self._beam = BeamSearchDecoder(tokenizer, cfg.decode)
        if decode == "beam_device":
            from conformer_tpu_torch.ops.beam_search_device import \
                ctc_beam_search_device_sharded

            # the eval step's outputs are this rank's stripe already
            self._device_beam = functools.partial(
                ctc_beam_search_device_sharded, mesh=mesh, striped=True,
                beam_width=cfg.decode.beam_width,
                top_k=cfg.decode.device_top_k, blank_id=tokenizer.pad_id,
                unk_id=tokenizer.unk_id, max_len=cfg.data.max_tokens,
                scan_unroll=cfg.decode.device_scan_unroll,
                **device_lm_kwargs(cfg, tokenizer, self.device,
                                   word_fallback=True, mesh=mesh))

    def print(self, *args) -> None:
        """Print on one rank: the only one, or rank 0 of a mesh."""
        if self.lead:
            print(*args, flush=True)

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
        logs the batch in ``batch_log``. Under a mesh the outputs and texts
        are those of this rank's stripe of the batch (the loss the global
        one)."""
        t0 = time.perf_counter()
        to = lambda a, dt: torch.from_numpy(
            np.ascontiguousarray(a, dt)).to(self.device)
        arrays = [a for a in (audio, audio_lengths, tokens, token_lengths)
                  if a is not None]
        if self.mesh is not None:
            from conformer_tpu_torch.parallel.mesh import batch_stripe

            arrays = batch_stripe(arrays, self.mesh)
        args = [to(arrays[0], np.float32)] + [to(a, np.int64)
                                              for a in arrays[1:]]
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
        """audio (B, S) float32 zero-padded; audio_lengths (B,) samples.
        Under a mesh every rank gets the whole batch's texts."""
        texts = self.run_batch(audio, audio_lengths)[1]
        return self._gather_rows(texts)

    def _gather_rows(self, rows: list) -> list:
        """Per-row host values of this rank's stripe -> those of the whole
        batch, in row order (the data group's, a collective); unchanged
        without a mesh."""
        if self.mesh is None or self.mesh.dp == 1:
            return rows
        import torch.distributed as dist

        parts = [None] * self.mesh.dp
        dist.all_gather_object(parts, rows, group=self.mesh.data_group)
        return [r for part in parts for r in part]

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
        RNN-T) over the batches, and corpus WER/CER x100 against the
        cleaned, upper-cased transcripts. Rows without a transcript count in
        no metric. Under a mesh each rank scores its stripes' rows, the
        edit counts are summed over the data group and the pairs gathered
        in row order, so every rank returns what one process would."""
        data_cfg = self.cfg.data
        ds = ManifestDataset(manifest, self.cfg.audio.sample_rate,
                             num_examples=data_cfg.num_examples)
        loader = BucketedLoader(ds, self.tok, data_cfg, training=False,
                                batch_size=batch_size or data_cfg.batch_size)
        batches, losses = [], []      # this rank's (ref, hyp) per batch
        for batch in loader.epoch(0):
            out, texts = self.run_batch(batch.audio, batch.audio_lengths,
                                         batch.tokens, batch.token_lengths)
            losses.append(float(out["loss"]))
            row0 = 0
            if self.mesh is not None:
                row0 = self.mesh.batch_offset(len(texts))
            refs = (batch.texts or [])[row0:row0 + len(texts)]
            batches.append([(self.tok.clean_text(ref.upper()), texts[i])
                            for i, ref in enumerate(refs) if ref])
        pairs = [p for rows in batches for p in rows]
        counts = np.array(edit_counts([h for _, h in pairs],
                                      [r for r, _ in pairs]), np.int64)
        if self.mesh is not None and self.mesh.dp > 1:
            counts = self.mesh.data_count(
                torch.from_numpy(counts).to(self.device)).cpu().numpy()
            # every data rank's rows of each batch, in row order
            every = self._gather_rows([batches])
            pairs = [p for i in range(len(batches)) for rank in every
                     for p in rank[i]]
        w_err, words, c_err, chars = (int(c) for c in counts)
        metrics = {
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "wer": w_err / max(words, 1) * 100 if pairs else float("nan"),
            "cer": c_err / max(chars, 1) * 100 if pairs else float("nan"),
        }
        return metrics, pairs
