"""Data pipeline: manifests -> length-bucketed, static-shape audio/text batches
(this package's copy of conformer_tpu/data/dataset.py).

CSV manifests are read with the stdlib ``csv`` module (rows of column ->
string; ``start``/``end`` become floats), not pandas, which would read
``""`` and ``"NA"`` as missing and ``"123"`` as a number; a ``.parquet``
manifest is read with pyarrow (imported only then; without it the read
raises ``ImportError``), its rows the typed values of its columns. Audio
is WAV or FLAC (audio/io.py). Batches, buckets, shuffling, the skip of long
audio, dummy-row padding for evaluation and the prefetch thread are the
JAX package's. Its notes on the design follow.

Capability parity with the reference data layer (reference: dataset.py:47-108):
CSV/parquet manifests with (path, text) rows, audio loading +
resampling, padded batches of (audio, tokens, lengths). Design points:

- **Length bucketing.** Batches are padded to one of a small, fixed set of
  bucket sizes (the JAX train step compiles once per bucket; here the shapes
  stay few and the kernels see the same lengths as the JAX package's).
- **No length sorting.** The LSTM loop needs none.
- **Featurization on the device.** The loader emits raw padded audio; the
  log-mel frontend and SpecAugment run in the train step.
- **Sharding.** ``shard_index``/``shard_count`` pick a disjoint manifest
  stripe, for data parallelism later.
"""

from __future__ import annotations

import csv
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np

from conformer_tpu_torch.audio.io import load_audio
from conformer_tpu_torch.config import DataConfig
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer
from conformer_tpu_torch.utils.spans import span

_FLOAT_COLUMNS = ("start", "end")


def load_manifest(manifest: str) -> List[dict]:
    """CSV or parquet manifest -> rows (dicts) with at least (path, text)."""
    if manifest.endswith(".parquet"):
        try:
            import pyarrow.parquet as pq
        except ImportError as e:
            raise ImportError(
                f"reading the parquet manifest {manifest} needs pyarrow, "
                "which is not installed; install it or use a CSV manifest"
            ) from e
        return pq.read_table(manifest).to_pylist()
    with open(manifest, newline="", encoding="utf8") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for col in _FLOAT_COLUMNS:
            if row.get(col) not in (None, ""):
                row[col] = float(row[col])
    return rows


@dataclass
class Batch:
    """One static-shape train/eval batch (host numpy, device-put by the step)."""

    audio: np.ndarray            # (B, S_bucket) float32, zero-padded
    audio_lengths: np.ndarray    # (B,) int32 valid sample counts
    tokens: np.ndarray           # (B, N) int32, pad_id-padded
    token_lengths: np.ndarray    # (B,) int32
    texts: Optional[List[str]] = None  # raw transcripts (eval convenience)


class ManifestDataset:
    """Row access over a manifest: returns (audio float32, text str).

    Mirrors ConformerDataset (reference: dataset.py:47-82) including
    ``num_examples`` truncation; adds optional (start, end) segment columns.
    """

    def __init__(self, manifest, sample_rate: int = 16000,
                 num_examples: Optional[int] = None):
        """manifest: a CSV or parquet path, or a list of row dicts."""
        rows = load_manifest(manifest) if isinstance(manifest, str) else manifest
        if num_examples is not None:
            rows = rows[:num_examples]
        self.rows = list(rows)
        self.sample_rate = sample_rate
        self._cols = set(self.rows[0]) if self.rows else set()

    def __len__(self) -> int:
        return len(self.rows)

    def row(self, index: int) -> dict:
        return dict(self.rows[index])

    def __getitem__(self, index: int) -> Tuple[np.ndarray, str]:
        r = self.row(index)
        audio = load_audio(r["path"], self.sample_rate)
        if "start" in self._cols and "end" in self._cols:
            audio = audio[int(r["start"] * self.sample_rate):
                          int(r["end"] * self.sample_rate)]
        return audio, r.get("text", "")


class BucketedLoader:
    """Shuffled, bucketed, prefetching batch iterator.

    Groups utterances by duration into `cfg.bucket_boundaries_s` buckets; each
    emitted batch is padded to its bucket's sample count. Utterances longer
    than the last boundary are clipped to `cfg.max_audio_s`.

    Two counters, cumulative over the loader's epochs: ``wait_s``, the
    seconds the consumer was blocked on the prefetch queue, and ``busy_s``,
    the loader threads' working seconds summed over the threads (each
    file's read, decode and resample, and each batch's assembly).
    """

    def __init__(self, dataset: ManifestDataset, tokenizer: GraphemeTokenizer,
                 cfg: DataConfig, shard_index: int = 0, shard_count: int = 1,
                 training: bool = True, batch_size: Optional[int] = None):
        self.ds = dataset
        self.tok = tokenizer
        self.cfg = cfg
        self.training = training
        self.batch_size = batch_size or cfg.batch_size
        # Evaluation must see every utterance: remainder batches are padded
        # with dummy rows (excluded from loss/metrics), never dropped — a
        # small validation set spread over many buckets would otherwise
        # yield zero batches and NaN metrics.
        self.drop_remainder = cfg.drop_remainder and training
        self.wait_s = self.busy_s = 0.0
        self._busy_lock = threading.Lock()
        self.indices = np.arange(shard_index, len(dataset), shard_count)
        sr = dataset.sample_rate
        self.boundaries = [int(b * sr) for b in cfg.bucket_boundaries_s]
        self.max_samples = int(cfg.max_audio_s * sr)
        if not self.boundaries or self.boundaries[-1] < self.max_samples:
            self.boundaries.append(self.max_samples)
        # Per-bucket batch sizes: long buckets peak at smaller batches than
        # short ones on a fixed HBM budget (measured: 8s peaks at b56, 24s
        # at b32 — docs/PERFORMANCE.md), so a single global batch size
        # either OOMs the long bucket or underfills the short one. When
        # cfg.bucket_batch_sizes is set it maps 1:1 onto bucket boundaries
        # (the last entry repeats for the implicit max_audio_s bucket);
        # an explicit `batch_size` argument (eval callers) overrides it.
        if cfg.bucket_batch_sizes and batch_size is None:
            sizes = list(cfg.bucket_batch_sizes)
            if len(sizes) not in (len(cfg.bucket_boundaries_s),
                                  len(self.boundaries)):
                raise ValueError(
                    f"bucket_batch_sizes has {len(sizes)} entries for "
                    f"{len(self.boundaries)} buckets")
            while len(sizes) < len(self.boundaries):
                sizes.append(sizes[-1])
            self.batch_sizes = sizes
        else:
            self.batch_sizes = [self.batch_size] * len(self.boundaries)

    def _bucket_for(self, n_samples: int) -> int:
        for i, b in enumerate(self.boundaries):
            if n_samples <= b:
                return i
        return len(self.boundaries) - 1

    def _add_busy(self, t0: float) -> None:
        """Add the time since ``t0`` to ``busy_s`` under one lock, so that
        the reader threads lose no count."""
        with self._busy_lock:
            self.busy_s += time.perf_counter() - t0

    def _make_batch(self, items: List[Tuple[np.ndarray, str]], bucket: int) -> Batch:
        t0 = time.perf_counter()
        size = self.boundaries[bucket]
        b = len(items)
        audio = np.zeros((b, size), dtype=np.float32)
        audio_lengths = np.zeros((b,), dtype=np.int32)
        texts = []
        for i, (sig, text) in enumerate(items):
            n = min(len(sig), size)
            audio[i, :n] = sig[:n]
            audio_lengths[i] = n
            texts.append(text)
        tokens, token_lengths = self.tok.encode_batch(texts, max_len=self.cfg.max_tokens)
        batch = Batch(audio, audio_lengths, tokens.astype(np.int32),
                      token_lengths.astype(np.int32), texts)
        self._add_busy(t0)
        return batch

    def _load_items(self, order: Iterable[int]) -> Iterator[Tuple[np.ndarray, str]]:
        """Load rows in manifest order; unreadable files are skipped (they
        must not kill the epoch). With cfg.num_workers > 1, file IO +
        resampling run on a thread pool a sliding window ahead of the
        consumer so host loading overlaps device compute."""
        workers = max(self.cfg.num_workers, 0)
        if workers <= 1:
            for idx in order:
                t0 = time.perf_counter()
                try:
                    item = self.ds[int(idx)]
                except Exception:
                    continue
                finally:
                    self._add_busy(t0)
                yield item
            return
        skip = object()

        def load(idx):
            t0 = time.perf_counter()
            try:
                return self.ds[int(idx)]
            except Exception:
                return skip
            finally:
                self._add_busy(t0)

        from collections import deque

        with ThreadPoolExecutor(max_workers=workers) as ex:
            window: deque = deque()
            it = iter(order)
            for idx in it:
                window.append(ex.submit(load, idx))
                if len(window) >= workers * 4:
                    break
            for idx in it:
                item = window.popleft().result()
                window.append(ex.submit(load, idx))
                if item is not skip:
                    yield item
            while window:
                item = window.popleft().result()
                if item is not skip:
                    yield item

    def _iter_epoch(self, epoch: int) -> Iterator[Batch]:
        order = self.indices.copy()
        if self.training:
            rng = np.random.default_rng(self.cfg.seed + epoch)
            rng.shuffle(order)
        skip_long = self.training and self.cfg.long_audio == "skip"
        pending: dict[int, list] = {}
        for item in self._load_items(order):
            if skip_long and len(item[0]) > self.max_samples:
                # Clipping audio while keeping the full transcript would
                # manufacture impossible CTC alignments (loss -> inf ->
                # zeroed); drop the utterance from training instead.
                continue
            bucket = self._bucket_for(len(item[0]))
            pending.setdefault(bucket, []).append(item)
            if len(pending[bucket]) == self.batch_sizes[bucket]:
                yield self._make_batch(pending.pop(bucket), bucket)
        if not self.drop_remainder:
            for bucket, items in pending.items():
                if items:
                    # Pad the batch dimension too — shapes must stay static.
                    # Dummy rows have empty transcripts (token_length 0) and
                    # are excluded from CTC loss and eval metrics.
                    while len(items) < self.batch_sizes[bucket]:
                        items.append((np.zeros(1, np.float32), ""))
                    yield self._make_batch(items, bucket)

    def epoch(self, epoch: int = 0, prefetch: int = 4) -> Iterator[Batch]:
        """Iterate one epoch with background prefetching.

        Producer-thread exceptions are relayed to the consumer (a failing
        loader must raise, not silently truncate the epoch)."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = object()

        def producer():
            try:
                for batch in self._iter_epoch(epoch):
                    q.put(batch)
                q.put(stop)
            except BaseException as e:  # noqa: BLE001 — relayed, not swallowed
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            t0 = time.perf_counter()
            with span("loader.wait"):
                item = q.get()
            self.wait_s += time.perf_counter() - t0
            if item is stop:
                break
            if isinstance(item, BaseException):
                raise item
            yield item


def synthetic_batch(batch_size: int, num_samples: int, vocab_size: int,
                    max_tokens: int = 64, seed: int = 0) -> Batch:
    """Random batch for tests/benchmarks (no disk IO)."""
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((batch_size, num_samples)).astype(np.float32) * 0.1
    audio_lengths = rng.integers(num_samples // 2, num_samples + 1,
                                 size=batch_size).astype(np.int32)
    token_lengths = rng.integers(max_tokens // 2, max_tokens + 1,
                                 size=batch_size).astype(np.int32)
    tokens = rng.integers(1, vocab_size, size=(batch_size, max_tokens)).astype(np.int32)
    tokens[np.arange(max_tokens)[None, :] >= token_lengths[:, None]] = 0
    return Batch(audio, audio_lengths, tokens, token_lengths)
