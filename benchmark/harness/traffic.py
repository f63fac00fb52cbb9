"""The one generator of the benchmark's audio traffic, driven by the
parameters of a traffic file.

Lengths: each bucket ``(lo, hi]`` of ``buckets_s`` holds ``rows[i]``
utterances whose lengths lie on a stratified uniform grid over the bucket
(the same set in every run), in an order fixed by ``order_seed``: every
run sends the same work. Content comes from the run's seed: each file is
16 kHz 16-bit WAV of Gaussian noise and a few tones (the weights are
random, so the content only has to differ from row to row), and each
transcript is a seeded string of the tokenizer's graphemes,
``tokens_per_s`` tokens a second of audio (at most the configuration's
``max_tokens``), words of 1 to 3 graphemes parted by the word delimiter.

The benchmark keeps each transcript's token ids as it made them: the
reference takes those, and the program tokenizes the text itself.
"""

from __future__ import annotations

import csv
import os
import wave
from typing import Dict, List

import numpy as np


def lengths(traffic: dict, sample_rate: int) -> List[int]:
    """The pool's utterance lengths in samples, in manifest order."""
    out = []
    for (lo, hi), n in zip(traffic["buckets_s"], traffic["rows"]):
        grid = lo + (hi - lo) * (np.arange(n) + 0.5) / n
        out.extend(int(round(s * sample_rate)) for s in grid)
    order = np.random.default_rng(traffic["order_seed"]).permutation(len(out))
    return [out[i] for i in order]


def word_list(traffic: dict, tokenizer) -> Dict[int, List[List[str]]]:
    """Grapheme count -> words (lists of graphemes) whose text the
    tokenizer reads back as exactly those graphemes; fixed by the traffic
    file's ``words.seed``."""
    spec = traffic["words"]
    special = {tokenizer.pad_token, tokenizer.delim_token,
               tokenizer.unk_token}
    single = [g for g in tokenizer.vocab if g not in special
              and tokenizer.encode(g) == [tokenizer.token_id(g)]]
    rng = np.random.default_rng(spec["seed"])
    words: Dict[int, List[List[str]]] = {n: [] for n in range(1, 4)}
    for g in single:
        words[1].append([g])
    for _ in range(100 * spec["count"]):
        if min(len(words[2]), len(words[3])) >= spec["count"]:
            break
        n = int(rng.integers(2, 4))
        gs = [single[int(i)] for i in rng.integers(0, len(single), n)]
        if (len(words[n]) < spec["count"] and tokenizer.encode("".join(gs))
                == [tokenizer.token_id(g) for g in gs]):
            words[n].append(gs)
    return words


def transcript(rng: np.random.Generator, words, target: int, tokenizer):
    """-> (text, token ids) of exactly ``target`` tokens."""
    parts: List[str] = []
    ids: List[int] = []
    remaining = target
    while remaining > 0:
        if parts:
            remaining -= 1
            ids.append(tokenizer.token_id(tokenizer.delim_token))
        fits = [n for n in (1, 2, 3)
                if n == remaining or n <= remaining - 2]
        n = fits[int(rng.integers(0, len(fits)))]
        gs = words[n][int(rng.integers(0, len(words[n])))]
        parts.append("".join(gs))
        ids.extend(tokenizer.token_id(g) for g in gs)
        remaining -= n
    return " ".join(parts), ids


def write_wav(path: str, x: np.ndarray, sample_rate: int) -> None:
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def read_wav(path: str) -> np.ndarray:
    """16-bit mono WAV -> float32 samples in [-1, 1)."""
    with wave.open(path, "rb") as f:
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
    return pcm.astype(np.float32) / 32768.0


def make_pool(traffic: dict, seed: int, out_dir: str, tokenizer,
              max_tokens: int, sample_rate: int) -> List[dict]:
    """Write the pool's WAVs under ``out_dir`` -> manifest rows (path, text,
    ids, samples), in manifest order."""
    os.makedirs(out_dir, exist_ok=True)
    words = word_list(traffic, tokenizer)
    rng = np.random.default_rng(seed % 2 ** 63)
    a = traffic["audio"]
    rows, texts = [], set()
    for i, n in enumerate(lengths(traffic, sample_rate)):
        target = max(1, min(int(round(traffic["tokens_per_s"] * n
                                      / sample_rate)), max_tokens))
        text, ids = transcript(rng, words, target, tokenizer)
        while text in texts:
            text, ids = transcript(rng, words, target, tokenizer)
        texts.add(text)
        t = np.arange(n, dtype=np.float32) / sample_rate
        x = rng.standard_normal(n, dtype=np.float32) * np.float32(
            rng.uniform(*a["noise"]))
        for _ in range(a["tones"]):
            x += np.float32(rng.uniform(*a["tone_amp"])) * np.sin(
                np.float32(2 * np.pi * rng.uniform(*a["tone_hz"])) * t
                + np.float32(rng.uniform(0, 2 * np.pi)))
        path = os.path.join(out_dir, f"{i:05d}.wav")
        write_wav(path, x, sample_rate)
        rows.append({"path": path, "text": text, "ids": ids, "samples": n})
    return rows


def write_manifest(rows: List[dict], path: str, repeat: int = 1) -> None:
    """The manifest: the rows in order, the whole list ``repeat`` times
    (an epoch as long as a corpus's, from the same files)."""
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for _ in range(repeat):
            for r in rows:
                w.writerow([r["path"], r["text"]])
