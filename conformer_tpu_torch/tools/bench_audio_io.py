"""Host audio-ingestion throughput (counterpart of tools/bench_audio_io.py):
the port's native C++ decoders against scipy and the pure-Python FLAC
decoder.

Decodes synthesised LibriSpeech-shaped utterances (16 kHz mono 16-bit, a
tone over noise) and prints audio seconds decoded per wall second on one
core: WAV through the native decoder (``audio/native.py``), scipy and
``audio/io.py::read_wav`` (scipy first), FLAC through the native decoder
and ``audio/flac.py``, and the native FLAC decoder's speed-up over the
Python one. It runs on the CPU only: the card plays no part in it. A
failed build of the native library raises (the port has no fallback).

    python -m conformer_tpu_torch.tools.bench_audio_io [--files 8]
        [--seconds 10] [--repeats 5]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

SR = 16000


def utterances(root: str, n_files: int,
               seconds: float) -> Tuple[List[str], List[str]]:
    """Write ``n_files`` seeded utterances as WAV and FLAC twins under
    ``root`` -> (WAV paths, FLAC paths)."""
    from scipy.io import wavfile

    from conformer_tpu_torch.audio import flac

    rng = np.random.default_rng(0)
    n = int(SR * seconds)
    wavs, flacs = [], []
    for i in range(n_files):
        t = np.arange(n) / SR
        sig = (0.4 * np.sin(2 * np.pi * (200 + 40 * i) * t)
               + 0.05 * rng.standard_normal(n))
        ints = np.clip(np.round(sig * 32768), -32768, 32767)
        w = os.path.join(root, f"u{i}.wav")
        f = os.path.join(root, f"u{i}.flac")
        wavfile.write(w, SR, ints.astype(np.int16))
        flac.write_flac(f, ints.astype(np.int64), SR)
        wavs.append(w)
        flacs.append(f)
    return wavs, flacs


def rate(fn: Callable[[str], object], paths: List[str], seconds: float,
         repeats: int) -> float:
    """Audio seconds decoded a wall second, after one warm call (which
    builds the native library on first use)."""
    fn(paths[0])
    t0 = time.perf_counter()
    for _ in range(repeats):
        for p in paths:
            fn(p)
    return len(paths) * repeats * seconds / (time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    from scipy.io import wavfile

    from conformer_tpu_torch.audio import flac, native
    from conformer_tpu_torch.audio.io import read_wav

    cases = (("wav_native", "WAV native C++", native.read_wav, "wav"),
             ("flac_native", "FLAC native C++", native.read_flac, "flac"),
             ("wav_scipy", "WAV scipy", wavfile.read, "wav"),
             ("flac_python", "FLAC pure-Python", flac.read_flac, "flac"),
             ("wav_dispatch", "WAV via read_wav (dispatch)", read_wav, "wav"))
    out = {}
    with tempfile.TemporaryDirectory(prefix="bench_audio_io_") as tmp:
        wavs, flacs = utterances(tmp, args.files, args.seconds)
        for key, label, fn, kind in cases:
            out[key] = rate(fn, wavs if kind == "wav" else flacs,
                            args.seconds, args.repeats)
            print(f"{label:28s} {out[key]:10.0f} audio-s/s per core",
                  flush=True)
    out["flac_native_speedup"] = out["flac_native"] / out["flac_python"]
    print(f"\nnative FLAC speedup over pure-Python: "
          f"{out['flac_native_speedup']:.0f}x", flush=True)
    return out


if __name__ == "__main__":
    main()
