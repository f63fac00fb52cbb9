"""Build and load the port's host C++ libraries (this directory's ``*.cpp``).

Two libraries, each of copies of the JAX package's ``native/`` sources:

* ``decode``: ``ngram_lm.cpp`` (the ARPA builder and scorer) and
  ``beam_search.cpp`` (the CTC prefix beam search over that scorer);
* ``audio``: ``audio_io.cpp`` (WAV decoding and the polyphase resampler)
  and ``flac.cpp`` (the FLAC decoder).

Each is compiled by ``g++`` at first use into ``build/`` at the root of the
checkout (git-ignored), under a name that carries the hash of its sources
and flags (``lib<name>-<hash>.so``), as ``ops/cuda/build.py`` names the CUDA
libraries; nothing is built at import time, and nothing is written into
``native/``, where the JAX package keeps its own libraries. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
LIBRARIES = {"decode": ("ngram_lm.cpp", "beam_search.cpp"),
             "audio": ("audio_io.cpp", "flac.cpp")}
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LINK_FLAGS = ["-lpthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def lib_path(name: str = "decode") -> Path:
    """-> build/lib<name>-<hash of the sources and flags>.so."""
    h = hashlib.sha256()
    for src in LIBRARIES[name]:
        h.update(src.encode())
        h.update((SRC / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load(name: str = "decode") -> ctypes.CDLL:
    """-> the loaded library ``name`` (a key of LIBRARIES), compiled first
    when build/ has none of its current sources."""
    with _lock:
        if name in _libs:
            return _libs[name]
        out = lib_path(name)
        if not out.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: cannot build "
                                   f"conformer_tpu_torch/native ({name})")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, *(str(SRC / s) for s in LIBRARIES[name]),
                   "-o", str(tmp), *LINK_FLAGS]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError("g++ failed for conformer_tpu_torch/"
                                   f"native ({name}):\n{done.stderr}")
            os.replace(tmp, out)
        _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]
