"""Build and load the port's host C++ library (this directory's ``*.cpp``).

``ngram_lm.cpp`` (the ARPA builder and scorer) and ``beam_search.cpp`` (the
CTC prefix beam search over that scorer) are copies of the JAX package's
``native/`` sources, linked into one library. It is compiled by ``g++`` at
first use into ``build/`` at the root of the checkout (git-ignored), under
a name that carries the hash of its sources and flags, as
``ops/cuda/build.py`` names the CUDA libraries; nothing is built at import
time, and nothing is written into ``native/``, where the JAX package keeps
its own libraries. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("ngram_lm.cpp", "beam_search.cpp")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LINK_FLAGS = ["-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def lib_path() -> Path:
    """-> build/libdecode-<hash of the sources and flags>.so."""
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.encode())
        h.update((SRC / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libdecode-{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """-> the loaded library, compiled first when build/ has none of the
    current sources."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            cxx = shutil.which("g++")
            if cxx is None:
                raise RuntimeError("g++ not found: cannot build "
                                   "conformer_tpu_torch/native")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cxx, *CXX_FLAGS, *(str(SRC / s) for s in SOURCES),
                   "-o", str(tmp), *LINK_FLAGS]
            done = subprocess.run(cmd, capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError("g++ failed for conformer_tpu_torch/"
                                   f"native:\n{done.stderr}")
            os.replace(tmp, out)
        _lib = ctypes.CDLL(str(out))
        return _lib
