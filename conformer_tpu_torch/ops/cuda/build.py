"""Build and load the hand-written CUDA kernels (``conformer_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``. Libraries go to
``build/`` at the root of the checkout (git-ignored) under a name that carries
the hash of the source, so an edited source is rebuilt and an unchanged one
is loaded as it is. Nothing here runs at import time: the first launch of a
kernel builds it, and ``build_all`` builds every kernel at once, one ``nvcc``
process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNEL_SOURCES = ("sincos_attention", "sincos_attention_bwd", "mel_frontend",
                  "depthwise_conv", "vpu_pass")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time or 0.0 when cached, "ptxas": compiler log}
BUILD_LOG: Dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_source_hash(name)}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path, float]":
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, proc, tmp: Path, out: Path, t0: float) -> str:
    """-> "" on success, else the compiler's log."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        return f"nvcc failed for {name}.cu:\n{log}"
    os.replace(tmp, out)
    BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "ptxas": log}
    return ""


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, dict]:
    """Compile every listed kernel source that has no current library, all
    ``nvcc`` processes in parallel. Returns BUILD_LOG."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        pending: List[tuple] = []
        for name in names:
            if _lib_path(name).exists():
                BUILD_LOG.setdefault(name, {"seconds": 0.0, "ptxas": ""})
            else:
                pending.append((name, *_start(name)))
        errors = [_finish(*job) for job in pending]
    if any(errors):
        raise RuntimeError("\n".join(e for e in errors if e))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """-> the loaded library for csrc/<name>.cu, building it first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_lib_path(name)))
                _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point of the
    library built from csrc/<name>.cu."""
    if err != 0:
        describe = getattr(lib, f"{name}_error_string")
        describe.restype = ctypes.c_char_p
        describe.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({describe(err).decode()})")
