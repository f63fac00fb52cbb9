"""n-gram language models: the ARPA builder and backoff scorers
(counterpart of conformer_tpu/lm/ngram.py).

``build_arpa`` trains an interpolated modified-Kneser-Ney ARPA with the
native builder (``conformer_tpu_torch/native/ngram_lm.cpp``, a copy of the
JAX package's), in place of KenLM's ``lmplz``. ``NgramLM`` scores through
the native scorer, or, with ``native=False``, through ``PyNgramLM``, the
plain Python ARPA scorer that the tests hold the native one against. Scores
are log10, as KenLM's. The native library is built at first use
(``conformer_tpu_torch.native.load``); a failed build raises.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from conformer_tpu_torch import native

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """-> the native library with the LM's argument types set."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = native.load()
        lib.lm_load.restype = ctypes.c_void_p
        lib.lm_load.argtypes = [ctypes.c_char_p]
        lib.lm_free.argtypes = [ctypes.c_void_p]
        lib.lm_order.restype = ctypes.c_int
        lib.lm_order.argtypes = [ctypes.c_void_p]
        lib.lm_vocab_id.restype = ctypes.c_int
        lib.lm_vocab_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        for name in ("lm_bos", "lm_eos", "lm_unk"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        lib.lm_score.restype = ctypes.c_float
        lib.lm_score.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_int32),
                                 ctypes.c_int, ctypes.c_int32]
        lib.lm_build_arpa.restype = ctypes.c_int
        lib.lm_build_arpa.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int]
        _LIB = lib
        return lib


def build_arpa(text_path: str, arpa_path: str, order: int = 5) -> None:
    """Train an interpolated modified-KN ARPA of ``order`` from a corpus of
    one sentence per line."""
    rc = _library().lm_build_arpa(text_path.encode(), arpa_path.encode(),
                                  order)
    if rc != 0:
        raise RuntimeError(f"ARPA build failed (rc={rc})")


class NgramLM:
    """Backoff n-gram scorer over an ARPA file: native, or the plain Python
    scorer with ``native=False``. Scores are log10."""

    def __init__(self, arpa_path: str, native: bool = True):
        self._native = None
        self._py: Optional[PyNgramLM] = None
        if not native:
            self._py = PyNgramLM(arpa_path)
            return
        lib = _library()
        handle = lib.lm_load(arpa_path.encode())
        if not handle:
            raise ValueError(f"cannot load the ARPA file {arpa_path!r}")
        self._native = (lib, ctypes.c_void_p(handle))

    @property
    def order(self) -> int:
        if self._native:
            lib, h = self._native
            return lib.lm_order(h)
        return self._py.order

    def vocab_id(self, word: str) -> int:
        if self._native:
            lib, h = self._native
            return lib.lm_vocab_id(h, word.encode())
        return self._py.vocab.get(word, -1)

    @property
    def bos_id(self) -> int:
        if self._native:
            lib, h = self._native
            return lib.lm_bos(h)
        return self._py.vocab.get("<s>", -1)

    @property
    def eos_id(self) -> int:
        if self._native:
            lib, h = self._native
            return lib.lm_eos(h)
        return self._py.vocab.get("</s>", -1)

    def score_id(self, context: Sequence[int], word_id: int) -> float:
        """log10 P(word | context) with backoff; ids from this LM's vocab."""
        if self._native:
            lib, h = self._native
            ctx = np.asarray(context, dtype=np.int32)
            ptr = ctx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
            return float(lib.lm_score(h, ptr, len(ctx), word_id))
        return self._py.score_id(list(context), word_id)

    def score_word(self, context_words: Sequence[str], word: str) -> float:
        ctx = [self.vocab_id(w) for w in context_words]
        return self.score_id(ctx, self.vocab_id(word))

    def sentence_logprob(self, words: Sequence[str],
                         include_eos: bool = True) -> float:
        """Sum of the conditional log10 probabilities after <s> (KenLM's
        ``score``)."""
        ctx = [self.bos_id]
        total = 0.0
        for w in words:
            wid = self.vocab_id(w)
            total += self.score_id(ctx, wid)
            ctx.append(wid)
        if include_eos:
            total += self.score_id(ctx, self.eos_id)
        return total

    def __del__(self):
        if getattr(self, "_native", None):
            lib, h = self._native
            lib.lm_free(h)


class PyNgramLM:
    """The plain Python ARPA backoff scorer."""

    def __init__(self, arpa_path: str):
        self.vocab: Dict[str, int] = {}
        self.tables: List[Dict[Tuple[int, ...], Tuple[float, float]]] = []
        self._parse(arpa_path)
        self.order = len(self.tables)

    def _wid(self, w: str) -> int:
        if w not in self.vocab:
            self.vocab[w] = len(self.vocab)
        return self.vocab[w]

    def _parse(self, path: str) -> None:
        with open(path, encoding="utf8") as f:
            current = 0
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                if line.startswith("\\"):
                    if line == "\\end\\":
                        break
                    if "-grams:" in line:
                        current = int(line[1:line.index("-grams:")])
                        while len(self.tables) < current:
                            self.tables.append({})
                    continue
                if current == 0:
                    continue
                parts = line.split()
                logp = float(parts[0])
                words = parts[1: 1 + current]
                backoff = (float(parts[1 + current])
                           if len(parts) > 1 + current else 0.0)
                key = tuple(self._wid(w) for w in words)
                self.tables[current - 1][key] = (logp, backoff)

    def score_id(self, context: List[int], word: int) -> float:
        if word < 0:
            word = self.vocab.get("<unk>", -1)
        max_ctx = self.order - 1
        context = context[-max_ctx:] if max_ctx else []
        backoff_sum = 0.0
        for use in range(len(context), -1, -1):
            ids = tuple(context[len(context) - use:]) + (word,)
            entry = self.tables[use].get(ids)
            if entry is not None:
                return backoff_sum + entry[0]
            if use >= 1:
                ctx_entry = self.tables[use - 1].get(ids[:-1])
                if ctx_entry is not None:
                    backoff_sum += ctx_entry[1]
        unk = self.vocab.get("<unk>")
        if unk is not None and (unk,) in self.tables[0]:
            return backoff_sum + self.tables[0][(unk,)][0]
        return backoff_sum - 99.0
