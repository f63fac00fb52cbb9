"""CTC prefix beam search with n-gram LM shallow fusion and hotword boosting
(counterpart of conformer_tpu/decode/beam_search.py).

The reference's decode: beam width 190, LM weight alpha 2.1, word bonus
beta 9.2, beam prune -20, hotword weight 9.0 (``DecodeConfig``). Scores
follow pyctcdecode's convention: CTC log-probabilities in natural log; a
completed word adds alpha times its n-gram score (log10, converted to ln)
plus beta, and a hotword hotword_weight * ln(10) more. The search runs on
true log-softmax outputs, ends words at the tokenizer's delimiter token and
skips ``<UNK>`` frames, as the JAX decoder does.

``BeamSearchDecoder`` runs the native C++ loop
(``conformer_tpu_torch/native/beam_search.cpp``, a copy of the JAX
package's; a batch is decoded on a host thread pool) or, with
``native=False``, the Python implementation below, the plain version that
the tests hold the native one against. A failed native build raises. The
device computes the log-softmax; the search runs on the host.
"""

from __future__ import annotations

import ctypes
import math
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from conformer_tpu_torch import native
from conformer_tpu_torch.config import DecodeConfig
from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer

LOG10_TO_LN = math.log(10.0)
NEG_INF = -float("inf")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """-> the native library with the beam search's argument types set."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = native.load()
        c_charpp = ctypes.POINTER(ctypes.c_char_p)
        lib.bs_create.restype = ctypes.c_void_p
        lib.bs_create.argtypes = [
            ctypes.c_char_p, c_charpp, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_int, ctypes.c_double, ctypes.c_double, c_charpp,
            ctypes.c_int, ctypes.c_double]
        lib.bs_free.argtypes = [ctypes.c_void_p]
        lib.bs_decode_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.bs_stream_new.restype = ctypes.c_void_p
        lib.bs_stream_new.argtypes = [ctypes.c_void_p]
        lib.bs_stream_feed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int]
        lib.bs_stream_text.restype = ctypes.c_int
        lib.bs_stream_text.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.bs_stream_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return lib


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


@dataclass
class _Beam:
    # CTC bookkeeping
    last_token: int = -1
    p_b: float = 0.0          # log prob ending in blank
    p_nb: float = NEG_INF     # log prob ending in non-blank
    # text state
    text: str = ""            # completed words joined by spaces
    partial: str = ""         # current partial word
    # LM state
    lm_ctx: Tuple[int, ...] = ()
    lm_score: float = 0.0     # accumulated fused LM contribution (natural log)
    n_words: int = 0

    def total(self) -> float:
        return _logsumexp2(self.p_b, self.p_nb) + self.lm_score

    def key(self) -> Tuple:
        return (self.text, self.partial, self.last_token)


class BeamSearchDecoder:
    """CTC prefix beam search over (T, V) natural-log softmax frames.

    ``native=True`` (the default) runs the C++ loop, which loads
    ``cfg.lm_path`` itself; ``native=False`` runs the Python implementation,
    the plain version, scoring ``cfg.lm_path`` with the Python n-gram scorer
    (``NgramLM(..., native=False)``), so that no native code is on its path."""

    def __init__(self, tokenizer: GraphemeTokenizer, cfg: DecodeConfig,
                 native: bool = True):
        self.tok = tokenizer
        self.cfg = cfg
        self.lm = None
        self.hotwords = {h.upper() for h in cfg.hotwords}
        self._native = None
        if not native:
            if cfg.lm_path:
                from conformer_tpu_torch.lm.ngram import NgramLM

                self.lm = NgramLM(cfg.lm_path, native=False)
            return
        lib = _library()
        vocab = (ctypes.c_char_p * len(tokenizer.vocab))(
            *[t.encode("utf8") for t in tokenizer.vocab])
        hot = [h.encode("utf8") for h in sorted(self.hotwords)]
        hot_arr = (ctypes.c_char_p * max(len(hot), 1))(*(hot or [b""]))
        handle = lib.bs_create(
            (cfg.lm_path or "").encode(), vocab, len(tokenizer.vocab),
            tokenizer.pad_id, tokenizer.unk_id, tokenizer.delim_id,
            float(cfg.alpha), float(cfg.beta), int(cfg.beam_width),
            float(cfg.beam_prune_logp), float(cfg.token_min_logp),
            hot_arr, len(hot), float(cfg.hotword_weight))
        if not handle:
            raise ValueError(f"cannot load the ARPA file {cfg.lm_path!r}")
        self._native = (lib, ctypes.c_void_p(handle))

    def __del__(self):
        if getattr(self, "_native", None):
            lib, h = self._native
            lib.bs_free(h)

    # ------------------------------------------------------------------
    def _decode_native(self, log_probs: np.ndarray,
                       lengths: Optional[np.ndarray], n_threads: int
                       ) -> List[str]:
        lib, h = self._native
        lp = np.ascontiguousarray(log_probs, dtype=np.float32)
        b, t, v = lp.shape
        cap = max(8 * t + 64, 256)
        out = ctypes.create_string_buffer(b * cap)
        ln_ptr = None
        if lengths is not None:
            ln = np.ascontiguousarray(lengths, dtype=np.int32)
            ln_ptr = ln.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        lib.bs_decode_batch(
            h, lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), ln_ptr,
            b, t, v, out, cap, n_threads)
        texts = []
        for i in range(b):
            raw = out.raw[i * cap:(i + 1) * cap].split(b"\0", 1)[0]
            texts.append(self.tok.spec_decode(raw.decode("utf8")))
        return texts

    # ------------------------------------------------------------------
    def _word_bonus(self, beam: _Beam, word: str
                    ) -> Tuple[float, Tuple[int, ...]]:
        """LM and hotword contribution of completing ``word`` in ``beam``'s
        context -> (natural-log score delta, new LM context ids)."""
        delta = 0.0
        new_ctx = beam.lm_ctx
        if self.lm is not None:
            wid = self.lm.vocab_id(word)
            delta += self.cfg.alpha * LOG10_TO_LN * self.lm.score_id(
                list(beam.lm_ctx), wid)
            delta += self.cfg.beta
            max_ctx = max(self.lm.order - 1, 1)
            new_ctx = (beam.lm_ctx + (wid,))[-max_ctx:]
        if self.hotwords:
            tail = (beam.text + " " + word).strip().split()
            # boost if a suffix of the text of up to 4 words is a hotword
            for span in range(1, min(len(tail), 4) + 1):
                phrase = " ".join(tail[-span:])
                if phrase in self.hotwords:
                    delta += (self.cfg.hotword_weight or 0.0) * LOG10_TO_LN
                    break
        return delta, new_ctx

    # ------------------------------------------------------------------
    def decode(self, log_probs: np.ndarray,
               length: Optional[int] = None) -> str:
        """log_probs: (T, V) natural-log softmax outputs -> text."""
        if self._native is not None:
            n = int(length) if length is not None else log_probs.shape[0]
            return self._decode_native(log_probs[None],
                                       np.asarray([n], np.int32), 1)[0]
        return self.decode_py(log_probs, length)

    def decode_py(self, log_probs: np.ndarray,
                  length: Optional[int] = None) -> str:
        """The Python search (the plain version)."""
        beams = self.start_state()
        beams = self.step_py(beams, log_probs, length)
        return self.finalize_py(beams)

    def start_state(self) -> List[_Beam]:
        """A fresh beam state: one empty hypothesis after the LM's <s>."""
        return [_Beam(lm_ctx=(self.lm.bos_id,) if self.lm else ())]

    def step_py(self, beams: List[_Beam], log_probs: np.ndarray,
                length: Optional[int] = None) -> List[_Beam]:
        """Advance ``beams`` through the frames of ``log_probs`` (T, V).

        The search takes frames in order, so stepping chunk by chunk through
        a kept state is exactly the offline decode of the concatenation."""
        cfg = self.cfg
        tok = self.tok
        t_max = int(length) if length is not None else log_probs.shape[0]
        blank = tok.pad_id
        unk = tok.unk_id
        delim = tok.delim_id

        for t in range(t_max):
            frame = log_probs[t]
            # candidate tokens above the per-frame floor
            cand = np.nonzero(frame >= cfg.token_min_logp)[0]
            if len(cand) == 0:
                cand = np.array([int(np.argmax(frame))])
            next_beams: Dict[Tuple, _Beam] = {}

            def merge(nb: _Beam) -> None:
                k = nb.key()
                old = next_beams.get(k)
                if old is None:
                    next_beams[k] = nb
                else:
                    old.p_b = _logsumexp2(old.p_b, nb.p_b)
                    old.p_nb = _logsumexp2(old.p_nb, nb.p_nb)

            for beam in beams:
                p_total = _logsumexp2(beam.p_b, beam.p_nb)
                for c in cand:
                    c = int(c)
                    lp = float(frame[c])
                    if c == blank:
                        merge(_Beam(last_token=beam.last_token,
                                    p_b=p_total + lp, p_nb=NEG_INF,
                                    text=beam.text, partial=beam.partial,
                                    lm_ctx=beam.lm_ctx,
                                    lm_score=beam.lm_score,
                                    n_words=beam.n_words))
                        continue
                    if c == unk:
                        continue
                    if c == beam.last_token:
                        # same prefix: the repeat collapses
                        merge(_Beam(last_token=c, p_b=NEG_INF,
                                    p_nb=beam.p_nb + lp,
                                    text=beam.text, partial=beam.partial,
                                    lm_ctx=beam.lm_ctx,
                                    lm_score=beam.lm_score,
                                    n_words=beam.n_words))
                        # after a blank: a new occurrence of c
                        base = beam.p_b
                    else:
                        base = p_total
                    if base == NEG_INF:
                        continue
                    if c == delim:
                        # word boundary: complete the partial word
                        if beam.partial:
                            delta, new_ctx = self._word_bonus(beam,
                                                              beam.partial)
                            merge(_Beam(
                                last_token=c, p_b=NEG_INF, p_nb=base + lp,
                                text=(beam.text + " " + beam.partial).strip(),
                                partial="", lm_ctx=new_ctx,
                                lm_score=beam.lm_score + delta,
                                n_words=beam.n_words + 1))
                        else:
                            merge(_Beam(last_token=c, p_b=NEG_INF,
                                        p_nb=base + lp, text=beam.text,
                                        partial="", lm_ctx=beam.lm_ctx,
                                        lm_score=beam.lm_score,
                                        n_words=beam.n_words))
                    else:
                        merge(_Beam(last_token=c, p_b=NEG_INF,
                                    p_nb=base + lp, text=beam.text,
                                    partial=beam.partial + tok.vocab[c],
                                    lm_ctx=beam.lm_ctx,
                                    lm_score=beam.lm_score,
                                    n_words=beam.n_words))

            scored = sorted(next_beams.values(), key=_Beam.total, reverse=True)
            best = scored[0].total() if scored else 0.0
            floor = best + cfg.beam_prune_logp  # prune_logp is negative
            beams = [b for b in scored[: cfg.beam_width] if b.total() >= floor]
            if not beams:
                beams = scored[:1]
        return beams

    def finalize_py(self, beams: List[_Beam]) -> str:
        """The best hypothesis with its trailing partial word scored; reads
        the state only, so a stream can poll it and keep feeding."""
        final: List[Tuple[float, str]] = []
        for beam in beams:
            score = _logsumexp2(beam.p_b, beam.p_nb) + beam.lm_score
            text = beam.text
            if beam.partial:
                delta, _ = self._word_bonus(beam, beam.partial)
                score += delta
                text = (text + " " + beam.partial).strip()
            final.append((score, text))
        final.sort(key=lambda x: x[0], reverse=True)
        best_text = final[0][1] if final else ""
        return self.tok.spec_decode(best_text)

    def decode_batch(self, log_probs: np.ndarray,
                     lengths: Optional[np.ndarray] = None,
                     n_threads: Optional[int] = None) -> List[str]:
        """(B, T, V) with true lengths (B,) -> B texts. The native decoder
        takes the rows on a host thread pool (the scorer is read-only)."""
        if self._native is not None:
            return self._decode_native(
                log_probs, lengths,
                n_threads or min(os.cpu_count() or 1, log_probs.shape[0]))
        out = []
        for i in range(log_probs.shape[0]):
            n = int(lengths[i]) if lengths is not None else None
            out.append(self.decode_py(log_probs[i], n))
        return out

    def stream(self) -> "BeamStream":
        """A kept beam state, fed frames chunk by chunk (BeamStream)."""
        return BeamStream(self)


class BeamStream:
    """Beam search with LM fusion across chunk boundaries.

    Feeding [A; B] in two ``feed`` calls gives the same hypothesis as one
    offline decode of the concatenation: the search takes frames in order,
    so carrying the beams loses nothing. ``text`` reads the current best
    hypothesis (trailing partial word scored) without changing the state."""

    def __init__(self, decoder: BeamSearchDecoder):
        self.dec = decoder  # keeps the native handle alive
        self._state = None
        if decoder._native is not None:
            lib, h = decoder._native
            self._state = ctypes.c_void_p(lib.bs_stream_new(h))
        else:
            self._beams = decoder.start_state()

    def feed(self, log_probs: np.ndarray, length: Optional[int] = None) -> None:
        """Advance through ``log_probs`` (T, V) natural-log softmax frames."""
        t = int(length) if length is not None else log_probs.shape[0]
        if t <= 0:
            return
        if self._state is not None:
            lib, h = self.dec._native
            lp = np.ascontiguousarray(log_probs[:t], dtype=np.float32)
            lib.bs_stream_feed(
                h, self._state,
                lp.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                t, lp.shape[1])
        else:
            self._beams = self.dec.step_py(self._beams, log_probs, t)

    def text(self) -> str:
        """The current best hypothesis, spec-decoded; more frames may
        revise it."""
        if self._state is None:
            return self.dec.finalize_py(self._beams)
        lib, h = self.dec._native
        cap = 1 << 16
        buf = ctypes.create_string_buffer(cap)
        lib.bs_stream_text(h, self._state, buf, cap)
        return self.dec.tok.spec_decode(buf.value.decode("utf8"))

    def close(self) -> None:
        if self._state is not None:
            lib, _ = self.dec._native
            lib.bs_stream_free(self._state)
            self._state = None

    def __del__(self):
        self.close()
