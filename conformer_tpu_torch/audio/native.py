"""ctypes binding of the port's native audio library (counterpart of
conformer_tpu/audio/native.py).

``native/audio_io.cpp`` (WAV decoding, the polyphase resampler) and
``native/flac.cpp`` (the FLAC decoder), copies of the JAX package's sources,
are built at first use into ``build/libaudio-<hash>.so``
(``conformer_tpu_torch.native.load("audio")``). A failed build raises:
nothing here falls back to scipy.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from conformer_tpu_torch import native

KAISER_BETA = 5.0        # scipy resample_poly's default window ('kaiser', 5.0)
HALF_LEN_MULT = 10       # scipy's default half length, 10 * max(up, down)

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    """-> the audio library with its argument types set."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = native.load("audio")
        info = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long)]
        read = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_long]
        for fn, args in ((lib.audio_wav_info, info), (lib.audio_wav_read, read),
                         (lib.audio_flac_info, info),
                         (lib.audio_flac_read, read)):
            fn.restype = ctypes.c_int
            fn.argtypes = args
        lib.audio_resample_out_len.restype = ctypes.c_long
        lib.audio_resample_out_len.argtypes = [ctypes.c_long, ctypes.c_int,
                                               ctypes.c_int]
        lib.audio_resample.restype = ctypes.c_long
        lib.audio_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_double, ctypes.c_int]
        _LIB = lib
        return lib


def _read(kind: str, path: str) -> Tuple[np.ndarray, int]:
    """``kind`` "wav" or "flac" -> (float32 signal, (samples,) mono or
    (channels, samples), sample rate); ValueError on a file the decoder
    rejects."""
    lib = _library()
    info, read = getattr(lib, f"audio_{kind}_info"), \
        getattr(lib, f"audio_{kind}_read")
    sr, channels, frames = ctypes.c_int(), ctypes.c_int(), ctypes.c_long()
    if info(path.encode(), ctypes.byref(sr), ctypes.byref(channels),
            ctypes.byref(frames)) != 0:
        raise ValueError(f"unreadable {kind.upper()}: {path}")
    total = frames.value * channels.value
    buf = np.empty((total,), np.float32)
    if read(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            total) != 0:
        raise ValueError(f"unreadable {kind.upper()}: {path}")
    if channels.value > 1:
        return buf.reshape(frames.value, channels.value).T.copy(), sr.value
    return buf, sr.value


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 signal, (samples,) or (channels, samples), sample rate)."""
    return _read("wav", path)


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 signal, (samples,) or (channels, samples), sample rate),
    scaled by 2^-(bps-1) as the WAV path scales its integers."""
    return _read("flac", path)


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling, float32; (channels, samples) channel by
    channel."""
    if orig_sr == target_sr:
        return signal.astype(np.float32)
    lib = _library()
    g = int(np.gcd(orig_sr, target_sr))
    up, down = target_sr // g, orig_sr // g

    def one(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float32)
        cap = lib.audio_resample_out_len(len(x), up, down)
        out = np.empty((cap,), np.float32)
        n = lib.audio_resample(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), up, down,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
            KAISER_BETA, HALF_LEN_MULT)
        return out[:n]

    if signal.ndim == 2:
        return np.stack([one(ch) for ch in signal])
    return one(signal)
