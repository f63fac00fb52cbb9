"""Host-side audio I/O (counterpart of conformer_tpu/audio/io.py).

WAV and FLAC, from files or in-memory payloads, and polyphase resampling.
The orders are the JAX package's: WAV through scipy first and the native
decoder (``audio/native.py``) for files scipy rejects; FLAC through the
native decoder first and the pure-Python one (``audio/flac.py``) for streams
the native one rejects; resampling always through the native polyphase
filter, whose build failing raises.
"""

from __future__ import annotations

import io as _io
import os
from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile

from conformer_tpu_torch.audio import native

_INT_SCALE = {np.dtype(np.int16): 32768.0, np.dtype(np.int32): 2147483648.0,
              np.dtype(np.uint8): 128.0}


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    """Integer PCM -> float32 in [-1, 1]; 2-D data -> (channels, samples)."""
    if data.dtype in _INT_SCALE:
        signal = data.astype(np.float32) / _INT_SCALE[data.dtype]
        if data.dtype == np.dtype(np.uint8):
            signal = signal - 1.0
    else:
        signal = data.astype(np.float32)
    return signal.T if signal.ndim == 2 else signal


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 signal in [-1, 1], (channels, samples) if multi-channel;
    sample rate). scipy's reader first; the native decoder for encodings
    scipy rejects (e.g. some WAVE_FORMAT_EXTENSIBLE files)."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        sr, data = wavfile.read(path)
        return _pcm_to_float(data), int(sr)
    except Exception as scipy_err:   # a parse error: try the native decoder
        try:
            return native.read_wav(path)
        except ValueError:
            raise ValueError(f"unreadable WAV: {path}") from scipy_err


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 signal in [-1, 1], (channels, samples) if multi-channel;
    sample rate). The same PCM decodes to the identical float array from a
    FLAC and a WAV. The native decoder first; the pure-Python one for a
    stream the native one rejects, whose error names the fault."""
    try:
        return native.read_flac(path)
    except ValueError:
        from conformer_tpu_torch.audio import flac

        return flac.read_flac(path)


def _sniff_format(magic: bytes, what: str) -> str:
    """The first bytes past an ID3 tag -> "flac" | "wav", or a ValueError
    that names a recognised format this package does not read."""
    if magic[:4] == b"fLaC":
        return "flac"
    if magic[:4] in (b"RIFF", b"RIFX"):
        return "wav"
    for prefix, name in ((b"OggS", "OGG"), (b"\xff\xfb", "MP3"),
                         (b"\xff\xf3", "MP3"), (b"\xff\xf2", "MP3")):
        if magic[: len(prefix)] == prefix:
            raise ValueError(f"{name} is not supported ({what}); "
                             "supported formats: WAV, FLAC")
    raise ValueError(f"unrecognized audio format ({what}); "
                     "supported formats: WAV, FLAC")


def _skip_id3(header: bytes) -> int:
    """-> offset past a leading ID3v2 tag (0 when none)."""
    if header[:3] == b"ID3" and len(header) >= 10:
        size = ((header[6] & 0x7F) << 21) | ((header[7] & 0x7F) << 14) | \
               ((header[8] & 0x7F) << 7) | (header[9] & 0x7F)
        return 10 + size
    return 0


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Format-sniffing load: WAV (RIFF/RIFX) or FLAC by magic bytes, past a
    leading ID3v2 tag -> (float32 signal in [-1, 1], sample rate)."""
    with open(path, "rb") as f:
        magic = f.read(10)
        off = _skip_id3(magic)
        if off:
            f.seek(off)
            magic = f.read(4)
    fmt = _sniff_format(magic, path)
    return read_flac(path) if fmt == "flac" else read_wav(path)


def decode_wav_bytes(raw: bytes) -> Tuple[np.ndarray, int]:
    """An in-memory WAV payload -> (float32 signal in [-1, 1], (channels,
    samples) if multi-channel; sample rate), scaled as read_wav scales."""
    sr, data = wavfile.read(_io.BytesIO(raw))
    return _pcm_to_float(data), int(sr)


def decode_audio_bytes(raw: bytes) -> Tuple[np.ndarray, int]:
    """In-memory counterpart of read_audio (an upload arrives as bytes):
    the same sniffing and the same named errors."""
    off = _skip_id3(raw[:10])
    fmt = _sniff_format(raw[off: off + 4], "<uploaded payload>")
    if fmt == "flac":
        from conformer_tpu_torch.audio.flac import decode_flac_bytes

        return decode_flac_bytes(raw)
    return decode_wav_bytes(raw[off:] if off else raw)


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (Kaiser-windowed sinc, the native filter),
    float32."""
    return native.resample(signal, orig_sr, target_sr)


def load_audio(path: str, sample_rate: int = 16000, mono: bool = True,
               channel: Optional[int] = None) -> np.ndarray:
    """Load and resample to ``sample_rate`` float32. ``channel`` selects one
    channel of a multi-channel file; otherwise ``mono`` averages them."""
    signal, sr = read_audio(path)
    if signal.ndim == 2:
        if channel is not None:
            signal = signal[channel]
        elif mono:
            signal = signal.mean(axis=0)
    return resample(signal, sr, sample_rate)


def split_segment(signal: np.ndarray, start_s: float, end_s: float,
                  sample_rate: int = 16000) -> np.ndarray:
    """Slice [start_s, end_s) seconds."""
    return signal[int(start_s * sample_rate): int(end_s * sample_rate)]
