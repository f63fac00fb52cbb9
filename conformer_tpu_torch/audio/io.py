"""Host-side audio I/O (counterpart of conformer_tpu/audio/io.py).

WAV decoding and polyphase resampling through scipy. FLAC and the native
C++ decoders are not ported yet: a FLAC file raises a clear error.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

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
    sample rate)."""
    sr, data = wavfile.read(path)
    return _pcm_to_float(data), int(sr)


def _skip_id3(header: bytes) -> int:
    """-> offset past a leading ID3v2 tag (0 when none)."""
    if header[:3] == b"ID3" and len(header) >= 10:
        size = ((header[6] & 0x7F) << 21) | ((header[7] & 0x7F) << 14) | \
               ((header[8] & 0x7F) << 7) | (header[9] & 0x7F)
        return 10 + size
    return 0


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Format-sniffing load: WAV (RIFF/RIFX) by magic bytes. FLAC, OGG and
    MP3 raise a ValueError that names the format."""
    with open(path, "rb") as f:
        magic = f.read(10)
        off = _skip_id3(magic)
        if off:
            f.seek(off)
            magic = f.read(4)
    if magic[:4] in (b"RIFF", b"RIFX"):
        return read_wav(path)
    if magic[:4] == b"fLaC":
        raise ValueError(f"FLAC is not supported by this package yet ({path}); "
                         "convert to WAV")
    for prefix, name in ((b"OggS", "OGG"), (b"\xff\xfb", "MP3"),
                         (b"\xff\xf3", "MP3"), (b"\xff\xf2", "MP3")):
        if magic[: len(prefix)] == prefix:
            raise ValueError(f"{name} is not supported ({path}); "
                             "supported format: WAV")
    raise ValueError(f"unrecognized audio format ({path}); "
                     "supported format: WAV")


def resample(signal: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy.signal.resample_poly), float32."""
    if orig_sr == target_sr:
        return signal.astype(np.float32)
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(signal, target_sr // g, orig_sr // g,
                         axis=-1).astype(np.float32)


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
