"""Log-mel spectrogram frontend in PyTorch.

Counterpart of ``conformer_tpu/audio/mel.py``: torchaudio-style
``MelSpectrogram(n_fft=400, hop=160, n_mels=80, slaney)`` followed by
``log(clamp(mel, 1e-5))``. The windowed DFT is one real product
``frames @ [window*cos | window*sin]`` (``stft_impl='matmul'``), with an
``'rfft'`` path for cross-checking and the fused kernel K3
(``ops/cuda/mel_frontend.py``) as ``'pallas'``; ``'auto'`` takes the kernel
from ``AUTO_PALLAS_MIN_FRAMES`` frames up, as the JAX frontend does.
Output is time-major ``(..., n_frames, n_mels)``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from conformer_tpu_torch.config import AudioConfig
from conformer_tpu_torch.ops.cuda.mel_frontend import k3_operands, logmel_fwd_op

_MEL_BREAK_HZ = 1000.0
_MEL_BREAK = 15.0          # slaney mels at 1 kHz (= 1000 / (200/3))
_MEL_LOGSTEP = float(np.log(6.4) / 27.0)


def hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz->mel: linear below 1 kHz, logarithmic above."""
    freq = np.asarray(freq, dtype=np.float64)
    mels = freq / (200.0 / 3.0)
    log_region = freq >= _MEL_BREAK_HZ
    return np.where(
        log_region,
        _MEL_BREAK + np.log(np.maximum(freq, _MEL_BREAK_HZ) / _MEL_BREAK_HZ)
        / _MEL_LOGSTEP,
        mels)


def mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    freq = mels * (200.0 / 3.0)
    log_region = mels >= _MEL_BREAK
    return np.where(log_region,
                    _MEL_BREAK_HZ * np.exp(_MEL_LOGSTEP * (mels - _MEL_BREAK)),
                    freq)


def hz_to_mel_htk(freq: np.ndarray) -> np.ndarray:
    """HTK-scale Hz->mel: 2595 log10(1 + f/700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz_htk(mels: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mels, dtype=np.float64) / 2595.0) - 1.0)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int, fmin: float,
                   fmax: float, norm: Optional[str] = "slaney",
                   mel_scale: str = "slaney") -> np.ndarray:
    """(n_freqs, n_mels) triangular mel filterbank with optional slaney area
    normalisation (torchaudio's ``melscale_fbanks`` construction)."""
    if mel_scale == "htk":
        hz_to_mel, mel_to_hz = hz_to_mel_htk, mel_to_hz_htk
    elif mel_scale == "slaney":
        hz_to_mel, mel_to_hz = hz_to_mel_slaney, mel_to_hz_slaney
    else:
        raise ValueError(f"unknown mel_scale: {mel_scale!r}")
    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_pts = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    f_pts = mel_to_hz(mel_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[None, :-1]
    up = slopes[:, 2:] / f_diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb = fb * (2.0 / (f_pts[2: n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb.astype(np.float32)


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (torch.hann_window default)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _dft_matrix(n_fft: int, window: np.ndarray) -> np.ndarray:
    """(n_fft, 2*(n_fft//2+1)) real matrix of the windowed one-sided DFT:
    frames @ W = [real | -imag]."""
    n_bins = n_fft // 2 + 1
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_bins, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * t * k / n_fft
    return np.concatenate([np.cos(ang) * window[:, None],
                           np.sin(ang) * window[:, None]],
                          axis=1).astype(np.float32)


def reflect_pad(signal: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis by ``pad`` on both sides with numpy's rule,
    which also holds when ``pad`` exceeds the signal length."""
    s = signal.shape[-1]
    idx = torch.arange(-pad, s + pad, device=signal.device)
    if s == 1:
        idx = torch.zeros_like(idx)
    else:
        period = 2 * (s - 1)
        idx = torch.remainder(idx, period)
        idx = torch.where(idx >= s, period - idx, idx)
    return signal[..., idx]


def frame_signal(signal: torch.Tensor, n_fft: int, hop_length: int
                 ) -> torch.Tensor:
    """(..., samples) -> (..., n_frames, n_fft) centred frames
    (torch.stft center=True semantics)."""
    n_frames = signal.shape[-1] // hop_length + 1
    padded = reflect_pad(signal, n_fft // 2)
    return padded.unfold(-1, n_fft, hop_length)[..., :n_frames, :]


class MelFrontend:
    """Log-mel frontend with its constants on ``device``."""

    AUTO_PALLAS_MIN_FRAMES = 1600

    def __init__(self, cfg: AudioConfig | None = None, device="cpu"):
        cfg = cfg or AudioConfig()
        if cfg.win_length != cfg.n_fft:
            raise NotImplementedError("win_length != n_fft not supported yet")
        self.cfg = cfg
        self.device = torch.device(device)
        self.n_bins = cfg.n_fft // 2 + 1
        window = hann_window(cfg.win_length)
        self._window = torch.from_numpy(window).to(self.device)
        self._dft = torch.from_numpy(
            _dft_matrix(cfg.n_fft, window)).to(self.device)
        self._fb = torch.from_numpy(mel_filterbank(
            self.n_bins, cfg.n_mels, cfg.sample_rate, cfg.fmin, cfg.fmax,
            cfg.mel_norm, cfg.mel_scale)).to(self.device)
        # K3's operands: the DFT matrix and the filterbank split into TF32
        # hi and lo parts, once. The CPU path takes the plain version, which
        # reads _dft and _fb as they are; an exported program carries both
        # to whichever device it is moved to.
        self._k3 = k3_operands(self._dft, self._fb, cfg.hop_length,
                               cfg.n_fft)

    def power_spectrogram(self, signal: torch.Tensor) -> torch.Tensor:
        """(..., samples) -> (..., n_frames, n_bins) power spectrogram."""
        frames = frame_signal(signal, self.cfg.n_fft, self.cfg.hop_length)
        if self.cfg.stft_impl != "rfft":
            proj = frames @ self._dft
            re, im = proj[..., : self.n_bins], proj[..., self.n_bins:]
            return re * re + im * im
        spec = torch.fft.rfft(frames * self._window, n=self.cfg.n_fft, dim=-1)
        return (spec.real ** 2 + spec.imag ** 2).to(torch.float32)

    def impl_for(self, num_samples: int) -> str:
        """The path __call__ takes for signals of this many samples."""
        impl = self.cfg.stft_impl
        if impl == "auto":
            n_frames = num_samples // self.cfg.hop_length + 1
            impl = ("pallas" if n_frames >= self.AUTO_PALLAS_MIN_FRAMES
                    else "matmul")
        return impl

    def __call__(self, signal: torch.Tensor) -> torch.Tensor:
        """(..., samples) fp32 -> (..., n_frames, n_mels) log-mel features."""
        if self.impl_for(signal.shape[-1]) == "pallas":
            return self._kernel_logmel(signal)
        mel = self.power_spectrogram(signal) @ self._fb
        return torch.log(torch.clamp(mel, min=self.cfg.log_clamp_min))

    def _kernel_logmel(self, signal: torch.Tensor) -> torch.Tensor:
        """Fused frame+window+DFT+mel+log (kernel K3 on the GPU)."""
        squeeze = signal.ndim == 1
        if squeeze:
            signal = signal[None]
        padded = reflect_pad(signal, self.cfg.n_fft // 2).contiguous()
        n_frames = signal.shape[-1] // self.cfg.hop_length + 1
        out = logmel_fwd_op(padded, self._dft, self._fb, self.cfg.hop_length,
                            self.cfg.n_fft, n_frames, self.cfg.log_clamp_min,
                            *self._k3)
        return out[0] if squeeze else out

    def frame_lengths(self, sample_lengths: torch.Tensor) -> torch.Tensor:
        """Valid frame count per utterance."""
        return sample_lengths // self.cfg.hop_length + 1


@functools.lru_cache(maxsize=4)
def default_frontend(device="cuda", **audio_kwargs) -> MelFrontend:
    """A shared frontend of ``AudioConfig(**audio_kwargs)`` on ``device``
    (the card unless the caller asks for the CPU)."""
    return MelFrontend(AudioConfig(**audio_kwargs), device=device)
