"""Model FLOPs and the attention's least work: the yardstick of ``mfu.*``
and of the attention rooflines.

``model_train_flops`` and its helpers are a frozen copy of
bench.py:221-289 (the analytic matmul/conv FLOPs, forward x
3 for a train step, recomputation not counted), taking the configuration
tree as a dict. The benchmark counts each row at its real length:
``*_rows`` sum the per-row counts, so padding adds nothing.

``attention_work`` is the least work of relative-position self-attention,
whatever implements it: per block and row of L frames, the content
scores, the position scores against a (2L-1)-row relative table and the
probabilities times V (2 L^2 D each), and the position projection
(2 L D^2); the backward twice the forward. Bytes: each input read once
and each output written once, in the compute dtype (q+u, q+v, k, v and
the position weights in; the context out; the backward also reads the
output's gradient and writes the five gradients).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Iterable, Tuple


def _ns(cfg: dict) -> SimpleNamespace:
    return SimpleNamespace(model=SimpleNamespace(**cfg["model"]),
                           audio=SimpleNamespace(**cfg["audio"]))


# ---- frozen copy of bench.py:221-289 ------------------------------------

def _post_subsample_frames(mel_frames: int) -> int:
    return ((mel_frames - 1) // 2 - 1) // 2


def _mel_fwd_flops(cfg, b: int, mel_frames: int) -> float:
    n_fft = cfg.audio.n_fft
    n_mels = cfg.model.n_mel_channels
    return (2.0 * b * mel_frames * n_fft * (n_fft // 2 + 1) * 2
            + 2.0 * b * mel_frames * (n_fft // 2 + 1) * n_mels)


def _subsample_proj_fwd_flops(cfg, b: int, mel_frames: int) -> float:
    m = cfg.model
    d, n_mels = m.d_model, m.n_mel_channels
    t1 = (mel_frames - 1) // 2
    l = (t1 - 1) // 2
    f1 = (n_mels - 1) // 2
    f2 = (f1 - 1) // 2
    fwd = 2.0 * b * d * f1 * t1 * 9                    # conv1 (1 -> d, k3)
    if getattr(m, "subsample_impl", "conv2d") == "separable":
        fwd += 2.0 * b * d * f2 * l * (9 + d)          # dw + pw
    else:
        fwd += 2.0 * b * d * f2 * l * 9 * d            # conv2 (d -> d, k3)
    fwd += 2.0 * b * l * (f2 * d) * d                  # input projection
    return fwd


def _blocks_fwd_flops(cfg, b: int, l: int) -> float:
    m = cfg.model
    d = m.d_model
    per_block = (
        2 * (2.0 * b * l * d * 4 * d * 2)              # ffn1 + ffn2
        + 4 * (2.0 * b * l * d * d)                    # q/k/v/out projections
        + 2.0 * b * l * d * d                          # pos-table prep (qv @ W)
        + 2.0 * b * l * l * d                          # content scores
        + 2 * (2.0 * b * l * l * d / 2 * 2)            # sin/cos position scores
        + 2.0 * b * l * l * d                          # probs @ V
        + 2.0 * b * l * d * 2 * d                      # conv pointwise1 (GLU)
        + 2.0 * b * l * d * m.kernel_size              # depthwise conv
        + 2.0 * b * l * d * d                          # conv pointwise2
    )
    return m.n_blocks * per_block


def _lstm_head_fwd_flops(cfg, b: int, l: int) -> float:
    m = cfg.model
    h = m.lstm_hidden_dim
    return (2.0 * b * l * (m.d_model * 4 * h + h * 4 * h)
            + 2.0 * b * l * h * m.vocab_size)


def model_train_flops(cfg, batch: int, mel_frames: int) -> float:
    l = _post_subsample_frames(mel_frames)
    fwd = (_mel_fwd_flops(cfg, batch, mel_frames)
           + _subsample_proj_fwd_flops(cfg, batch, mel_frames)
           + _blocks_fwd_flops(cfg, batch, l)
           + _lstm_head_fwd_flops(cfg, batch, l))
    return 3.0 * fwd


# ---- per-row sums ---------------------------------------------------------

def mel_frames(samples: int, hop: int) -> int:
    return samples // hop + 1


def train_flops_rows(cfg: dict, rows: Iterable[Tuple[int, int]]) -> float:
    """Sum over rows of (real samples, real tokens) of the CTC train
    step's FLOPs at that row's length."""
    ns = _ns(cfg)
    hop = cfg["audio"]["hop_length"]
    total = 0.0
    for samples, tokens in rows:
        total += model_train_flops(ns, 1, mel_frames(int(samples), hop))
    return total


def attention_work(cfg: dict, batches: Iterable[Iterable[int]],
                   backward: bool) -> Tuple[float, float]:
    """-> (FLOPs, bytes) of the attention's least work over ``batches``,
    each a list of rows' real samples, in every block."""
    m = cfg["model"]
    d, n_blocks = m["d_model"], m["n_blocks"]
    width = 2 if cfg["optim"]["compute_dtype"] == "bfloat16" else 4
    hop = cfg["audio"]["hop_length"]
    flops = nbytes = 0.0
    for rows in batches:
        io = 0.0
        for samples in rows:
            l = _post_subsample_frames(mel_frames(int(samples), hop))
            if l <= 0:
                continue
            f = 6.0 * l * l * d + 2.0 * l * d * d
            flops += 2.0 * f if backward else f
            io += (9.0 if backward else 5.0) * l * d
        nbytes += (io + (2.0 if backward else 1.0) * d * d) * width
    return flops * n_blocks, nbytes * n_blocks
