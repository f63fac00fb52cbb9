"""The plain reference of the benchmark's training cells: the log-mel
frontend, SpecAugment, the Conformer encoder (convolution subsampling, the
macaron blocks with Transformer-XL relative-position attention, the
convolution module with its masked batch norm, hash dropout), the CTC head
(an LSTM, swish, masked batch norm, the classifier, the CTC loss) and
Adam, in float32 with TF32 off.

It is written from the equations, over a dict of float32 tensors named as
the program's state dict, and takes from the program nothing but the
inputs the benchmark made: the raw padded audio, the lengths, the token
ids and the weights. The dropout masks and SpecAugment's masks are worked
out again from the step's seed (draws.py). The position scores are
``qv_i . (W_pos PE(i - j) + b_pos)`` over an explicit (2L-1)-row table and a
gather, not the program's sin/cos rewrite.

``Precision("fp8")`` is the control: the reference computed one step
below the configuration's bfloat16, at the points where the program
rounds to its compute dtype (each product's operands and output, each
norm's, activation's, dropout's and residual sum's output, the LSTM's
gates and state), each tensor is rounded to float8 e4m3 with a per-tensor
scale, and its gradient to float8 e5m2 with a per-tensor scale. What the
program computes in float32 (the frontend, the norms' statistics, the
loss) stays float32. ``Precision("bf16")`` rounds at the same points to
bfloat16: a witness of what the configuration's own rounding does.

Imports only torch and numpy.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference import draws

BUFFERS = (".mean", ".var", ".bias_hh")


def trainable(name: str) -> bool:
    return not name.endswith(BUFFERS)


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    s = x.detach().abs().amax().clamp(min=1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, 57344.0)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    """'fp32': products as they are; 'bf16': each rounding point rounds to
    bfloat16 (the configuration's own precision, emulated: a witness of
    what rounding alone does); 'fp8': to e4m3, gradients to e5m2 (the
    control)."""

    ROUND = {"bf16": _Bf16, "fp8": _Fp8}

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"precision must be fp32|bf16|fp8, got {name!r}")
        self.name = name
        self.fn = self.ROUND.get(name)

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn.apply(x) if self.fn is not None else x


# ---------------------------------------------------------------------------
# Frontend
# ---------------------------------------------------------------------------

def mel_filterbank(n_freqs: int, n_mels: int, sr: int, fmin: float,
                   fmax: float) -> np.ndarray:
    """(n_freqs, n_mels) triangular filters on the Slaney mel scale with
    Slaney area normalisation."""
    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        lin = f / (200.0 / 3.0)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1000.0)
                                                    / 1000.0)
                        / (np.log(6.4) / 27.0), lin)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        return np.where(m >= 15.0,
                        1000.0 * np.exp(np.log(6.4) / 27.0 * (m - 15.0)),
                        m * (200.0 / 3.0))

    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax),
                                  n_mels + 2))
    diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[None, :-1]
    up = slopes[:, 2:] / diff[None, 1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    fb *= (2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels]))[None, :]
    return fb


def log_mel(audio: torch.Tensor, audio_cfg: dict) -> torch.Tensor:
    """(B, S) padded audio -> (B, S // hop + 1, n_mels) log-mels: a centred
    STFT with reflect padding and a periodic Hann window, power, the
    filterbank, log of the clamped energies. The DFT runs in float64."""
    n_fft, hop = audio_cfg["n_fft"], audio_cfg["hop_length"]
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64,
                               device=audio.device)
    spec = torch.stft(audio.double(), n_fft, hop_length=hop, win_length=n_fft,
                      window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    power = (spec.real ** 2 + spec.imag ** 2).transpose(1, 2)
    fb = torch.from_numpy(mel_filterbank(
        n_fft // 2 + 1, audio_cfg["n_mels"], audio_cfg["sample_rate"],
        audio_cfg["fmin"], audio_cfg["fmax"])).to(audio.device)
    mel = power @ fb
    return torch.log(torch.clamp(mel, min=audio_cfg["log_clamp_min"])).float()


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _swish(x):
    return x * torch.sigmoid(x)


class Reference:
    """The model of a configuration dict (``model`` and ``audio`` groups of
    the program's config tree) over the weights ``w``."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor],
                 precision: Precision):
        self.m, self.audio = cfg["model"], cfg["audio"]
        self.w, self.p = w, precision
        self.rate = float(self.m["dropout_rate"])

    # -- pieces ------------------------------------------------------------
    def lin(self, x, name, bias=True):
        q = self.p.q
        return q(F.linear(q(x), q(self.w[name + ".weight"]),
                          self.w[name + ".bias"] if bias else None))

    def ln(self, x, name):
        return self.p.q(F.layer_norm(x, (x.shape[-1],),
                                     self.w[name + ".weight"],
                                     self.w[name + ".bias"], eps=1e-6))

    def drop(self, x, words):
        if words is None or self.rate == 0.0:
            return x
        keep = draws.hash_keep(x.shape, words, self.rate, x.device)
        return self.p.q(torch.where(keep, x / (1.0 - self.rate),
                                    torch.zeros_like(x)))

    def batch_norm(self, x, mask, name):
        """Batch statistics over the valid (row, frame) cells, biased
        variance, eps 1e-5."""
        m = mask[..., None].to(x.dtype)
        n = m.sum().clamp(min=1.0)
        mean = (x * m).sum(dim=(0, 1)) / n
        var = (((x - mean) ** 2) * m).sum(dim=(0, 1)) / n
        return self.p.q((x - mean) * torch.rsqrt(var + 1e-5)
                        * self.w[name + ".scale"] + self.w[name + ".bias"])

    def ffn(self, x, name, s):
        h = self.drop(self.p.q(_swish(self.lin(self.ln(x, name + ".norm"),
                                               name + ".hidden"))), s[0])
        return self.drop(self.lin(h, name + ".out"), s[1])

    def attention(self, x, name, lengths, s):
        b, l, d = x.shape
        h = self.m["n_heads"]
        dh = d // h
        q = self.p.q
        a = name + ".attention"
        y = self.ln(x, name + ".norm")
        qx = self.lin(y, a + ".query").view(b, l, h, dh)
        k = self.lin(y, a + ".key").view(b, l, h, dh)
        v = self.lin(y, a + ".value").view(b, l, h, dh)
        qu = q(qx + self.w[a + ".content_bias"])
        qv = q(qx + self.w[a + ".position_bias"])
        # PE(r) for r = -(L-1) .. L-1, row r + L - 1
        r = torch.arange(-(l - 1), l, dtype=torch.float64, device=x.device)
        inv = torch.exp(torch.arange(0, d, 2, dtype=torch.float64,
                                     device=x.device)
                        * -(math.log(10000.0) / d))
        ang = r[:, None] * inv[None, :]
        pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
        pe = pe.reshape(2 * l - 1, d).float()
        prel = self.lin(pe, a + ".pos").view(2 * l - 1, h, dh)
        content = torch.einsum("bihd,bjhd->bhij", q(qu), q(k))
        pos_all = torch.einsum("bihd,rhd->bhir", q(qv), q(prel))
        i = torch.arange(l, device=x.device)
        idx = (i[:, None] - i[None, :] + l - 1).expand(b, h, l, l)
        pos = pos_all.gather(-1, idx)
        scores = (content + pos) / math.sqrt(dh)
        valid = i[None, :] < lengths[:, None]
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.finfo(torch.float32).min)
        probs = torch.softmax(scores, dim=-1)
        if s is not None and self.rate > 0.0:
            keep = draws.attention_keep(s[2][0], b, h, l, self.rate, x.device)
            probs = torch.where(keep, probs / (1.0 - self.rate),
                                torch.zeros_like(probs))
        ctx = torch.einsum("bhij,bjhd->bihd", q(probs), q(v)).reshape(b, l, d)
        return self.drop(self.lin(ctx, a + ".out"), s[3] if s else None)

    def conv(self, x, name, mask, s):
        q = self.p.q
        y = self.lin(self.ln(x, name + ".norm"), name + ".pointwise1")
        a, g = y.chunk(2, dim=-1)
        y = q(a * torch.sigmoid(g))
        y = torch.where(mask[..., None], y, torch.zeros_like(y))
        wd = self.w[name + ".depthwise.weight"]
        k = wd.shape[-1]
        left = (k - 1) // 2
        y = q(F.conv1d(F.pad(q(y).transpose(1, 2), (left, k - 1 - left)),
                       q(wd), self.w[name + ".depthwise.bias"],
                       groups=y.shape[-1]).transpose(1, 2))
        y = q(_swish(self.batch_norm(y, mask, name + ".bn")))
        return self.drop(self.lin(y, name + ".pointwise2"), s[4] if s else None)

    def encode(self, mels, mel_lengths, dropout_seed: Optional[int]):
        """(B, T, n_mels) -> ((B, T', D), (B,) lengths)."""
        q = self.p.q
        e = "encoder."
        x = q(F.relu(F.conv2d(q(mels[:, None]),
                              q(self.w[e + "subsample.conv1.weight"]),
                              self.w[e + "subsample.conv1.bias"], stride=2)))
        x = q(F.relu(F.conv2d(x, q(self.w[e + "subsample.conv2.weight"]),
                              self.w[e + "subsample.conv2.bias"], stride=2)))
        b, c, t, f = x.shape
        x = self.lin(x.permute(0, 2, 3, 1).reshape(b, t, f * c),
                     e + "input_proj")
        words_in, blocks = None, None
        if dropout_seed is not None and self.rate > 0.0:
            words_in, blocks = draws.seed_words(dropout_seed,
                                                self.m["n_blocks"])
        x = self.drop(x, words_in)
        lengths = torch.clamp(((mel_lengths - 1) // 2 - 1) // 2, min=0)
        mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
        for i in range(self.m["n_blocks"]):
            s = blocks[i] if blocks is not None else None
            args = (x, f"{e}blocks.{i}.", lengths, mask, s)
            # each block recomputed in the backward: the reference holds one
            # block's (B, H, L, 2L-1) position scores at a time
            x = (checkpoint(self.block, *args, use_reentrant=False)
                 if torch.is_grad_enabled() else self.block(*args))
        return x, lengths, mask

    def block(self, x, n, lengths, mask, s):
        q = self.p.q
        x = q(0.5 * self.ffn(x, n + "ffn1", s[0:2] if s else (None, None)) + x)
        x = q(self.attention(x, n + "mhsa", lengths, s) + x)
        x = q(self.conv(x, n + "conv", mask, s) + x)
        x = q(0.5 * self.ffn(x, n + "ffn2", s[5:7] if s else (None, None)) + x)
        return self.ln(x, n + "final_norm")

    # -- heads -------------------------------------------------------------
    def _lstm(self, gx, w_hh):
        """gx (B, L, 4H) input gates -> (B, L, H); gates [i, f, g, o]; c
        and h kept in the compute dtype, as the program keeps them."""
        q = self.p.q
        bsz, l, four_h = gx.shape
        h = gx.new_zeros(bsz, four_h // 4)
        c = torch.zeros_like(h)
        wq = q(w_hh)
        outs = []
        for t in range(l):
            g = q(gx[:, t] + q(F.linear(q(h), wq)))
            i, f, gg, o = g.chunk(4, dim=-1)
            c = q(torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg))
            h = q(torch.sigmoid(o) * torch.tanh(c))
            outs.append(h)
        return torch.stack(outs, dim=1)

    def ctc_logits(self, enc, mask):
        q = self.p.q
        x = enc
        n = 0
        while f"decoder.lstm.{n}.weight_ih" in self.w:
            pre = f"decoder.lstm.{n}."
            gx = q(F.linear(q(x), q(self.w[pre + "weight_ih"]),
                            self.w[pre + "bias_ih"] + self.w[pre + "bias_hh"]))
            x = self._lstm(gx, self.w[pre + "weight_hh"])
            n += 1
        x = self.batch_norm(q(_swish(x)), mask, "decoder.norm")
        return self.lin(x, "decoder.classifier")

    # -- loss --------------------------------------------------------------
    def loss(self, audio, audio_lengths, tokens, token_lengths,
             spec_mask: Optional[torch.Tensor], dropout_seed: Optional[int],
             half_batch: bool = False):
        """The step's loss over the rows with a transcript (``half_batch``:
        a fault, the first half of the rows only)."""
        hop = self.audio["hop_length"]
        mels = log_mel(audio, self.audio)
        if spec_mask is not None:
            mels = torch.where(spec_mask.to(mels.device), 0.0, mels)
        mel_lengths = audio_lengths // hop + 1
        enc, lengths, mask = self.encode(mels, mel_lengths, dropout_seed)
        lp = torch.log_softmax(self.ctc_logits(enc, mask), dim=-1)
        per_row = F.ctc_loss(lp.transpose(0, 1), tokens, lengths,
                             token_lengths, blank=0, reduction="none",
                             zero_infinity=True)
        per_row = per_row / token_lengths.clamp(min=1).to(per_row.dtype)
        keep = (token_lengths > 0).to(per_row.dtype)
        if half_batch:
            keep[keep.shape[0] // 2:] = 0.0
        return (per_row * keep).sum() / keep.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# Three steps of Adam
# ---------------------------------------------------------------------------

def train_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                batches: Sequence[dict], train_seed: int,
                precision: str = "fp32", half_batch: bool = False) -> dict:
    """Follow the program's first steps from ``weights`` on ``batches``
    (each: audio, audio_lengths, tokens, token_lengths as CPU arrays).
    -> {"losses": [...], "grads": each step's gradient a leaf, on the CPU,
    "change": each leaf's change after the last step}. ``half_batch`` plants a fault: the loss over the first
    half of the rows."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = cfg["optim"]
    lr, b1, b2, eps = (opt["learning_rate"], opt["beta1"], opt["beta2"],
                       opt["eps"])
    device = next(iter(weights.values())).device
    params = {k: v.detach().clone().float().requires_grad_(trainable(k))
              for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in params.items()
             if trainable(k)}
    m_state = {k: torch.zeros_like(v) for k, v in start.items()}
    v_state = {k: torch.zeros_like(v) for k, v in start.items()}
    ref = Reference(cfg, params, Precision(precision))
    out: dict = {"losses": [], "grads": []}
    for n, batch in enumerate(batches):
        audio = torch.as_tensor(batch["audio"], device=device)
        al = torch.as_tensor(batch["audio_lengths"], device=device).long()
        tok = torch.as_tensor(batch["tokens"], device=device).long()
        tl = torch.as_tensor(batch["token_lengths"], device=device).long()
        frames = audio.shape[1] // cfg["audio"]["hop_length"] + 1
        spec_mask, dseed = draws.step_draws(
            train_seed, n, audio.shape[0], frames,
            cfg["audio"]["n_mels"], cfg["augment"])
        loss = ref.loss(audio, al, tok, tl, spec_mask, dseed, half_batch)
        grads = torch.autograd.grad(loss, [params[k] for k in start],
                                    allow_unused=True)
        out["losses"].append(float(loss.detach()))
        step = n + 1
        out["grads"].append({})
        with torch.no_grad():
            for k, g in zip(start, grads):
                g = torch.zeros_like(start[k]) if g is None else g
                out["grads"][-1][k] = g.to("cpu", copy=True)
                m_state[k].mul_(b1).add_(g, alpha=1 - b1)
                v_state[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v_state[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                params[k].addcdiv_(m_state[k], denom,
                                   value=-lr / (1 - b1 ** step))
    out["change"] = {k: (params[k].detach() - start[k]) for k in start}
    return out
