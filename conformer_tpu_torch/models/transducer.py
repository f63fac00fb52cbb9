"""Transducer (RNN-T): the Conformer encoder, an LSTM prediction network
over the label history and an additive joint (counterpart of
conformer_tpu/models/transducer.py).

``Transducer(cfg, compute_dtype)``: ``forward`` gives the (B, T', U+1, V)
joint lattice, ``forward_factors`` the joint's additive halves for the
lattice-free loss (ops/rnnt.py::rnnt_loss_scan), and ``encode``,
``joint_logits``, ``predict_init`` and ``predict_step`` are what the greedy
decode and the beam search (ops/rnnt.py) step through (``frame_fns``
gives the last two with their weights cast once, the same two functions
for as long as those weights are unchanged, for the frame loops' CUDA
graphs).

The LSTM cell is flax's ``OptimizedLSTMCell``: gates [i, f, g, o], input
kernels without a bias and recurrent kernels with one, the products and
gates in the compute dtype and the carry ``(c, h)`` in fp32 (flax's
parameter dtype, to which the bf16 gates promote). Parameters carry the
gates stacked: ``weight_ih`` (4H, in) holds the ``ii/if/ig/io`` kernels,
``weight_hh`` (4H, H) and ``bias`` (4H,) the ``hi/hf/hg/ho`` ones
(convert.py maps them). ``init_weights`` draws seeded random weights with
flax's initialiser families.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from conformer_tpu_torch.config import ModelConfig
from conformer_tpu_torch.models import conformer
from conformer_tpu_torch.models.encoder import ConformerEncoder
from conformer_tpu_torch.models.layers import DTYPES, Dense, cast

Carry = Tuple[torch.Tensor, torch.Tensor]          # (c, h), fp32


def lstm_step(carry: Carry, gx: torch.Tensor, w_hh: torch.Tensor,
              bias: torch.Tensor) -> Carry:
    """One OptimizedLSTMCell step: the recurrent gates in w_hh's dtype (the
    compute dtype) plus the input gates ``gx``, then c and h in fp32."""
    c, h = carry
    gates = F.linear(cast(h, w_hh.dtype), w_hh, bias) + gx
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    f32 = torch.float32
    new_c = cast(f, f32) * c + cast(i * torch.tanh(g), f32)
    return new_c, cast(o, f32) * torch.tanh(new_c)


class LSTMCell(nn.Module):
    """flax ``OptimizedLSTMCell``'s parameters; ``lstm_step`` steps it."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.compute_dtype = hidden_dim, dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_dim, input_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_dim, hidden_dim))
        self.bias = nn.Parameter(torch.zeros(4 * hidden_dim))

    def weights(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """-> (weight_ih, weight_hh, bias) in the compute dtype."""
        dt = self.compute_dtype
        return (cast(self.weight_ih, dt), cast(self.weight_hh, dt),
                cast(self.bias, dt))

    def init_carry(self, batch: int, device) -> Carry:
        zeros = torch.zeros(batch, self.hidden_dim, device=device)
        return zeros, zeros.clone()


class PredictionNetwork(nn.Module):
    """Label history: embed -> n-layer LSTM, teacher-forced over a whole
    transcript (``forward``) or one input at a time (``step_fn``)."""

    def __init__(self, vocab_size: int, embed_dim: int = 320,
                 hidden_dim: int = 320, n_layers: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.compute_dtype = embed_dim, dtype
        self.embedding = nn.Parameter(torch.empty(vocab_size, embed_dim))
        self.cells = nn.ModuleList(
            LSTMCell(embed_dim if i == 0 else hidden_dim, hidden_dim, dtype)
            for i in range(n_layers))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return cast(self.embedding, self.compute_dtype)[cast(tokens, torch.int64)]

    def init_state(self, batch: int, device) -> List[Carry]:
        return [cell.init_carry(batch, device) for cell in self.cells]

    def step_fn(self):
        """-> step(state, x (B, E) embedded input) -> (state, (B, H))
        through every layer, each weight cast to the compute dtype once,
        when it is made: a decode makes it once and calls it T' x
        max_symbols times (the casts are loop invariants, which XLA hoists
        out of the JAX decode's scan)."""
        cells = [cell.weights() for cell in self.cells]

        def step(state, x):
            new_state = []
            for (w_ih, w_hh, bias), carry in zip(cells, state):
                carry = lstm_step(carry, F.linear(cast(x, w_ih.dtype), w_ih),
                                  w_hh, bias)
                new_state.append(carry)
                x = carry[1]
            return new_state, x

        return step

    def forward(self, labels: torch.Tensor) -> torch.Tensor:
        """(B, U) ids -> (B, U+1, H): output u conditions on labels[:, :u];
        position 0 is the empty history, whose embedding is zeroed."""
        b = labels.shape[0]
        x = self.embed(F.pad(labels, (1, 0)))
        x = torch.cat([torch.zeros_like(x[:, :1]), x[:, 1:]], dim=1)
        for cell in self.cells:
            w_ih, w_hh, bias = cell.weights()
            gates_x = F.linear(cast(x, w_ih.dtype), w_ih)  # out of the loop
            carry = cell.init_carry(b, x.device)
            outs = []
            for u in range(x.shape[1]):
                carry = lstm_step(carry, gates_x[:, u], w_hh, bias)
                outs.append(carry[1])
            x = torch.stack(outs, dim=1)
        return x


class JointNetwork(nn.Module):
    """Additive joint: ``out(tanh(enc_proj(enc) + pred_proj(pred)))``, the
    projections in the compute dtype and ``out`` in fp32."""

    def __init__(self, enc_dim: int, pred_dim: int, vocab_size: int,
                 joint_dim: int = 320, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.enc_proj = Dense(enc_dim, joint_dim, dtype)
        self.pred_proj = Dense(pred_dim, joint_dim, dtype)
        self.out = Dense(joint_dim, vocab_size, torch.float32)

    def factors(self, enc: torch.Tensor, pred: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.enc_proj(enc), self.pred_proj(pred)

    def forward(self, enc: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """enc (..., D), pred (..., P), broadcast together -> (..., V)."""
        e, p = self.factors(enc, pred)
        return self.out(torch.tanh(e + p))


class Transducer(nn.Module):
    def __init__(self, cfg: ModelConfig, compute_dtype: str = "float32"):
        super().__init__()
        if cfg.arch != "transducer":
            raise ValueError(f"Transducer needs model.arch='transducer', "
                             f"got {cfg.arch!r}")
        self.cfg = cfg
        dtype = DTYPES[compute_dtype]
        self.encoder = ConformerEncoder(cfg, dtype)
        self.prediction = PredictionNetwork(
            cfg.vocab_size, cfg.pred_embed_dim, cfg.pred_hidden_dim,
            cfg.pred_layers, dtype)
        self.joint = JointNetwork(cfg.d_model, cfg.pred_hidden_dim,
                                  cfg.vocab_size, cfg.joint_dim, dtype)

    def forward(self, mels: torch.Tensor, lengths: Optional[torch.Tensor],
                labels: torch.Tensor, dropout_seed: Optional[int] = None):
        """-> ((B, T', U+1, V) fp32 lattice, (B,) encoder lengths)."""
        enc, enc_lengths = self.encoder(mels, lengths, dropout_seed)
        pred = self.prediction(labels)
        return self.joint(enc[:, :, None, :], pred[:, None, :, :]), enc_lengths

    def encode(self, mels: torch.Tensor, lengths: Optional[torch.Tensor],
               dropout_seed: Optional[int] = None):
        return self.encoder(mels, lengths, dropout_seed)

    def forward_factors(self, mels: torch.Tensor,
                        lengths: Optional[torch.Tensor], labels: torch.Tensor,
                        dropout_seed: Optional[int] = None):
        """-> ((e (B, T', J), p (B, U+1, J)), encoder lengths): the joint's
        halves, for rnnt_loss_scan with ``joint.out``'s parameters."""
        enc, enc_lengths = self.encoder(mels, lengths, dropout_seed)
        return self.joint.factors(enc, self.prediction(labels)), enc_lengths

    def joint_logits(self, enc_t: torch.Tensor, pred: torch.Tensor):
        """enc_t (B, D), pred (B, P) -> (B, V) fp32 logits."""
        return self.joint(enc_t, pred)

    def predict_init(self, batch: int, device=None):
        """-> (state, pred): the empty history, one step of the prediction
        network on a zeroed embedding (not the zero state)."""
        device = device or self.prediction.embedding.device
        x = torch.zeros(batch, self.cfg.pred_embed_dim, device=device,
                        dtype=self.prediction.compute_dtype)
        return self.prediction.step_fn()(
            self.prediction.init_state(batch, device), x)

    def predict_step(self, state: List[Carry], tokens: torch.Tensor):
        """state, (B,) ids -> (state, (B, H)): advance by one token."""
        return self.prediction.step_fn()(state, self.prediction.embed(tokens))

    def frame_fns(self):
        """-> (joint_logits, predict_step) as functions for the frame loops
        (ops/rnnt.py: the greedy decode and the beam search), every weight
        cast to the compute dtype once, when they are made, instead of at
        each call (see PredictionNetwork.step_fn). The same two functions
        come back while no parameter of the prediction network or the joint
        has moved or changed (its address and version counter), so that a
        loop's CUDA graph, which reads their weights by address, is captured
        once for them (ops/frame_graph.py); under ``torch.export`` they are
        made anew."""
        if torch.compiler.is_exporting():
            return self._make_frame_fns()
        key = tuple((p.data_ptr(), p._version) for m in (self.prediction,
                                                         self.joint)
                    for p in m.parameters())
        cached = self.__dict__.get("_frame_fns")
        if cached is None or cached[0] != key:
            cached = (key, self._make_frame_fns())
            self.__dict__["_frame_fns"] = cached
        return cached[1]

    def _make_frame_fns(self):
        pred, joint = self.prediction, self.joint
        dt = pred.compute_dtype
        enc_w, enc_b, pred_w, pred_b, emb = (cast(x, dt) for x in (
            joint.enc_proj.weight, joint.enc_proj.bias,
            joint.pred_proj.weight, joint.pred_proj.bias, pred.embedding))
        step = pred.step_fn()

        def joint_fn(enc_t, p):
            x = torch.tanh(F.linear(cast(enc_t, dt), enc_w, enc_b)
                           + F.linear(cast(p, dt), pred_w, pred_b))
            return joint.out(x)

        def pred_step_fn(state, tokens):
            return step(state, emb[cast(tokens, torch.int64)])

        return joint_fn, pred_step_fn


@torch.no_grad()
def init_weights(model: Transducer, seed: int = 0) -> Transducer:
    """Seeded random weights drawn on the CPU: the encoder's and the joint's
    as ``models/conformer.py::init_weights`` draws them (lecun-normal Dense
    kernels, zero biases), the embedding normal with variance 1/E
    (``nn.Embed``), each LSTM input kernel lecun-normal, each recurrent
    gate kernel orthogonal and the biases zero (``OptimizedLSTMCell``)."""
    conformer.init_weights(model, seed)
    gen = torch.Generator().manual_seed(seed + 1)
    pred = model.prediction
    pred.embedding.copy_(torch.randn(pred.embedding.shape, generator=gen)
                         / math.sqrt(pred.embedding.shape[1]))
    for cell in pred.cells:
        h, n_in = cell.hidden_dim, cell.weight_ih.shape[1]
        cell.weight_ih.copy_(torch.cat([
            conformer.lecun_normal((h, n_in), n_in, gen) for _ in range(4)]))
        cell.weight_hh.copy_(torch.cat([conformer.orthogonal(h, h, gen).T
                                        for _ in range(4)]))
        cell.bias.zero_()
    return model
