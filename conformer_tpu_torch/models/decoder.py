"""LSTM decoder head: LSTM -> swish -> masked BatchNorm -> vocab projection
(counterpart of conformer_tpu/models/decoder.py).

The LSTM is a loop over time with the input projection hoisted out of it,
in the compute dtype like the JAX scan (the cell state is carried in that
dtype too); under ``torch.export`` the loop is one ``while_loop``
(ops/frame_graph.py::exported_loop), so a program's size does not grow
with its bucket. Gate order [i, f, g, o], torch's. Parameters carry
``nn.LSTMCell``'s names; ``bias_hh`` is a zero buffer, since the JAX cell has
one bias only.

Under a mesh the input projection of each LSTM layer is column-parallel
over the gates, gathered whole before the recurrence, which every rank of
the model group runs alike; the classifier is column-parallel over the
vocabulary, gathered whole; each only where tp divides its width (370 over
4 does not: the classifier then stays whole, with the same numbers). The
BatchNorm sums its statistics over the data group.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from conformer_tpu_torch.models.layers import Dense, MaskedBatchNorm, swish
from conformer_tpu_torch.ops.frame_graph import exported_loop
from conformer_tpu_torch.parallel.collectives import (copy_to_model,
                                                      gather_from_model)
from conformer_tpu_torch.utils.spans import span


class LSTMLayer(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden_dim, self.compute_dtype = hidden_dim, dtype
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden_dim, input_dim))
        self.bias_ih = nn.Parameter(torch.zeros(4 * hidden_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden_dim, hidden_dim))
        self.register_buffer("bias_hh", torch.zeros(4 * hidden_dim))

    def forward(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """(L, B, D) time-major -> (L, B, H). group: the model group when
        the input weights hold this rank's gates."""
        dt = self.compute_dtype
        if group is not None:
            x = copy_to_model(x, group)
        gates_x = F.linear(x.to(dt), self.weight_ih.to(dt),
                           (self.bias_ih + self.bias_hh).to(dt))
        if group is not None:
            gates_x = gather_from_model(gates_x, group, -1)
        w_hh_t = self.weight_hh.to(dt).T
        b = x.shape[1]
        h = torch.zeros(b, self.hidden_dim, dtype=dt, device=x.device)
        c = torch.zeros_like(h)
        if not len(gates_x):
            return gates_x.new_zeros(0, b, self.hidden_dim)

        def cell(h, c, gx):
            i, f, g, o = torch.chunk(gx + h @ w_hh_t, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            return torch.sigmoid(o) * torch.tanh(c), c

        if torch.compiler.is_exporting():
            def step(carry, gx, t, inputs):
                h, c = cell(*carry, gx)
                return (h, c), h

            return exported_loop(step, (h, c), gates_x)[1]
        outs = []
        for gx in gates_x:
            h, c = cell(h, c, gx)
            outs.append(h)
        return torch.stack(outs)


class LSTMDecoder(nn.Module):
    def __init__(self, d_model: int, vocab_size: int, hidden_dim: int = 640,
                 n_layers: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lstm = nn.ModuleList(
            LSTMLayer(d_model if i == 0 else hidden_dim, hidden_dim, dtype)
            for i in range(n_layers))
        self.norm = MaskedBatchNorm(hidden_dim, dtype=dtype)
        self.classifier = Dense(hidden_dim, vocab_size, dtype)
        self.mesh, self.lstm_split, self.classifier_split = None, False, False

    def forward(self, x: torch.Tensor,
                frame_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, L, d_model) -> (B, L, vocab) unnormalised logits."""
        group = None if self.mesh is None else self.mesh.model_group
        x = x.transpose(0, 1)
        with span("model.lstm_head"):
            for layer in self.lstm:
                x = layer(x, group if self.lstm_split else None)
        x = swish(x)
        x = self.norm(x, mask=None if frame_mask is None else frame_mask.T,
                      use_running_average=not self.training)
        if self.classifier_split:
            logits = gather_from_model(self.classifier(copy_to_model(x, group)),
                                       group, -1)
        else:
            logits = self.classifier(x)
        return logits.transpose(0, 1)
