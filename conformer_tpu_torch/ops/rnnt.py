"""RNN-T loss and greedy decode (counterpart of conformer_tpu/ops/rnnt.py,
without the beam search).

Loss: the forward recursion over the (T, U+1) lattice,

    alpha[t, u] = logaddexp(alpha[t-1, u] + blank[t-1, u],
                            alpha[t, u-1] + emit[t, u-1]).

The JAX package scans over frames and resolves each frame's row with an
associative scan. Here the loop runs over the U+1 label positions instead
(about 100 against about 600 frames at 24 s), and each column resolves in
closed form: with a_t = alpha[t, u-1] + emit[t, u-1] and C_t the exclusive
prefix sum of blank[:, u] over frames,

    alpha[:, u] = C + logcumsumexp(a - C)   over frames,

a handful of launches per column and no (T, U) history beyond the alpha
columns themselves. C runs to the sum of a column's blank log-probs over
every frame, thousands in magnitude for a peaked model at 24 s, so the
columns are solved in float64: in fp32 both terms would carry rounding on
the scale of |C|, which the JAX per-frame logaddexp does not have. They
are (B, T) vectors, so that costs little. Nothing is masked: alpha at (t, u) depends only on
frames <= t and labels < u, so the padded frames and labels past a row's
lengths change no value that row's result reads, and every value stays
finite (the JAX NEG = -1e30 fill would overflow the prefix sums).

``rnnt_loss_scan`` never builds the (B, T, U+1, V) lattice: it takes the
joint's additive factors and computes the blank and emit planes a chunk of
frames at a time under ``torch.utils.checkpoint``, so the backward
recomputes each chunk's joint instead of keeping it; the emit plane is a
gather, equal to the JAX masked reduction.

``rnnt_greedy_decode`` is the JAX decode in its static form: every frame
runs all ``max_symbols`` rounds of joint, argmax, masked write and
prediction step, with no read of device values on the host (a CUDA graph
could capture it).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# Elements of one chunk's (B, frames, U+1, V) fp32 logits in rnnt_loss_scan.
SCAN_CHUNK_ELEMENTS = 1 << 25


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x[:, :t] at each t along dim 1."""
    return F.pad(torch.cumsum(x[:, :-1], dim=1), (1, 0))


def rnnt_alpha_final(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                     t_lengths: torch.Tensor, u_lengths: torch.Tensor
                     ) -> torch.Tensor:
    """lp_blank (B, T, U+1) log P(blank | t, u); lp_emit (B, T, U) log
    P(y_{u+1} | t, u); t_lengths, u_lengths (B,) -> (B,) log P(y | x) =
    alpha[T_b-1, U_b] + blank[T_b-1, U_b]. A row with no frame reads
    frame 0 (such rows are dummies that the callers mask out). Solved in
    float64, returned in fp32."""
    lp_blank, lp_emit = lp_blank.double(), lp_emit.double()
    col = _exclusive_cumsum(lp_blank[:, :, 0])          # alpha[:, :, 0]
    cols = [col]
    for u in range(1, lp_blank.shape[2]):
        a = col + lp_emit[:, :, u - 1]
        c = _exclusive_cumsum(lp_blank[:, :, u])
        col = c + torch.logcumsumexp(a - c, dim=1)
        cols.append(col)
    final = torch.stack(cols, dim=2) + lp_blank         # (B, T, U+1)
    t_last = (t_lengths.long() - 1).clamp(min=0)
    rows = torch.arange(final.shape[0], device=final.device)
    return final[rows, t_last, u_lengths.long()].float()


def nll_from_planes(lp_blank: torch.Tensor, lp_emit: torch.Tensor,
                    t_lengths: torch.Tensor, u_lengths: torch.Tensor,
                    row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> the mean over rows of -log P(y | x) / max(U, 1); with
    ``row_mask`` only the rows it marks count (dummy rows out)."""
    ll = rnnt_alpha_final(lp_blank, lp_emit, t_lengths, u_lengths)
    per_seq = -ll / u_lengths.float().clamp(min=1.0)
    if row_mask is not None:
        w = row_mask.float()
        return (per_seq * w).sum() / w.sum().clamp(min=1.0)
    return per_seq.mean()


def _emit_index(labels: torch.Tensor, frames: int) -> torch.Tensor:
    b, u = labels.shape
    return labels.long()[:, None, :, None].expand(b, frames, u, 1)


def rnnt_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                          t_lengths: torch.Tensor, u_lengths: torch.Tensor,
                          blank_id: int = 0,
                          row_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean RNN-T loss from the full (B, T, U+1, V) joint lattice; labels
    (B, U)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_emit = lp[:, :, :-1].gather(-1, _emit_index(labels, lp.shape[1]))
    return nll_from_planes(lp[..., blank_id], lp_emit[..., 0], t_lengths,
                           u_lengths, row_mask)


def _planes(e, p, out_weight, out_bias, index, blank_id: int):
    """Frames e (B, F, J) against every label position p (B, U+1, J) ->
    (blank (B, F, U+1), emit (B, F, U)) log-probabilities: tanh in the
    factors' dtype, the vocabulary projection and softmax in fp32."""
    x = torch.tanh(e[:, :, None, :] + p[:, None, :, :])
    logits = F.linear(x.float(), out_weight, out_bias)
    lse = torch.logsumexp(logits, dim=-1)
    emit = logits[:, :, :-1].gather(-1, index)[..., 0] - lse[:, :, :-1]
    return logits[..., blank_id] - lse, emit


def rnnt_loss_scan(e: torch.Tensor, p: torch.Tensor, out_weight: torch.Tensor,
                   out_bias: torch.Tensor, labels: torch.Tensor,
                   t_lengths: torch.Tensor, u_lengths: torch.Tensor,
                   blank_id: int = 0,
                   row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lattice-free RNN-T loss from the additive joint factors e = W_e enc
    (B, T, J) and p = W_p pred (B, U+1, J), with the joint's ``out``
    Linear parameters (out_weight (V, J), out_bias (V,), fp32); labels
    (B, U). The same numbers as rnnt_loss_from_logits on the joint's
    lattice. Frames go a chunk at a time (SCAN_CHUNK_ELEMENTS logits), each
    under checkpoint when a gradient is wanted."""
    b, t, _ = e.shape
    u1, v = p.shape[1], out_weight.shape[0]
    step = max(1, SCAN_CHUNK_ELEMENTS // max(b * u1 * v, 1))
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (e, p, out_weight, out_bias))
    blanks, emits = [], []
    for t0 in range(0, t, step):
        e_c = e[:, t0:t0 + step]
        args = (e_c, p, out_weight, out_bias,
                _emit_index(labels, e_c.shape[1]), blank_id)
        lpb, lpe = (checkpoint(_planes, *args, use_reentrant=False) if grad
                    else _planes(*args))
        blanks.append(lpb)
        emits.append(lpe)
    return nll_from_planes(torch.cat(blanks, 1), torch.cat(emits, 1),
                           t_lengths, u_lengths, row_mask)


def _select(keep: torch.Tensor, new, old):
    """Per row, ``new`` where keep (B, 1) else ``old``, over a (state,
    pred) tree of (B, H) tensors in lists and tuples."""
    if isinstance(new, (list, tuple)):
        return type(new)(_select(keep, n, o) for n, o in zip(new, old))
    return torch.where(keep, new, old)


def rnnt_greedy_decode(joint_fn: Callable, enc: torch.Tensor,
                       enc_lengths: torch.Tensor, pred_step_fn: Callable,
                       pred_init, max_symbols: int = 4,
                       max_len: Optional[int] = None, blank_id: int = 0,
                       start_frames: Optional[torch.Tensor] = None,
                       return_carry: bool = False):
    """Batched frame-synchronous greedy decode.

    joint_fn(enc_t (B, D), pred (B, P)) -> (B, V) logits;
    pred_step_fn(state, tokens (B,) int64) -> (state, pred (B, P));
    pred_init = (state, pred) before the first token, the state a list of
    (B, H) tensors or tuples of them. Each frame emits up to
    ``max_symbols`` non-blank tokens. -> (tokens (B, max_len or
    T * max_symbols) int32, counts (B,) int32), and with ``return_carry``
    also the final (state, pred), so that a stream carries its label
    history exactly across windows; ``start_frames`` (B,) skips each row's
    leading frames (a window's left context). A round is a few dozen ops
    and every frame runs ``max_symbols`` of them, so an exported program
    holds T * max_symbols copies: the loop is written in as few ops as its
    arithmetic allows."""
    b, t, _ = enc.shape
    u = max_len or t * max_symbols
    dev = enc.device
    if start_frames is None:
        start_frames = torch.zeros(b, dtype=torch.int64, device=dev)
    state, pred = pred_init
    buf = torch.zeros(b, u, dtype=torch.int64, device=dev)
    count = torch.zeros(b, dtype=torch.int64, device=dev)
    pos = torch.arange(u, device=dev)[None, :]
    for ti in range(t):
        enc_t = enc[:, ti]
        alive = (start_frames <= ti) & (enc_lengths > ti)
        for _ in range(max_symbols):
            tok = joint_fn(enc_t, pred).argmax(dim=-1)
            emit = alive & (tok != blank_id) & (count < u)
            keep = emit[:, None]
            buf = torch.where((pos == count[:, None]) & keep, tok[:, None],
                              buf)
            count = count + emit
            # a row that emits nothing steps on token 0 and keeps its carry
            new_state, new_pred = pred_step_fn(state, tok * emit)
            state = _select(keep, new_state, state)
            pred = _select(keep, new_pred, pred)
            alive = emit
    buf, count = buf.to(torch.int32), count.to(torch.int32)
    if return_carry:
        return buf, count, (state, pred)
    return buf, count
