"""RNN-T loss, greedy decode and beam search (counterpart of
conformer_tpu/ops/rnnt.py).

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
prediction step, with no read of device values on the host, as one frame
step of ops/frame_graph.py (a CUDA graph a frame on the card).

``rnnt_beam_search`` is the JAX beam search with the batch as a leading
axis: the B x W hypotheses step through the joint and the prediction
network as one batch of B * W rows, the merges and top-k selections are
those of the CTC device search (ops/beam_search_device.py), and the frames
go through ops/frame_graph.py (one CUDA graph a frame step on the card).
``rnnt_beam_search_sharded`` runs it over a mesh as the CTC search's
sharded wrapper does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

from conformer_tpu_torch.lm.device_table import score_tokens
from conformer_tpu_torch.models.dropout import M32, mul32
from conformer_tpu_torch.ops.beam_search_device import (
    _LOG10_TO_LN, NEG, WordFusion, barred_tokens, frame_mode,
    hash_pair_order, logaddexp, next_or_neg, refuse_exporting_a_shard,
    run_heads, shard_key, split_over_mesh, word_delta)
from conformer_tpu_torch.ops.frame_graph import run_frames
from conformer_tpu_torch.parallel.mesh import batch_stripe
from conformer_tpu_torch.ops.topk import (argsort_desc, topk_lastaxis,
                                          topk_stable)

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
                    row_mask: Optional[torch.Tensor] = None,
                    count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """-> the mean over rows of -log P(y | x) / max(U, 1); with
    ``row_mask`` only the rows it marks count (dummy rows out); with
    ``count`` (a mesh's global count of such rows) the rows' sum over it."""
    ll = rnnt_alpha_final(lp_blank, lp_emit, t_lengths, u_lengths)
    per_seq = -ll / u_lengths.float().clamp(min=1.0)
    if row_mask is not None:
        w = row_mask.float()
        n = w.sum() if count is None else count
        return (per_seq * w).sum() / n.clamp(min=1.0)
    return per_seq.mean()


def _emit_index(labels: torch.Tensor, frames: int) -> torch.Tensor:
    b, u = labels.shape
    return labels.long()[:, None, :, None].expand(b, frames, u, 1)


def rnnt_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                          t_lengths: torch.Tensor, u_lengths: torch.Tensor,
                          blank_id: int = 0,
                          row_mask: Optional[torch.Tensor] = None,
                          count: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Mean RNN-T loss from the full (B, T, U+1, V) joint lattice; labels
    (B, U); row_mask and count as nll_from_planes's."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    lp_emit = lp[:, :, :-1].gather(-1, _emit_index(labels, lp.shape[1]))
    return nll_from_planes(lp[..., blank_id], lp_emit[..., 0], t_lengths,
                           u_lengths, row_mask, count)


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
                   row_mask: Optional[torch.Tensor] = None,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lattice-free RNN-T loss from the additive joint factors e = W_e enc
    (B, T, J) and p = W_p pred (B, U+1, J), with the joint's ``out``
    Linear parameters (out_weight (V, J), out_bias (V,), fp32); labels
    (B, U); row_mask and count as nll_from_planes's. The same numbers as rnnt_loss_from_logits on the joint's
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
                           t_lengths, u_lengths, row_mask, count)


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
    leading frames (a window's left context). One frame's ``max_symbols``
    rounds are one step of ``ops/frame_graph.py::run_frames``, the
    buffer, the count and the flattened (state, pred) its carry: eager on
    the CPU, a CUDA graph a frame on the card (cached while ``joint_fn``
    and ``pred_step_fn`` are the same objects: ``Transducer.frame_fns``),
    one ``while_loop`` under export."""
    b, t, _ = enc.shape
    u = max_len or t * max_symbols
    dev = enc.device
    start = (torch.zeros(b, dtype=torch.int64, device=dev)
             if start_frames is None else start_frames.to(dev, torch.int64))
    n = enc_lengths.to(dev, torch.int64)
    leaves, spec = tree_flatten(tuple(pred_init))
    carry0 = (torch.zeros(b, u, dtype=torch.int64, device=dev),
              torch.zeros(b, dtype=torch.int64, device=dev), *leaves)

    def step(carry, enc_t, t_idx, inputs):
        buf, count = carry[:2]
        state, pred = tree_unflatten(list(carry[2:]), spec)
        start_, n_ = inputs
        alive = (start_ <= t_idx) & (n_ > t_idx)
        pos = torch.arange(u, device=dev)[None, :]
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
        return (buf, count, *tree_flatten((state, pred))[0]), count

    final = carry0
    if t:
        final, _ = run_frames(
            step, carry0, enc.transpose(0, 1), (start, n),
            key=("rnnt_greedy", max_symbols, u, blank_id, spec),
            consts=(joint_fn, pred_step_fn))
    buf, count = final[0].to(torch.int32), final[1].to(torch.int32)
    if return_carry:
        return buf, count, tree_unflatten(list(final[2:]), spec)
    return buf, count


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

class RnntBeams(NamedTuple):
    """The raw batched beams of rnnt_beam_search (the streaming carry), in
    the order of the JAX package's beam tuple; int64, fp32 scores, the
    prediction network's state and output (B, W, H) and (B, W, P)."""

    score: torch.Tensor
    buf: torch.Tensor       # (B, W, U) emitted tokens
    cnt: torch.Tensor       # (B, W) how many
    h1: torch.Tensor        # (B, W) 32-bit rolling hashes of the tokens
    h2: torch.Tensor
    ctx: torch.Tensor       # (B, W, order-1) LM context, right-aligned
    cl: torch.Tensor        # (B, W) its valid length
    wf1: torch.Tensor       # word fusion: the partial word's hashes
    wf2: torch.Tensor
    wn: torch.Tensor        # and its tokens
    rw1: torch.Tensor       # (B, W, 3) hotwords: the last completed words
    rw2: torch.Tensor
    rc: torch.Tensor        # (B, W) their count (<= 3)
    state: list
    pred: torch.Tensor


# the packed integer columns: (B, W, 14 + m_ctx) int64
_CNT, _CL, _WN, _RC, _H1, _H2, _WF1, _WF2 = range(8)
_RW1, _RW2, _CTX = slice(8, 11), slice(11, 14), 14
_M1 = 1000003
_M2 = 2654435761


def _merge_topk(score: torch.Tensor, h1: torch.Tensor, h2: torch.Tensor,
                k_out: int):
    """Merge hypotheses with the same (h1, h2) by logaddexp, then keep the
    k_out best -> (their positions, their merged scores, NEG if dead):
    one sort by (h1, h2, -score) and a window-2 logaddexp at each run
    head, as the CTC search merges (a run holds at most one hypothesis of
    each of the two merged pools, each a previous merge's output)."""
    order = hash_pair_order(h1, h2, -score)
    s_h1, s_h2 = h1.gather(-1, order), h2.gather(-1, order)
    s_score = score.gather(-1, order)
    boundary, next_same = run_heads(s_h1, s_h2)
    merged = logaddexp(s_score, next_or_neg(s_score, next_same))
    top, pos = topk_stable(torch.where(boundary, merged, NEG), k_out)
    return order.gather(-1, pos), torch.where(top > NEG / 2, top, NEG)


def _select_topk(score: torch.Tensor, k_out: int):
    """The k_out best of a pool that cannot hold duplicates (one round's
    emissions: ext(i, c) == ext(j, c') forces i == j and c == c') ->
    (positions, scores, NEG if dead)."""
    top, sel = topk_stable(score, k_out)
    return sel, torch.where(top > NEG / 2, top, NEG)


def _flat_state(state) -> list:
    return [x for carry in state for x in carry]


def _nest_state(flat) -> list:
    return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]


def rnnt_beam_search(joint_fn: Callable, enc: torch.Tensor,
                     enc_lengths: torch.Tensor, pred_step_fn: Callable,
                     pred_init, beam_width: int = 8, top_k: int = 4,
                     max_symbols: int = 4, max_len: Optional[int] = None,
                     blank_id: int = 0, unk_id: Optional[int] = None,
                     length_norm: bool = False, lm_tables=None,
                     tok2lm: Optional[torch.Tensor] = None,
                     lm_alpha: float = 0.0, lm_beta: float = 0.0,
                     delim_id: Optional[int] = None, lm_bos_id: int = -1,
                     lm_unk_logp: float = -99.0, lm_order: int = 0,
                     word_arrays=None, hot_arrays=None,
                     hot_weight: float = 0.0,
                     start_frames: Optional[torch.Tensor] = None,
                     init_beams: Optional[RnntBeams] = None,
                     return_beams: bool = False, scan_unroll: int = 1,
                     lm_shard=None):
    """Batched time-synchronous RNN-T beam search (counterpart of the JAX
    ``rnnt_beam_search``).

    Per frame, ``max_symbols`` + 1 rounds: each round the top-``top_k``
    non-blank extensions of every active hypothesis compete for the
    ``beam_width`` active slots, and blank extensions retire into the
    frame's finished pool, where hypotheses with the same tokens (the same
    64-bit double hash) merge by logaddexp. joint_fn(enc_t (N, D), pred
    (N, P)) -> (N, V) logits and pred_step_fn / pred_init are
    rnnt_greedy_decode's (``Transducer.frame_fns``, ``predict_init(B)``);
    the B x W hypotheses step as one batch of B * W rows. The frames go
    through ``ops/frame_graph.py::run_frames`` (a CUDA graph a frame step
    on the card).

    Fusion as the CTC search's: token-level (``tok2lm``, ``lm_order``) or
    word-level with hotwords (``word_arrays``, ``hot_arrays``); in word
    mode a delimiter after an empty partial word is not emitted, and the
    trailing partial word is scored into the returned ranking (the raw
    beams stay unscored). ``length_norm`` ranks by score over length.
    -> (tokens (B, W, U) int32, counts (B, W) int32, scores (B, W)), best
    first (and the raw ``RnntBeams`` with ``return_beams``);
    ``start_frames`` skips each row's leading frames and ``init_beams``
    resumes a stream. ``lm_shard``: ``lm_tables`` is this rank's part of a
    table split over a group (lm/device_table.py::TableShard)."""
    refuse_exporting_a_shard(lm_shard)
    b, t, d = enc.shape
    dev = enc.device
    w, kk = beam_width, top_k
    u = max_len or t * max_symbols
    word_mode = word_arrays is not None and lm_tables is not None
    use_lm = lm_tables is not None and lm_order >= 2 and not word_mode
    m_ctx = max(lm_order - 1, 1)
    fusion = (WordFusion(lm_tables, word_arrays, hot_arrays, lm_alpha,
                         lm_beta, lm_unk_logp, hot_weight, lm_shard)
              if word_mode else None)

    if init_beams is None:
        state0, pred0 = pred_init

        def rep(x):
            return x[:, None].expand(b, w, *x.shape[1:])

        lm_ctx0 = torch.full((b, w, m_ctx), -1, dtype=torch.int64, device=dev)
        lm_len0 = torch.zeros((b, w), dtype=torch.int64, device=dev)
        if (use_lm or word_mode) and lm_bos_id >= 0:
            lm_ctx0[..., -1] = lm_bos_id
            lm_len0 += 1
        zeros = torch.zeros((b, w), dtype=torch.int64, device=dev)
        score0 = torch.full((b, w), NEG, device=dev)
        score0[:, 0] = 0.0
        rw0 = torch.zeros((b, w, 3), dtype=torch.int64, device=dev)
        init_beams = RnntBeams(
            score0, torch.zeros((b, w, u), dtype=torch.int64, device=dev),
            zeros, zeros, zeros, lm_ctx0, lm_len0, zeros, zeros, zeros, rw0,
            rw0, zeros, [(rep(c), rep(h)) for c, h in state0], rep(pred0))
    i = init_beams
    cols0 = torch.cat([torch.stack([i.cnt, i.cl, i.wn, i.rc, i.h1, i.h2,
                                    i.wf1, i.wf2], -1), i.rw1, i.rw2, i.ctx],
                      -1)
    flat = lambda x: x.reshape(b * w, *x.shape[2:])
    carry0 = (i.score, i.buf, cols0, flat(i.pred),
              *[flat(x) for x in _flat_state(i.state)])
    n = enc_lengths.to(dev, torch.int64).clamp(max=t)
    start = (torch.zeros((b,), dtype=torch.int64, device=dev)
             if start_frames is None else start_frames.to(dev, torch.int64))

    def step(carry, enc_t, t_idx, inputs):
        n_, start_ = inputs
        active = (t_idx >= start_) & (t_idx < n_)              # (B,)
        rows = torch.arange(b, device=dev)[:, None] * w
        enc_rep = enc_t[:, None].expand(b, w, d).reshape(b * w, d)
        act = carry
        fin = (torch.full_like(carry[0], NEG),) + carry[1:]

        def beam_gather(pools, sel):
            """The carry tensors after the score (buf, sm, then the flat
            (B * W, ...) pred and state) of two pools, joined along the
            beam axis, at sel (B, W)."""
            out = []
            for j, parts in enumerate(zip(*(p[1:] for p in pools))):
                flat_ = j >= 2
                if flat_:
                    parts = [x.reshape(b, w, -1) for x in parts]
                x = torch.cat(parts, 1)
                x = x.gather(1, sel.reshape(b, w, *(1,) * (x.dim() - 2))
                             .expand(b, w, *x.shape[2:]))
                out.append(x.reshape(b * w, -1) if flat_ else x)
            return tuple(out)

        for s in range(max_symbols + 1):
            a_sc, a_buf, a_sm, a_pr = act[:4]
            logp = torch.log_softmax(
                joint_fn(enc_rep, a_pr).float(), -1).reshape(b, w, -1)
            # blank extensions retire into the finished pool
            retired = (a_sc + logp[..., blank_id],) + act[1:]
            pools = (fin, retired)
            sel, msc = _merge_topk(
                torch.cat([fin[0], retired[0]], 1),
                torch.cat([fin[2][..., _H1], a_sm[..., _H1]], 1),
                torch.cat([fin[2][..., _H2], a_sm[..., _H2]], 1), w)
            fin = (msc,) + beam_gather(pools, sel)
            if s == max_symbols:
                break

            # non-blank extensions stay active within the frame
            masked = logp.masked_fill(
                barred_tokens(logp.shape[-1], blank_id, unk_id, dev), NEG)
            cand_lp, cand_tok = topk_lastaxis(masked, kk)      # (B, W, KK)
            e_sc = a_sc[..., None] + cand_lp
            a_ctx, a_cl = a_sm[..., _CTX:], a_sm[..., _CL]
            a_wn = a_sm[..., _WN]
            if use_lm:
                lm10 = score_tokens(
                    lm_tables, a_ctx[:, :, None, :].expand(b, w, kk, m_ctx),
                    a_cl[..., None].expand(b, w, kk), tok2lm[cand_tok],
                    lm_unk_logp, shard=lm_shard)
                delta = lm_alpha * _LOG10_TO_LN * lm10
                if delim_id is not None and lm_beta:
                    delta = delta + torch.where(cand_tok == delim_id, lm_beta,
                                                0.0)
                e_sc = e_sc + delta
            if word_mode:
                w_delta, wid_done, _ = word_delta(
                    fusion, a_ctx, a_cl, a_sm[..., _WF1], a_sm[..., _WF2],
                    a_sm[..., _RW1], a_sm[..., _RW2], a_sm[..., _RC])
                is_d = cand_tok == delim_id
                e_sc = e_sc + torch.where(is_d & (a_wn[..., None] > 0),
                                          w_delta[..., None], 0.0)
                # no delimiter after an empty partial word
                e_sc = torch.where(is_d & (a_wn[..., None] == 0), NEG, e_sc)
            e_sc = torch.where(a_sm[..., _CNT][..., None] >= u, NEG, e_sc)
            tok_u = cand_tok + 1
            e_h1 = ((mul32(a_sm[..., _H1], _M1)[..., None] + tok_u)
                    & M32).reshape(b, -1)
            e_h2 = ((mul32(a_sm[..., _H2], _M2)[..., None] + tok_u)
                    & M32).reshape(b, -1)
            sel, msc = _select_topk(e_sc.reshape(b, -1), w)
            p = sel // kk                      # candidate = parent * KK + c
            tk = cand_tok.reshape(b, -1).gather(1, sel)
            pa = a_sm.gather(1, p[..., None].expand(b, w, a_sm.shape[-1]))
            cnt = pa[..., _CNT]
            new_buf = torch.where(
                torch.arange(u, device=dev) == cnt[..., None], tk[..., None],
                a_buf.gather(1, p[..., None].expand(b, w, u)))
            flat_p = (p + rows).reshape(-1)
            st = [x.index_select(0, flat_p) for x in act[4:]]
            new_st, new_pr = pred_step_fn(_nest_state(st), tk.reshape(-1))
            n_wf1, n_wf2, n_wn = pa[..., _WF1], pa[..., _WF2], pa[..., _WN]
            n_rw1, n_rw2, n_rc = pa[..., _RW1], pa[..., _RW2], pa[..., _RC]
            new_ctx, new_cl = pa[..., _CTX:], pa[..., _CL]
            if use_lm:
                new_ctx = torch.cat([new_ctx[..., 1:], tok2lm[tk][..., None]],
                                    -1)
                new_cl = (new_cl + 1).clamp(max=m_ctx)
            elif word_mode:
                # a selected delimiter always completes a word
                is_d = tk == delim_id
                tc = word_arrays.tok[tk]
                grown1 = (mul32(n_wf1, tc[..., 0]) + tc[..., 1]) & M32
                grown2 = (mul32(n_wf2, tc[..., 2]) + tc[..., 3]) & M32
                d3 = is_d[..., None]
                n_rw1 = torch.where(d3, torch.cat(
                    [n_rw1[..., 1:], n_wf1[..., None]], -1), n_rw1)
                n_rw2 = torch.where(d3, torch.cat(
                    [n_rw2[..., 1:], n_wf2[..., None]], -1), n_rw2)
                n_rc = torch.where(is_d, (n_rc + 1).clamp(max=3), n_rc)
                n_wf1 = torch.where(is_d, 0, grown1)
                n_wf2 = torch.where(is_d, 0, grown2)
                n_wn = torch.where(is_d, 0, n_wn + 1)
                new_ctx = torch.where(d3, torch.cat(
                    [new_ctx[..., 1:], wid_done.gather(1, p)[..., None]],
                    -1), new_ctx)
                new_cl = torch.where(is_d, (new_cl + 1).clamp(max=m_ctx),
                                     new_cl)
            new_sm = torch.cat([torch.stack(
                [cnt + 1, new_cl, n_wn, n_rc, e_h1.gather(1, sel),
                 e_h2.gather(1, sel), n_wf1, n_wf2], -1), n_rw1, n_rw2,
                new_ctx], -1)
            act = (msc, new_buf, new_sm, new_pr, *_flat_state(new_st))

        keep = active[:, None]
        keep_flat = keep.expand(b, w).reshape(b * w, 1)
        out = []
        for j, (new, old) in enumerate(zip(fin, carry)):
            m = (keep_flat if j >= 3 else
                 keep.reshape(b, 1, *(1,) * (new.dim() - 2)))
            out.append(torch.where(m, new, old))
        return tuple(out), active

    key = ("rnnt_beam", w, kk, max_symbols, u, blank_id, unk_id, delim_id,
           use_lm, word_mode, hot_arrays is not None, lm_alpha, lm_beta,
           lm_unk_logp, m_ctx, hot_weight, shard_key(lm_shard))
    consts = tuple(x for x in (joint_fn, pred_step_fn, lm_tables, tok2lm,
                               word_arrays, hot_arrays,
                               lm_shard and lm_shard.group) if x is not None)
    final = carry0
    if t:
        final, _ = run_frames(step, carry0, enc.transpose(0, 1), (n, start),
                              key=key, consts=consts, unroll=scan_unroll,
                              graph=frame_mode(lm_shard) == "graph")
    score, buf, sm, pr = final[:4]
    unflat = lambda x: x.reshape(b, w, *x.shape[1:])
    beams = RnntBeams(
        score, buf, sm[..., _CNT], sm[..., _H1], sm[..., _H2], sm[..., _CTX:],
        sm[..., _CL], sm[..., _WF1], sm[..., _WF2], sm[..., _WN],
        sm[..., _RW1], sm[..., _RW2], sm[..., _RC],
        _nest_state([unflat(x) for x in final[4:]]), unflat(pr))
    if word_mode:
        # the trailing partial word, into the ranking only
        w_delta, _, _ = word_delta(fusion, beams.ctx, beams.cl, beams.wf1,
                                   beams.wf2, beams.rw1, beams.rw2, beams.rc)
        score = score + torch.where(beams.wn > 0, w_delta, 0.0)
    rank = (score / beams.cnt.float().clamp(min=1.0) if length_norm
            else score)
    order = argsort_desc(rank)
    out = (buf.gather(1, order[..., None].expand(b, w, u)).to(torch.int32),
           beams.cnt.gather(1, order).to(torch.int32), score.gather(1, order))
    return out + (beams,) if return_beams else out


def rnnt_beam_search_sharded(joint_fn: Callable, enc: torch.Tensor,
                             enc_lengths: Optional[torch.Tensor],
                             pred_step_fn: Callable, pred_init, mesh=None,
                             striped: bool = False, **kw):
    """The RNN-T beam search over a (dp, tp) mesh (counterpart of the JAX
    ``rnnt_beam_search_sharded``), as ctc_beam_search_device_sharded: the
    batch (enc, its lengths, the prediction network's initial state,
    ``start_frames``) split over the data group, the n-gram table's buckets
    over the model group with the probe sums; joint_fn and pred_step_fn
    are replicated over the model group. -> the outputs of the rows this
    rank searched. ``init_beams``/``return_beams`` (the streaming carry)
    are refused, as in the JAX wrapper."""
    if kw.get("init_beams") is not None or kw.get("return_beams"):
        raise ValueError("init_beams/return_beams are unsupported in the "
                         "sharded RNN-T search")
    b = enc.shape[0]
    if enc_lengths is None:   # before the fallback, so both paths take it
        enc_lengths = torch.full((b,), enc.shape[1], dtype=torch.int64,
                                 device=enc.device)
    data, tables, shard = split_over_mesh(mesh, b, kw.pop("lm_tables", None),
                                          striped)
    start = kw.pop("start_frames", None)
    if data:
        state0, pred0 = pred_init
        enc, enc_lengths, start, pred0 = batch_stripe(
            [enc, enc_lengths, start, pred0], mesh)
        pred_init = ([batch_stripe([c, h], mesh) for c, h in state0], pred0)
    return rnnt_beam_search(joint_fn, enc, enc_lengths, pred_step_fn,
                            pred_init, lm_tables=tables, start_frames=start,
                            lm_shard=shard, **kw)
