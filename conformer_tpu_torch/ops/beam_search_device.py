"""Device CTC prefix beam search with n-gram LM fusion and hotwords, and its
sharded wrapper over a (dp, tp) mesh (counterpart of
conformer_tpu/ops/beam_search_device.py).

The JAX package runs the search as one XLA program, ``lax.scan`` over
frames and ``vmap`` over the batch. Here the batch is a leading B axis of
every tensor and the frames go through ``ops/frame_graph.py::run_frames``:
on the card one CUDA graph a frame step (or ``decode.device_scan_unroll``
steps), on the CPU the same step eagerly.

Per frame and beam (static shapes throughout):
- the top-K non-blank tokens (``topk_lastaxis``, lax.top_k's tie order)
  give W "keep" candidates (blank and repeat mass) and W*K "extend"
  candidates;
- identical prefixes merge: a stable sort by (h1, h2, -total), the two
  32-bit rolling hashes of the prefix, then a window-2 logaddexp at each
  run head (a run holds at most one keep and one extend: the JAX
  package's proof at its merge site);
- the W run heads with the most mass survive, ties to the lower position
  (a stable sort), so the hash order decides which beams survive, not
  only their order;
- each frame writes a (parent, token) backpointer; the prefixes are rebuilt
  after the frame loop by a walk back through them (a second run of the
  frame runner) and one scatter into a buffer one column wider than
  ``max_len``, whose last column takes what the JAX bounded scatter drops.

The 32-bit hashes are int64 in [0, 2^32) (lm/device_table.py); the merge's
sort key (h1, h2) is one int64, (h1 - 2^31) * 2^32 + h2, which orders as
the pair does. The small per-beam integer columns live in one int64
matrix, so that a parent's columns come in one gather; the scores and the
backoff cache bo1 stay float tensors.

Fusion, as in the JAX package: token-level (``tok2lm`` into a token ARPA:
alpha * ln P(c | ctx) at every extension, beta at a delimiter) or
word-level (the host decoder's ARPA: the word completes at a delimiter
after a non-empty partial word and adds alpha * ln10 * log10 P(word | ctx)
+ beta, and hotword phrases ending there add hot_weight * ln10), with
the trailing partial word scored into the final ranking. Delimiter runs
normalise to one token. Streaming: ``return_state`` gives the raw batched
``BeamState`` and ``init_state`` resumes from it; ``start_frames`` skips
each row's leading (left-context) frames.

``ctc_beam_search_device_sharded`` runs the search over a mesh
(parallel/mesh.py), as the JAX wrapper's ``shard_map`` does: each data rank
searches its stripe of the batch, and the n-gram table's buckets split over
the model group (lm/device_table.py::TableShard), every model rank running
the same beams and sharing only the probe sums. A sum over an NCCL group
is captured in the frame graph; over gloo, whose collectives go through the
host, the frame steps run eagerly (``frame_mode``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from conformer_tpu_torch.lm.device_table import (FNV_BASIS, HotArrays,
                                                 NgramTables, TableShard,
                                                 WordArrays, fnv_fold,
                                                 hotword_hit, lookup_word_ids,
                                                 score_tokens)
from conformer_tpu_torch.models.dropout import M32, mul32
from conformer_tpu_torch.ops.frame_graph import run_frames
from conformer_tpu_torch.parallel.mesh import batch_stripe
from conformer_tpu_torch.ops.topk import argsort_desc, topk_lastaxis, \
    topk_stable

NEG = -1e30
_M1 = 1000003
_M2 = 2654435761
_LOG10_TO_LN = math.log(10.0)

# the packed integer columns: (B, W, 13 + m_ctx) int64
_PLEN, _LAST, _LM_LEN, _WN, _RCOUNT, _WF1, _WF2 = range(7)
_RW1, _RW2, _CTX = slice(7, 10), slice(10, 13), 13


class BeamState(NamedTuple):
    """The raw batched beams (streaming carry); int64 and fp32."""

    prefixes: torch.Tensor  # (B, W, U)
    plen: torch.Tensor      # (B, W)
    last: torch.Tensor      # (B, W), -1 when empty
    h1: torch.Tensor        # (B, W) 32-bit rolling hashes of the prefix
    h2: torch.Tensor        # (B, W)
    p_b: torch.Tensor       # (B, W) log mass of blank-ending paths
    p_nb: torch.Tensor      # (B, W) log mass of non-blank-ending paths
    lm_ctx: torch.Tensor    # (B, W, order-1) LM ids, right-aligned
    lm_len: torch.Tensor    # (B, W) valid context length
    # word-level fusion: the partial word's character hashes, its tokens
    wf1: torch.Tensor       # (B, W)
    wf2: torch.Tensor       # (B, W)
    wn: torch.Tensor        # (B, W)
    # hotwords: the last completed words' hash pairs, their count (<= 3)
    rw1: torch.Tensor       # (B, W, 3)
    rw2: torch.Tensor       # (B, W, 3)
    rcount: torch.Tensor    # (B, W)


class WordFusion(NamedTuple):
    """Word-level LM fusion and hotwords (the host decoder's
    decode/beam_search.py::_word_bonus), shared by the CTC and RNN-T
    searches."""

    tables: NgramTables
    word: WordArrays
    hot: Optional[HotArrays]
    alpha: float
    beta: float
    unk_logp: float
    hot_weight: float
    shard: Optional[TableShard] = None


def word_delta(f: WordFusion, ctx, ctx_len, wf1, wf2, rw1, rw2, rcount,
               bo_last=None):
    """Completing each beam's partial word -> (its LM and hotword score,
    the word's LM id (-1 OOV), the word's unigram backoff (the next
    context's bo1)). ``bo_last``: the unigram backoff of ctx[-1] when the
    caller carries it (bo1), else looked up."""
    wid = lookup_word_ids(f.word, wf1, wf2)
    bo_tok = torch.zeros(wid.shape, dtype=torch.float32, device=wid.device)
    dense_pre = None
    uni = f.tables.uni
    if uni is not None:
        v_lm = uni.shape[0]
        row = uni[wid.clamp(0, v_lm - 1)]
        bo_tok = torch.where((wid >= 0) & (wid < v_lm), row[..., 1], 0.0)
        if bo_last is None:
            last = ctx[..., -1]
            bo_last = torch.where((last >= 0) & (last < v_lm),
                                  uni[last.clamp(0, v_lm - 1), 1], 0.0)
        dense_pre = (row[..., 0], bo_last)
    lm10 = score_tokens(f.tables, ctx, ctx_len, wid, f.unk_logp,
                        shard=f.shard, dense_pre=dense_pre)
    delta = f.alpha * _LOG10_TO_LN * lm10 + f.beta
    if f.hot is not None and f.hot_weight:
        # the last k completed words and this one (k = 0..3), folded
        fp1s, fp2s = [], []
        for span in range(1, 5):
            fp1 = torch.full_like(wf1, FNV_BASIS)
            fp2 = torch.full_like(wf2, FNV_BASIS)
            for j in range(3 - (span - 1), 3):
                fp1 = fnv_fold(fp1, rw1[..., j])
                fp2 = fnv_fold(fp2, rw2[..., j])
            fp1s.append(fnv_fold(fp1, wf1))
            fp2s.append(fnv_fold(fp2, wf2))
        hits = hotword_hit(f.hot, torch.stack(fp1s, -1),
                           torch.stack(fp2s, -1))
        spans_ok = rcount[..., None] >= torch.arange(4, device=wf1.device)
        delta = delta + torch.where((hits & spans_ok).any(-1),
                                    f.hot_weight * _LOG10_TO_LN, 0.0)
    return delta, wid, bo_tok


def logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(e^a + e^b), NEG where both are dead (<= NEG / 2)."""
    m = torch.maximum(a, b)
    dead = m <= NEG / 2
    safe = torch.where(dead, 0.0, m)
    out = safe + torch.log(torch.exp(a - safe) + torch.exp(b - safe))
    return torch.where(dead, NEG, out)


def hash_pair_order(h1: torch.Tensor, h2: torch.Tensor,
                    score_key: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts the last axis by (h1, h2, score_key),
    ties by position: ``lax.sort((h1, h2, score_key, iota),
    num_keys=3)``'s order, from two stable passes (least significant key
    first). -0.0 sorts as +0.0."""
    first = torch.sort(score_key + 0.0, dim=-1, stable=True).indices
    pair = (h1 - 2 ** 31) * 2 ** 32 + h2
    second = torch.sort(pair.gather(-1, first), dim=-1, stable=True).indices
    return first.gather(-1, second)


def run_heads(s_h1, s_h2):
    """(boundary, next_same) over a hash-sorted axis: whether each slot
    starts a run of one (h1, h2), and whether the next slot continues
    it."""
    same_prev = (s_h1[..., 1:] == s_h1[..., :-1]) & \
        (s_h2[..., 1:] == s_h2[..., :-1])
    edge = torch.ones(same_prev.shape[:-1] + (1,), dtype=torch.bool,
                      device=same_prev.device)
    return (torch.cat([edge, ~same_prev], -1),
            torch.cat([same_prev, ~edge], -1))


def next_or_neg(x: torch.Tensor, next_same: torch.Tensor) -> torch.Tensor:
    """x shifted left by one along the last axis where the next slot is in
    the same run, NEG elsewhere."""
    shifted = torch.cat([x[..., 1:], torch.full_like(x[..., :1], NEG)], -1)
    return torch.where(next_same, shifted, NEG)


def ctc_beam_search_device(log_probs: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None,
                           beam_width: int = 16, top_k: int = 8,
                           blank_id: int = 0,
                           unk_id: Optional[int] = None,
                           max_len: Optional[int] = None,
                           lm_tables: Optional[NgramTables] = None,
                           tok2lm: Optional[torch.Tensor] = None,
                           lm_alpha: float = 0.0,
                           lm_beta: float = 0.0,
                           delim_id: Optional[int] = None,
                           lm_bos_id: int = -1,
                           lm_unk_logp: float = -99.0,
                           lm_order: int = 0,
                           word_arrays: Optional[WordArrays] = None,
                           hot_arrays: Optional[HotArrays] = None,
                           hot_weight: float = 0.0,
                           init_state: Optional[BeamState] = None,
                           return_state: bool = False,
                           start_frames: Optional[torch.Tensor] = None,
                           scan_unroll: int = 1,
                           lm_shard: Optional[TableShard] = None):
    """(B, T, V) log-softmax -> (prefixes (B, W, U) int32, lengths (B, W)
    int32, scores (B, W) fp32), best beam first (and the raw BeamState
    with ``return_state``).

    ``lengths`` masks trailing frames; ``max_len`` (default T) caps the
    emitted tokens and sizes U; ``unk_id`` is never emitted. Token-level
    fusion: ``lm_tables`` (DeviceNgramTable.device_arrays), ``tok2lm``
    (V,) int64 token -> LM id (-1 OOV), ``lm_order`` the table's order.
    Word-level fusion: ``lm_tables`` of the word ARPA and ``word_arrays``
    (DeviceWordVocab.device_arrays); hotwords with ``hot_arrays``
    (DeviceHotwords.device_arrays) and ``hot_weight`` (log10 units, as
    decode.hotword_weight). Streaming: ``init_state`` / ``return_state``
    / ``start_frames`` (pass a ``max_len`` that covers the stream).
    ``scan_unroll``: frame steps a CUDA graph holds. ``lm_shard``:
    ``lm_tables`` is this rank's part of a table split over a group (the
    JAX ``lm_axis_name`` and ``lm_n_slots_global``)."""
    refuse_exporting_a_shard(lm_shard)
    log_probs = log_probs.float()
    b, t, v = log_probs.shape
    dev = log_probs.device
    u = max_len or t
    k = min(top_k, v - 1)
    w = beam_width
    word_mode = word_arrays is not None and lm_tables is not None
    use_lm = lm_tables is not None and lm_order >= 2 and not word_mode
    m_ctx = max(lm_order - 1, 1)
    fusion = (WordFusion(lm_tables, word_arrays, hot_arrays, lm_alpha,
                         lm_beta, lm_unk_logp, hot_weight, lm_shard)
              if word_mode else None)

    if init_state is None:
        lm_ctx0 = torch.full((b, w, m_ctx), -1, dtype=torch.int64, device=dev)
        lm_len0 = torch.zeros((b, w), dtype=torch.int64, device=dev)
        if (use_lm or word_mode) and lm_bos_id >= 0:
            lm_ctx0[..., -1] = lm_bos_id
            lm_len0 += 1
        zeros = torch.zeros((b, w), dtype=torch.int64, device=dev)
        p_b0 = torch.full((b, w), NEG, device=dev)
        p_b0[:, 0] = 0.0
        init_state = BeamState(
            prefixes=torch.zeros((b, w, u), dtype=torch.int64, device=dev),
            plen=zeros, last=zeros - 1, h1=zeros, h2=zeros, p_b=p_b0,
            p_nb=torch.full((b, w), NEG, device=dev), lm_ctx=lm_ctx0,
            lm_len=lm_len0, wf1=zeros, wf2=zeros, wn=zeros,
            rw1=torch.zeros((b, w, 3), dtype=torch.int64, device=dev),
            rw2=torch.zeros((b, w, 3), dtype=torch.int64, device=dev),
            rcount=zeros)
    init = init_state
    bo1_0 = torch.zeros((b, w), device=dev)
    if word_mode and lm_tables.uni is not None:
        uni = lm_tables.uni
        last0 = init.lm_ctx[..., -1]
        bo1_0 = torch.where((last0 >= 0) & (last0 < uni.shape[0]),
                            uni[last0.clamp(0, uni.shape[0] - 1), 1], 0.0)
    cols = torch.cat([
        torch.stack([init.plen, init.last, init.lm_len, init.wn, init.rcount,
                     init.wf1, init.wf2], -1),
        init.rw1, init.rw2, init.lm_ctx], -1)
    carry0 = (cols, init.h1, init.h2, init.p_b, init.p_nb, bo1_0)
    n = (torch.full((b,), t, dtype=torch.int64, device=dev) if lengths is None
         else lengths.to(dev, torch.int64).clamp(max=t))
    start = (torch.zeros((b,), dtype=torch.int64, device=dev)
             if start_frames is None else start_frames.to(dev, torch.int64))

    def step(carry, frame, t_idx, inputs):
        S, h1, h2, p_b, p_nb, bo1 = carry
        n_, start_ = inputs
        active = ((t_idx >= start_) & (t_idx < n_))[:, None]   # (B, 1)
        last, wn, lm_len = S[..., _LAST], S[..., _WN], S[..., _LM_LEN]
        lm_ctx = S[..., _CTX:]
        total = logaddexp(p_b, p_nb)                           # (B, W)
        masked = frame.masked_fill(barred_tokens(v, blank_id, unk_id, dev),
                                   NEG)
        cand_lp, cand_tok = topk_lastaxis(masked, k)           # (B, K)
        ct = cand_tok[:, None, :]

        # keep candidates (same prefix): blank mass + repeat mass
        is_rep = last[..., None] == ct                         # (B, W, K)
        if delim_id is not None:
            # a delimiter run is one token: re-emitting the delimiter
            # stays on the prefix (the host decoder keys beams by text)
            is_rep = is_rep & (ct != delim_id)
        rep_lp = torch.where(is_rep, cand_lp[:, None, :], NEG).amax(-1)
        keep_pb = total + frame[:, blank_id][:, None]
        keep_pnb = p_nb + rep_lp
        if delim_id is not None:
            keep_pnb = logaddexp(keep_pnb, torch.where(
                last == delim_id, total + frame[:, delim_id][:, None], NEG))

        # extend candidates (append c)
        ext = torch.where(is_rep, p_b[..., None], total[..., None]) \
            + cand_lp[:, None, :]
        if delim_id is not None:
            ext = torch.where((last[..., None] == delim_id)
                              & (ct == delim_id), NEG, ext)
        if use_lm:
            lm10 = score_tokens(
                lm_tables, lm_ctx[:, :, None, :].expand(b, w, k, m_ctx),
                lm_len[..., None].expand(b, w, k),
                tok2lm[cand_tok][:, None, :].expand(b, w, k), lm_unk_logp,
                shard=lm_shard)
            lm_delta = lm_alpha * _LOG10_TO_LN * lm10
            if delim_id is not None and lm_beta:
                lm_delta = lm_delta + torch.where(ct == delim_id, lm_beta,
                                                  0.0)
            ext = ext + lm_delta
        if word_mode:
            # the LM fires when the delimiter completes a non-empty word
            w_delta, wid_done, bo_tok = word_delta(
                fusion, lm_ctx, lm_len, S[..., _WF1], S[..., _WF2],
                S[..., _RW1], S[..., _RW2], S[..., _RCOUNT], bo_last=bo1)
            ext = ext + torch.where((ct == delim_id) & (wn[..., None] > 0),
                                    w_delta[..., None], 0.0)
        full = (S[..., _PLEN][..., None] >= u) | (ext <= NEG / 2)
        ext_pnb = torch.where(full, NEG, ext).reshape(b, w * k)
        tok_u = ct + 1
        ext_h1 = ((mul32(h1, _M1)[..., None] + tok_u) & M32).reshape(b, -1)
        ext_h2 = ((mul32(h2, _M2)[..., None] + tok_u) & M32).reshape(b, -1)
        c_h1 = torch.cat([h1, ext_h1], 1)
        c_h2 = torch.cat([h2, ext_h2], 1)
        c_pb = torch.cat([keep_pb, torch.full_like(ext_pnb, NEG)], 1)
        c_pnb = torch.cat([keep_pnb, ext_pnb], 1)

        # merge identical prefixes, then keep the W heads with most mass
        order = hash_pair_order(c_h1, c_h2, -logaddexp(c_pb, c_pnb))
        s_h1, s_h2 = c_h1.gather(1, order), c_h2.gather(1, order)
        s_pb, s_pnb = c_pb.gather(1, order), c_pnb.gather(1, order)
        boundary, next_same = run_heads(s_h1, s_h2)
        suf_pb = logaddexp(s_pb, next_or_neg(s_pb, next_same))
        suf_pnb = logaddexp(s_pnb, next_or_neg(s_pnb, next_same))
        head = torch.where(boundary, logaddexp(suf_pb, suf_pnb), NEG)
        top, pos = topk_stable(head, w)
        sel = order.gather(1, pos)
        # slots past the unique prefixes are not heads: dead, or their
        # mass would count twice at the next merge
        alive = top > NEG / 2

        # candidate i < W keeps beam i; i >= W extends beam (i - W) // K
        # with token cand_tok[(i - W) % K]
        is_ext = sel >= w
        ext_off = torch.where(is_ext, sel - w, 0)
        parent = torch.where(is_ext, ext_off // k, sel)
        tok = torch.where(is_ext, cand_tok.gather(1, ext_off % k), -1)
        par = S.gather(1, parent[..., None].expand(b, w, S.shape[-1]))
        p_ctx, p_len, p_wn = par[..., _CTX:], par[..., _LM_LEN], par[..., _WN]
        new_wf1, new_wf2, new_wn = par[..., _WF1], par[..., _WF2], p_wn
        new_rw1, new_rw2 = par[..., _RW1], par[..., _RW2]
        new_rcount = par[..., _RCOUNT]
        new_ctx, new_len = p_ctx, p_len
        new_bo1 = bo1.gather(1, parent)
        if use_lm:
            shifted = torch.cat(
                [p_ctx[..., 1:], tok2lm[tok.clamp(min=0)][..., None]], -1)
            new_ctx = torch.where(is_ext[..., None], shifted, p_ctx)
            new_len = torch.where(is_ext, (p_len + 1).clamp(max=m_ctx), p_len)
        elif word_mode:
            is_delim = is_ext & (tok == delim_id)
            grow = is_ext & ~is_delim
            # fold the token's characters into the partial-word hashes
            tc = word_arrays.tok[tok.clamp(min=0)]             # (B, W, 4)
            new_wf1 = torch.where(
                grow, (mul32(new_wf1, tc[..., 0]) + tc[..., 1]) & M32,
                torch.where(is_delim, 0, new_wf1))
            new_wf2 = torch.where(
                grow, (mul32(new_wf2, tc[..., 2]) + tc[..., 3]) & M32,
                torch.where(is_delim, 0, new_wf2))
            new_wn = torch.where(grow, p_wn + 1,
                                 torch.where(is_delim, 0, p_wn))
            # a completed word enters the context; its unigram backoff
            # becomes the next frames' bo1
            completed = is_delim & (p_wn > 0)
            shifted = torch.cat(
                [p_ctx[..., 1:], wid_done.gather(1, parent)[..., None]], -1)
            new_ctx = torch.where(completed[..., None], shifted, p_ctx)
            new_len = torch.where(completed, (p_len + 1).clamp(max=m_ctx),
                                  p_len)
            new_bo1 = torch.where(completed, bo_tok.gather(1, parent),
                                  new_bo1)
            if hot_arrays is not None:
                comp = completed[..., None]
                new_rw1 = torch.where(comp, torch.cat(
                    [new_rw1[..., 1:], par[..., _WF1, None]], -1), new_rw1)
                new_rw2 = torch.where(comp, torch.cat(
                    [new_rw2[..., 1:], par[..., _WF2, None]], -1), new_rw2)
                new_rcount = torch.where(
                    completed, (new_rcount + 1).clamp(max=3), new_rcount)
        p_plen, p_last = par[..., _PLEN], par[..., _LAST]
        new_S = torch.cat([torch.stack([
            torch.where(is_ext, p_plen + 1, p_plen),
            torch.where(is_ext, tok, p_last), new_len, new_wn, new_rcount,
            new_wf1, new_wf2], -1), new_rw1, new_rw2, new_ctx], -1)
        new = (new_S, s_h1.gather(1, pos), s_h2.gather(1, pos),
               torch.where(alive, suf_pb.gather(1, pos), NEG),
               torch.where(alive, suf_pnb.gather(1, pos), NEG), new_bo1)
        new = tuple(torch.where(active if x.dim() == 2 else active[..., None],
                                x, old) for x, old in zip(new, carry))
        # identity backpointers on inactive frames
        beams = torch.arange(w, device=dev)
        bp = torch.stack([torch.where(active, parent, beams),
                          torch.where(active, tok, -1)], -1)
        return new, bp

    key = ("ctc_beam", w, k, u, blank_id, unk_id, delim_id, use_lm, word_mode,
           hot_arrays is not None, lm_alpha, lm_beta, lm_unk_logp, m_ctx,
           hot_weight, shard_key(lm_shard))
    consts = tuple(x for x in (lm_tables, tok2lm, word_arrays, hot_arrays,
                               lm_shard and lm_shard.group) if x is not None)
    if t:
        (S, h1, h2, p_b, p_nb, _), bps = run_frames(
            step, carry0, log_probs.transpose(0, 1), (n, start), key=key,
            consts=consts, unroll=scan_unroll,
            graph=frame_mode(lm_shard) == "graph")
        origin, path_toks = _walk_back(bps, scan_unroll)
    else:
        S, h1, h2, p_b, p_nb, _ = carry0
        origin = torch.arange(w, device=dev).expand(b, w)
        path_toks = torch.zeros((0, b, w), dtype=torch.int64, device=dev)
    prefixes = init.prefixes.gather(1, origin[..., None].expand(b, w, u))
    emitted = path_toks >= 0                                    # (T, B, W)
    dest = init.plen.gather(1, origin)[None] + emitted.cumsum(0) - 1
    index = torch.where(emitted & (dest < u), dest, u).permute(1, 2, 0)
    prefixes = torch.cat([prefixes, torch.zeros_like(prefixes[..., :1])], -1)
    prefixes = prefixes.scatter(2, index, path_toks.clamp(min=0).permute(
        1, 2, 0))[..., :u]
    final = BeamState(
        prefixes=prefixes, plen=S[..., _PLEN], last=S[..., _LAST], h1=h1,
        h2=h2, p_b=p_b, p_nb=p_nb, lm_ctx=S[..., _CTX:],
        lm_len=S[..., _LM_LEN], wf1=S[..., _WF1], wf2=S[..., _WF2],
        wn=S[..., _WN], rw1=S[..., _RW1], rw2=S[..., _RW2],
        rcount=S[..., _RCOUNT])

    score = logaddexp(p_b, p_nb)
    if word_mode:
        # the trailing partial word, as the host decoder's finalize
        w_delta, _, _ = word_delta(fusion, final.lm_ctx, final.lm_len,
                                   final.wf1, final.wf2, final.rw1,
                                   final.rw2, final.rcount)
        score = score + torch.where(final.wn > 0, w_delta, 0.0)
    order = argsort_desc(score)
    out = (prefixes.gather(1, order[..., None].expand(b, w, u)).to(
        torch.int32), final.plen.gather(1, order).to(torch.int32),
        score.gather(1, order))
    return out + (final,) if return_state else out


def shard_key(shard: Optional[TableShard]) -> tuple:
    """What of a TableShard fixes a frame step (the group goes in the
    consts)."""
    return () if shard is None else (shard.index, shard.n_slots)


def barred_tokens(v: int, blank_id: int, unk_id: Optional[int],
                  device) -> torch.Tensor:
    """(V,) bool: the tokens a search never extends with (the blank and
    the unk), for a ``masked_fill`` in the frame step (an indexed write of
    a scalar there would be a tensor constant inside the step, which an
    exported ``while_loop`` cannot hold)."""
    ids = torch.arange(v, device=device)
    barred = ids == blank_id
    return barred if unk_id is None else barred | (ids == unk_id)


def refuse_exporting_a_shard(shard: Optional[TableShard]) -> None:
    """A sharded search is not exported: a program runs on one device, as
    the JAX export has no mesh."""
    if shard is not None and torch.compiler.is_exporting():
        raise ValueError("a sharded search cannot be exported: export the "
                         "search without a mesh")


def frame_mode(shard: Optional[TableShard]) -> str:
    """How a search's frame steps run on the card: "graph" (one CUDA graph
    a window, the probe sums captured when the group is NCCL's) or "eager"
    (the sums go over a gloo group, through the host, which no graph can
    hold). Decided by the group's backend, never by a failed capture."""
    if shard is None or shard.group is None:
        return "graph"
    from conformer_tpu_torch.parallel.collectives import capturable

    return "graph" if capturable(shard.group) else "eager"


_PARTS: dict = {}


def split_over_mesh(mesh, b: int, lm_tables: Optional[NgramTables],
                    striped: bool):
    """The JAX wrapper's choice of axes for a batch of ``b`` rows -> (split
    the rows over the data group, this rank's tables, its TableShard or
    None). The data group applies at dp > 1 when b divides by dp (and the
    rows are not a stripe already); the model group at tp > 1 when the
    table's buckets divide by tp, or when it is already this rank's part
    (``device_arrays(part=...)``). A whole table is split here, its parts
    kept for the next call, so that a captured graph finds the same
    tensors."""
    data = (mesh is not None and not striped and mesh.dp > 1
            and b % mesh.dp == 0)
    if mesh is None or mesh.tp <= 1 or lm_tables is None:
        if lm_tables is not None and lm_tables.part is not None:
            raise ValueError(f"a table part {lm_tables.part} without a "
                             "model group to sum over")
        return data, lm_tables, None
    index = mesh.model_index
    if lm_tables.part is None:
        if lm_tables.keys.shape[1] % mesh.tp:
            return data, lm_tables, None        # stays whole on each rank
        key = (id(lm_tables.keys), index, mesh.tp)
        if key not in _PARTS:
            while len(_PARTS) >= 4:
                _PARTS.pop(next(iter(_PARTS)))
            _PARTS[key] = (lm_tables.keys,
                           lm_tables.take_part(index, mesh.tp))
        lm_tables = _PARTS[key][1]
    elif lm_tables.part != (index, mesh.tp):
        raise ValueError(f"table part {lm_tables.part} on model rank "
                         f"{index} of {mesh.tp}")
    return data, lm_tables, TableShard(index, lm_tables.n_slots,
                                       mesh.model_group)


def ctc_beam_search_device_sharded(log_probs: torch.Tensor,
                                   lengths: Optional[torch.Tensor] = None,
                                   mesh=None, striped: bool = False, **kw):
    """The device search over a (dp, tp) mesh (counterpart of the JAX
    ``ctc_beam_search_device_sharded``): each data rank searches its
    stripe of the batch, the n-gram table's buckets split over the model
    group with the probe results summed over it, every model rank running
    the same beams. -> the outputs of the rows this rank searched: its
    stripe, or the whole batch where the data group does not apply
    (``b % dp``); the caller gathers them over the data group. Without a
    mesh, or when no axis applies (no table, tp 1, dp 1 or an uneven
    batch), it is the unsharded search. ``striped``: the rows are this
    rank's stripe already (an eval step under the mesh gives them), so only
    the model group applies. ``kw``: ctc_beam_search_device's, without the
    streaming carry."""
    if kw.get("init_state") is not None or kw.get("return_state"):
        raise ValueError("init_state/return_state are unsupported in the "
                         "sharded CTC search")
    b = log_probs.shape[0]
    data, tables, shard = split_over_mesh(mesh, b, kw.pop("lm_tables", None),
                                          striped)
    start = kw.pop("start_frames", None)
    if data:
        log_probs, lengths, start = batch_stripe([log_probs, lengths, start],
                                                 mesh)
    return ctc_beam_search_device(log_probs, lengths, lm_tables=tables,
                                  start_frames=start, lm_shard=shard, **kw)


def _walk_back(bps: torch.Tensor, unroll: int):
    """Backpointers (T, B, W, 2) (parent, token or -1) -> (each final
    beam's origin slot (B, W), its token at each frame (T, B, W)), walking
    from the last frame to the first through the frame runner."""
    steps, b, w, _ = bps.shape

    def back(carry, bp_t, t_idx, inputs):
        (cur,) = carry
        tok = bp_t[..., 1].gather(1, cur)
        return (torch.where(t_idx < inputs[0], bp_t[..., 0].gather(1, cur),
                            cur),), tok

    start = torch.arange(w, device=bps.device).expand(b, w).contiguous()
    (origin,), toks = run_frames(
        back, (start,), bps.flip(0),
        (torch.full((), steps, dtype=torch.int64, device=bps.device),),
        key=("ctc_walk",), unroll=unroll)
    return origin, toks.flip(0)
