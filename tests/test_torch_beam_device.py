"""The port's device CTC prefix beam search against the JAX package on the
CPU (conformer_tpu_torch/ops/beam_search_device.py, ops/frame_graph.py's
eager loop).

The same seeded log-probs (B 2-3, T <= 24, V 32: a blank, a delimiter, an
<unk> and letters) go through the JAX ``ctc_beam_search_device`` and the
port's, W 8, K 4, in every mode: no LM (with ``lengths``, ``unk_id`` and
``max_len``), token-level fusion, word-level fusion with hotwords, and a
two-chunk ``return_state`` / ``init_state`` / ``start_frames`` carry held
against the JAX carry. Tolerance: prefixes and lengths equal, scores
within 1e-4 absolute for every live beam, rankings equal wherever
consecutive JAX scores differ by more than 1e-4 (within a closer group the
same prefixes, in any order). The pipeline's ``decode="beam_device"`` is
held against the JAX pipeline in tests/test_torch_beam.py.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.lm import device_table as jdt
from conformer_tpu.lm.ngram import build_arpa
from conformer_tpu.ops import beam_search_device as jbs
from conformer_tpu_torch.lm import device_table as dt
from conformer_tpu_torch.ops import beam_search_device as bs
from conformer_tpu_torch.ops import frame_graph
from torch_threads import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
TOL = 1e-4
NEG = -1e30
LETTERS = list("ABCDEGHIKLMNOPRSTUVXY") + ["CH", "NG", "TR", "NH", "GI",
                                           "TH", "PH", "QU"]
TOKENS = ["<PAD>", "|", "<UNK>"] + LETTERS          # V 32
BLANK, DELIM, UNK = 0, 1, 2
WORDS = ["XIN", "CHAO", "BAN", "CAM", "ON", "TAM", "BIET", "LOI", "VIET",
         "NAM", "TRAO", "NGHE"]
W, K = 8, 4


def _spell(word):
    """Greedy longest-match tokenisation into TOKENS ids."""
    ids, i = [], 0
    while i < len(word):
        for size in (2, 1):
            piece = word[i: i + size]
            if piece in TOKENS:
                ids.append(TOKENS.index(piece))
                i += size
                break
    return ids


def log_probs(b, t, seed, sentence=("ON", "NAM", "BAN", "XIN"),
              noise=-6.0):
    """(b, t, 32) fp32 log-softmax rows around a spelled sentence (a
    different cut of it per row), noisy enough that beams compete."""
    rng = np.random.default_rng(seed)
    lp = rng.normal(noise, 1.5, size=(b, t, len(TOKENS))).astype(np.float32)
    path = []
    for w in sentence:
        path += _spell(w) + [DELIM]
    for row in range(b):
        f = 0
        for tok in path[row % 2:]:
            for _ in range(int(rng.integers(1, 3))):
                if f < t:
                    lp[row, f, tok] += rng.uniform(3.0, 7.0)
                    f += 1
            if f < t and rng.uniform() < 0.5:
                lp[row, f, BLANK] += 4.0
                f += 1
    lp[..., BLANK] += np.where(rng.uniform(size=(b, t)) < 0.2, 3.0, 0.0)
    return (lp - np.log(np.exp(lp).sum(-1, keepdims=True))).astype(np.float32)


@pytest.fixture(scope="module")
def lms(tmp_path_factory):
    """(word ARPA, token ARPA) over seeded sentences of WORDS."""
    root = tmp_path_factory.mktemp("beamlm")
    rng = np.random.default_rng(0)
    sentences = [list(rng.choice(WORDS, rng.integers(2, 5)))
                 for _ in range(200)] + [["XIN", "CHAO", "BAN"]] * 5
    paths = []
    for name, line in (("words", " ".join),
                       ("tokens", lambda s: " ".join(
                           " ".join(TOKENS[i] for i in _spell(w))
                           for w in s))):
        corpus = root / f"{name}.txt"
        corpus.write_text("\n".join(line(s) for s in sentences),
                          encoding="utf8")
        path = str(root / f"{name}.arpa")
        build_arpa(str(corpus), path, order=3)
        paths.append(path)
    return tuple(paths)


def _kwargs(mode, lms, torch_side, alpha=2.1, beta=1.5):
    """The search's fusion kwargs for ``mode`` (none, token, word, hot), as
    the JAX package's ``_device_lm_kwargs`` makes them."""
    if mode == "none":
        return {}
    word_arpa, token_arpa = lms
    pkg = dt if torch_side else jdt
    arrays = ((lambda x: x.device_arrays(CPU)) if torch_side
              else (lambda x: x.device_arrays()))
    table = pkg.DeviceNgramTable.from_arpa(
        token_arpa if mode == "token" else word_arpa)
    kw = dict(lm_tables=arrays(table), lm_alpha=alpha, lm_beta=beta,
              delim_id=DELIM, lm_bos_id=int(table.bos_id),
              lm_unk_logp=float(table.unk_logp), lm_order=int(table.order))
    if mode == "token":
        tok2lm = np.array([table.vocab.get(s, -1) for s in TOKENS])
        kw["tok2lm"] = (torch.from_numpy(tok2lm) if torch_side
                        else jnp.asarray(tok2lm, jnp.int32))
        return kw
    kw["word_arrays"] = arrays(pkg.DeviceWordVocab.build(TOKENS, table.vocab))
    if mode == "hot":
        kw.update(hot_arrays=arrays(pkg.DeviceHotwords.build(
            ["CHAO BAN", "NAM"])), hot_weight=9.0)
    return kw


def assert_beams_match(got, want, tol=TOL):
    """Live beams (JAX score > NEG / 2): the same count; scores within tol
    rank by rank; where consecutive JAX scores differ by more than tol the
    prefix and length at each rank are equal, and within a closer group
    the same prefixes in any order."""
    prefixes, plens, scores = (x.numpy() for x in got[:3])
    w_pre, w_len, w_sc = (np.asarray(x) for x in want[:3])
    for row in range(w_sc.shape[0]):
        live = w_sc[row] > NEG / 2
        assert ((scores[row] > NEG / 2) == live).all()
        np.testing.assert_allclose(scores[row][live], w_sc[row][live],
                                   atol=tol, rtol=0)
        n = int(live.sum())
        groups, begin = [], 0
        for i in range(1, n + 1):
            if i == n or w_sc[row, i - 1] - w_sc[row, i] > tol:
                groups.append(range(begin, i))
                begin = i
        for g in groups:
            seqs = lambda p, ln: sorted(tuple(p[row, i, : ln[row, i]])
                                        for i in g)
            assert seqs(prefixes, plens) == seqs(w_pre, w_len), (row, g)


def _both(lp, mode, lms, **kw):
    want = jbs.ctc_beam_search_device_jit(
        jnp.asarray(lp), beam_width=W, top_k=K, blank_id=BLANK,
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, **_kwargs(mode, lms, False))
    got = bs.ctc_beam_search_device(
        torch.from_numpy(lp), beam_width=W, top_k=K, blank_id=BLANK,
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}, **_kwargs(mode, lms, True))
    return got, want


CASES = {
    "none": dict(unk_id=UNK),
    "none_lengths_max_len": dict(lengths=np.array([24, 13, 7], np.int32),
                                 max_len=5, delim_id=DELIM),
    "token": dict(unk_id=UNK),
    "word": dict(unk_id=UNK),
    "hot": dict(unk_id=UNK, lengths=np.array([24, 19, 24], np.int32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_jax(case, lms):
    mode = case.split("_")[0]
    lp = log_probs(3, 24, seed=len(case))
    got, want = _both(lp, mode, lms, **CASES[case])
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[0].shape == tuple(np.asarray(want[0]).shape)
    assert_beams_match(got, want)
    assert (got[1].numpy()[:, 0] > 0).all()
    if "max_len" in CASES[case]:
        assert int(got[1].max()) <= 5
    if mode != "none":     # the unk token never wins a row
        assert not (got[0].numpy()[:, 0] == UNK).any()


def test_unk_is_never_emitted_and_delim_runs_are_one_token():
    lp = log_probs(2, 20, seed=7)
    lp[:, :, UNK] = -0.01                      # unk everywhere the best
    got = bs.ctc_beam_search_device(torch.from_numpy(lp), beam_width=W,
                                    top_k=K, unk_id=UNK, delim_id=DELIM)
    prefixes, plens = got[0].numpy(), got[1].numpy()
    for row in range(2):
        seq = list(prefixes[row, 0, : plens[row, 0]])
        assert UNK not in seq
        assert all(not (a == b == DELIM) for a, b in zip(seq, seq[1:]))


def _state_equal(state, j_state):
    for name in bs.BeamState._fields:
        a, b = getattr(state, name).numpy(), np.asarray(getattr(j_state, name))
        if a.dtype == np.float32:
            live = b > NEG / 2
            np.testing.assert_allclose(a[live], b[live], atol=TOL, rtol=0)
            assert ((a > NEG / 2) == live).all(), name
        else:
            np.testing.assert_array_equal(a, b.astype(np.int64), name)


def test_two_chunk_carry_matches_the_jax_carry(lms):
    """Chunk 1 (12 frames) returns the raw state; chunk 2 (16 frames whose
    first 4 repeat chunk 1's, skipped by start_frames) resumes from it:
    states and results against the JAX package's, word LM and hotwords."""
    lp = log_probs(2, 24, seed=11)
    kw = dict(unk_id=UNK, max_len=20, return_state=True)
    (*got1, state1), (*want1, j_state1) = _both(lp[:, :12], "hot", lms, **kw)
    assert_beams_match(got1, want1)
    _state_equal(state1, j_state1)
    assert int(state1.wn.max()) > 0 and int(state1.lm_len.max()) > 1
    start = np.array([4, 4], np.int32)
    want2 = jbs.ctc_beam_search_device_jit(
        jnp.asarray(lp[:, 8:]), beam_width=W, top_k=K, blank_id=BLANK,
        init_state=j_state1, start_frames=jnp.asarray(start),
        **kw, **_kwargs("hot", lms, False))
    got2 = bs.ctc_beam_search_device(
        torch.from_numpy(lp[:, 8:]), beam_width=W, top_k=K, blank_id=BLANK,
        init_state=state1, start_frames=torch.from_numpy(start),
        **kw, **_kwargs("hot", lms, True))
    assert_beams_match(got2[:3], want2[:3])
    _state_equal(got2[3], want2[3])


def test_frame_graph_runs_eagerly_on_the_cpu():
    """run_frames scans like lax.scan on the CPU (inside eager() too); the
    outputs stack over frames and an empty frame axis is refused."""
    def step(carry, frame, t, inputs):
        (acc,) = carry
        acc = acc + frame * (t + inputs[0])
        return (acc,), acc.clone()

    frames = torch.arange(12.0).reshape(4, 3)
    with frame_graph.eager():
        (acc,), outs = frame_graph.run_frames(
            step, (torch.zeros(3),), frames, (torch.tensor(1),))
    want = torch.cumsum(frames * torch.arange(1.0, 5.0)[:, None], 0)
    torch.testing.assert_close(outs, want, rtol=0, atol=0)
    torch.testing.assert_close(acc, want[-1], rtol=0, atol=0)
    with pytest.raises(ValueError, match="at least one frame"):
        frame_graph.run_frames(step, (torch.zeros(3),), frames[:0])


def test_a_frame_step_reads_outside_tensors_only_through_consts():
    """A tensor that a step (or a function its closure holds) closes over
    must be one of run_frames's consts: a CUDA graph reads it by address,
    after the call that made it has freed it. The check runs on the CPU."""
    frames, table = torch.arange(6.0).reshape(3, 2), torch.tensor([2.0, 3.0])

    def scale(x):
        return x * table

    def step(carry, frame, t, inputs):
        (acc,) = carry
        acc = acc + scale(frame)
        return (acc,), acc.clone()

    def direct(carry, frame, t, inputs):
        return (carry[0] + frame * table,), frame

    for fn in (step, direct):
        with pytest.raises(ValueError, match="'table'"):
            frame_graph.run_frames(fn, (torch.zeros(2),), frames)
    (acc,), _ = frame_graph.run_frames(step, (torch.zeros(2),), frames,
                                       consts=(scale,))
    torch.testing.assert_close(acc, frames.sum(0) * table, rtol=0, atol=0)
    (acc,), _ = frame_graph.run_frames(direct, (torch.zeros(2),), frames,
                                       consts=((table,),))
    torch.testing.assert_close(acc, frames.sum(0) * table, rtol=0, atol=0)
