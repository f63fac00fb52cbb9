"""The port's transducer (RNN-T) against the JAX package on the CPU.

``ModelConfig.tiny`` with ``arch='transducer'`` (prediction, joint 32, the
vi vocabulary of 370), fp32, dropout off, the flax weights carried across
by ``conformer_tpu_torch.convert``, and seeded numpy inputs:

- the convert round trip (both block layouts) and its CLI;
- the teacher-forced prediction network, ``predict_init`` and
  ``predict_step`` (atol 1e-5); the joint and the lattice (atol 1e-4);
- ``rnnt_alpha_final`` against a float64 dynamic programme (1e-5), also
  on a peaked 24 s lattice with its gradients (1e-4);
- ``rnnt_loss_scan`` and ``rnnt_loss_from_logits``: value (rtol 1e-5) and
  gradients (1e-4 of each gradient's max) against the JAX losses, with
  ``row_mask``; padding frames and labels past the lengths changes nothing;
- the greedy decode's tokens and counts, with ``start_frames`` and
  ``return_carry`` (the carry to 1e-5);
- one train step's loss and grad norm (rtol 1e-5), scan and lattice,
  against ``make_transducer_train_step``;
- pipeline texts, WER, CER and loss against the JAX ``InferencePipeline``;
  streamed texts against the JAX ``StreamingTranscriber``; a served
  ``/transcribe`` text and a stream session against the JAX pipeline and
  transcriber; ``cli.train`` / ``cli.test`` on the CPU;
- the beam search through the pipeline (texts, WER, CER and loss against
  the JAX pipeline with ``decode="beam"``) and a stream; pseudo-labelling
  a transducer raises ``NotImplementedError``.

The joint's blank bias is raised (``BLANK_BIAS``) so that the random model
mixes blanks and emissions, and the greedy decode's choices are not all
the same token.
"""

import concurrent.futures
import csv
import functools
import io
import json
import math
import threading
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.data.dataset import Batch as JBatch
from conformer_tpu.decode import pipeline as jpipeline
from conformer_tpu.decode.streaming import \
    StreamingTranscriber as JStreamingTranscriber
from conformer_tpu.models.transducer import Transducer as JTransducer
from conformer_tpu.ops import rnnt as jrnnt
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.state import TrainState
from conformer_tpu.train.state import make_optimizer as j_make_optimizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu.train.steps import \
    make_transducer_train_step as j_make_train_step
from conformer_tpu_torch import convert
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.decode.pipeline import InferencePipeline
from conformer_tpu_torch.decode.streaming import StreamingTranscriber
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.models.transducer import Transducer
from conformer_tpu_torch.ops import rnnt
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.train.state import make_optimizer
from conformer_tpu_torch.train.steps import make_train_step
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
VOCAB = 370
BLANK_BIAS = 2.0
OVERRIDES = {"model.arch": "transducer", "model.pred_embed_dim": 32,
             "model.pred_hidden_dim": 32, "model.joint_dim": 32,
             "optim.compute_dtype": "float32"}


def _jcfg(**extra):
    return JConfig(model=JModelConfig.tiny(VOCAB)).override(
        **OVERRIDES, **extra)


@functools.lru_cache(maxsize=None)
def _variables(scan: bool = False):
    """Flax-initialised tiny transducer weights (numpy), the blank's joint
    bias raised; jitted once."""
    jcfg = _jcfg(**{"model.use_scan_layers": scan})
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    variables = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0)))
    variables["params"]["joint"]["out"]["bias"][0] += BLANK_BIAS
    return variables


def _port_cfg():
    return Config.from_dict(_jcfg().to_dict())


def _port_model():
    cfg = _port_cfg()
    model = Transducer(cfg.model, "float32")
    model.load_state_dict(convert.flax_to_state_dict(_variables(), cfg.model))
    return model.eval()


def _bound():
    return JTransducer(_jcfg().model).bind(_variables())


def _audio(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    return (0.4 * np.sin(2 * np.pi * 300 * t)
            + 0.1 * rng.standard_normal(len(t))).astype(np.float32)


def _post(url, data=b"", headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _wav_bytes(samples):
    buf = io.BytesIO()
    wavfile.write(buf, SR, samples)
    return buf.getvalue()


def _mels(b=2, t=61, seed=1):
    rng = np.random.default_rng(seed)
    mels = rng.standard_normal((b, t, 80)).astype(np.float32)
    lengths = np.array([t, t - 17][:b], np.int32)
    return mels, lengths


def _labels(b=2, u=5, seed=2):
    rng = np.random.default_rng(seed)
    labels = rng.integers(1, VOCAB, (b, u)).astype(np.int32)
    lengths = np.array([u, u - 2][:b], np.int32)
    labels[np.arange(u)[None] >= lengths[:, None]] = 0
    return labels, lengths


# ---------------------------------------------------------------------------
# Weights and the model
# ---------------------------------------------------------------------------

def _assert_same_tree(got, want):
    leaves = jax.tree_util.tree_leaves_with_path(want)
    assert len(jax.tree_util.tree_leaves(got)) == len(leaves)
    for path, arr in leaves:
        have = got
        for key in path:
            have = have[key.key]
        np.testing.assert_array_equal(have, arr,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("scan", [False, True])
def test_convert_round_trip(scan):
    cfg = _port_cfg().model
    variables = _variables(scan)
    state = convert.flax_to_state_dict(variables, cfg)
    assert set(state) == set(Transducer(cfg).state_dict())
    _assert_same_tree(convert.state_dict_to_flax(state, cfg, scan=scan),
                      variables)


def test_convert_cli_writes_the_transducer_state_dict(tmp_path):
    cfg = _port_cfg()
    cfg.to_json(str(tmp_path / "c.json"))
    flat = {"/".join(k.key for k in path): arr for path, arr in
            jax.tree_util.tree_leaves_with_path(_variables())}
    np.savez(tmp_path / "t.npz", **flat)
    convert.main(["--npz", str(tmp_path / "t.npz"), "--out",
                  str(tmp_path / "w.pt"), "--config", str(tmp_path / "c.json")])
    state = torch.load(tmp_path / "w.pt")
    want = convert.flax_to_state_dict(_variables(), cfg.model)
    assert set(state) == set(want)
    for name in want:
        torch.testing.assert_close(state[name], want[name], rtol=0, atol=0)


def _state_close(got, want, atol):
    for (gc, gh), (wc, wh) in zip(got, want):
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), atol=atol)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), atol=atol)


def test_prediction_network_matches_jax():
    bound, model = _bound(), _port_model()
    labels, _ = _labels()
    with torch.no_grad():
        got = model.prediction(torch.from_numpy(labels))
        state, pred = model.predict_init(2)
        tokens = torch.from_numpy(labels[:, 0])
        state2, pred2 = model.predict_step(state, tokens)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(bound.prediction(labels)), atol=1e-5)
    j_state, j_pred = bound.predict_init(2)
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), atol=1e-5)
    _state_close(state, j_state, 1e-5)
    j_state2, j_pred2 = bound.predict_step(j_state, labels[:, 0])
    np.testing.assert_allclose(pred2.numpy(), np.asarray(j_pred2), atol=1e-5)
    _state_close(state2, j_state2, 1e-5)
    # the teacher-forced output at u = 1 is one step from predict_init
    np.testing.assert_allclose(got[:, 1].numpy(), pred2.numpy(), atol=1e-6)


def test_joint_and_lattice_match_jax():
    bound, model = _bound(), _port_model()
    mels, mel_lengths = _mels()
    labels, _ = _labels()
    (j_lattice, j_len) = bound(mels, mel_lengths, labels)
    with torch.no_grad():
        lattice, lengths = model(torch.from_numpy(mels),
                                 torch.from_numpy(mel_lengths),
                                 torch.from_numpy(labels))
        (e, p), _ = model.forward_factors(torch.from_numpy(mels),
                                          torch.from_numpy(mel_lengths),
                                          torch.from_numpy(labels))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(j_len))
    assert lattice.dtype == torch.float32
    np.testing.assert_allclose(lattice.numpy(), np.asarray(j_lattice),
                               atol=1e-4)
    enc, _ = bound.encode(mels, mel_lengths)
    j_e, j_p = bound.joint.factors(enc, bound.prediction(labels))
    np.testing.assert_allclose(e.numpy(), np.asarray(j_e), atol=1e-4)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_p), atol=1e-5)


# ---------------------------------------------------------------------------
# The loss
# ---------------------------------------------------------------------------

def _naive_log_likelihood(lp_blank, lp_emit, t_len, u_len):
    alpha = np.full((t_len, u_len + 1), -np.inf)
    alpha[0, 0] = 0.0
    for t in range(t_len):
        for u in range(u_len + 1):
            terms = []
            if t > 0:
                terms.append(alpha[t - 1, u] + lp_blank[t - 1, u])
            if u > 0:
                terms.append(alpha[t, u - 1] + lp_emit[t, u - 1])
            if terms:
                alpha[t, u] = np.logaddexp.reduce(terms)
    return alpha[t_len - 1, u_len] + lp_blank[t_len - 1, u_len]


def test_alpha_final_matches_a_naive_dp():
    rng = np.random.default_rng(3)
    b, t, u = 4, 9, 5
    lp_blank = np.log(rng.uniform(0.05, 0.95, (b, t, u + 1)))
    lp_emit = np.log(rng.uniform(0.05, 0.95, (b, t, u)))
    t_len = np.array([9, 4, 1, 7])
    u_len = np.array([5, 2, 3, 0])
    got = rnnt.rnnt_alpha_final(torch.from_numpy(lp_blank),
                                torch.from_numpy(lp_emit),
                                torch.from_numpy(t_len),
                                torch.from_numpy(u_len)).numpy()
    want = [_naive_log_likelihood(lp_blank[i], lp_emit[i], t_len[i], u_len[i])
            for i in range(b)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def _lae(a, b):
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    return max(a, b) + math.log1p(math.exp(-abs(a - b)))


def _dp_with_gradients(lp_blank, lp_emit, t_len, u_len):
    """One row frame by frame in float64: -> (log P(y | x), its gradient
    in lp_blank (T, U+1), in lp_emit (T, U)), the gradients as the
    lattice's occupation probabilities (alpha + step + beta - log P)."""
    blank, emit = lp_blank.astype(np.float64), lp_emit.astype(np.float64)
    alpha = np.full((t_len, u_len + 1), -np.inf)
    beta = np.full((t_len + 1, u_len + 2), -np.inf)
    for t in range(t_len):
        for u in range(u_len + 1):
            a = 0.0 if t == u == 0 else -math.inf
            if t > 0:
                a = _lae(a, alpha[t - 1, u] + blank[t - 1, u])
            if u > 0:
                a = _lae(a, alpha[t, u - 1] + emit[t, u - 1])
            alpha[t, u] = a
    beta[t_len, u_len] = 0.0          # past the final blank
    for t in range(t_len - 1, -1, -1):
        for u in range(u_len, -1, -1):
            beta[t, u] = _lae(beta[t + 1, u] + blank[t, u],
                              beta[t, u + 1] + emit[t, u]
                              if u < u_len else -math.inf)
    ll = beta[0, 0]
    g_blank, g_emit = np.zeros_like(blank), np.zeros_like(emit)
    g_blank[:t_len, :u_len + 1] = np.exp(
        alpha + blank[:t_len, :u_len + 1] + beta[1:t_len + 1, :u_len + 1]
        - ll)
    g_emit[:t_len, :u_len] = np.exp(
        alpha[:, :u_len] + emit[:t_len, :u_len] + beta[:t_len, 1:u_len + 1]
        - ll)
    return ll, g_blank, g_emit


def _peaked_planes(rng, b, t, u):
    """A confident model's planes: near 0 along one diagonal alignment
    (the labels spread evenly over the frames: k(t) of them by frame t)
    and around -20 off it, so that a column's blank log-probs sum to
    thousands before the alignment reaches it."""
    k = np.minimum(u, (np.arange(1, t + 1) * u) // t)[:, None]
    pos = np.arange(u + 1)[None, :]
    on = lambda: -rng.uniform(0.0, 0.05, (b, t, u + 1))
    off = lambda: -20.0 + rng.uniform(-2.0, 2.0, (b, t, u + 1))
    lp_blank = np.where(pos == k, on(), off())
    lp_emit = np.where(pos < k, on(), off())[:, :, :u]
    return lp_blank.astype(np.float32), lp_emit.astype(np.float32)


def test_alpha_final_holds_on_a_peaked_24s_lattice():
    """T' 599 (24 s), U 60, peaked: the value (rtol 1e-5) and both
    gradients (atol 1e-4) against the float64 frame-by-frame DP."""
    rng = np.random.default_rng(5)
    b, t, u = 2, 599, 60
    lp_blank, lp_emit = _peaked_planes(rng, b, t, u)
    t_len, u_len = np.array([599, 530]), np.array([60, 53])  # on the path
    blank = torch.from_numpy(lp_blank).requires_grad_(True)
    emit = torch.from_numpy(lp_emit).requires_grad_(True)
    ll = rnnt.rnnt_alpha_final(blank, emit, torch.from_numpy(t_len),
                               torch.from_numpy(u_len))
    g_blank, g_emit = torch.autograd.grad(ll.sum(), (blank, emit))
    for i in range(b):
        want, w_blank, w_emit = _dp_with_gradients(lp_blank[i], lp_emit[i],
                                                   t_len[i], u_len[i])
        assert float(ll[i].detach()) == pytest.approx(want, rel=1e-5)
        np.testing.assert_allclose(g_blank[i].numpy(), w_blank, atol=1e-4)
        np.testing.assert_allclose(g_emit[i].numpy(), w_emit, atol=1e-4)


def _loss_case(seed=4):
    """Joint factors, the out projection (the JAX (J, V) kernel), labels,
    lengths and a row mask."""
    rng = np.random.default_rng(seed)
    b, t, u, v, j = 4, 11, 6, 13, 8
    e = rng.standard_normal((b, t, j)).astype(np.float32)
    p = rng.standard_normal((b, u + 1, j)).astype(np.float32)
    w = (0.5 * rng.standard_normal((j, v))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(1, v, (b, u)).astype(np.int32)
    t_len = np.array([11, 7, 3, 9], np.int32)
    u_len = np.array([6, 2, 0, 4], np.int32)
    labels[np.arange(u)[None] >= u_len[:, None]] = 0
    mask = np.array([1, 1, 0, 1], bool)
    return e, p, w, bias, labels, t_len, u_len, mask


def _jax_loss(impl, e, p, w, bias, labels, t_len, u_len, mask):
    if impl == "scan":
        return jrnnt.rnnt_loss_scan(e, p, w, bias, labels, t_len, u_len,
                                    row_mask=mask)
    lattice = jnp.tanh(e[:, :, None] + p[:, None]) @ w + bias
    return jrnnt.rnnt_loss_from_logits(lattice, labels, t_len, u_len,
                                       row_mask=mask)


def _port_loss(impl, e, p, w, bias, labels, t_len, u_len, mask):
    """w: the JAX (J, V) kernel; the port takes the Linear (V, J) weight."""
    w = w.T
    if impl == "scan":
        return rnnt.rnnt_loss_scan(e, p, w, bias, labels, t_len, u_len,
                                   row_mask=mask)
    lattice = torch.nn.functional.linear(
        torch.tanh(e[:, :, None] + p[:, None]), w, bias)
    return rnnt.rnnt_loss_from_logits(lattice, labels, t_len, u_len,
                                      row_mask=mask)


@pytest.mark.parametrize("impl", ["scan", "lattice"])
def test_loss_and_gradients_match_jax(impl):
    e, p, w, bias, labels, t_len, u_len, mask = _loss_case()
    want, j_grads = jax.value_and_grad(
        lambda *a: _jax_loss(impl, *a, labels, t_len, u_len, mask),
        argnums=(0, 1, 2, 3))(e, p, w, bias)
    args = [torch.tensor(x, requires_grad=True) for x in (e, p, w, bias)]
    got = _port_loss(impl, *args, *(torch.from_numpy(x) for x in
                                     (labels, t_len, u_len, mask)))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for name, arg, j_grad in zip("e p w bias".split(), args, j_grads):
        g, jg = arg.grad.numpy(), np.asarray(j_grad)
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max(), name
    # the masked row gets no gradient
    assert float(args[0].grad[2].abs().max()) == 0.0


@pytest.mark.parametrize("impl", ["scan", "lattice"])
def test_loss_ignores_padding_past_the_lengths(impl):
    """Junk frames, label slots and joint positions past every row's
    lengths, and junk in the padded slots of the shorter rows, change
    nothing."""
    case = _loss_case()
    e, p, w, bias, labels, t_len, u_len, mask = case
    rng = np.random.default_rng(9)
    junk = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    e = np.concatenate([e, junk(4, 5, 8)], axis=1)
    p = np.concatenate([p, junk(4, 3, 8)], axis=1)
    labels = np.concatenate([labels, rng.integers(1, 13, (4, 3))], axis=1)
    labels[1, 2:] = rng.integers(1, 13, 7)          # past row 1's 2 labels
    e[1, 7:] = junk(9, 8)                           # past row 1's 7 frames
    base = _port_loss(impl, *(torch.from_numpy(x) for x in case))
    padded = _port_loss(impl, *(torch.from_numpy(np.ascontiguousarray(x))
                                for x in (e, p, w, bias, labels.astype(
                                    np.int32), t_len, u_len, mask)))
    np.testing.assert_allclose(float(padded), float(base), rtol=1e-6)


def test_scan_loss_is_the_same_in_chunks():
    """The frames go in several checkpointed chunks when the chunk budget
    is small: the value and the gradients do not change."""
    case = [torch.from_numpy(x) for x in _loss_case()]
    runs = []
    for elements in (rnnt.SCAN_CHUNK_ELEMENTS, 3 * 4 * 7 * 13):
        args = [x.clone().requires_grad_(True) for x in case[:4]]
        with mock.patch.object(rnnt, "SCAN_CHUNK_ELEMENTS", elements):
            loss = _port_loss("scan", *args, *case[4:])
        loss.backward()
        runs.append((float(loss.detach()), [a.grad for a in args]))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    for g0, g1 in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(g1, g0, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Greedy decode
# ---------------------------------------------------------------------------

def _decode_both(start=None, max_len=None, carry=False, fns=False):
    """The port's decode (through joint_logits and predict_step, or with
    ``fns`` through frame_fns) and the JAX decode on the same encodings."""
    bound, model = _bound(), _port_model()
    mels, mel_lengths = _mels(t=81)
    enc, enc_len = bound.encode(mels, mel_lengths)
    kw = dict(max_symbols=4, max_len=max_len)
    j_out = jrnnt.rnnt_greedy_decode(
        bound.joint_logits, enc, enc_len, bound.predict_step,
        bound.predict_init(2), return_carry=carry,
        start_frames=None if start is None else jnp.asarray(start), **kw)
    with torch.no_grad():
        t_enc, t_len = model.encode(torch.from_numpy(mels),
                                    torch.from_numpy(mel_lengths))
        joint_fn, pred_step_fn = (model.frame_fns() if fns else
                                  (model.joint_logits, model.predict_step))
        out = rnnt.rnnt_greedy_decode(
            joint_fn, t_enc, t_len, pred_step_fn,
            model.predict_init(2), return_carry=carry,
            start_frames=None if start is None else torch.tensor(start),
            **kw)
    return out, j_out


@pytest.mark.parametrize("fns", [False, True])
@pytest.mark.parametrize("start,max_len", [(None, None), ((3, 7), 12)])
def test_greedy_decode_matches_jax(start, max_len, fns):
    (tokens, counts), (j_tokens, j_counts) = _decode_both(start, max_len,
                                                          fns=fns)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert tokens.dtype == counts.dtype == torch.int32
    # blanks and emissions mix, and not one token over and over
    assert 0 < int(counts.min())
    assert len(set(tokens[0, : int(counts[0])].tolist())) > 1
    assert int(counts[0]) < 4 * 19
    if max_len:
        assert int(counts.max()) <= max_len


def test_greedy_decode_returns_the_carry():
    (tokens, counts, (state, pred)), (j_tokens, j_counts, (j_state, j_pred)) \
        = _decode_both(start=(5, 0), carry=True, fns=True)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_allclose(pred.numpy(), np.asarray(j_pred), atol=1e-5)
    _state_close(state, j_state, 1e-5)


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((4, 16000)) * 0.1).astype(np.float32)
    audio_lengths = np.array([16000, 12000, 16000, 9000], np.int32)
    audio[np.arange(16000)[None] >= audio_lengths[:, None]] = 0.0
    token_lengths = np.array([8, 5, 0, 6], np.int32)       # row 2: a dummy row
    tokens = rng.integers(1, VOCAB, (4, 10)).astype(np.int32)
    tokens[np.arange(10)[None] >= token_lengths[:, None]] = 0
    return audio, audio_lengths, tokens, token_lengths


TRAIN = {"augment.enabled": False, "optim.learning_rate": 1e-3,
         "optim.grad_clip_norm": 5.0}


@pytest.fixture(scope="module")
def jax_train_steps():
    """impl -> the JAX step's metrics (compiled once each, unoptimised,
    the two side by side)."""
    variables = _variables()

    def run(impl):
        jcfg = _jcfg(**TRAIN, **{"model.rnnt_loss_impl": impl})
        tx = j_make_optimizer(jcfg.optim)
        state = TrainState.create(variables["params"],
                                  variables["batch_stats"], tx)
        args = (state, *(jnp.asarray(x) for x in _batch()),
                jax.random.PRNGKey(0))
        # LLVM's optimisation passes off: most of the compile on the CPU,
        # and they change no value compared here
        _, metrics = j_make_train_step(jcfg, tx, donate=False).lower(
            *args).compile(
                compiler_options={"xla_backend_optimization_level": 0})(*args)
        return jax.tree_util.tree_map(float, metrics)

    impls = ("scan", "lattice")
    with concurrent.futures.ThreadPoolExecutor(len(impls)) as pool:
        return dict(zip(impls, pool.map(run, impls)))


@pytest.mark.parametrize("impl", ["scan", "lattice"])
def test_one_train_step_matches_jax(impl, jax_train_steps):
    cfg = Config.from_dict(_jcfg(**TRAIN, **{
        "model.rnnt_loss_impl": impl}).to_dict())
    model = Transducer(cfg.model, "float32")
    model.load_state_dict(convert.flax_to_state_dict(_variables(), cfg.model))
    opt = make_optimizer(cfg.optim, model.parameters())
    metrics = make_train_step(cfg, model, opt)(
        *(torch.from_numpy(x) for x in _batch()), 0)
    want = jax_train_steps[impl]
    np.testing.assert_allclose(float(metrics["loss"]), want["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               want["grad_norm"], rtol=1e-5)


# ---------------------------------------------------------------------------
# Pipeline, streaming, serving, CLIs
# ---------------------------------------------------------------------------

TEXTS = ["xin chào", "Việt Nam", "một hai ba", "hôm nay trời đẹp", "bốn"]
SECONDS = [0.6, 1.3, 0.9, 1.8, 0.5]
PIPE = {"data.batch_size": 2, "data.bucket_boundaries_s": [1.0, 2.0],
        "data.max_audio_s": 2.0, "data.num_workers": 0}


def _manifest(directory):
    path = directory / "eval.csv"
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i, (sec, text) in enumerate(zip(SECONDS, TEXTS)):
            wav = directory / f"e{i}.wav"
            sig = np.clip(_audio(sec, seed=20 + i), -1, 1)
            wavfile.write(wav, SR, (sig * 32767).astype(np.int16))
            w.writerow([str(wav), text])
    return str(path)


@pytest.fixture(scope="module")
def jax_pipeline(tmp_path_factory):
    """(directory with the manifest, port config file and weights, the JAX
    pipeline on the same weights, its evaluation)."""
    directory = tmp_path_factory.mktemp("transducer")
    manifest = _manifest(directory)
    jcfg = _jcfg(**PIPE, **{"train.checkpoint_dir": str(directory / "none")})
    with mock.patch.object(jpipeline, "init_variables",
                           lambda cfg, key: _variables()):
        jpipe = jpipeline.InferencePipeline(jcfg, j_load_tokenizer("vi"))
    cfg = Config.from_dict(jcfg.to_dict())
    cfg.to_json(str(directory / "c.json"))
    torch.save(convert.flax_to_state_dict(_variables(), cfg.model),
               directory / "w.pt")
    return directory, jpipe, jpipe.evaluate(manifest)


def test_pipeline_texts_wer_and_cer_match_jax(jax_pipeline):
    directory, jpipe, (want_metrics, want_pairs) = jax_pipeline
    cfg = Config.from_json(str(directory / "c.json"))
    pipe = InferencePipeline(cfg, load_tokenizer("vi"),
                             weights=str(directory / "w.pt"), device="cpu")
    metrics, pairs = pipe.evaluate(str(directory / "eval.csv"))
    assert pairs == want_pairs
    assert all(hyp for _, hyp in pairs)
    assert metrics["wer"] == want_metrics["wer"]
    assert metrics["cer"] == want_metrics["cer"]
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"],
                               rtol=1e-5)


CHUNK_S, CONTEXT_S = 1.0, 1.0
STREAM_SECONDS = {"single": 0.8, "multi": 2.3}


@pytest.fixture(scope="module")
def jax_stream_texts():
    variables = _variables()
    st = JStreamingTranscriber(_jcfg(), j_load_tokenizer("vi"), variables,
                               chunk_s=CHUNK_S, left_context_s=CONTEXT_S)
    texts = {}
    for i, (name, sec) in enumerate(STREAM_SECONDS.items()):
        st.reset()
        st.feed(_audio(sec, seed=30 + i))
        st.finish()
        texts[name] = st.text
    return texts


def _stream(st, audio, block):
    st.reset()
    for i in range(0, len(audio), block):
        st.feed(audio[i: i + block])
    st.finish()
    return st.text


@pytest.mark.parametrize("pipelined", [True, False])
def test_streamed_texts_match_jax(jax_stream_texts, pipelined):
    st = StreamingTranscriber(_port_cfg(), load_tokenizer("vi"), _port_model(),
                              chunk_s=CHUNK_S, left_context_s=CONTEXT_S,
                              pipeline_chunks=pipelined)
    for i, (name, sec) in enumerate(STREAM_SECONDS.items()):
        audio = _audio(sec, seed=30 + i)
        for block in (len(audio), 5000):
            assert _stream(st, audio, block) == jax_stream_texts[name]
        assert jax_stream_texts[name]
    # a fresh utterance after reset starts from predict_init again
    st.feed(_audio(1.5, seed=99))
    assert _stream(st, _audio(0.8, seed=30), 3000) == \
        jax_stream_texts["single"]


def test_served_transcribe_and_stream_match_jax(jax_pipeline):
    from conformer_tpu_torch.cli import serve

    directory, jpipe, _ = jax_pipeline
    server = serve.make_server(serve.parse_args(
        ["--config", str(directory / "c.json"), "--weights",
         str(directory / "w.pt"), "--device", "cpu", "--port", "0",
         "--buckets", "2.0", "--window-ms", "10",
         "--stream-chunk-seconds", str(CHUNK_S),
         "--stream-context-seconds", str(CONTEXT_S)]))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        audio = np.round(np.clip(_audio(1.4, seed=40), -1, 1) * 32767
                         ).astype(np.int16)
        got = _post(f"{base}/transcribe", _wav_bytes(audio))["text"]
        sig = audio.astype(np.float32) / 32768.0
        padded = np.zeros((1, 2 * SR), np.float32)
        padded[0, : len(sig)] = sig
        want = jpipe.transcribe_batch(JBatch(
            padded, np.array([len(sig)], np.int32),
            np.zeros((1, 1), np.int32), np.zeros((1,), np.int32)))[0]
        assert got == want and got
        sid = _post(f"{base}/stream/start")["session"]
        _post(f"{base}/stream/{sid}", sig.astype("<f4").tobytes(),
              {"Content-Type": "audio/f32"})
        final = _post(f"{base}/stream/{sid}/finish")["text"]
    finally:
        server.shutdown()
        server.server_close()
    st = JStreamingTranscriber(jpipe.cfg, jpipe.tok, {
        "params": jpipe.state.params, "batch_stats": jpipe.state.batch_stats},
        chunk_s=CHUNK_S, left_context_s=CONTEXT_S)
    st.feed(sig)
    st.finish()
    assert final == st.text


def test_cli_train_resume_and_test_on_cpu(jax_pipeline, tmp_path, capsys):
    """cli.train trains a tiny transducer with greedy validation, resumes,
    and cli.test reports WER, CER and the RNN-T loss of the checkpoint."""
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.cli import train as cli_train

    directory = jax_pipeline[0]
    manifest = str(directory / "eval.csv")
    ck = str(tmp_path / "ck")
    argv = ["--config", str(directory / "c.json"), "--train-manifest",
            manifest, "--val-manifest", manifest, "--checkpoint-dir", ck,
            "--device", "cpu", "--set", "train.log_every_steps=1",
            "--set", "train.checkpoint_every_steps=1",
            "--set", "train.val_every_steps=2", "--set", "train.num_epochs=9"]
    trainer = cli_train.main([*argv, "--set", "train.num_steps=2"])
    assert trainer.step == 2
    assert "val: {'loss'" in capsys.readouterr().out
    trainer = cli_train.main([*argv, "--set", "train.num_steps=3"])
    assert trainer.start_step == 2 and trainer.step == 3
    metrics = cli_test.main(["--manifest", manifest, "--checkpoint-dir", ck,
                             "--device", "cpu"])
    assert set(metrics) == {"wer", "cer", "loss"}
    assert np.isfinite(metrics["loss"]) and metrics["wer"] > 0


@pytest.fixture(scope="module")
def jax_beam(jax_pipeline):
    """(the config, the port's weights file, the JAX pipeline's evaluation
    with decode="beam" at W 8) on the jax_pipeline fixture's manifest and
    weights with the joint's output scaled by 4: a random model's flat
    token choices make the empty text the likeliest, and the beam would
    find nothing else."""
    directory = jax_pipeline[0]
    jcfg = _jcfg(**PIPE, **{"train.checkpoint_dir": str(directory / "none"),
                            "decode.beam_width": 8})
    variables = jax.tree_util.tree_map(np.copy, _variables())
    variables["params"]["joint"]["out"]["kernel"] *= 4.0
    with mock.patch.object(jpipeline, "init_variables",
                           lambda cfg, key: variables):
        jpipe = jpipeline.InferencePipeline(jcfg, j_load_tokenizer("vi"),
                                            decode="beam")
    cfg = Config.from_dict(jcfg.to_dict())
    weights = str(directory / "w_beam.pt")
    torch.save(convert.flax_to_state_dict(variables, cfg.model), weights)
    return cfg, weights, jpipe.evaluate(str(directory / "eval.csv"))


def test_beams_and_pseudo_labels_raise(jax_pipeline, jax_beam):
    """Once refused, the transducer's beams now run: the pipeline with
    decode="beam" (W 8) gives the JAX pipeline's texts, WER, CER and loss
    with ``decode="beam"``; beam_device and beam_auto take the same search
    on the CPU; a stream runs it window by window. Pseudo-labelling a
    transducer still raises (a JAX fault, ROADMAP.md §3)."""
    from conformer_tpu_torch.cli import pseudo_label

    directory = jax_pipeline[0]
    manifest = str(directory / "eval.csv")
    cfg, weights, (want_metrics, want_pairs) = jax_beam
    tok = load_tokenizer("vi")
    for decode in ("beam", "beam_device", "beam_auto"):
        pipe = InferencePipeline(cfg, tok, weights=weights, decode=decode,
                                 device="cpu")
        assert pipe.decode in ("beam", "beam_device")
    metrics, pairs = pipe.evaluate(manifest)
    assert pairs == want_pairs and all(hyp for _, hyp in pairs)
    assert metrics["wer"] == want_metrics["wer"]
    assert metrics["cer"] == want_metrics["cer"]
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"],
                               rtol=1e-5)
    st = StreamingTranscriber(cfg, tok, pipe.model, chunk_s=CHUNK_S,
                              left_context_s=CONTEXT_S, decode="beam_device")
    assert st.decode == "beam"
    audio = _audio(STREAM_SECONDS["multi"], seed=31)
    assert st.feed(audio) == "" and st.finish() == st.text
    with pytest.raises(NotImplementedError, match="CTC model"):
        pseudo_label.main(["--manifest", str(directory / "eval.csv"),
                           "--output", "o.csv", "--config",
                           str(directory / "c.json"), "--device", "cpu"])
    assert isinstance(build_model(cfg.model, seed=None), Transducer)
    with pytest.raises(ValueError, match="unknown model.arch"):
        build_model(cfg.model.__class__(arch="rnn"))
