"""Self-supervised pretraining in the port against the JAX package on the
CPU, at the tiny config of tests/test_pretrain.py (2 blocks, d_model 64,
2 heads, kernel 7, fp32, dropout 0; proj 32, 2 x 16 codes).

- span mask: the port's dilation of JAX's Bernoulli starts equals
  ``sample_mask_spans`` bit for bit; the port's own draws keep its
  properties;
- ``GumbelQuantizer`` in evaluation and in training on JAX's Gumbel draw:
  codevectors, perplexity and the straight-through gradients to 1e-5;
- ``contrastive_loss``, both negatives_impls (the sampled indices drawn
  again as the JAX code draws them): loss, accuracy and gradients to 1e-5;
- ``Wav2Vec2Pretrain`` (evaluation) and both ``BYOLNet`` towers: 1e-4;
- one wav2vec2 step (both negatives_impls) and one BYOL step (SpecAugment
  off, a target tower apart from the online one) against
  ``make_*_step(..., donate=False)``, JAX's draws fed to the port: loss and
  its parts to 1e-5 relative, BatchNorm statistics to 1e-6, every
  parameter (the BYOL target's after the EMA too) within 5e-3 of the
  learning rate;
- ``transfer_encoder`` into CTC and transducer models equals the JAX one on
  converted trees bit for bit (whole, and by parts where the depths
  differ), and raises when nothing matches;
- convert.py round-trips the wav2vec2 and BYOL trees bit for bit;
- ``cli.pretrain --device cpu`` (wav2vec2 and BYOL): 2 steps, checkpoints,
  resume to 3; ``cli.train --init-encoder-from`` starts from those weights;
  without a GPU it raises, and ``optim.accum_steps > 1`` is refused.
"""

import concurrent.futures
import csv
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.models.byol import BYOLNet as JBYOLNet
from conformer_tpu.models.quantizer import GumbelQuantizer as JGumbelQuantizer
from conformer_tpu.models.wav2vec2 import Wav2Vec2Pretrain as JWav2Vec2Pretrain
from conformer_tpu.models.wav2vec2 import contrastive_loss as j_contrastive_loss
from conformer_tpu.models.wav2vec2 import sample_mask_spans as j_sample_mask_spans
from conformer_tpu.train import pretrain as jpretrain
from conformer_tpu.train.state import make_optimizer as j_make_optimizer
from conformer_tpu.utils.masking import subsampled_length as j_subsampled_length
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from conformer_tpu_torch.models import quantizer as tquantizer
from conformer_tpu_torch.models import wav2vec2 as tw2v
from conformer_tpu_torch.models.byol import BYOLNet, BYOLPretrain
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.models.quantizer import GumbelQuantizer
from conformer_tpu_torch.models.wav2vec2 import (Wav2Vec2Pretrain,
                                                 contrastive_loss,
                                                 dilate_mask_starts,
                                                 sample_mask_spans)
from conformer_tpu_torch.train import pretrain as tpretrain
from conformer_tpu_torch.train.state import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401

LR = 1e-3


def _configs(method="wav2vec2", **extra):
    """tests/test_pretrain.py's tiny config (plus ``extra``), for JAX and
    for the port."""
    over = {"model.vocab_size": 370, "model.n_blocks": 2, "model.d_model": 64,
            "model.n_heads": 2, "model.kernel_size": 7,
            "model.lstm_hidden_dim": 64, "model.dropout_rate": 0.0,
            "model.use_scan_layers": False, "model.use_remat": False,
            "optim.compute_dtype": "float32", "optim.learning_rate": LR,
            "optim.eps": 1e-3, "pretrain.method": method,
            "pretrain.proj_dim": 32, "pretrain.num_groups": 2,
            "pretrain.num_vars": 16, "pretrain.num_negatives": 10,
            "pretrain.predictor_hidden": 64, "augment.enabled": True,
            "augment.n_time_masks": 1, "augment.time_mask_param": 10,
            "augment.n_freq_masks": 1, "augment.freq_mask_param": 8}
    over.update(extra)
    jcfg = JConfig().override(**over)
    return jcfg, Config.from_dict(jcfg.to_dict())


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _randomize_stats(stats, seed: int):
    """BatchNorm statistics drawn at random (init gives 0 and 1)."""
    rng = np.random.default_rng(seed)

    def fill(path, x):
        name = path[-1].key
        lo, hi = (-0.5, 0.5) if name == "mean" else (0.5, 1.5)
        return rng.uniform(lo, hi, x.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, stats)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _mels(b=2, t=120, lengths=(120, 70), seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, 80)).astype(np.float32),
            np.array(lengths, np.int32))


# ---------------------------------------------------------------------------
# Span mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_valid", [False, True])
def test_span_mask_dilation_matches_jax_bit_for_bit(with_valid):
    key = jax.random.PRNGKey(3)
    b, t, p, span = 4, 100, 0.1, 5
    valid = np.arange(t)[None] < np.array([100, 80, 37, 5])[:, None]
    want = j_sample_mask_spans(key, b, t, p, span,
                               jnp.asarray(valid) if with_valid else None)
    starts = np.array(jax.random.bernoulli(key, p, (b, t)))   # JAX's 1st draw
    got = dilate_mask_starts(torch.from_numpy(starts), span,
                             torch.from_numpy(valid) if with_valid else None)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_span_mask_properties_of_the_ports_own_draws():
    """tests/test_pretrain.py::TestMasking on the port's draws."""
    mask = sample_mask_spans(torch.Generator().manual_seed(0), 4, 100, 0.1, 5)
    assert mask.shape == (4, 100) and mask.any()
    assert 0 < mask.float().mean() < 0.9
    valid = torch.zeros(2, 50, dtype=torch.bool)
    valid[:, :10] = True
    mask = sample_mask_spans(torch.Generator().manual_seed(0), 2, 50, 0.5, 3,
                             valid)
    assert not mask[:, 10:].any() and mask[:, :10].any()


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_quantizer_matches_jax(train):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    mask = rng.random((2, 10)) < 0.5
    weights = rng.standard_normal((2, 10, 16)).astype(np.float32)
    q = JGumbelQuantizer(input_dim=24, num_groups=2, num_vars=8,
                         codevector_dim=16)
    params = q.init({"params": jax.random.PRNGKey(1),
                     "gumbel": jax.random.PRNGKey(2)}, jnp.asarray(x))["params"]
    key = jax.random.PRNGKey(4)

    def j_loss(params, x):
        out, ppl = q.apply({"params": params}, x, jnp.asarray(mask), 1.5,
                           train=train, rng=key if train else None)
        return jnp.sum(out * weights) + ppl, (out, ppl)

    (_, (j_out, j_ppl)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    gumbels = np.asarray(jax.random.gumbel(key, (2, 10, 2, 8), jnp.float32))

    tq = GumbelQuantizer(24, 2, 8, 16)
    p = _np_tree(params)
    tq.load_state_dict({
        "weight_proj.weight": torch.tensor(p["weight_proj"]["kernel"].T),
        "weight_proj.bias": torch.tensor(p["weight_proj"]["bias"]),
        "codevectors": torch.tensor(p["codevectors"])})
    tq.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    out, ppl = tq(xt, torch.from_numpy(mask), 1.5,
                  gumbels=torch.from_numpy(gumbels) if train else None)
    ((out * torch.from_numpy(weights)).sum() + ppl).backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **tol)
    np.testing.assert_allclose(float(ppl.detach()), float(j_ppl), **tol)
    # in evaluation no gradient passes the argmax: torch leaves it unset,
    # JAX gives zeros
    grad = lambda t: (t.grad if t.grad is not None
                      else torch.zeros_like(t)).numpy()
    np.testing.assert_allclose(grad(xt), np.asarray(j_gx), **tol)
    np.testing.assert_allclose(grad(tq.weight_proj.weight).T,
                               np.asarray(j_gp["weight_proj"]["kernel"]), **tol)
    np.testing.assert_allclose(grad(tq.weight_proj.bias),
                               np.asarray(j_gp["weight_proj"]["bias"]), **tol)
    np.testing.assert_allclose(grad(tq.codevectors),
                               np.asarray(j_gp["codevectors"]), **tol)
    # the straight-through gradient reaches the features in training
    assert (float(np.abs(grad(xt)).max()) > 0) == train


# ---------------------------------------------------------------------------
# InfoNCE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["all", "sampled"])
def test_contrastive_loss_matches_jax(impl):
    """Targets from a codebook of 5, so same-target candidates occur."""
    b, t, d, k = 3, 24, 16, 7
    rng = np.random.default_rng(0)
    context = rng.standard_normal((b, t, d)).astype(np.float32)
    codes = rng.standard_normal((5, d)).astype(np.float32)
    target = codes[rng.integers(0, 5, (b, t))]
    mask = rng.random((b, t)) < 0.6
    key = jax.random.PRNGKey(4)

    def j_loss(c, tg):
        loss, acc = j_contrastive_loss(c, tg, jnp.asarray(mask), key,
                                       num_negatives=k, temperature=0.1,
                                       negatives_impl=impl)
        return loss, acc

    (j_l, j_acc), (j_gc, j_gt) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(context),
                                               jnp.asarray(target))
    # the sampled path's indices, drawn as the JAX code draws them
    raw = jax.vmap(lambda r: jax.random.randint(r, (t, k), 0, t - 1))(
        jax.random.split(key, b))
    negatives = np.asarray(raw + (raw >= jnp.arange(t)[:, None]))
    c_t = torch.from_numpy(context).requires_grad_()
    t_t = torch.from_numpy(target).requires_grad_()
    loss, acc = contrastive_loss(c_t, t_t, torch.from_numpy(mask), k, 0.1,
                                 impl, negatives=torch.from_numpy(
                                     negatives.astype(np.int64)))
    loss.backward()
    tol = dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(j_l), **tol)
    assert float(acc) == float(j_acc)
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(j_gc), **tol)
    np.testing.assert_allclose(t_t.grad.numpy(), np.asarray(j_gt), **tol)


# ---------------------------------------------------------------------------
# The two pretraining models
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _w2v_variables(scan: bool = False):
    jcfg, _ = _configs("wav2vec2", **{"model.use_scan_layers": scan})
    model = JWav2Vec2Pretrain(jcfg.model, jcfg.pretrain, deterministic=True)
    mels = jnp.zeros((1, 32, 80))
    mask = jnp.zeros((1, j_subsampled_length(32)), bool)
    init = jax.jit(lambda key: model.init({"params": key}, mels,
                                          jnp.array([32]), mask))
    tree = _np_tree(dict(init(jax.random.PRNGKey(5))))
    tree["batch_stats"] = _randomize_stats(tree["batch_stats"], 6)
    return tree


@functools.lru_cache(maxsize=None)
def _byol_variables(scan: bool = False):
    """Online tower variables (random BatchNorm statistics)."""
    jcfg, _ = _configs("byol", **{"model.use_scan_layers": scan})
    net = JBYOLNet(jcfg.model, jcfg.pretrain, with_predictor=True)
    init = jax.jit(lambda key: net.init({"params": key}, jnp.zeros((1, 32, 80)),
                                        jnp.array([32])))
    tree = _np_tree(dict(init(jax.random.PRNGKey(7))))
    tree["batch_stats"] = _randomize_stats(tree["batch_stats"], 8)
    return tree


def _target_tree(online: dict) -> dict:
    return {"params": {k: v for k, v in online["params"].items()
                       if k != "predictor"},
            "batch_stats": online["batch_stats"]}


@functools.lru_cache(maxsize=None)
def _w2v_forward_reference():
    """-> (mels, lengths, mask, JAX's (context, target, perplexity))."""
    jcfg, _ = _configs("wav2vec2")
    mels, lengths = _mels()
    t_sub = j_subsampled_length(mels.shape[1])
    mask = np.random.default_rng(2).random((2, t_sub)) < 0.3
    want = jax.jit(JWav2Vec2Pretrain(jcfg.model, jcfg.pretrain,
                                     deterministic=True).apply)(
        _w2v_variables(), jnp.asarray(mels), jnp.asarray(lengths),
        jnp.asarray(mask))
    return mels, lengths, mask, _np_tree(want)


@functools.lru_cache(maxsize=None)
def _byol_tower_reference(train: bool):
    """-> (mels, lengths, [(with_predictor, tree, tree name, JAX's
    (projections, lengths), its updated batch_stats)] for both towers)."""
    jcfg, _ = _configs("byol")
    online = _byol_variables()
    mels, lengths = _mels(3, 100, (100, 64, 37))
    towers = []
    for with_pred, tree, name in ((True, online, "byol"),
                                  (False, _target_tree(online), "byol_target")):
        net = JBYOLNet(jcfg.model, jcfg.pretrain, with_predictor=with_pred,
                       deterministic=not train)
        out, updates = jax.jit(functools.partial(
            net.apply, mutable=["batch_stats"]))(
                tree, jnp.asarray(mels), jnp.asarray(lengths))
        towers.append((with_pred, tree, name, _np_tree(out),
                       _np_tree(updates["batch_stats"])))
    return mels, lengths, towers


def _byol_references():
    for train in (False, True):
        _byol_tower_reference(train)
    _byol_step_reference()


@pytest.fixture(scope="module")
def jax_reference():
    """Compiles and runs the JAX side of the forward and step comparisons
    once per module, in set-up (the cached functions hold the results):
    BYOL's in a thread beside wav2vec2's, whose steps catch their Gumbel
    draws through a patched jax.random.gumbel, one at a time."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        byol = pool.submit(_byol_references)
        _w2v_forward_reference()
        for impl in ("all", "sampled"):
            _w2v_step_reference(impl)
        byol.result()


def test_wav2vec2_forward_matches_jax(jax_reference):
    _, tcfg = _configs("wav2vec2")
    tree = _w2v_variables()
    mels, lengths, mask, want = _w2v_forward_reference()
    model = Wav2Vec2Pretrain(tcfg.model, tcfg.pretrain)
    model.load_state_dict(flax_to_state_dict(tree, tcfg.model, "wav2vec2"))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(mels), torch.from_numpy(lengths),
                           torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_byol_towers_match_jax(train, jax_reference):
    """Both towers in evaluation; the online one also in training (batch
    statistics, which it then updates)."""
    _, tcfg = _configs("byol")
    mels, lengths, towers = _byol_tower_reference(train)
    t_args = (torch.from_numpy(mels), torch.from_numpy(lengths))
    for with_pred, tree, name, (want, want_len), stats in towers:
        port = BYOLNet(tcfg.model, tcfg.pretrain, with_pred)
        port.load_state_dict(flax_to_state_dict(tree, tcfg.model, name))
        with torch.no_grad():
            got, got_len = port.train(train)(*t_args)
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
        if train:
            back = state_dict_to_flax(port.state_dict(), tcfg.model, False,
                                      name)
            want_stats = _leaves(stats)
            got_stats = _leaves(back["batch_stats"])
            for key, arr in want_stats.items():
                np.testing.assert_allclose(got_stats[key], arr, atol=1e-6,
                                           err_msg=key)
            break


@pytest.mark.parametrize("name", ["wav2vec2", "byol", "byol_target"])
@pytest.mark.parametrize("scan", [False, True])
def test_pretrain_trees_round_trip(name, scan):
    _, tcfg = _configs("byol" if name.startswith("byol") else "wav2vec2",
                       **{"model.use_scan_layers": scan})
    tree = (_w2v_variables(scan) if name == "wav2vec2"
            else _byol_variables(scan))
    if name == "byol_target":
        tree = _target_tree(tree)
    port = (Wav2Vec2Pretrain(tcfg.model, tcfg.pretrain) if name == "wav2vec2"
            else BYOLNet(tcfg.model, tcfg.pretrain, name == "byol"))
    port.load_state_dict(flax_to_state_dict(tree, tcfg.model, name))
    back = state_dict_to_flax(port.state_dict(), tcfg.model, scan, name)
    want, got = _leaves(tree), _leaves(back)
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


# ---------------------------------------------------------------------------
# One train step of each method
# ---------------------------------------------------------------------------

def _audio():
    rng = np.random.default_rng(7)
    audio = (rng.standard_normal((3, 16000)) * 0.1).astype(np.float32)
    lengths = np.array([16000, 12000, 9000], np.int32)
    audio[np.arange(16000)[None] >= lengths[:, None]] = 0.0
    return audio, lengths


# The steps' JAX side runs the scan-stacked blocks: the quickest compile
# (the port computes the same either way).
SCAN = {"model.use_scan_layers": True}


def _assert_params_close(got: dict, want: dict, what: str):
    worst = max(float(np.abs(got[k] - v).max()) for k, v in want.items())
    assert sorted(got) == sorted(want), what
    assert worst <= 5e-3 * LR, (what, worst)


def _unoptimised(step, *args):
    """A jitted JAX step compiled with LLVM's optimisation passes off (most
    of its compile on the CPU; they change no value compared here), run
    on ``args``."""
    return step.lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@functools.lru_cache(maxsize=None)
def _w2v_step_reference(impl: str):
    """JAX's wav2vec2 step from its init state, with the draws it made: the
    mask starts and sampled negatives drawn again from its keys, the Gumbel
    noise caught as it is drawn."""
    jcfg, _ = _configs("wav2vec2", **SCAN, **{"pretrain.negatives_impl": impl})
    tx = j_make_optimizer(jcfg.optim)
    state = jax.jit(lambda key: jpretrain.init_wav2vec2_state(
        jcfg, key, tx, mel_frames=32))(jax.random.PRNGKey(3))
    audio, lengths = _audio()
    caught = []
    gumbel = jax.random.gumbel

    def spy(key, shape=(), dtype=jnp.float64, *args, **kwargs):
        out = gumbel(key, shape, dtype, *args, **kwargs)
        jax.debug.callback(lambda v: caught.append(np.asarray(v)), out)
        return out

    rng = jax.random.PRNGKey(0)
    with mock.patch.object(jax.random, "gumbel", spy):
        new_state, metrics = _unoptimised(
            jpretrain.make_wav2vec2_step(jcfg, tx, donate=False), state,
            jnp.asarray(audio), jnp.asarray(lengths), rng,
            jpretrain.gumbel_temperature_at(jcfg, 0))
        metrics = _np_tree(metrics)
    assert len(caught) == 1
    mask_key, _, neg_key, _ = jax.random.split(jax.random.fold_in(rng, 0), 4)
    t_sub = j_subsampled_length(1 + 16000 // jcfg.audio.hop_length)
    starts = np.asarray(jax.random.bernoulli(
        mask_key, jcfg.pretrain.mask_prob, (3, t_sub)))
    k = jcfg.pretrain.num_negatives
    raw = jax.vmap(lambda r: jax.random.randint(r, (t_sub, k), 0, t_sub - 1))(
        jax.random.split(neg_key, 3))
    negatives = np.asarray(raw + (raw >= jnp.arange(t_sub)[:, None]))
    return (_np_tree({"params": state.params,
                      "batch_stats": state.batch_stats}),
            _np_tree({"params": new_state.params,
                      "batch_stats": new_state.batch_stats}),
            metrics, {"starts": starts, "gumbels": caught[0],
                      "negatives": negatives.astype(np.int64)})


@pytest.mark.parametrize("impl", ["all", "sampled"])
def test_wav2vec2_step_matches_jax(impl, monkeypatch, jax_reference):
    before, after, j_metrics, draws = _w2v_step_reference(impl)
    _, tcfg = _configs("wav2vec2", **SCAN, **{"pretrain.negatives_impl": impl})
    model = Wav2Vec2Pretrain(tcfg.model, tcfg.pretrain)
    model.load_state_dict(flax_to_state_dict(before, tcfg.model, "wav2vec2"))
    monkeypatch.setattr(tw2v, "sample_mask_starts",
                        lambda *a: torch.from_numpy(draws["starts"]))
    monkeypatch.setattr(tquantizer, "gumbel_noise",
                        lambda *a: torch.from_numpy(draws["gumbels"]))
    monkeypatch.setattr(tw2v, "sample_negatives",
                        lambda *a: torch.from_numpy(draws["negatives"]))
    assert draws["starts"].any()
    opt = make_optimizer(tcfg.optim, model.parameters())
    metrics = tpretrain.make_wav2vec2_step(tcfg, model, opt)(
        *(torch.from_numpy(x) for x in _audio()), 0)
    for key in ("loss", "contrastive", "diversity", "accuracy", "perplexity"):
        np.testing.assert_allclose(float(metrics[key]), j_metrics[key],
                                   rtol=1e-5, err_msg=key)
    got = state_dict_to_flax(model.state_dict(), tcfg.model, True, "wav2vec2")
    want_stats, got_stats = _leaves(after["batch_stats"]), _leaves(
        got["batch_stats"])
    for key, arr in want_stats.items():
        np.testing.assert_allclose(got_stats[key], arr, atol=1e-6, rtol=0,
                                   err_msg=key)
    _assert_params_close(_leaves(got["params"]), _leaves(after["params"]),
                         "params")


@functools.lru_cache(maxsize=None)
def _byol_step_reference():
    """JAX's BYOL step from an init state whose target tower was moved away
    from the online one (random parameters and statistics), so that the
    EMA and the target's running statistics are both seen."""
    jcfg, _ = _configs("byol", **SCAN, **{"augment.enabled": False})
    tx = j_make_optimizer(jcfg.optim)
    state = jax.jit(lambda key: jpretrain.init_byol_state(
        jcfg, key, tx, mel_frames=32))(jax.random.PRNGKey(3))
    rng = np.random.default_rng(12)
    state = state.replace(
        target_params=jax.tree_util.tree_map(
            lambda x: x + rng.normal(0, 0.05, x.shape).astype(np.float32),
            state.target_params),
        target_batch_stats=_randomize_stats(state.target_batch_stats, 13))
    before = _np_tree(state)
    new_state, metrics = _unoptimised(
        jpretrain.make_byol_step(jcfg, tx, donate=False), state,
        *(jnp.asarray(x) for x in _audio()), jax.random.PRNGKey(0))
    return before, _np_tree(new_state), _np_tree(metrics)


def _byol_state_dict(params, stats, target_params, target_stats, cfg):
    state = {f"online.{k}": v for k, v in flax_to_state_dict(
        {"params": params, "batch_stats": stats}, cfg.model, "byol").items()}
    state.update({f"target.{k}": v for k, v in flax_to_state_dict(
        {"params": target_params, "batch_stats": target_stats}, cfg.model,
        "byol_target").items()})
    return state


def test_byol_step_matches_jax(jax_reference):
    before, after, j_metrics = _byol_step_reference()
    _, tcfg = _configs("byol", **SCAN, **{"augment.enabled": False})
    model = BYOLPretrain(tcfg.model, tcfg.pretrain)
    model.load_state_dict(_byol_state_dict(
        before.params, before.batch_stats, before.target_params,
        before.target_batch_stats, tcfg))
    opt = make_optimizer(tcfg.optim, model.parameters())
    assert len(opt.params) == len(list(model.online.parameters()))
    metrics = tpretrain.make_byol_step(tcfg, model, opt)(
        *(torch.from_numpy(x) for x in _audio()), 0)
    np.testing.assert_allclose(float(metrics["loss"]), j_metrics["loss"],
                               rtol=1e-5)
    for tower, params, stats, name in (
            (model.online, after.params, after.batch_stats, "byol"),
            (model.target, after.target_params, after.target_batch_stats,
             "byol_target")):
        got = state_dict_to_flax(tower.state_dict(), tcfg.model, True, name)
        want_stats, got_stats = _leaves(stats), _leaves(got["batch_stats"])
        for key, arr in want_stats.items():
            np.testing.assert_allclose(got_stats[key], arr, atol=1e-6,
                                       rtol=0, err_msg=f"{name} {key}")
        _assert_params_close(_leaves(got["params"]), _leaves(params), name)
    # the target's statistics are its own, untouched
    for key, arr in _leaves(before.target_batch_stats).items():
        np.testing.assert_array_equal(_leaves(after.target_batch_stats)[key],
                                      arr)


# ---------------------------------------------------------------------------
# The encoder transfer
# ---------------------------------------------------------------------------

def _transfer_case(method: str, arch: str, scan: bool, blocks: int):
    """Port models with seeded weights and their converted trees: the
    pretraining model (2 blocks) and the supervised one (``blocks``)."""
    _, pcfg = _configs(method, **{"model.use_scan_layers": scan})
    scfg = pcfg.override(**{"model.arch": arch, "model.n_blocks": blocks,
                            "model.pred_embed_dim": 32,
                            "model.pred_hidden_dim": 32,
                            "model.joint_dim": 32})
    pre_model = tpretrain.build_pretrain_model(pcfg, seed=5)
    name = "wav2vec2" if method == "wav2vec2" else "byol"
    pre_tower = pre_model if method == "wav2vec2" else pre_model.online
    pre_tree = state_dict_to_flax(pre_tower.state_dict(), pcfg.model, scan,
                                  name)
    sup = build_model(scfg.model, seed=9)
    sup_tree = state_dict_to_flax(sup.state_dict(), scfg.model, scan)
    pre = {n: p.detach() for n, p in pre_tower.named_parameters()}
    return scfg, pre, pre_tree, sup, sup_tree


@pytest.mark.parametrize("method,arch,scan,blocks", [
    ("wav2vec2", "ctc", True, 2), ("byol", "ctc", True, 2),
    ("wav2vec2", "transducer", True, 2), ("byol", "transducer", True, 2),
    ("wav2vec2", "ctc", True, 3), ("byol", "transducer", False, 3)])
def test_transfer_encoder_matches_jax(method, arch, scan, blocks):
    """Depth 3 against 2: the scan layout transfers the stack whole or not
    at all (here not), the unrolled one block by block."""
    scfg, pre, pre_tree, sup, sup_tree = _transfer_case(method, arch, scan,
                                                        blocks)
    want_params = jpretrain.transfer_encoder(pre_tree["params"],
                                             sup_tree["params"], method)
    want = flax_to_state_dict({"params": _np_tree(want_params),
                               "batch_stats": sup_tree["batch_stats"]},
                              scfg.model)
    copied = tpretrain.transfer_encoder(pre, sup, method)
    stack = ["blocks"] if blocks == 2 else ([] if scan else
                                            ["blocks.0", "blocks.1"])
    assert copied == ["subsample", "input_proj"] + stack
    got = sup.state_dict()
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_transfer_encoder_raises_when_nothing_matches():
    _, _, pre_tree, _, _ = _transfer_case("wav2vec2", "ctc", True, 2)
    _, pcfg = _configs("wav2vec2")
    ocfg = pcfg.override(**{"model.d_model": 32})
    other = build_model(ocfg.model, seed=1)
    other_tree = state_dict_to_flax(other.state_dict(), ocfg.model, True)
    with pytest.raises(ValueError, match="no encoder weights"):
        jpretrain.transfer_encoder(pre_tree["params"], other_tree["params"])
    pre = {n: torch.from_numpy(np.asarray(v)) for n, v in
           flax_to_state_dict(pre_tree, pcfg.model, "wav2vec2").items()}
    with pytest.raises(ValueError, match="no encoder weights"):
        tpretrain.transfer_encoder(pre, other, "wav2vec2")


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

TINY = ["--set", "model.n_blocks=2", "--set", "model.d_model=64",
        "--set", "model.n_heads=2", "--set", "model.kernel_size=7",
        "--set", "model.lstm_hidden_dim=80", "--set", "data.batch_size=2",
        "--set", "data.num_workers=0", "--set", "train.log_every_steps=1",
        "--set", "train.checkpoint_every_steps=1",
        "--set", "train.num_epochs=10", "--set", "pretrain.proj_dim=32",
        "--set", "pretrain.num_vars=16", "--set", "pretrain.predictor_hidden=64"]


def _path_manifest(tmp_path):
    """Unlabelled WAVs in a manifest with a ``path`` column alone."""
    rng = np.random.default_rng(3)
    manifest = tmp_path / "unlabelled.csv"
    with open(manifest, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path"])
        for i, sec in enumerate([0.6, 1.2, 0.9, 1.7]):
            wav = tmp_path / f"u{i}.wav"
            sig = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
            wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
            w.writerow([str(wav)])
    return str(manifest)


@pytest.mark.parametrize("method", ["wav2vec2", "byol"])
def test_cli_pretrain_resumes_and_train_starts_from_its_encoder(
        method, tmp_path):
    from conformer_tpu_torch.cli import pretrain as cli_pretrain
    from conformer_tpu_torch.cli import train as cli_train

    manifest = _path_manifest(tmp_path)
    ck = tmp_path / "pre"
    argv = ["--manifest", manifest, "--method", method, "--checkpoint-dir",
            str(ck), "--device", "cpu", *TINY]
    first = cli_pretrain.main(argv + ["--set", "train.num_steps=2"])
    assert (first.start_step, first.step) == (0, 2)
    assert (ck / "config.json").exists()
    assert sorted(p.name for p in ck.glob("ckpt_*.pt")) == \
        ["ckpt_00000001.pt", "ckpt_00000002.pt"]
    second = cli_pretrain.main(argv + ["--set", "train.num_steps=3"])
    assert (second.start_step, second.step) == (2, 3)
    assert second.optimizer.count == 3
    lines = (ck / "metrics.jsonl").read_text().splitlines()
    assert [eval(ln.replace("NaN", "None"))["step"] for ln in lines
            if "pretrain/loss" in ln] == [1, 2, 3]
    tower = second.model if method == "wav2vec2" else second.model.online
    encoder = {n: p.detach().clone() for n, p in tower.named_parameters()}
    # cli.train with no epoch to run: the model as it starts
    sup_argv = ["--train-manifest", _labelled(tmp_path, manifest),
                "--checkpoint-dir", str(tmp_path / "sup"), "--device", "cpu",
                "--init-encoder-from", str(ck), "--init-method", method,
                *TINY]
    trainer = cli_train.main(sup_argv + ["--set", "train.num_epochs=0"])
    prefix = "encoder." if method == "byol" else ""
    for name, p in trainer.model.encoder.named_parameters():
        assert torch.equal(p.detach(), encoder[prefix + name]), name
    # and it trains from there
    trainer = cli_train.main(sup_argv + ["--set", "train.num_steps=1"])
    assert trainer.step == 1


def _labelled(tmp_path, manifest: str) -> str:
    """The same WAVs with transcripts."""
    out = tmp_path / "labelled.csv"
    with open(manifest, newline="", encoding="utf8") as f:
        paths = [r["path"] for r in csv.DictReader(f)]
    with open(out, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        w.writerows([p, "xin chào"] for p in paths)
    return str(out)


def test_cli_pretrain_refuses_a_missing_gpu_and_accumulation(monkeypatch,
                                                            tmp_path):
    from conformer_tpu_torch.cli import pretrain as cli_pretrain

    manifest = _path_manifest(tmp_path)
    base = ["--manifest", manifest, "--checkpoint-dir", str(tmp_path / "ck"),
            *TINY]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_pretrain.main(base)
    with pytest.raises(NotImplementedError, match="accum_steps"):
        cli_pretrain.main(base + ["--device", "cpu",
                                  "--set", "optim.accum_steps=2"])
