"""The port's building blocks against the JAX package on the CPU, fp32,
same weights (carried by conformer_tpu_torch.convert), same seeded inputs.

Tolerance atol/rtol 1e-5 for layers (fp32 sums in another order), exact for
integer outputs (masks, lengths, greedy collapse) and for the position
table, which both sides build in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.models import decoder as jdec
from conformer_tpu.models import layers as jl
from conformer_tpu.models.position import relative_positional_encoding as j_pe
from conformer_tpu.ops import ctc as jctc
from conformer_tpu.ops.rel_shift import rel_shift as j_rel_shift
from conformer_tpu.utils import masking as jm
from conformer_tpu_torch.convert import block_part_to_state_dict
from conformer_tpu_torch.models import decoder as tdec
from conformer_tpu_torch.models import layers as tl
from conformer_tpu_torch.models.position import relative_positional_encoding
from conformer_tpu_torch.ops import ctc as tctc
from conformer_tpu_torch.ops.rel_shift import rel_shift, rel_shift_reference
from conformer_tpu_torch.utils import masking as tm

TOL = dict(atol=1e-5, rtol=1e-5)


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _perturb(tree, seed):
    """Non-trivial weights: init values plus noise on every leaf."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), tree)


def _stats(features, seed):
    rng = np.random.default_rng(seed)
    return {"mean": rng.uniform(-0.5, 0.5, features).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, features).astype(np.float32)}


def test_activations():
    x = _x(3, 8)
    np.testing.assert_allclose(tl.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.swish(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(tl.glu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.glu(jnp.asarray(x))), **TOL)


def test_feed_forward_matches_flax():
    x = _x(2, 11, 32)
    m = jl.FeedForwardModule(32)
    params = _perturb(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    want = m.apply({"params": params}, jnp.asarray(x))
    t = tl.FeedForwardModule(32)
    t.load_state_dict(block_part_to_state_dict({"params": params}, "ffn1"))
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("use_mask", [True, False])
def test_masked_batch_norm_both_paths_match_flax(use_mask):
    x = _x(3, 10, 16)
    mask = np.arange(10)[None, :] < np.array([10, 6, 1])[:, None]
    m = jl.MaskedBatchNorm(16)
    jmask = jnp.asarray(mask) if use_mask else None
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x), jmask, True)
    params = _perturb(v["params"], 2)
    stats = _stats(16, 3)
    t = tl.MaskedBatchNorm(16)
    t.load_state_dict({"scale": torch.from_numpy(params["scale"]),
                       "bias": torch.from_numpy(params["bias"]),
                       "mean": torch.from_numpy(stats["mean"]),
                       "var": torch.from_numpy(stats["var"])})
    tmask = torch.from_numpy(mask) if use_mask else None
    # running-average path
    want = m.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                   jmask, True)
    t.eval()
    got = t(torch.from_numpy(x), tmask, use_running_average=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # masked-statistics path, with the running-stat update
    want, new = m.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(x), jmask, False, mutable=["batch_stats"])
    t.train()
    got = t(torch.from_numpy(x), tmask, use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(new["batch_stats"][name]), **TOL)


@pytest.mark.parametrize("mask_pad", [True, False])
@pytest.mark.parametrize("training", [False, True])
def test_convolution_module_matches_flax(mask_pad, training):
    x = _x(2, 23, 32)
    mask = np.arange(23)[None, :] < np.array([23, 9])[:, None]
    m = jl.ConvolutionModule(32, 7, mask_pad=mask_pad)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    variables = {"params": _perturb(v["params"], 4),
                 "batch_stats": {"norm": _stats(32, 5)}}
    want, _ = m.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                      deterministic=not training, mutable=["batch_stats"])
    t = tl.ConvolutionModule(32, 7, mask_pad=mask_pad)
    t.load_state_dict(block_part_to_state_dict(variables, "conv"))
    t.train(training)
    with torch.no_grad():
        got = t(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_depthwise_pallas_impl_names_the_missing_kernel():
    """impl='pallas' runs the ported kernel K4a (its plain version on the
    CPU) and matches the flax layer with its Pallas kernel in interpret
    mode: fp32 within 1e-5, bf16 bit for bit; the same weights serve
    impl='xla'. An impl that names no kernel raises."""
    from unittest import mock

    from conformer_tpu.ops.pallas import depthwise_conv as jdc

    x = _x(2, 19, 24)
    orig = jdc.depthwise_conv1d
    for dtype in ("float32", "bfloat16"):
        m = jl.DepthwiseConv1d(24, 7, impl="pallas", dtype=jnp.dtype(dtype))
        with mock.patch.object(jdc, "depthwise_conv1d",
                               lambda x_, w, b, *_: orig(x_, w, b, True, True)):
            params = _perturb(m.init(jax.random.PRNGKey(0),
                                     jnp.asarray(x, dtype))["params"], 9)
            want = m.apply({"params": params}, jnp.asarray(x, dtype))
        state = {"weight": torch.from_numpy(
                     np.array(params["kernel"].transpose(2, 1, 0))),
                 "bias": torch.from_numpy(np.array(params["bias"]))}
        t = tl.DepthwiseConv1d(24, 7, impl="pallas",
                               dtype=getattr(torch, dtype))
        t.load_state_dict(state)
        with torch.no_grad():
            got = t(torch.from_numpy(x)).float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_allclose(got, want, **TOL)
        xla = tl.DepthwiseConv1d(24, 7, impl="xla")
        xla.load_state_dict(state)
        with torch.no_grad():
            np.testing.assert_allclose(xla(torch.from_numpy(x)).numpy(), got,
                                       **TOL)
    with pytest.raises(ValueError, match="conv_impl"):
        tl.DepthwiseConv1d(8, 7, impl="cudnn")


@pytest.mark.parametrize("impl", ["conv2d", "separable"])
def test_subsampling_matches_flax(impl):
    x = _x(2, 41, 80)
    m = jl.ConvolutionSubsampling(16, impl=impl)
    params = _perturb(m.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 6)
    want = m.apply({"params": params}, jnp.asarray(x))
    t = tl.ConvolutionSubsampling(16, impl=impl)
    state = {}
    for name, p in params.items():
        state[f"{name}.weight"] = torch.from_numpy(
            np.array(p["kernel"].transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"]))
    t.load_state_dict(state)
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    assert got.shape == want.shape == (2, ((41 - 1) // 2 - 1) // 2, 16 * 19)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


def test_lstm_decoder_matches_flax():
    x = _x(2, 13, 24)
    mask = np.arange(13)[None, :] < np.array([13, 7])[:, None]
    m = jdec.LSTMDecoder(30, 20, n_layers=2)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    params = _perturb(v["params"], 7)
    stats = {"norm": _stats(20, 8)}
    want = m.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                   jnp.asarray(mask))
    t = tdec.LSTMDecoder(24, 30, 20, n_layers=2).eval()
    state = {"norm.scale": params["norm"]["scale"],
             "norm.bias": params["norm"]["bias"],
             "norm.mean": stats["norm"]["mean"],
             "norm.var": stats["norm"]["var"],
             "classifier.weight": params["classifier"]["kernel"].T,
             "classifier.bias": params["classifier"]["bias"]}
    for i in range(2):
        p = params[f"lstm_{i}"]
        state.update({f"lstm.{i}.weight_ih": p["input_proj"]["kernel"].T,
                      f"lstm.{i}.bias_ih": p["input_proj"]["bias"],
                      f"lstm.{i}.weight_hh": p["recurrent_kernel"].T,
                      f"lstm.{i}.bias_hh": np.zeros(80, np.float32)})
    t.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in state.items()})
    with torch.no_grad():
        got = t(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_position_encoding_and_rel_shift():
    np.testing.assert_array_equal(relative_positional_encoding(9, 16).numpy(),
                                  np.asarray(j_pe(9, 16)))
    s = _x(2, 3, 9, 17)
    np.testing.assert_array_equal(rel_shift(torch.from_numpy(s)).numpy(),
                                  np.asarray(j_rel_shift(jnp.asarray(s))))
    np.testing.assert_array_equal(rel_shift(torch.from_numpy(s)).numpy(),
                                  rel_shift_reference(torch.from_numpy(s)).numpy())


def test_masks_and_lengths():
    lengths = np.array([0, 1, 5, 160, 1601], np.int32)
    assert tm.mel_frame_length(16000, 160) == jm.mel_frame_length(16000, 160)
    np.testing.assert_array_equal(
        tm.subsampled_length(torch.from_numpy(lengths)).numpy(),
        np.asarray(jm.subsampled_length(jnp.asarray(lengths))))
    for n in (0, 1, 7, 2401):
        assert tm.subsampled_length(n) == jm.subsampled_length(n)
    small = np.array([0, 3, 7], np.int32)
    np.testing.assert_array_equal(
        tm.padding_mask(torch.from_numpy(small), 7).numpy(),
        np.asarray(jm.padding_mask(jnp.asarray(small), 7)))
    np.testing.assert_array_equal(
        tm.attention_pad_mask(torch.from_numpy(small), 7).numpy(),
        np.asarray(jm.attention_pad_mask(jnp.asarray(small), 7)))


def test_greedy_collapse_with_unk_and_blank_gaps():
    blank, unk = 0, 9
    ids = np.array([
        [3, 3, 0, 3, 4, 4, 9, 4, 5, 0, 0, 5, 6, 6],    # repeats across gaps
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],    # all blank
        [9, 2, 9, 2, 0, 7, 7, 7, 8, 1, 1, 0, 1, 2],    # unk gaps, length cut
    ], np.int32)
    lengths = np.array([14, 14, 11], np.int32)
    for unk_id in (unk, None):
        want = jctc.greedy_collapse(jnp.asarray(ids), jnp.asarray(lengths),
                                    blank, unk_id)
        got = tctc.greedy_collapse(torch.from_numpy(ids),
                                   torch.from_numpy(lengths), blank, unk_id)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 20, 12)).astype(np.float32)
    want = jctc.greedy_decode(jnp.asarray(logits), None, 0, unk)
    got = tctc.greedy_decode(torch.from_numpy(logits), None, 0, unk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
