"""The port's depthwise conv (K4a/K4b and their autograd Function) against
the JAX package's Pallas kernel run in interpret mode on the CPU.

- the plain K4a against ``depthwise_conv1d(x, w, b, True, True)`` at the
  shapes of tests/test_pallas.py: fp32 within 1e-5 (XLA may contract a tap's
  product and add into one FMA), bf16 bit for bit (both round after every
  product and every add);
- dx, dw and db of the autograd Function against ``jax.grad`` through the
  interpret path at 1e-4, and the bf16 weight gradient rounded as the JAX
  ``.astype(w.dtype)`` rounds it;
- even K: the port's dx is the exact gradient, the JAX Pallas dx is not;
- the tiny Conformer with ``conv_impl="pallas"``: logits (1e-4) and one fp32
  train step (loss and grad norm to 1e-5 relative) against the JAX model on
  the same converted weights.
"""

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.ops.pallas import depthwise_conv as jdc
from conformer_tpu.train.state import TrainState
from conformer_tpu.train.state import make_optimizer as j_make_optimizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu.train.steps import make_forward as j_make_forward
from conformer_tpu.train.steps import make_train_step as j_make_train_step
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
from conformer_tpu_torch.train.state import make_optimizer
from conformer_tpu_torch.train.steps import make_forward, make_train_step

VOCAB = 370
SHAPES = [((2, 64, 32), 7), ((1, 100, 16), 31), ((3, 50, 8), 3)]


def _case(shape, k, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal((k, shape[2])).astype(np.float32),
            rng.standard_normal((shape[2],)).astype(np.float32))


@contextlib.contextmanager
def jax_pallas_interpret():
    """The JAX DepthwiseConv1d calls depthwise_conv1d(x, w, b, True), which
    on the CPU silently takes XLA; route it, forward and backward, through
    the Pallas kernels in interpret mode."""
    orig = jdc.depthwise_conv1d
    with mock.patch.object(jdc, "depthwise_conv1d",
                           lambda x, w, b, *_: orig(x, w, b, True, True)):
        yield


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,k", SHAPES)
def test_plain_forward_matches_the_pallas_kernel(shape, k, dtype):
    x, w, b = _case(shape, k)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jdc.depthwise_conv1d(
        *(jnp.asarray(a, jdt) for a in (x, w, b)), True, True)
        .astype(jnp.float32))
    got = dc.depthwise_conv_fwd(*(torch.from_numpy(a).to(tdt)
                                  for a in (x, w, b)), (k - 1) // 2)
    assert got.dtype == tdt and tuple(got.shape) == shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _torch_grads(x, w, b, dtype=torch.float32):
    xt, wt, bt = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (x, w, b))
    torch.sin(dc.depthwise_conv1d(xt, wt, bt).float()).sum().backward()
    return xt.grad, wt.grad, bt.grad


def _jax_grads(x, w, b, dtype=jnp.float32):
    loss = lambda x_, w_, b_: jnp.sum(jnp.sin(
        jdc.depthwise_conv1d(x_, w_, b_, True, True).astype(jnp.float32)))
    return jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (x, w, b)))


@pytest.mark.parametrize("shape,k", SHAPES)
def test_gradients_match_jax_through_the_pallas_kernels(shape, k):
    x, w, b = _case(shape, k, seed=1)
    for got, want, name in zip(_torch_grads(x, w, b), _jax_grads(x, w, b),
                               ("dx", "dw", "db")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_bf16_gradients_round_as_the_jax_kernels_do():
    """bf16: dx is K4a on g (bit for bit, like the forward) and dw is the
    fp32 sum rounded once to bf16, as ``_pallas_dw(...).astype(w.dtype)``;
    the two fp32 sums may differ in their last bits, so dw is held to one
    bf16 ulp of its value."""
    x, w, b = _case((2, 40, 16), 7, seed=2)
    got = _torch_grads(x, w, b, torch.bfloat16)
    want = [np.asarray(g.astype(jnp.float32))
            for g in _jax_grads(x, w, b, jnp.bfloat16)]
    assert all(g.dtype == torch.bfloat16 for g in got)
    np.testing.assert_array_equal(got[0].float().numpy(), want[0])
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[1]) + 1e-30)) - 7)
    assert np.all(np.abs(got[1].float().numpy() - want[1]) <= ulp)


def test_even_kernel_size_dx_is_exact_where_the_jax_pallas_dx_is_not():
    """At K = 4 the JAX ``_bwd`` convolves g with the flipped taps under the
    forward's left pad (1), where the exact gradient needs K - 1 - pad = 2
    (ROADMAP.md, faults in the JAX package). The port's dx agrees with
    autograd through the plain per-tap loop and with JAX's gradient through
    XLA; the JAX Pallas dx does not."""
    x, w, b = _case((2, 30, 8), 4, seed=3)
    got = _torch_grads(x, w, b)[0].numpy()
    xt = torch.from_numpy(x).requires_grad_(True)
    torch.sin(dc.depthwise_conv_plain(xt, torch.from_numpy(w),
                                      torch.from_numpy(b), 1)).sum().backward()
    np.testing.assert_allclose(got, xt.grad.numpy(), atol=1e-5, rtol=1e-5)
    exact = jax.grad(lambda x_: jnp.sum(jnp.sin(jdc._xla_depthwise(
        x_, jnp.asarray(w), jnp.asarray(b)))))(jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(exact), atol=1e-4, rtol=1e-4)
    pallas_dx = np.asarray(_jax_grads(x, w, b)[0])
    assert np.abs(pallas_dx - np.asarray(exact)).max() > 0.1


# ---------------------------------------------------------------------------
# The tiny model with conv_impl="pallas"
# ---------------------------------------------------------------------------

LR = 1e-3


def _configs():
    over = {"model.conv_impl": "pallas", "optim.compute_dtype": "float32",
            "augment.enabled": False, "optim.learning_rate": LR,
            "optim.grad_clip_norm": 5.0, "optim.eps": 1e-3,
            "model.use_scan_layers": True}
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(**over)
    return jcfg, Config.from_dict(jcfg.to_dict())


@functools.lru_cache(maxsize=None)
def _variables():
    jcfg, _ = _configs()
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(5)))


def _batch():
    rng = np.random.default_rng(8)
    audio = (rng.standard_normal((3, 12800)) * 0.1).astype(np.float32)
    audio_lengths = np.array([12800, 9000, 12800], np.int32)
    audio[1, 9000:] = 0.0
    token_lengths = np.array([7, 4, 5], np.int32)
    tokens = rng.integers(1, VOCAB, (3, 8)).astype(np.int32)
    tokens[np.arange(8)[None] >= token_lengths[:, None]] = 0
    return audio, audio_lengths, tokens, token_lengths


def _port_model(tcfg):
    model = Conformer(tcfg.model, "float32")
    model.load_state_dict(flax_to_state_dict(_variables(), tcfg.model))
    return model


def test_tiny_model_with_pallas_conv_matches_jax_logits():
    jcfg, tcfg = _configs()
    audio, lengths = _batch()[:2]
    with jax_pallas_interpret():
        j_logits, j_len = jax.jit(j_make_forward(jcfg))(
            _variables(), jnp.asarray(audio), jnp.asarray(lengths))
    model = _port_model(tcfg).eval()
    assert model.encoder.blocks[0].conv.depthwise.impl == "pallas"
    t_logits, t_len = make_forward(tcfg, model)(torch.from_numpy(audio),
                                                torch.from_numpy(lengths))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)


def test_tiny_model_with_pallas_conv_train_step_matches_jax():
    """One fp32 train step (dropout 0, SpecAugment off), JAX's depthwise
    conv forward and backward through its Pallas kernels in interpret mode:
    loss and grad norm to 1e-5 relative, as tests/test_torch_train.py."""
    jcfg, tcfg = _configs()
    variables = _variables()
    tx = j_make_optimizer(jcfg.optim)
    state = TrainState.create(variables["params"], variables["batch_stats"], tx)
    batch = _batch()
    with jax_pallas_interpret():
        _, j_metrics = j_make_train_step(jcfg, tx, donate=False)(
            state, *(jnp.asarray(a) for a in batch), jax.random.PRNGKey(0))
    model = _port_model(tcfg)
    opt = make_optimizer(tcfg.optim, model.parameters())
    metrics = make_train_step(tcfg, model, opt)(
        *(torch.from_numpy(a) for a in batch), 0)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(j_metrics["grad_norm"]), rtol=1e-5)
