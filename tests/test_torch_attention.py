"""Kernel K1's plain version and the port's attention modules against the
JAX package on the CPU.

K1: ``sincos_attention_fwd`` (its plain version on CPU tensors) against
``rel_attention_sincos_packed(..., interpret=True)``, the Pallas kernel run
in interpret mode, at H = 2, dh = 64, with key lengths full, partial and 0;
atol 2e-5, the forward tolerance tests/test_pallas.py uses. Modules: both
attention impls against flax with the same weights, atol 1e-5 (fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.models import attention as jattn
from conformer_tpu.models.position import relative_positional_encoding
from conformer_tpu.ops.pallas import sincos_attention as jsa
from conformer_tpu.utils.masking import attention_pad_mask
from conformer_tpu_torch.convert import block_part_to_state_dict
from conformer_tpu_torch.models import attention as tattn
from conformer_tpu_torch.ops.cuda import launch_counts
from conformer_tpu_torch.ops.cuda import sincos_attention as tsa


def _inputs(b, l, h, dh, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    qu, qv, k, v = (mk(b, l, d) for _ in range(4))
    kernel = (mk(d, d) / np.sqrt(d)).astype(np.float32)
    return qu, qv, k, v, kernel


@pytest.mark.parametrize("l,tq,lengths", [(37, 16, [37, 20, 0]),
                                          (150, None, [150, 0, 93])])
def test_kernel_plain_version_matches_pallas_interpret(l, tq, lengths):
    h, dh = 2, 64
    qu, qv, k, v, kernel = _inputs(3, l, h, dh, seed=l)
    lengths = np.array(lengths, np.int32)
    scale = 1.0 / np.sqrt(dh)
    want = jsa.rel_attention_sincos_packed(
        *(jnp.asarray(x) for x in (qu, qv, k, v)),
        jsa.prep_pos_kernel(jnp.asarray(kernel), h), jnp.asarray(lengths),
        scale, tq=tq, interpret=True)
    t = torch.from_numpy
    before = launch_counts()["sincos_attention_fwd"]
    got = tsa.rel_attention_sincos_packed(
        t(qu), t(qv), t(k), t(v), tsa.prep_pos_kernel(t(kernel), h),
        t(lengths), scale)
    assert launch_counts()["sincos_attention_fwd"] == before   # CPU: no launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_tables_and_pos_kernel_layout_match():
    for ours, theirs in zip(tsa.sincos_tables(50, 128),
                            jsa.sincos_tables(50, 128)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    kernel = _inputs(1, 1, 4, 32, 0)[4]
    np.testing.assert_array_equal(
        tsa.prep_pos_kernel(torch.from_numpy(kernel), 4).numpy(),
        np.asarray(jsa.prep_pos_kernel(jnp.asarray(kernel), 4)))


def test_plain_version_bf16_rounds_like_the_jax_reference_math():
    """In bf16 the plain version rounds alpha/beta and the probabilities
    where the Pallas kernel does; held against the interpret-mode kernel at
    bf16's resolution (2 ulp at |x| < 2, atol 1.6e-2)."""
    h, dh, l = 2, 64, 40
    qu, qv, k, v, kernel = _inputs(2, l, h, dh, seed=7)
    lengths = np.array([40, 11], np.int32)
    bf = jnp.bfloat16
    want = jsa.rel_attention_sincos_packed(
        *(jnp.asarray(x, bf) for x in (qu, qv, k, v)),
        jsa.prep_pos_kernel(jnp.asarray(kernel, bf), h), jnp.asarray(lengths),
        1.0 / np.sqrt(dh), tq=16, interpret=True)
    t = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    got = tsa.rel_attention_sincos_packed(
        t(qu), t(qv), t(k), t(v), tsa.prep_pos_kernel(t(kernel), h),
        torch.from_numpy(lengths), 1.0 / np.sqrt(dh))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1.6e-2)


def test_dropout_is_refused_until_the_backward_kernel_lands():
    qu, qv, k, v, kernel = (torch.from_numpy(x)
                            for x in _inputs(1, 8, 2, 64, 0))
    with pytest.raises(NotImplementedError):
        tsa.rel_attention_sincos_packed(qu, qv, k, v,
                                        tsa.prep_pos_kernel(kernel, 2), None,
                                        0.125, dropout_rate=0.1)


def _flax_attention(module_cls, impl, d, h, x, pos, mask, seed):
    m = module_cls(d, h, 0.0, jnp.float32, impl)
    variables = m.init(jax.random.PRNGKey(seed), x, pos, mask)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    rng = np.random.default_rng(seed)
    # non-zero biases everywhere, so every parameter is exercised
    params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        params)
    out = m.apply({"params": params}, x, pos, mask)
    return {"params": params}, np.asarray(out)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("module", ["attention", "mhsa"])
def test_attention_modules_match_flax(impl, module):
    b, l, d, h = 2, 29, 128, 2
    rng = np.random.default_rng(1)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    lengths = np.array([29, 17], np.int32)
    pos = relative_positional_encoding(l, d)
    mask = attention_pad_mask(jnp.asarray(lengths), l)
    if module == "attention":
        jcls, part = jattn.RelativeMultiHeadAttention, "mhsa/attention"
        tmod = tattn.RelativeMultiHeadAttention(d, h, impl=impl)
    else:
        jcls, part = jattn.MHSAModule, "mhsa"
        tmod = tattn.MHSAModule(d, h, impl=impl)
    variables, want = _flax_attention(jcls, impl, d, h, jnp.asarray(x), pos,
                                      mask, seed=2)
    tmod.load_state_dict(block_part_to_state_dict(variables, part))
    tmask = torch.from_numpy(np.array(mask))
    tpos = torch.from_numpy(np.asarray(pos)) if impl == "xla" else None
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), tpos, tmask)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_both_impls_agree_in_the_port():
    """The kernel path and the dense rel-shift path compute one function."""
    b, l, d, h = 2, 33, 128, 2
    torch.manual_seed(0)
    x = torch.randn(b, l, d)
    lengths = torch.tensor([33, 5])
    fused = tattn.RelativeMultiHeadAttention(d, h, impl="pallas")
    dense = tattn.RelativeMultiHeadAttention(d, h, impl="xla")
    with torch.no_grad():
        for p in fused.parameters():
            p.normal_(0, 0.1)
        dense.load_state_dict(fused.state_dict())
        pos = torch.from_numpy(np.asarray(relative_positional_encoding(l, d)))
        mask = ~(torch.arange(l)[None, :] < lengths[:, None])[:, None, None, :]
        a = fused(x, None, mask)
        c = dense(x, pos, mask)
    np.testing.assert_allclose(a.numpy(), c.numpy(), atol=2e-5)
