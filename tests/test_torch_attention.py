"""Kernel K1's plain version and the port's attention modules against the
JAX package on the CPU.

K1: ``sincos_attention_fwd`` (its plain version on CPU tensors) against
``rel_attention_sincos_packed(..., interpret=True)``, the Pallas kernel run
in interpret mode, at H = 2, dh = 64, with key lengths full, partial and 0;
atol 2e-5, the forward tolerance tests/test_pallas.py uses; with dropout,
the same at the JAX kernel's tile rows. K2: the plain backward against
``jax.vjp`` of the same call, atol 1e-5. Modules: both attention impls
against flax with the same weights, outputs and parameter gradients, atol
1e-5 (fp32)."""

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
from torch_threads import one_torch_thread  # noqa: F401


def _inputs(b, l, h, dh, seed):
    rng = np.random.default_rng(seed)
    d = h * dh
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)
    qu, qv, k, v = (mk(b, l, d) for _ in range(4))
    kernel = (mk(d, d) / np.sqrt(d)).astype(np.float32)
    return qu, qv, k, v, kernel


@pytest.mark.parametrize("l,tq,lengths", [
    (37, 16, [37, 20, 0]),
    (150, None, [150, 0, 93]),
    # across the card kernel's 128-row query and 64-key tiles; rows of
    # length 0 (uniform weights) and 1
    (129, None, [1, 0]),
    (257, None, [0, 1]),
])
def test_kernel_plain_version_matches_pallas_interpret(l, tq, lengths):
    h, dh = 2, 64
    qu, qv, k, v, kernel = _inputs(len(lengths), l, h, dh, seed=l)
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


def _packed_call(rate, tq, lengths, qu, qv, k, v, kernel, h, scale):
    """(JAX output, its vjp) of the Pallas kernels in interpret mode."""
    def f(qu, qv, k, v, wh):
        return jsa.rel_attention_sincos_packed(
            qu, qv, k, v, wh, jnp.asarray(lengths), scale, rate,
            jnp.int32(7), tq=tq, interpret=True)
    wh = jsa.prep_pos_kernel(jnp.asarray(kernel), h)
    return jax.vjp(f, *(jnp.asarray(x) for x in (qu, qv, k, v)), wh)


@pytest.mark.parametrize("b,l,h,dh,tq,lengths", [
    (3, 50, 2, 64, 32, [50, 20, 0]),        # partial last tile of 32 rows
    (3, 50, 2, 64, None, [50, 20, 0]),      # auto tile: one of 56 rows
    (1, 300, 2, 16, None, [300]),           # L > 256: auto tiles of 128
    (2, 129, 2, 64, None, [1, 0]),          # rows of length 1 and 0
    (2, 257, 2, 64, None, [0, 1]),
])
def test_plain_forward_with_dropout_matches_pallas_interpret(b, l, h, dh, tq,
                                                             lengths):
    qu, qv, k, v, kernel = _inputs(b, l, h, dh, seed=l)
    scale = 1.0 / np.sqrt(dh)
    want, _ = _packed_call(0.3, tq, np.array(lengths, np.int32), qu, qv, k, v,
                           kernel, h, scale)
    t = torch.from_numpy
    got = tsa.rel_attention_sincos_packed(
        t(qu), t(qv), t(k), t(v), tsa.prep_pos_kernel(t(kernel), h),
        t(np.array(lengths, np.int32)), scale, dropout_rate=0.3, seed=7, tq=tq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("l,h,lengths,tq", [
    (50, 2, [50, 20, 0], 32),
    # past 768, the longest L the card's bf16 backward once took at H 8
    (800, 1, [731], 128),
])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_backward_matches_jax_vjp(rate, l, h, lengths, tq):
    """The autograd Function's plain path (plain forward, plain backward)
    against jax.vjp of the interpret-mode kernels, including the gradient
    of the (D, D) position kernel through prep_pos_kernel; atol 1e-5 as
    tests/test_pallas.py::test_fused_backward_parity."""
    dh = 64
    lengths = np.array(lengths, np.int32)
    qu, qv, k, v, kernel = _inputs(len(lengths), l, h, dh, seed=11)
    g = np.random.default_rng(12).standard_normal(qu.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    _, vjp = _packed_call(rate, tq, lengths, qu, qv, k, v, kernel, h, scale)
    jgrads = vjp(jnp.asarray(g))
    j_kernel = jax.vjp(lambda K: jsa.prep_pos_kernel(K, h),
                       jnp.asarray(kernel))[1](jgrads[4])[0]
    ts = [torch.tensor(x, requires_grad=True) for x in (qu, qv, k, v, kernel)]
    before = launch_counts()
    out = tsa.rel_attention_sincos_packed(
        *ts[:4], tsa.prep_pos_kernel(ts[4], h), torch.from_numpy(lengths),
        scale, dropout_rate=rate, seed=7, tq=tq)
    (out * torch.from_numpy(g)).sum().backward()
    assert launch_counts() == before                   # CPU: no launch
    for got, want in zip(ts, [*jgrads[:4], j_kernel]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want),
                                   atol=1e-5)


def test_inference_takes_the_forward_only():
    """Without autograd (serving) no row statistics are made and no
    backward is recorded; the result equals the autograd path's."""
    qu, qv, k, v, kernel = (torch.from_numpy(x) for x in _inputs(1, 8, 2, 64, 0))
    wh = tsa.prep_pos_kernel(kernel, 2)
    with torch.inference_mode():
        served = tsa.rel_attention_sincos_packed(qu, qv, k, v, wh, None, 0.125)
    assert served.grad_fn is None
    trained = tsa.rel_attention_sincos_packed(qu.requires_grad_(), qv, k, v,
                                              wh, None, 0.125)
    assert type(trained.grad_fn).__name__ == "SincosAttentionBackward"
    np.testing.assert_array_equal(served.numpy(), trained.detach().numpy())


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


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_attention_module_gradients_match_flax(impl):
    """Every parameter's gradient, the position kernel's (through the
    kernel path's prep_pos_kernel) included; the position bias, which the
    kernel path does not read, gets none here and a zero one in JAX (the
    optimizer fills it with zeros, train/state.py)."""
    b, l, d, h = 2, 29, 128, 2
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    g = rng.standard_normal((b, l, d)).astype(np.float32)
    pos = relative_positional_encoding(l, d)
    mask = attention_pad_mask(jnp.asarray(np.array([29, 11], np.int32)), l)
    m = jattn.RelativeMultiHeadAttention(d, h, 0.0, jnp.float32, impl)
    variables, _ = _flax_attention(jattn.RelativeMultiHeadAttention, impl, d,
                                   h, jnp.asarray(x), pos, mask, seed=6)
    jgrads = jax.grad(lambda p: jnp.sum(m.apply({"params": p}, jnp.asarray(x),
                                                pos, mask) * g))(
        variables["params"])
    tmod = tattn.RelativeMultiHeadAttention(d, h, impl=impl)
    tmod.load_state_dict(block_part_to_state_dict(variables, "mhsa/attention"))
    tpos = torch.from_numpy(np.asarray(pos)) if impl == "xla" else None
    out = tmod(torch.from_numpy(x), tpos, torch.from_numpy(np.array(mask)))
    (out * torch.from_numpy(g)).sum().backward()
    want = block_part_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, jgrads)}, "mhsa/attention")
    for name, p in tmod.named_parameters():
        if p.grad is None:
            assert impl == "pallas" and name == "pos.bias"
            assert not want[name].any()
            continue
        # 1e-5 of the gradient's own scale: they reach ~20 here, and fp32
        # sums over B*L rows are taken in another order
        scale = max(1.0, float(want[name].abs().max()))
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5 * scale, rtol=1e-5, err_msg=name)


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


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("h,dh", [(3, 16), (4, 32), (3, 64), (4, 36)])
def test_plain_versions_match_pallas_interpret_at_every_head_shape(h, dh,
                                                                   rate):
    """The shapes the general kernels take on the card (odd head counts,
    head widths other than 64, D/2 not a multiple of 64, and Conformer-S's
    (4, 36), whose head width and D/2 are not multiples of 16 bytes in
    bf16; the JAX wrapper takes it through its per-head layout): the plain forward
    against the interpret-mode kernels (atol 2e-5) and the autograd
    Function's plain backward against their jax.vjp (atol 1e-5), with a
    ragged row and a row of length 0."""
    lengths = np.array([45, 17, 0], np.int32)
    l = 45
    qu, qv, k, v, kernel = _inputs(len(lengths), l, h, dh, seed=h * dh)
    g = np.random.default_rng(dh).standard_normal(qu.shape).astype(np.float32)
    scale = 1.0 / np.sqrt(dh)
    want, vjp = _packed_call(rate, 16, lengths, qu, qv, k, v, kernel, h, scale)
    jgrads = vjp(jnp.asarray(g))
    j_kernel = jax.vjp(lambda K: jsa.prep_pos_kernel(K, h),
                       jnp.asarray(kernel))[1](jgrads[4])[0]
    ts = [torch.tensor(x, requires_grad=True) for x in (qu, qv, k, v, kernel)]
    out = tsa.rel_attention_sincos_packed(
        *ts[:4], tsa.prep_pos_kernel(ts[4], h), torch.from_numpy(lengths),
        scale, dropout_rate=rate, seed=7, tq=16)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=2e-5)
    (out * torch.from_numpy(g)).sum().backward()
    for got, want_g in zip(ts, [*jgrads[:4], j_kernel]):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want_g),
                                   atol=1e-5)


@pytest.mark.parametrize("dtype,h,dh,want", [
    (torch.bfloat16, 8, 64, "wgmma"),     # production width, D 512
    (torch.bfloat16, 4, 64, "wgmma"),     # ModelConfig.small, D 256
    (torch.bfloat16, 2, 64, "wgmma"),
    (torch.bfloat16, 2, 32, "general"),   # ModelConfig.tiny
    (torch.bfloat16, 3, 16, "general"),
    (torch.bfloat16, 4, 32, "general"),
    (torch.bfloat16, 3, 64, "general"),   # D/2 = 96
    (torch.bfloat16, 12, 64, "general"),  # D 768 > 512
    (torch.bfloat16, 2, 128, "general"),
    (torch.bfloat16, 5, 24, "general"),   # a dh below its padded width
    (torch.bfloat16, 4, 36, "general"),   # Conformer-S, D 144
    (torch.float32, 4, 36, "general"),
    (torch.float32, 8, 64, "general"),
    (torch.float32, 3, 16, "general"),
])
def test_attention_variant_picks_a_kernel_for_every_shape(dtype, h, dh, want):
    """On the card every shape the JAX kernels take goes to one of the two
    kernels, never to the plain version; the selector is a pure function."""
    assert tsa.attention_variant(dtype, h, dh, h * dh) == want
    assert want in tsa.VARIANTS


@pytest.mark.parametrize("dtype,h,dh,d", [
    (torch.float16, 8, 64, 512),    # no kernel for fp16
    (torch.bfloat16, 2, 192, 384),  # past the general kernels' 128
    (torch.bfloat16, 3, 33, 99),    # odd D: the sin/cos halves differ
    (torch.float32, 2, 32, 128),    # H * dh != D
])
def test_attention_variant_refuses_shapes_no_kernel_takes(dtype, h, dh, d):
    with pytest.raises(ValueError):
        tsa.attention_variant(dtype, h, dh, d)


def test_cuda_tensors_never_reach_the_plain_version():
    """The wrappers reach the plain versions only through the CPU branch:
    with the plain versions replaced by a function that fails, a meta tensor
    (neither CPU nor CUDA) raises the wrappers' own device error."""
    qu = torch.empty(1, 4, 64, device="meta")
    wh = torch.empty(2, 32, 64, device="meta")
    lengths = torch.empty(1, dtype=torch.int32, device="meta")
    sin_t = cos_t = torch.empty(4, 32, device="meta")
    boom = lambda *a, **k: pytest.fail("the plain version was called")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsa, "sincos_attention_plain", boom)
        mp.setattr(tsa, "sincos_attention_bwd_plain", boom)
        with pytest.raises(ValueError, match="no kernel for device"):
            tsa.sincos_attention_fwd(qu, qu, qu, qu, wh, lengths, sin_t, cos_t)
        with pytest.raises(ValueError, match="no kernel for device"):
            tsa.sincos_attention_bwd(qu, qu, qu, qu, wh, lengths, sin_t, cos_t,
                                     None, qu)


@pytest.mark.parametrize("dtype,h,dh,b,l,want", [
    # fp32 at production width: the 64-row query tile (147 KB) fits, with a
    # 4-stage ring in the forward and a 3-stage one beside dO's tile
    (torch.float32, 8, 64, 8, 599,
     dict(dhp=64, d2p=256, vec_bytes=16, chunks=9, fwd_rows=64,
          fwd_stages=4, bwd_rows=64, bwd_stages=3, dwh_splits=1)),
    # ModelConfig.tiny: 160 CTAs of 64 rows; the dwh pass splits each batch
    # row into 10 row tiles to fill the card
    (torch.bfloat16, 2, 32, 8, 599,
     dict(dhp=32, d2p=32, vec_bytes=16, chunks=3, fwd_rows=64, bwd_rows=64,
          dwh_splits=10)),
    # Conformer-S: dh 36 and D/2 72 pad to 48 and 80; 72-byte head columns
    # take 8-byte copies in bf16, 144-byte ones 16-byte copies in fp32; 12
    # (batch row, head) pairs at L 199 cut the query tile to 16 rows
    (torch.bfloat16, 4, 36, 3, 199,
     dict(dhp=48, d2p=80, vec_bytes=8, chunks=5, fwd_rows=16, bwd_rows=16,
          dwh_splits=4)),
    (torch.float32, 4, 36, 3, 199,
     dict(dhp=48, d2p=80, vec_bytes=16, chunks=5, fwd_rows=16, bwd_rows=16,
          dwh_splits=4)),
    # D 768 in bf16: 13 score chunks, 144 CTAs of 64 rows
    (torch.bfloat16, 12, 64, 3, 199,
     dict(dhp=64, d2p=384, vec_bytes=16, chunks=13, fwd_rows=64,
          bwd_rows=64, dwh_splits=1)),
    # D/2 = 51 bf16 values is 102 bytes: 2-byte copies
    (torch.bfloat16, 3, 34, 2, 50,
     dict(dhp=48, d2p=64, vec_bytes=2, chunks=3, fwd_rows=16, bwd_rows=16,
          dwh_splits=1)),
    # fp32 at dh 128, D 1024: the query tile fits only at 16 rows
    (torch.float32, 8, 128, 8, 599,
     dict(dhp=128, d2p=512, vec_bytes=16, chunks=18, fwd_rows=16,
          bwd_rows=16, dwh_splits=1)),
    # D 8192 in fp32: no query tile fits in shared memory
    (torch.float32, 64, 128, 1, 50,
     dict(fwd_rows=0, bwd_rows=0)),
])
def test_general_geometry_by_shape(dtype, h, dh, b, l, want):
    """The general kernels' tiling, the host's copy of the sources' own
    (chip_smoke.py holds it against the built library): padded widths, the
    copy width, the query rows (the most of 64, 32, 16 that fit in shared
    memory, halved while the grid has fewer CTAs than SMs) and the ring
    stages (4 where they fit, else 3)."""
    geo = tsa.general_geometry(dtype, b, l, h, dh)
    assert {k: geo[k] for k in want} == want
    for rows, smem in ((geo["fwd_rows"], geo["fwd_smem"]),
                       (geo["bwd_rows"], geo["bwd_smem"])):
        assert (smem <= tsa.GENERAL_SMEM_LIMIT) if rows else smem == 0


@pytest.mark.parametrize("dtype,h,dh,b,l,want", [
    # ds and p_drop (B*H, L, 600) in fp32, da (B*H, L, 512) in fp32 and
    # the dwh partials (B, H, 64, 512) in fp32: 271 MB (the earlier
    # design's alpha | beta, ds, p_drop and two (B*H, L, D) buffers, all
    # fp32, were 420 MB)
    (torch.float32, 8, 64, 8, 599,
     2 * 64 * 599 * 600 * 4 + 64 * 599 * 512 * 4 + 8 * 8 * 64 * 512 * 4),
    # bf16: ds, p_drop and da in bf16, only the partials in fp32
    (torch.bfloat16, 2, 32, 8, 599,
     2 * 16 * 599 * 600 * 2 + 16 * 599 * 64 * 2 + 80 * 2 * 32 * 64 * 4),
])
def test_general_backward_scratch_bytes(dtype, h, dh, b, l, want):
    assert tsa.bwd_scratch_bytes(b, l, h, dh, dtype) == want
    assert tsa.general_geometry(dtype, b, l, h, dh)["bwd_scratch"] == want


def test_3xtf32_scores_and_values_hold_the_fp32_limit():
    """The general kernels' fp32 products in 3xTF32, emulated in float64
    at B 1, L 599, H 8, dh 64: the scores over the 576-deep
    [qu | alpha | beta] . [k | cos | sin] and P . V with P split the same
    way hold the output to 1e-4 of float64's (the fp32 limit of the card's
    check), with the kernels' truncating split (``split_tf32_trunc``) and
    with K3's rounded one (the port's ``split_tf32``), where one TF32
    product alone does not."""
    from conformer_tpu_torch.ops.cuda.mel_frontend import split_tf32

    h, dh, l = 8, 64, 599
    d = h * dh
    qu, qv, k, v, kernel = _inputs(1, l, h, dh, seed=599)
    scale = np.float32(1.0 / np.sqrt(dh))
    qu, qv = qu * scale, qv * scale
    wh = tsa.prep_pos_kernel(torch.from_numpy(kernel), h).numpy()
    sin_t, cos_t = (x.numpy() for x in tsa.sincos_tables(l, d))
    split = lambda x: x.reshape(l, h, dh).transpose(1, 0, 2)
    a = np.einsum("hld,hdx->hlx", split(qv[0]), wh).astype(np.float32)
    a_s, a_c = a[..., :d // 2], a[..., d // 2:]
    alpha = a_s * sin_t + a_c * cos_t
    beta = -a_s * cos_t + a_c * sin_t
    q_aug = np.concatenate([split(qu[0]), alpha, beta], -1)
    k_aug = np.concatenate([split(k[0]), np.broadcast_to(cos_t, (h, l, d // 2)),
                            np.broadcast_to(sin_t, (h, l, d // 2))], -1)
    f64 = lambda x: np.asarray(x, np.float64)

    def product(x, y, splitter, terms):
        (xh, xl), (yh, yl) = splitter(x), splitter(y)
        out = f64(xh) @ f64(yh)
        if terms == 3:
            out += f64(xh) @ f64(yl) + f64(xl) @ f64(yh)
        return out

    def attention(splitter, terms):
        s = product(q_aug, k_aug.transpose(0, 2, 1), splitter, terms)
        s = s.astype(np.float32).astype(np.float64)    # fp32 scores
        e = np.exp(s - s.max(-1, keepdims=True))
        p = e.astype(np.float32)
        return (product(p, split(v[0]), splitter, terms)
                / e.sum(-1, keepdims=True))

    s = f64(q_aug) @ f64(k_aug).transpose(0, 2, 1)
    e = np.exp(s - s.max(-1, keepdims=True))
    want = (e @ f64(split(v[0]))) / e.sum(-1, keepdims=True)
    for splitter in (tsa.split_tf32_trunc, split_tf32):
        assert np.abs(attention(splitter, 3) - want).max() <= 1e-4
        assert np.abs(attention(splitter, 1) - want).max() > 1e-4


def test_truncating_tf32_split_holds_each_value_to_2_pow_minus_20():
    """The general kernels' split: hi and lo (as the tensor cores read it)
    are TF32 values, hi is x truncated, and hi + lo holds x to 2^-20 of
    it."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x = np.concatenate([x, x * np.float32(1e-30), x * np.float32(1e30)])
    hi, lo = tsa.split_tf32_trunc(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    assert (np.abs(hi) <= np.abs(x)).all()
    err = np.abs(hi.astype(np.float64) + lo - x)
    assert (err <= np.abs(x) * 2.0 ** -20).all()
