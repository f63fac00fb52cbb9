"""The port's hash dropout against the JAX package, bit for bit.

``models/dropout.py::hash_keep`` against ``conformer_tpu.models.dropout.
hash_keep`` (3-D and 4-D shapes, seed words of length 2 and 4, rates 0.1
and 0.5); the attention kernel's mask, ``ops/cuda/sincos_attention.py::
dropout_keep``, against ``_dropout_keep`` tile by tile; and the ``Dropout``
module's scaling against the JAX module's formula on the same mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.models import dropout as jd
from conformer_tpu.ops.pallas import sincos_attention as jsa
from conformer_tpu_torch.models import dropout as td
from conformer_tpu_torch.ops.cuda import sincos_attention as tsa
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("words", [(1, 2), (0xFFFFFFFF, 7, 9, 123456789)])
@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 3, 4, 33)])
def test_hash_keep_is_the_jax_mask(shape, words, rate):
    want = np.asarray(jd.hash_keep(shape, jnp.asarray(np.array(words, np.uint32)),
                                   rate))
    got = td.hash_keep(shape, words, rate).numpy()
    np.testing.assert_array_equal(got, want)
    assert abs(got.mean() - (1 - rate)) < 0.15


@pytest.mark.parametrize("seed,b,h,qi,tq,l", [(7, 0, 0, 0, 32, 50),
                                              (-5, 2, 1, 1, 32, 50),
                                              (2 ** 31 - 1, 1, 7, 3, 128, 599),
                                              (123456, 3, 2, 0, 200, 199)])
def test_attention_keep_mask_is_the_jax_kernels_tile_by_tile(seed, b, h, qi,
                                                            tq, l):
    want = np.asarray(jsa._dropout_keep(jnp.int32(seed), b, h, qi, (tq, l),
                                        0.3))
    rows = min((qi + 1) * tq, l)
    got = tsa.dropout_keep(seed, b + 1, h + 1, rows, l, tq, 0.3)
    # rows past L of a partial last tile exist only in the JAX tile
    np.testing.assert_array_equal(got[b, h, qi * tq:].numpy(),
                                  want[:rows - qi * tq])


def test_hash_tq_follows_the_jax_tile_rows():
    assert [tsa.hash_tq(l) for l in (50, 199, 256, 257, 599)] == \
        [56, 200, 256, 128, 128]
    assert tsa.hash_tq(50, 32) == 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_scales_kept_elements_and_zeroes_the_rest(dtype):
    rate, words = 0.1, (11, 22)
    x = torch.randn(4, 9, 16, generator=torch.Generator().manual_seed(0)).to(dtype)
    drop = td.Dropout(rate)
    assert torch.equal(drop(x, None), x)                 # no seed: identity
    got = drop(x, words)
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16
                     else jnp.float32)
    keep = jd.hash_keep(x.shape, jnp.asarray(np.array(words, np.uint32)), rate)
    want = jnp.where(keep, jx * jnp.asarray(1.0 / (1.0 - rate), jx.dtype),
                     jnp.zeros((), jx.dtype))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    with pytest.raises(ValueError):
        td.Dropout(0.1, "nope")
