"""The port's per-pass microbenchmark kernel K5 (its plain version on the
CPU) against the JAX tool's Pallas ``_kernel`` run in interpret mode, every
op at rows 8, cols 199, grid 2, n 3 (tools/bench_vpu_pass.py is loaded by
path, as it is a script). Tolerance 1e-5 relative: the exponentials of the
two libraries may differ in the last bit, and the row sums add in another
order."""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from conformer_tpu_torch.ops.cuda.vpu_pass import OPS, vpu_pass
from conformer_tpu_torch.tools import bench_vpu_pass as bench
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ROWS, COLS, GRID, N = 8, 199, 2, 3


@functools.lru_cache(maxsize=None)
def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_vpu_pass", ROOT / "tools" / "bench_vpu_pass.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("op", OPS)
def test_plain_pass_matches_the_jax_kernel(op):
    x = bench.tile_input(ROWS, COLS, GRID, device="cpu")
    block = pl.BlockSpec((ROWS, COLS), lambda i: (i, 0))
    want = pl.pallas_call(
        functools.partial(_jax_tool()._kernel, op=op, n=N), grid=(GRID,),
        in_specs=[block], out_specs=block,
        out_shape=jax.ShapeDtypeStruct((GRID * ROWS, COLS), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))
    got = vpu_pass(x, op, N, ROWS)
    assert got.dtype == torch.float32 and tuple(got.shape) == (GRID * ROWS,
                                                               COLS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=0)


def test_pass_bounds_follow_the_issue_rates():
    """One pass over 128 x 16 elements on one SM at 1 Hz: 16 clocks of the
    FP32 pipe per instruction, 128 of the MUFU unit."""
    assert bench.pass_bound_s("add", 2048, 1.0, 1) == 16.0
    assert bench.pass_bound_s("exp2", 2048, 1.0, 1) == 128.0
    assert bench.pass_bound_s("sum", 2048, 1.0, 1) == 48.0
    with pytest.raises(ValueError, match="unknown op"):
        vpu_pass(torch.zeros(8, 4), "log", 1, 8)
