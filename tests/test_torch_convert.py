"""conformer_tpu_torch.convert: the flax tree <-> state_dict bridge, on both
block layouts (scan-stacked and unrolled), against the JAX package's own
initialised trees. Exact (it only moves and transposes numbers)."""

import functools

import jax
import numpy as np
import pytest
import torch

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.train.state import param_count
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import (flax_to_state_dict, is_scan_layout,
                                         state_dict_to_flax)
from conformer_tpu_torch.models.conformer import Conformer
from torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _variables(scan: bool, subsample: str = "conv2d"):
    """Two LSTM layers, so the per-layer LSTM mapping is exercised. Cached:
    the tests read the tree and never write it."""
    over = {"model.use_scan_layers": scan, "model.subsample_impl": subsample,
            "model.n_lstm_layers": 2}
    jcfg = JConfig(model=JModelConfig.tiny(40)).override(**over)
    # Jitted, on a short dummy batch: one compile instead of one per op, and
    # the parameter shapes do not depend on the batch's length.
    variables = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))(
        jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, dict(variables))
    return Config.from_dict(jcfg.to_dict()), tree


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("subsample", ["conv2d", "separable"])
def test_round_trip_is_exact(scan, subsample):
    cfg, tree = _variables(scan, subsample)
    assert is_scan_layout(tree) == scan
    state = flax_to_state_dict(tree, cfg.model)
    model = Conformer(cfg.model)
    model.load_state_dict(state)              # strict: every name, every shape
    back = state_dict_to_flax(model.state_dict(), cfg.model, scan=scan)
    want = dict(_leaves(tree))
    got = dict(_leaves(back))
    assert sorted(got) == sorted(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(got[key], arr, err_msg=key)


def test_scan_and_unrolled_give_the_same_state_dict():
    cfg, tree = _variables(True, "conv2d")
    state = flax_to_state_dict(tree, cfg.model)
    unrolled = state_dict_to_flax(state, cfg.model, scan=False)
    again = flax_to_state_dict(unrolled, cfg.model)
    assert state.keys() == again.keys()
    for key in state:
        assert torch.equal(state[key], again[key]), key


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("subsample", ["conv2d", "separable"])
def test_parameter_count_matches_jax(scan, subsample):
    cfg, tree = _variables(scan, subsample)
    model = Conformer(cfg.model)
    n = sum(p.numel() for p in model.parameters())
    assert n == param_count(tree["params"])


def test_nonzero_lstm_hidden_bias_is_refused():
    cfg, tree = _variables(True, "conv2d")
    state = flax_to_state_dict(tree, cfg.model)
    state["decoder.lstm.0.bias_hh"] = torch.ones_like(
        state["decoder.lstm.0.bias_hh"])
    with pytest.raises(ValueError, match="bias_hh"):
        state_dict_to_flax(state, cfg.model, scan=True)


def test_npz_cli_writes_a_loadable_state_dict(tmp_path):
    from conformer_tpu_torch.convert import main

    cfg, tree = _variables(True, "conv2d")
    npz = tmp_path / "tree.npz"
    np.savez(npz, **dict(_leaves(tree)))
    cfg_path = tmp_path / "cfg.json"
    cfg.to_json(str(cfg_path))
    out = tmp_path / "w.pt"
    main(["--npz", str(npz), "--out", str(out), "--config", str(cfg_path)])
    model = Conformer(cfg.model)
    model.load_state_dict(torch.load(out))
