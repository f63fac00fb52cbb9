"""The port's RNN-T beam search against the JAX package on the CPU
(conformer_tpu_torch/ops/rnnt.py::rnnt_beam_search).

A tiny transducer (``ModelConfig.tiny`` at vocab 32, prediction and joint
32, fp32; the port's seeded weights with the joint's output sharpened and
the blank's and delimiter's biases raised, so that blanks, emissions and
word ends mix, carried to flax by ``conformer_tpu_torch.convert``) decodes
the same seeded encodings (B 2, T 10) through the JAX ``rnnt_beam_search``
(joint_logits, predict_step, predict_init of the bound flax model) and the
port's (``Transducer.frame_fns``, ``predict_init``), W 8, top-k 4, 3
symbols a frame: no LM (``lengths``, ``unk_id``), word LM with hotwords,
``length_norm``, and a resume through ``init_beams`` / ``return_beams`` /
``start_frames`` held against the JAX beams. Tolerance: tokens and counts
equal, scores within 1e-4 absolute for every live beam, rankings equal
wherever consecutive JAX scores differ by more than 1e-4; the raw beams'
prediction state within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.models.transducer import Transducer as JTransducer
from conformer_tpu.ops import rnnt as jrnnt
from conformer_tpu_torch import convert
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.ops import rnnt
from test_torch_beam_device import (BLANK, DELIM, NEG, TOKENS, UNK,
                                    _kwargs, assert_beams_match,
                                    lms)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

B, T, W, TOP_K, SYMBOLS = 2, 10, 8, 4, 3
OUT_SCALE, BLANK_BIAS, DELIM_BIAS = 4.0, 2.0, 2.0


def _jcfg():
    return JConfig(model=JModelConfig.tiny(len(TOKENS))).override(**{
        "model.arch": "transducer", "model.pred_embed_dim": 32,
        "model.pred_hidden_dim": 32, "model.joint_dim": 32,
        "optim.compute_dtype": "float32"})


@functools.lru_cache(maxsize=None)
def _models():
    """(the bound flax transducer, the port's) on the same weights: the
    port's seeded init, its joint output scaled by OUT_SCALE (peaked
    choices) and the blank's and the delimiter's biases raised, carried to
    flax by convert.state_dict_to_flax."""
    cfg = Config.from_dict(_jcfg().to_dict())
    model = build_model(cfg.model, "float32", seed=0)
    with torch.no_grad():
        model.joint.out.weight.mul_(OUT_SCALE)
        model.joint.out.bias[BLANK] = BLANK_BIAS
        model.joint.out.bias[DELIM] = DELIM_BIAS
    variables = convert.state_dict_to_flax(model.state_dict(), cfg.model,
                                           scan=False)
    return JTransducer(_jcfg().model).bind(variables), model.eval()


def _enc(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 64)) * 2.0).astype(np.float32)


def _jax_search(**kw):
    bound = _models()[0]
    return jax.jit(functools.partial(
        jrnnt.rnnt_beam_search, bound.joint_logits,
        pred_step_fn=bound.predict_step, beam_width=W, top_k=TOP_K,
        max_symbols=SYMBOLS, blank_id=BLANK, **kw))


def _jax(lengths, kwargs_mode, lms_, start=None, jax_beams=None, enc=None,
         **kw):
    """The JAX search's outputs on the seeded encodings."""
    bound = _models()[0]
    enc = _enc() if enc is None else enc
    j_kw = dict(kw, **_kwargs(kwargs_mode, lms_, False, *FUSION))
    static = {k: v for k, v in j_kw.items()
              if not isinstance(v, (jax.Array, tuple))}
    dynamic = {k: v for k, v in j_kw.items() if k not in static}
    return _jax_search(**static)(
        jnp.asarray(enc), jnp.asarray(lengths),
        pred_init=bound.predict_init(B),
        start_frames=None if start is None else jnp.asarray(start),
        init_beams=jax_beams, **dynamic)


def _port(lengths, kwargs_mode, lms_, start=None, beams=None, enc=None,
          **kw):
    """The port's search's outputs on the same encodings."""
    model = _models()[1]
    enc = _enc() if enc is None else enc
    joint_fn, pred_step_fn = model.frame_fns()
    with torch.no_grad():
        return rnnt.rnnt_beam_search(
            joint_fn, torch.from_numpy(enc), torch.from_numpy(lengths),
            pred_step_fn, model.predict_init(B), beam_width=W, top_k=TOP_K,
            max_symbols=SYMBOLS, blank_id=BLANK,
            start_frames=None if start is None else torch.from_numpy(start),
            init_beams=beams, **kw, **_kwargs(kwargs_mode, lms_, True,
                                              *FUSION))


LENGTHS = np.array([T, 7], np.int32)
# alpha, beta: light enough on the tiny model's emissions that beams
# complete words
FUSION = (0.3, 3.0)
CASES = {
    "none": dict(unk_id=UNK),
    "none_length_norm": dict(unk_id=UNK, length_norm=True, max_len=12),
    "hot": dict(unk_id=UNK),
}


# the resume case: window 1 (frames 0-5) returns the raw beams; window 2
# (frames 3-9, its first 3 skipped by start_frames) resumes from them
RESUME = dict(unk_id=UNK, max_len=20, return_beams=True)
RESUME_START = np.array([3, 3], np.int32)


@pytest.fixture(scope="module")
def jax_results(lms):
    """Every case's JAX search, compiled and run once a module, in set-up:
    case -> outputs, and "resume" -> (window 1's, window 2's)."""
    out = {case: _jax(LENGTHS, case.split("_")[0], lms, **CASES[case])
           for case in CASES}
    enc = _enc(seed=3)
    first = _jax(np.array([6, 6], np.int32), "hot", lms, enc=enc[:, :6],
                 **RESUME)
    second = _jax(np.array([7, 7], np.int32), "hot", lms, enc=enc[:, 3:],
                  start=RESUME_START, jax_beams=first[-1], **RESUME)
    out["resume"] = (first, second)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_jax(case, lms, jax_results):
    got = _port(LENGTHS, case.split("_")[0], lms, **CASES[case])
    want = jax_results[case]
    assert got[0].dtype == got[1].dtype == torch.int32
    assert_beams_match(got, want)
    counts = got[1].numpy()
    assert (counts[:, 0] > 0).all() and (counts[:, 0] < T * SYMBOLS).all()
    if "length_norm" in case:
        # ranked by score over length: the plain ranking differs somewhere
        model = _models()[1]
        joint_fn, pred_step_fn = model.frame_fns()
        with torch.no_grad():
            plain = rnnt.rnnt_beam_search(
                joint_fn, torch.from_numpy(_enc()),
                torch.from_numpy(LENGTHS), pred_step_fn,
                model.predict_init(B), beam_width=W, top_k=TOP_K,
                max_symbols=SYMBOLS, blank_id=BLANK, unk_id=UNK, max_len=12)
        assert not torch.equal(plain[0], got[0])


def test_resume_from_the_raw_beams_matches_jax(lms, jax_results):
    """Window 1 (frames 0-5) returns the raw beams; window 2 (frames 3-9,
    its first 3 skipped by start_frames) resumes from them; word LM and
    hotwords: beams and results against the JAX package's."""
    enc = _enc(seed=3)
    (*want1, j_beams), want2 = jax_results["resume"]
    *got1, beams = _port(np.array([6, 6], np.int32), "hot", lms,
                         enc=enc[:, :6], **RESUME)
    assert_beams_match(got1, want1)
    j_fields = list(j_beams)
    for name, j in zip(rnnt.RnntBeams._fields[:13], j_fields[:13]):
        got, want = getattr(beams, name).numpy(), np.asarray(j)
        if name == "score":
            live = want > NEG / 2
            np.testing.assert_allclose(got[live], want[live], atol=1e-4)
        else:
            np.testing.assert_array_equal(got, want.astype(np.int64), name)
    np.testing.assert_allclose(beams.pred.numpy(), np.asarray(j_fields[14]),
                               atol=1e-5)
    for (c, h), (jc, jh) in zip(beams.state, j_fields[13]):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    got2 = _port(np.array([7, 7], np.int32), "hot", lms, enc=enc[:, 3:],
                 start=RESUME_START, beams=beams, **RESUME)
    assert_beams_match(got2[:3], want2[:3])
    assert int(got2[1][:, 0].sum()) > int(got1[1][:, 0].sum())
