"""The port's beam export (``export_model(decode="beam")``) and the rolled
frame loops of every exported program against the JAX package on the CPU.

``ModelConfig.tiny`` in fp32 with the kernels' paths on, the flax weights
carried across by ``convert.py`` (tests/test_torch_export.py's helpers):

- the CTC beam program in the setting of the JAX package's own beam export
  test (vi tokenizer, the 2-gram ARPA of "XIN CHÀO" / "CẢM ƠN BẠN", W 8,
  alpha 0.8, beta 1.0, the hotword "XIN CHÀO" at 3.0, ``max_tokens`` 24,
  batch 2 of 1 s, lengths 16000 / 12000): tokens and counts equal to the
  JAX ``export_model(decode="beam")`` artifact's;
- the transducer beam program (the BLANK_BIAS transducer, its joint's
  output sharpened, at 1 s, W 4, no LM): tokens and counts equal to the
  JAX ``rnnt_beam_search`` on the JAX encoder of the same weights;
- ``run_frames`` under export: one ``while_loop`` node whatever T, its
  carries and outputs bit for bit those of the eager loop at T 1, 7 and 50,
  for a step with int64 carries, a stable sort and a gather;
- a sharded search refuses to be exported.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conformer_tpu.audio.mel import MelFrontend as JMelFrontend
from conformer_tpu.decode.pipeline import _device_lm_kwargs
from conformer_tpu.export import ExportedModel as JExportedModel
from conformer_tpu.export import export_model as j_export_model
from conformer_tpu.lm.ngram import build_arpa
from conformer_tpu.models.transducer import Transducer as JTransducer
from conformer_tpu.ops.rnnt import rnnt_beam_search as j_rnnt_beam_search
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu_torch.export import ExportedModel, export_model
from conformer_tpu_torch.lm.device_table import TableShard
from conformer_tpu_torch.ops.beam_search_device import ctc_beam_search_device
from conformer_tpu_torch.ops.frame_graph import run_frames
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from test_torch_export import (SR, TRANSDUCER, _jcfg, _port_model,
                               _variables, graph_nodes)
from torch_threads import one_torch_thread  # noqa: F401

BEAM = {"data.max_tokens": 24, "decode.beam_width": 8, "decode.alpha": 0.8,
        "decode.beta": 1.0, "decode.hotwords": ["XIN CHÀO"],
        "decode.hotword_weight": 3.0}
RNNT_WIDTH = 4
UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)
OUT_SCALE = 6.0


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_beam_lm")
    corpus = root / "c.txt"
    corpus.write_text("\n".join(["XIN CHÀO", "CẢM ƠN BẠN"] * 5),
                      encoding="utf8")
    path = str(root / "lm.arpa")
    build_arpa(str(corpus), path, order=2)
    return path


def _loops(program) -> int:
    """The ``while_loop`` nodes of a program's top graph."""
    return sum(n.target is torch.ops.higher_order.while_loop
               for n in program.graph.nodes)


def _batch(seed):
    audio = (np.random.default_rng(seed).standard_normal((2, SR))
             * 0.05).astype(np.float32)
    lengths = np.array([SR, 12000], np.int64)
    audio[1, 12000:] = 0.0
    return audio, lengths


@pytest.fixture(scope="module")
def ctc_beam(tmp_path_factory, arpa):
    """The CTC beam program (port) and the JAX beam artifact, 1 s, batch 2,
    from the same weights."""
    root = tmp_path_factory.mktemp("export_ctc_beam")
    jcfg = _jcfg(**BEAM, **{"decode.lm_path": arpa})
    variables = _variables(False)
    cfg, model = _port_model(jcfg, variables)
    export_model(cfg, model, str(root / "port"), batch_size=2,
                 audio_seconds=(1.0,), decode="beam",
                 tokenizer=load_tokenizer("vi"))
    j_export_model(jcfg, variables, str(root / "jax"), batch_size=2,
                   audio_seconds=(1.0,), decode="beam",
                   tokenizer=j_load_tokenizer("vi"))
    return root, cfg, model


def test_ctc_beam_program_equals_the_jax_artifact(ctc_beam):
    root, cfg, model = ctc_beam
    audio, lengths = _batch(2)
    tokens, counts = ExportedModel(str(root / "port"), device="cpu")(
        audio, lengths)
    j_tokens, j_counts = JExportedModel(str(root / "jax"))(
        audio, lengths.astype(np.int32))
    assert tokens.dtype == counts.dtype == torch.int32
    assert tokens.shape == (2, cfg.data.max_tokens)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert int(counts.min()) > 0
    with open(root / "port" / "meta.json") as f:
        meta = json.load(f)
    assert meta["outputs"] == "tokens_counts" and meta["decode"] == "beam"
    program = torch.export.load(str(root / "port" / "model_b2_1s.pt2"))
    # the LSTM head, the search's frames and its walk back
    assert _loops(program) == 3
    # no unsigned constant (the hash constants): older torch.export
    # versions cannot save one
    assert not [v.dtype for v in program.constants.values()
                if torch.is_tensor(v) and v.dtype in UNSIGNED]


def _tone_batch(seed):
    """A tone in noise, as the greedy program's test: the BLANK_BIAS
    transducer then mixes blanks and emissions."""
    rng = np.random.default_rng(seed)
    tone = 0.4 * np.sin(2 * np.pi * 300 * np.arange(SR) / SR)
    audio = (tone + 0.3 * rng.standard_normal((2, SR))).astype(np.float32)
    lengths = np.array([SR, 12000], np.int64)
    audio[1, 12000:] = 0.0
    return audio, lengths


@pytest.fixture(scope="module")
def rnnt_beam(tmp_path_factory):
    """The transducer beam program (port) at 1 s, batch 2, W 4, and the JAX
    search's best beams on the JAX encoder of the same weights: the
    BLANK_BIAS transducer with its joint's output sharpened by OUT_SCALE
    (on its flat random joint the empty hypothesis gathers every
    alignment's mass and wins), no LM (on a random model the word LM
    prices every emission out)."""
    root = tmp_path_factory.mktemp("export_rnnt_beam")
    jcfg = _jcfg(**TRANSDUCER, **dict(BEAM, **{
        "decode.beam_width": RNNT_WIDTH}))
    variables = jax.tree_util.tree_map(np.copy, _variables(True))
    variables["params"]["joint"]["out"]["kernel"] *= OUT_SCALE
    cfg, model = _port_model(jcfg, variables)
    export_model(cfg, model, str(root / "port"), batch_size=2,
                 audio_seconds=(1.0,), decode="beam",
                 tokenizer=load_tokenizer("vi"))

    tok = j_load_tokenizer("vi")
    dc = jcfg.decode
    lm_kwargs = _device_lm_kwargs(jcfg, tok, word_fallback=True)
    j_model = JTransducer(jcfg.model, compute_dtype="float32",
                          deterministic=True)
    frontend = JMelFrontend(jcfg.audio)

    @jax.jit
    def search(audio, lengths):
        bound = j_model.bind(variables)
        enc, enc_lengths = bound.encode(frontend(audio),
                                        frontend.frame_lengths(lengths))
        prefixes, plens, _ = j_rnnt_beam_search(
            bound.joint_logits, enc, enc_lengths, bound.predict_step,
            bound.predict_init(enc.shape[0]), beam_width=dc.beam_width,
            top_k=dc.rnnt_top_k, max_symbols=dc.rnnt_max_symbols,
            max_len=jcfg.data.max_tokens, unk_id=tok.unk_id,
            length_norm=dc.rnnt_length_norm, **lm_kwargs)
        return prefixes[:, 0], plens[:, 0]

    audio, lengths = _tone_batch(5)
    want = search(jnp.asarray(audio), jnp.asarray(lengths, jnp.int32))
    return root, (audio, lengths), want


def test_rnnt_beam_program_equals_the_jax_search(rnnt_beam):
    root, (audio, lengths), (j_tokens, j_counts) = rnnt_beam
    tokens, counts = ExportedModel(str(root / "port"), device="cpu")(
        audio, lengths)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert tokens.dtype == torch.int32 and int(counts.min()) > 0
    with open(root / "port" / "meta.json") as f:
        meta = json.load(f)
    assert meta["outputs"] == "tokens_counts" and meta["decode"] == "beam"


def _sort_step(carry, frame, t, inputs):
    """A frame step with int64 carries, a stable sort and a gather."""
    acc, order = carry
    key = (frame * 4).floor().to(torch.int64) + acc % 3
    order = torch.sort(key, dim=-1, stable=True).indices
    picked = frame.gather(-1, order)
    return (acc + picked.to(torch.int64) * t + order, order), \
        (picked * inputs[0]).sum(-1)


class _Frames(torch.nn.Module):
    def forward(self, frames):
        b, v = frames.shape[1:]
        carry = (torch.arange(b * v).reshape(b, v), torch.zeros(
            b, v, dtype=torch.int64))
        (acc, order), outs = run_frames(_sort_step, carry, frames,
                                        (torch.full((), 2.0),))
        return acc, order, outs


@functools.lru_cache(maxsize=None)
def _exported_frames(t):
    frames = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (t, 3, 6)).astype(np.float32) * 3)
    return frames, torch.export.export(_Frames(), (frames,))


@pytest.mark.parametrize("t", [1, 7, 50])
def test_run_frames_under_export_is_one_loop_equal_to_the_eager_one(t):
    frames, program = _exported_frames(t)
    got = program.module()(frames)
    want = _Frames()(frames)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert _loops(program) == 1
    assert graph_nodes(program) == graph_nodes(_exported_frames(7)[1])


def test_a_sharded_search_is_not_exported():
    class Sharded(torch.nn.Module):
        def forward(self, lp):
            return ctc_beam_search_device(
                lp, beam_width=2, lm_shard=TableShard(0, 8, None))[0]

    with pytest.raises(ValueError, match="sharded search"):
        torch.export.export(Sharded(), (torch.zeros(1, 3, 5),))
