"""The port's export (``conformer_tpu_torch/export.py``, ``cli/export.py``)
and its ``torch.library`` custom ops against the JAX package on the CPU.

``ModelConfig.tiny`` in fp32 with the kernels' paths on (``stft_impl`` and
``conv_impl`` 'pallas'), the flax weights carried across by ``convert.py``:

- the CTC program's logits against the JAX ``make_forward`` and against the
  JAX package's own exported artifact on the same input (atol 1e-4);
- the transducer program's greedy tokens and counts equal to the JAX
  artifact's;
- bucket padding (the smallest bucket that holds the audio), audio past the
  largest bucket rejected, ``meta.json``'s keys;
- ``cli.export --device cpu`` on a checkpoint of ``cli.train``'s kind;
- the program holds the three kernels (K1, K3, K4a) as custom-op nodes, and
  ``move_to_device_pass`` moves every constant and device argument, those
  of the ``while_loop`` subgraphs too;
- the frame loops stay rolled: the CTC program's and the greedy
  transducer program's graph nodes are as many at 2 s as at 1 s;
- each custom op's fake (shape and dtype) against its plain version
  (``torch.library.opcheck``); ``decode="beam"`` without a tokenizer
  raises (tests/test_torch_export_beam.py holds the beam programs).
"""

import functools
import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.export.passes import move_to_device_pass

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.export import ExportedModel as JExportedModel
from conformer_tpu.export import export_model as j_export_model
from conformer_tpu.train.steps import init_variables
from conformer_tpu.train.steps import make_forward as j_make_forward
from conformer_tpu_torch.audio.mel import MelFrontend
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.export import ExportedModel, export_model
from conformer_tpu_torch.models.conformer import build_model
from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
from conformer_tpu_torch.ops.cuda import mel_frontend as mf
from conformer_tpu_torch.ops.cuda import sincos_attention as sa
from conformer_tpu_torch.train.checkpoint import CheckpointManager
from conformer_tpu_torch.train.state import make_optimizer
from conformer_tpu_torch.train.steps import make_forward
from torch_threads import one_torch_thread  # noqa: F401

SR = 16000
VOCAB = 370
OPS = ("conformer_tpu_torch.sincos_attention_fwd.default",
       "conformer_tpu_torch.logmel_fwd.default",
       "conformer_tpu_torch.depthwise_conv_fwd.default")
TRANSDUCER = {"model.arch": "transducer", "model.pred_embed_dim": 32,
              "model.pred_hidden_dim": 32, "model.joint_dim": 32}
BLANK_BIAS = 2.0     # the random joint then mixes blanks and emissions


def graph_nodes(exported) -> int:
    """Nodes of a program's graph and of every subgraph it holds (a
    ``while_loop``'s condition and body)."""
    return sum(len(m.graph.nodes) for m in exported.graph_module.modules()
               if isinstance(m, torch.fx.GraphModule))


def _jcfg(**extra):
    return JConfig(model=JModelConfig.tiny(VOCAB)).override(
        **{"optim.compute_dtype": "float32", "audio.stft_impl": "pallas",
           "model.conv_impl": "pallas"}, **extra)


@functools.lru_cache(maxsize=None)
def _variables(transducer: bool):
    jcfg = _jcfg(**(TRANSDUCER if transducer else {}))
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    variables = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(0)))
    if transducer:
        variables["params"]["joint"]["out"]["bias"][0] += BLANK_BIAS
    return variables


def _port_model(jcfg, variables):
    cfg = Config.from_dict(jcfg.to_dict())
    model = build_model(cfg.model, "float32", seed=None)
    model.load_state_dict(flax_to_state_dict(variables, cfg.model))
    return cfg, model.eval()


def _audio(b=2, n=12000, seed=0):
    rng = np.random.default_rng(seed)
    audio = (0.05 * rng.standard_normal((b, n))).astype(np.float32)
    lengths = np.array([n, n - 4000][:b], np.int64)
    audio[np.arange(n)[None] >= lengths[:, None]] = 0.0
    return audio, lengths


@pytest.fixture(scope="module")
def ctc(tmp_path_factory):
    """The CTC program exported at 1 and 2 s, batch 2, and the JAX
    artifact of the same weights at 1 s."""
    root = tmp_path_factory.mktemp("export_ctc")
    jcfg, variables = _jcfg(), _variables(False)
    cfg, model = _port_model(jcfg, variables)
    files = export_model(cfg, model, str(root / "port"), batch_size=2,
                         audio_seconds=(1.0, 2.0))
    j_export_model(jcfg, variables, str(root / "jax"), batch_size=2,
                   audio_seconds=(1.0,))
    return root, jcfg, variables, cfg, model, files


def test_ctc_program_matches_the_jax_forward_and_artifact(ctc):
    root, jcfg, variables, _, _, _ = ctc
    audio, lengths = _audio()
    logits, out_lengths = ExportedModel(str(root / "port"), device="cpu")(
        audio, lengths)
    padded = np.pad(audio, ((0, 0), (0, SR - audio.shape[1])))
    want, want_lengths = j_make_forward(jcfg)(
        variables, jnp.asarray(padded), jnp.asarray(lengths, jnp.int32))
    np.testing.assert_array_equal(out_lengths.numpy(), np.asarray(want_lengths))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4)
    j_logits, _ = JExportedModel(str(root / "jax"))(
        audio, lengths.astype(np.int32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               atol=1e-4)


def test_buckets_pad_up_and_reject_audio_past_the_largest(ctc):
    root, _, _, cfg, model, files = ctc
    assert [os.path.basename(f) for f in files] == ["model_b2_1s.pt2",
                                                    "model_b2_2s.pt2"]
    exported = ExportedModel(str(root / "port"), device="cpu")
    forward = make_forward(cfg, model)
    for n, bucket in ((12000, SR), (SR, SR), (SR + 1, 2 * SR),
                      (30000, 2 * SR)):
        audio, lengths = _audio(n=n, seed=n)
        got, got_len = exported(audio, lengths)
        want, want_len = forward(torch.from_numpy(np.pad(
            audio, ((0, 0), (0, bucket - n)))), torch.from_numpy(lengths))
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        assert torch.equal(got_len, want_len)
    with pytest.raises(ValueError, match="longer than largest"):
        exported(*_audio(n=2 * SR + 1))
    with open(root / "port" / "meta.json") as f:
        meta = json.load(f)
    with open(root / "jax" / "meta.json") as f:
        j_meta = json.load(f)
    assert set(j_meta) <= set(meta)
    assert meta["framework"] == "conformer_tpu_torch"
    assert meta["outputs"] == "logits_lengths" and meta["device"] == "cpu"
    assert meta["audio_seconds"] == [1.0, 2.0] and meta["batch_size"] == 2
    with pytest.raises(ValueError, match="needs the tokenizer"):
        export_model(cfg, model, str(root / "beam"), decode="beam")


def test_program_holds_the_kernels_and_moves_to_a_device(ctc):
    files = ctc[-1]
    program = torch.export.load(files[0])
    targets = {str(n.target) for n in program.graph.nodes}
    assert set(OPS) <= targets
    moved = move_to_device_pass(program, "meta")
    for tensor in [*moved.state_dict.values(), *moved.constants.values()]:
        assert tensor.device.type == "meta"
    graphs = [m.graph for m in moved.graph_module.modules()
              if isinstance(m, torch.fx.GraphModule)]
    assert len(graphs) == 3       # the LSTM head's loop: condition and body
    for graph in graphs:
        for node in graph.nodes:
            if "device" in node.kwargs:
                assert torch.device(node.kwargs["device"]).type == "meta", node
    assert any("device" in n.kwargs for n in program.graph.nodes)


@pytest.mark.parametrize("arch", ["ctc", "transducer"])
def test_frame_loops_stay_rolled_across_buckets(arch, ctc, transducer):
    """As many graph nodes at 2 s as at 1 s: the LSTM head and the greedy
    rounds are one while_loop each, not a copy a frame."""
    files = ctc[-1] if arch == "ctc" else transducer[-1]
    one, two = (torch.export.load(f) for f in files)
    assert graph_nodes(one) == graph_nodes(two)
    assert sum(n.target is torch.ops.higher_order.while_loop
               for n in one.graph.nodes) == 1


@pytest.fixture(scope="module")
def transducer(tmp_path_factory):
    """The transducer exported by the port at 1 and 2 s and by the JAX
    package at 1 s, batch 2, from the same weights."""
    root = tmp_path_factory.mktemp("export_transducer")
    jcfg = _jcfg(**TRANSDUCER)
    variables = _variables(True)
    cfg, model = _port_model(jcfg, variables)
    files = export_model(cfg, model, str(root / "port"), batch_size=2,
                         audio_seconds=(1.0, 2.0))
    j_export_model(jcfg, variables, str(root / "jax"), batch_size=2,
                   audio_seconds=(1.0,))
    return (ExportedModel(str(root / "port"), device="cpu"),
            JExportedModel(str(root / "jax")), root, files)


def test_transducer_program_tokens_equal_the_jax_artifact(transducer):
    exported, j_exported, root, _ = transducer
    rng = np.random.default_rng(3)
    tone = 0.4 * np.sin(2 * np.pi * 300 * np.arange(SR) / SR)
    audio = (tone + 0.3 * rng.standard_normal((2, SR))).astype(np.float32)
    lengths = np.array([SR, 12000], np.int64)
    audio[1, 12000:] = 0.0
    tokens, counts = exported(audio, lengths)
    j_tokens, j_counts = j_exported(audio, lengths.astype(np.int32))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(j_tokens))
    assert tokens.dtype == torch.int32
    assert 0 < int(counts.min()) and int(counts.max()) < 4 * 24
    with open(root / "port" / "meta.json") as f:
        assert json.load(f)["outputs"] == "tokens_counts"


def _checkpoint(cfg, model, ck):
    """A checkpoint of cli.train's kind (step 4) of ``model`` in ``ck``."""
    from conformer_tpu_torch.cli.common import save_config

    mgr = CheckpointManager(str(ck))
    mgr.save(model, make_optimizer(cfg.optim, model.parameters()), step=4)
    mgr.close()
    save_config(cfg, str(ck))


def test_cli_export_on_a_port_checkpoint(ctc, tmp_path, capsys):
    from conformer_tpu_torch.cli.export import main

    _, _, _, cfg, model, _ = ctc
    ck = tmp_path / "ck"
    _checkpoint(cfg, model, ck)
    out = tmp_path / "out"
    files = main(["--checkpoint-dir", str(ck), "--out", str(out),
                  "--device", "cpu", "--batch-size", "1",
                  "--audio-seconds", "1"])
    assert [os.path.basename(f) for f in files] == ["model_b1_1s.pt2"]
    assert "exported step 4" in capsys.readouterr().out
    with open(out / "meta.json") as f:
        assert json.load(f)["export_seconds"] > 0
    audio, lengths = _audio(b=1, n=9000, seed=5)
    got, _ = ExportedModel(str(out), device="cpu")(audio, lengths)
    with torch.no_grad():
        want, _ = model(*_mels(cfg, np.pad(audio, ((0, 0), (0, SR - 9000))),
                               lengths))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    with pytest.raises(SystemExit, match="no checkpoint"):
        main(["--checkpoint-dir", str(tmp_path / "none"), "--out", str(out),
              "--device", "cpu"])
    with mock.patch.object(torch.cuda, "is_available", lambda: False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ExportedModel(str(out))


def test_cli_export_beam_on_a_port_checkpoint(ctc, tmp_path, capsys):
    """``cli.export --decode beam --device cpu``: the program's best beam
    equals the device search on the live model's log-probs."""
    from conformer_tpu_torch.cli.export import main
    from conformer_tpu_torch.ops.beam_search_device import (
        ctc_beam_search_device)

    _, _, _, cfg, model, _ = ctc
    ck = tmp_path / "ck"
    _checkpoint(cfg, model, ck)
    out = tmp_path / "beam"
    files = main(["--checkpoint-dir", str(ck), "--out", str(out),
                  "--device", "cpu", "--batch-size", "2",
                  "--audio-seconds", "1", "--decode", "beam",
                  "--set", "decode.beam_width=4",
                  "--set", "data.max_tokens=16"])
    assert [os.path.basename(f) for f in files] == ["model_b2_1s.pt2"]
    assert "exported step 4" in capsys.readouterr().out
    with open(out / "meta.json") as f:
        meta = json.load(f)
    assert meta["decode"] == "beam" and meta["outputs"] == "tokens_counts"
    audio, lengths = _audio(seed=6)
    tokens, counts = ExportedModel(str(out), device="cpu")(audio, lengths)
    with torch.no_grad():
        logits, out_len = model(*_mels(
            cfg, np.pad(audio, ((0, 0), (0, SR - audio.shape[1]))), lengths))
    prefixes, plens, _ = ctc_beam_search_device(
        torch.log_softmax(logits, -1), out_len, beam_width=4,
        top_k=cfg.decode.device_top_k, unk_id=369, max_len=16)
    assert torch.equal(counts, plens[:, 0]) and int(counts.max()) > 0
    assert torch.equal(tokens, prefixes[:, 0])


def _mels(cfg, audio, lengths):
    frontend = MelFrontend(cfg.audio)
    return (frontend(torch.from_numpy(audio)),
            frontend.frame_lengths(torch.from_numpy(lengths)))


def _op_cases():
    rng = np.random.default_rng(8)
    t = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    b, l, h, dh = 2, 9, 2, 8
    d = h * dh
    sin_t, cos_t = sa.sincos_tables(l, d)
    attention = (t(b, l, d), t(b, l, d), t(b, l, d), t(b, l, d),
                 t(h, dh, d), torch.tensor([9, 5], dtype=torch.int32),
                 sin_t, cos_t, 0.0, 0, sa.hash_tq(l))
    fe = MelFrontend()
    mel = (t(2, 3600), fe._dft, fe._fb, 160, 400, 21, 1e-5, *fe._k3)
    conv = (t(2, 11, 6), t(7, 6), t(6), 3)
    return (("attention", sa.sincos_attention_fwd_op, attention,
             sa.sincos_attention_plain),
            ("mel", mf.logmel_fwd_op, mel, lambda *a: mf.logmel_plain(*a[:7])),
            ("conv", dc.depthwise_conv_fwd_op, conv, dc.depthwise_conv_plain))


@pytest.mark.parametrize("case", range(3))
def test_custom_op_fakes_match_their_plain_versions(case):
    name, op, args, plain = _op_cases()[case]
    torch.library.opcheck(op, args)
    want = plain(*args)
    torch.testing.assert_close(op(*args), want, rtol=0, atol=0)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if torch.is_tensor(a) else a
                     for a in args]
        fake = op(*fake_args)
    assert fake.shape == want.shape and fake.dtype == want.dtype, name
