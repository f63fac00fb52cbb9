"""The PyTorch port's whole serving path against the JAX package on the CPU.

The tiny CTC Conformer (ModelConfig.tiny, fp32), with flax-initialised
weights carried across by conformer_tpu_torch.convert, on the same seeded
audio: audio -> log-mels -> logits -> greedy tokens -> text. The JAX
attention's default 'pallas' impl runs its plain reference on the CPU, as
the JAX package's own tests run it. Tolerance: logits atol/rtol 1e-4 (fp32
on both sides; sums are taken in another order)."""

import csv
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.ops.ctc import greedy_decode as j_greedy_decode
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables, make_forward as j_make_forward
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.train.steps import make_eval_step, make_forward
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 370   # the 'vi' tokenizer


def _configs(scan: bool, attention_impl: str = "pallas"):
    over = {"model.use_scan_layers": scan, "optim.compute_dtype": "float32",
            "model.attention_impl": attention_impl}
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(**over)
    tcfg = Config.from_dict(jcfg.to_dict())
    return jcfg, tcfg


def _randomize_stats(variables, seed):
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x), variables["batch_stats"])

    def fill(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fill(v)
            elif k == "mean":
                tree[k] = rng.uniform(-0.5, 0.5, v.shape).astype(np.float32)
            else:
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    fill(stats)
    params = jax.tree_util.tree_map(lambda x: np.asarray(x), variables["params"])
    return {"params": params, "batch_stats": stats}


def _audio(seed=0):
    rng = np.random.default_rng(seed)
    audio = (rng.standard_normal((2, 19200)) * 0.1).astype(np.float32)
    lengths = np.array([19200, 13000], np.int32)
    audio[1, 13000:] = 0.0
    return audio, lengths


@functools.lru_cache(maxsize=None)
def _variables(scan: bool):
    """Flax variables with random BatchNorm statistics, shared by both
    attention impls (the impl changes no parameter). Jitted, on a short
    dummy batch: one compile instead of one per op, and the parameter
    shapes do not depend on the batch's length."""
    jcfg, _ = _configs(scan)
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    return _randomize_stats(init(jax.random.PRNGKey(3)), 4)


@functools.lru_cache(maxsize=None)
def _pair(scan: bool, attention_impl: str):
    """(JAX config, port config, flax variables, port model). Cached: the
    tests only read them."""
    jcfg, tcfg = _configs(scan, attention_impl)
    variables = _variables(scan)
    model = Conformer(tcfg.model, tcfg.optim.compute_dtype).eval()
    model.load_state_dict(flax_to_state_dict(variables, tcfg.model))
    return jcfg, tcfg, variables, model


@pytest.mark.parametrize("scan,impl", [(True, "pallas"), (False, "pallas"),
                                       (False, "xla")])
def test_logits_tokens_and_text_match_jax(scan, impl):
    jcfg, tcfg, variables, model = _pair(scan, impl)
    audio, lengths = _audio()
    tok = load_tokenizer("vi")
    jtok = j_load_tokenizer("vi")

    j_logits, j_len = jax.jit(j_make_forward(jcfg))(
        variables, jnp.asarray(audio), jnp.asarray(lengths))
    j_tokens, j_counts = j_greedy_decode(j_logits, j_len, unk_id=jtok.unk_id)

    t_logits, t_len = make_forward(tcfg, model)(torch.from_numpy(audio),
                                                torch.from_numpy(lengths))
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(j_len))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               atol=1e-4, rtol=1e-4)

    out = make_eval_step(tcfg, model, unk_id=tok.unk_id)(
        torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(out["counts"].numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(out["tokens"].numpy(), np.asarray(j_tokens))
    texts = [tok.collapsed_ids_to_text(out["tokens"][i].numpy(),
                                       out["counts"][i])
             for i in range(2)]
    j_texts = [jtok.collapsed_ids_to_text(np.asarray(j_tokens[i]),
                                          int(j_counts[i]))
               for i in range(2)]
    assert texts == j_texts


def test_cli_infer_on_cpu(tmp_path):
    """cli.infer.main end to end on WAV files with converted weights."""
    from conformer_tpu_torch.cli.infer import main

    jcfg, tcfg, variables, model = _pair(True, "pallas")
    weights = tmp_path / "w.pt"
    torch.save(model.state_dict(), weights)
    cfg_path = tmp_path / "cfg.json"
    tcfg.to_json(str(cfg_path))
    audio, lengths = _audio(1)
    paths = []
    for i in range(3):
        p = tmp_path / f"a{i}.wav"
        n = int(lengths[i % 2])
        wavfile.write(p, 16000, (audio[i % 2, :n] * 32767).astype(np.int16))
        paths.append(str(p))
    out_csv = tmp_path / "out.csv"
    pipe = main(["--audio", *paths, "--config", str(cfg_path),
                 "--weights", str(weights), "--device", "cpu",
                 "--batch-size", "2", "--output", str(out_csv)])
    with open(out_csv, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["path", "prediction"] and len(rows) == 4
    assert [b["batch_size"] for b in pipe.batch_log] == [2, 1]
    # The same audio through the JAX forward gives the same text.
    jtok = j_load_tokenizer("vi")
    sig = wavfile.read(paths[2])[1].astype(np.float32) / 32768.0
    j_logits, j_len = jax.jit(j_make_forward(jcfg))(
        variables, jnp.asarray(sig[None]), jnp.asarray([len(sig)], jnp.int32))
    j_tokens, j_counts = j_greedy_decode(j_logits, j_len, unk_id=jtok.unk_id)
    want = jtok.collapsed_ids_to_text(np.asarray(j_tokens[0]), int(j_counts[0]))
    assert rows[3] == [paths[2], want]


@functools.lru_cache(maxsize=None)
def _jax_wav_text(n: int) -> str:
    """The JAX forward's greedy text of ``_audio(1)``'s row ``n % 2`` as
    written to a 16-bit WAV (one compile: padded to the batch's length)."""
    jcfg, _, variables, _ = _pair(True, "pallas")
    audio, lengths = _audio(1)
    k = int(lengths[n % 2])
    sig = np.zeros((1, audio.shape[1]), np.float32)
    sig[0, :k] = (audio[n % 2, :k] * 32767).astype(np.int16) / 32768.0
    jtok = j_load_tokenizer("vi")
    j_logits, j_len = jax.jit(j_make_forward(jcfg))(
        variables, jnp.asarray(sig), jnp.asarray([k], jnp.int32))
    j_tokens, j_counts = j_greedy_decode(j_logits, j_len, unk_id=jtok.unk_id)
    return jtok.collapsed_ids_to_text(np.asarray(j_tokens[0]), int(j_counts[0]))


def test_cli_infer_serves_a_checkpoint_dir_from_a_parquet_manifest(tmp_path,
                                                                   capsys):
    """A training directory (a checkpoint of the JAX variables carried by
    convert.py, and config.json) is all cli.infer needs: no --config. Its
    texts are the JAX forward's."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from conformer_tpu_torch.cli.common import save_config
    from conformer_tpu_torch.cli.infer import main
    from conformer_tpu_torch.train.checkpoint import CheckpointManager
    from conformer_tpu_torch.train.state import make_optimizer

    _, tcfg, _, model = _pair(True, "pallas")
    ck = tmp_path / "ck"
    mgr = CheckpointManager(str(ck))
    mgr.save(model, make_optimizer(tcfg.optim, model.parameters()), step=2)
    mgr.close()
    save_config(tcfg, str(ck))
    audio, lengths = _audio(1)
    paths = []
    for i in range(3):
        p = tmp_path / f"a{i}.wav"
        n = int(lengths[i % 2])
        wavfile.write(p, 16000, (audio[i % 2, :n] * 32767).astype(np.int16))
        paths.append(str(p))
    manifest = tmp_path / "m.parquet"
    pq.write_table(pa.table({"path": paths}), manifest)
    out_csv = tmp_path / "out.csv"
    main(["--manifest", str(manifest), "--checkpoint-dir", str(ck),
          "--device", "cpu", "--batch-size", "2", "--output", str(out_csv)])
    said = capsys.readouterr().out
    assert f"restored step 2 from {ck}" in said and "config.json" in said
    with open(out_csv, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    assert rows == [["path", "prediction"]] + [
        [p, _jax_wav_text(i)] for i, p in enumerate(paths)]
    with pytest.raises(SystemExit):         # one source of weights
        main(["--audio", paths[0], "--checkpoint-dir", str(ck),
              "--weights", str(tmp_path / "w.pt"), "--device", "cpu"])


@pytest.mark.parametrize("fmt", ["csv", "parquet"])
def test_cli_infer_reads_segment_manifests_as_the_jax_cli_does(tmp_path,
                                                               monkeypatch,
                                                               fmt):
    """The same (path, start, end) manifest reaches transcribe_files as the
    same paths and segments in both CLIs (their pipelines replaced by a
    recorder; the JAX one's module is never imported, which takes long)."""
    import sys
    import types

    import pyarrow as pa
    import pyarrow.parquet as pq
    from conformer_tpu.cli import infer as j_infer

    from conformer_tpu_torch.cli import infer as t_infer
    from conformer_tpu_torch.decode import pipeline as t_pipeline

    calls = []

    class Recorder:
        def __init__(self, *args, **kwargs):
            pass

        def transcribe_files(self, paths, batch_size=8, channel=None,
                             segments=None):
            calls.append((list(paths), segments))
            return [""] * len(paths)

    monkeypatch.setitem(sys.modules, "conformer_tpu.decode.pipeline",
                        types.SimpleNamespace(InferencePipeline=Recorder))
    monkeypatch.setattr(t_pipeline, "InferencePipeline", Recorder)
    table = {"path": [str(tmp_path / f"call{i}.wav") for i in (0, 0, 1)],
             "start": [0.0, 2.5, 0.25], "end": [2.5, 6.75, 3.0],
             "text": ["A", "B", "C"]}
    manifest = tmp_path / f"m.{fmt}"
    if fmt == "parquet":
        pq.write_table(pa.table(table), manifest)
    else:
        with open(manifest, "w", newline="", encoding="utf8") as f:
            w = csv.writer(f)
            w.writerow(list(table))
            w.writerows(zip(*table.values()))
    j_infer.main(["--manifest", str(manifest)])
    t_infer.main(["--manifest", str(manifest), "--device", "cpu"])
    want = (table["path"], list(zip(table["start"], table["end"])))
    assert calls == [want, want]
