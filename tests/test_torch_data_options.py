"""The data and model options of the port against the JAX package on the
CPU: parquet manifests, the CSV reader's difference from the JAX loader's,
``model.conv_norm='group'``, and the reference-checkpoint importer.

- a parquet manifest's rows equal the JAX ``load_manifest`` table's, and a
  missing pyarrow gives the named ImportError;
- CSV rows ``a.wav,`` / ``b.wav,123`` / ``c.wav,NA`` read as the strings
  ``''``, ``'123'``, ``'NA'`` (the JAX loader's pandas turns them into
  missing values and a number; ROADMAP.md §3);
- the tiny CTC model with the one-group GroupNorm, flax-initialised with
  random norm scales and biases: logits to 1e-4 (fp32) with a padded row,
  and its tree round-trips through convert.py bit for bit;
- a seeded reference-layout state dict, with and without DDP's
  ``module.``: the port's importer gives, bit for bit, the state dict of
  the JAX tool's ``convert_state_dict`` followed by convert.py, and its CLI
  writes a checkpoint directory that ``cli.test`` evaluates.
"""

import csv
import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.data import dataset as jdata
from conformer_tpu.models.conformer import Conformer as JConformer
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from conformer_tpu_torch.data import dataset as tdata
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.tools import import_reference_checkpoint as importer
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 370   # the 'vi' tokenizer, which cli.test sets


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------

def _wavs(tmp_path, seconds=(0.4, 1.1, 0.7)):
    rng = np.random.default_rng(5)
    paths = []
    for i, sec in enumerate(seconds):
        path = tmp_path / f"w{i}.wav"
        sig = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
        wavfile.write(path, 16000, (sig * 32767).astype(np.int16))
        paths.append(str(path))
    return paths


def test_parquet_manifest_rows_are_the_jax_loaders(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    paths = _wavs(tmp_path)
    table = pa.table({"path": paths, "text": ["xin chào", "", "123"],
                      "start": [0.0, 0.25, 0.1], "end": [0.4, 1.0, 0.6],
                      "speaker": [3, 1, 2]})
    manifest = str(tmp_path / "m.parquet")
    pq.write_table(table, manifest)
    rows = tdata.load_manifest(manifest)
    assert rows == jdata.load_manifest(manifest).to_pylist()
    j_ds, t_ds = jdata.ManifestDataset(manifest), tdata.ManifestDataset(manifest)
    assert len(t_ds) == len(j_ds) == 3
    for i in range(3):
        assert t_ds.row(i) == j_ds.row(i)
        (ja, jt), (ta, tt) = j_ds[i], t_ds[i]
        np.testing.assert_array_equal(ta, ja)          # the start/end cut
        assert tt == jt


def test_parquet_without_pyarrow_raises_a_named_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="needs pyarrow"):
        tdata.ManifestDataset(str(tmp_path / "m.parquet"))


def test_csv_cells_stay_strings_unlike_the_jax_loader(tmp_path):
    manifest = tmp_path / "m.csv"
    manifest.write_text("path,text\na.wav,\nb.wav,123\nc.wav,NA\n",
                        encoding="utf8")
    rows = tdata.load_manifest(str(manifest))
    assert [r["text"] for r in rows] == ["", "123", "NA"]
    j_ds = jdata.ManifestDataset(str(manifest))
    # pandas: '' and 'NA' are missing, '123' a number (ROADMAP.md §3)
    assert [j_ds.row(i)["text"] for i in range(3)] == [None, 123.0, None]


# ---------------------------------------------------------------------------
# conv_norm = 'group'
# ---------------------------------------------------------------------------

def _group_configs(scan: bool):
    over = {"model.conv_norm": "group", "model.use_scan_layers": scan,
            "optim.compute_dtype": "float32"}
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(**over)
    return jcfg, Config.from_dict(jcfg.to_dict())


@functools.lru_cache(maxsize=None)
def _group_variables(scan: bool):
    """Flax-initialised tiny weights, each GroupNorm's scale and bias drawn
    at random (init gives ones and zeros)."""
    jcfg, _ = _group_configs(scan)
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    tree = jax.tree_util.tree_map(np.asarray, dict(init(jax.random.PRNGKey(2))))
    rng = np.random.default_rng(9)
    enc = tree["params"]["encoder"]
    blocks = ([enc["blocks"]["block"]] if scan
              else [enc[f"block_{i}"] for i in range(jcfg.model.n_blocks)])
    for block in blocks:
        norm = block["conv"]["norm"]
        norm["scale"] = rng.uniform(0.5, 1.5, norm["scale"].shape).astype(
            np.float32)
        norm["bias"] = rng.uniform(-0.3, 0.3, norm["bias"].shape).astype(
            np.float32)
    return tree


@pytest.mark.parametrize("scan", [True, False])
def test_group_norm_tree_round_trips(scan):
    _, tcfg = _group_configs(scan)
    tree = _group_variables(scan)
    model = Conformer(tcfg.model)
    model.load_state_dict(flax_to_state_dict(tree, tcfg.model))
    assert not any(".conv.bn." in n for n in model.state_dict())
    back = state_dict_to_flax(model.state_dict(), tcfg.model, scan=scan)
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict((jax.tree_util.keystr(p), v)
               for p, v in jax.tree_util.tree_leaves_with_path(back))
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, arr in want:
        np.testing.assert_array_equal(got[jax.tree_util.keystr(path)], arr)


def test_group_norm_logits_match_jax_with_a_padded_row():
    jcfg, tcfg = _group_configs(False)
    tree = _group_variables(False)
    rng = np.random.default_rng(1)
    mels = rng.standard_normal((3, 120, 80)).astype(np.float32)
    lengths = np.array([120, 75, 33], np.int32)
    want, want_len = jax.jit(JConformer(jcfg.model, compute_dtype="float32",
                                        deterministic=True).apply)(
        tree, jnp.asarray(mels), jnp.asarray(lengths))
    model = Conformer(tcfg.model)
    model.load_state_dict(flax_to_state_dict(tree, tcfg.model))
    with torch.no_grad():
        got, got_len = model.eval()(torch.from_numpy(mels),
                                    torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# The reference-checkpoint importer
# ---------------------------------------------------------------------------

def _jax_tool():
    """tools/import_torch_checkpoint.py (tools/ is not a package)."""
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "import_torch_checkpoint.py"
    spec = importlib.util.spec_from_file_location("import_torch_checkpoint",
                                                  str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_state_dict(cfg) -> dict:
    """Seeded tensors under the reference model's names, the shapes the
    reference layout gives them (plus the BatchNorms' step counters)."""
    m = cfg.model
    d, h, k, hid = m.d_model, m.n_heads, m.kernel_size, m.lstm_hidden_dim
    f_sub = ((m.n_mel_channels - 1) // 2 - 1) // 2
    shapes = {"encoder.downsampling_conv.conv_1.weight": (d, 1, 3, 3),
              "encoder.downsampling_conv.conv_1.bias": (d,),
              "encoder.downsampling_conv.conv_2.weight": (d, d, 3, 3),
              "encoder.downsampling_conv.conv_2.bias": (d,),
              "encoder.linear.weight": (d, d * f_sub),
              "encoder.linear.bias": (d,)}
    for i in range(m.n_blocks):
        p = f"encoder.layers.{i}."
        for j in (1, 2):
            shapes.update({f"{p}ffn_{j}.layer_norm.weight": (d,),
                           f"{p}ffn_{j}.layer_norm.bias": (d,),
                           f"{p}ffn_{j}.hidden_linear.weight": (4 * d, d),
                           f"{p}ffn_{j}.hidden_linear.bias": (4 * d,),
                           f"{p}ffn_{j}.out_linear.weight": (d, 4 * d),
                           f"{p}ffn_{j}.out_linear.bias": (d,)})
        shapes.update({f"{p}attention.layer_norm.weight": (d,),
                       f"{p}attention.layer_norm.bias": (d,)})
        a = f"{p}attention.attention."
        for proj in ("query", "key", "value", "pos", "out"):
            shapes.update({f"{a}{proj}_proj.weight": (d, d),
                           f"{a}{proj}_proj.bias": (d,)})
        shapes.update({f"{a}content_bias": (h, d // h),
                       f"{a}position_bias": (h, d // h)})
        c = f"{p}conv."
        shapes.update({f"{c}layer_norm.weight": (d,),
                       f"{c}layer_norm.bias": (d,),
                       f"{c}pointwise_conv_1.weight": (2 * d, d, 1),
                       f"{c}pointwise_conv_1.bias": (2 * d,),
                       f"{c}deepwise_conv.weight": (d, 1, k),
                       f"{c}deepwise_conv.bias": (d,),
                       f"{c}batch_norm.weight": (d,),
                       f"{c}batch_norm.bias": (d,),
                       f"{c}batch_norm.running_mean": (d,),
                       f"{c}batch_norm.running_var": (d,),
                       f"{c}pointwise_conv_2.weight": (d, d, 1),
                       f"{c}pointwise_conv_2.bias": (d,),
                       f"{p}layer_norm.weight": (d,),
                       f"{p}layer_norm.bias": (d,)})
    shapes.update({"decoder.lstm.weight_ih_l0": (4 * hid, d),
                   "decoder.lstm.weight_hh_l0": (4 * hid, hid),
                   "decoder.lstm.bias_ih_l0": (4 * hid,),
                   "decoder.lstm.bias_hh_l0": (4 * hid,),
                   "decoder.norm.weight": (hid,), "decoder.norm.bias": (hid,),
                   "decoder.norm.running_mean": (hid,),
                   "decoder.norm.running_var": (hid,),
                   "decoder.linear.weight": (m.vocab_size, hid),
                   "decoder.linear.bias": (m.vocab_size,)})
    rng = np.random.default_rng(11)
    sd = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for n, s in shapes.items()}
    for n in list(sd):
        if n.endswith("running_var"):
            sd[n] = sd[n].abs() + 0.5
    sd["decoder.norm.num_batches_tracked"] = torch.tensor(7)
    return sd


def _importer_config():
    return Config().override(**{
        "model.vocab_size": VOCAB, "model.n_blocks": 2, "model.d_model": 64,
        "model.n_heads": 2, "model.kernel_size": 7,
        "model.lstm_hidden_dim": 48})


@pytest.mark.parametrize("ddp", [False, True])
def test_importer_matches_the_jax_tool_then_convert(ddp):
    cfg = _importer_config()
    sd = _reference_state_dict(cfg)
    if ddp:
        sd = {f"module.{n}": v for n, v in sd.items()}
    tool = _jax_tool()
    ref = tool.strip_ddp_prefix({n: v.numpy() for n, v in sd.items()})
    params, stats = tool.convert_state_dict(ref, cfg.model.n_blocks,
                                            cfg.model.d_model,
                                            cfg.model.n_mel_channels,
                                            scan_layers=False)
    want = flax_to_state_dict({"params": params, "batch_stats": stats},
                              cfg.model)
    got = importer.convert_state_dict(importer.strip_ddp_prefix(sd),
                                      cfg.model)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], want[name]), name
    Conformer(cfg.model).load_state_dict(got)        # strict: every name


def test_importer_cli_writes_a_checkpoint_that_cli_test_reads(tmp_path):
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.train.checkpoint import CheckpointManager

    cfg = _importer_config()
    sd = _reference_state_dict(cfg)
    ref = tmp_path / "ref.pt"
    torch.save({"model": {f"module.{n}": v for n, v in sd.items()},
                "epoch": 3}, ref)
    ck = tmp_path / "ck"
    m = cfg.model
    importer.main([str(ref), str(ck), "--vocab-size", str(VOCAB),
                   "--n-blocks", str(m.n_blocks), "--d-model", str(m.d_model),
                   "--n-heads", str(m.n_heads),
                   "--kernel-size", str(m.kernel_size),
                   "--lstm-hidden", str(m.lstm_hidden_dim)])
    assert Config.from_json(str(ck / "config.json")).model == cfg.model
    model = Conformer(cfg.model)
    assert CheckpointManager(str(ck)).restore(model) == (0, 0)
    want = importer.convert_state_dict(sd, cfg.model)
    for name, value in model.state_dict().items():
        assert torch.equal(value, want[name]), name
    wav = _wavs(tmp_path, (0.8,))[0]
    manifest = tmp_path / "m.csv"
    with open(manifest, "w", newline="", encoding="utf8") as f:
        csv.writer(f).writerows([["path", "text"], [wav, "xin chào"]])
    metrics = cli_test.main(["--manifest", str(manifest), "--checkpoint-dir",
                             str(ck), "--device", "cpu"])
    assert np.isfinite(metrics["loss"])
