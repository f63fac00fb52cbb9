"""The port's pseudo-labelling CLI against the JAX package's on the CPU.

``conformer_tpu.cli.pseudo_label`` (seeded random weights, fp32,
``ModelConfig.tiny``) and ``conformer_tpu_torch.cli.pseudo_label --device
cpu`` with those weights carried by ``convert.py``, on a manifest of seeded
WAVs at 16 and 8 kHz and a FLAC: the same rows, the texts exactly, each
confidence (the mean per-frame max log-prob) to 1e-4; the confidence filter
keeps what the JAX filter keeps.
"""

import csv
import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.cli import pseudo_label as j_pseudo_label
from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.decode import pipeline as jpipeline
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.audio.flac import write_flac
from conformer_tpu_torch.cli import pseudo_label
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401

SECONDS = [0.9, 1.4, 0.6, 1.7, 1.1, 0.8]
RATES = [16000, 8000, 16000, 16000, 8000, 16000]


def _read(path):
    with open(path, newline="", encoding="utf8") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(directory, manifest, port config JSON, port weights, JAX rows with
    no filter)."""
    root = tmp_path_factory.mktemp("pseudo")
    rng = np.random.default_rng(21)
    with open(root / "unlabeled.csv", "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path"])
        for i, (sec, sr) in enumerate(zip(SECONDS, RATES)):
            t = np.arange(int(sec * sr)) / sr
            sig = (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)
                   + 0.05 * rng.standard_normal(len(t)))
            ints = np.round(np.clip(sig, -1, 1) * 32767).astype(np.int16)
            if i == 3:
                path = root / f"u{i}.flac"
                write_flac(str(path), ints.astype(np.int64), sr)
            else:
                path = root / f"u{i}.wav"
                wavfile.write(path, sr, ints)
            w.writerow([str(path)])
    jcfg = JConfig(model=JModelConfig.tiny(370)).override(
        **{"optim.compute_dtype": "float32"})
    jcfg.to_json(str(root / "c.json"))
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    with mock.patch.object(jpipeline, "init_variables",
                           lambda cfg, key: init(key)):
        j_pseudo_label.main(["--manifest", str(root / "unlabeled.csv"),
                             "--checkpoint-dir", str(root / "none"),
                             "--config", str(root / "c.json"),
                             "--output", str(root / "jax.csv"),
                             "--batch-size", "4"])
    variables = init(jax.random.PRNGKey(0))
    cfg = Config.from_json(str(root / "c.json"))
    torch.save(flax_to_state_dict(variables, cfg.model), root / "w.pt")
    return root, _read(root / "jax.csv")


def _port(root, *extra):
    out = root / f"port{len(extra)}.csv"
    kept = pseudo_label.main(["--manifest", str(root / "unlabeled.csv"),
                              "--weights", str(root / "w.pt"),
                              "--config", str(root / "c.json"),
                              "--output", str(out), "--device", "cpu",
                              "--batch-size", "4", *extra])
    rows = _read(out)
    assert kept == len(rows)
    return rows


def _assert_rows_equal(got, want):
    assert [(r["path"], r["text"]) for r in got] == \
        [(r["path"], r["text"]) for r in want]
    np.testing.assert_allclose([float(r["confidence"]) for r in got],
                               [float(r["confidence"]) for r in want],
                               rtol=0, atol=1e-4)


def test_csv_equals_the_jax_cli(reference):
    root, want = reference
    assert len(want) == len(SECONDS)
    assert all(r["text"] and r["text"] == r["text"].lower() for r in want)
    _assert_rows_equal(_port(root), want)


@pytest.mark.parametrize("where", ["between", "above_all"])
def test_confidence_filter_keeps_what_the_jax_filter_keeps(reference, where):
    root, want = reference
    confs = sorted(float(r["confidence"]) for r in want)
    # halfway between two readings: no rounding moves a row across it
    threshold = ((confs[2] + confs[3]) / 2 if where == "between" else 1.0)
    kept = [r for r in want if float(r["confidence"]) >= threshold]
    got = _port(root, "--min-confidence", str(threshold))
    _assert_rows_equal(got, kept)
    assert len(got) == (len(want) - 3 if where == "between" else 0)
