"""The port's evaluation path against the JAX package on the CPU.

``InferencePipeline.evaluate`` and ``cli/test.py --device cpu`` at the tiny
width (fp32) against the JAX ``InferencePipeline.evaluate`` on a manifest of
seeded WAVs, with the JAX pipeline's weights carried across by
``conformer_tpu_torch.convert``: WER and CER equal, the loss within 1e-5
relative, the (reference, hypothesis) pairs identical, and the results CSV
with the JAX CLI's header and one row per pair.
"""

import csv
import functools
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu.config import Config as JConfig
from conformer_tpu.config import ModelConfig as JModelConfig
from conformer_tpu.decode import pipeline as jpipeline
from conformer_tpu.text.tokenizer import load_tokenizer as j_load_tokenizer
from conformer_tpu.train.steps import init_variables
from conformer_tpu_torch.cli.common import save_config
from conformer_tpu_torch.config import Config
from conformer_tpu_torch.convert import flax_to_state_dict
from conformer_tpu_torch.decode.pipeline import InferencePipeline
from conformer_tpu_torch.models.conformer import Conformer
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.train.checkpoint import CheckpointManager
from conformer_tpu_torch.train.state import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401

VOCAB = 370
TEXTS = ["xin chào", "Việt Nam", "một hai ba", "hôm nay trời đẹp", "bốn",
         "chúng tôi đi học", "năm"]
SECONDS = [0.4, 1.3, 0.7, 1.9, 1.6, 0.9, 0.5]
OVERRIDES = {"optim.compute_dtype": "float32", "data.batch_size": 2,
             "data.bucket_boundaries_s": [1.0, 2.0], "data.max_audio_s": 2.0,
             "data.num_workers": 0}


def _manifest(directory):
    rng = np.random.default_rng(11)
    path = directory / "eval.csv"
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i, (sec, text) in enumerate(zip(SECONDS, TEXTS)):
            wav = directory / f"e{i}.wav"
            sig = np.clip(rng.standard_normal(int(sec * 16000)) * 0.1, -1, 1)
            wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
            w.writerow([str(wav), text])
    return str(path)


@functools.lru_cache(maxsize=None)
def _reference(directory):
    """(port config, port state dict, JAX metrics, JAX pairs) for the
    manifest in ``directory``: the JAX pipeline with no checkpoint (its
    seeded random weights, initialised under jit: one compile instead of
    one per op), evaluated once."""
    jcfg = JConfig(model=JModelConfig.tiny(VOCAB)).override(**OVERRIDES)
    jcfg = jcfg.override(**{"train.checkpoint_dir": str(directory / "none")})
    init = jax.jit(functools.partial(init_variables, jcfg, mel_frames=32))
    with mock.patch.object(jpipeline, "init_variables",
                           lambda cfg, key: init(key)):
        pipe = jpipeline.InferencePipeline(jcfg, j_load_tokenizer("vi"))
    metrics, pairs = pipe.evaluate(str(directory / "eval.csv"))
    variables = {"params": pipe.state.params,
                 "batch_stats": pipe.state.batch_stats}
    tcfg = Config.from_dict(jcfg.to_dict())
    return tcfg, flax_to_state_dict(variables, tcfg.model), metrics, pairs


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    directory = tmp_path_factory.mktemp("evaluate")
    _manifest(directory)
    return directory, _reference(directory)


def _assert_same(metrics, pairs, want_metrics, want_pairs):
    assert pairs == want_pairs
    assert len(pairs) == len(TEXTS)
    assert metrics["wer"] == want_metrics["wer"]
    assert metrics["cer"] == want_metrics["cer"]
    np.testing.assert_allclose(metrics["loss"], want_metrics["loss"],
                               rtol=1e-5)


def test_evaluate_matches_the_jax_pipeline(reference, tmp_path):
    directory, (tcfg, state, want_metrics, want_pairs) = reference
    weights = tmp_path / "w.pt"
    torch.save(state, weights)
    pipe = InferencePipeline(tcfg, load_tokenizer("vi"), weights=str(weights),
                             device="cpu")
    metrics, pairs = pipe.evaluate(str(directory / "eval.csv"))
    _assert_same(metrics, pairs, want_metrics, want_pairs)
    # one logged batch per loader batch: 7 rows in buckets of 1 s and 2 s
    assert sum(b["batch_size"] for b in pipe.batch_log) == 8


def test_cli_test_on_cpu_restores_the_checkpoint_and_writes_results(
        reference, tmp_path, capsys):
    """Training's checkpoint directory (a checkpoint and config.json) is all
    cli/test.py needs; it prints the JAX CLI's line and writes its CSV."""
    from conformer_tpu_torch.cli.test import main

    directory, (tcfg, state, want_metrics, want_pairs) = reference
    model = Conformer(tcfg.model, "float32")
    model.load_state_dict(state)
    ck = tmp_path / "ck"
    mgr = CheckpointManager(str(ck))
    mgr.save(model, make_optimizer(tcfg.optim, model.parameters()), step=3)
    mgr.close()
    save_config(tcfg, str(ck))
    results = tmp_path / "results.csv"
    metrics = main(["--manifest", str(directory / "eval.csv"),
                    "--checkpoint-dir", str(ck), "--device", "cpu",
                    "--results", str(results)])
    out = capsys.readouterr().out
    assert "restored step 3" in out
    assert (f"WER: {metrics['wer']:.2f}%  CER: {metrics['cer']:.2f}%  "
            f"loss: {metrics['loss']:.4f}") in out
    with open(results, newline="", encoding="utf8") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["label", "prediction"]
    pairs = [tuple(r) for r in rows[1:]]
    _assert_same(metrics, pairs, want_metrics, want_pairs)
