"""The benchmark's whole run on the CPU at a toy size: a cell of new files
(ModelConfig.tiny's widths, float32, dropout and SpecAugment on, the
kernels' plain versions) through set-up, the window, the traced slice and
the reference, then with the program broken underneath, and the control.

The toy cell's limits are its own (1e-3): in float32 the program and the
reference agree to ~1e-5 in loss and gradient and ~5e-4 in the change.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import readings, run  # noqa: E402

SEED = 3000000001


def _make_root(root: Path) -> Path:
    from conformer_tpu_torch.config import Config

    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy", "source": "test",
                         "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "toy"})
    b["workloads"].append({"name": "toy.train", "config": "toy",
                           "traffic": "toy", "chips": 1, "why": "toy"})
    for m in b["per_layer"] + b["end_to_end"][:1]:
        m["workloads"].append("toy.train")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cfg = Config().override(**{
        "model.n_blocks": 2, "model.d_model": 64, "model.n_heads": 2,
        "model.kernel_size": 7, "model.lstm_hidden_dim": 80,
        "optim.compute_dtype": "float32", "data.batch_size": 2,
        "data.num_workers": 0, "data.max_tokens": 24})
    d = root / "benchmark"
    (d / "configs" / "toy.json").write_text(json.dumps(
        {"source": "test", "reduced": [], "tokenizer": "vi",
         "config": cfg.to_dict()}))
    t = json.loads((d / "traffic" / "bucketed.json").read_text())
    t.update(buckets_s=[[0.5, 1], [1, 2]], rows=[4, 4],
             bucket_batch_sizes=[2] * 6, trace_steps=2)
    (d / "traffic" / "toy.json").write_text(json.dumps(t))
    (d / "limits" / "toy.train.json").write_text(json.dumps(
        {"loss1": 1e-3, "grad": 1e-3, "change": 1e-3}))
    return root


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    return _make_root(tmp_path_factory.mktemp("bench") / "root")


def _run(root, trace=0):
    return run.main(["--workload", "toy.train", "--seed", str(SEED),
                     "--seconds", "1", "--trace", str(trace)],
                    require_card=False, root=root)


def test_a_sound_run_is_correct(toy_root):
    out = _run(toy_root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_audio_per_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_a_traced_run_reports_the_per_layer_metrics(toy_root):
    out = _run(toy_root, trace=1)
    assert out["correct"], out["checks"]
    # no kernel ran on the CPU: the rooflines find nothing to read
    assert set(out["metrics"]) == {"loader_wait.train", "padding.train",
                                   "mfu.train", "device_idle.train",
                                   "launches.train"}
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_step_that_leaves_its_state_unchanged_is_not_correct(
        toy_root, monkeypatch):
    from conformer_tpu_torch.train import state

    def no_update(self):
        import torch

        self.count += 1
        return torch.zeros(())

    monkeypatch.setattr(state.Optimizer, "step", no_update)
    out = _run(toy_root)
    assert not out["correct"]
    assert out["checks"]["change"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(toy_root, monkeypatch):
    import torch
    from conformer_tpu_torch.train import steps

    real = steps.ctc_loss

    def half(*args, row_mask=None, **kw):
        keep = torch.arange(len(row_mask)) < len(row_mask) // 2
        return real(*args, row_mask=row_mask & keep.to(row_mask.device),
                    **kw)

    monkeypatch.setattr(steps, "ctc_loss", half)
    out = _run(toy_root)
    assert not out["correct"]
    assert out["checks"]["loss1"]["value"] > 1e-2


def test_a_token_altered_where_it_is_made_is_not_correct(toy_root,
                                                         monkeypatch):
    from conformer_tpu_torch.text.tokenizer import GraphemeTokenizer

    real = GraphemeTokenizer.encode_batch

    def altered(self, sentences, max_len=None):
        tokens, lengths = real(self, sentences, max_len)
        tokens[:, 0] = (tokens[:, 0] % 300) + 1
        return tokens, lengths

    monkeypatch.setattr(GraphemeTokenizer, "encode_batch", altered)
    out = _run(toy_root)
    assert not out["correct"]


def test_the_control_in_float8_is_not_correct(toy_root):
    lim = json.loads((toy_root / "benchmark" / "limits" /
                      "toy.train.json").read_text())
    r = readings.main(["--workload", "toy.train", "--seeds", str(SEED),
                       "--control-seeds", str(SEED)], require_card=False,
                      root=toy_root)[0]
    assert all(r["program"][k] <= lim[k] for k in lim)
    assert any(r["fp8"][k] > lim[k] for k in lim)
    assert any(r["half_batch"][k] > lim[k] for k in lim)
