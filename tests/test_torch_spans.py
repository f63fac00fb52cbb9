"""The training step's spans (utils/spans.py) and the loader's counters.

Spans off enter no ``record_function``; spans on land in the running
``torch.profiler`` session's trace as ``user_annotation`` events on the
clock of its ``cpu_op`` events; ``spans.on()`` restores what it found. The
trainer's own profiler window turns them on and writes its trace also when
the epoch ends inside it. ``BucketedLoader.wait_s`` and ``busy_s`` count
the consumer's blocked time and the loader threads' working time.
"""

import csv
import gc
import json
import threading
import time

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from conformer_tpu_torch.config import Config, DataConfig
from conformer_tpu_torch.data.dataset import BucketedLoader, ManifestDataset
from conformer_tpu_torch.text.tokenizer import load_tokenizer
from conformer_tpu_torch.utils import spans
from torch_threads import one_torch_thread  # noqa: F401

STEP_SPANS = ("train.forward", "train.backward", "train.optimizer",
              "model.lstm_head", "model.dropout", "loader.wait")


def _manifest(tmp_path, n=4):
    rng = np.random.default_rng(5)
    path = tmp_path / "m.csv"
    with open(path, "w", newline="", encoding="utf8") as f:
        w = csv.writer(f)
        w.writerow(["path", "text"])
        for i in range(n):
            wav = tmp_path / f"u{i}.wav"
            sig = np.clip(rng.standard_normal(int((0.5 + 0.2 * i) * 16000))
                          * 0.1, -1, 1)
            wavfile.write(wav, 16000, (sig * 32767).astype(np.int16))
            w.writerow([str(wav), "xin chào việt nam"[:4 + i]])
    return str(path)


def _trainer(tmp_path, **overrides):
    """A Trainer at ModelConfig.tiny's widths, with hash dropout 0.1 and
    remat on (the production model's), on the CPU; and its loader."""
    from conformer_tpu_torch.train.trainer import Trainer

    manifest = _manifest(tmp_path)
    cfg = Config().override(**{
        "model.n_blocks": 2, "model.d_model": 64, "model.n_heads": 2,
        "model.kernel_size": 7, "model.lstm_hidden_dim": 80,
        "data.batch_size": 2, "data.num_workers": 0,
        "data.bucket_boundaries_s": [2.0], "data.max_audio_s": 2.0,
        "data.train_manifest": manifest,
        "train.checkpoint_dir": str(tmp_path / "ck"),
        "train.checkpoint_every_steps": 0, "train.log_every_steps": 0,
        **overrides})
    tok = load_tokenizer("vi")
    trainer = Trainer(cfg, tok, device="cpu")
    loader = BucketedLoader(ManifestDataset(manifest, 16000), tok, cfg.data)
    return trainer, loader


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with spans off")


def test_spans_off_enter_no_record_function(tmp_path, monkeypatch):
    # (torch.optim opens record_functions of its own: only the spans' are
    # refused)
    monkeypatch.setattr(spans, "record_function", _refuse)
    trainer, loader = _trainer(tmp_path)
    assert spans.span("train.forward") is spans.span("model.dropout")
    loss = trainer.train_epoch(loader.epoch(0), 0)
    assert np.isfinite(loss) and trainer.step == 2


def test_spans_on_restores_the_previous_state_and_the_gc_hook():
    assert not spans._on and spans._gc_hook not in gc.callbacks
    with spans.on():
        assert spans._on and gc.callbacks.count(spans._gc_hook) == 1
        assert isinstance(spans.span("a"), torch.profiler.record_function)
        with spans.on():
            assert gc.callbacks.count(spans._gc_hook) == 1
        assert spans._on and spans._gc_hook in gc.callbacks
    assert not spans._on and spans._gc_hook not in gc.callbacks
    with pytest.raises(ValueError):
        with spans.on():
            raise ValueError("inside")
    assert not spans._on and spans._gc_hook not in gc.callbacks
    assert spans.span("a") is spans._NULL


def test_a_collection_under_spans_is_a_host_gc_span(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gc.collect()                        # spans off: no span
        with spans.on():
            gc.collect()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    gcs = [e for e in events if e.get("cat") == "user_annotation"
           and e["name"] == "host.gc"]
    assert len(gcs) == 1 and gcs[0]["dur"] > 0
    assert not spans._gc_open


def _trace_events(path):
    events = json.loads(path.read_text())["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def _iv(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def _inside(inner, outers):
    s, e = _iv(inner)
    return any(a <= s and e <= b for a, b in map(_iv, outers))


def test_the_trainers_window_traces_each_span_on_the_ops_clock(tmp_path):
    # a window of 5 steps over an epoch of 2: the epoch's end cuts it short,
    # and its trace is still written
    trainer, loader = _trainer(tmp_path, **{"train.profile_start_step": 0,
                                            "train.profile_num_steps": 5})
    trainer.train_epoch(loader.epoch(0), 0)
    assert trainer.step == 2
    assert not spans._on and spans._gc_hook not in gc.callbacks
    events = _trace_events(tmp_path / "ck" / "profile" / "trace.json")
    marks = [e for e in events if e.get("cat") == "user_annotation"]
    by = {n: [e for e in marks if e["name"] == n] for n in STEP_SPANS}
    for name in STEP_SPANS:
        assert by[name], name
    assert len(by["train.backward"]) == len(by["train.optimizer"]) == 2
    assert len(by["model.lstm_head"]) == 2
    # the head and dropout inside a step's forward (dropout also in remat's
    # recomputation, inside the backward)
    assert all(_inside(e, by["train.forward"]) for e in by["model.lstm_head"])
    fwd = [e for e in by["model.dropout"] if _inside(e, by["train.forward"])]
    assert fwd and all(_inside(e, by["train.forward"] + by["train.backward"])
                       for e in by["model.dropout"])
    # the four phases do not overlap on the step's thread
    main = sorted((_iv(e) for n in ("train.forward", "train.backward",
                                    "train.optimizer", "loader.wait")
                   for e in by[n]))
    assert all(b[0] >= a[1] for a, b in zip(main, main[1:]))
    # same clock: every op that starts inside a span ends inside it, and
    # every span but the loader's holds ops
    ops = [_iv(e) + (e["tid"],) for e in events if e.get("cat") == "cpu_op"]
    for name in STEP_SPANS:
        for m in by[name]:
            s, e = _iv(m)
            held = [o for o in ops if o[2] == m["tid"] and s <= o[0] < e]
            assert all(o[1] <= e + 1 for o in held), name
            if name != "loader.wait":
                assert held, name
    # the LSTM cell's tanh ops of a forward fall in the head's span
    fwd_iv = [_iv(e) for e in by["train.forward"]]
    tanh = [e for e in events if e.get("cat") == "cpu_op"
            and e["name"] == "aten::tanh"
            and any(a <= _iv(e)[0] <= b for a, b in fwd_iv)]
    assert tanh and all(_inside(e, by["model.lstm_head"]) for e in tanh)


class _SlowDataset:
    """Rows that take ``delay`` seconds each to read."""

    sample_rate = 16000

    def __init__(self, n, delay):
        self.n, self.delay = n, delay

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(self.delay)
        return np.zeros(8000, np.float32), "xin"


@pytest.mark.parametrize("workers", [0, 2])
def test_the_loader_counts_its_wait_and_its_threads_work(workers):
    n, delay = 24, 0.01
    cfg = DataConfig(batch_size=4, num_workers=workers, seed=0,
                     bucket_boundaries_s=[1.0], max_audio_s=1.0)
    loader = BucketedLoader(_SlowDataset(n, delay), load_tokenizer("vi"), cfg)
    assert loader.wait_s == loader.busy_s == 0.0
    t0 = time.perf_counter()
    assert len(list(loader.epoch(0))) == n // 4
    wall = time.perf_counter() - t0
    # every row's read is counted, by whichever thread read it
    assert n * delay <= loader.busy_s <= wall * (workers + 1)
    # the consumer did nothing but wait
    assert 0.5 * n * delay / max(workers, 1) <= loader.wait_s <= wall
    wait, busy = loader.wait_s, loader.busy_s
    list(loader.epoch(1))                   # the counters carry on
    assert loader.wait_s > wait and loader.busy_s >= busy + n * delay


def test_the_busy_counter_loses_no_count_across_threads(monkeypatch):
    import sys
    import types

    from conformer_tpu_torch.data import dataset

    loader = BucketedLoader(_SlowDataset(1, 0.0), load_tokenizer("vi"),
                            DataConfig(batch_size=1, num_workers=2))
    # every add is exactly 1 s: a lost update leaves the sum short
    monkeypatch.setattr(dataset, "time",
                        types.SimpleNamespace(perf_counter=lambda: 1.0))
    n_threads, adds = 16, 5000

    def add():
        for _ in range(adds):
            loader._add_busy(0.0)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=add) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert loader.busy_s == n_threads * adds
