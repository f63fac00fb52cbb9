"""harness/spans.py on a hand-built trace (two threads, nested spans, kernels
joined to their launches by correlation, idle gaps inside and outside the
spans), on a trace without spans, and slice_spans.py's whole run on the
CPU at the toy cell's size."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import slice_spans  # noqa: E402
from benchmark.harness import spans  # noqa: E402
from benchmark.harness.trace import ANNOTATION  # noqa: E402

MAIN, AUTOGRAD, DEVICE = 11, 12, 7


def _x(cat, name, ts, end, tid, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
         "pid": 1 if tid != DEVICE else 0, "tid": tid}
    if args:
        e["args"] = args
    return e


def _trace():
    ann = lambda name, s, e, tid=MAIN: _x("user_annotation", name, s, e, tid)
    launch = lambda corr, ts, tid=MAIN: _x("cuda_runtime", "cudaLaunchKernel",
                                           ts, ts + 5, tid, correlation=corr)
    kernel = lambda corr, s, e: _x("kernel", f"k{corr}", s, e, DEVICE,
                                   correlation=corr)
    return [
        ann(ANNOTATION, 0, 1200),
        ann("train.forward", 0, 400),
        ann("model.dropout", 100, 150),
        ann("model.lstm_head", 200, 300),
        ann("train.backward", 400, 800),
        ann("model.dropout", 500, 550, AUTOGRAD),    # remat's recomputation
        ann("train.optimizer", 800, 900),
        ann("Optimizer.step#Adam.step", 800, 900),   # torch's own: not a span
        ann("host.gc", 850, 860),
        ann("loader.wait", 900, 1000),
        launch(5, 50), launch(1, 120), launch(2, 250), launch(6, 410),
        launch(3, 520, AUTOGRAD), launch(4, 600), launch(7, 855),
        launch(8, 1005),
        kernel(5, 60, 100), kernel(1, 130, 160), kernel(2, 260, 330),
        kernel(6, 480, 510), kernel(3, 540, 560), kernel(4, 610, 700),
        kernel(7, 870, 880), kernel(99, 1100, 1110), kernel(8, 1150, 1160),
        _x("gpu_memcpy", "Memcpy HtoD", 700, 720, DEVICE),
        _x("cpu_op", "aten::mm", 20, 40, MAIN),
    ]


def _us(d):
    return {k: pytest.approx(v * 1e-6) for k, v in d.items()}


def test_spans_are_read_from_a_hand_built_trace():
    got = spans.read(_trace())
    assert got["span_s"] == _us({
        "train.forward": 400, "train.backward": 400, "train.optimizer": 100,
        "model.dropout": 100, "model.lstm_head": 100, "host.gc": 10,
        "loader.wait": 100})
    assert got["main_s"] == pytest.approx(1000e-6)
    # by the innermost span on the launching thread; kernel 99 has no
    # launch, kernel 8 was launched outside every span
    assert got["kernel_s"] == _us({
        "train.forward": 40, "model.dropout": 30 + 20,
        "model.lstm_head": 70, "train.backward": 30 + 90, "host.gc": 10,
        spans.NONE: 10 + 10})
    assert got["kernels_s"] == pytest.approx(310e-6)
    # the gap at 525 lies in the backward (main thread) and in the
    # recomputed dropout (autograd thread): the span opened last names it
    assert got["idle_s"] == _us({
        "train.forward": 60, "model.dropout": 30 + 30,
        "model.lstm_head": 100, "train.backward": 150 + 50 + 150,
        "loader.wait": 220, spans.NONE: 40})


def test_the_shares_of_a_hand_built_slice():
    tr = {"window_s": 1200e-6, "busy_s": 390e-6}
    got = slice_spans.shares(tr, spans.read(_trace()))
    assert got["host_forward.train"] == pytest.approx(100 * 400 / 1200)
    assert got["gc_pause.train"] == pytest.approx(100 * 10 / 1200)
    assert got["main_spans_cover"] == pytest.approx(100 * 1000 / 1200)
    assert got["dropout_device.train"] == pytest.approx(100 * 50 / 310)
    assert got["idle_unattributed.train"] == pytest.approx(100 * 40 / 830)


def test_a_trace_without_spans_reads_no_span():
    events = [e for e in _trace() if e["cat"] != "user_annotation"
              or e["name"] == ANNOTATION]
    got = spans.read(events)
    assert got["span_s"] == {} and got["main_s"] == 0
    assert set(got["kernel_s"]) == set(got["idle_s"]) == {spans.NONE}
    shares = slice_spans.shares({"window_s": 1200e-6, "busy_s": 390e-6}, got)
    assert set(shares) == {"main_spans_cover", "device_idle.train",
                           "idle_unattributed.train"}
    assert shares["idle_unattributed.train"] == pytest.approx(100.0)


def test_slice_spans_reads_the_toy_cell_on_the_cpu(tmp_path):
    from test_bench_rehearsal import SEED, _make_root

    root = _make_root(tmp_path / "root")
    out = slice_spans.main(
        ["--workload", "toy.train", "--seed", str(SEED), "--seconds", "1",
         "--cost-steps", "2", "--cost-passes", "1"],
        require_card=False, root=root)
    for name in ("host_forward.train", "host_backward.train",
                 "host_optimizer.train", "lstm_head.train",
                 "main_spans_cover", "loader_queue_wait.train",
                 "loader_busy.train"):
        assert 0 < out[name] <= 100, name
    # no kernel ran on the CPU
    assert "dropout_device.train" not in out
    assert out["slice"]["kernels_s"] == 0
    assert set(out["slice"]["span_s"]) >= {
        "train.forward", "train.backward", "train.optimizer",
        "model.lstm_head", "model.dropout", "loader.wait"}
    assert out["cost"]["order"] == ["off", "on"]
    assert all(len(v["wall_ms_per_step"]) == 1
               for k, v in out["cost"].items() if k in ("off", "on"))
