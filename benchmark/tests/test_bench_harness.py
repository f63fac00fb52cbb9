"""CPU tests of the benchmark's harness: its parts found by name, a cell
added from new files only, the frozen FLOP arithmetic, the kernel
classifier, the traffic generator, what the benchmark imports, and the
refusal to run without a card.

    python -m pytest benchmark/tests -q
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import flops, traffic  # noqa: E402
from benchmark.harness.spec import Spec, classify  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "conformer_tpu"}
NUMBERS = {"loss1", "loss", "grad", "grad_median", "change", "change_median"}


def test_the_harness_lists_every_part_from_its_files():
    spec = Spec()
    b = spec.bench
    assert spec.cells() == [w["name"] for w in b["workloads"]]
    for w in b["workloads"]:
        config = spec.config(w["config"])
        assert "config" in config and config["reduced"] == next(
            c["reduced"] for c in b["configs"] if c["name"] == w["config"])
        t = spec.traffic(w["traffic"])
        assert callable(spec.driver(t["entry"]).run)
        assert set(spec.limits(w["name"])) & NUMBERS
        names = {m["name"] for m in spec.per_layer(w["name"])}
        assert names and all(callable(spec.reader(n).read) for n in names)
        assert {m["name"] for m in spec.end_to_end(w["name"])} >= {"setup_s"}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    groups = spec.kernel_groups()
    assert len(groups) == len(list((spec.dir / "kernels").glob("*.json")))
    ops = {g["name"]: g["operation"] for g in groups if "operation" in g}
    assert ops == {"k1_drop": "attn_fwd", "k1": "attn_fwd",
                   "k1_general": "attn_fwd", "k2": "attn_bwd",
                   "k2_general": "attn_bwd"}


def _throwaway_root(tmp_path: Path) -> Path:
    """A copy of the benchmark with one more cell, made of new files only:
    a configuration, a traffic mix, limits, a per-layer metric and a
    kernel group."""
    root = tmp_path / "root"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "toy", "source": "test",
                         "file": "benchmark/configs/toy.json",
                         "reduced": [], "why": "a throwaway"})
    b["workloads"].append({"name": "toy.cell", "config": "toy",
                           "traffic": "toy", "chips": 1, "why": "test"})
    b["end_to_end"][0]["workloads"].append("toy.cell")
    b["per_layer"].append({"name": "toy_share", "unit": "%",
                           "better": "lower", "source": "host_clock",
                           "layer": "Trainer and loader",
                           "moves": "train_audio_per_s",
                           "workloads": ["toy.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    d = root / "benchmark"
    (d / "configs" / "toy.json").write_text(json.dumps(
        {"source": "test", "reduced": [], "tokenizer": "vi",
         "config": {}}))
    (d / "traffic" / "toy.json").write_text(json.dumps({"entry": "train"}))
    (d / "limits" / "toy.cell.json").write_text(json.dumps(
        {"loss": 1, "grad": 1, "change": 1}))
    (d / "metrics" / "toy_share.py").write_text(
        "def read(m):\n    return 1.0\n")
    (d / "kernels" / "toy_attn.json").write_text(json.dumps(
        {"order": 5, "patterns": ["toy_attention_kernel"],
         "operation": "attn_fwd"}))
    return root


def test_a_cell_made_of_new_files_only_is_listed_and_resolved(tmp_path):
    spec = Spec(_throwaway_root(tmp_path))
    assert "toy.cell" in spec.cells()
    assert spec.config(spec.cell("toy.cell")["config"])["tokenizer"] == "vi"
    assert spec.driver(spec.traffic("toy")["entry"]).run
    assert [m["name"] for m in spec.per_layer("toy.cell")] == ["toy_share"]
    assert spec.reader("toy_share").read({}) == 1.0
    groups = spec.kernel_groups()
    assert groups[0]["name"] == "toy_attn"
    assert classify("void toy_attention_kernel<1>()", groups)["name"] \
        == "toy_attn"
    # the cells already there are untouched
    assert Spec().cells() == spec.cells()[:-1]


# bench.py's model_train_flops (B 8) at Config() and at
# ModelConfig.tiny(370), 801 and 2401 mel frames
PINNED = {
    ("full", 801): 1606832037120.0,
    ("full", 2401): 5236937022720.0,
    ("tiny", 801): 18248427264.0,
    ("tiny", 2401): 60727428864.0,
}


@pytest.mark.parametrize("size,frames", sorted(PINNED))
def test_the_frozen_flop_arithmetic_is_bench_pys(size, frames):
    from conformer_tpu_torch.config import Config, ModelConfig

    cfg = Config() if size == "full" else Config(model=ModelConfig.tiny(370))
    tree = cfg.to_dict()
    ns = flops._ns(tree)
    ctc = PINNED[(size, frames)]
    assert flops.model_train_flops(ns, 8, frames) == ctc
    samples = (frames - 1) * tree["audio"]["hop_length"]
    assert flops.train_flops_rows(tree, [(samples, 96)] * 8) \
        == pytest.approx(ctc, rel=1e-12)


def test_attention_work_counts_real_lengths_once():
    from conformer_tpu_torch.config import Config

    tree = Config().to_dict()
    f, b = flops.attention_work(tree, [[16000 * 8, 0]], backward=False)
    l, d = 199, 512
    assert f == 17 * (6.0 * l * l * d + 2.0 * l * d * d)
    assert b == 17 * (5.0 * l * d + d * d) * 2
    fb, _ = flops.attention_work(tree, [[16000 * 8]], backward=True)
    assert fb == 2 * f


KERNELS = {
    "void (anonymous namespace)::hopper::fwd_kernel<false>(CUtensorMap_st, "
    "int, float)": "k1",
    "void (anonymous namespace)::hopper::fwd_kernel<true>(CUtensorMap_st, "
    "int, float)": "k1_drop",
    "void (anonymous namespace)::general::fwd_kernel<__nv_bfloat16, 2, 32>"
    "(Params)": "k1_general",
    "void (anonymous namespace)::hopper::q_pass(CUtensorMap_st, int)": "k2",
    "void (anonymous namespace)::hopper::dwh_pass(float const*, int)": "k2",
    "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_warpgroup"
    "size1x1x1_execute_segment_k_off_kernel__5x_cublas": "gemm",
    "nvjet_tst_128x256_64x4_1x2_h_bz_coopA_NNT": "gemm",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "AUnaryFunctor<long, long, long, at::native::BitwiseXorFunctor<long> >,"
    " std::array<char*, 2ul> >(int, at::native::AUnaryFunctor<long, long, "
    "long, at::native::BitwiseXorFunctor<long> >, std::array<char*, 2ul>)":
        "elementwise",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
    "_nocast<at::native::BinaryFunctor<float, float, float, at::native::"
    "binary_internal::MulFunctor<float> > >(at::TensorIteratorBase&, at::"
    "native::BinaryFunctor<float, float, float, at::native::binary_internal"
    "::MulFunctor<float> > const&)::{lambda(int)#1}>(int, {lambda(int)#1})":
        "elementwise",
    "void (anonymous namespace)::elementwise_kernel<0>(float*, int)": "k5",
    "void (anonymous namespace)::logmel_kernel(Params)": "k3",
    "Memcpy HtoD (Pinned -> Device)": "memcpy_memset",
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_the_classifier_puts_known_kernels_in_their_groups(name):
    assert classify(name, Spec().kernel_groups())["name"] == KERNELS[name]


SMALL = {"buckets_s": [[1, 2], [4, 8]], "rows": [3, 2],
         "tokens_per_s": 12, "order_seed": 0,
         "words": {"count": 50, "seed": 0},
         "audio": {"noise": [0.005, 0.05], "tones": 2,
                   "tone_amp": [0.02, 0.2], "tone_hz": [80.0, 4000.0]}}


def test_the_traffic_is_fixed_work_with_content_from_the_seed(tmp_path):
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    tok = load_tokenizer("vi")
    pools = [traffic.make_pool(SMALL, seed, str(tmp_path / str(i)), tok, 64,
                               16000)
             for i, seed in enumerate((2 ** 31 + 7, 2 ** 31 + 7, 5))]
    a, b, c = pools
    assert [r["samples"] for r in a] == [r["samples"] for r in c]
    assert [r["text"] for r in a] == [r["text"] for r in b]
    assert [r["text"] for r in a] != [r["text"] for r in c]
    for ra, rb in zip(a, b):
        assert Path(ra["path"]).read_bytes() == Path(rb["path"]).read_bytes()
    for r in a + c:
        assert len(r["ids"]) == min(round(12 * r["samples"] / 16000), 64)
        assert tok.encode(r["text"]) == r["ids"]
        x = traffic.read_wav(r["path"])
        assert len(x) == r["samples"] and np.abs(x).max() > 0
    lo, hi = sorted(r["samples"] for r in a)[0], max(r["samples"] for r in a)
    assert 16000 < lo and hi <= 8 * 16000


def _imports(path: Path):
    tree = ast.parse(path.read_text(encoding="utf8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    files = [p for p in (ROOT / "benchmark").rglob("*.py")
             if "tests" not in p.parts]
    assert files
    for p in files:
        assert not set(_imports(p)) & FORBIDDEN, p
    for p in (ROOT / "benchmark" / "reference").glob("*.py"):
        assert "conformer_tpu_torch" not in set(_imports(p)), p
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run, readings\n"
        "from benchmark.harness.spec import Spec\n"
        "s = Spec()\n"
        "for c in s.cells():\n"
        "    s.driver(s.traffic(s.cell(c)['traffic'])['entry'])\n"
        "    [s.reader(m['name']) for m in s.per_layer(c)]\n"
        "import conformer_tpu_torch.train.trainer, "
        "conformer_tpu_torch.data.dataset\n"
        "print(run.forbidden_modules())\n" % str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_to_start_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "ctc_train.bucketed", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode != 0
    assert "no CUDA card" in out.stderr
    assert not [line for line in out.stdout.splitlines()
                if line.startswith("{") and '"correct"' in line]
