"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, importing it builds nothing, its entry points refuse to fall back
to the CPU quietly, and its kernel wrappers take the plain path only for
CPU tensors."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "conformer_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "conformer_tpu"}


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_or_jax_package_import_anywhere_in_the_port():
    files = _port_files()
    assert len(files) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN)
           for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


_BLOCKED_IMPORT = r'''
import importlib, pkgutil, subprocess, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "orbax",
                                  "conformer_tpu", "triton"}:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())

_popen = subprocess.Popen

class NoCompiler(_popen):
    def __init__(self, args, *rest, **kwargs):
        if "nvcc" in str(args):
            raise AssertionError(f"nvcc was started at import: {args}")
        super().__init__(args, *rest, **kwargs)

subprocess.Popen = NoCompiler
import conformer_tpu_torch
names = [m.name for m in pkgutil.walk_packages(conformer_tpu_torch.__path__,
                                               "conformer_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from conformer_tpu_torch.ops.cuda import build
assert build.BUILD_LOG == {} and build._loaded == {}
print(len(names))
'''


def test_the_mesh_modules_are_held_to_it_too():
    files = {str(p.relative_to(ROOT)) for p in _port_files()}
    assert {"conformer_tpu_torch/parallel/mesh.py",
            "conformer_tpu_torch/parallel/collectives.py"} <= files
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT.replace(
            "print(len(names))", "print(sorted(n for n in names "
            "if '.parallel' in n))")],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "conformer_tpu_torch.parallel.mesh" in out.stdout
    assert "conformer_tpu_torch.parallel.collectives" in out.stdout


def test_every_module_imports_with_jax_blocked_and_builds_nothing():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 20


def test_entry_points_refuse_a_missing_gpu(monkeypatch, tmp_path):
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.cli.infer import main
    from conformer_tpu_torch.config import Config, ModelConfig
    from conformer_tpu_torch.decode.pipeline import InferencePipeline
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(model=ModelConfig.tiny(370))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferencePipeline(cfg, load_tokenizer("vi"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--audio", str(tmp_path / "a.wav"), "--set", "model.n_blocks=1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["--manifest", str(tmp_path / "m.csv"),
                       "--set", "model.n_blocks=1"])


_DEVICE_BEAMS = r'''
import csv, os, sys
import numpy as np
from scipy.io import wavfile

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "optax", "orbax",
                                  "conformer_tpu"}:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import torch
torch.set_num_threads(1)
from conformer_tpu_torch.cli import test as cli_test
from conformer_tpu_torch.cli.infer import main
from conformer_tpu_torch.text.tokenizer import load_tokenizer

tok = load_tokenizer("vi")
rng = np.random.default_rng(0)
wav = os.path.abspath("a.wav")
wavfile.write(wav, 16000, (rng.standard_normal(12000) * 3000).astype(np.int16))
with open("m.csv", "w", newline="", encoding="utf8") as f:
    csv.writer(f).writerows([["path", "text"], [wav, "xin chào"]])
# a word ARPA and a token ARPA, written out
words = ["XIN", "CHÀO"]
with open("w.arpa", "w", encoding="utf8") as f:
    f.write("\\data\\\nngram 1=4\n\n\\1-grams:\n-1.0\t<s>\t-0.3\n"
            "-0.5\t</s>\n-0.6\tXIN\t-0.2\n-0.7\tCHÀO\t-0.2\n\n\\end\\\n")
toks = [t for t in tok.vocab[1:40]]
with open("t.arpa", "w", encoding="utf8") as f:
    f.write("\\data\\\nngram 1=%d\nngram 2=1\n\n\\1-grams:\n" % (len(toks) + 2))
    f.write("-1.0\t<s>\t-0.3\n-1.5\t</s>\n")
    f.write("".join("-1.6\t%s\t-0.1\n" % t for t in toks))
    f.write("\n\\2-grams:\n-0.4\t%s %s\n\n\\end\\\n" % (toks[0], toks[1]))
tiny = ["--set", "model.n_blocks=1", "--set", "model.d_model=64",
        "--set", "model.n_heads=2", "--set", "model.kernel_size=7",
        "--set", "model.lstm_hidden_dim=80", "--set", "decode.beam_width=8",
        "--decode", "beam_device"]
device_lm = ["--set", "decode.device_lm_path=t.arpa"]
decodes = []
for flag in (["--streaming", "--lm", "w.arpa", "--set",
              'decode.hotwords=["XIN CHÀO"]'], device_lm):
    decodes.append(main(["--audio", wav, "--device", "cpu", *tiny,
                         *flag]).decode)
metrics = []
for flag in (["--lm", "w.arpa"], device_lm):
    metrics.append(cli_test.main(["--manifest", "m.csv", "--device", "cpu",
                                  *tiny, *flag]))
assert all(np.isfinite(m["loss"]) for m in metrics), metrics
assert not {m for m in sys.modules
            if m.split(".")[0] in {"jax", "flax", "conformer_tpu"}}
print(decodes, len(metrics))
'''


def test_unported_decoders_raise(tmp_path):
    """Once refused, the device beam paths (decode beam_device, offline and
    streaming, word-level fusion and a hotword from --lm and token-level
    from a device LM, through cli.infer and cli.test) now run the port's
    eager search on the CPU, with JAX and the JAX package blocked from
    import."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _DEVICE_BEAMS], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    # the streaming run's pipeline holds only the model (greedy)
    assert out.stdout.strip().splitlines()[-1] == \
        "['greedy', 'beam_device'] 2"


def test_wrappers_take_the_plain_path_on_cpu_and_count_nothing():
    from conformer_tpu_torch.audio.mel import MelFrontend
    from conformer_tpu_torch.ops import cuda
    from conformer_tpu_torch.ops.cuda import sincos_attention as sa
    from conformer_tpu_torch.ops.cuda.mel_frontend import logmel_fwd

    from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
    from conformer_tpu_torch.ops.cuda.vpu_pass import vpu_pass, vpu_pass_plain

    cuda.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    qu, qv, k, v = (torch.randn(2, 9, 128, generator=g) for _ in range(4))
    wh = sa.prep_pos_kernel(torch.randn(128, 128, generator=g) / 11.3, 2)
    sin_t, cos_t = sa.sincos_tables(9, 128)
    lengths = torch.tensor([9, 4], dtype=torch.int32)
    out = sa.sincos_attention_fwd(qu, qv, k, v, wh, lengths, sin_t, cos_t)
    assert torch.equal(out, sa.sincos_attention_plain(qu, qv, k, v, wh,
                                                      lengths, sin_t, cos_t))
    fe = MelFrontend()
    logmel_fwd(torch.randn(2, 4000, generator=g), fe._dft, fe._fb, 160, 400,
               23)
    dout = torch.randn(2, 9, 128, generator=g)
    grads = sa.sincos_attention_bwd(qu, qv, k, v, wh, lengths, sin_t, cos_t,
                                    None, dout, 0.1, 7, 16)
    want = sa.sincos_attention_bwd_plain(qu, qv, k, v, wh, lengths, sin_t,
                                         cos_t, None, dout, 0.1, 7, 16)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))
    w, bias = torch.randn(7, 128, generator=g), torch.randn(128, generator=g)
    assert torch.equal(dc.depthwise_conv_fwd(qu, w, bias, 3),
                       dc.depthwise_conv_plain(qu, w, bias, 3))
    assert torch.equal(dc.depthwise_conv_dw(qu, dout, 7, 3),
                       dc.depthwise_conv_dw_plain(qu, dout, 7, 3))
    assert torch.equal(vpu_pass(qu[0], "exp", 2, 9),
                       vpu_pass_plain(qu[0], "exp", 2))
    assert cuda.launch_counts() == {"sincos_attention_fwd": 0,
                                    "sincos_attention_bwd": 0,
                                    "logmel_fwd": 0,
                                    "depthwise_conv_fwd": 0,
                                    "depthwise_conv_dw": 0,
                                    "vpu_pass": 0,
                                    "sincos_attention_fwd_dropout": 0,
                                    "sincos_attention_fwd_general": 0,
                                    "sincos_attention_bwd_general": 0,
                                    "sincos_attention_fwd_general_fp32": 0,
                                    "sincos_attention_bwd_general_fp32": 0,
                                    "depthwise_conv_fwd_window": 0,
                                    "depthwise_conv_dw_window": 0}
    # Any other device has no plain path and no kernel: it raises.
    meta = [x.to("meta") for x in (qu, qv, k, v, wh, lengths, sin_t, cos_t)]
    with pytest.raises(ValueError, match="no kernel"):
        sa.sincos_attention_fwd(*meta)
    with pytest.raises(ValueError, match="no kernel"):
        sa.sincos_attention_bwd(*meta, None, meta[0])
    with pytest.raises(ValueError, match="no kernel"):
        dc.depthwise_conv_fwd(meta[0], w.to("meta"), bias.to("meta"), 3)
    with pytest.raises(ValueError, match="no kernel"):
        dc.depthwise_conv_dw(meta[0], meta[0], 7, 3)
    with pytest.raises(ValueError, match="no kernel"):
        vpu_pass(meta[0][0], "add", 1, 9)


def test_chip_smoke_refuses_to_run_without_a_gpu():
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_time_attention_refuses_to_run_without_a_gpu(monkeypatch, capsys):
    from conformer_tpu_torch.tools import time_attention

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        time_attention.main()
    assert capsys.readouterr().out == ""


def test_chip_smoke_holds_each_attention_gradient_slice_to_its_own_scale():
    """chip_smoke's K2 check: a row whose gradient is 100x another's sets no
    scale for it, so a wrong slice of a full row fails however small."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    g = torch.Generator().manual_seed(0)
    want = torch.randn(2, 5, 8, generator=g) * 0.1       # B 2, L 5, H 2, dh 4
    want[1, 0] *= 100.0                                   # a short row's key
    assert chip_smoke.k2_rel_err(want, want, "dv", 2) == 0.0
    got = want.clone()
    got.view(2, 5, 2, 4)[0, :, 0] = 0.0                   # batch row 0, head 0
    whole_tensor = float((got - want).abs().max() / want.abs().max())
    assert whole_tensor < chip_smoke.TOL_K2["bfloat16"]  # one scale passes it
    assert chip_smoke.k2_rel_err(got, want, "dv", 2) == pytest.approx(1.0)
    dwh = torch.randn(2, 4, 8, generator=g)               # (H, dh, D)
    dwh[1] *= 100.0
    off = dwh.clone()
    off[0] *= 1.01
    assert chip_smoke.k2_rel_err(off, dwh, "dwh", 2) == pytest.approx(0.01,
                                                                      rel=1e-3)


def test_chip_smoke_same_bits_tells_one_flipped_bit():
    """chip_smoke's determinism check compares K2's gradients as bits: one
    flipped low bit fails it, NaNs in the same places pass, and -0.0 is not
    0.0."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    g = torch.Generator().manual_seed(1)
    grads = (torch.randn(2, 5, 8, generator=g).to(torch.bfloat16),
             torch.randn(2, 4, 8, generator=g))
    grads[1][0, 0, 0] = float("nan")
    same = tuple(x.clone() for x in grads)
    assert chip_smoke.same_bits(torch, grads, same)
    flipped = same[1].clone()
    flipped.view(torch.int32)[1, 2, 3] ^= 1                # one ulp of fp32
    assert torch.allclose(flipped, same[1], equal_nan=True)
    assert not chip_smoke.same_bits(torch, grads, (same[0], flipped))
    low = same[0].clone()
    low.view(torch.int16)[0, 0, 0] ^= 1                   # one ulp of bf16
    assert not chip_smoke.same_bits(torch, grads, (low, same[1]))
    zeros = torch.zeros(3)
    assert not chip_smoke.same_bits(torch, (zeros,), (-zeros,))
    assert not chip_smoke.same_bits(torch, grads, grads[:1])


@pytest.mark.parametrize("probe", ["probe_attention_fwd",
                                   "probe_attention_bwd",
                                   "probe_attention_general",
                                   "probe_mel_frontend"])
def test_attention_probe_variants_edit_the_current_sources(probe):
    """Each probe variant's text edits apply to the committed sources and
    headers (each edit where it names its count), and only the kernel
    variant is the source unchanged; nothing is compiled here."""
    import importlib

    from conformer_tpu_torch.tools import probe_attention_fwd as fwd

    mod = importlib.import_module(f"conformer_tpu_torch.tools.{probe}")
    sources = fwd.variant_sources(mod.NAME, mod.VARIANTS)
    assert set(sources) == set(mod.VARIANTS)
    for variant, files in sources.items():
        assert f"{mod.NAME}.cu" in files and "hopper.cuh" in files
        changed = [f for f in files if files[f] != sources["kernel"][f]]
        assert bool(changed) == (variant != "kernel"), variant


def test_chip_smoke_times_sdpa_under_each_backend_that_takes_the_call(
        monkeypatch):
    """chip_smoke's yardstick: SDPA is set up and timed under each backend,
    a backend that refuses the call is left out, and the fastest is named.
    On the CPU only the math backend takes SDPA; a stand-in clock gives the
    refusing backends no time to report."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    ran = []

    def fake_ms(torch_, fn, iters=20, warmup=3):
        fn()
        ran.append(torch.backends.cuda.math_sdp_enabled())
        return 0.5

    monkeypatch.setattr(chip_smoke, "cuda_ms", fake_ms)
    q = torch.randn(1, 2, 5, 8)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(q, q, q)
    times, best = chip_smoke.sdpa_times(torch, lambda: sdpa)
    assert times == {"math": 0.5} and best == "math"
    assert ran == [True]
