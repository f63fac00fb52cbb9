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


def test_unported_decoders_raise():
    from conformer_tpu_torch.cli import test as cli_test
    from conformer_tpu_torch.cli.infer import main
    from conformer_tpu_torch.config import Config, ModelConfig
    from conformer_tpu_torch.decode.pipeline import InferencePipeline
    from conformer_tpu_torch.text.tokenizer import load_tokenizer

    cfg = Config(model=ModelConfig.tiny(370))
    for decode in ("beam", "beam_device"):
        with pytest.raises(NotImplementedError):
            InferencePipeline(cfg, load_tokenizer("vi"), decode=decode,
                              device="cpu")
    for flag in (["--streaming"], ["--lm", "lm.arpa"]):
        with pytest.raises(NotImplementedError):
            main(["--audio", "a.wav", "--device", "cpu", *flag])
    tiny = ["--set", "model.n_blocks=1", "--set", "model.d_model=64",
            "--set", "model.n_heads=2", "--set", "model.kernel_size=7"]
    for flag in (["--decode", "beam"], ["--decode", "beam_device"],
                 ["--decode", "beam_auto"], ["--lm", "lm.arpa"]):
        with pytest.raises(NotImplementedError):
            cli_test.main(["--manifest", "m.csv", "--device", "cpu", *tiny,
                           *flag])


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
                                    "sincos_attention_fwd_dropout": 0}
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
