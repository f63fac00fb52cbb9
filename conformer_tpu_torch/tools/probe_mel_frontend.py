"""How K3's tiling and ring depth set its time on the card.

    python -m conformer_tpu_torch.tools.probe_mel_frontend

Builds variants of ``csrc/mel_frontend.cu`` into ``build/probe/``, each
with its choice of tiling fixed (the port never loads them), and times each
through the port's wrapper at B 8 and 2401 and 1601 frames (seeded noise,
one silent and one quiet row, as ``chip_smoke.py``'s K3 check), beside the
plain version:

- ``kernel``: the source as it is (wide 128-frame CTAs while they fit one
  an SM, else narrow 64-frame ones);
- ``wide_only`` and ``narrow_only``: one tiling at every shape;
- ``first_design``: 4 warps of two m-tiles (128 frames a CTA, 10 KB
  stages, two CTAs an SM), the tiling the kernel was first written with;
- ``running_sum``: each product accumulated by the tensor cores straight
  into the running sum (no per-k-step fp32 add), to show what that add
  buys in accuracy and costs in time.

Each variant's largest |kernel - plain| and, for both, the largest
difference from the plain version's math in float64, so that the
kernel's error and the fp32 plain version's can be told apart. Prints one
JSON line. Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from conformer_tpu_torch.audio.mel import MelFrontend, reflect_pad
from conformer_tpu_torch.config import AudioConfig
from conformer_tpu_torch.ops.cuda import build
from conformer_tpu_torch.ops.cuda import mel_frontend as mf
from conformer_tpu_torch.tools.probe_attention_fwd import build_variants
from conformer_tpu_torch.tools.timing import device_ms

NAME = "mel_frontend"
PICK = ("const bool wide = wide_ctas <= sm_count();",)
VARIANTS = {
    "kernel": [],
    "wide_only": [(*PICK, "const bool wide = wide_ctas > 0;")],
    "narrow_only": [(*PICK, "const bool wide = wide_ctas < 0;")],
    "first_design": [("using Narrow = Tile<4, 1, 5, 3>;",
                      "using Narrow = Tile<4, 2, 5, 2>;"),
                     (*PICK, "const bool wide = wide_ctas < 0;")],
    "running_sum": [("  float d[4];\n  mma0(d, lo, bh0, bh1);",
                     "  float (&d)[4] = acc;\n  mma(d, lo, bh0, bh1);"),
                    ("for (int i = 0; i < 4; ++i) acc[i] += d[i];",
                     "for (int i = 0; i < 0; ++i) acc[i] += d[i];")],
}


def inputs(seconds: int, b: int = 8, seed: int = 10):
    """chip_smoke.py's K3 operands: seeded noise at 0.1, row 0 silent, row 1
    at 1e-3 of it; reflect-padded. -> (padded, frontend, n_frames)."""
    cfg = AudioConfig()
    fe = MelFrontend(cfg, device="cuda")
    n = seconds * 16000
    gen = torch.Generator().manual_seed(seed)
    audio = torch.randn(b, n, generator=gen) * 0.1
    audio[0] = 0.0
    audio[1] *= 1e-3
    padded = reflect_pad(audio.to("cuda"), cfg.n_fft // 2).contiguous()
    return padded, fe, n // cfg.hop_length + 1


def main() -> Dict[str, dict]:
    libs = build_variants(NAME, VARIANTS)
    cfg = AudioConfig()
    cases = {s: inputs(s) for s in (24, 16)}
    result: Dict[str, dict] = {"plain": {}}
    saved = build._loaded.get(NAME)
    try:
        for seconds, (padded, fe, n_frames) in cases.items():
            args = (padded, fe._dft, fe._fb, cfg.hop_length, cfg.n_fft,
                    n_frames, cfg.log_clamp_min)
            plain = mf.logmel_plain(*args)
            exact = mf.logmel_plain(padded.double(), fe._dft.double(),
                                    fe._fb.double(), *args[3:6],
                                    cfg.log_clamp_min)
            key = f"frames{n_frames}"
            result["plain"][key] = {
                "ms": device_ms(lambda: mf.logmel_plain(*args)),
                "max_abs_err_vs_fp64": float((plain - exact).abs().max())}
            for variant, lib in libs.items():
                build._loaded[NAME] = lib
                got = mf.logmel_fwd(*args, operands=fe._k3)
                result.setdefault(variant, {})[key] = {
                    "ms": device_ms(lambda: mf.logmel_fwd(
                        *args, operands=fe._k3)),
                    "max_abs_err": float((got - plain).abs().max()),
                    "max_abs_err_vs_fp64": float((got - exact).abs().max()),
                    "finite": bool(torch.isfinite(got).all())}
    finally:
        if saved is None:
            build._loaded.pop(NAME, None)
        else:
            build._loaded[NAME] = saved
    print(json.dumps({"probe": NAME, "device": torch.cuda.get_device_name(0),
                      "result": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
