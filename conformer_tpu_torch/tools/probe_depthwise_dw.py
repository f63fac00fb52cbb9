"""What bounds K4b's window kernel (the depthwise conv's weight gradient at
K 31) on the card.

    python -m conformer_tpu_torch.tools.probe_depthwise_dw

Builds variants of ``csrc/depthwise_conv.cu`` into ``build/probe/`` (the
port never loads them), each with one statement changed, and times each
through the port's wrapper at B 8, C 512, L 199 and 599, bf16 and fp32:

- ``kernel``: the source as it is;
- ``fp32_math``: the products and the running sums in fp32 (fmaf; no
  conversion to fp64): what the fp64 arithmetic costs;
- ``no_math``: the copies alone (no products, no fold);
- ``no_copies``: the products and the fold on whatever the ring holds (the
  producer arrives on each stage with no copy);
- ``no_frames``: no CTA takes a frame: the launch, the clusters and the
  final sums alone;
- ``stages2``: a ring of two stages (one tile in flight);
- ``two_per_sm``: only the shared memory the CTA uses, so that two CTAs
  fit an SM and the card holds a cluster of 8 for every slice of C 512
  (the scheduler may then place two on one SM).

Beside them, K4a's window kernel at B 1, L 1 through its wrapper: the time
a launch takes in this harness whatever it does.

Each variant's registers and spills from ``ptxas -v``. Prints one JSON
line. Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
from typing import Dict

import torch

from conformer_tpu_torch.ops.cuda import build
from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
from conformer_tpu_torch.tools.probe_attention_fwd import variant_sources
from conformer_tpu_torch.tools.timing import device_ms

NAME = "depthwise_conv"
VARIANTS = {
    "kernel": [],
    "fp32_math": [("double acc[K];", "float acc[K];"),
                  ("double (&acc)[K]) {", "float (&acc)[K]) {"),
                  ("double gv[DW_FPT];", "float gv[DW_FPT];"),
                  ("(double)to_float(sg[j * DW_LANES]) : 0.0;",
                   "to_float(sg[j * DW_LANES]) : 0.f;"),
                  ("const double xm = (double)to_float(sx[m * DW_LANES]);",
                   "const float xm = to_float(sx[m * DW_LANES]);"),
                  ("acc[m - j] = fma(xm, gv[j], acc[m - j]);",
                   "acc[m - j] = fmaf(xm, gv[j], acc[m - j]);")],
    "no_math": [("if (f0 < comp.te) {", "if (f0 < comp.te && L < 0) {")],
    "no_copies": [("sm90::tma_3d(dst, &maps.x, bar, c0, load.t - pad, load.b);",
                   "sm90::bar_arrive(bar);"),
                  ("sm90::tma_3d(dst + S::X_BYTES, &maps.g, bar, c0, load.t, "
                   "load.b);", "(void)dst;"),
                  ("sm90::bar_expect(bar, (int)S::STAGE);", "")],
    "no_frames": [("n0 = n * rank / splits, n1 = n * (rank + 1) / splits;",
                   "n0 = 0, n1 = 0;")],
    "stages2": [("static constexpr int STAGES = sizeof(T) == 2 ? 4 : 3;",
                 "static constexpr int STAGES = 2;")],
    "two_per_sm": [("(BYTES > 115 * 1024 ? BYTES : 115 * 1024) + 128;",
                    "BYTES + 128;")],
}


def build_variants() -> "tuple[Dict[str, ctypes.CDLL], Dict[str, str]]":
    """Compile every variant into build/probe/depthwise_conv/<variant>/, all
    nvcc processes at once. -> (libraries, the window kernels' ptxas
    lines)."""
    jobs = {}
    for variant, files in variant_sources(NAME, VARIANTS).items():
        out_dir = build.BUILD_DIR / "probe" / NAME / variant
        out_dir.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (out_dir / f).write_text(text)
        lib = out_dir / f"lib{NAME}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(out_dir / f"{NAME}.cu")]
        jobs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         lib)
    libs, ptxas = {}, {}
    for variant, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
        lines = log.splitlines()
        ptxas[variant] = [
            re.sub(r"\s+", " ", " ".join(lines[i + 1:i + 4]))
            for i, ln in enumerate(lines)
            if "Compiling entry" in ln and "dw_window" in ln]
    return libs, ptxas


def main() -> dict:
    libs, ptxas = build_variants()
    gen = torch.Generator().manual_seed(0)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for l in (199, 599):
            x, g = (torch.randn(8, l, 512, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            cases[f"{str(dtype).split('.')[-1]}_l{l}"] = (x, g)
    want = {key: dc.depthwise_conv_dw_plain(x, g, 31, 15)
            for key, (x, g) in cases.items()}
    saved = build._loaded.get(NAME)
    result: Dict[str, dict] = {}
    try:
        for variant, lib in libs.items():
            build._loaded[NAME] = lib
            for key, (x, g) in cases.items():
                got = dc.depthwise_conv_dw(x, g, 31, 15)
                rel = float((got - want[key]).abs().max()
                            / want[key].abs().max())
                ms = device_ms(lambda: dc.depthwise_conv_dw(x, g, 31, 15),
                               iters=50)
                result.setdefault(variant, {})[key] = {"ms": ms,
                                                       "rel_err": rel}
    finally:
        if saved is None:
            build._loaded.pop(NAME, None)
        else:
            build._loaded[NAME] = saved
    one = [torch.ones(*shape, device="cuda", dtype=torch.bfloat16)
           for shape in ((1, 1, 512), (31, 512), (512,))]
    floor = device_ms(lambda: dc.depthwise_conv_fwd(*one, 15), iters=50)
    splits = {}
    for variant, lib in libs.items():
        fn = lib.depthwise_conv_dw_window_splits
        fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_int
        splits[variant] = {"float32": fn(512, 0), "bfloat16": fn(512, 1)}
    out = {"probe": "depthwise_conv_dw", "splits_c512": splits, "device": torch.cuda.get_device_name(0),
           "ms": result, "k4a_b1_l1_ms": floor, "ptxas": ptxas}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
