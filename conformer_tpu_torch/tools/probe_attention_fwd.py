"""What bounds the bf16 attention forward K1 on the card.

    python -m conformer_tpu_torch.tools.probe_attention_fwd

Builds variants of ``csrc/sincos_attention.cu`` into ``build/probe/``, each
the source or its shared header ``csrc/hopper.cuh`` with one constant or
statement changed (the port never loads them), and times each through the
port's wrapper at B 8, H 8, D 512, bf16, L 199 and 599, with and without
dropout:

- ``kernel``: the source as it is (two consumer warpgroups, 128-row tiles);
- ``rows64``: one consumer warpgroup, so 64-row query tiles;
- ``loads_only``: no score or value products; the ring streams every tile
  and the consumers take and release them: the time of the copies;
- ``math_only``: the producer arrives on each stage without copying it;
  the products and the softmax run on what the ring holds: the time of the
  products and the softmax alone.

Prints one JSON line of device ms per variant, length and rate. Needs a GPU
and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
from typing import Dict

import torch

from conformer_tpu_torch.ops.cuda import build
from conformer_tpu_torch.ops.cuda import sincos_attention as sa
from conformer_tpu_torch.tools.timing import device_ms

NAME = "sincos_attention"
SCORES = "wgmma_ss<0>(s, desc_k(a + 32 * kk), desc_k(kt + 32 * kk));"
VALUES = "wgmma_rs<1>(o, p[kk], desc_mn(vt + 2048 * kk));"
ARM = "  bar_expect(bar, bytes);"
TMA_2D = "uint32_t bar, int c0, int c1) {\n"
TMA_3D = "uint32_t bar, int c0, int c1, int c2) {\n"
# variant -> [(text in the source, its replacement)]
VARIANTS = {
    "kernel": [],
    "rows64": [("constexpr int CONSUMERS = 2;", "constexpr int CONSUMERS = 1;")],
    "loads_only": [(SCORES, "(void)a; (void)kt;"),
                   (VALUES, "(void)p; (void)vt;")],
    "math_only": [(ARM, "  bar_arrive(bar);\n  (void)bytes;"),
                  ("bar_expect(q_full, CONSUMERS * BOX);", "bar_arrive(q_full);"),
                  (TMA_2D, TMA_2D + "  return;\n"),
                  (TMA_3D, TMA_3D + "  return;\n")],
}


def variant_sources(name: str = NAME, variants: Dict[str, list] = VARIANTS
                    ) -> Dict[str, Dict[str, str]]:
    """-> {variant: {file name: text}} of csrc/<name>.cu and the headers. An
    edit (old, new) or (old, new, count) changes the one file that holds
    `old`, which must occur `count` times (default once) in all of them."""
    texts = {path.name: path.read_text()
             for path in [build.CSRC / f"{name}.cu",
                          *sorted(build.CSRC.glob("*.cuh"))]}
    out = {}
    for variant, edits in variants.items():
        files = dict(texts)
        for old, new, *count in edits:
            found = {f: t.count(old) for f, t in files.items() if old in t}
            if sum(found.values()) != (count[0] if count else 1) or len(found) != 1:
                raise RuntimeError(f"{variant}: {old!r} occurs {found}")
            (f,) = found
            files[f] = files[f].replace(old, new)
        out[variant] = files
    return out


def build_variants(name: str = NAME, variants: Dict[str, list] = VARIANTS
                   ) -> Dict[str, ctypes.CDLL]:
    """Write and compile every variant into build/probe/<name>/<variant>/,
    all nvcc processes at once."""
    jobs = {}
    for variant, files in variant_sources(name, variants).items():
        out_dir = build.BUILD_DIR / "probe" / name / variant
        out_dir.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (out_dir / f).write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
               str(out_dir / f"{name}.cu")]
        jobs[variant] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         lib)
    libs = {}
    for variant, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {variant}:\n{log}")
        libs[variant] = ctypes.CDLL(str(lib))
    return libs


def inputs(l: int, b: int = 8, h: int = 8, seed: int = 0):
    """K1's operands at (b, l), H 8, dh 64, bf16, lengths full to 0."""
    d = h * 64
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to("cuda", torch.bfloat16)
    qu, qv, k, v = (mk(b, l, d) * (1.0 if i > 1 else 0.125) for i in range(4))
    wh = sa.prep_pos_kernel(mk(d, d) / math.sqrt(d), h)
    lens = [l, l - 1, l // 2, 1, 0, l, 3 * l // 4, 7][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sin_t, cos_t = sa.sincos_tables(l, d, torch.bfloat16, "cuda")
    return qu.contiguous(), qv.contiguous(), k, v, wh, lengths, sin_t, cos_t


def main() -> Dict[str, dict]:
    libs = build_variants()
    cases = {l: inputs(l) for l in (199, 599)}
    saved = build._loaded.get(NAME)
    result: Dict[str, dict] = {}
    try:
        for variant, lib in libs.items():
            build._loaded[NAME] = lib
            for l, args in cases.items():
                for rate in (0.0, 0.1):
                    drop = (rate, 1234567, sa.hash_tq(l))
                    result.setdefault(variant, {})[f"l{l}_rate{rate}"] = (
                        device_ms(lambda: sa.sincos_attention_fwd(*args, *drop),
                                  iters=50))
    finally:
        if saved is None:
            build._loaded.pop(NAME, None)
        else:
            build._loaded[NAME] = saved
    print(json.dumps({"probe": "sincos_attention_fwd", "device":
                      torch.cuda.get_device_name(0), "ms": result}), flush=True)
    return result


if __name__ == "__main__":
    main()
