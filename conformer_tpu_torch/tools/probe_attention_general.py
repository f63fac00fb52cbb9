"""What bounds the general attention forward K1 on the card.

    python -m conformer_tpu_torch.tools.probe_attention_general

Builds variants of ``csrc/sincos_attention.cu`` with its shared header
``csrc/attention_general.cuh`` changed (the port never loads them) into
``build/probe/sincos_attention/``, and times each through the port's
wrapper on the shapes the general kernel takes: fp32 at production width
(H 8, dh 64, B 8, L 599), bf16 ModelConfig.tiny (2, 32) at B 8, L 599 and
bf16 (12, 64) at B 3, L 199, rates 0 and 0.1:

- ``kernel``: the source as it is;
- ``no_products``: no score and no value products (their k-step loops run
  no step); the ring streams every tile, the prologue, the softmax and the
  stores run: the time of the copies and the softmax;
- ``no_copies``: every cp.async of the prologue and the ring is gone; the
  products and the softmax run on what shared memory holds: the time of
  the products and the softmax;
- ``no_prologue``: no query tile built (no alpha | beta products): the
  prologue's share;
- ``rna_split``: fp32 operands split by two ``cvt.rna.tf32.f32``
  (``tf32::split``, K3's) instead of by truncation (``split_trunc``): the
  split's share;
- ``running_sum``: fp32 products summed in the tensor cores' running sum
  instead of per tile from zero (the design's guard against their
  truncating accumulation); its largest |kernel - plain| is reported
  beside the kernel's.

Prints one JSON line: device ms per variant and case, and each variant's
largest |kernel - plain|. Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import json
import math
import subprocess
from typing import Dict

import torch

from conformer_tpu_torch.ops.cuda import build
from conformer_tpu_torch.ops.cuda import sincos_attention as sa
from conformer_tpu_torch.tools.probe_attention_fwd import build_variants
from conformer_tpu_torch.tools.timing import device_ms

NAME = "sincos_attention"
VARIANTS = {
    "kernel": [],
    "no_products": [
        ("  for (int kk = 0; kk < c.width; kk += 16) {",
         "  for (int kk = 0; kk < 0 * c.width; kk += 16) {"),
        ("  for (int kk = 0; kk < c.width; kk += 8) {",
         "  for (int kk = 0; kk < 0 * c.width; kk += 8) {"),
        ("                                           const T* y, int ys) {\n",
         "                                           const T* y, int ys) {\n"
         "  return;\n"),
    ],
    "no_copies": [("  const int n = ok ? vb : 0;\n",
                   "  return;\n  const int n = ok ? vb : 0;\n")],
    "no_prologue": [("  for (int xc = 0; xc < nx; ++xc) {",
                     "  for (int xc = 0; xc < 0 * nx; ++xc) {")],
    "rna_split": [("tf32::split_trunc(", "tf32::split(", 7)],
    "running_sum": [
        ("      mma3(part[2 * np], a, b[0], b[1]);\n"
         "      mma3(part[2 * np + 1], a, b[2], b[3]);",
         "      mma3(s[2 * np], a, b[0], b[1]);\n"
         "      mma3(s[2 * np + 1], a, b[2], b[3]);"),
        ("        mma3(part[vn], a, b0, b1);",
         "        mma3(acc[vn], a, b0, b1);"),
    ],
}
# (dtype, H, dh, B, L)
CASES = ((torch.float32, 8, 64, 8, 599), (torch.bfloat16, 2, 32, 8, 599),
         (torch.bfloat16, 12, 64, 3, 199))


def inputs(dtype, h: int, dh: int, b: int, l: int, seed: int = 0):
    """K1's operands, scale folded into qu/qv, key lengths full to 0."""
    d = h * dh
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen).to("cuda", dtype)
    s = 1.0 / math.sqrt(dh)
    qu, qv, k, v = (mk(b, l, d) * (s if i < 2 else 1.0) for i in range(4))
    wh = sa.prep_pos_kernel(mk(d, d) / math.sqrt(d), h)
    lens = [l, l - 1, l // 2, 1, 0, l, 3 * l // 4, 7][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    sin_t, cos_t = sa.sincos_tables(l, d, dtype, "cuda")
    return (qu.contiguous(), qv.contiguous(), k, v, wh, lengths, sin_t,
            cos_t)


def main() -> Dict[str, dict]:
    libs = build_variants(NAME, VARIANTS)
    cases = {f"{str(dt)[6:]}_h{h}_dh{dh}_b{b}_l{l}": inputs(dt, h, dh, b, l)
             for dt, h, dh, b, l in CASES}
    saved = build._loaded.get(NAME)
    ms: Dict[str, dict] = {}
    err: Dict[str, dict] = {}
    try:
        for variant, lib in libs.items():
            build._loaded[NAME] = lib
            for key, args in cases.items():
                l = args[0].shape[1]
                for rate in (0.0, 0.1):
                    drop = (rate, 1234567, sa.hash_tq(l))
                    run = lambda: sa.sincos_attention_fwd(*args, *drop)
                    name = f"{key}_rate{rate}"
                    ms.setdefault(variant, {})[name] = device_ms(run,
                                                                 iters=20)
                    want = sa.sincos_attention_plain(*args, *drop)
                    err.setdefault(variant, {})[name] = float(
                        (run().float() - want.float()).abs().max())
    finally:
        if saved is None:
            build._loaded.pop(NAME, None)
        else:
            build._loaded[NAME] = saved
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"probe": "sincos_attention_fwd general", "card": card,
                      "ms": ms, "max_abs_err": err}), flush=True)
    return ms


if __name__ == "__main__":
    main()
