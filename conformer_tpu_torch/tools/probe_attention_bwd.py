"""What bounds the bf16 attention backward K2 on the card.

    python -m conformer_tpu_torch.tools.probe_attention_bwd

Builds variants of ``csrc/sincos_attention_bwd.cu`` into
``build/probe/sincos_attention_bwd/``, each the source or its shared header
``csrc/hopper.cuh`` with statements changed (the port never loads them),
and times each through the port's wrapper at B 8, H 8, D 512, bf16, L 199
and 599, with and without dropout:

- ``kernel``: the source as it is;
- ``no_products``: every ``wgmma`` product is gone (its PTX commented out);
  the rings stream every tile, the softmax, the hash and the stores of ds,
  p_drop and da run: the time of the copies, the softmax and the stores;
- ``no_copies``: the producer arrives on each stage without copying it; the
  products, the softmax and the stores run on what the rings hold;
- ``no_stores``: q_pass stores no ds and no p_drop (the later launches read
  what the scratch holds): the cost of materialising them;
- ``recompute_k``: k_pass replaced by a key pass that recomputes the scores
  (``probe_k_pass_recompute.cuh``, spliced in): q_pass keeps alpha | beta
  and delta for it instead of p_drop, so dk and dv need no materialised
  p_drop. Its gradients are held against the kernel's.

It also times each variant's four launches (q_pass, k_pass, da_pass,
dwh_pass) under ``torch.profiler``. Prints one JSON line of device ms per
variant, length and rate, and of each launch. Needs a GPU and ``nvcc``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import torch

from conformer_tpu_torch.ops.cuda import build
from conformer_tpu_torch.ops.cuda import sincos_attention as sa
from conformer_tpu_torch.tools.probe_attention_fwd import (TMA_2D, TMA_3D,
                                                           build_variants,
                                                           inputs)
from conformer_tpu_torch.tools.timing import device_ms

NAME = "sincos_attention_bwd"
WGMMA = '"wgmma.mma_async.sync.aligned.m64n'
KERNELS = ("q_pass", "k_pass", "da_pass", "dwh_pass")
# variant -> [(text in the source or a header, its replacement[, count])]
VARIANTS = {
    "kernel": [],
    "no_products": [(WGMMA, '"// wgmma.mma_async.sync.aligned.m64n', 4)],
    "no_copies": [("  bar_expect(bar, bytes);", "  bar_arrive(bar);\n  (void)bytes;"),
                  ("bar_expect(q_full, CONSUMERS * BOX);", "bar_arrive(q_full);"),
                  (TMA_2D, TMA_2D + "  return;\n"),
                  (TMA_3D, TMA_3D + "  return;\n")],
    "no_stores": [("        if (key < L) {\n", "        if (key < 0) {\n")],
    "recompute_k": [
        # the p_drop region holds alpha | beta: rows of at least D values
        ("rows * padded_len(L));",
         "rows * (padded_len(L) > H * DH ? padded_len(L) : H * DH));"),
        # q_pass keeps alpha | beta there and delta in the da region ...
        ("bf16* __restrict__ ds_out, bf16* __restrict__ pd_out, int LP) {",
         "bf16* __restrict__ ds_out, bf16* __restrict__ pd_out, int LP,\n"
         "       float* __restrict__ delta_out) {"),
        ("              pack(-s0 * cq.x + c0 * sq.x, -s1 * cq.y + c1 * sq.y);\n"
         "        }\n",
         "              pack(-s0 * cq.x + c0 * sq.x, -s1 * cq.y + c1 * sq.y);\n"
         "          if (q < L) {\n"
         "            bf16* abq = pd_out + (((size_t)b * H + h) * L + q) * D + x;\n"
         "            *reinterpret_cast<uint32_t*>(abq) =\n"
         "                *reinterpret_cast<uint32_t*>(q_ptr + (1 + c) * PANEL + off);\n"
         "            *reinterpret_cast<uint32_t*>(abq + D2) =\n"
         "                *reinterpret_cast<uint32_t*>(q_ptr + (1 + n_half + c) * PANEL + off);\n"
         "          }\n"
         "        }\n"),
        ("      dl[hf] += __shfl_xor_sync(0xffffffffu, dl[hf], 2);\n    }\n",
         "      dl[hf] += __shfl_xor_sync(0xffffffffu, dl[hf], 2);\n"
         "      if (t == 0 && ok[hf]) delta_out[bh * L + qw + r_lo + 8 * hf] = dl[hf];\n"
         "    }\n"),
        # ... and stores no p_drop
        ("              *reinterpret_cast<uint32_t*>(pd_row[hf] + key) =\n"
         "                  pack(pdv[2 * hf], pdv[2 * hf + 1]);\n",
         "              (void)pdv;\n"),
        ("inline int padded_len(int L)",
         (Path(__file__).with_name("probe_k_pass_recompute.cuh").read_text()
          + "inline int padded_len(int L)")),
        ("q_pass<DROP><<<rows, THREADS, smem_q, stream>>>(qm, a, s.ds, s.pd, LP);",
         "q_pass<DROP><<<rows, THREADS, smem_q, stream>>>(qm, a, s.ds, s.pd, LP,\n"
         "      reinterpret_cast<float*>(s.da));"),
        ("  k_pass<<<rows, THREADS, smem_r, stream>>>(km, a);\n",
         "  RMaps rm;\n"
         "  rm.k = qm.k;\n  rm.cos_t = qm.cos_t;\n  rm.sin_t = qm.sin_t;\n"
         "  rm.qu = km.qu;\n  rm.dout = km.dout;\n"
         "  if (!encode(fn, &rm.ab, s.pd, 3, da_dims, packed_strides, 64))\n"
         "    return cudaErrorInvalidValue;\n"
         "  if ((err = set_smem(k_pass_recompute<DROP>, smem_q))) return err;\n"
         "  k_pass_recompute<DROP><<<rows, THREADS, smem_q, stream>>>(\n"
         "      rm, a, reinterpret_cast<const float*>(s.da));\n"),
    ],
}


def bwd_inputs(l: int, rate: float, b: int = 8, seed: int = 0):
    """K2's operands at (b, l): K1's inputs, its row statistics under the
    same dropout, and a seeded dO."""
    args = inputs(l, b=b, seed=seed)
    drop = (rate, 1234567, sa.hash_tq(l))
    _, stats = sa.sincos_attention_fwd(*args, *drop, stats=True)
    gen = torch.Generator().manual_seed(seed + 1)
    dout = torch.randn(args[0].shape, generator=gen).to("cuda", torch.bfloat16)
    return (*args, stats, dout, *drop)


def per_kernel_ms(call, iters: int = 10) -> Dict[str, float]:
    """Device ms of each of K2's launches, averaged over `iters` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        for k in KERNELS:
            if f"::{k}" in e.key:
                out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def agreement(libs, cases) -> Dict[str, dict]:
    """recompute_k's five gradients against the kernel's, each as max |diff|
    over the kernel's max |value|."""
    out = {}
    saved = build._loaded.get(NAME)
    try:
        for (l, rate), args in cases.items():
            grads = {}
            for variant in ("kernel", "recompute_k"):
                build._loaded[NAME] = libs[variant]
                grads[variant] = sa.sincos_attention_bwd(*args)
            out[f"l{l}_rate{rate}"] = {
                key: float((r.float() - k.float()).abs().max()
                           / k.float().abs().max())
                for key, k, r in zip(("dqu", "dqv", "dk", "dv", "dwh"),
                                     grads["kernel"], grads["recompute_k"])}
    finally:
        if saved is None:
            build._loaded.pop(NAME, None)
        else:
            build._loaded[NAME] = saved
    return out


def main() -> Dict[str, dict]:
    libs = build_variants(NAME, VARIANTS)
    cases = {(l, rate): bwd_inputs(l, rate) for l in (199, 599)
             for rate in (0.0, 0.1)}
    saved = build._loaded.get(NAME)
    result: Dict[str, dict] = {}
    launches: Dict[str, dict] = {}
    try:
        for variant, lib in libs.items():
            build._loaded[NAME] = lib
            for (l, rate), args in cases.items():
                call = lambda: sa.sincos_attention_bwd(*args)
                key = f"l{l}_rate{rate}"
                result.setdefault(variant, {})[key] = device_ms(call, iters=20)
                launches.setdefault(variant, {})[key] = per_kernel_ms(call)
    finally:
        if saved is None:
            build._loaded.pop(NAME, None)
        else:
            build._loaded[NAME] = saved
    print(json.dumps({"probe": NAME, "device": torch.cuda.get_device_name(0),
                      "ms": result, "per_launch_ms": launches,
                      "recompute_k_vs_kernel": agreement(libs, cases)}),
          flush=True)
    return result


if __name__ == "__main__":
    main()
