"""Device time of the attention kernels K1 and K2.

Times ``sincos_attention_fwd`` (K1) and ``sincos_attention_bwd`` (K2) at
B 8, H 8, dh 64, D 512, L 199 and 599, rates 0 and 0.1, in fp32 and bf16
(fp32 takes the general kernels, bf16 the wgmma ones), and the general
kernels in bf16 at GENERAL_BF16 (ModelConfig.tiny's (H, dh) = (2, 32) at
B 8, L 599 and (12, 64), D 768, at B 3, L 199), rates 0 and 0.1, beside
their plain versions, with the largest |kernel - plain| of each
call's outputs. It uses only the wrappers' call signatures, so it times
whichever ``conformer_tpu_torch`` comes first on the path: run it as a file
with ``PYTHONPATH`` set to another checkout to time that checkout's kernels
on the same card, in the same call:

    python -m conformer_tpu_torch.tools.time_attention
    PYTHONPATH=<other checkout> python conformer_tpu_torch/tools/time_attention.py

Prints one JSON object a line and, first, the card's name and power limit.
"""

from __future__ import annotations

import json
import math
import subprocess

import torch

from conformer_tpu_torch.ops.cuda import sincos_attention as sa
from conformer_tpu_torch.tools.timing import device_ms

B, H, DH = 8, 8, 64
LENGTHS = (199, 599)
# (H, dh, B, L) of the bf16 shapes the general kernels take
GENERAL_BF16 = ((2, 32, 8, 599), (12, 64, 3, 199))
RATES = (0.0, 0.1)
DROPOUT_SEED = 1234567


def inputs(l: int, dtype, seed: int, h: int = H, dh: int = DH, b: int = B):
    """Seeded operands as chip_smoke.py makes them: scale folded into qu
    and qv, key lengths full, one short, half, 1, 0, full, 3/4, 7."""
    d = h * dh
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=gen)
    dev = torch.device("cuda")
    qu, qv, k, v = (mk(b, l, d).to(dev, dtype) for _ in range(4))
    wh = sa.prep_pos_kernel((mk(d, d) / math.sqrt(d)).to(dev, dtype), h)
    lens = [l, l - 1, l // 2, 1, 0, l, 3 * l // 4, 7][:b]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    s = torch.tensor(1.0 / math.sqrt(dh), dtype=dtype, device=dev)
    sin_t, cos_t = sa.sincos_tables(l, d, dtype, dev)
    dout = mk(b, l, d).to(dev, dtype)
    return ((qu * s).contiguous(), (qv * s).contiguous(), k, v, wh, lengths,
            sin_t, cos_t), dout


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max())
               for g, w in zip(got, want))


def run(dtype, l: int, rate: float, seed: int, h: int = H, dh: int = DH,
        b: int = B) -> dict:
    args, dout = inputs(l, dtype, seed, h, dh, b)
    drop = (rate, DROPOUT_SEED, sa.hash_tq(l))
    out, stats = sa.sincos_attention_fwd(*args, *drop, stats=True)
    bwd_args = (*args, stats, dout, *drop)
    fwd_err = max_err((out,), (sa.sincos_attention_plain(*args, *drop),))
    bwd_err = max_err(sa.sincos_attention_bwd(*bwd_args),
                      sa.sincos_attention_bwd_plain(*bwd_args))
    return {
        "dtype": str(dtype).replace("torch.", ""), "b": b, "l": l, "h": h,
        "dh": dh, "rate": rate,
        "k1_ms": device_ms(lambda: sa.sincos_attention_fwd(*args, *drop)),
        "k1_plain_ms": device_ms(
            lambda: sa.sincos_attention_plain(*args, *drop), iters=5),
        "k1_max_abs_err": fwd_err,
        "k2_ms": device_ms(lambda: sa.sincos_attention_bwd(*bwd_args)),
        "k2_plain_ms": device_ms(
            lambda: sa.sincos_attention_bwd_plain(*bwd_args), iters=5),
        "k2_max_abs_err": bwd_err,
    }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_attention needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"package": sa.__file__}))
    for i, dtype in enumerate((torch.float32, torch.bfloat16)):
        for l in LENGTHS:
            for rate in RATES:
                print(json.dumps(run(dtype, l, rate, seed=500 + i)),
                      flush=True)
    for i, (h, dh, b, l) in enumerate(GENERAL_BF16):
        for rate in RATES:
            print(json.dumps(run(torch.bfloat16, l, rate, 510 + i, h, dh, b)),
                  flush=True)


if __name__ == "__main__":
    main()
