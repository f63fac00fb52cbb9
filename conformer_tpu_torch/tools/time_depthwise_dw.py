"""Device time of K4b, the depthwise conv's weight gradient.

Times ``depthwise_conv_dw`` at B 8, C 512, K 31, L 199 and 599, in bf16 and
fp32, beside its plain version, with the largest |kernel - plain| over the
largest |plain|. It uses only the wrapper's call signature, so it times
whichever ``conformer_tpu_torch`` comes first on the path: run it as a file
with ``PYTHONPATH`` set to another checkout to time that checkout's kernel
on the same card, in the same call:

    python -m conformer_tpu_torch.tools.time_depthwise_dw
    PYTHONPATH=<other checkout> python conformer_tpu_torch/tools/time_depthwise_dw.py

Prints the card's name and power limit, then one JSON object a line.
"""

from __future__ import annotations

import json
import subprocess

import torch

from conformer_tpu_torch.ops.cuda import depthwise_conv as dc
from conformer_tpu_torch.tools.timing import device_ms

B, C, K = 8, 512, 31
LENGTHS = (199, 599)


def main() -> None:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    pad = (K - 1) // 2
    for l in LENGTHS:
        for dtype in (torch.bfloat16, torch.float32):
            gen = torch.Generator().manual_seed(60)
            x, g = (torch.randn(B, l, C, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            want = dc.depthwise_conv_dw_plain(x, g, K, pad)
            got = dc.depthwise_conv_dw(x, g, K, pad)
            print(json.dumps({
                "module": dc.__file__, "b": B, "l": l, "c": C, "k": K,
                "dtype": str(dtype).removeprefix("torch."),
                "rel_err": float((got - want).abs().max()
                                 / want.abs().max()),
                "ms": device_ms(lambda: dc.depthwise_conv_dw(x, g, K, pad)),
                "plain_ms": device_ms(
                    lambda: dc.depthwise_conv_dw_plain(x, g, K, pad), iters=5),
            }), flush=True)


if __name__ == "__main__":
    main()
