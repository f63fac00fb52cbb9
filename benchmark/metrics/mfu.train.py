"""The training window's model FLOPs (each row at its real length, forward
x 3, recomputation not counted: harness/flops.py) over the window's time
and one H100's bf16 dense peak."""

from benchmark.harness.trace import PEAK_BF16_FLOPS


def read(m: dict):
    return 100.0 * m["model_flops"] / (m["window_s"] * PEAK_BF16_FLOPS)
