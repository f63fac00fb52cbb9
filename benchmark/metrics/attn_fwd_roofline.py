"""The attention forward's share of its roofline in the traced slice: the
least time its work needs (harness/flops.py::attention_work, the rows at
their real lengths; the larger of FLOPs over the bf16 peak and bytes over
HBM bandwidth) over the device time of the kernels that the kernel group
files assign to the operation "attn_fwd". Nothing when no such kernel
ran."""

from benchmark.harness.trace import PEAK_BF16_FLOPS, PEAK_HBM_BYTES


def read(m: dict):
    tr = m.get("trace")
    seconds = tr["op_s"].get("attn_fwd") if tr else None
    if not seconds:
        return None
    f, b = tr["work"]["attn_fwd"]
    return 100.0 * max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES) / seconds
