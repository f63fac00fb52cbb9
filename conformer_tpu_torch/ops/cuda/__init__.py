"""Hand-written CUDA kernels for Hopper, bound with ctypes.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, counting launches in ``<wrapper>.launches``; the
attention forward also counts its launches with dropout (K1-drop).
"""

from __future__ import annotations

from typing import Dict

from conformer_tpu_torch.ops.cuda.mel_frontend import logmel_fwd
from conformer_tpu_torch.ops.cuda.sincos_attention import (
    sincos_attention_bwd, sincos_attention_fwd)

WRAPPERS = (sincos_attention_fwd, sincos_attention_bwd, logmel_fwd)


def launch_counts() -> Dict[str, int]:
    counts = {fn.__name__: fn.launches for fn in WRAPPERS}
    counts["sincos_attention_fwd_dropout"] = sincos_attention_fwd.dropout_launches
    return counts


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    sincos_attention_fwd.dropout_launches = 0
