"""Hand-written CUDA kernels for Hopper, bound with ctypes.

Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors, counting launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

from typing import Dict

from conformer_tpu_torch.ops.cuda.mel_frontend import logmel_fwd
from conformer_tpu_torch.ops.cuda.sincos_attention import sincos_attention_fwd

WRAPPERS = (sincos_attention_fwd, logmel_fwd)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in WRAPPERS}


def reset_launch_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
