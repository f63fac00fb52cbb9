"""Per-pass cost microbenchmark kernel K5: one op applied n times to every
element of an fp32 (rows, cols) tile per CTA (``csrc/vpu_pass.cu``).

Counterpart of ``tools/bench_vpu_pass.py::_kernel``; the benchmark that
times it is ``conformer_tpu_torch/tools/bench_vpu_pass.py``. ``vpu_pass``
is the kernel wrapper: a CPU tensor takes the plain version
``vpu_pass_plain`` (the same loop in torch); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from conformer_tpu_torch.ops.cuda import build

# In the kernel's order (csrc/vpu_pass.cu, enum Op).
OPS = ("add", "mul", "where", "exp", "exp2", "exp_raw", "max", "sum")


def vpu_pass_plain(x: torch.Tensor, op: str, n: int) -> torch.Tensor:
    """x (R, cols) fp32 -> the JAX tool's ``_kernel`` applied to it: op n
    times per element, or for max/sum, n row-reduction passes."""
    if op == "add":
        for _ in range(n):
            x = x + 1.000001
    elif op == "mul":
        for _ in range(n):
            x = x * 1.000001
    elif op == "exp":
        for _ in range(n):
            x = torch.exp(x * 1e-6)
    elif op == "exp2":
        for _ in range(n):
            x = torch.exp2(x * 1e-6)
    elif op == "exp_raw":
        for _ in range(n):
            x = torch.exp(x) * 1e-6
    elif op == "where":
        m = x > 0.5
        for _ in range(n):
            x = torch.where(m, x, x * 0.999999)
    elif op in ("max", "sum"):
        acc = x
        for _ in range(n):
            t = x + acc[:, :1]
            acc = acc + (t.amax(dim=-1, keepdim=True) if op == "max"
                         else t.sum(dim=-1, keepdim=True))
        x = acc
    else:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    return x


def vpu_pass(x: torch.Tensor, op: str, n: int, rows: int) -> torch.Tensor:
    """Kernel wrapper (K5): x (grid * rows, cols) fp32, one CTA per ``rows``
    rows; same result as vpu_pass_plain. CPU tensors take the plain
    version; CUDA tensors launch the kernel (counted in
    ``vpu_pass.launches``) or raise."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    if x.device.type == "cpu":
        return vpu_pass_plain(x, op, n)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 2-D float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    total, cols = x.shape
    if rows <= 0 or total % rows:
        raise ValueError(f"{total} rows do not split into tiles of {rows}")
    lib = build.load("vpu_pass")
    if op in ("max", "sum"):
        limit = lib.vpu_pass_max_row_cols
        limit.argtypes, limit.restype = [], ctypes.c_int
        if cols > limit():
            raise ValueError(f"the row reductions take cols <= {limit()}, "
                             f"got {cols}")
    out = torch.empty_like(x)
    fn = lib.vpu_pass
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), OPS.index(op), n, rows, cols,
                 total // rows, stream)
    build.check(lib, "vpu_pass", err)
    vpu_pass.launches += 1
    return out


vpu_pass.launches = 0
