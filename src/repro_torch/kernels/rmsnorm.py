"""Wrapper for the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

``x * rsqrt(mean(x²) + eps) * (w [+ 1])`` over the last axis of a bf16 or
f32 tensor, with f32 weights and f32 math, rounded once to x's dtype. Rows
of the widths the models use are read from device memory once and
normalized from registers; other widths and unaligned rows take the
kernel's two-pass any-width path.
Replaces the Pallas kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_kernel``
(the JAX wrapper pads rows to a multiple of 8; this kernel takes any row
count). The plain torch version is ``kernels/ref.py::rmsnorm_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import (
    FLOAT_DTYPES, check_launch, check_operand, float_code, launch_counts,
    library,
)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _launcher():
    fn = library("rmsnorm").rmsnorm_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_cuda(
    x: torch.Tensor, w: torch.Tensor, *, eps: float, plus_one: bool
) -> torch.Tensor:
    """RMSNorm of the rows of a bf16/f32 CUDA ``x`` (any leading shape) by
    weights ``w`` [D] (cast to f32) -> x's shape and dtype."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must have a non-empty last axis, got {tuple(x.shape)}")
    d = x.shape[-1]
    # a row whose base is not 16-byte aligned takes the kernel's any-width
    # path as it lies, with no copy
    x2 = x.reshape(-1, d).contiguous()
    check_operand(x2, "x", 2, FLOAT_DTYPES)
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    check_operand(wf, "w", 1, (torch.float32,))
    if wf.shape[0] != d:
        raise ValueError(f"w has {wf.shape[0]} entries for rows of width {d}")
    out = torch.empty_like(x2)
    rows = x2.shape[0]
    if rows:
        launch = _launcher()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                x2.data_ptr(), wf.data_ptr(), out.data_ptr(), rows, d,
                float(eps), int(bool(plus_one)), float_code(x2.dtype), stream,
            )
        check_launch(err, "rmsnorm")
        launch_counts["rmsnorm"] += 1
    return out.reshape(x.shape)
