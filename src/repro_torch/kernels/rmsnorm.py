"""Wrapper for the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

``x * rsqrt(mean(x²) + eps) * (w [+ 1])`` over the last axis of a bf16 or
f32 tensor, with f32 weights and f32 math, rounded once to x's dtype. Rows
of the widths the models use are read from device memory once and
normalized from registers; other widths and unaligned rows take the
kernel's two-pass any-width path.
Replaces the Pallas kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_kernel``
(the JAX wrapper pads rows to a multiple of 8; this kernel takes any row
count). The plain torch version is ``kernels/ref.py::rmsnorm_ref``.

``rmsnorm_bwd_cuda`` is its gradient (``rmsnorm_bwd_kernel`` then
``rmsnorm_dw_kernel``, no atomics: the same dx and dw run to run), new
with no TPU counterpart (the JAX package differentiates its plain path);
its plain version is ``ref.rmsnorm_bwd_ref``. ``ops.rmsnorm`` routes a
CUDA tensor's gradient here through an ``autograd.Function``.
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


_BWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_SHAPE_ARGTYPES = [
    ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int),
]


def _launcher(symbol: str = "rmsnorm_launch", argtypes=None):
    fn = getattr(library("rmsnorm"), symbol)
    fn.argtypes = _ARGTYPES if argtypes is None else argtypes
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


def rmsnorm_bwd_cuda(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float,
    plus_one: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rmsnorm_cuda(x, w)`` for an output gradient ``dy``
    of x's shape and dtype -> (dx in x's dtype, dw f32 [D])."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must have a non-empty last axis, got {tuple(x.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(
            f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} must match x "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    check_operand(x2, "x", 2, FLOAT_DTYPES)
    check_operand(dy2, "dy", 2, FLOAT_DTYPES)
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    check_operand(wf, "w", 1, (torch.float32,))
    if wf.shape[0] != d:
        raise ValueError(f"w has {wf.shape[0]} entries for rows of width {d}")
    dx = torch.empty_like(x2)
    dw = torch.zeros((d,), dtype=torch.float32, device=x.device)
    rows = x2.shape[0]
    if rows:
        blocks, warps = ctypes.c_int(), ctypes.c_int()
        check_launch(
            _launcher("rmsnorm_bwd_shape", _SHAPE_ARGTYPES)(
                rows, d, ctypes.byref(blocks), ctypes.byref(warps)),
            "rmsnorm_bwd (width)")
        partial = torch.empty((blocks.value, d), dtype=torch.float32, device=x.device)
        launch = _launcher("rmsnorm_bwd_launch", _BWD_ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                x2.data_ptr(), wf.data_ptr(), dy2.data_ptr(), dx.data_ptr(),
                partial.data_ptr(), dw.data_ptr(), rows, d, blocks.value,
                warps.value, float(eps), int(bool(plus_one)),
                float_code(x2.dtype), stream,
            )
        check_launch(err, "rmsnorm_bwd")
        launch_counts["rmsnorm_bwd"] += 1
    return dx.reshape(x.shape), dw
