"""Wrapper for the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

``x * rsqrt(mean(x²) + eps) * (w [+ 1])`` over the last axis of a bf16 or
f32 tensor, with f32 weights and f32 math, rounded once to x's dtype. Rows
of the widths the models use are read from device memory once and
normalized from registers; other widths and unaligned rows take the
kernel's two-pass any-width path.
Replaces the Pallas kernel ``src/repro/kernels/rmsnorm.py::rmsnorm_kernel``
(the JAX wrapper pads rows to a multiple of 8; this kernel takes any row
count). The plain torch version is ``kernels/ref.py::rmsnorm_ref``.

``rmsnorm_bwd_cuda`` is its gradient, new with no TPU counterpart (the
JAX package differentiates its plain path): at the widths the models use
(the register route of ``bwd_plan``, which the library computes) one read
of x and dy into registers, ``rmsnorm_bwd_rows_kernel``, whose lanes add
dw into registers; other widths and unaligned rows
``rmsnorm_bwd_any_kernel``; then ``rmsnorm_dw_kernel`` sums the blocks'
partial rows in a fixed order. No atomics: the same dx and dw run to
run. Its plain version is
``ref.rmsnorm_bwd_ref``; ``ref.rmsnorm_bwd_blocked`` is the register
route's algorithm, its dw summed in the kernels' order. ``ops.rmsnorm``
routes a CUDA tensor's gradient here through an ``autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools

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
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_PLAN_ARGTYPES = [ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_int)]
_PLAN_KEYS = ("lanes", "vecs", "unroll", "warps", "blocks", "nvec", "split")


def bwd_plan(rows: int, d: int, dtype: torch.dtype, aligned: bool) -> dict:
    """The launch plan ``rmsnorm_bwd_cuda`` runs for ``rows`` rows of width
    ``d`` of ``dtype`` with 16-byte-aligned operands or not, as the kernels'
    library computes it (``csrc/rmsnorm.cu``'s ``bwd_plan``): the register
    route where ``lanes`` > 0 (``vecs`` 16-byte vectors a lane, ``unroll``
    row groups a warp iteration), else the any-width route (``warps`` a
    block); ``blocks`` partial rows of ``nvec`` interleaved vectors, summed
    in ``split`` interleaved runs. ``ref.rmsnorm_bwd_blocked`` takes it."""
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    check_launch(_launcher("rmsnorm_bwd_plan", _PLAN_ARGTYPES)(
        rows, d, float_code(dtype), int(aligned), out), "rmsnorm_bwd (plan)")
    return dict(zip(_PLAN_KEYS, out))


@functools.cache
def _bwd_max_blocks() -> int:
    fn = library("rmsnorm").rmsnorm_bwd_max_blocks
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


@functools.cache
def _bwd_launch():
    return _launcher("rmsnorm_bwd_launch", _BWD_ARGTYPES)


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
    of x's shape and dtype -> (dx in x's dtype, dw f32 [D]).

    The backward runs once a norm and training step, and a cold call costs
    its host work wherever that outlasts the card's queue, so the wrapper
    does little: the library picks the route, x and dy are read as they lie
    where contiguous, and every entry of dw is written by the kernels."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"x must have a non-empty last axis, got {tuple(x.shape)}")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(
            f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} must match x "
            f"{tuple(x.shape)} {x.dtype} on {x.device}")
    d = x.shape[-1]
    x = x.contiguous()
    dy = dy.contiguous()
    wf = w.to(device=x.device, dtype=torch.float32).contiguous()
    if wf.dim() != 1 or wf.shape[0] != d:
        raise ValueError(f"w {tuple(wf.shape)} must hold one entry for each of the "
                         f"rows' {d} columns")
    dx = torch.empty_like(x)
    dw = torch.empty((d,), dtype=torch.float32, device=x.device)
    rows = x.numel() // d
    if not rows:
        return dx, dw.zero_()
    # scratch for the plan's partial rows, which never pass the rows or the
    # library's cap; the library picks the route from the operands' alignment
    partial = torch.empty((min(rows, _bwd_max_blocks()), d), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = _bwd_launch()(
            x.data_ptr(), wf.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            partial.data_ptr(), partial.shape[0], dw.data_ptr(), rows, d,
            float(eps), int(bool(plus_one)), float_code(x.dtype),
            torch.cuda.current_stream().cuda_stream,
        )
    check_launch(err, "rmsnorm_bwd")
    launch_counts["rmsnorm_bwd"] += 1
    return dx, dw
