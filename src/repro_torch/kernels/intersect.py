"""Wrapper for the CUDA intersect kernel (``csrc/intersect.cu``).

Counts, per row pair, the values shared by two sorted, SENTINEL-padded
int32 rows whose real entries are unique. Replaces the Pallas kernel
``src/repro/kernels/intersect.py::intersect_count_kernel``. The plain
torch version is ``kernels/ref.py::intersect_count_ref``; the choice
between the two is made in ``kernels/ops.py`` by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _launcher():
    fn = library("intersect").intersect_count_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def intersect_count_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a[i] ∩ b[i]| for int32[B, Ka] / int32[B, Kb] CUDA rows -> int32[B]."""
    check_operand(a, "a", 2)
    check_operand(b, "b", 2)
    if a.shape[0] != b.shape[0] or a.device != b.device:
        raise ValueError(
            f"row mismatch: a {tuple(a.shape)} on {a.device}, "
            f"b {tuple(b.shape)} on {b.device}"
        )
    rows, ka = a.shape
    out = torch.empty(rows, dtype=torch.int32, device=a.device)
    if rows == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            rows, ka, b.shape[1], stream,
        )
    check_launch(err, "intersect_count")
    launch_counts["intersect_count"] += 1
    return out
