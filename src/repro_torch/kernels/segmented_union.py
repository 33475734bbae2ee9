"""Wrapper for the CUDA segmented-union kernel (``csrc/segmented_union.cu``).

Per row: the sorted unique non-SENTINEL values of an unsorted,
SENTINEL-padded int32 row, capped at ``max_out`` and SENTINEL-padded.
Replaces the Pallas kernel
``src/repro/kernels/segmented_union.py::segmented_union_kernel`` together
with its wrapper's scatter (``src/repro/kernels/ops.py:105-111``). The
plain torch version is ``kernels/ref.py::segmented_union_ref``.

``MAX_FLAT`` is the widest row one block's shared memory holds: 227 KiB
per block on an H100 is 58,112 int32, and the in-block bitonic sort
wants a power of two, so 32,768. It replaces the JAX package's
``UNION_PALLAS_MAX_FLAT = 2048`` (sized for the TPU's all-pairs VMEM
tiles). This wrapper refuses wider rows; the dispatcher's rule sends them
to the sort path (``core/dispatch.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library

MAX_FLAT = 32768

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _launcher():
    fn = library("segmented_union").segmented_union_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def segmented_union_cuda(flat: torch.Tensor, max_out: int) -> torch.Tensor:
    """Sorted-unique rows of int32[B, K] CUDA ``flat`` -> int32[B, max_out]."""
    check_operand(flat, "flat", 2)
    rows, k = flat.shape
    if k > MAX_FLAT:
        raise ValueError(
            f"row width {k} exceeds the kernel's capacity {MAX_FLAT}"
        )
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    out = torch.empty((rows, max_out), dtype=torch.int32, device=flat.device)
    if rows == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(flat.data_ptr(), out.data_ptr(), rows, k, max_out, stream)
    check_launch(err, "segmented_union")
    launch_counts["segmented_union"] += 1
    return out
