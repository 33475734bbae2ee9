"""Wrapper for the CUDA frontier-compaction kernel (``csrc/frontier.cu``).

Per row: the sorted unique candidates of an unsorted, SENTINEL-padded
int32 row that are not in the row's visited set, capped at ``max_out``
and SENTINEL-padded. Replaces the Pallas kernel
``src/repro/kernels/frontier.py::frontier_kernel`` together with its
wrapper's scatter (``src/repro/kernels/ops.py:159-164``). The plain torch
versions are ``kernels/ref.py::frontier_ref`` (all-pairs oracle) and
``frontier_search_ref`` (binary search, the CPU path).

``MAX_CAND`` is the widest candidate row the kernel takes: the in-block
sort's capacity shared with the segmented-union kernel, 32,768 (1,024
threads x 32 keys in registers). This wrapper refuses wider rows; the
traversal sends them to the plain path (``core/traversal.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library
from .segmented_union import MAX_FLAT

MAX_CAND = MAX_FLAT

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _launcher():
    fn = library("frontier").frontier_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def frontier_compact_cuda(
    cand: torch.Tensor, visited_sorted: torch.Tensor, max_out: int
) -> torch.Tensor:
    """Next-frontier rows of int32[B, Kc] CUDA ``cand`` against int32[B, Kv]
    ``visited_sorted`` (each row ascending, SENTINEL last) -> int32[B, max_out].
    """
    check_operand(cand, "cand", 2)
    check_operand(visited_sorted, "visited", 2)
    rows, kc = cand.shape
    if visited_sorted.shape[0] != rows or visited_sorted.device != cand.device:
        raise ValueError(
            f"row mismatch: cand {tuple(cand.shape)} on {cand.device}, "
            f"visited {tuple(visited_sorted.shape)} on {visited_sorted.device}"
        )
    if kc > MAX_CAND:
        raise ValueError(
            f"candidate row width {kc} exceeds the kernel's capacity {MAX_CAND}"
        )
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    out = torch.empty((rows, max_out), dtype=torch.int32, device=cand.device)
    if rows == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            cand.data_ptr(), visited_sorted.data_ptr(), out.data_ptr(),
            rows, kc, visited_sorted.shape[1], max_out, stream,
        )
    check_launch(err, "frontier_compact")
    launch_counts["frontier_compact"] += 1
    return out
