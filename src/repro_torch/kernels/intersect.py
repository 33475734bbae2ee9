"""Wrappers for the CUDA intersect kernels (``csrc/intersect.cu``).

``intersect_rows_cuda`` (the query path): for each pair of node ids, the
number of hyperedges the two nodes share, read from their effective
membership rows where they lie in the CSR and its delta overlay, one launch
a batch. ``intersect_count_cuda``: per row pair, the values shared by two
sorted, SENTINEL-padded int32 rows whose real entries are unique; rows of
at most 32 entries take a group of lanes a pair, which search the b row
in registers by shuffles (``ref.intersect_count_lanes`` is that plan in
plain torch), wider rows a warp a pair. Both replace the Pallas kernel
``src/repro/kernels/intersect.py::intersect_count_kernel``. The plain torch versions are
``kernels/ref.py::intersect_rows_ref`` (the degree-bucketed route) and
``intersect_count_ref``; the choice between kernel and plain version is
made in ``kernels/ops.py`` by the tensors' device.
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


INDPTR_DTYPES = (torch.int32, torch.int64)
ID_DTYPES = (torch.uint16, torch.int32)

_ROWS_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
]


def _rows_launcher():
    fn = library("intersect").intersect_rows_launch
    fn.argtypes = _ROWS_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _csr_args(indptr: torch.Tensor, ids: torch.Tensor, name: str) -> tuple:
    check_operand(indptr, f"{name} indptr", 1, INDPTR_DTYPES)
    check_operand(ids, f"{name} ids", 1, ID_DTYPES)
    if indptr.numel() < 1:
        raise ValueError(f"{name} indptr is empty")
    return (indptr.data_ptr(), int(indptr.dtype == torch.int64), ids.data_ptr(),
            int(ids.dtype == torch.int32), indptr.numel() - 1)


def intersect_rows_cuda(
    indptr: torch.Tensor,
    ids: torch.Tensor,
    u: torch.Tensor,
    v: torch.Tensor,
    *,
    overlay: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    node_filter: torch.Tensor | None = None,
) -> torch.Tensor:
    """|row(u[i]) ∩ row(v[i])| for int32[B] CUDA ids -> int32[B], 0 where
    ``node_filter[clip(v[i])]`` is False.

    ``indptr`` (int32 or int64) and ``ids`` (uint16 or int32) are the
    membership CSR as stored; ``overlay`` is its delta as (dirty bool[n],
    delta indptr, delta ids), a dirty row read from the delta. Rows must be
    sorted with unique entries, as the CSR builders make them."""
    check_operand(u, "u", 1)
    check_operand(v, "v", 1)
    if u.shape != v.shape:
        raise ValueError(f"u {tuple(u.shape)} and v {tuple(v.shape)} differ")
    base = _csr_args(indptr, ids, "base")
    tensors = [indptr, ids, u, v]
    delta = (None, 0, None, 0, 0)
    dirty, n_dirty = None, 0
    if overlay is not None:
        dirty_t, d_indptr, d_ids = overlay
        check_operand(dirty_t, "dirty", 1, (torch.bool,))
        if dirty_t.numel() < 1:
            raise ValueError("overlay dirty mask is empty")
        delta = _csr_args(d_indptr, d_ids, "delta")
        dirty, n_dirty = dirty_t.data_ptr(), dirty_t.numel()
        tensors += [dirty_t, d_indptr, d_ids]
    filt, n_filter = None, 0
    if node_filter is not None:
        check_operand(node_filter, "node_filter", 1, (torch.bool,))
        if node_filter.numel() < 1:
            raise ValueError("node_filter is empty")
        filt, n_filter = node_filter.data_ptr(), node_filter.numel()
        tensors.append(node_filter)
    if any(t.device != u.device for t in tensors):
        raise ValueError(
            "intersect_rows operands lie on different devices: "
            + ", ".join(str(t.device) for t in tensors))
    out = torch.empty(u.shape[0], dtype=torch.int32, device=u.device)
    if u.shape[0] == 0:
        return out
    launch = _rows_launcher()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(*base, dirty, n_dirty, *delta, u.data_ptr(), v.data_ptr(),
                     filt, n_filter, out.data_ptr(), u.shape[0], stream)
    check_launch(err, "intersect_rows")
    launch_counts["intersect_rows"] += 1
    return out
