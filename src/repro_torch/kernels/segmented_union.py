"""Wrappers for the CUDA segmented-union kernels (``csrc/segmented_union.cu``).

Per row: the sorted unique non-SENTINEL values of an unsorted,
SENTINEL-padded int32 row, capped at ``max_out`` and SENTINEL-padded, or
only their number. Replaces the Pallas kernel
``src/repro/kernels/segmented_union.py::segmented_union_kernel`` together
with its wrapper's scatter (``src/repro/kernels/ops.py:105-111``). The
plain torch versions are in ``kernels/ref.py``.

``MAX_FLAT`` is the widest row one group of threads sorts in one piece:
1,024 threads holding 32 keys each in registers, 32,768 entries (the
shared-memory buffer beside them is 135 KiB of the 227 KiB a block may
use). It replaces the JAX package's ``UNION_PALLAS_MAX_FLAT = 2048``
(sized for the TPU's all-pairs VMEM tiles). Wider rows take the wide
route of ``kernels/ops.py``, which cuts them into tiles of at most
``MAX_FLAT`` for :func:`union_tiles_cuda` and merges the tiles' runs with
:func:`union_merge_cuda` and :func:`union_compact_cuda`.

Launch counts: ``segmented_union`` (in-block rows), ``segmented_union_count``
(in-block count-only rows), ``segmented_union_wide`` (the wide route's tile
sort), ``union_merge`` (one merge level of the wide route) and
``union_compact`` (its final pass).
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library

MAX_FLAT = 32768

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int


def _fn(name: str, argtypes):
    fn = getattr(library("segmented_union"), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _launch_tiles(flat: torch.Tensor, out, count, tile: int, max_out: int,
                  what: str) -> None:
    rows, k = flat.shape
    if rows == 0:
        return
    launch = _fn("segmented_union_launch", [_P, _P, _P, _I64, _I, _I, _I, _P])
    err = launch(flat.data_ptr(), _ptr(out), _ptr(count), rows, k, tile,
                 max_out, _stream(flat))
    check_launch(err, what)
    launch_counts[what] += 1


def _check_width(k: int) -> None:
    if k > MAX_FLAT:
        raise ValueError(f"row width {k} exceeds the kernel's capacity {MAX_FLAT}")


def segmented_union_cuda(flat: torch.Tensor, max_out: int) -> torch.Tensor:
    """Sorted-unique rows of int32[B, K] CUDA ``flat`` -> int32[B, max_out]."""
    check_operand(flat, "flat", 2)
    _check_width(flat.shape[1])
    if max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    out = torch.empty((flat.shape[0], max_out), dtype=torch.int32,
                      device=flat.device)
    _launch_tiles(flat, out, None, max(flat.shape[1], 1), max_out,
                  "segmented_union")
    return out


def segmented_union_count_cuda(flat: torch.Tensor) -> torch.Tensor:
    """Distinct non-SENTINEL values per row of int32[B, K] CUDA ``flat``
    -> int32[B]."""
    check_operand(flat, "flat", 2)
    _check_width(flat.shape[1])
    count = torch.empty((flat.shape[0],), dtype=torch.int32, device=flat.device)
    _launch_tiles(flat, None, count, max(flat.shape[1], 1), 1,
                  "segmented_union_count")
    return count


def union_tiles_cuda(flat: torch.Tensor, tile: int, m: int) -> torch.Tensor:
    """The wide route's first step: each row of int32[B, K] CUDA ``flat`` cut
    into T = ceil(K / tile) tiles, each tile's sorted uniques capped at
    ``m`` and SENTINEL-padded -> int32[B, T * m], T sorted runs a row."""
    check_operand(flat, "flat", 2)
    if not 1 <= tile <= MAX_FLAT:
        raise ValueError(f"tile must be in [1, {MAX_FLAT}], got {tile}")
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    rows, k = flat.shape
    tiles = max(-(-k // tile), 1)
    out = torch.empty((rows, tiles * m), dtype=torch.int32, device=flat.device)
    _launch_tiles(flat, out, None, tile, m, "segmented_union_wide")
    return out


def union_merge_cuda(x: torch.Tensor, run: int) -> torch.Tensor:
    """Rows of int32[B, N] CUDA ``x``, each a sequence of sorted runs of
    ``run`` entries (the last possibly shorter) -> the same rows as sorted
    runs of ``2 * run``: runs 2q and 2q + 1 merged."""
    check_operand(x, "x", 2)
    if run < 1:
        raise ValueError(f"run must be >= 1, got {run}")
    rows, n = x.shape
    y = torch.empty_like(x)
    if rows == 0 or n == 0:
        return y
    launch = _fn("union_merge_launch", [_P, _P, _I64, _I64, _I64, _P])
    err = launch(x.data_ptr(), y.data_ptr(), rows, n, run, _stream(x))
    check_launch(err, "union_merge")
    launch_counts["union_merge"] += 1
    return y


def union_compact_cuda(x: torch.Tensor, max_out: int | None) -> torch.Tensor:
    """Sorted rows of int32[B, N] CUDA ``x`` (SENTINEL last) -> their distinct
    non-SENTINEL values, int32[B, max_out] SENTINEL-padded, or with
    ``max_out=None`` their number, int32[B]."""
    check_operand(x, "x", 2)
    rows, n = x.shape
    if max_out is None:
        out, count = None, torch.empty((rows,), dtype=torch.int32, device=x.device)
    elif max_out < 1:
        raise ValueError(f"max_out must be >= 1, got {max_out}")
    else:
        out = torch.empty((rows, max_out), dtype=torch.int32, device=x.device)
        count = None
    if rows:
        launch = _fn("union_compact_launch", [_P, _P, _P, _I64, _I64, _I, _P])
        err = launch(x.data_ptr(), _ptr(out), _ptr(count), rows, n,
                     max_out or 1, _stream(x))
        check_launch(err, "union_compact")
        launch_counts["union_compact"] += 1
    return count if out is None else out
