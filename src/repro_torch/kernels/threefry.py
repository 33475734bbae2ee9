"""Wrappers for the CUDA threefry kernels (``csrc/threefry.cu``).

``threefry_bits_cuda``: JAX's random bits of a key; ``randint_cuda``:
``jax.random.randint``'s int32 draw over the two subkeys of a key, with
scalar or per-element bounds; ``csr_row_sample_cuda``: one column drawn
uniformly from each queried row of a CSR (and its delta overlay), the
whole of ``csr_row_sample`` / ``eff_row_sample`` in one launch. Keys are
pairs of uint32 ints, passed as launch arguments. The plain torch versions
are ``kernels/ref.py::threefry_bits_ref``, ``randint_ref`` and
``csr_row_sample_ref``; ``kernels/ops.py`` picks between kernel and plain
version by the tensors' device. No TPU kernel is replaced: on the TPU XLA
fuses the threefry primitive itself.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library
from .intersect import ID_DTYPES, INDPTR_DTYPES

_U32 = ctypes.c_uint32
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

#: each launcher's C argument types
ARGTYPES = {
    "threefry_bits_launch": [_U32, _U32, _P, _I64, _P],
    "randint_launch": [_U32, _U32, _U32, _U32, _P, ctypes.c_int32, _P, ctypes.c_int32,
                       _P, _I64, _P],
    "csr_row_sample_launch": [_U32, _U32, _U32, _U32, _P, _I, _P, _I, _I64, _P, _I64,
                              _P, _I, _P, _I, _I64, _P, _P, _P, _I64, _P],
}
_launchers: dict = {}


def _fn(name: str):
    """The launcher ``name`` of the threefry library, its argument types
    bound on the first call only, so a launch pays no ctypes setup."""
    fn = _launchers.get(name)
    if fn is None:
        fn = getattr(library("threefry"), name)
        fn.argtypes = ARGTYPES[name]
        fn.restype = ctypes.c_int
        _launchers[name] = fn
    return fn


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _cuda_device(device, what: str) -> torch.device:
    """``device`` as a CUDA device with its index (``cuda`` -> the current
    one), so it compares equal to a tensor's."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA device, got {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def threefry_bits_cuda(key, n: int, device) -> torch.Tensor:
    """Element i of ``jax.random.bits(key, (n,))`` for i < n -> int32[n]
    holding the uint32 bits, on CUDA ``device``."""
    device = _cuda_device(device, "threefry_bits_cuda")
    out = torch.empty(int(n), dtype=torch.int32, device=device)
    if n == 0:
        return out
    launch = _fn("threefry_bits_launch")
    with torch.cuda.device(device):
        err = launch(int(key[0]), int(key[1]), out.data_ptr(), int(n),
                     _stream(device))
    check_launch(err, "threefry_bits")
    launch_counts["threefry_bits"] += 1
    return out


def _bound_arg(x, n: int, device, name: str) -> tuple:
    """A bound as (pointer or None, scalar) for the launch."""
    if isinstance(x, torch.Tensor):
        check_operand(x, name, 1)
        if x.numel() != n or x.device != device:
            raise ValueError(
                f"{name} must hold {n} elements on {device}, got "
                f"{tuple(x.shape)} on {x.device}")
        return x.data_ptr(), 0
    return None, int(x)


def randint_cuda(k1, k2, lo, hi, n: int, device) -> torch.Tensor:
    """``jax.random.randint`` (int32) over the subkeys k1, k2 of
    ``split(key)`` -> int32[n]; ``lo`` / ``hi`` are ints or int32[n] CUDA
    tensors."""
    device = _cuda_device(device, "randint_cuda")
    lo_p, lo_s = _bound_arg(lo, n, device, "lo")
    hi_p, hi_s = _bound_arg(hi, n, device, "hi")
    out = torch.empty(int(n), dtype=torch.int32, device=device)
    if n == 0:
        return out
    launch = _fn("randint_launch")
    with torch.cuda.device(device):
        err = launch(int(k1[0]), int(k1[1]), int(k2[0]), int(k2[1]),
                     lo_p, lo_s, hi_p, hi_s, out.data_ptr(), int(n),
                     _stream(device))
    check_launch(err, "randint")
    launch_counts["randint"] += 1
    return out


def _csr_args(indptr: torch.Tensor, ids: torch.Tensor, name: str) -> tuple:
    check_operand(indptr, f"{name} indptr", 1, INDPTR_DTYPES)
    check_operand(ids, f"{name} ids", 1, ID_DTYPES)
    if indptr.numel() < 1:
        raise ValueError(f"{name} indptr is empty")
    return (indptr.data_ptr(), int(indptr.dtype == torch.int64), ids.data_ptr(),
            int(ids.dtype == torch.int32), indptr.numel() - 1)


def csr_row_sample_cuda(
    indptr: torch.Tensor,
    ids: torch.Tensor,
    rows: torch.Tensor,
    k1,
    k2,
    *,
    overlay: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One column drawn from each row ``rows[i]`` (int32[n] CUDA ids) of
    the CSR (``indptr`` int32 or int64, ``ids`` uint16 or int32, as
    stored) -> (int32[n] samples, bool[n] valid); an empty row gives its
    own id, invalid. ``overlay`` is the delta as (dirty bool[m], delta
    indptr, delta ids): a dirty row is read from the delta. k1, k2: the
    subkeys of ``split(key)``."""
    check_operand(rows, "rows", 1)
    base = _csr_args(indptr, ids, "base")
    tensors = [indptr, ids, rows]
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
    if any(t.device != rows.device for t in tensors):
        raise ValueError(
            "csr_row_sample operands lie on different devices: "
            + ", ".join(str(t.device) for t in tensors))
    n = rows.numel()
    out = torch.empty(n, dtype=torch.int32, device=rows.device)
    valid = torch.empty(n, dtype=torch.bool, device=rows.device)
    if n == 0:
        return out, valid
    launch = _fn("csr_row_sample_launch")
    with torch.cuda.device(rows.device):
        err = launch(int(k1[0]), int(k1[1]), int(k2[0]), int(k2[1]),
                     *base, dirty, n_dirty, *delta, rows.data_ptr(),
                     out.data_ptr(), valid.data_ptr(), n, _stream(rows.device))
    check_launch(err, "csr_row_sample")
    launch_counts["csr_row_sample"] += 1
    return out, valid
