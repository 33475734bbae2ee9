"""Wrapper for the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``h_t = a_t * h_(t-1) + b_t`` over the sequence axis of f32 a, b
(B, S, dr), from h0 (B, dr) or 0, with every h_t returned; the carried
state after a prefill is ``h[:, -1]``. Replaces no TPU kernel: the
reference runs the recurrence as ``jax.lax.associative_scan``
(``src/repro/models/layers.py:689``). The plain torch version is
``kernels/ref.py::rglru_scan_ref``, which rounds as the kernel does (a
product, then a sum), so the two agree bit for bit. Launches count under
``launch_counts["rglru_scan"]``.

:func:`rglru_scan_bwd_cuda` is its gradient, from a and the forward's h:
one launch of ``rglru_scan_bwd_kernel``, bit-identical to
``ref.rglru_scan_bwd_loop``; its plain f32 autograd version is
``ref.rglru_scan_bwd_ref``. Launches count under
``launch_counts["rglru_scan_bwd"]``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
]


_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def _launcher(symbol: str = "rglru_scan_launch", argtypes=_ARGTYPES):
    fn = getattr(library("rglru_scan"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_state(h0, B: int, dr: int, device):
    """h0 (B, dr) f32 on ``device``, contiguous, or None."""
    if h0 is None:
        return None
    h0 = h0.contiguous()
    check_operand(h0, "h0", 2, (torch.float32,))
    if tuple(h0.shape) != (B, dr) or h0.device != device:
        raise ValueError(f"h0 {tuple(h0.shape)} must be {(B, dr)} on {device}")
    return h0


def rglru_scan_cuda(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> torch.Tensor:
    """The recurrence over CUDA f32 a, b (B, S, dr) from h0 (B, dr) or 0
    -> h (B, S, dr) f32."""
    a, b = a.contiguous(), b.contiguous()
    check_operand(a, "a", 3, (torch.float32,))
    check_operand(b, "b", 3, (torch.float32,))
    if b.shape != a.shape or b.device != a.device:
        raise ValueError(f"b {tuple(b.shape)} must match a {tuple(a.shape)} on "
                         f"{a.device}")
    B, S, dr = a.shape
    h0 = _check_state(h0, B, dr, a.device)
    h = torch.empty_like(a)
    if B * S * dr:
        launch = _launcher()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(a.data_ptr(), b.data_ptr(),
                         None if h0 is None else h0.data_ptr(), h.data_ptr(),
                         B, S, dr, stream)
        check_launch(err, "rglru_scan")
        launch_counts["rglru_scan"] += 1
    return h


def rglru_scan_bwd_cuda(
    a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor | None, dh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The gradient of ``rglru_scan_cuda(a, b, h0)`` for an output gradient
    ``dh``, from CUDA f32 a and the forward's output h (B, S, dr) -> (da,
    db, dh0) f32; dh0 is None without h0."""
    a, h, dh = a.contiguous(), h.contiguous(), dh.contiguous()
    for name, t in (("a", a), ("h", h), ("dh", dh)):
        check_operand(t, name, 3, (torch.float32,))
        if t.shape != a.shape or t.device != a.device:
            raise ValueError(f"{name} {tuple(t.shape)} must match a {tuple(a.shape)} "
                             f"on {a.device}")
    B, S, dr = a.shape
    h0 = _check_state(h0, B, dr, a.device)
    da, db = torch.empty_like(a), torch.empty_like(a)
    dh0 = None if h0 is None else torch.empty_like(h0)
    if B * dr:
        launch = _launcher("rglru_scan_bwd_launch", _BWD_ARGTYPES)
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(a.data_ptr(), h.data_ptr(),
                         None if h0 is None else h0.data_ptr(), dh.data_ptr(),
                         da.data_ptr(), db.data_ptr(),
                         None if dh0 is None else dh0.data_ptr(), B, S, dr, stream)
        check_launch(err, "rglru_scan_bwd")
        launch_counts["rglru_scan_bwd"] += 1
    return da, db, dh0
