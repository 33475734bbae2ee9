"""Wrapper for the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``).

``h_t = a_t * h_(t-1) + b_t`` over the sequence axis of f32 a, b
(B, S, dr), from h0 (B, dr) or 0, with every h_t returned; the carried
state after a prefill is ``h[:, -1]``. Replaces no TPU kernel: the
reference runs the recurrence as ``jax.lax.associative_scan``
(``src/repro/models/layers.py:689``). The plain torch version is
``kernels/ref.py::rglru_scan_ref``, which rounds as the kernel does (a
product, then a sum), so the two agree bit for bit. Launches count under
``launch_counts["rglru_scan"]``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import check_launch, check_operand, launch_counts, library

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
]


def _launcher():
    fn = library("rglru_scan").rglru_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


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
    if h0 is not None:
        h0 = h0.contiguous()
        check_operand(h0, "h0", 2, (torch.float32,))
        if tuple(h0.shape) != (B, dr) or h0.device != a.device:
            raise ValueError(f"h0 {tuple(h0.shape)} must be {(B, dr)} on {a.device}")
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
