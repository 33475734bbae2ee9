"""Wrapper for the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Causal (or full) grouped-query attention forward with an online softmax
and f32 accumulation; q row ``bh`` reads kv row ``bh // group``. Replaces
the Pallas kernel
``src/repro/kernels/flash_attention.py::flash_attention_kernel``, which
needs S % 128 == 0; this kernel takes any S. The plain torch version is
``kernels/ref.py::attention_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import (
    FLOAT_DTYPES, aligned16, check_launch, check_operand, float_code,
    launch_counts, library,
)

HEAD_DIMS = (32, 64, 128, 256)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _launcher():
    fn = library("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float, causal: bool, kv_group: int,
) -> torch.Tensor:
    """Attention of CUDA q [B·Hq, S, D] against k, v [B·Hq/kv_group, S, D]
    (bf16 or f32, one dtype) -> [B·Hq, S, D] in q's dtype."""
    q, k, v = aligned16(q), aligned16(k), aligned16(v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_operand(t, name, 3, FLOAT_DTYPES)
    bhq, s_len, d = q.shape
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if kv_group < 1 or bhq % kv_group:
        raise ValueError(f"{bhq} q rows are not a multiple of kv_group {kv_group}")
    want = (bhq // kv_group, s_len, d)
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} must be {want} for q "
            f"{tuple(q.shape)} and kv_group {kv_group}"
        )
    out = torch.empty_like(q)
    if bhq == 0 or s_len == 0:
        return out
    launch = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bhq, s_len, d, kv_group, float(scale), int(bool(causal)),
            float_code(q.dtype), stream,
        )
    check_launch(err, "flash_attention")
    launch_counts["flash_attention"] += 1
    return out
