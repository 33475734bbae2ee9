"""Wrapper for the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Causal (or full) grouped-query attention forward with an online softmax
and f32 accumulation; q head ``h`` reads kv head ``h // (Hq / Hkv)``.
Replaces the Pallas kernel
``src/repro/kernels/flash_attention.py::flash_attention_kernel``, which
needs S % 128 == 0; both routes here take any S. The plain torch version
is ``kernels/ref.py::attention_heads_ref``.

The route is picked from the dtype and the head dim, explicitly:

- bf16 with D in ``WGMMA_HEAD_DIMS``: ``flash_wgmma_kernel`` on the tensor
  cores. It reads q, k, v at their own strides through TMA (the layer hands
  it transposed views of [B, S, H, D]) and writes o into a [B, S, Hq, D]
  tensor, returned as a (B, Hq, S, D) view. An operand whose strides or
  base TMA cannot take (16-byte multiples, unit stride along D) is copied
  first, counted under ``launch_counts["flash_attention_copies"]``.
  Launches count under ``"flash_attention"``.
- f32, and bf16 with D in {32, 256}: ``flash_fma_kernel``, f32 FMAs on the
  CUDA cores on contiguous [B·H, S, D] copies. Launches count under
  ``"flash_attention_fma"``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import (
    FLOAT_DTYPES, aligned16, check_launch, check_operand, float_code,
    launch_counts, library,
)

HEAD_DIMS = (32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128)

_I64P = ctypes.POINTER(ctypes.c_int64)
_FMA_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_WGMMA_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    _I64P, _I64P, _I64P, _I64P, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]


def _launcher(symbol: str, argtypes):
    fn = getattr(library("flash_attention"), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def uses_wgmma(dtype: torch.dtype, d: int) -> bool:
    """Whether (dtype, head dim) takes the tensor-core route."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether TMA can read ``t`` as it lies: unit stride along the last
    axis, a 16-byte-aligned base and every other stride of a multiple of
    16 bytes (a stride of an axis of size 1 is never used)."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (st * es) % 16 == 0
        for n, st in zip(t.shape[:-1], t.stride()[:-1])))


def _tma_operand(t: torch.Tensor) -> torch.Tensor:
    if _tma_ready(t):
        return t
    launch_counts["flash_attention_copies"] += 1
    return aligned16(t)


def _strides(t: torch.Tensor):
    """(b, h, s) element strides of a 4-D tensor for the C interface; an
    axis of size 1 gets a stride TMA accepts (it is never stepped)."""
    st = [s if n > 1 else t.shape[-1] for n, s in zip(t.shape[:3], t.stride()[:3])]
    return (ctypes.c_int64 * 3)(*st)


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float, causal: bool,
) -> torch.Tensor:
    """Attention of CUDA q (B, Hq, S, D) against k, v (B, Hkv, S, D), at
    any strides (bf16 or f32, one dtype) -> (B, Hq, S, D) in q's dtype."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must lie on one device")
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} must be {(B, Hkv, S, D)} "
            f"for q {tuple(q.shape)}"
        )
    if uses_wgmma(q.dtype, D):
        return _flash_wgmma(q, k, v, scale, causal)
    return _flash_fma(q, k, v, scale, causal)


def _flash_wgmma(q, k, v, scale, causal):
    B, Hq, S, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    if B == 0 or S == 0 or Hq == 0:
        return out
    q, k, v = (_tma_operand(t) for t in (q, k, v))
    launch = _launcher("flash_attention_wgmma_launch", _WGMMA_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, k.shape[1], S, D, _strides(q), _strides(k), _strides(v),
            _strides(out), float(scale), int(bool(causal)), stream,
        )
    check_launch(err, "flash_attention")
    launch_counts["flash_attention"] += 1
    return out


def _flash_fma(q, k, v, scale, causal):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    qf = aligned16(q.reshape(B * Hq, S, D))
    kf = aligned16(k.reshape(B * Hkv, S, D))
    vf = aligned16(v.reshape(B * Hkv, S, D))
    for name, t in (("q", qf), ("k", kf), ("v", vf)):
        check_operand(t, name, 3, FLOAT_DTYPES)
    out = torch.empty_like(qf)
    if B * Hq == 0 or S == 0:
        return out.view(B, Hq, S, D)
    launch = _launcher("flash_attention_fma_launch", _FMA_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), out.data_ptr(),
            B * Hq, S, D, Hq // Hkv, float(scale), int(bool(causal)),
            float_code(q.dtype), stream,
        )
    check_launch(err, "flash_attention_fma")
    launch_counts["flash_attention_fma"] += 1
    return out.view(B, Hq, S, D)
