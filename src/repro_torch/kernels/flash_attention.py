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

Under grad (``residuals=True``) the tensor-core route also writes what its
backward needs: ``o_lo``, the part of the f32 output that the bf16 ``o``
drops (o's layout), and each row's log-sum-exp ``lse`` (f32 [B·Hq, S]).
``ref.attention_residuals_ref`` is their plain version.

``flash_attention_bwd_cuda`` is the gradient (``csrc/flash_attention_bwd.cu``),
new with no TPU counterpart (the JAX package differentiates its plain
path), routed as the forward:

- bf16 with D in ``WGMMA_HEAD_DIMS``: from the forward's o, o_lo and lse, a
  row pass for rowsum(dO ∘ (o + o_lo)), then a dK/dV and a dQ kernel on the
  tensor cores. q, k, v and dO are read at their strides through TMA, o and
  o_lo as the forward wrote them; an operand that cannot be read so is
  copied, counted under ``launch_counts["flash_attention_bwd_copies"]``.
  dq, dk, dv are returned as (B, H, S, D) views of [B, S, H, D]. Launches
  count under ``"flash_attention_bwd"``.
- f32, and bf16 with D in {32, 256}: a pass for each row's log-sum-exp and
  rowsum(dO * O), both from the recomputed scores, a dK/dV kernel and a dQ
  kernel, f32 FMAs, contiguous outputs. Launches count under
  ``"flash_attention_bwd_fma"``.

Neither route uses atomics. The plain version is ``ref.attention_bwd_ref``;
``ref.attention_bwd_blocked`` is the tensor-core route's algorithm.
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
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    _I64P, _I64P, _I64P, _I64P, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
_BWD_FMA_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [_I64P] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]
_BWD_WGMMA_ARGTYPES = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [_I64P] * 8 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
]
#: the backward's LSE and Dd rows are padded to a multiple of this
BWD_PAD = 128


def _launcher(symbol: str, argtypes, source: str = "flash_attention"):
    fn = getattr(library(source), symbol)
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


def _tma_operand(t: torch.Tensor, copies: str = "flash_attention_copies"
                 ) -> torch.Tensor:
    """``t`` as it lies where ``_tma_ready``, else a copy counted under
    ``launch_counts[copies]``."""
    if _tma_ready(t):
        return t
    launch_counts[copies] += 1
    return aligned16(t)


def _strides(t: torch.Tensor):
    """(b, h, s) element strides of a 4-D tensor for the C interface; an
    axis of size 1 gets a stride TMA accepts (it is never stepped)."""
    st = [s if n > 1 else t.shape[-1] for n, s in zip(t.shape[:3], t.stride()[:3])]
    return (ctypes.c_int64 * 3)(*st)


def _check_qkv(ts) -> None:
    """The checks the kernels need of (name, tensor) pairs q, k, v (and dO):
    CUDA tensors of q's float dtype and device, 4-D, a supported head dim,
    kv heads dividing q heads, k and v shaped alike."""
    q = ts[0][1]
    for name, t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != q.dtype or t.dtype not in FLOAT_DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16 like q, got {t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D, got shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} must lie on q's device {q.device}")
    k, v = ts[1][1], ts[2][1]
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    if tuple(k.shape) != (B, Hkv, S, D) or tuple(v.shape) != (B, Hkv, S, D):
        raise ValueError(
            f"k {tuple(k.shape)} / v {tuple(v.shape)} must be {(B, Hkv, S, D)} "
            f"for q {tuple(q.shape)}")


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    scale: float, causal: bool, residuals: bool = False,
):
    """Attention of CUDA q (B, Hq, S, D) against k, v (B, Hkv, S, D), at
    any strides (bf16 or f32, one dtype) -> (B, Hq, S, D) in q's dtype; with
    ``residuals`` -> (o, o_lo, lse), o_lo and lse None on the CUDA-core
    route, whose backward recomputes them."""
    _check_qkv((("q", q), ("k", k), ("v", v)))
    if uses_wgmma(q.dtype, q.shape[-1]):
        out = _flash_wgmma(q, k, v, scale, causal, residuals)
        return out if residuals else out[0]
    out = _flash_fma(q, k, v, scale, causal)
    return (out, None, None) if residuals else out


def _flash_wgmma(q, k, v, scale, causal, residuals):
    B, Hq, S, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    o_lo = torch.empty_like(out) if residuals else None
    lse = (torch.empty((B * Hq, S), dtype=torch.float32, device=q.device)
           if residuals else None)
    if B == 0 or S == 0 or Hq == 0:
        return out, o_lo, lse
    q, k, v = (_tma_operand(t) for t in (q, k, v))
    launch = _launcher("flash_attention_wgmma_launch", _WGMMA_ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            o_lo.data_ptr() if residuals else None,
            lse.data_ptr() if residuals else None,
            B, Hq, k.shape[1], S, D, _strides(q), _strides(k), _strides(v),
            _strides(out), float(scale), int(bool(causal)), stream,
        )
    check_launch(err, "flash_attention")
    launch_counts["flash_attention"] += 1
    return out, o_lo, lse


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


def flash_attention_bwd_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    o: torch.Tensor | None = None, o_lo: torch.Tensor | None = None,
    lse: torch.Tensor | None = None, *, scale: float, causal: bool,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_cuda(q, k, v)`` for an output
    gradient ``do`` -> (dq, dk, dv) in q's dtype. q, do (B, Hq, S, D) and
    k, v (B, Hkv, S, D) at any strides. The tensor-core route needs what the
    forward wrote under grad: its output ``o``, ``o_lo`` (o's strides) and
    ``lse`` (f32 [B·Hq, S]); the CUDA-core route takes none of them."""
    _check_qkv((("q", q), ("k", k), ("v", v), ("do", do)))
    if tuple(do.shape) != tuple(q.shape):
        raise ValueError(f"do {tuple(do.shape)} must be q's {tuple(q.shape)}")
    B, Hq, S, D = q.shape
    if uses_wgmma(q.dtype, D):
        return _flash_bwd_wgmma(q, k, v, do, o, o_lo, lse, scale, causal)
    return _flash_bwd_fma(q, k, v, do, scale, causal)


def _flash_bwd_wgmma(q, k, v, do, o, o_lo, lse, scale, causal):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if o is None or o_lo is None or lse is None:
        raise ValueError("the tensor-core backward needs the forward's o, o_lo and "
                         "lse (flash_attention_cuda(..., residuals=True))")
    for name, t in (("o", o), ("o_lo", o_lo)):
        if t.dtype != q.dtype or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} on {t.device} must "
                             f"be q's {q.dtype} {tuple(q.shape)} on {q.device}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (B * Hq, S)
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 {(B * Hq, S)} on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    dq = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if B == 0 or S == 0 or Hq == 0:
        return dq, dk, dv
    copies = "flash_attention_bwd_copies"
    q, k, v, do = (_tma_operand(t, copies) for t in (q, k, v, do))
    if not (_tma_ready(o) and _tma_ready(o_lo) and o.stride() == o_lo.stride()):
        launch_counts[copies] += 2
        o, o_lo = aligned16(o), aligned16(o_lo)
    lse = lse.contiguous()
    s_pad = -(-S // BWD_PAD) * BWD_PAD
    lse2 = torch.empty((B * Hq, s_pad), dtype=torch.float32, device=q.device)
    dd = torch.empty_like(lse2)
    launch = _launcher("flash_attention_bwd_wgmma_launch", _BWD_WGMMA_ARGTYPES,
                       "flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            o_lo.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), lse2.data_ptr(), dd.data_ptr(), B, Hq, Hkv, S, D,
            *(_strides(t) for t in (q, k, v, do, o, dq, dk, dv)),
            float(scale), int(bool(causal)), stream,
        )
    check_launch(err, "flash_attention_bwd")
    launch_counts["flash_attention_bwd"] += 1
    return dq, dk, dv


def _flash_bwd_fma(q, k, v, do, scale, causal):
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    dq = torch.empty((B, Hq, S, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, S, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if B == 0 or S == 0 or Hq == 0:
        return dq, dk, dv
    # the backward kernels read rows of D contiguous elements on 16-byte
    # boundaries: the condition TMA sets
    q, k, v, do = (_tma_operand(t, "flash_attention_bwd_copies") for t in (q, k, v, do))
    lse = torch.empty((B * Hq, S), dtype=torch.float32, device=q.device)
    dd = torch.empty_like(lse)
    launch = _launcher("flash_attention_bwd_fma_launch", _BWD_FMA_ARGTYPES,
                       "flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            dd.data_ptr(), B, Hq, Hkv, S, D, _strides(q), _strides(k),
            _strides(v), _strides(do), float(scale),
            int(bool(causal)), float_code(q.dtype), stream,
        )
    check_launch(err, "flash_attention_bwd_fma")
    launch_counts["flash_attention_bwd_fma"] += 1
    return dq, dk, dv
