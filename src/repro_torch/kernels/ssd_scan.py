"""Wrapper for the CUDA Mamba2 SSD-scan kernel (``csrc/ssd_scan.cu``).

The chunked SSD recurrence of one b·h per block, the (N, P) state carried
across chunks in shared memory, B and C read per batch row by index (no
per-head copy). Replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py::ssd_scan_kernel``, which needs
S % chunk == 0; this kernel treats the steps past S as x = dt = a_log = 0
(B = C = 0), which leaves every real position exact because the
recurrence is causal. The plain torch versions are
``kernels/ref.py::ssd_scan_chunked_ref`` and ``ssd_scan_ref``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import (
    FLOAT_DTYPES, aligned16, check_launch, check_operand, float_code,
    launch_counts, library,
)

MAX_CHUNK = 128  # the Q x Q f32 score tile must fit beside the state
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def kernel_chunk(chunk: int, seq: int) -> int:
    """The kernel's chunk for a requested ``chunk`` and sequence length:
    ``min(chunk, seq)`` rounded up to a multiple of 16, at most 128. The
    chunk changes only the order of the f32 sums, not the function."""
    q = max(min(chunk, seq), 1)
    return min(-(-q // 16) * 16, MAX_CHUNK)


def smem_bytes(q: int, n: int, p: int) -> int:
    """Dynamic shared memory of one block, as ``csrc/ssd_scan.cu``'s
    ``smem_floats`` counts it."""
    return 4 * (2 * q * p + n * p + q * q + 2 * q * 16 + 4 * q)


def _launcher():
    fn = library("ssd_scan").ssd_scan_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd_scan_cuda(
    x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
    bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
) -> torch.Tensor:
    """SSD scan of CUDA x [B, H, S, P] (bf16/f32) with dt, a_log [B, H, S]
    (f32) and B, C [B, S, N] in x's dtype -> [B, H, S, P] in x's dtype."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D (B, H, S, P), got {tuple(x.shape)}")
    b, h, s_len, p = x.shape
    xf = aligned16(x.reshape(b * h, s_len, p))
    dtf = dt.reshape(b * h, s_len).contiguous()
    af = a_log.reshape(b * h, s_len).contiguous()
    bm, cm = bmat.contiguous(), cmat.contiguous()
    check_operand(xf, "x", 3, FLOAT_DTYPES)
    check_operand(dtf, "dt", 2, (torch.float32,))
    check_operand(af, "a_log", 2, (torch.float32,))
    check_operand(bm, "bmat", 3, (xf.dtype,))
    check_operand(cm, "cmat", 3, (xf.dtype,))
    n = bm.shape[-1]
    if tuple(bm.shape) != (b, s_len, n) or tuple(cm.shape) != (b, s_len, n):
        raise ValueError(
            f"bmat {tuple(bm.shape)} / cmat {tuple(cm.shape)} must be "
            f"({b}, {s_len}, N) for x {tuple(x.shape)}"
        )
    if any(t.device != x.device for t in (dtf, af, bm, cm)):
        raise ValueError("all operands must lie on x's device")
    if p % 4:
        raise ValueError(f"head dim P={p} must be a multiple of 4")
    q = kernel_chunk(chunk, s_len)
    if smem_bytes(q, n, p) > SMEM_LIMIT:
        raise ValueError(
            f"chunk {q}, state {n}, head dim {p} need {smem_bytes(q, n, p)} "
            f"bytes of shared memory, over {SMEM_LIMIT}"
        )
    out = torch.empty_like(xf)
    if xf.numel():
        launch = _launcher()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                xf.data_ptr(), dtf.data_ptr(), af.data_ptr(), bm.data_ptr(),
                cm.data_ptr(), out.data_ptr(), b * h, h, s_len, q, n, p,
                float_code(xf.dtype), stream,
            )
        check_launch(err, "ssd_scan")
        launch_counts["ssd_scan"] += 1
    return out.reshape(b, h, s_len, p)
