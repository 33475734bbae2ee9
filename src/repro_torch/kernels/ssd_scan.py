"""Wrapper for the CUDA Mamba2 SSD-scan kernels (``csrc/ssd_scan.cu``).

The chunked SSD recurrence, each block walking the chunks in order with
the (N, P) state carried on chip, B and C read per batch row by index (no
per-head copy). Replaces the Pallas kernel
``src/repro/kernels/ssd_scan.py::ssd_scan_kernel``, which needs
S % chunk == 0; both routes here treat the steps past S as x = dt = a_log
= 0 (B = C = 0), which leaves every real position exact because the
recurrence is causal. The plain torch versions are
``kernels/ref.py::ssd_scan_heads_ref`` (the op's layout),
``ssd_scan_chunked_ref`` and ``ssd_scan_ref``.

The route is picked by :func:`uses_tensor_cores`, from the dtype and the
shapes:

- bf16 with P a multiple of ``TC_HEAD_TILE`` and N one of ``TC_STATES``
  (mamba2: P 64, N 128, chunk 128): ``ssd_tc_kernel``,
  all four products on the tensor cores. It reads x, dt, a_log, B and C at
  their own strides (the layer hands it views of its activations): x, B
  and C by TMA, dt and a_log by ``cp.async``; an x, B or C whose strides
  or base TMA cannot take (:func:`tma_ready`) is copied first.
  Launches count under ``launch_counts["ssd_scan"]``.
- f32, and the shapes the first cannot take: ``ssd_fma_kernel``, f32 FMAs
  on the CUDA cores on contiguous [B·H, S, P] copies, exact to f32
  rounding. Launches count under ``launch_counts["ssd_scan_fma"]``.

:func:`ssd_scan_bwd_cuda` is the gradient (``csrc/ssd_scan_bwd.cu``), at
its own chunk (:func:`bwd_chunk`), on two routes picked by
:func:`bwd_uses_tensor_cores`:

- bf16 with P 32 or 64 and N one of ``TC_STATES`` (mamba2's training
  call): ``ssd_bwd_tc_states_kernel`` (counted under
  ``launch_counts["ssd_scan_bwd_states"]``) writes each chunk's entering
  state and the gradient of its leaving state, then
  ``ssd_bwd_tc_grads_kernel`` (``launch_counts["ssd_scan_bwd"]``) the five
  gradients, every product on the tensor cores. Both read x, dy, dt, a_log,
  B and C at their own strides (the layer's views, dy a transposed view);
  an x, dy, B or C whose strides or base 16-byte loads cannot take
  (:func:`tma_ready`) is copied first, counted under
  ``launch_counts["ssd_scan_bwd_copies"]``.
- f32, and the shapes the first cannot take: ``ssd_bwd_states_kernel``
  (``launch_counts["ssd_scan_bwd_states_fma"]``), then
  ``ssd_bwd_chunk_kernel`` (``launch_counts["ssd_scan_bwd_fma"]``), f32 FMAs
  on contiguous copies of the operands; each operand it had to copy counts
  under ``launch_counts["ssd_scan_bwd_copies"]``.

Their plain versions are ``kernels/ref.py::ssd_scan_bwd_blocked`` (the
tensor-core route's algorithm and roundings), ``ssd_scan_chunked_bwd``
(the FMA route's) and ``ssd_scan_bwd_ref`` (f32 autograd).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import (
    FLOAT_DTYPES, aligned16, check_launch, check_operand, float_code,
    launch_counts, library,
)

MAX_CHUNK = 128  # the Q x Q f32 score tile must fit beside the state
BWD_MAX_CHUNK = 64  # the backward's chunk, halved until its block fits
SMEM_LIMIT = 232_448  # bytes of shared memory a block may use on Hopper
TC_HEAD_TILE = 32  # head-dim columns per block of the tensor-core route
TC_STATES = (16, 32, 64, 128)  # state sizes the tensor-core route is built for
TC_BWD_HEAD_DIMS = (32, 64)  # head dims the backward's tensor-core route is built for

_I64P = ctypes.POINTER(ctypes.c_int64)
_FMA_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_TC_ARGTYPES = [
    ctypes.c_void_p, _I64P, ctypes.c_void_p, _I64P, ctypes.c_void_p, _I64P,
    ctypes.c_void_p, _I64P, ctypes.c_void_p, _I64P, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def kernel_chunk(chunk: int, seq: int) -> int:
    """The kernel's chunk for a requested ``chunk`` and sequence length:
    ``min(chunk, seq)`` rounded up to a multiple of 16, at most 128. The
    chunk changes only the order of the f32 sums, not the function."""
    q = max(min(chunk, seq), 1)
    return min(-(-q // 16) * 16, MAX_CHUNK)


def uses_tensor_cores(dtype: torch.dtype, p: int, n: int, q: int) -> bool:
    """Whether an SSD call of x's ``dtype``, head dim ``p``, state ``n`` and
    kernel chunk ``q`` (:func:`kernel_chunk`) takes the tensor-core route:
    bf16, ``p`` a multiple of ``TC_HEAD_TILE``, ``n`` one of ``TC_STATES``
    and ``q`` a multiple of 16 from 16 to ``MAX_CHUNK``."""
    return (dtype == torch.bfloat16 and p > 0 and p % TC_HEAD_TILE == 0
            and n in TC_STATES and 16 <= q <= MAX_CHUNK and q % 16 == 0)


def smem_bytes(q: int, n: int, p: int) -> int:
    """Dynamic shared memory of one block of the FMA route, as
    ``csrc/ssd_scan.cu``'s ``smem_floats`` counts it."""
    return 4 * (2 * q * p + n * p + q * q + 2 * q * 16 + 4 * q)


def bwd_uses_tensor_cores(dtype: torch.dtype, p: int, n: int) -> bool:
    """Whether the SSD backward of x's ``dtype``, head dim ``p`` and state
    ``n`` takes the tensor-core route: bf16, ``p`` one of
    ``TC_BWD_HEAD_DIMS`` and ``n`` one of ``TC_STATES`` (its chunk,
    :func:`bwd_chunk`, is then a multiple of 16)."""
    return dtype == torch.bfloat16 and p in TC_BWD_HEAD_DIMS and n in TC_STATES


def bwd_chunk(chunk: int, seq: int, n: int, p: int) -> int:
    """The backward's chunk: :func:`kernel_chunk`, at most
    ``BWD_MAX_CHUNK``. At the tensor-core route's widths that is the chunk
    of both routes (the FMA kernels' blocks fit at 64 there); elsewhere it
    is halved until the FMA kernels' blocks fit in shared memory, as
    ``csrc/ssd_scan_bwd.cu``'s ``ssd_scan_bwd_chunk`` counts them (this
    loads, and on first use builds, that library)."""
    q = min(kernel_chunk(chunk, seq), BWD_MAX_CHUNK)
    if bwd_uses_tensor_cores(torch.bfloat16, p, n):
        return q
    query = _launcher("ssd_scan_bwd_chunk", [ctypes.c_int] * 3, "ssd_scan_bwd")
    q = query(q, n, p)
    if q < 1:
        raise ValueError(f"state {n}, head dim {p}: the SSD backward's blocks do not "
                         "fit in shared memory at any chunk")
    return q


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the tensor-core routes can read ``t`` (x, dy, B or C) as it
    lies, the forward by TMA and the backward by 16-byte ``cp.async``: unit
    stride along the last axis, a 16-byte-aligned base and every other
    stride a positive multiple of 16 bytes (a stride of an axis of size 1 is
    never used)."""
    es = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and (st * es) % 16 == 0)
        for n, st in zip(t.shape[:-1], t.stride()[:-1])))


def _strides(t: torch.Tensor, axes: int):
    """The element strides of ``t``'s first ``axes`` axes for the C
    interface; an axis of size 1 gets a stride TMA accepts (it is never
    stepped)."""
    return (ctypes.c_int64 * axes)(*(
        st if n > 1 else t.shape[-1]
        for n, st in zip(t.shape[:axes], t.stride()[:axes])))


def _launcher(symbol: str, argtypes, source: str = "ssd_scan"):
    fn = getattr(library(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def _check_scan_operands(x, dt, a_log, bmat, cmat) -> None:
    """The forward's and the backward's operand checks: CUDA x [B, H, S,
    P] bf16/f32, dt and a_log f32 [B, H, S], B and C [B, S, N] in x's dtype,
    all on x's device."""
    if not x.is_cuda:
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D (B, H, S, P), got {tuple(x.shape)}")
    if x.dtype not in FLOAT_DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    b, h, s_len, p = x.shape
    for name, t, dtype in (("dt", dt, torch.float32), ("a_log", a_log, torch.float32),
                           ("bmat", bmat, x.dtype), ("cmat", cmat, x.dtype)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} must lie on x's device {x.device}, got {t.device}")
    if tuple(dt.shape) != (b, h, s_len) or tuple(a_log.shape) != (b, h, s_len):
        raise ValueError(
            f"dt {tuple(dt.shape)} / a_log {tuple(a_log.shape)} must be "
            f"({b}, {h}, {s_len}) for x {tuple(x.shape)}"
        )
    n = bmat.shape[-1] if bmat.dim() == 3 else -1
    if tuple(bmat.shape) != (b, s_len, n) or tuple(cmat.shape) != (b, s_len, n):
        raise ValueError(
            f"bmat {tuple(bmat.shape)} / cmat {tuple(cmat.shape)} must be "
            f"({b}, {s_len}, N) for x {tuple(x.shape)}"
        )
    if p % 4:
        raise ValueError(f"head dim P={p} must be a multiple of 4")


def ssd_scan_cuda(
    x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
    bmat: torch.Tensor, cmat: torch.Tensor, *, chunk: int,
) -> torch.Tensor:
    """SSD scan of CUDA x [B, H, S, P] (bf16/f32) with dt, a_log [B, H, S]
    (f32) and B, C [B, S, N] in x's dtype, at any strides -> contiguous
    [B, H, S, P] in x's dtype."""
    _check_scan_operands(x, dt, a_log, bmat, cmat)
    p, n = x.shape[-1], bmat.shape[-1]
    q = kernel_chunk(chunk, x.shape[2])
    if uses_tensor_cores(x.dtype, p, n, q):
        return _ssd_tc(x, dt, a_log, bmat, cmat, q)
    return _ssd_fma(x, dt, a_log, bmat, cmat, q)


def _ssd_tc(x, dt, a_log, bmat, cmat, q):
    b, h, s_len, p = x.shape
    n = bmat.shape[-1]
    out = torch.empty((b, h, s_len, p), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x, bmat, cmat = (t if tma_ready(t) else aligned16(t) for t in (x, bmat, cmat))
    launch = _launcher("ssd_scan_tc_launch", _TC_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            x.data_ptr(), _strides(x, 3), dt.data_ptr(), _strides(dt, 3),
            a_log.data_ptr(), _strides(a_log, 3), bmat.data_ptr(),
            _strides(bmat, 2), cmat.data_ptr(), _strides(cmat, 2), out.data_ptr(),
            b, h, s_len, q, n, p,
            stream,
        )
    check_launch(err, "ssd_scan")
    launch_counts["ssd_scan"] += 1
    return out


def _ssd_fma(x, dt, a_log, bmat, cmat, q):
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
    if smem_bytes(q, n, p) > SMEM_LIMIT:
        raise ValueError(
            f"chunk {q}, state {n}, head dim {p} need {smem_bytes(q, n, p)} "
            f"bytes of shared memory, over {SMEM_LIMIT}"
        )
    out = torch.empty_like(xf)
    if xf.numel():
        launch = _launcher("ssd_scan_fma_launch", _FMA_ARGTYPES)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = launch(
                xf.data_ptr(), dtf.data_ptr(), af.data_ptr(), bm.data_ptr(),
                cm.data_ptr(), out.data_ptr(), b * h, h, s_len, q, n, p,
                float_code(xf.dtype), stream,
            )
        check_launch(err, "ssd_scan_fma")
        launch_counts["ssd_scan_fma"] += 1
    return out.reshape(b, h, s_len, p)


_BWD_STATES_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_CHUNKS_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_BWD_TC_OPERANDS = [ctypes.c_void_p, _I64P] * 6
_BWD_TC_STATES_ARGTYPES = (_BWD_TC_OPERANDS + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
                           + [ctypes.c_void_p])
_BWD_TC_GRADS_ARGTYPES = (_BWD_TC_OPERANDS + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                          + [ctypes.c_void_p])


def ssd_scan_bwd_cuda(
    x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
    bmat: torch.Tensor, cmat: torch.Tensor, dy: torch.Tensor, *, chunk: int,
) -> tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan_cuda`` for an output gradient ``dy`` of
    x's shape and dtype, the operands as the forward takes them, at any
    strides -> (dx in x's dtype [B, H, S, P], ddt and da_log f32 [B, H, S],
    dB and dC in B's dtype [B, S, N], summed over the heads), contiguous."""
    _check_scan_operands(x, dt, a_log, bmat, cmat)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} must match "
                         f"x {tuple(x.shape)} {x.dtype} on {x.device}")
    b, h, s_len, p = x.shape
    n = bmat.shape[-1]
    if n & (n - 1) or n > 512:
        raise ValueError(f"state size N={n}: the SSD backward takes a power of two "
                         "up to 512")
    q = bwd_chunk(chunk, s_len, n, p)
    dev, f32 = x.device, torch.float32
    dx = torch.empty((b, h, s_len, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, h, s_len), dtype=f32, device=dev)
    da = torch.empty((b, h, s_len), dtype=f32, device=dev)
    db = torch.empty((b, s_len, n), dtype=bmat.dtype, device=dev)
    dc = torch.empty((b, s_len, n), dtype=bmat.dtype, device=dev)
    outs = (dx, ddt, da, db, dc)
    if b * h * s_len == 0:
        return outs
    if bwd_uses_tensor_cores(x.dtype, p, n):
        _ssd_bwd_tc(x, dt, a_log, bmat, cmat, dy, q, outs)
    else:
        _ssd_bwd_fma(x, dt, a_log, bmat, cmat, dy, q, outs)
    return outs


@functools.cache
def _bwd_tc_launchers():
    """The tensor-core route's two C entry points (argtypes set once)."""
    return (_launcher("ssd_scan_bwd_tc_states_launch", _BWD_TC_STATES_ARGTYPES,
                      "ssd_scan_bwd"),
            _launcher("ssd_scan_bwd_tc_grads_launch", _BWD_TC_GRADS_ARGTYPES,
                      "ssd_scan_bwd"))


def _ssd_bwd_tc(x, dt, a_log, bmat, cmat, dy, q, outs):
    b, h, s_len, p = x.shape
    n = bmat.shape[-1]
    ready = [tma_ready(t) for t in (x, dy, bmat, cmat)]
    x, dy, bmat, cmat = (t if ok else aligned16(t)
                         for t, ok in zip((x, dy, bmat, cmat), ready))
    nc = -(-s_len // q)
    sbuf = torch.empty((b * h, nc, 2, n, p), dtype=torch.bfloat16, device=x.device)
    dbuf = torch.empty_like(sbuf)
    operands = (x.data_ptr(), _strides(x, 3), dy.data_ptr(), _strides(dy, 3),
                dt.data_ptr(), _strides(dt, 3), a_log.data_ptr(), _strides(a_log, 3),
                bmat.data_ptr(), _strides(bmat, 2), cmat.data_ptr(), _strides(cmat, 2))
    shape = (b, h, s_len, q, n, p)
    states, grads = _bwd_tc_launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = states(*operands, sbuf.data_ptr(), dbuf.data_ptr(), *shape, stream)
        check_launch(err, "ssd_scan_bwd_states")
        launch_counts["ssd_scan_bwd_states"] += 1
        err = grads(*operands, sbuf.data_ptr(), dbuf.data_ptr(),
                    *(t.data_ptr() for t in outs), *shape, stream)
        check_launch(err, "ssd_scan_bwd")
        launch_counts["ssd_scan_bwd"] += 1
    launch_counts["ssd_scan_bwd_copies"] += ready.count(False)


def _ssd_bwd_fma(x, dt, a_log, bmat, cmat, dy, q, outs):
    b, h, s_len, p = x.shape
    n = bmat.shape[-1]
    dev, f32 = x.device, torch.float32
    copies = 0

    def flat(t, shape):
        nonlocal copies
        copies += not t.is_contiguous()
        return t.contiguous().reshape(shape)

    xf, dyf = flat(x, (b * h, s_len, p)), flat(dy, (b * h, s_len, p))
    dtf, af = flat(dt, (b * h, s_len)), flat(a_log, (b * h, s_len))
    bm, cm = flat(bmat, (b, s_len, n)), flat(cmat, (b, s_len, n))
    nc = -(-s_len // q)
    sbuf = torch.empty((b * h, nc, n, p), dtype=f32, device=dev)
    dbuf = torch.empty_like(sbuf)
    sdot = torch.empty((b * h, nc), dtype=f32, device=dev)
    db32 = torch.empty((b, s_len, n), dtype=f32, device=dev)
    dc32 = torch.empty_like(db32)
    dx, ddt, da, db, dc = outs
    code = float_code(x.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher("ssd_scan_bwd_states_launch", _BWD_STATES_ARGTYPES,
                        "ssd_scan_bwd")(
            xf.data_ptr(), dyf.data_ptr(), dtf.data_ptr(), af.data_ptr(),
            bm.data_ptr(), cm.data_ptr(), sbuf.data_ptr(), dbuf.data_ptr(),
            sdot.data_ptr(), b, h, s_len, q, n, p, code, stream)
        check_launch(err, "ssd_scan_bwd_states_fma")
        launch_counts["ssd_scan_bwd_states_fma"] += 1
        err = _launcher("ssd_scan_bwd_chunks_launch", _BWD_CHUNKS_ARGTYPES,
                        "ssd_scan_bwd")(
            xf.data_ptr(), dyf.data_ptr(), dtf.data_ptr(), af.data_ptr(),
            bm.data_ptr(), cm.data_ptr(), sbuf.data_ptr(), dbuf.data_ptr(),
            sdot.data_ptr(), dx.data_ptr(), ddt.data_ptr(), da.data_ptr(),
            db32.data_ptr(), dc32.data_ptr(), db.data_ptr(), dc.data_ptr(),
            b, h, s_len, q, n, p, code, stream)
        check_launch(err, "ssd_scan_bwd_fma")
        launch_counts["ssd_scan_bwd_fma"] += 1
    launch_counts["ssd_scan_bwd_copies"] += copies
