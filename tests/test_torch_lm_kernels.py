"""PyTorch port, LM kernels: ``ops.flash_attention``, ``ops.ssd_scan`` and
``ops.rmsnorm`` against the JAX package's ops.

The JAX side runs its Pallas kernels the way ``tests/test_kernels.py``
does (``use_pallas=True``, interpret mode on the CPU) and its plain path
(``use_pallas=False``); the port's ops run their plain torch versions
here, because the tensors lie on the CPU. Inputs come from
``np.random.default_rng`` with the seed named in each test.

Tolerances: float32 atol 2e-5 (rtol 2e-5 where values exceed 1): both
sides compute the same function in f32 and differ only in the order of
their sums. bf16: 2^-6 relative — the JAX Pallas RMSNorm rounds once, at
the end, while ``rmsnorm_ref`` (both packages) rounds ``mult`` and
``scale`` to bf16 first, a difference of a unit or two in the last of
bf16's 8 significant bits.

The CUDA kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (marked ``cuda``; skips without a card) and
by ``chip_smoke.py``; the CPU can check their wrappers' refusals and the
padding rule the SSD kernel relies on.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ssd_scan import (
    bwd_chunk, bwd_uses_tensor_cores, kernel_chunk, tma_ready, uses_tensor_cores,
)

F32_TOL = 2e-5
BF16_TOL = 2.0**-6


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _qkv(rng, B, Hq, Hkv, S, D):
    return (rng.normal(size=(B, Hq, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, S, D)).astype(np.float32))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("D", [32, 64])
def test_flash_attention_parity(S, D):
    rng = np.random.default_rng(10 + S + D)  # seed 10+S+D
    q, k, v = _qkv(rng, 2, 4, 2, S, D)  # GQA group 2
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, use_pallas=True), F32_TOL)
    _close(got, jops.flash_attention(jq, jk, jv, causal=True, use_pallas=False),
           F32_TOL)


@pytest.mark.parametrize("S,causal", [(100, True), (1, True), (64, False)])
def test_flash_attention_any_length_and_full(S, causal):
    """The port takes any S (the Pallas kernel needs S % 128 == 0): held
    against the JAX plain path."""
    rng = np.random.default_rng(20 + S)  # seed 20+S
    q, k, v = _qkv(rng, 1, 4, 1, S, 32)  # MQA
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, use_pallas=False)
    _close(got, want, F32_TOL)


def test_flash_attention_bf16_parity():
    rng = np.random.default_rng(30)  # seed 30
    q, k, v = _qkv(rng, 1, 2, 2, 128, 64)
    got = tops.flash_attention(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)))
    want = jops.flash_attention(*(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)),
                                use_pallas=True)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_takes_the_layers_transposed_views(causal):
    # the attention layer hands over (B, H, S, D) views of [B, S, H, D]
    # tensors; the result equals the call on contiguous copies and the JAX op
    q, k, v = _qkv(np.random.default_rng(303), 2, 4, 2, 40, 32)  # seed 303
    views = [torch.from_numpy(np.ascontiguousarray(t.transpose(0, 2, 1, 3))
                              ).transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = tops.flash_attention(*views, causal=causal)
    want = tops.flash_attention(*(t.contiguous() for t in views), causal=causal)
    assert torch.equal(got, want)
    _close(got, jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     causal=causal, use_pallas=False), F32_TOL)


def test_attention_heads_ref_matches_attention_ref():
    q, k, v = _qkv(np.random.default_rng(304), 2, 4, 1, 24, 16)  # seed 304
    got = tref.attention_heads_ref(*(torch.from_numpy(t) for t in (q, k, v)),
                                   scale=0.25, causal=True)
    want = tref.attention_ref(torch.from_numpy(q.reshape(8, 24, 16)),
                              torch.from_numpy(k.reshape(2, 24, 16)),
                              torch.from_numpy(v.reshape(2, 24, 16)),
                              scale=0.25, causal=True, kv_group=4)
    assert torch.equal(got, want.reshape(2, 4, 24, 16))


def test_attention_ref_parity():
    rng = np.random.default_rng(31)  # seed 31
    q, k, v = (t.reshape(-1, 40, 32) for t in _qkv(rng, 2, 4, 2, 40, 32))
    got = tref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), scale=0.2, kv_group=2)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              scale=0.2, kv_group=2)
    _close(got, want, F32_TOL)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, B, H, S, P, N):
    dt = rng.uniform(0.1, 1.0, size=(B, H, S)).astype(np.float32)
    return (
        rng.normal(size=(B, H, S, P)).astype(np.float32),
        dt,
        (-dt * rng.uniform(0.5, 2.0, size=(B, H, S))).astype(np.float32),
        (rng.normal(size=(B, S, N)) * 0.2).astype(np.float32),
        (rng.normal(size=(B, S, N)) * 0.2).astype(np.float32),
    )


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("S", [128, 100])
def test_ssd_scan_parity(chunk, S):
    """S a multiple of the chunk: the Pallas kernel and the chunked plain
    path; not a multiple: the JAX op's sequential plain path (its Pallas
    kernel refuses such S)."""
    rng = np.random.default_rng(40 + chunk + S)  # seed 40+chunk+S
    args = _ssd_inputs(rng, 2, 3, S, 16, 16)
    got = tops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    jargs = [jnp.asarray(a) for a in args]
    if S % chunk == 0:
        _close(got, jops.ssd_scan(*jargs, chunk=chunk, use_pallas=True), F32_TOL)
    _close(got, jops.ssd_scan(*jargs, chunk=chunk, use_pallas=False), F32_TOL)


def test_ssd_scan_bf16_parity():
    rng = np.random.default_rng(50)  # seed 50
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 1, 2, 64, 16, 16)
    got = tops.ssd_scan(torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
                        torch.from_numpy(a_log), torch.from_numpy(bm).bfloat16(),
                        torch.from_numpy(cm).bfloat16(), chunk=16)
    want = jops.ssd_scan(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                         jnp.asarray(a_log), jnp.asarray(bm, jnp.bfloat16),
                         jnp.asarray(cm, jnp.bfloat16), chunk=16, use_pallas=True)
    assert got.dtype == torch.bfloat16
    # both round only the output; their f32 sums differ in order
    _close(got, want, BF16_TOL)


def test_ssd_refs_parity():
    rng = np.random.default_rng(51)  # seed 51
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 1, 3, 48, 8, 16)
    flat = (x.reshape(3, 48, 8), dt.reshape(3, 48), a_log.reshape(3, 48),
            np.repeat(bm, 3, axis=0), np.repeat(cm, 3, axis=0))
    t = [torch.from_numpy(a) for a in flat]
    j = [jnp.asarray(a) for a in flat]
    _close(tref.ssd_scan_ref(*t), jref.ssd_scan_ref(*j), F32_TOL)
    _close(tref.ssd_scan_chunked_ref(*t, chunk=16),
           jref.ssd_scan_chunked_ref(*j, chunk=16), F32_TOL)


@pytest.mark.parametrize("chunk,seq,want", [(128, 2048, 128), (128, 100, 112),
                                            (16, 100, 16), (100, 1000, 112),
                                            (64, 5, 16), (256, 4096, 128)])
def test_ssd_kernel_chunk(chunk, seq, want):
    assert kernel_chunk(chunk, seq) == want


@pytest.mark.parametrize("S", [100, 5, 128])
def test_ssd_zero_tail_is_exact(S):
    """The CUDA kernel runs in chunks of ``kernel_chunk`` and reads the
    steps past S as x = dt = a_log = B = C = 0: the real positions equal
    the sequential recurrence on the unpadded inputs."""
    rng = np.random.default_rng(60 + S)  # seed 60+S
    x, dt, a_log, bm, cm = (torch.from_numpy(a) for a in _ssd_inputs(rng, 1, 2, S, 8, 16))
    q = kernel_chunk(128, S)
    pad = -S % q

    def padded(t, dim):
        shape = list(t.shape)
        shape[dim] = pad
        return torch.cat([t, torch.zeros(shape, dtype=t.dtype)], dim=dim)

    bf = bm[:, None].expand(1, 2, S, 16).reshape(2, S, 16)
    cf = cm[:, None].expand(1, 2, S, 16).reshape(2, S, 16)
    flat = (x.reshape(2, S, 8), dt.reshape(2, S), a_log.reshape(2, S), bf, cf)
    got = tref.ssd_scan_chunked_ref(*(padded(t, 1) for t in flat), chunk=q)
    want = tref.ssd_scan_ref(*flat)
    torch.testing.assert_close(got[:, :S], want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype,p,n,q,want", [
    (torch.bfloat16, 64, 128, 128, True),  # mamba2-130m's prefill
    (torch.bfloat16, 32, 16, 16, True),
    (torch.bfloat16, 96, 64, 112, True),
    (torch.bfloat16, 64, 32, 48, True),
    (torch.float32, 64, 128, 128, False),  # f32 stays exact on the CUDA cores
    (torch.bfloat16, 48, 128, 128, False),  # P not a multiple of 32
    (torch.bfloat16, 16, 16, 16, False),  # the reduced configs' head dim
    (torch.bfloat16, 64, 48, 128, False),  # N not one of 16, 32, 64, 128
    (torch.bfloat16, 64, 256, 128, False),
    (torch.bfloat16, 64, 128, 8, False),  # a chunk under 16
    (torch.bfloat16, 64, 128, 120, False),  # a chunk not a multiple of 16
    (torch.bfloat16, 64, 128, 144, False),  # a chunk over 128
])
def test_ssd_route_choice(dtype, p, n, q, want):
    assert uses_tensor_cores(dtype, p, n, q) is want


@pytest.mark.parametrize("seq", [1, 16, 127, 128, 129, 2048, 2049])
def test_mamba2_prefill_takes_the_tensor_core_route(seq):
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-130m")
    # the layer asks for chunk min(ssm_chunk, S)
    q = kernel_chunk(min(cfg.ssm_chunk, seq), seq)
    assert uses_tensor_cores(torch.bfloat16, cfg.ssm_head_dim, cfg.ssm_state, q)


def test_mamba_layer_hands_the_tensor_core_route_views_tma_reads(monkeypatch):
    """At mamba2-130m's width the Mamba layer passes x, B and C as views of
    its activations (no copy), and TMA can read each as it lies; dt and
    a_log, read by 4-byte copies, may be strided."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import Mamba

    cfg = get_config("mamba2-130m")
    layer = Mamba(cfg, device="cpu")
    layer.init(torch.Generator().manual_seed(0))
    seen = []
    plain = tops.ssd_scan

    def capture(*args, **kwargs):
        seen.append((args, kwargs))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tops, "ssd_scan", capture)
    x = torch.from_numpy(np.random.default_rng(90).normal(  # seed 90
        size=(2, 130, cfg.d_model)).astype(np.float32)).bfloat16()
    out, _ = layer(x)
    assert out.shape == x.shape and bool(torch.isfinite(out.float()).all())
    (xh, dt, a_log, bm, cm), kw = seen[0]
    assert xh.dtype == bm.dtype == cm.dtype == torch.bfloat16
    assert not xh.is_contiguous() and not bm.is_contiguous()
    assert all(tma_ready(t) for t in (xh, bm, cm))
    q = kernel_chunk(kw["chunk"], xh.shape[2])
    assert uses_tensor_cores(xh.dtype, xh.shape[-1], bm.shape[-1], q)


@pytest.mark.parametrize("dtype,p,n,want", [
    (torch.bfloat16, 64, 128, True),  # mamba2-130m's training call
    (torch.bfloat16, 32, 16, True),
    (torch.bfloat16, 32, 128, True),
    (torch.bfloat16, 64, 64, True),
    (torch.float32, 64, 128, False),  # f32 stays exact on the CUDA cores
    (torch.bfloat16, 16, 16, False),  # the reduced configs' head dim
    (torch.bfloat16, 96, 128, False),  # head dims past 64
    (torch.bfloat16, 64, 256, False),  # N not one of 16, 32, 64, 128
    (torch.bfloat16, 64, 48, False),
])
def test_ssd_bwd_route_choice(dtype, p, n, want):
    assert bwd_uses_tensor_cores(dtype, p, n) is want
    if want:  # the route's chunk: the forward's, at most 64, asked of no library
        for chunk, seq in ((128, 2048), (128, 45), (16, 100), (128, 1)):
            q = bwd_chunk(chunk, seq, n, p)
            assert q == min(kernel_chunk(chunk, seq), 64) and q % 16 == 0


def test_mamba_layer_hands_the_backward_views_it_reads(monkeypatch):
    """At mamba2-130m's width the SSD backward gets the forward's views and
    dy as a transposed view of the layer's [B, S, H, P] gradient: all of x,
    dy, B and C readable as they lie (no copy), on the tensor-core route."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import Mamba

    cfg = get_config("mamba2-130m")
    layer = Mamba(cfg, device="cpu")
    layer.init(torch.Generator().manual_seed(0))
    seen = []

    def bwd(x, dt, a_log, bmat, cmat, dy, *, chunk):
        seen.append((x, dt, a_log, bmat, cmat, dy, chunk))
        grads = tref.ssd_scan_bwd_ref(x, dt, a_log, bmat, cmat, dy, chunk=chunk)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, a_log, bmat, cmat)))

    monkeypatch.setattr(tops, "ssd_scan_cuda", lambda x, dt, a_log, bmat, cmat, *, chunk: (
        tref.ssd_scan_heads_ref(x, dt, a_log, bmat, cmat, chunk=chunk)))
    monkeypatch.setattr(tops, "ssd_scan_bwd_cuda", bwd)
    monkeypatch.setattr(tops, "ssd_scan", lambda x, dt, a_log, bmat, cmat, *, chunk=128: (
        tops._SSDScan.apply(x, dt, a_log, bmat, cmat, chunk)))
    x = torch.from_numpy(np.random.default_rng(91).normal(  # seed 91
        size=(2, 130, cfg.d_model)).astype(np.float32)).bfloat16().requires_grad_(True)
    out, _ = layer(x)
    out.float().square().sum().backward()
    assert len(seen) == 1 and bool(torch.isfinite(x.grad.float()).all())
    xh, dt, a_log, bm, cm, dy, chunk = seen[0]
    assert dy.dtype == xh.dtype == bm.dtype == torch.bfloat16 and dy.shape == xh.shape
    assert not dy.is_contiguous() and not xh.is_contiguous() and not bm.is_contiguous()
    assert all(tma_ready(t) for t in (xh, dy, bm, cm))
    assert bwd_uses_tensor_cores(xh.dtype, xh.shape[-1], bm.shape[-1])
    assert bwd_chunk(chunk, xh.shape[2], bm.shape[-1], xh.shape[-1]) == 64


def test_tma_ready_refuses_what_tma_cannot_read():
    base = torch.zeros(4 * 40 * 64 + 8, dtype=torch.bfloat16)
    x = base[:4 * 40 * 64].view(4, 40, 64)
    assert tma_ready(x)
    assert not tma_ready(base[1:4 * 40 * 64 + 1].view(4, 40, 64))  # base off 16 B
    assert not tma_ready(x[..., ::2])  # not unit stride along the last axis
    rows120 = torch.zeros(4, 40, 60, dtype=torch.bfloat16)[..., :56]
    assert rows120.data_ptr() % 16 == 0 and not tma_ready(rows120)  # 120-byte rows
    assert tma_ready(x[:, :1])  # the stride of an axis of size 1 is never used
    assert not tma_ready(x[:1].expand(4, 40, 64))  # a zero stride


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(3, 128), (5, 7, 96), (16, 2048)])
@pytest.mark.parametrize("plus_one", [False, True])
def test_rmsnorm_parity_f32(shape, plus_one):
    rng = np.random.default_rng(70 + shape[-1])  # seed 70+D
    x = rng.normal(size=shape).astype(np.float32)
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    got = tops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), plus_one=plus_one)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    _close(got, jops.rmsnorm(jx, jw, plus_one=plus_one, use_pallas=True), F32_TOL)
    _close(got, jref.rmsnorm_ref(jx, jw, plus_one=plus_one), F32_TOL)


@pytest.mark.parametrize("shape", [(3, 128), (16, 2048)])
def test_rmsnorm_parity_bf16(shape):
    rng = np.random.default_rng(80 + shape[-1])  # seed 80+D
    x = rng.normal(size=shape).astype(np.float32)
    w = (rng.normal(size=shape[-1:]) * 0.1).astype(np.float32)
    got = tops.rmsnorm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                       plus_one=True)
    jx = jnp.asarray(x, jnp.bfloat16)
    jw = jnp.asarray(w)
    assert got.dtype == torch.bfloat16
    # same rounding as the JAX reference: equal up to the last bf16 bit
    _close(got, jref.rmsnorm_ref(jx, jw, plus_one=True), BF16_TOL)
    # the Pallas kernel (like the CUDA one) rounds once, at the end
    _close(got, jops.rmsnorm(jx, jw, plus_one=True, use_pallas=True), BF16_TOL)


# ---------------------------------------------------------------------------
# The CUDA wrappers refuse tensors that do not lie on a card
# ---------------------------------------------------------------------------


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    q = torch.zeros((1, 4, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q[:, :2], q[:, :2], scale=0.125, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_cuda(q, torch.zeros(64), eps=1e-6, plus_one=True)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan_cuda(torch.zeros((1, 2, 16, 8)), torch.zeros((1, 2, 16)),
                      torch.zeros((1, 2, 16)), torch.zeros((1, 16, 4)),
                      torch.zeros((1, 16, 4)), chunk=16)
