"""PyTorch port: the scans' backward algorithms on the CPU.

``ref.rglru_scan_bwd_loop`` and ``ref.ssd_scan_chunked_bwd`` are the
backward kernels' algorithms (``csrc/rglru_scan.cu``,
``csrc/ssd_scan_bwd.cu``) in plain torch, explicit formulas and no
autograd. They are held here against torch autograd of the plain forward
versions (``ref.rglru_scan_bwd_ref``, ``ref.ssd_scan_bwd_ref``) and
against the JAX package's own gradients: ``jax.vjp`` of
``repro.kernels.ref.ssd_scan_chunked_ref`` with B and C repeated over the
heads and their gradients summed back, and ``jax.vjp`` of the RG-LRU's
``jax.lax.associative_scan`` with the combine of
``src/repro/models/layers.py:678-689`` (the reference has no standalone
function for it). Inputs come from ``np.random.default_rng`` with the seed
named in each test; dt in [0.01, 0.5], a_log = -dt A with A in [0.5, 8],
a in [0.5, 1), as the layers make them.

Tolerances (f32 throughout, the sums taken in other orders):
- RG-LRU loop against autograd: 1e-6, rtol and atol (|values| of order 1).
- RG-LRU loop against JAX: 1e-5, rtol and atol (the associative scan
  multiplies the decays in a tree, not step by step).
- SSD chunked backward against autograd and against JAX: rtol 1e-4 plus
  1e-6 of the gradient's largest magnitude (ddt and da_log sum a chunk's
  terms of either sign, the cancelled rounding scales with the largest).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

RGLRU_TOL = 1e-6
RGLRU_JAX_TOL = 1e-5
SSD_RTOL, SSD_FLOOR = 1e-4, 1e-6


def _rglru_inputs(seed: int, B: int, S: int, dr: int, with_h0: bool):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, dr)).astype(np.float32)
    b, dh = (rng.standard_normal((B, S, dr)).astype(np.float32) for _ in range(2))
    h0 = rng.standard_normal((B, dr)).astype(np.float32) if with_h0 else None
    return a, b, h0, dh


def _ssd_inputs(seed: int, B: int, H: int, S: int, P: int, N: int):
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((B, H, S, P)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.01, 0.5, (B, H, S)).astype(np.float32)
    a_log = (-dt * rng.uniform(0.5, 8.0, (1, H, 1))).astype(np.float32)
    bmat, cmat = (rng.standard_normal((B, S, N)).astype(np.float32) for _ in range(2))
    return x, dt, a_log, bmat, cmat, dy


def _t(arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _close_ssd(got, want):
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=SSD_RTOL,
                                   atol=SSD_FLOOR * float(w.abs().max()))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("B,S,dr", [(1, 1, 3), (2, 37, 16)])
def test_rglru_bwd_loop_matches_autograd(B, S, dr, with_h0):
    a, b, h0, dh = _t(_rglru_inputs(3000 + S, B, S, dr, with_h0))  # seed 3000+S
    h = ref.rglru_scan_ref(a, b, h0)
    got = ref.rglru_scan_bwd_loop(a, h, h0, dh)
    want = ref.rglru_scan_bwd_ref(a, b, h0, dh)
    assert (got[2] is None) == (not with_h0) == (want[2] is None)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=RGLRU_TOL, atol=RGLRU_TOL)


def _jax_rglru_scan(a, b, h0):
    """The reference's prefill recurrence (``src/repro/models/layers.py:
    678-689``): the carried state seeded as step 0 of an associative scan."""
    def combine(left, right):
        al, bl = left
        ar, br = right
        return al * ar, bl * ar + br

    a_all = jnp.concatenate([jnp.ones_like(h0[:, None]), a], axis=1)
    b_all = jnp.concatenate([h0[:, None], b], axis=1)
    _, hs = jax.lax.associative_scan(combine, (a_all, b_all), axis=1)
    return hs[:, 1:]


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_bwd_loop_matches_jax_vjp(with_h0):
    a, b, h0, dh = _rglru_inputs(3100, 2, 45, 8, with_h0)  # seed 3100
    h0_j = h0 if with_h0 else np.zeros((2, 8), np.float32)
    _, vjp = jax.vjp(_jax_rglru_scan, jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0_j))
    want = vjp(jnp.asarray(dh))
    at, bt, h0t, dht = _t((a, b, h0, dh))
    got = ref.rglru_scan_bwd_loop(at, ref.rglru_scan_ref(at, bt, h0t), h0t, dht)
    for g, w in zip(got, want):
        if g is not None:
            torch.testing.assert_close(g, torch.from_numpy(np.array(w)),
                                       rtol=RGLRU_JAX_TOL, atol=RGLRU_JAX_TOL)


@pytest.mark.parametrize("chunk", [16, 32])
@pytest.mark.parametrize("S", [64, 45])
def test_ssd_chunked_bwd_matches_autograd(S, chunk):
    """S a multiple of the chunk (the autograd reference runs the chunked
    form) and not (it runs the sequential one)."""
    args = _t(_ssd_inputs(3200 + S + chunk, 2, 3, S, 8, 16))  # seed 3200+S+chunk
    got = ref.ssd_scan_chunked_bwd(*args, chunk=chunk)
    assert [tuple(g.shape) for g in got] == [(2, 3, S, 8), (2, 3, S), (2, 3, S),
                                             (2, S, 16), (2, S, 16)]
    _close_ssd(got, ref.ssd_scan_bwd_ref(*args, chunk=chunk))


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_bwd_matches_jax_vjp(chunk):
    """``jax.vjp`` of the reference's chunked SSD (which needs S % chunk ==
    0) over (B*H) rows, B and C repeated over the heads: their gradients
    summed back over the heads."""
    B, H, S, P, N = 2, 3, 64, 8, 16
    x, dt, a_log, bmat, cmat, dy = _ssd_inputs(3300 + chunk, B, H, S, P, N)  # seed 3300+chunk

    def heads(xf, dtf, af, bf, cf):
        rep = lambda m: jnp.repeat(m[:, None], H, axis=1).reshape(B * H, S, N)  # noqa: E731
        y = jref.ssd_scan_chunked_ref(xf.reshape(B * H, S, P), dtf.reshape(B * H, S),
                                      af.reshape(B * H, S), rep(bf), rep(cf), chunk=chunk)
        return y.reshape(B, H, S, P)

    _, vjp = jax.vjp(heads, *(jnp.asarray(t) for t in (x, dt, a_log, bmat, cmat)))
    want = vjp(jnp.asarray(dy))
    got = ref.ssd_scan_chunked_bwd(*_t((x, dt, a_log, bmat, cmat, dy)), chunk=chunk)
    _close_ssd(got, want)


def test_ssd_chunked_bwd_pads_past_the_sequence():
    """The steps past S take no gradient: S = 45 at chunk 32 against the
    same scan with 19 zero steps appended, cut back to 45."""
    x, dt, a_log, bmat, cmat, dy = _t(_ssd_inputs(3400, 1, 2, 45, 8, 16))  # seed 3400
    pad = lambda t, axis: torch.cat(  # noqa: E731
        [t, torch.zeros_like(t.narrow(axis, 0, 19))], dim=axis)
    long = [pad(x, 2), pad(dt, 2), pad(a_log, 2), pad(bmat, 1), pad(cmat, 1), pad(dy, 2)]
    got = ref.ssd_scan_chunked_bwd(x, dt, a_log, bmat, cmat, dy, chunk=32)
    want = ref.ssd_scan_chunked_bwd(*long, chunk=32)
    for g, w, axis in zip(got, want, (2, 2, 2, 1, 1)):
        torch.testing.assert_close(g, w.narrow(axis, 0, 45), rtol=0, atol=0)
