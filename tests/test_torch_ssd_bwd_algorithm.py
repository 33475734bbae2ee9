"""PyTorch port: the SSD backward's tensor-core algorithm on the CPU.

``ref.ssd_scan_bwd_blocked`` is the algorithm of the SSD backward's
tensor-core route (``csrc/ssd_scan_bwd.cu``, ``ssd_bwd_tc_states_kernel``
and ``ssd_bwd_tc_grads_kernel``): x, dy, B and C enter the products as the
bf16 values they are; each f32 operand of a product (the states passes'
decay-weighted B and C, the stored states S_c and D, the masked score
tiles M, E and E ∘ dt) goes in as two bf16 parts, hi = bf16(v) and
lo = bf16(v − hi); sums are f32; dx, dB and dC are rounded once to bf16.
It is held against the JAX package's own gradients, ``jax.vjp`` of
``repro.kernels.ref.ssd_scan_chunked_ref`` over (B·H) rows with B and C
repeated over the heads (their gradients summed back), and against f32
autograd of the port's plain scan (``ref.ssd_scan_bwd_ref``).

Inputs come from ``np.random.default_rng`` at the seed named in each test:
x, dy, B and C standard normal rounded to bf16; dt = softplus(z), z
standard normal, and a_log = dt·A with A uniform in [-16, -1] per head, the
ranges mamba2's layer makes (``models/layers.py``, ``Mamba``). P 64 and N
128 are mamba2's widths, the chunk 64 the route's (``ssd_scan.bwd_chunk``).

Limit: every element of every gradient within 2^-6 of its reference value
plus 2^-10 of that gradient's largest magnitude, the limit the backward
kernels are held to on the card (``chip_smoke.py``'s TRAIN_REL_TOL and
TRAIN_FLOOR_TOL). With the pairs the algorithm reaches about 0.22 of it,
all of that the outputs' own bf16 rounding. Rounded once instead of
split (``single=``, 2 heads of 512 steps, seeds 3501–3504), the score
tiles reached 0.51–0.67 of the limit at mamba2's ranges and 1.01–1.19
times it under the slower decay the CUDA tests draw (dt in [0.01, 0.5], A
in [-8, -0.5]); the states 0.80 and the weights 0.50, the two together
0.89: so all three go in as pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

REL, FLOOR = 2.0**-6, 2.0**-10
B, H, P, N, CHUNK = 1, 3, 64, 128, 64
NAMES = ("dx", "ddt", "da_log", "dB", "dC")


def _inputs(seed: int, S: int, heads: int = H, weak: bool = False):
    """mamba2's ranges, or with ``weak`` the slower decay the CUDA tests
    draw (dt uniform in [0.01, 0.5], A in [-8, -0.5])."""
    rng = np.random.default_rng(seed)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()

    x, dy = bf16((B, heads, S, P)), bf16((B, heads, S, P))
    if weak:
        dt = rng.uniform(0.01, 0.5, (B, heads, S)).astype(np.float32)
        a_log = (dt * -rng.uniform(0.5, 8.0, (1, heads, 1))).astype(np.float32)
    else:
        dt = np.logaddexp(0.0, rng.standard_normal((B, heads, S))).astype(np.float32)
        a_log = (dt * -rng.uniform(1.0, 16.0, (1, heads, 1))).astype(np.float32)
    bmat, cmat = bf16((B, S, N)), bf16((B, S, N))
    return x, torch.from_numpy(dt), torch.from_numpy(a_log), bmat, cmat, dy


def _excess(got, want) -> float:
    """Largest ratio of |got - want| to the limit REL |want| + FLOOR max |want|."""
    got, want = got.float(), torch.as_tensor(np.array(want)).float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    limit = REL * want.abs() + FLOOR * float(want.abs().max())
    return float(((got - want).abs() / limit.clamp_min(1e-30)).max())


def _jax_vjp(x, dt, a_log, bmat, cmat, dy, chunk):
    S = x.shape[2]

    def heads(xf, dtf, af, bf, cf):
        rep = lambda m: jnp.repeat(m[:, None], H, axis=1).reshape(B * H, S, N)  # noqa: E731
        y = jref.ssd_scan_chunked_ref(xf.reshape(B * H, S, P), dtf.reshape(B * H, S),
                                      af.reshape(B * H, S), rep(bf), rep(cf), chunk=chunk)
        return y.reshape(B, H, S, P)

    f32 = [jnp.asarray(t.float().numpy()) for t in (x, dt, a_log, bmat, cmat)]
    _, vjp = jax.vjp(heads, *f32)
    return vjp(jnp.asarray(dy.float().numpy()))


@pytest.mark.parametrize("S,jax_chunk", [(256, 64), (200, 40)])
def test_ssd_bwd_blocked_matches_jax_and_autograd(S, jax_chunk):
    """S a multiple of the route's chunk and not (the steps past S padded
    with zeros); the JAX reference needs S % chunk == 0 and takes its own
    chunk, which changes only the order of its sums."""
    args = _inputs(3500 + S, S)  # seed 3500+S
    got = ref.ssd_scan_bwd_blocked(*args, chunk=CHUNK)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32, torch.float32,
                                      torch.bfloat16, torch.bfloat16]
    for against, want in (("jax.vjp", _jax_vjp(*args, jax_chunk)),
                          ("autograd", ref.ssd_scan_bwd_ref(*args, chunk=CHUNK))):
        ratios = {n: _excess(g, w) for n, g, w in zip(NAMES, got, want)}
        assert max(ratios.values()) <= 1.0, (against, ratios)


def test_ssd_bwd_single_rounded_scores_are_rejected():
    """The pairs are needed: the same algorithm with the score tiles rounded
    once to bf16 passes the limit at S 512 under the slower decay, where the
    pairs keep every gradient under a quarter of it."""
    args = _inputs(3501, 512, heads=2, weak=True)  # seed 3501
    want = ref.ssd_scan_bwd_ref(*args, chunk=CHUNK)
    paired = ref.ssd_scan_bwd_blocked(*args, chunk=CHUNK)
    single = ref.ssd_scan_bwd_blocked(*args, chunk=CHUNK, single=("scores",))
    assert max(_excess(g, w) for g, w in zip(paired, want)) < 0.25
    assert max(_excess(g, w) for g, w in zip(single, want)) > 1.0
