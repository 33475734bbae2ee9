"""PyTorch port: the tensor-core flash backward's and the RMSNorm backward's
algorithms on the CPU.

``ref.attention_bwd_blocked`` is the algorithm of the flash backward's
tensor-core route (``csrc/flash_attention_bwd.cu``): it starts from what the
forward writes under grad (``ref.attention_residuals_ref``: o, o_lo and the
log-sum-exp), forms Dd = rowsum(dO ∘ (o + o_lo)) in f32 and feeds P and dS
to each product as two bf16 parts (hi and the rounded rest).
``ref.rmsnorm_bwd_blocked`` is the register route of the RMSNorm backward
(``csrc/rmsnorm.cu``) with dw summed in the kernels' fixed order, at the
launch plan the kernels' library gives (``kernels/rmsnorm.py::bwd_plan``
reads it on the card, where ``tests/test_torch_cuda.py`` checks it). Both
are held against f32 autograd of the plain forward versions
(``ref.attention_bwd_ref``, ``ref.rmsnorm_bwd_ref``) and against the JAX
package's own gradients, ``jax.vjp`` of ``repro.kernels.ref.attention_ref``
and ``rmsnorm_ref`` in f32 on the same values.

Inputs come from ``np.random.default_rng`` at the seed named in each test,
rounded to bf16 as the training path hands them to the kernels.

Limit: every element of every gradient within 2^-6 of its reference value
plus 2^-10 of that gradient's largest magnitude, the limit the backward
kernels are held to on the card (``chip_smoke.py``'s TRAIN_REL_TOL and
TRAIN_FLOOR_TOL): the algorithms round their outputs once to bf16 (2^-9),
and flash's products take P and dS at 16 significant bits, whose errors add
up over the S keys or queries of a sum, some of either sign. (With P and dS
each rounded once to bf16 the same cases reached 1.84 times the limit.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref

REL, FLOOR = 2.0**-6, 2.0**-10


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                            ).bfloat16()


def _excess(got, want) -> float:
    """Largest ratio of |got - want| to the limit REL |want| + FLOOR max |want|."""
    got, want = got.float(), torch.as_tensor(np.array(want)).float()
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    limit = REL * want.abs() + FLOOR * float(want.abs().max())
    return float(((got - want).abs() / limit.clamp_min(1e-30)).max())


def _flash_inputs(seed: int, S: int, D: int, group: int):
    rng = np.random.default_rng(seed)
    B, Hkv = 2, 2
    q, do = (_bf16(rng, (B, Hkv * group, S, D)) for _ in range(2))
    k, v = (_bf16(rng, (B, Hkv, S, D)) for _ in range(2))
    return q, k, v, do


def _jax_attention_grads(q, k, v, do, scale, causal):
    """``jax.vjp`` of the JAX package's attention_ref in f32, in its
    (B·H, S, D) layout, reshaped back to the op's (B, H, S, D)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    flat = [jnp.asarray(t.float().reshape(-1, S, D).numpy()) for t in (q, k, v)]

    def attn(q, k, v):
        return jref.attention_ref(q, k, v, scale=scale, causal=causal,
                                  kv_group=Hq // Hkv)

    _, vjp = jax.vjp(attn, *flat)
    grads = vjp(jnp.asarray(do.float().reshape(-1, S, D).numpy()))
    return [np.asarray(g).reshape(B, -1, S, D) for g in grads]


# (S, D, group, causal): every sequence length, head dim, group and mask
# appears at least twice
FLASH_CASES = [(17, 64, 1, True), (17, 128, 4, False), (128, 64, 2, False),
               (128, 128, 1, True), (200, 64, 4, True), (200, 128, 2, False),
               (128, 128, 4, True), (200, 64, 1, False)]


@pytest.mark.parametrize("S,D,group,causal", FLASH_CASES)
def test_flash_bwd_algorithm_matches_autograd_and_jax(S, D, group, causal):
    q, k, v, do = _flash_inputs(4100 + S + D + group, S, D, group)  # seed 4100+S+D+group
    scale = D**-0.5
    o, o_lo, lse = ref.attention_residuals_ref(q, k, v, scale=scale, causal=causal)
    got = ref.attention_bwd_blocked(q, k, v, do, o, o_lo, lse, scale=scale,
                                    causal=causal)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = ref.attention_bwd_ref(q, k, v, do, scale=scale, causal=causal)
    jax_grads = _jax_attention_grads(q, k, v, do, scale, causal)
    for name, g, w, j in zip(("dq", "dk", "dv"), got, want, jax_grads):
        assert _excess(g, w) <= 1.0, f"{name} against autograd"
        assert _excess(g, j) <= 1.0, f"{name} against jax.vjp"


def test_flash_residuals_match_the_forward():
    """o, o_lo and the log-sum-exp of the plain forward: o is the plain
    attention's output, o + o_lo its f32 output to 16 bits, and the rows of
    exp(S·scale - lse) sum to 1."""
    q, k, v, _ = _flash_inputs(4200, 40, 64, 2)  # seed 4200
    o, o_lo, lse = ref.attention_residuals_ref(q, k, v, scale=0.125, causal=True)
    assert torch.equal(o, ref.attention_heads_ref(q, k, v, scale=0.125, causal=True))
    o32 = ref.attention_heads_ref(q.float(), k.float(), v.float(), scale=0.125)
    assert float((o.float() + o_lo.float() - o32).abs().max()) <= 2.0**-16 * float(
        o32.abs().max())
    kf = torch.repeat_interleave(k.float(), 2, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * 0.125
    s = torch.where(torch.ones((40, 40), dtype=torch.bool).tril(), s, -torch.inf)
    rows = torch.exp(s - lse.reshape(2, 4, 40, 1)).sum(-1)
    torch.testing.assert_close(rows, torch.ones_like(rows), rtol=0, atol=1e-6)


def test_flash_dd_needs_the_residual():
    """Why the forward writes o_lo: Dd from the bf16 o alone errs by about
    2^-9 of each term, and dS = P (dP - Dd) passes that on where dP and Dd
    nearly cancel. On a fixed seed the bf16 o's Dd errs over 100 times more
    than o + o_lo's, and its dq misses the limit that o + o_lo's meets."""
    q, k, v, do = _flash_inputs(4300, 200, 128, 2)  # seed 4300
    q = (q.float() * 4).bfloat16()  # peaked rows: P near one-hot, dP near Dd
    scale = 128**-0.5
    o, o_lo, lse = ref.attention_residuals_ref(q, k, v, scale=scale, causal=True)
    o32 = (o.float() + o_lo.float()).double()
    exact = ref.attention_heads_ref(q.double(), k.double(), v.double(), scale=scale)
    dd_exact = (do.double() * exact).sum(-1)
    err_lo = float(((do.double() * o32).sum(-1) - dd_exact).abs().max())
    err_hi = float(((do.double() * o.double()).sum(-1) - dd_exact).abs().max())
    assert err_hi > 100 * err_lo
    want = ref.attention_bwd_ref(q, k, v, do, scale=scale, causal=True)
    with_lo = ref.attention_bwd_blocked(q, k, v, do, o, o_lo, lse, scale=scale)
    without = ref.attention_bwd_blocked(q, k, v, do, o, torch.zeros_like(o_lo), lse,
                                        scale=scale)
    assert _excess(with_lo[0], want[0]) <= 1.0
    assert _excess(without[0], want[0]) > 1.0


def _jax_rmsnorm_grads(x, w, dy, plus_one):
    _, vjp = jax.vjp(lambda x, w: jref.rmsnorm_ref(x, w, plus_one=plus_one),
                     jnp.asarray(x.float().numpy()), jnp.asarray(w.numpy()))
    return vjp(jnp.asarray(dy.float().numpy()))


# widths: qwen3's q/k norm, mamba2's hidden, qwen3's hidden; rows past one
# grid stride of the plan, so every block's warps take several row groups.
# The plan is the one the kernels' library gives these shapes (4 warps a
# block, 528 blocks, 16 runs; tests/test_torch_cuda.py::
# test_rmsnorm_bwd_plan_routes_each_width holds the library to it)
RMSNORM_PLANS = [(40000, 128, 16, 8), (5000, 768, 32, 2), (2500, 2048, 32, 1)]
RMSNORM_WARPS, RMSNORM_BLOCKS, RMSNORM_SPLIT = 4, 528, 16


@pytest.mark.parametrize("rows,d,lanes,unroll", RMSNORM_PLANS)
def test_rmsnorm_bwd_algorithm_matches_autograd_and_jax(rows, d, lanes, unroll):
    rng = np.random.default_rng(4400 + d)  # seed 4400+d
    x = _bf16(rng, (rows, d), 3.0)
    dy = _bf16(rng, (rows, d))
    w = torch.from_numpy((rng.standard_normal(d) * 0.1).astype(np.float32))
    assert RMSNORM_BLOCKS * RMSNORM_WARPS * (32 // lanes) * unroll < rows
    dx, dw = ref.rmsnorm_bwd_blocked(
        x, w, dy, eps=1e-6, plus_one=True, lanes=lanes, unroll=unroll,
        warps=RMSNORM_WARPS, blocks=RMSNORM_BLOCKS, split=RMSNORM_SPLIT)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    want = ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6, plus_one=True)
    jax_grads = _jax_rmsnorm_grads(x, w, dy, True)
    for name, g, wv, j in zip(("dx", "dw"), (dx, dw), want, jax_grads):
        assert _excess(g, wv) <= 1.0, f"{name} against autograd"
        assert _excess(g, j) <= 1.0, f"{name} against jax.vjp"
