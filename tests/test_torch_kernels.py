"""PyTorch port, kernels: ``kernels/ops.py`` against the JAX package's ops.

The JAX side runs its Pallas kernels the way ``tests/test_kernels.py``
does (``use_pallas=True``, interpret mode on the CPU); the port's ops run
their plain torch versions here, because the tensors lie on the CPU.
Tolerance: none — int32 outputs and float32 shared-hyperedge counts must
be bit-identical. Inputs come from ``np.random.default_rng`` with the
seed named in each test.

The CUDA kernels themselves are held against the plain versions by
``tests/test_torch_cuda.py`` (marked ``cuda``; skips without a card) and
by ``chip_smoke.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.csr import SENTINEL
from repro.core import layers as jlayers
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import assert_same, port_layer

S = int(SENTINEL)


def _sorted_rows(rng, B, K, universe=400):
    """Sorted unique rows, SENTINEL-padded; every 5th row all-SENTINEL."""
    rows = np.full((B, K), S, dtype=np.int32)
    for i in range(B):
        if i % 5 == 4:
            continue
        n = int(rng.integers(0, K + 1))
        rows[i, :n] = np.sort(rng.choice(universe, size=n, replace=False))
    return rows


def _flat_rows(rng, B, K, universe):
    """Unsorted rows with duplicates and SENTINEL holes; row 0 all-SENTINEL."""
    flat = rng.integers(0, universe, (B, K)).astype(np.int32)
    flat[rng.random((B, K)) < 0.3] = S
    flat[0] = S
    return flat


@pytest.mark.parametrize("K", [8, 32, 128, 300])
def test_intersect_count_parity(K):
    rng = np.random.default_rng(100 + K)  # seed 100+K
    a = _sorted_rows(rng, 13, K)
    b = _sorted_rows(rng, 13, max(K // 2, 3))
    want = jops.intersect_count(jnp.asarray(a), jnp.asarray(b), use_pallas=True)
    got = tops.intersect_count(torch.from_numpy(a), torch.from_numpy(b))
    assert_same(got, want)
    assert_same(tref.intersect_count_ref(torch.from_numpy(a), torch.from_numpy(b)),
                jref.intersect_count_ref(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("K", [8, 32, 128, 300])
@pytest.mark.parametrize("max_out", [1, 7, 64, 310])
def test_segmented_union_parity(K, max_out):
    rng = np.random.default_rng(200 + K + max_out)  # seed 200+K+max_out
    flat = _flat_rows(rng, 9, K, universe=max(K // 3, 2))
    jv, jm = jops.segmented_union(jnp.asarray(flat), max_out, use_pallas=True)
    tv, tm = tops.segmented_union(torch.from_numpy(flat), max_out)
    assert_same(tv, jv)
    assert_same(tm, jm)


def test_segmented_union_batched_shape():
    rng = np.random.default_rng(7)  # seed 7; leading batch dims kept
    flat = _flat_rows(rng, 12, 40, universe=15).reshape(3, 4, 40)
    jv, jm = jops.segmented_union(jnp.asarray(flat), 9, use_pallas=False)
    tv, tm = tops.segmented_union(torch.from_numpy(flat), 9)
    assert_same(tv, jv)
    assert_same(tm, jm)


@pytest.fixture(scope="module")
def two_mode_pair():
    rng = np.random.default_rng(300)  # seed 300
    nodes = rng.integers(0, 250, 1400)
    hyper = rng.integers(0, 35, 1400)
    j = jlayers.two_mode_from_memberships(250, 35, nodes, hyper)
    return j, port_layer("wk", j)


def test_pseudo_edge_value_parity(two_mode_pair):
    j, t = two_mode_pair
    rng = np.random.default_rng(301)  # seed 301
    u = rng.integers(0, 250, 64).astype(np.int32)
    v = rng.integers(0, 250, 64).astype(np.int32)
    want = jops.pseudo_edge_value(j, jnp.asarray(u), jnp.asarray(v), use_pallas=True)
    got = tops.pseudo_edge_value(t, torch.from_numpy(u), torch.from_numpy(v))
    assert_same(got, want)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("max_alters", [5, 60])
def test_pseudo_node_alters_parity(two_mode_pair, filtered, max_alters):
    j, t = two_mode_pair
    rng = np.random.default_rng(302)  # seed 302
    u = rng.integers(0, 250, 16).astype(np.int32)
    nf = rng.random(250) < 0.5 if filtered else None
    jv, jm = jops.pseudo_node_alters(
        j, jnp.asarray(u), max_alters, width_m=8, width_n=32,
        node_filter=None if nf is None else jnp.asarray(nf), use_pallas=True,
    )
    tv, tm = tops.pseudo_node_alters(
        t, torch.from_numpy(u), max_alters, width_m=8, width_n=32,
        node_filter=None if nf is None else torch.from_numpy(nf),
    )
    assert_same(tv, jv)
    assert_same(tm, jm)


def test_filtered_oracles_parity(two_mode_pair):
    j, t = two_mode_pair
    rng = np.random.default_rng(303)  # seed 303
    u = rng.integers(0, 250, 20).astype(np.int32)
    nf = rng.random(250) < 0.4
    jv, jm = j.node_alters_padded(jnp.asarray(u), 400)
    tv, tm = t.node_alters_padded(torch.from_numpy(u), 400)
    assert_same(tv, jv)
    ja, jam = jref.filtered_alters_ref(jv, jm, jnp.asarray(nf), 30)
    ta, tam = tref.filtered_alters_ref(tv, tm, torch.from_numpy(nf), 30)
    assert_same(ta, ja)
    assert_same(tam, jam)
    assert_same(tref.filtered_degree_ref(tv, tm, torch.from_numpy(nf)),
                jref.filtered_degree_ref(jv, jm, jnp.asarray(nf)))
