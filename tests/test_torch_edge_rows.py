"""PyTorch port, GetEdgeValue / CheckEdge on the CPU against the JAX
package: ``dispatch.bucketed_edge_value`` runs ``ops.intersect_rows``,
whose CPU route is the plain version of the CSR-route intersect kernel (the
degree-bucketed route, ``ref.intersect_rows_ref``).

The layer has degree-0 rows, rows wider than 128 and a delta overlay whose
delta has more rows than the base (dirty rows inside and past the base);
the port holds it with uint16 or int32 ids and int32 or int64 ``indptr``,
the delta in the other dtypes. Queries include ids at -1, 0, n - 1, n and
n + 5, u = v, and a node filter shorter than the id range.

Tolerance: none — float32 counts and booleans must be bit-identical.
Inputs come from ``np.random.default_rng`` with the seed named in each
test.
"""

import dataclasses
import functools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import dispatch as jdisp
from repro.core import layers as jlayers
from repro.core.csr import CSR as JCSR
from repro.core.overlay import DeltaOverlay as JDeltaOverlay
from repro.core.overlay import eff_max_degree as j_eff_max_degree
from repro_torch.core import api as tapi
from repro_torch.core import dispatch as tdisp
from repro_torch.core.convert import _layer
from repro_torch.kernels import ops as tops
from repro_torch.kernels.build import launch_counts

from _torch_parity import assert_same, layer_tree

N, H, EXTRA = 200, 700, 8  # nodes, hyperedges, delta rows past the base


def _sorted_ids(rng, n):
    return np.sort(rng.choice(H, size=n, replace=False))


def _csr_arrays(rows):
    indptr = np.zeros(len(rows) + 1, np.int32)
    indptr[1:] = np.cumsum([len(r) for r in rows])
    ids = np.concatenate(rows).astype(np.uint16) if rows else np.zeros(0, np.uint16)
    return indptr, ids


@functools.lru_cache(maxsize=None)
def _jax_layer(overlay: bool):
    """Base rows: node 0-4 wide (130-300 ids), every 7th node empty, the
    rest 1-12 ids of H. Overlay (seed 1701): 30 dirty rows, 5 of them past
    the base, with 0-200 ids each."""
    rng = np.random.default_rng(1700)  # seed 1700
    rows = []
    for i in range(N):
        n = int(rng.integers(130, 301)) if i < 5 else (
            0 if i % 7 == 6 else int(rng.integers(1, 13)))
        rows.append(_sorted_ids(rng, n))
    nodes = np.repeat(np.arange(N), [len(r) for r in rows])
    j = jlayers.two_mode_from_memberships(N, H, nodes, np.concatenate(rows))
    if not overlay:
        return j
    rng = np.random.default_rng(1701)  # seed 1701
    dirty = np.zeros(N + EXTRA, bool)
    dirty[rng.choice(N, 25, replace=False)] = True
    dirty[N + np.array([0, 2, 3, 5, 7])] = True
    delta_rows = [
        _sorted_ids(rng, int(rng.choice([0, 1, 5, 40, 200]))) if d
        else np.zeros(0, np.int64) for d in dirty
    ]
    indptr, ids = _csr_arrays(delta_rows)
    base_lengths = np.diff(np.asarray(j.memb.indptr))
    ov = JDeltaOverlay(
        delta=JCSR(indptr=jnp.asarray(indptr), indices=jnp.asarray(ids),
                   values=None, n_rows=N + EXTRA, n_cols=H),
        dirty=jnp.asarray(dirty),
        base_shadowed=int(base_lengths[dirty[:N]].sum()),
    )
    return dataclasses.replace(
        j, memb_ov=ov, max_memberships=max(j_eff_max_degree(j.memb, ov), 1))


def _port(j, ids_dtype, indptr_dtype):
    """The JAX layer as the port holds it: base ids and indptr in the given
    dtypes, the delta's in the other ones."""
    other = {np.uint16: np.int32, np.int32: np.uint16, np.int64: np.int32}
    tree = layer_tree("x", j)
    csrs = [(tree["memb"], ids_dtype, indptr_dtype)]
    if tree["memb_ov"] is not None:
        csrs.append((tree["memb_ov"]["delta"], other[ids_dtype],
                     other.get(indptr_dtype, np.int64)))
    for c, idt, ipt in csrs:
        c["indices"] = c["indices"].astype(idt)
        c["indptr"] = c["indptr"].astype(ipt)
    return _layer(tree, torch.device("cpu"))


def _pairs(seed):
    """Random pairs over [-2, N + EXTRA + 6), then every pair of the edge
    ids -1, 0, N - 1, N, N + 5 and the wide node 1, then u = v."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-2, N + EXTRA + 6, 300)
    v = rng.integers(-2, N + EXTRA + 6, 300)
    v[:100] = rng.integers(0, 5, 100)  # wide rows on one side
    edge = np.array([-1, 0, N - 1, N, N + 5, 1])
    eu, ev = np.meshgrid(edge, edge)
    same = rng.integers(-1, N + EXTRA, 20)
    u = np.concatenate([u, eu.ravel(), same]).astype(np.int32)
    v = np.concatenate([v, ev.ravel(), same]).astype(np.int32)
    return u, v


def _filter(filtered):
    if not filtered:
        return None
    return np.random.default_rng(1702).random(N - 5) < 0.6  # seed 1702


@functools.lru_cache(maxsize=None)
def _jax_values(overlay, filtered):
    u, v = _pairs(1703)  # seed 1703
    return np.asarray(jdisp.bucketed_edge_value(
        _jax_layer(overlay), jnp.asarray(u), jnp.asarray(v),
        node_filter=_filter(filtered)))


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ids_dtype", [np.uint16, np.int32])
def test_edge_value_plain_route_matches_jax(ids_dtype, indptr_dtype, overlay,
                                            filtered):
    t = _port(_jax_layer(overlay), ids_dtype, indptr_dtype)
    assert t.memb.indices.dtype == torch.from_numpy(np.zeros(0, ids_dtype)).dtype
    assert t.memb.indptr.dtype == torch.from_numpy(np.zeros(0, indptr_dtype)).dtype
    u, v = _pairs(1703)  # seed 1703
    nf = _filter(filtered)
    before = dict(launch_counts)
    got = tdisp.bucketed_edge_value(t, torch.from_numpy(u), torch.from_numpy(v),
                                    node_filter=nf)
    assert dict(launch_counts) == before  # the CPU launches nothing
    want = _jax_values(overlay, filtered)
    assert_same(got, want)
    assert_same(tdisp.bucketed_check_edge(t, u, v, node_filter=nf), want > 0)
    # the same route as the padded plain path, which reads rows whole
    assert_same(got, t.edge_value_padded(torch.from_numpy(u), torch.from_numpy(v),
                                         node_filter=nf))
    assert (want > 0).sum() > 50 and want.max() > 12  # wide rows share ids


def _effective_rows(j):
    """Each id's effective row as a numpy set, with the clip rules."""
    bind, bids = np.asarray(j.memb.indptr), np.asarray(j.memb.indices)
    ov = j.memb_ov

    def row(r):
        if ov is not None:
            dirty = np.asarray(ov.dirty)
            if dirty[min(max(r, 0), dirty.size - 1)]:
                dind, dids = np.asarray(ov.delta.indptr), np.asarray(ov.delta.indices)
                n = dind.size - 1
                return set(dids[dind[min(max(r, 0), n)]:dind[min(max(r + 1, 0), n)]])
        n = bind.size - 1
        return set(bids[bind[min(max(r, 0), n)]:bind[min(max(r + 1, 0), n)]])

    return row


@pytest.mark.parametrize("overlay", [False, True])
def test_intersect_rows_plain_version_counts_shared_ids(overlay):
    """ops.intersect_rows on CPU tensors against counts of shared ids by
    Python sets, the clip rules written out."""
    j = _jax_layer(overlay)
    t = _port(j, np.uint16, np.int64)
    u, v = _pairs(1704)  # seed 1704
    nf = _filter(True)
    row = _effective_rows(j)
    want = np.array([
        len(row(a) & row(b)) if nf[min(max(b, 0), nf.size - 1)] else 0
        for a, b in zip(u.tolist(), v.tolist())], np.int32)
    got = tops.intersect_rows(t.memb, t.memb_ov, torch.from_numpy(u),
                              torch.from_numpy(v), torch.from_numpy(nf),
                              widths=tdisp.DEFAULT_BUCKET_WIDTHS)
    assert_same(got, want)


@pytest.mark.parametrize("filtered", [False, True])
def test_api_getedge_and_checkedge_match_jax(filtered):
    j = _jax_layer(True)
    jnet = japi.createnetwork(japi.createnodeset(N)).with_layer("x", j)
    tnet = tapi.createnetwork(tapi.createnodeset(N, device="cpu")).with_layer(
        "x", _port(j, np.int32, np.int32))
    rng = np.random.default_rng(1705)  # seed 1705
    u, v = rng.integers(0, N, 150), rng.integers(0, N, 150)
    v[:40] = u[:40]
    nf = _filter(filtered)
    nf = None if nf is None else np.concatenate([nf, np.ones(5, bool)])
    assert_same(tapi.getedge(tnet, "x", u, v, filter=nf),
                np.asarray(japi.getedge(jnet, "x", u, v, filter=nf)))
    assert_same(tapi.checkedge(tnet, "x", u, v, filter=nf),
                np.asarray(japi.checkedge(jnet, "x", u, v, filter=nf)))
    assert tapi.getedge(tnet, "x", 3, 3) == japi.getedge(jnet, "x", 3, 3)
