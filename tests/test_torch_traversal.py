"""PyTorch port, batched traversal: frontier compaction, k-hop BFS, ego
batches and components, against the JAX package.

The JAX side runs the frontier Pallas kernel the way
``tests/test_kernels.py`` does (``use_pallas=True``, interpret mode on the
CPU) and its traversal through its default CPU path; the port runs its
plain torch versions, because the tensors lie on the CPU. Tolerance:
none — every output is int32 or bool and must be bit-identical (dtype,
shape and values). Networks are built by the JAX package from seeded
generators and carried across as numpy arrays; ids and filters come from
``np.random.default_rng`` with the seed named in each test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import layers as jlayers
from repro.core import overlay as jov
from repro.core import request as jreq
from repro.core import traversal as jtrav
from repro.core.csr import SENTINEL
from repro.core.network import create_network as jcreate_network
from repro.core.nodeset import NodeSelection as JSelection
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import api as tapi
from repro_torch.core import overlay as tov
from repro_torch.core import request as treq
from repro_torch.core import traversal as ttrav
from repro_torch.core.nodeset import NodeSelection as TSelection
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import launch_counts

from _torch_parity import assert_same, port_layer, port_network

S = int(SENTINEL)


@pytest.fixture(scope="module")
def mixed(small_mixed_network):
    """tests/conftest.py's 100-node network (er, ws, ba, wk) plus an int
    ``income`` attribute (seed 30), in both packages."""
    income = np.random.default_rng(30).integers(0, 1000, 100)
    jnet = japi.setnodeattr(small_mixed_network, "income", np.arange(100),
                            income, kind="int")
    return jnet, port_network(jnet)


def _filters(jnet, tnet, filtered):
    if not filtered:
        return None, None
    return (japi.selectnodes(jnet, "income", ">", 300),
            tapi.selectnodes(tnet, "income", ">", 300))


def _same_khop(got, want):
    for g, w in zip(got, want):
        assert_same(g, w)


# ---------------------------------------------------------------------------
# frontier compaction
# ---------------------------------------------------------------------------


def _frontier_inputs(rng, B, Kc, Kv, universe):
    """Unsorted candidates with duplicates and SENTINEL holes (row 0 all
    SENTINEL); visited rows that overlap them, with duplicates and
    SENTINEL pads, in any order."""
    cand = rng.integers(0, universe, (B, Kc)).astype(np.int32)
    cand[rng.random((B, Kc)) < 0.3] = S
    cand[0] = S
    visited = rng.integers(0, universe, (B, Kv)).astype(np.int32)
    visited[rng.random((B, Kv)) < 0.3] = S
    return cand, visited


@pytest.mark.parametrize("B,Kc,Kv,max_out", [
    (5, 8, 1, 4),        # hop 1: visited is the source column
    (9, 130, 257, 64),   # candidates past one 128-lane tile
    (3, 512, 100, 600),  # max_out above the kept count
])
def test_frontier_compact_parity(B, Kc, Kv, max_out):
    for seed in (0, 1):
        rng = np.random.default_rng(seed * 1000 + Kc)  # seed seed*1000+Kc
        cand, visited = _frontier_inputs(rng, B, Kc, Kv, universe=max(Kc // 2, 4))
        jc, jv = jnp.asarray(cand), jnp.asarray(visited)
        tc, tv = torch.from_numpy(cand), torch.from_numpy(visited)
        want = jops.frontier_compact(jc, jv, max_out, use_pallas=True,
                                     interpret=True)
        _same_khop(jref.frontier_ref(jc, jv, max_out), want)
        tsorted = torch.sort(tv, dim=-1).values
        for got in (tops.frontier_compact(tc, tv, max_out),
                    tops.frontier_compact(tc, tsorted, max_out, visited_sorted=True),
                    tref.frontier_ref(tc, tv, max_out),
                    tref.frontier_search_ref(tc, tsorted, max_out)):
            _same_khop(got, want)


# ---------------------------------------------------------------------------
# k-hop neighborhoods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,filtered,k,mf", [
    (None, False, 3, None),  # exact per-hop caps, default frontier cap
    (None, True, 2, 16),
    (["wk"], False, 2, 16),
    (["er", "wk"], True, 3, None),
    (["ws", "ba"], False, 2, 16),
])
def test_khop_neighborhood_parity(mixed, layers, filtered, k, mf):
    jnet, tnet = mixed
    jf, tf = _filters(jnet, tnet, filtered)
    src = np.random.default_rng(31).integers(0, 100, 8).astype(np.int32)  # seed 31
    want = jtrav.khop_neighborhood(jnet, jnp.asarray(src), k, max_frontier=mf,
                                   layer_names=layers, node_filter=jf)
    for use_kernel in (True, False):
        _same_khop(ttrav.khop_neighborhood(tnet, src, k, max_frontier=mf,
                                           layer_names=layers, node_filter=tf,
                                           use_kernel=use_kernel), want)


def test_khop_edge_cases_parity(mixed):
    jnet, tnet = mixed
    # k = 0: sources only
    _same_khop(ttrav.khop_neighborhood(tnet, [2, 9], 0),
               jtrav.khop_neighborhood(jnet, jnp.asarray([2, 9], jnp.int32), 0))
    # every alter filtered out: only the sources remain, early exit at hop 1
    jn, tn = JSelection(np.zeros(100, bool)), TSelection(np.zeros(100, bool))
    _same_khop(
        ttrav.khop_neighborhood(tnet, [0, 50], 3, max_frontier=16, node_filter=tn),
        jtrav.khop_neighborhood(jnet, jnp.asarray([0, 50], jnp.int32), 3,
                                max_frontier=16, node_filter=jn),
    )
    # a degree-0 source (node 3 of a 4-node layer with one edge)
    jsmall = jcreate_network(4).with_layer(
        "l", jlayers.one_mode_from_edges(4, [0], [1]))
    tsmall = port_network(jsmall)
    _same_khop(ttrav.khop_neighborhood(tsmall, [3, 0], 2, max_frontier=4),
               jtrav.khop_neighborhood(jsmall, jnp.asarray([3, 0], jnp.int32), 2,
                                       max_frontier=4))
    # one hyperedge (200 members) wider than the largest bucket width
    n = 260
    layer = jlayers.two_mode_from_memberships(
        n, 2, np.concatenate([np.arange(200), [200, 201, 202]]),
        np.concatenate([np.zeros(200, np.int64), np.ones(3, np.int64)]),
    )
    jbig = jcreate_network(n).with_layer("aff", layer)
    tbig = port_network(jbig)
    _same_khop(ttrav.khop_neighborhood(tbig, [0, 201], 1, max_frontier=n),
               jtrav.khop_neighborhood(jbig, jnp.asarray([0, 201], jnp.int32), 1,
                                       max_frontier=n))


def test_khop_multi_chunk_and_plain_rows(mixed, monkeypatch):
    """Slot chunking and over-capacity rows change no result: the JAX
    package expands each hop in one shot (its MAX_CAND_FLAT is 65,536)."""
    jnet, tnet = mixed
    src = np.random.default_rng(32).integers(0, 100, 8).astype(np.int32)  # seed 32
    want = jtrav.khop_neighborhood(jnet, jnp.asarray(src), 3, max_frontier=16)
    calls = []
    inner = ttrav._frontier_alters
    monkeypatch.setattr(ttrav, "_frontier_alters",
                        lambda *a: calls.append(1) or inner(*a))
    monkeypatch.setattr(ttrav, "MAX_CAND_FLAT", 64)
    _same_khop(ttrav.khop_neighborhood(tnet, src, 3, max_frontier=16), want)
    assert len(calls) > 3  # more than one chunk per hop
    # rows wider than the kernel's capacity take the counted plain path
    monkeypatch.setattr(ttrav, "FRONTIER_KERNEL_MAX", 16)
    before = launch_counts["frontier_sort_rows"]
    _same_khop(ttrav.khop_neighborhood(tnet, src, 3, max_frontier=16), want)
    assert launch_counts["frontier_sort_rows"] > before


# ---------------------------------------------------------------------------
# ego batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("layers,filtered", [(None, False), (["wk", "er"], True)])
def test_ego_batch_parity(mixed, k, layers, filtered):
    jnet, tnet = mixed
    jf, tf = _filters(jnet, tnet, filtered)
    egos = np.random.default_rng(33).integers(0, 100, 8).astype(np.int32)  # seed 33
    want = jtrav.ego_batch(jnet, jnp.asarray(egos), 16, k=k,
                           layer_names=layers, node_filter=jf)
    _same_khop(ttrav.ego_batch(tnet, egos, 16, k=k, layer_names=layers,
                               node_filter=tf), want)
    _same_khop(tnet.ego_batch(egos, 16, k=k, layer_names=layers,
                              node_filter=tf), want)


# ---------------------------------------------------------------------------
# components
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def overlay_net(mixed):
    """The mixed network with live overlays on ``wk`` (added memberships)
    and ``er`` (added and deleted edges), seed 34."""
    jnet, _ = mixed
    rng = np.random.default_rng(34)
    big = jlayers.two_mode_from_memberships(
        100, 12, rng.integers(0, 100, 400), rng.integers(0, 12, 400))
    jn = jnet.with_layer("wk", jlayers.add_edges(
        big, rng.integers(0, 100, 6), rng.integers(0, 14, 6), compact_ratio=None))
    jn = jn.with_layer("er", jlayers.delete_edges(
        jlayers.add_edges(jn.layer("er"), rng.integers(0, 100, 5),
                          rng.integers(0, 100, 5), compact_ratio=None),
        rng.integers(0, 100, 30), rng.integers(0, 100, 30), compact_ratio=None))
    assert jn.layer("wk").memb_ov is not None and jn.layer("er").out_ov is not None
    return jn, port_network(jn)


@pytest.mark.parametrize("layers,filtered,overlay", [
    (None, False, False),
    (["er"], True, False),
    (["wk"], True, False),
    (None, True, True),
    (["wk"], False, True),
    (["er", "ws"], False, True),
])
def test_components_batched_parity(mixed, overlay_net, layers, filtered, overlay):
    jnet, tnet = overlay_net if overlay else mixed
    jf, tf = _filters(jnet, tnet, filtered)
    for max_sweeps in (None, 1):  # 1: the intermediate labels must match too
        want = jtrav.components_batched(jnet, layers, node_filter=jf,
                                        max_sweeps=max_sweeps)
        got = ttrav.components_batched(tnet, layers, node_filter=tf,
                                       max_sweeps=max_sweeps)
        assert_same(got, want)
    assert tapi.countcomponents(tnet, layers, filter=tf) == \
        japi.countcomponents(jnet, layers, filter=jf)
    assert tapi.componentsfast(tnet, layers, filter=tf) == \
        japi.componentsfast(jnet, layers, filter=jf)


def test_components_long_path_converges():
    n = 400
    jnet = jcreate_network(n).with_layer(
        "path", jlayers.one_mode_from_edges(n, np.arange(n - 1), np.arange(1, n)))
    tnet = port_network(jnet)
    before = launch_counts["components_sweeps"]
    got = ttrav.components_batched(tnet)
    assert_same(got, jtrav.components_batched(jnet))
    assert int((got == 0).sum()) == n
    assert 1 < launch_counts["components_sweeps"] - before < 40  # O(log n)


def test_eff_edge_stream_parity(overlay_net):
    jnet, tnet = overlay_net
    for name, attrs in (("wk", ("memb", "members")), ("er", ("out",))):
        jl, tl = jnet.layer(name), tnet.layer(name)
        for a in attrs:
            jb, job = getattr(jl, a), getattr(jl, a + "_ov")
            tb, tob = getattr(tl, a), getattr(tl, a + "_ov")
            for g, w in zip(tov.eff_edge_stream(tb, tob), jov.eff_edge_stream(jb, job)):
                assert_same(g, np.asarray(w).astype(np.int32))
            for g, w in zip(tov.eff_coo(tb, tob), jov.eff_coo(jb, job)):
                if w is None:
                    assert g is None
                else:
                    assert_same(g, w)
    ts = port_layer("ws", jnet.layer("ws"))
    rows, cols = tov.eff_edge_stream(ts.out, None)
    assert_same(rows, jov.eff_edge_stream(jnet.layer("ws").out, None)[0])
    assert cols.dtype == torch.int32


# ---------------------------------------------------------------------------
# api and the request engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layers,filtered", [(None, False), (["wk", "ba"], True)])
def test_api_khop_egosample_and_request_parity(mixed, layers, filtered):
    jnet, tnet = mixed
    jf, tf = _filters(jnet, tnet, filtered)
    src = [int(s) for s in np.random.default_rng(35).integers(0, 100, 8)]  # seed 35
    got = tapi.khop(tnet, src, 2, layernames=layers, max_frontier=16, filter=tf)
    assert got == japi.khop(jnet, src, 2, layernames=layers, max_frontier=16,
                            filter=jf)
    assert got == treq.run_query(tnet, treq.QueryRequest.khop(
        src, 2, layers=layers, max_frontier=16, filter=tf))
    assert tapi.khop(tnet, src[0], 1) == japi.khop(jnet, src[0], 1)
    assert tapi.egosample(tnet, src, max_alters=16, k=2, layernames=layers,
                          filter=tf) == \
        japi.egosample(jnet, src, max_alters=16, k=2, layernames=layers, filter=jf)
    # wire form, batched with other kinds; equal to the JAX engine's results
    spec = {"attr": "income", "op": "gt", "value": 300} if filtered else None
    reqs = [{"kind": "khop", "sources": src[:4], "k": 2, "max_frontier": 16},
            {"kind": "khop", "sources": src[4:], "k": 2, "max_frontier": 16},
            {"kind": "khop", "sources": [src[0]], "k": 1, "layers": layers},
            {"kind": "alters", "u": src[0], "max_alters": 9}]
    if spec is not None:
        for r in reqs:
            r["filter"] = spec
    for d in reqs:
        assert treq.QueryRequest.from_dict(d).to_dict() == \
            jreq.QueryRequest.from_dict(d).to_dict()
    for g, w in zip(treq.run_queries(tnet, reqs), jreq.run_queries(jnet, reqs)):
        jreq.assert_results_equal(g, w)


def test_unported_walks_still_raise(mixed):
    """Walks are ported now (they raised before): the walkbatch request and
    the fleet equal the JAX package's; a malformed khop still raises."""
    import jax

    from repro_torch.core import prng

    jnet, tnet = mixed
    walk = {"kind": "walkbatch", "starts": [1], "steps": 3}
    jreq.assert_results_equal(treq.run_query(tnet, walk), jreq.run_query(jnet, walk))
    assert_same(ttrav.random_walk_batch(tnet, [1], 3, prng.key(4)),
                jtrav.random_walk_batch(jnet, jnp.asarray([1]), 3,
                                        jax.random.PRNGKey(4)))
    with pytest.raises(ValueError, match="k must be >= 0"):
        treq.run_query(tnet, {"kind": "khop", "sources": [1], "k": -1})
