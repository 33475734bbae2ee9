"""PyTorch port, the point-query path: the degree-bucketed dispatcher, the
multilayer Network, the request engine and the script API, against the
JAX package and against the materialized-projection oracle.

Tolerance: none — every result (int32 alters and degrees, float32
shared-hyperedge counts, booleans) must be bit-identical. Networks are
built by the JAX package from seeded generators and carried across as
numpy arrays (``network_from_arrays``); query ids come from
``np.random.default_rng`` with the seed named in each test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import dispatch as jdisp
from repro.core import layers as jlayers
from repro.core import request as jreq
from repro.core.projection import project_two_mode as jproject
from repro_torch.core import api as tapi
from repro_torch.core import dispatch as tdisp
from repro_torch.core import request as treq
from repro_torch.core.network import Network
from repro_torch.core.projection import project_two_mode as tproject
from repro_torch.kernels.build import launch_counts

from _torch_parity import assert_csr_identical, assert_same, port_layer, port_network


def _skewed_jax_layer(seed=0, n_nodes=300, n_hyper=40):
    """Hub node 0, one giant hyperedge (0), size-1 hyperedges, isolated
    nodes (ids >= n_nodes - 20) — the JAX dispatcher tests' layer."""
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, n_nodes - 20, 600)
    hyper = rng.integers(0, n_hyper, 600)
    giant = rng.choice(n_nodes - 20, 120, replace=False)
    singles = rng.integers(0, n_nodes - 20, 5)
    hub_h = rng.choice(n_hyper, 35, replace=False)
    nodes = np.concatenate([nodes, giant, singles, np.zeros(35, int)])
    hyper = np.concatenate(
        [hyper, np.zeros(120, int), np.arange(n_hyper, n_hyper + 5), hub_h]
    )
    return jlayers.two_mode_from_memberships(n_nodes, n_hyper + 5, nodes, hyper)


@pytest.fixture(scope="module")
def skewed():
    j = _skewed_jax_layer()  # seed 0
    return j, port_layer("skewed", j)


@pytest.fixture(scope="module")
def mixed():
    """A mixed-mode network (er, ws, ba, two two-mode layers) with an int
    attribute, like tests/conftest.py::small_mixed_network but larger."""
    net = japi.createnetwork(japi.createnodeset(400))
    net = japi.generate(japi.addlayer(net, "er", 1), "er", type="er", p=0.02, seed=1)
    net = japi.generate(japi.addlayer(net, "ws", 1), "ws", type="ws", k=4, beta=0.1, seed=2)
    net = japi.generate(japi.addlayer(net, "ba", 1), "ba", type="ba", m=3, seed=3)
    net = japi.generate(japi.addlayer(net, "wk", 2), "wk", type="2mode", h=25, a=3, seed=4)
    net = japi.generate(japi.addlayer(net, "sc", 2), "sc", type="2mode", h=4, a=1.5, seed=5)
    income = np.random.default_rng(6).integers(0, 1000, 400)  # seed 6
    net = japi.setnodeattr(net, "income", np.arange(400), income, kind="int")
    return net, port_network(net)


def _ids(seed, n, hi):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.int32)


# ---------------------------------------------------------------------------
# The dispatcher
# ---------------------------------------------------------------------------


def test_plan_buckets_and_ladder_parity():
    deg = np.array([0, 1, 8, 9, 32, 33, 128, 500, 2])
    for max_width in (3, 40, 500):
        got = tdisp.plan_buckets(deg, max_width)
        want = jdisp.plan_buckets(deg, max_width)
        assert [w for _, w in got] == [w for _, w in want]
        for (gi, _), (wi, _) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
    for n in (0, 1, 8, 9, 1000):
        assert tdisp._pow2_rows(n) == jdisp._pow2_rows(n)


def test_node_width_table_and_alters_bound_parity(skewed):
    j, t = skewed
    assert_same(tdisp.node_max_hyperedge_size(t), jdisp.node_max_hyperedge_size(j))
    u = _ids(1, 50, 300)  # seed 1
    assert tdisp.alters_bound([t], u, 300) == jdisp.alters_bound([j], jnp.asarray(u), 300)


@pytest.mark.parametrize("filtered", [False, True])
def test_bucketed_edge_value_parity(skewed, filtered):
    j, t = skewed
    u, v = _ids(2, 257, 300), _ids(3, 257, 300)  # seeds 2, 3
    u[:5] = 0  # the hub
    nf = (np.random.default_rng(4).random(300) < 0.6) if filtered else None
    got = tdisp.bucketed_edge_value(t, torch.from_numpy(u), torch.from_numpy(v),
                                    node_filter=nf)
    want = jdisp.bucketed_edge_value(j, jnp.asarray(u), jnp.asarray(v),
                                     node_filter=nf)
    assert_same(got, want)
    padded = t.edge_value_padded(torch.from_numpy(u), torch.from_numpy(v),
                                 node_filter=nf)
    assert_same(got, padded)
    assert_same(tdisp.bucketed_check_edge(t, torch.from_numpy(u),
                                          torch.from_numpy(v), node_filter=nf),
                np.asarray(want) > 0)


def test_edge_value_vs_projection_oracle(skewed):
    j, t = skewed
    proj_t, proj_j = tproject(t), jproject(j)
    assert_csr_identical(proj_t.out, proj_j.out)
    u, v = _ids(5, 400, 300), _ids(6, 400, 300)  # seeds 5, 6
    got = t.edge_value(torch.from_numpy(u), torch.from_numpy(v))
    assert_same(got, proj_t.edge_value(torch.from_numpy(u), torch.from_numpy(v)))


@pytest.mark.parametrize("max_alters", [3, 40, 4096])
@pytest.mark.parametrize("filtered", [False, True])
def test_bucketed_node_alters_parity(skewed, max_alters, filtered):
    j, t = skewed
    u = _ids(7, 70, 300)  # seed 7
    u[:3] = [0, 299, 1]  # hub, isolated, ordinary
    nf = (np.random.default_rng(8).random(300) < 0.5) if filtered else None
    tv, tm = tdisp.bucketed_node_alters(t, torch.from_numpy(u), max_alters,
                                        node_filter=nf)
    jv, jm = jdisp.bucketed_node_alters(j, jnp.asarray(u), max_alters,
                                        node_filter=nf)
    assert_same(tv, jv)
    assert_same(tm, jm)
    pv, pm = t.node_alters_padded(torch.from_numpy(u), max_alters, node_filter=nf)
    assert_same(tv, pv)
    assert_same(tm, pm)


def test_node_alters_vs_projection_oracle(skewed):
    j, t = skewed
    proj = tproject(t)
    u = _ids(9, 60, 300)  # seed 9
    full = proj.max_degree()
    tv, tm = t.node_alters(torch.from_numpy(u), full)
    pv, pm = proj.node_alters(torch.from_numpy(u), full)
    assert_same(tv, pv)
    assert_same(tm, pm)


def test_bucketed_filtered_degree_parity(skewed, mixed):
    j, t = skewed
    u = _ids(10, 90, 300)  # seed 10
    nf = np.random.default_rng(11).random(300) < 0.5  # seed 11
    got = tdisp.bucketed_filtered_degree(t, torch.from_numpy(u), nf)
    assert_same(got, jdisp.bucketed_filtered_degree(j, jnp.asarray(u), nf))
    assert_same(got, t.filtered_degree_padded(torch.from_numpy(u), nf))
    jnet, tnet = mixed
    nf = np.random.default_rng(12).random(400) < 0.5  # seed 12
    u = _ids(13, 90, 400)  # seed 13
    for name in ("er", "ba"):
        tl, jl = tnet.layer(name), jnet.layer(name)
        got = tdisp.bucketed_filtered_degree(tl, torch.from_numpy(u), nf)
        assert_same(got, jdisp.bucketed_filtered_degree(jl, jnp.asarray(u), nf))
        assert_same(got, tl.filtered_degree_padded(torch.from_numpy(u), nf))


def test_union_rows_kernel_and_sort_path(monkeypatch):
    rng = np.random.default_rng(14)  # seed 14
    vals = rng.integers(0, 50, (6, 90)).astype(np.int32)
    valid = rng.random((6, 90)) < 0.7
    want = jdisp.union_rows(jnp.asarray(vals), jnp.asarray(valid), 20)
    got = tdisp.union_rows(torch.from_numpy(vals), torch.from_numpy(valid), 20)
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])
    # rows wider than the in-block capacity take the wide route (tiles of
    # that capacity, merged), never the sort path
    monkeypatch.setattr(tdisp, "UNION_KERNEL_MAX_FLAT", 64)
    before = launch_counts["segmented_union_sort_rows"]
    got = tdisp.union_rows(torch.from_numpy(vals), torch.from_numpy(valid), 20)
    assert launch_counts["segmented_union_sort_rows"] == before
    assert_same(got[0], want[0])
    assert_same(got[1], want[1])


# ---------------------------------------------------------------------------
# Network + API on a mixed-mode network, with and without a filter
# ---------------------------------------------------------------------------


def test_network_buffers_match_native_build(mixed):
    jnet, tnet = mixed
    native = tapi.createnetwork(tapi.createnodeset(400, device="cpu"))
    native = tapi.generate(tapi.addlayer(native, "wk", 2), "wk",
                           type="2mode", h=25, a=3, seed=4)
    native = tapi.generate(tapi.addlayer(native, "er", 1), "er",
                           type="er", p=0.02, seed=1)
    assert_csr_identical(native.layer("wk").memb, tnet.layer("wk").memb)
    assert_csr_identical(native.layer("er").out, tnet.layer("er").out)
    assert tnet.nbytes == jnet.nbytes


@pytest.mark.parametrize("layer", ["er", "ws", "ba", "wk", "sc"])
@pytest.mark.parametrize("filtered", [False, True])
def test_api_checkedge_getedge_parity(mixed, layer, filtered):
    jnet, tnet = mixed
    u, v = _ids(20, 120, 400), _ids(21, 120, 400)  # seeds 20, 21
    jf = japi.selectnodes(jnet, "income", ">", 500) if filtered else None
    tf = tapi.selectnodes(tnet, "income", ">", 500) if filtered else None
    if filtered:
        np.testing.assert_array_equal(tf.mask, jf.mask)
    assert_same(tapi.checkedge(tnet, layer, u, v, filter=tf),
                japi.checkedge(jnet, layer, u, v, filter=jf))
    assert_same(tapi.getedge(tnet, layer, u, v, filter=tf),
                japi.getedge(jnet, layer, u, v, filter=jf))
    assert tapi.checkedge(tnet, layer, int(u[0]), int(v[0]), filter=tf) == \
        japi.checkedge(jnet, layer, int(u[0]), int(v[0]), filter=jf)
    assert tapi.getedge(tnet, layer, int(u[0]), int(v[0]), filter=tf) == \
        japi.getedge(jnet, layer, int(u[0]), int(v[0]), filter=jf)


@pytest.mark.parametrize("layers", [None, ["wk"], ["wk", "er"], ["sc", "ba", "ws"]])
@pytest.mark.parametrize("filtered", [False, True])
def test_api_getnodealters_parity(mixed, layers, filtered):
    jnet, tnet = mixed
    u = _ids(22, 40, 400)  # seed 22
    jf = japi.selectnodes(jnet, "income", "<=", 400) if filtered else None
    tf = tapi.selectnodes(tnet, "income", "<=", 400) if filtered else None
    for max_alters in (6, 200):
        tv, tm = tapi.getnodealters(tnet, u, layernames=layers,
                                    max_alters=max_alters, filter=tf)
        jv, jm = japi.getnodealters(jnet, u, layernames=layers,
                                    max_alters=max_alters, filter=jf)
        assert_same(tv, jv)
        assert_same(tm, jm)
    assert_same(tapi.getnodealters(tnet, int(u[0]), layernames=layers, filter=tf),
                japi.getnodealters(jnet, int(u[0]), layernames=layers, filter=jf))


@pytest.mark.parametrize("layers", [None, ["wk"], ["er", "sc"]])
@pytest.mark.parametrize("filtered", [False, True])
def test_api_getdegree_parity(mixed, layers, filtered):
    jnet, tnet = mixed
    u = _ids(23, 150, 400)  # seed 23
    jf = japi.selectnodes(jnet, "income", ">=", 250) if filtered else None
    tf = tapi.selectnodes(tnet, "income", ">=", 250) if filtered else None
    assert_same(tapi.getdegree(tnet, u, layernames=layers, filter=tf),
                japi.getdegree(jnet, u, layernames=layers, filter=jf))
    assert tapi.getdegree(tnet, 3, layernames=layers, filter=tf) == \
        japi.getdegree(jnet, 3, layernames=layers, filter=jf)


def test_attribute_surface_parity(mixed):
    jnet, tnet = mixed
    ids = np.array([5, 1, 7, 1])
    jn = japi.setnodeattr(jnet, "score", ids, [0.5, 1.5, 2.5, 3.5])
    tn = tapi.setnodeattr(tnet, "score", ids, [0.5, 1.5, 2.5, 3.5])
    jn = japi.setnodeattr(jn, "income", [2, 3], 7)
    tn = tapi.setnodeattr(tn, "income", [2, 3], 7)
    for name, op, val in (("score", ">", 1.0), ("income", "==", 7),
                          ("score", "has", None), ("income", "!=", 7)):
        np.testing.assert_array_equal(tapi.selectnodes(tn, name, op, val).mask,
                                      japi.selectnodes(jn, name, op, val).mask)
    q = np.arange(10, dtype=np.int32)
    tv, th = tn.nodeset.get_attr("score", torch.from_numpy(q))
    jv, jh = jn.nodeset.get_attr("score", jnp.asarray(q))
    assert_same(tv, jv)
    assert_same(th, jh)


# ---------------------------------------------------------------------------
# A network carrying live delta overlays
# ---------------------------------------------------------------------------


def test_overlay_network_query_parity(mixed):
    jnet, _ = mixed
    rng = np.random.default_rng(24)  # seed 24
    jn = jnet.with_layer("wk", jlayers.add_edges(
        jnet.layer("wk"), rng.integers(0, 400, 25), rng.integers(0, 27, 25),
        compact_ratio=None))
    jn = jn.with_layer("er", jlayers.delete_edges(
        jlayers.add_edges(jn.layer("er"), rng.integers(0, 400, 30),
                          rng.integers(0, 400, 30), compact_ratio=None),
        rng.integers(0, 400, 10), rng.integers(0, 400, 10), compact_ratio=None))
    assert jn.layer("wk").memb_ov is not None and jn.layer("er").out_ov is not None
    tn = port_network(jn)
    u, v = _ids(25, 100, 400), _ids(26, 100, 400)  # seeds 25, 26
    sel_j = japi.selectnodes(jn, "income", ">", 300)
    sel_t = tapi.selectnodes(tn, "income", ">", 300)
    for name in ("wk", "er"):
        assert_same(tapi.getedge(tn, name, u, v), japi.getedge(jn, name, u, v))
    for jf, tf in ((None, None), (sel_j, sel_t)):
        tv, tm = tapi.getnodealters(tn, u[:30], layernames=["wk", "er"],
                                    max_alters=64, filter=tf)
        jv, jm = japi.getnodealters(jn, u[:30], layernames=["wk", "er"],
                                    max_alters=64, filter=jf)
        assert_same(tv, jv)
        assert_same(tm, jm)
        assert_same(tapi.getdegree(tn, u, layernames=["wk", "er"], filter=tf),
                    japi.getdegree(jn, u, layernames=["wk", "er"], filter=jf))


# ---------------------------------------------------------------------------
# The request engine
# ---------------------------------------------------------------------------


def test_request_wire_round_trip_and_batching(mixed):
    jnet, tnet = mixed
    spec = {"attr": "income", "op": "gt", "value": 100}
    dicts = [
        {"kind": "getedge", "layer": "wk", "u": 3, "v": 9},
        {"kind": "getedge", "layer": "wk", "u": 4, "v": 9, "filter": spec},
        {"kind": "alters", "u": 5, "layers": ["wk", "er"], "max_alters": 12},
        {"kind": "alters", "u": 6, "filter": spec},
        {"kind": "degree", "u": [1, 2, 3], "layers": ["sc"]},
        {"kind": "degree", "u": 7, "filter": spec},
    ]
    for d in dicts:
        q = treq.QueryRequest.from_dict(d)
        assert q.to_dict() == d
        assert treq.QueryRequest.from_dict(q.to_dict()) == q
        assert q.to_dict() == jreq.QueryRequest.from_dict(d).to_dict()
    got = treq.run_queries(tnet, dicts)
    want = jreq.run_queries(jnet, dicts)
    for g, w in zip(got, want):
        jreq.assert_results_equal(g, w)
    assert treq.run_query(tnet, dicts[2]).tolist() == \
        jreq.run_query(jnet, dicts[2]).tolist()


def test_request_unported_kinds_and_validation(mixed):
    _, tnet = mixed
    assert treq.run_query(tnet, {"kind": "khop", "sources": [1], "k": 2})[0][
        "source"] == 1
    # walkbatch is ported now: the request equals the JAX package's
    walk = {"kind": "walkbatch", "starts": [1], "steps": 3}
    jreq.assert_results_equal(treq.run_query(tnet, walk),
                              jreq.run_query(mixed[0], walk))
    with pytest.raises(ValueError, match="unknown request kind"):
        treq.run_query(tnet, {"kind": "bogus"})
    with pytest.raises(KeyError):
        treq.run_query(tnet, {"kind": "getedge", "layer": "nope", "u": 1, "v": 2})
    with pytest.raises(ValueError, match="not both"):
        treq.merge_filter_kwargs(np.ones(400, bool), np.ones(400, bool))
    assert isinstance(tnet, Network)
