"""Mutation parity of the PyTorch port with the JAX package on the CPU:
``add_edges`` / ``delete_edges`` through ``overlay_update``.

The same batches through both packages give byte-identical layers: base
CSRs, delta CSR arrays, ``dirty`` (and the port's host mirror of it) and
``base_shadowed``; the compaction policy folds the same layers at the
same ratio; and queries on the result (checkedge, getedge, alters,
degree, k-hop, a walk fleet) equal the JAX package's and the port's own
``compacted()``'s. Layers come from ``np.random.default_rng`` with the
seed named in each fixture.
"""

import numpy as np
import pytest
import torch

from repro.core import api as japi
from repro.core.layers import add_edges as j_add
from repro.core.layers import compact_layer as j_compact
from repro.core.layers import delete_edges as j_delete
from repro.core.layers import one_mode_from_edges as j_one_mode
from repro.core.layers import two_mode_from_memberships as j_two_mode
from repro_torch.core import api as tapi
from repro_torch.core.layers import DEFAULT_COMPACT_RATIO, has_overlay
from repro_torch.core.layers import add_edges as t_add
from repro_torch.core.layers import compact_layer as t_compact
from repro_torch.core.layers import delete_edges as t_delete

from _torch_parity import (
    assert_layer_identical,
    assert_network_identical,
    np_of,
    port_layer,
    port_network,
)

N = 120


@pytest.fixture(scope="module")
def base_layers():
    """JAX layers of a few hundred entries each (seed 1910): undirected,
    directed valued, undirected valued, undirected with self-loops, and a
    two-mode layer of 30 groups (uint16 ids)."""
    rng = np.random.default_rng(1910)

    def edges(k):
        return rng.integers(0, N, (2, k))

    s, d = edges(600)
    und = j_one_mode(N, s, d)
    s, d = edges(500)
    dirv = j_one_mode(N, s, d, values=rng.random(500).astype(np.float32),
                      directed=True)
    s, d = edges(400)
    undv = j_one_mode(N, s, d, values=rng.random(400).astype(np.float32))
    s, d = edges(400)
    selfy = j_one_mode(N, s, d, allow_self=True)
    nodes, groups = rng.integers(0, N, 500), rng.integers(0, 30, 500)
    two = j_two_mode(N, 30, nodes, groups)
    return {"und": und, "dirv": dirv, "undv": undv, "self": selfy, "two": two}


def _existing(layer, k: int, seed: int):
    """k stored (row, col) pairs of a layer's base CSR."""
    csr = layer.memb if layer.mode == 2 else layer.out
    indptr, idx = np.asarray(csr.indptr), np.asarray(csr.indices)
    rows = np.repeat(np.arange(csr.n_rows), np.diff(indptr))
    pick = np.random.default_rng(seed).choice(rows.size, k, replace=False)
    return rows[pick].tolist(), idx[pick].astype(np.int64).tolist()


CASES = [
    "undirected add, duplicates and a dropped self-loop",
    "undirected delete, mirrored, missing and out of range",
    "directed valued upsert",
    "valued keep on values=None",
    "undirected valued, both orientations in one batch",
    "self-loops kept where allowed",
    "two-mode add with group growth",
    "two-mode growth past 65,535 on a uint16 base",
    "two-mode delete, missing and out of range",
    "chained adds and deletes",
]


def _batches(layers):
    """name -> (layer key, [op]); op = ("add", src, dst, values) or
    ("delete", src, dst)."""
    ds, dd = _existing(layers["dirv"], 6, 1911)
    us, ud = _existing(layers["undv"], 4, 1912)
    ts, td = _existing(layers["two"], 8, 1913)
    es, ed = _existing(layers["und"], 5, 1914)
    return {
        "undirected add, duplicates and a dropped self-loop": ("und", [
            ("add", [1, 2, 5, 7, 7], [2, 1, 5, 100, 100], None)]),
        "undirected delete, mirrored, missing and out of range": ("und", [
            ("delete", ed[:3] + [3, -1, N + 3], es[:3] + [4, 5, 2])]),
        "directed valued upsert": ("dirv", [
            ("add", ds[:3] + [0, 1], dd[:3] + [9, 9], [7.5, 8.5, 9.5, 1.25, 2.25])]),
        "valued keep on values=None": ("dirv", [
            ("add", ds[3:] + [2, 3], dd[3:] + [11, 12], None)]),
        "undirected valued, both orientations in one batch": ("undv", [
            ("add", [us[0], ud[0], 10, 20], [ud[0], us[0], 20, 10], [2.0, 3.0, 4.0, 5.0])]),
        "self-loops kept where allowed": ("self", [
            ("add", [4, 4, 6], [4, 8, 6], None)]),
        "two-mode add with group growth": ("two", [
            ("add", [1, 2, 3], [35, 40, td[0]], None)]),
        "two-mode growth past 65,535 on a uint16 base": ("two", [
            ("add", [3, 4, 5], [70_000, 70_000, 12], None)]),
        "two-mode delete, missing and out of range": ("two", [
            ("delete", ts[:4] + [0, N + 1, 3], td[:4] + [29, 2, 10**6])]),
        "chained adds and deletes": ("two", [
            ("add", [7, 8, 9], [31, 31, 31], None),
            ("delete", ts[4:] + [7], td[4:] + [31]),
            ("add", [7, 10], [31, 65_536], None)]),
    }


@pytest.mark.parametrize("case", CASES)
def test_batches_write_identical_overlays(base_layers, case):
    key, ops = _batches(base_layers)[case]
    jl = base_layers[key]
    tl = port_layer(key, jl)
    for op in ops:
        if op[0] == "add":
            jl = j_add(jl, op[1], op[2], values=op[3], compact_ratio=None)
            tl = t_add(tl, torch.tensor(op[1]), op[2], values=op[3], compact_ratio=None)
        else:
            jl = j_delete(jl, op[1], op[2], compact_ratio=None)
            tl = t_delete(tl, op[1], torch.tensor(op[2]), compact_ratio=None)
        assert_layer_identical(tl, jl)
    assert has_overlay(tl)
    assert_layer_identical(t_compact(tl), j_compact(jl))


def test_upsert_and_keep_values(base_layers):
    jl = base_layers["dirv"]
    s, d = _existing(jl, 2, 1915)
    tl = port_layer("dirv", jl)
    up = t_add(tl, s[:1], d[:1], values=[42.0], compact_ratio=None)
    keep = t_add(tl, s[1:] + [0], d[1:] + [119], compact_ratio=None)
    u = torch.tensor([s[0], s[1], 0])
    v = torch.tensor([d[0], d[1], 119])
    assert up.edge_value(u[:1], v[:1]).tolist() == [42.0]
    old = tl.edge_value(u[1:2], v[1:2]).tolist()
    assert keep.edge_value(u[1:], v[1:]).tolist() == old + [1.0]


def test_undirected_edges_are_mirrored(base_layers):
    tl = port_layer("undv", base_layers["undv"])
    tl = t_add(tl, [30], [31], values=[6.5], compact_ratio=None)
    assert tl.edge_value(torch.tensor([30, 31]), torch.tensor([31, 30])).tolist() == [6.5, 6.5]
    tl = t_delete(tl, [31], [30], compact_ratio=None)
    assert not tl.check_edge(torch.tensor([30, 31]), torch.tensor([31, 30])).any()


def test_self_loops_are_dropped_unless_allowed(base_layers):
    tl = port_layer("und", base_layers["und"])
    assert t_add(tl, [4], [4], compact_ratio=None) is tl
    ts = t_add(port_layer("self", base_layers["self"]), [4], [4], compact_ratio=None)
    assert bool(ts.check_edge(torch.tensor([4]), torch.tensor([4]))[0])


def test_group_past_uint16_gives_an_int32_delta(base_layers):
    tl = port_layer("two", base_layers["two"])
    assert tl.memb.indices.dtype == torch.uint16
    tl = t_add(tl, [3, 4], [70_000, 70_000], compact_ratio=None)
    assert tl.memb_ov.delta.indices.dtype == torch.int32
    assert tl.n_hyperedges == 70_001
    assert tl.members_ov.delta.n_rows > tl.members.n_rows
    assert float(tl.edge_value(torch.tensor([3]), torch.tensor([4]))[0]) >= 1.0


@pytest.mark.parametrize("ratio", [0, None, DEFAULT_COMPACT_RATIO])
def test_compaction_policy_matches_jax(base_layers, ratio):
    jl, key = base_layers["two"], "two"
    s, d = [1, 2, 3], [4, 5, 6]
    got = t_add(port_layer(key, jl), s, d, compact_ratio=ratio)
    want = j_add(jl, s, d, compact_ratio=ratio)
    assert has_overlay(got) == (ratio != 0)  # 0 rebuilds at once, None never
    assert_layer_identical(got, want)


def test_auto_compaction_past_the_ratio(base_layers):
    jl = base_layers["two"]
    rng = np.random.default_rng(1916)
    s, d = rng.integers(0, N, 300).tolist(), rng.integers(0, 30, 300).tolist()
    got = t_add(port_layer("two", jl), s, d)
    assert not has_overlay(got)
    assert_layer_identical(got, j_add(jl, s, d))


def test_valued_addlayer_takes_values_where_jax_raises():
    """A departure on purpose: the port's ``addlayer(valued=True)`` builds a
    valued layer, so ``addedges(values=)`` upserts; the JAX package's
    ``addlayer`` drops ``valued`` and its ``addedges`` raises."""
    tnet = tapi.addlayer(tapi.createnetwork(tapi.createnodeset(10, device="cpu")),
                         "V", valued=True)
    tnet = tapi.addedges(tnet, "V", [1, 2], [3, 4], values=[2.5, 3.5])
    assert tapi.getedge(tnet, "V", [1, 2], [3, 4]).tolist() == [2.5, 3.5]
    jnet = japi.addlayer(japi.createnetwork(japi.createnodeset(10)), "V", valued=True)
    with pytest.raises(ValueError, match="unvalued"):
        japi.addedges(jnet, "V", [1, 2], [3, 4], values=[2.5, 3.5])


# ---------------------------------------------------------------------------
# Queries on a mutated network: JAX == port == port.compacted()
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mutated(base_layers):
    """A network of the undirected, directed valued and two-mode layers,
    mutated through both packages' api (overlays live), with an income
    filter; -> (JAX net, port net, port net compacted, filter)."""
    jnet = japi.createnetwork(japi.createnodeset(N))
    for name in ("und", "dirv", "two"):
        jnet = jnet.with_layer(name, base_layers[name])
    jnet = japi.setnodeattr(jnet, "income", np.arange(N), np.arange(N) % 7, kind="int")
    tnet = port_network(jnet)
    steps = [("add", "und", [1, 2, 40], [50, 60, 41], None),
             ("delete", "und", *_existing(base_layers["und"], 3, 1917)),
             ("add", "dirv", [5, 6], [7, 8], [1.5, 2.5]),
             ("add", "two", [1, 2, 3, 9], [0, 0, 31, 31], None),
             ("delete", "two", *_existing(base_layers["two"], 3, 1918))]
    for op, layer, s, d, *vals in steps:
        if op == "add":
            jnet = japi.addedges(jnet, layer, s, d, values=vals[0])
            tnet = tapi.addedges(tnet, layer, s, d, values=vals[0])
        else:
            jnet = japi.deleteedges(jnet, layer, s, d)
            tnet = tapi.deleteedges(tnet, layer, s, d)
    assert all(has_overlay(tnet.layer(n)) for n in ("und", "dirv", "two"))
    assert_network_identical(tnet, jnet)
    sel = np.arange(N) % 7 > 2
    return jnet, tnet, tnet.compacted(), sel


def _same(a, b):
    a, b = (x if isinstance(x, (list, dict, int, float, bool)) else np_of(x)
            for x in (a, b))
    if isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b))
    else:
        assert a == b


QUERY_IDS = np.random.default_rng(1919).integers(0, N, (2, 48))


@pytest.mark.parametrize("kind", ["checkedge", "getedge", "alters", "degree",
                                  "degree_filtered", "khop", "walk"])
def test_queries_equal_jax_and_compacted(mutated, kind):
    jnet, tnet, tcomp, sel = mutated
    u, v = QUERY_IDS

    def run(api, net):
        if kind == "checkedge":
            return [api.checkedge(net, name, u, v) for name in ("und", "dirv", "two")]
        if kind == "getedge":
            return [api.getedge(net, name, u, v) for name in ("und", "dirv", "two")]
        if kind == "alters":
            return api.getnodealters(net, u, max_alters=128)[0]
        if kind == "degree":
            return api.getdegree(net, u)
        if kind == "degree_filtered":
            return api.getdegree(net, u, filter=sel)
        if kind == "khop":
            return api.khop(net, u[:8], 2, max_frontier=64)
        return api.walkbatch(net, u[:8], 6, walkers=2, seed=3,
                             layernames=["und", "two"])

    got, comp = run(tapi, tnet), run(tapi, tcomp)
    want = run(japi, jnet)
    if isinstance(want, list) and kind in ("checkedge", "getedge"):
        for g, c, w in zip(got, comp, want):
            _same(g, w)
            _same(c, w)
    else:
        _same(got, want)
        _same(comp, want)


@pytest.mark.parametrize("kind", ["undirected int32", "directed valued",
                                  "directed, no inbound", "two-mode int32",
                                  "row emptied"])
def test_compaction_equals_jax(kind):
    """``compact_layer`` folds each CSR with its overlay; the result must be
    the JAX package's rebuild, widths re-narrowed by the default policy
    included (seed 1923)."""
    from repro.core.csr import POLICY_INT32

    rng = np.random.default_rng(1923)
    s, d = rng.integers(0, N, (2, 400))
    vals = rng.random(400).astype(np.float32)
    if kind == "undirected int32":
        jl = j_one_mode(N, s, d, policy=POLICY_INT32)
    elif kind == "directed valued":
        jl = j_one_mode(N, s, d, values=vals, directed=True)
    elif kind == "directed, no inbound":
        jl = j_one_mode(N, s, d, values=vals, directed=True, store_inbound=False)
    elif kind == "two-mode int32":
        jl = j_two_mode(N, 30, s, d % 30, policy=POLICY_INT32)
    else:
        jl = j_two_mode(N, 30, s, d % 30)
    csr = jl.memb if jl.mode == 2 else jl.out
    row = int(np.argmax(np.diff(np.asarray(csr.indptr))))
    gone = np.asarray(csr.indices)[int(csr.indptr[row]):int(csr.indptr[row + 1])]
    tl = port_layer(kind, jl)
    a, b = rng.integers(0, N, (2, 20))
    if jl.mode == 2:
        b = b % 30
    kw = {"values": rng.random(20).astype(np.float32)} if getattr(jl, "valued", False) else {}
    jl = j_delete(j_add(jl, a, b, compact_ratio=None, **kw),
                  [row] * gone.size, gone, compact_ratio=None)
    tl = t_delete(t_add(tl, a, b, compact_ratio=None, **kw),
                  [row] * gone.size, gone, compact_ratio=None)
    assert_layer_identical(tl, jl)
    assert_layer_identical(t_compact(tl), j_compact(jl))
