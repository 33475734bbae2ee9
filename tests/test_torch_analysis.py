"""PyTorch port, analysis: degree and density summaries, BFS distances and
shortest paths, components, processing, memory reports, temporal networks,
and the attribute, layer and container functions of the api, against the
JAX package.

Both packages run on the CPU. Tolerance: none — integer results, CSR
buffers (dtypes included), byte counts and the float summaries (computed
by the same numpy calls on the same arrays) must be identical. Networks
come from the JAX package's seeded generators, carried across as numpy
arrays; ids and selections from ``np.random.default_rng`` with the seed
named in each test.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from repro.core import analysis as jan
from repro.core import api as japi
from repro.core import layers as jlayers
from repro.core import memory as jmem
from repro.core import processing as jproc
from repro.core import projection as jprojection
from repro.core.temporal import TemporalNetwork as JTemporal
from repro_torch.core import analysis as tan
from repro_torch.core import api as tapi
from repro_torch.core import layers as tlayers
from repro_torch.core import memory as tmem
from repro_torch.core import processing as tproc
from repro_torch.core import projection as tprojection
from repro_torch.core.temporal import TemporalNetwork as TTemporal

from _torch_parity import assert_csr_identical, assert_same, port_layer, port_network


def _build(n=250, seed=0):
    net = japi.createnetwork(japi.createnodeset(n))
    net = japi.generate(japi.addlayer(net, "er", 1), "er", type="er", p=0.012, seed=seed + 1)
    net = japi.generate(japi.addlayer(net, "ba", 1), "ba", type="ba", m=2, seed=seed + 2)
    net = japi.generate(japi.addlayer(net, "wk", 2), "wk", type="2mode", h=40, a=2, seed=seed + 3)
    net = japi.generate(japi.addlayer(net, "hh", 2), "hh", type="2mode", h=90, a=1, seed=seed + 4)
    rng = np.random.default_rng(seed + 5)
    net = japi.setnodeattr(net, "income", np.arange(n), rng.integers(0, 100, n), kind="int")
    sub = rng.choice(n, n // 3, replace=False)
    net = japi.setnodeattr(net, "score", sub, rng.random(sub.size).astype(np.float32),
                           kind="float")
    return net


@pytest.fixture(scope="module")
def nets():
    """250 nodes (er, ba, wk, hh; an int ``income`` and a sparse float
    ``score``, seed 5), a copy whose ``wk`` and ``er`` carry live delta
    overlays (seed 6), and a directed valued layer ``dv`` (seed 7)."""
    net = _build()
    rng = np.random.default_rng(6)
    ov = net.with_layer("wk", jlayers.add_edges(
        net.layer("wk"), rng.integers(0, 250, 30), rng.integers(0, 44, 30),
        compact_ratio=None))
    ov = ov.with_layer("er", jlayers.add_edges(
        ov.layer("er"), rng.integers(0, 250, 40), rng.integers(0, 250, 40),
        compact_ratio=None))
    assert jlayers.has_overlay(ov.layer("wk")) and jlayers.has_overlay(ov.layer("er"))
    rng = np.random.default_rng(7)
    src, dst = rng.integers(0, 250, 900), rng.integers(0, 250, 900)
    dv = jlayers.one_mode_from_edges(
        250, src, dst, values=rng.integers(1, 6, 900).astype(np.float32),
        directed=True, allow_self=True)
    return {"plain": (net, port_network(net)), "overlay": (ov, port_network(ov)),
            "dv": (dv, port_layer("dv", dv))}


def _sel(jnet, tnet):
    return (japi.selectnodes(jnet, "income", ">", 50),
            tapi.selectnodes(tnet, "income", ">", 50))


# ---------------------------------------------------------------------------
# Degree, density, attribute summaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "overlay"])
@pytest.mark.parametrize("layers", [None, ["wk"], ["er", "hh"]])
def test_degree_centrality_and_distribution(nets, variant, layers):
    jnet, tnet = nets[variant]
    assert_same(tan.degree_centrality(tnet, layers), jan.degree_centrality(jnet, layers))
    for jf, tf in ((None, None), _sel(jnet, tnet)):
        jd, jc = jan.degree_distribution(jnet, layers, node_filter=jf)
        td, tc = tan.degree_distribution(tnet, layers, node_filter=tf)
        assert_same(td, jd)
        assert_same(tc, jc)
        assert tapi.degreedist(tnet, layers, filter=tf) == \
            japi.degreedist(jnet, layers, filter=jf)


@pytest.mark.parametrize("filtered", [False, True])
def test_projected_degree(nets, filtered):
    jnet, tnet = nets["plain"]
    jf, tf = _sel(jnet, tnet) if filtered else (None, None)
    u = np.random.default_rng(8).integers(0, 250, 60).astype(np.int32)
    for layers in (None, ["wk"]):
        assert_same(tan.projected_degree(tnet, u, layers, node_filter=tf),
                    jan.projected_degree(jnet, jnp.asarray(u), layers, node_filter=jf))
    assert_same(tan.projected_degree(tnet, u, max_alters=3),
                jan.projected_degree(jnet, jnp.asarray(u), max_alters=3))


def test_density_and_attribute_summary(nets):
    for variant in ("plain", "overlay"):
        jnet, tnet = nets[variant]
        for name in jnet.layer_names:
            assert tapi.getdensity(tnet, name) == japi.getdensity(jnet, name)
    assert tan.density(nets["dv"][1]) == jan.density(nets["dv"][0])
    jnet, tnet = nets["plain"]
    for attr in ("income", "score"):
        assert tapi.attributesummary(tnet, attr) == japi.attributesummary(jnet, attr)


# ---------------------------------------------------------------------------
# BFS, shortest paths, components
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "overlay"])
@pytest.mark.parametrize("layers", [None, ["wk"], ["er", "ba"]])
def test_bfs_distances(nets, variant, layers):
    jnet, tnet = nets[variant]
    for src in (0, 17, 249):
        assert_same(tan.bfs_distances(tnet, src, layers),
                    jan.bfs_distances(jnet, src, layers))
    assert_same(tan.bfs_distances(tnet, 3, layers, max_steps=2),
                jan.bfs_distances(jnet, 3, layers, max_steps=2))


@pytest.mark.parametrize("layers", [None, ["hh"], ["er"]])
def test_shortest_path_length(nets, layers):
    jnet, tnet = nets["overlay"]
    pairs = np.random.default_rng(9).integers(0, 250, (12, 2))
    for s, t in [(4, 4)] + pairs.tolist():
        want = jan.shortest_path_length(jnet, s, t, layers)
        assert tan.shortest_path_length(tnet, s, t, layers) == want
        assert tapi.shortestpath(tnet, s, t, layers) == want


def test_connected_components_and_count(nets):
    for variant in ("plain", "overlay"):
        jnet, tnet = nets[variant]
        for jf, tf in ((None, None), _sel(jnet, tnet)):
            assert_same(tan.connected_components(tnet, ["wk", "hh"], node_filter=tf),
                        jan.connected_components(jnet, ["wk", "hh"], node_filter=jf))
            assert tapi.countcomponents(tnet, filter=tf) == \
                japi.countcomponents(jnet, filter=jf)


# ---------------------------------------------------------------------------
# Processing: CSR buffers byte-identical
# ---------------------------------------------------------------------------


def _same_layer(tl, jl):
    assert tl.mode == jl.mode
    if jl.mode == 2:
        assert_csr_identical(tl.memb, jl.memb)
        assert_csr_identical(tl.members, jl.members)
        assert (tl.max_memberships, tl.max_hyperedge_size) == \
            (jl.max_memberships, jl.max_hyperedge_size)
        return
    assert (tl.directed, tl.valued, tl.allow_self, tl.store_inbound) == \
        (jl.directed, jl.valued, jl.allow_self, jl.store_inbound)
    assert_csr_identical(tl.out, jl.out)
    assert (tl.in_ is None) == (jl.in_ is None)
    if jl.in_ is not None:
        assert_csr_identical(tl.in_, jl.in_)


@pytest.mark.parametrize("method", ["max", "min", "sum", "or"])
def test_symmetrize(nets, method):
    jl, tl = nets["dv"]
    _same_layer(tproc.symmetrize(tl, method), jproc.symmetrize(jl, method))
    jnet, tnet = nets["plain"]
    _same_layer(tproc.symmetrize(tnet.layer("er"), method),
                jproc.symmetrize(jnet.layer("er"), method))


@pytest.mark.parametrize("op", ["gt", "ge", "lt", "le"])
def test_dichotomize_and_filter_edges(nets, op):
    jl, tl = nets["dv"]
    _same_layer(tproc.dichotomize(tl, 3.0, op), jproc.dichotomize(jl, 3.0, op))
    _same_layer(tproc.filter_edges(tl, 2.5), jproc.filter_edges(jl, 2.5))
    jnet, tnet = nets["plain"]
    _same_layer(tproc.dichotomize(tnet.layer("er"), 0.5, op),
                jproc.dichotomize(jnet.layer("er"), 0.5, op))
    with pytest.raises(ValueError, match="valued"):
        tproc.filter_edges(tnet.layer("er"), 1.0)


def test_induced_subnetwork_and_subgraph_layer(nets):
    jnet, tnet = nets["plain"]
    mask = np.random.default_rng(10).random(250) < 0.4
    jsub = japi.subnetwork(jnet, japi.selectnodes(jnet, "income", ">", 30) &
                           type(japi.selectnodes(jnet, "income", ">", 30))(mask))
    tsub = tapi.subnetwork(tnet, tapi.selectnodes(tnet, "income", ">", 30) &
                           type(tapi.selectnodes(tnet, "income", ">", 30))(mask))
    assert (tsub.n_nodes, tsub.layer_names) == (jsub.n_nodes, jsub.layer_names)
    for name in jsub.layer_names:
        _same_layer(tsub.layer(name), jsub.layer(name))
    assert tsub.nodeset.attrs.names == jsub.nodeset.attrs.names
    for tc, jc in zip(tsub.nodeset.attrs.columns, jsub.nodeset.attrs.columns):
        assert tc.kind == jc.kind
        assert_same(tc.node_ids, jc.node_ids)
        assert_same(tc.values, jc.values)
    no_orig = tproc.induced_subnetwork(tnet, mask, orig_id_attr=None)
    assert "orig_id" not in no_orig.nodeset.attrs.names
    with pytest.raises(ValueError, match="entries"):
        tproc.induced_subnetwork(tnet, mask[:10])
    for name in ("wk", "ba"):
        _same_layer(tproc.subgraph_layer(tnet.layer(name), mask),
                    jproc.subgraph_layer(jnet.layer(name), mask))
    jl, tl = nets["dv"]
    _same_layer(tproc.subgraph_layer(tl, mask), jproc.subgraph_layer(jl, mask))


# ---------------------------------------------------------------------------
# Overlay folding, 6a functions, memory and container reports
# ---------------------------------------------------------------------------


def test_compact_layer_and_projection(nets):
    jnet, tnet = nets["overlay"]
    for name in jnet.layer_names:
        assert tlayers.has_overlay(tnet.layer(name)) == jlayers.has_overlay(jnet.layer(name))
        _same_layer(tlayers.compact_layer(tnet.layer(name)),
                    jlayers.compact_layer(jnet.layer(name)))
    _same_layer(tprojection.project_two_mode(tnet.layer("wk")),
                jprojection.project_two_mode(jnet.layer("wk")))
    for name in ("wk", "hh"):
        assert tprojection.projection_nbytes(tnet.layer(name)) == \
            jprojection.projection_nbytes(jnet.layer(name))


def test_drop_inbound(nets):
    jl, tl = nets["dv"]
    td, jd = tl.drop_inbound(), jl.drop_inbound()
    _same_layer(td, jd)
    assert td.nbytes == jd.nbytes < tl.nbytes


@pytest.mark.parametrize("variant", ["plain", "overlay"])
def test_memory_report_and_describenet(nets, variant):
    jnet, tnet = nets[variant]
    jr, tr = jmem.memory_report(jnet), tmem.memory_report(tnet)
    assert (tr.total_nbytes, tr.nodeset_nbytes) == (jr.total_nbytes, jr.nodeset_nbytes)
    for a, b in zip(tr.layers, jr.layers):
        assert (a.name, a.mode, a.nbytes, a.n_edges, a.equivalent_projected_edges,
                a.projection_nbytes, a.compression_ratio) == \
            (b.name, b.mode, b.nbytes, b.n_edges, b.equivalent_projected_edges,
             b.projection_nbytes, b.compression_ratio)
    assert tr.resident_rss_bytes > 0 and tr.peak_rss_bytes > 0
    assert tr.pretty().splitlines()[:-1] == jr.pretty().splitlines()[:-1]
    assert tapi.memoryreport(tnet).total_nbytes == jr.total_nbytes
    assert tapi.describenet(tnet) == japi.describenet(jnet)
    assert tapi.listlayers(tnet) == japi.listlayers(jnet)


def test_attribute_and_layer_functions(nets):
    jnet, tnet = nets["plain"]
    ids = np.array([0, 3, 17, 249])
    for attr in ("income", "score"):
        for a, b in zip(tapi.getnodeattr(tnet, attr, ids),
                        japi.getnodeattr(jnet, attr, ids)):
            assert_same(a, b)
    assert tapi.listattrs(tnet) == japi.listattrs(jnet)
    assert tapi.listattrs(tapi.dropattr(tnet, "score")) == \
        japi.listattrs(japi.dropattr(jnet, "score"))
    assert tnet.nodeset.attrs.without_column("income").names == \
        jnet.nodeset.attrs.without_column("income").names
    assert_same(tnet.nodeset.select_ids("income", ">=", 90),
                jnet.nodeset.select_ids("income", ">=", 90))
    sel = tapi.selectnodes(tnet, "income", "<", 20)
    assert tapi.countnodes(tnet) == 250
    assert tapi.countnodes(tnet, sel) == japi.countnodes(
        jnet, japi.selectnodes(jnet, "income", "<", 20))
    assert tapi.deletelayer(tnet, "ba").layer_names == \
        japi.deletelayer(jnet, "ba").layer_names
    assert tapi.describenet(tapi.deletelayer(tnet, "wk")) == \
        japi.describenet(japi.deletelayer(jnet, "wk"))
    for seed, n, s in ((1, 20, None), (2, 400, None), (3, 5, "sel")):
        jsel = japi.selectnodes(jnet, "income", "<", 20) if s else None
        assert_same(tapi.samplenodes(tnet, n, seed=seed, selection=sel if s else None),
                    japi.samplenodes(jnet, n, seed=seed, selection=jsel))


# ---------------------------------------------------------------------------
# Temporal networks
# ---------------------------------------------------------------------------


def test_temporal_network():
    years = (2019, 2020, 2021)
    jnets = [_build(n=120, seed=10 * i) for i in range(3)]
    jt = JTemporal.from_snapshots(list(zip(years, jnets))[::-1])
    tt = TTemporal.from_snapshots([(y, port_network(n)) for y, n in zip(years, jnets)][::-1])
    assert tt.years == jt.years
    pairs = np.random.default_rng(12).integers(0, 120, (8, 2)).tolist()
    for u, v in pairs:
        for name in ("wk", "er", "hh"):
            assert tt.edge_years(name, u, v) == jt.edge_years(name, u, v)
        assert tt.first_contact(u, v) == jt.first_contact(u, v)
        assert tt.first_contact(u, v, ["hh"]) == jt.first_contact(u, v, ["hh"])
    assert tt.memory_by_year() == jt.memory_by_year()
    assert tt.nbytes == jt.nbytes
    tw, jw = tt.window(2020, 2021), jt.window(2020, 2021)
    assert tw.layer_names == jw.layer_names
    assert tapi.describenet(tw) == japi.describenet(jw)
    assert tt.at(2020).n_nodes == 120
    with pytest.raises(KeyError):
        tt.at(1999)
    with pytest.raises(ValueError, match="no snapshots"):
        tt.window(1990, 1995)
    with pytest.raises(ValueError, match="duplicate"):
        TTemporal.from_snapshots([(2019, tt.at(2019)), (2019, tt.at(2020))])
