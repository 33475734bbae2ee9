"""The sharded network view of the PyTorch port on the CPU
(``repro_torch.core.sharded``), against the JAX package.

The network is the JAX package's ``_boundary_net`` of
``tests/test_sharded_engine.py``: 400 nodes with hubs and hyperedges
straddling every 8-shard boundary. It is built in the JAX package and
carried across as arrays (``tests/_torch_parity.py``). At 1/2/4/8 shards
the port's ``ShardedNetwork`` must equal, bit for bit and dtype for
dtype, the JAX package's unsharded results (computed once, in process)
and its sharded ones. The JAX package's sharded results, its serving
engine at 4 shards and its ``shard_map`` generation (``ShardedTwoMode``,
``make_sharded_edge_value``, ``make_sharded_walk_step``) run once, in two
subprocesses with 8 forced host devices side by side, started when the
module's first test needs them, so they overlap the in-process work; they
write the npz files the tests read. The JAX package's compiles per shard
count dominate the file's time, so its sharded view answers a probe of
the query set (``run_queries(full=False)``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import np_of, port_layer, port_network

TESTS = Path(__file__).resolve().parent
SRC = str(TESTS.parent / "src")
SHARD_COUNTS = (1, 2, 4, 8)
N = 400
BOUNDS8 = np.asarray([(N * s) // 8 for s in range(1, 8)], np.int64)
KHOP_CASES = ((1, 64), (2, 128), (3, 256))
FILTERED_KHOP_LAYERS = (("ties",), ("hh",), None)
COMPONENT_CASES = ("all", "filtered", "ties", "hh")
WALK_STEPS = 4
WALKERS = 128


# -- the shared query set (JAX side in process, in the subprocess, and the port)


def point_inputs():
    """Boundary-heavy pairs: every 8-shard bound (which holds the 2- and
    4-shard bounds), its neighbors, and a random fill."""
    rng = np.random.default_rng(11)
    b = BOUNDS8
    u = np.concatenate([b, b - 1, b + 1, rng.integers(0, N, 64)]).astype(np.int32)
    v = np.concatenate([b + 1, b, b - 1, rng.integers(0, N, 64)]).astype(np.int32)
    return u, v


def point_filter():
    return np.arange(N) % 3 != 0


def khop_filter():
    return np.arange(N) % 4 != 0


def component_filter():
    return np.arange(N) % 2 == 0


def run_queries(net, components, full: bool = True) -> dict:
    """Every query kind of the module on ``net`` (either package's
    Network, or either package's sharded view) -> {name: numpy array}.
    ``full=False`` runs the probe the JAX package's sharded view answers
    in the subprocess (its compiles per shard count dominate the file's
    time): the point queries, the k = 2 k-hop and the components over
    all layers, unfiltered and filtered."""
    u, v = point_inputs()
    nf = point_filter()
    out = {}
    for flt, tag in ((None, ""), (nf, "f_")):
        for layer in ("ties", "hh"):
            out[f"{tag}edge_{layer}"] = net.edge_value(layer, u, v, node_filter=flt)
        out[f"{tag}check_any"] = net.check_edge_any(u, v, node_filter=flt)
        out[f"{tag}alters_vals"], out[f"{tag}alters_mask"] = net.node_alters(
            u, 64, node_filter=flt)
        out[f"{tag}degree"] = net.degree(u, node_filter=flt)
    src = np.concatenate([BOUNDS8, [0, N - 1]]).astype(np.int32)
    for k, mf in KHOP_CASES if full else KHOP_CASES[1:2]:
        for name, x in zip(("nodes", "mask", "hops"),
                           net.khop(src, k, max_frontier=mf)):
            out[f"khop{k}_{name}"] = x
    cf = component_filter()
    if not full:
        out["components_all"] = components(net)
        out["components_filtered"] = components(net, node_filter=cf)
        return {k: np_of(x) for k, x in out.items()}
    fsrc = np.asarray([0, 57, 113], np.int32)
    for layers in FILTERED_KHOP_LAYERS:
        got = net.khop(fsrc, 2, max_frontier=128, layer_names=layers,
                       node_filter=khop_filter())
        for name, x in zip(("nodes", "mask", "hops"), got):
            out[f"fkhop_{'+'.join(layers or ('all',))}_{name}"] = x
    for case in COMPONENT_CASES:
        kw = {"filtered": {"node_filter": cf}, "ties": {"layer_names": ["ties"]},
              "hh": {"layer_names": ["hh"]}}.get(case, {})
        out[f"components_{case}"] = components(net, **kw)
    return {k: np_of(x) for k, x in out.items()}


def engine_trace() -> list[dict]:
    """The JAX package's engine test trace (tests/test_sharded_engine.py)."""
    rng = np.random.default_rng(5)
    reqs = []
    for _ in range(40):
        reqs.append({"kind": "getedge", "layer": "ties",
                     "u": int(rng.integers(N)), "v": int(rng.integers(N))})
        reqs.append({"kind": "alters", "u": int(rng.integers(N)),
                     "max_alters": 32})
        reqs.append({"kind": "degree", "u": [int(rng.integers(N))
                                             for _ in range(3)]})
    for _ in range(8):
        reqs.append({"kind": "khop", "sources": [int(rng.integers(N))],
                     "k": 2, "max_frontier": 128})
        reqs.append({"kind": "walkbatch", "starts": int(rng.integers(N)),
                     "steps": 4, "seed": 1})
    return reqs


def records(results) -> list:
    return [json.loads(json.dumps(r.to_record())) for r in results]


def edge_layer_jax():
    from repro.core import random_two_mode

    return random_two_mode(1000, 40, 4.0, seed=3)


def walk_layer_jax():
    from repro.core import random_two_mode

    return random_two_mode(400, 12, 3.0, seed=5)


def edge_pairs():
    rng = np.random.default_rng(0)
    return (rng.integers(0, 1000, 512).astype(np.int32),
            rng.integers(0, 1000, 512).astype(np.int32))


# -- the JAX subprocess (8 forced host devices) --------------------------------


#: the two subprocesses' shares: (shard counts of the sharded view, the
#: shard_map generation too, the engine too); they run side by side
JAX_PARTS = (((1, 2), False, True), ((4, 8), True, False))


def jax_subprocess_main(out_path: str, part: int) -> None:
    """Runs in a subprocess: the JAX package's sharded results at the
    part's shard counts, and its shard_map generation at every count or
    its engine at 4 shards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.core.sharded import (
        make_sharded_edge_value, make_sharded_walk_step, shard_network,
        shard_two_mode,
    )
    from repro.serve.graph_engine import GraphServeEngine
    from test_sharded_engine import _boundary_net

    assert len(jax.devices()) == 8
    counts, smap, engine = JAX_PARTS[part]
    net = _boundary_net()
    dump = {}
    for s in counts:
        sn = shard_network(net, s, devices=())
        res = run_queries(sn, lambda g, **kw: g.components(**kw), full=False)
        dump.update({f"s{s}/{k}": v for k, v in res.items()})
    for s in SHARD_COUNTS if smap else ():
        mesh = Mesh(np.asarray(jax.devices()[:s]), ("data",))
        ev = make_sharded_edge_value(shard_two_mode(edge_layer_jax(), s), mesh)
        u, v = edge_pairs()
        dump[f"s{s}/smap_edge"] = np.asarray(ev(jnp.asarray(u), jnp.asarray(v)))
        step = make_sharded_walk_step(shard_two_mode(walk_layer_jax(), s), mesh)
        w = jnp.arange(WALKERS, dtype=jnp.int32)
        for t in range(WALK_STEPS):
            w = step(w, t)
            dump[f"s{s}/smap_walk{t}"] = np.asarray(w)
    if engine:
        dump["engine4"] = np.asarray(json.dumps(
            records(GraphServeEngine(net, shards=4).serve(engine_trace()))))
    np.savez(out_path, **dump)


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The subprocesses' npz files, read lazily: the first test that
    indexes them waits for both."""
    tmp = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, str(TESTS)])
    # one thread each: the subprocesses run beside the test workers
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=1")
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for part in range(len(JAX_PARTS)):
        out = tmp / f"jax_sharded_{part}.npz"
        code = (f"import test_torch_sharded as t; "
                f"t.jax_subprocess_main({str(out)!r}, {part})")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))

    class Lazy:
        data = None

        def _load(self):
            if self.data is None:
                data = {}
                for out, proc in procs:
                    stdout, stderr = proc.communicate(timeout=600)
                    assert proc.returncode == 0, f"STDOUT:\n{stdout}\nSTDERR:\n{stderr}"
                    data.update(np.load(out))
                self.data = data
            return self.data

        def __getitem__(self, key):
            return self._load()[key]

        def __contains__(self, key):
            return key in self._load()

    yield Lazy()
    for _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- in-process fixtures -------------------------------------------------------


@pytest.fixture(scope="module")
def jnet(jax_sharded):
    # jax_sharded first: its subprocesses run while this module works
    from test_sharded_engine import _boundary_net

    return _boundary_net()


@pytest.fixture(scope="module")
def tnet(jnet):
    return port_network(jnet)


@pytest.fixture(scope="module")
def jax_unsharded(jnet):
    from repro.core.traversal import components_batched

    return run_queries(jnet, components_batched)


def _assert_bits(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype, (what, k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {k}")


def _subset(res: dict, prefix: tuple) -> dict:
    return {k: v for k, v in res.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def port(tnet):
    """The port's sharded view's results at a shard count, each computed
    once."""
    from repro_torch.core.sharded import shard_network

    done = {}

    def at(n_shards: int) -> dict:
        if n_shards not in done:
            done[n_shards] = run_queries(shard_network(tnet, n_shards),
                                         lambda g, **kw: g.components(**kw))
        return done[n_shards]

    return at


POINT_KEYS = ("edge_", "check_any", "alters_", "degree")
FILTERED_KEYS = ("f_",)


def _check(got: dict, jax_unsharded: dict, jax_sharded, n_shards: int,
           prefix: tuple) -> None:
    """``got`` equals the JAX package's unsharded results, every key, and
    its sharded view's at ``n_shards``, every key of the subprocess's
    probe (``run_queries(full=False)``)."""
    _assert_bits(got, _subset(jax_unsharded, prefix), "vs JAX unsharded")
    probe = {k: jax_sharded[f"s{n_shards}/{k}"] for k in got
             if f"s{n_shards}/{k}" in jax_sharded}
    _assert_bits({k: got[k] for k in probe}, probe, f"vs JAX at {n_shards} shards")


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_point_queries_bit_identical(port, jax_unsharded, jax_sharded, n_shards):
    got = _subset(port(n_shards), POINT_KEYS)
    _check(got, jax_unsharded, jax_sharded, n_shards, POINT_KEYS)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_point_queries_filtered_bit_identical(port, jax_unsharded, jax_sharded,
                                              n_shards):
    got = _subset(port(n_shards), FILTERED_KEYS)
    _check(got, jax_unsharded, jax_sharded, n_shards, FILTERED_KEYS)


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_khop_bit_identical_across_boundaries(port, jax_unsharded, jax_sharded,
                                              n_shards):
    got = _subset(port(n_shards), ("khop",))
    assert len(got) == 3 * len(KHOP_CASES)
    _check(got, jax_unsharded, jax_sharded, n_shards, ("khop",))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_khop_filtered_and_single_layer(port, jax_unsharded, jax_sharded, n_shards):
    got = _subset(port(n_shards), ("fkhop",))
    assert len(got) == 3 * len(FILTERED_KHOP_LAYERS)
    _check(got, jax_unsharded, jax_sharded, n_shards, ("fkhop",))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_components_bit_identical(port, jax_unsharded, jax_sharded, n_shards):
    got = _subset(port(n_shards), ("components",))
    assert len(got) == len(COMPONENT_CASES)
    _check(got, jax_unsharded, jax_sharded, n_shards, ("components",))


def test_one_shard_degenerate_equals_unsharded(tnet, jnet):
    from repro_torch.core.sharded import shard_network

    sn = shard_network(tnet, 1)
    assert sn.n_shards == 1
    u = np.arange(0, N, 11, dtype=np.int32)
    np.testing.assert_array_equal(np_of(sn.degree(u)), np.asarray(jnet.degree(u)))
    for x, y in zip(sn.khop(u[:4], 2, max_frontier=128),
                    tnet.khop(u[:4], 2, max_frontier=128)):
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def test_shard_rows_partition_the_graph(tnet, jnet):
    """Per-layer shard nnz sums to the layer's; each shard holds exactly
    its range's rows, int64-clamped and cast back to the indptr dtype, its
    host mirror equal to its device indptr; indices are views of the
    source's storage; nbytes is the JAX package's sum."""
    from repro_torch.core.sharded import shard_network

    sn = shard_network(tnet, 4)
    for li in range(len(tnet.layers)):
        whole = tnet.layers[li]
        csr_of = (lambda l: l.memb) if whole.mode == 2 else (lambda l: l.out)
        total = sum(csr_of(s.layers[li]).nnz for s in sn.shards)
        assert total == csr_of(whole).nnz
        indptr = csr_of(whole).indptr_host
        for s, shard in enumerate(sn.shards):
            lo, hi = int(sn.bounds[s]), int(sn.bounds[s + 1])
            sc = csr_of(shard.layers[li])
            sp = sc.indptr_host
            assert sp.dtype == indptr.dtype and sc.indptr.dtype == csr_of(whole).indptr.dtype
            np.testing.assert_array_equal(np_of(sc.indptr), sp)
            assert sp[0] == 0 and sp[lo] == 0 and sp[hi] == sp[-1]
            np.testing.assert_array_equal(
                np.diff(sp[lo:hi + 1]), np.diff(indptr[lo:hi + 1]))
            assert (sc.indices.untyped_storage().data_ptr()
                    == csr_of(whole).indices.untyped_storage().data_ptr())
    assert sn.nbytes == sum(
        sum(l.nbytes for l in sh.layers) for sh in sn.shards) + tnet.nodeset.nbytes
    from repro.core.sharded import shard_network as jax_shard_network

    assert sn.nbytes == jax_shard_network(jnet, 4, devices=()).nbytes


def test_queryrequest_runs_against_sharded(tnet, jnet):
    from repro.core.request import QueryRequest as JQ
    from repro.core.request import run_query as jrun
    from repro_torch.core import api
    from repro_torch.core.request import QueryRequest, assert_results_equal, run_query
    from repro_torch.core.sharded import shard_network

    sn = shard_network(tnet, 4)
    reqs = [
        ("getedge", ("hh", 49, 51), {}),
        ("alters", (50,), {"max_alters": 64}),
        ("degree", ([49, 50, 51],), {}),
        ("khop", ([50], 2), {"max_frontier": 128}),
        ("walkbatch", ([50], 4), {"seed": 3}),
    ]
    for kind, args, kw in reqs:
        want = jrun(jnet, getattr(JQ, kind)(*args, **kw))
        got = run_query(sn, getattr(QueryRequest, kind)(*args, **kw))
        assert_results_equal(got, run_query(tnet, getattr(QueryRequest, kind)(*args, **kw)))
        if isinstance(want, np.ndarray) or hasattr(want, "shape"):
            np.testing.assert_array_equal(np_of(got), np.asarray(want))
        else:
            assert json.loads(json.dumps(got, default=int)) == json.loads(
                json.dumps(want, default=int)), kind
    assert api.khop(sn, [50], 2, max_frontier=128) == api.khop(
        tnet, [50], 2, max_frontier=128)
    assert api.runquery(sn, {"kind": "degree", "u": 50}) == api.runquery(
        tnet, {"kind": "degree", "u": 50})


def test_engine_shards_bit_identical_to_reference(tnet, jax_sharded):
    """The port's engine at 4 shards serves the JAX package's engine test
    trace with the JAX package's sharded engine's records, and the port's
    unsharded engine's."""
    from repro_torch.serve import GraphServeEngine

    trace = engine_trace()
    got = records(GraphServeEngine(tnet, shards=4).serve(trace))
    assert all("error" not in r for r in got)
    assert got == records(GraphServeEngine(tnet).serve(trace))
    assert got == json.loads(str(jax_sharded["engine4"]))


def test_engine_reshards_after_mutation(tnet, monkeypatch):
    """An overlay-only mutation re-slices only the overlays
    (``reshard_deltas``, the shards' base CSRs kept); the view rebinds
    with the network, and a getedge reads the new tie."""
    from repro_torch.core import sharded
    from repro_torch.serve import GraphServeEngine

    routes = []
    real = sharded.reshard_deltas

    def spy(snet, new_net):
        view = real(snet, new_net)
        routes.append(view is not None)
        return view

    monkeypatch.setattr(sharded, "reshard_deltas", spy)
    eng = GraphServeEngine(tnet, shards=4)
    assert isinstance(eng._sharded, sharded.ShardedNetwork)
    before = eng._sharded
    req = {"kind": "getedge", "layer": "ties", "u": 0, "v": N - 1}
    assert eng.serve([req])[0].value == 0.0
    eng.add_edges("ties", [0], [N - 1])
    assert routes == [True]
    assert eng.serve([req])[0].value == 1.0
    assert eng._sharded.source is eng.net
    assert eng.stats["shards"] == 4
    li = tnet.layer_names.index("ties")
    for old, new in zip(before.shards, eng._sharded.shards):
        assert new.layers[li].out is old.layers[li].out
        assert new.layers[li].out_ov is not None
    u, v = point_inputs()
    for x, y in zip(eng._sharded.node_alters(u, 64), eng.net.node_alters(u, 64)):
        assert torch.equal(x, y)


def test_shard_network_validates():
    from repro.core import api as japi
    from repro_torch.core.sharded import shard_network
    from test_sharded_engine import _boundary_net

    jsmall = _boundary_net(n=16)
    net = port_network(jsmall)
    with pytest.raises(ValueError, match="n_shards"):
        shard_network(net, 0)
    sn = shard_network(net, 64)  # more shards than nodes: one a node
    assert sn.n_shards == 16
    ids = np.arange(16, dtype=np.int32)
    np.testing.assert_array_equal(np_of(sn.degree(ids)), np.asarray(jsmall.degree(ids)))
    assert shard_network(port_network(japi.createnetwork(5)), 3).n_shards == 3


# -- the shard_map generation, as a loop over shards ---------------------------


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_edge_value_matches_shard_map(jax_sharded, n_shards):
    from repro_torch.core.sharded import make_sharded_edge_value, shard_two_mode

    layer = port_layer("w", edge_layer_jax())
    graph = shard_two_mode(layer, n_shards)
    assert graph.n_shards == n_shards
    u, v = edge_pairs()
    got = make_sharded_edge_value(graph)(u, v)
    want = jax_sharded[f"s{n_shards}/smap_edge"]
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np_of(got), want)
    np.testing.assert_array_equal(np_of(got), np_of(layer.edge_value(
        torch.from_numpy(u), torch.from_numpy(v))))


@pytest.mark.parametrize("n_shards", SHARD_COUNTS)
def test_sharded_walk_step_matches_shard_map(jax_sharded, n_shards):
    from repro_torch.core.sharded import make_sharded_walk_step, shard_two_mode

    layer = port_layer("w", walk_layer_jax())
    step = make_sharded_walk_step(shard_two_mode(layer, n_shards))
    w = torch.arange(WALKERS, dtype=torch.int32)
    moved = 0
    for t in range(WALK_STEPS):
        nxt = step(w, t)
        assert nxt.dtype == torch.int32
        np.testing.assert_array_equal(np_of(nxt), jax_sharded[f"s{n_shards}/smap_walk{t}"])
        m = nxt != w
        moved += int(m.sum())
        # every move is a pseudo-projected edge (or a self co-member)
        assert not bool((m & (layer.edge_value(w, nxt) == 0)).any())
        w = nxt
    assert moved > 100
