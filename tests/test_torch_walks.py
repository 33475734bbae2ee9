"""PyTorch port, sampling: the threefry generator, row samples, walk
steps, walk fleets, neighborhood samples, the walkbatch request and the
estimators, against the JAX package (``jax.random`` and ``repro``).

Both packages run on the CPU; the port runs its plain torch versions of
the threefry kernels, because its tensors lie there. Tolerance: none for
keys, bits, integer draws, row samples, walk paths and samples (dtype,
shape and values bit-identical); the estimators' float results within
rel 1e-6 (float32 means summed in another order). Each plain version is
also held against a literal numpy threefry (``_np_threefry``), so the
oracle is not only checked through JAX. Networks come from the JAX
package's seeded generators; ids and filters from
``np.random.default_rng`` with the seed named in each test.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import estimators as jest
from repro.core import layers as jlayers
from repro.core import overlay as jov
from repro.core import request as jreq
from repro.core import traversal as jtrav
from repro.core import walks as jwalks
from repro.core.csr import csr_row_sample as jcsr_row_sample
from repro_torch.core import api as tapi
from repro_torch.core import estimators as test_
from repro_torch.core import overlay as tov
from repro_torch.core import prng
from repro_torch.core import request as treq
from repro_torch.core import traversal as ttrav
from repro_torch.core import walks as twalks
from repro_torch.core.csr import csr_row_sample as tcsr_row_sample
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_parity import assert_same, port_network

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def nets():
    """300 nodes: an ER layer, two two-mode layers (one with a live delta
    overlay on its membership CSR, seed 12) and an int ``income``
    attribute (seed 11), in both packages."""
    net = japi.createnetwork(japi.createnodeset(300))
    net = japi.generate(japi.addlayer(net, "er", 1), "er", type="er", p=0.02, seed=1)
    net = japi.generate(japi.addlayer(net, "wk", 2), "wk", type="2mode", h=30, a=3, seed=4)
    net = japi.generate(japi.addlayer(net, "hh", 2), "hh", type="2mode", h=120, a=1, seed=5)
    income = np.random.default_rng(11).integers(0, 100, 300)
    net = japi.setnodeattr(net, "income", np.arange(300), income, kind="int")
    rng = np.random.default_rng(12)
    ov = net.with_layer("wk", jlayers.add_edges(
        net.layer("wk"), rng.integers(0, 300, 40), rng.integers(0, 34, 40),
        compact_ratio=None))
    assert ov.layer("wk").memb_ov is not None
    return {"plain": (net, port_network(net)), "overlay": (ov, port_network(ov))}


def _starts(seed, n, n_nodes=300):
    return np.random.default_rng(seed).integers(0, n_nodes, n).astype(np.int32)


# ---------------------------------------------------------------------------
# A literal numpy threefry-2x32 (Python ints, one element at a time): the
# oracle the plain versions are held against, independent of JAX
# ---------------------------------------------------------------------------


def _np_threefry(k0, k1, x0, x1):
    m = 0xFFFFFFFF
    ks = [k0, k1, k0 ^ k1 ^ 0x1BD11BDA]
    rot = [[13, 15, 26, 6], [17, 29, 16, 24]]
    x0, x1 = (x0 + ks[0]) & m, (x1 + ks[1]) & m
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & m
            x1 = ((x1 << r) | (x1 >> (32 - r))) & m
            x1 ^= x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & m
    return x0, x1


def _np_bits(key, i):
    a, b = _np_threefry(key[0], key[1], i >> 32, i & 0xFFFFFFFF)
    return a ^ b


def _np_randint(key, i, lo, hi):
    m = 0xFFFFFFFF
    k1, k2 = (_np_threefry(key[0], key[1], 0, j) for j in (0, 1))
    span = 1 if hi <= lo else (hi - lo) & m
    mult = (((65536 % span) ** 2) & m) % span  # the square wraps mod 2^32
    off = ((_np_bits(k1, i) % span) * mult + _np_bits(k2, i) % span) & m
    return np.int32(np.uint32((lo + off % span) & m).view(np.int32))


def test_threefry_partitionable_is_jax_default():
    """The port implements only the partitionable scheme: a change of
    JAX's default must fail here, loudly."""
    assert jax.config.jax_threefry_partitionable is True


# ---------------------------------------------------------------------------
# core/prng.py against jax.random
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, -1])
def test_prng_key_words(seed):
    assert prng.key(seed) == tuple(
        int(w) for w in np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 7])
def test_prng_split_and_fold_in(num):
    jk = jax.random.PRNGKey(num)
    want = [tuple(int(w) for w in r) for r in np.asarray(jax.random.split(jk, num))]
    assert prng.split(prng.key(num), num) == want
    for data in (0, 5, 2**32 - 1):
        assert prng.fold_in(prng.key(num), data) == tuple(
            int(w) for w in np.asarray(jax.random.fold_in(jk, data)))
    with pytest.raises(OverflowError):
        prng.fold_in(prng.key(num), -1)


def test_prng_bits_and_uniform():
    jk, tk = jax.random.PRNGKey(9), prng.key(9)
    for shape in ((1,), (1001,), (7, 13)):
        assert_same(prng.random_bits(tk, shape, CPU).numpy().view(np.uint32),
                    jax.random.bits(jk, shape))
        assert_same(prng.uniform(tk, shape, CPU), jax.random.uniform(jk, shape))


_RANDINT_CASES = {
    "scalar-small": ((1000,), 0, 7),
    "scalar-large": ((4096,), 0, 10_000_000),
    "negative-low": ((333,), -50, 50),
    "full-int32": ((5, 9), -(2**31), 2**31 - 1),
    "span-1": ((64,), 3, 4),
    "max-below-min": ((64,), 9, 2),
    "per-element": ((333,), 0, "arange"),
    "per-element-2d": ((16, 24), 0, "rows"),
}


@pytest.mark.parametrize("case", sorted(_RANDINT_CASES))
def test_prng_randint(case):
    shape, lo, hi = _RANDINT_CASES[case]
    if hi == "arange":  # spans -3..329: span 1 where maxval <= 0
        hi = np.arange(-3, shape[0] - 3, dtype=np.int32)
    elif hi == "rows":  # one bound a row, broadcast along it
        hi = np.random.default_rng(13).integers(0, 40, (shape[0], 1)).astype(np.int32)
    jk, tk = jax.random.PRNGKey(21), prng.key(21)
    want = jax.random.randint(jk, shape, lo, jnp.asarray(hi))
    got = prng.randint(tk, shape, lo, torch.from_numpy(np.asarray(hi))
                       if isinstance(hi, np.ndarray) else hi, CPU)
    assert_same(got, want)


@pytest.mark.parametrize("weights", [None, (1.0, 2.0, 0.5), (0.2, 0.0, 5.0, 1.0)])
def test_prng_categorical(weights):
    n = 3 if weights is None else len(weights)
    w = np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32)
    with np.errstate(divide="ignore"):  # a zero weight: a -inf logit
        logits = np.log(w / w.sum()).astype(np.float32)
    jk, tk = jax.random.PRNGKey(5), prng.key(5)
    want = jax.random.categorical(jk, jnp.asarray(logits), shape=(20_000,))
    got = prng.categorical(tk, torch.from_numpy(logits), (20_000,))
    assert_same(got, want)
    assert_same(twalks._layer_logits(n, weights), jwalks._layer_logits(n, weights))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the literal numpy threefry
# ---------------------------------------------------------------------------


def test_threefry_bits_ref_against_numpy():
    key = prng.key(77)
    got = tref.threefry_bits_ref(key, 37, CPU).numpy().view(np.uint32)
    assert got.tolist() == [_np_bits(key, i) for i in range(37)]


def test_randint_ref_against_numpy():
    key = prng.key(78)
    k1, k2 = prng.split(key)
    hi = np.array([1, 2, 3, 70_000, 2**31 - 1, 0, -5, 65_536, 1000], np.int32)
    got = tref.randint_ref(k1, k2, 0, torch.from_numpy(hi), hi.size, CPU)
    assert got.numpy().tolist() == [
        int(_np_randint(key, i, 0, int(h))) for i, h in enumerate(hi)]


def test_csr_row_sample_ref_against_numpy(nets):
    _, tnet = nets["plain"]
    layer = tnet.layer("wk")
    key = prng.key(79)
    k1, k2 = prng.split(key)
    rows = torch.tensor([0, 5, 299, -1, 300, 2**31 - 1, 17, 17], dtype=torch.int32)
    sample, valid = tref.csr_row_sample_ref(layer.memb, None, rows, k1, k2)
    indptr, ids = layer.memb.indptr_host, layer.memb.indices.numpy()
    for i, r in enumerate(rows.tolist()):
        lo = int(indptr[min(max(r, 0), 300)])
        length = int(indptr[min(max(r + 1, 0), 300)]) - lo
        want = ids[lo + _np_randint(key, i, 0, max(length, 1))] if length > 0 else r
        assert (int(sample[i]), bool(valid[i])) == (int(want), length > 0)


# ---------------------------------------------------------------------------
# Row samples and walk steps against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("csr_name", ["memb", "members", "out"])
def test_csr_row_sample_parity(nets, csr_name):
    jnet, tnet = nets["plain"]
    layer = "er" if csr_name == "out" else "wk"
    jcsr = getattr(jnet.layer(layer), csr_name)
    tcsr = getattr(tnet.layer(layer), csr_name)
    rows = np.concatenate([_starts(14, 200, jcsr.n_rows), [-3, jcsr.n_rows, 0]])
    rows = rows.astype(np.int32)
    js, jv = jcsr_row_sample(jcsr, jnp.asarray(rows), jax.random.PRNGKey(15))
    ts, tv = tcsr_row_sample(tcsr, torch.from_numpy(rows), prng.key(15))
    assert_same(ts, js)
    assert_same(tv, jv)


def test_eff_row_sample_with_overlay(nets):
    jnet, tnet = nets["overlay"]
    jl, tl = jnet.layer("wk"), tnet.layer("wk")
    rows = np.arange(-2, 302, dtype=np.int32)
    js, jv = jov.eff_row_sample(jl.memb, jl.memb_ov, jnp.asarray(rows),
                                jax.random.PRNGKey(16))
    ts, tv = tov.eff_row_sample(tl.memb, tl.memb_ov, torch.from_numpy(rows),
                                prng.key(16))
    assert_same(ts, js)
    assert_same(tv, jv)
    # the plain row sample equals the rebuilt layer's, the overlay's contract
    rebuilt = port_network(jnet.with_layer("wk", jlayers.compact_layer(jl)))
    rs, rv = tcsr_row_sample(rebuilt.layer("wk").memb, torch.from_numpy(rows),
                             prng.key(16))
    assert_same(ts, rs)
    assert_same(tv, rv)


@pytest.mark.parametrize("variant", ["plain", "overlay"])
@pytest.mark.parametrize("layer", ["er", "wk", "hh"])
def test_sample_neighbor_parity(nets, variant, layer):
    jnet, tnet = nets[variant]
    u = _starts(17, 257)
    jv, jok = jnet.layer(layer).sample_neighbor(jnp.asarray(u), jax.random.PRNGKey(18))
    tv, tok = tnet.layer(layer).sample_neighbor(torch.from_numpy(u), prng.key(18))
    assert_same(tv, jv)
    assert_same(tok, jok)


# ---------------------------------------------------------------------------
# Walk fleets, neighborhood samples, requests
# ---------------------------------------------------------------------------

_FLEETS = {
    "all-layers-weighted-filtered": dict(walkers_per_start=3,
                                         layer_weights=[1.0, 2.0, 0.5], filtered=True),
    "all-layers-uniform": dict(walkers_per_start=1),
    "one-layer": dict(walkers_per_start=2, layer_names=["wk"]),
    "two-layers-filtered": dict(walkers_per_start=4, layer_names=["hh", "er"],
                                layer_weights=[3.0, 1.0], filtered=True),
}


@pytest.mark.parametrize("fleet", sorted(_FLEETS))
def test_random_walk_batch_parity(nets, fleet):
    kw = dict(_FLEETS[fleet])
    jnet, tnet = nets["overlay" if fleet == "one-layer" else "plain"]
    jf = tf = None
    if kw.pop("filtered", False):
        jf = japi.selectnodes(jnet, "income", ">", 40)
        tf = tapi.selectnodes(tnet, "income", ">", 40)
    starts = _starts(19, 40)
    want = jtrav.random_walk_batch(jnet, jnp.asarray(starts), 9,
                                   jax.random.PRNGKey(20), node_filter=jf, **kw)
    got = ttrav.random_walk_batch(tnet, starts, 9, prng.key(20), node_filter=tf, **kw)
    assert_same(got, want)
    # the first K starts' rows depend only on those starts
    head = ttrav.random_walk_batch(tnet, starts[:7], 9, prng.key(20),
                                   node_filter=tf, **kw)
    assert_same(head, got[: head.shape[0]])


def test_random_walk_and_ego_sample(nets):
    jnet, tnet = nets["plain"]
    starts = _starts(22, 30)
    assert_same(twalks.random_walk(tnet, starts, 6, prng.key(23)),
                jwalks.random_walk(jnet, jnp.asarray(starts), 6, jax.random.PRNGKey(23)))
    for k in (1, 2):
        tv, tm = twalks.ego_sample(tnet, starts[:10], 32, k=k)
        jv, jm = jwalks.ego_sample(jnet, jnp.asarray(starts[:10]), 32, k=k)
        assert_same(tv, jv)
        assert_same(tm, jm)
    with pytest.raises(ValueError, match="walkers_per_start"):
        ttrav.random_walk_batch(tnet, starts, 3, prng.key(1), walkers_per_start=0)


@pytest.mark.parametrize("method", ["walk", "alters"])
@pytest.mark.parametrize("layers", [None, ["wk"]])
def test_neighborhood_sample_parity(nets, method, layers):
    jnet, tnet = nets["plain"]
    seeds = _starts(24, 12)
    want = jwalks.neighborhood_sample(jnet, jnp.asarray(seeds), [4, 3],
                                      jax.random.PRNGKey(25), layer_names=layers,
                                      layer_weights=None if layers else [1.0, 1.0, 2.0],
                                      method=method, max_alters_per_hop=16)
    got = twalks.neighborhood_sample(tnet, seeds, [4, 3], prng.key(25),
                                     layer_names=layers,
                                     layer_weights=None if layers else [1.0, 1.0, 2.0],
                                     method=method, max_alters_per_hop=16)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert_same(g, w)
    with pytest.raises(ValueError, match="unknown method"):
        twalks.neighborhood_sample(tnet, seeds, [2], prng.key(1), method="bogus")


def test_walkbatch_request_and_api(nets):
    jnet, tnet = nets["plain"]
    spec = {"attr": "income", "op": "gt", "value": 40}
    req = {"kind": "walkbatch", "starts": [3, 9, 27], "steps": 5, "walkers": 2,
           "seed": 31, "layer_weights": [1.0, 2.0, 3.0], "filter": spec}
    assert treq.QueryRequest.from_dict(req).to_dict() == \
        jreq.QueryRequest.from_dict(req).to_dict()
    assert treq.QueryRequest.walkbatch([3], 5, seed=2).to_dict() == \
        jreq.QueryRequest.walkbatch([3], 5, seed=2).to_dict()
    got, want = treq.run_query(tnet, req), jreq.run_query(jnet, req)
    jreq.assert_results_equal(got, want)
    got = treq.run_queries(tnet, [req, dict(req, seed=32)])
    want = jreq.run_queries(jnet, [req, dict(req, seed=32)])
    for g, w in zip(got, want):
        jreq.assert_results_equal(g, w)
    assert tapi.walkbatch(tnet, [5, 6], 4, walkers=3, seed=7, layernames=["hh"]) == \
        japi.walkbatch(jnet, [5, 6], 4, walkers=3, seed=7, layernames=["hh"])
    with pytest.raises(ValueError, match="steps must be >= 0"):
        treq.run_query(tnet, {"kind": "walkbatch", "starts": [1], "steps": -1})


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------


def test_estimate_mean_degree(nets):
    jnet, tnet = nets["plain"]
    for layers in (None, ["wk"]):
        got = test_.estimate_mean_degree(tnet, 2000, prng.key(41), layers)
        want = jest.estimate_mean_degree(jnet, 2000, jax.random.PRNGKey(41), layers)
        assert got == pytest.approx(want, rel=1e-6)
    # the node sample itself is exact
    assert_same(prng.randint(prng.key(41), (2000,), 0, 300, CPU),
                jax.random.randint(jax.random.PRNGKey(41), (2000,), 0, 300))


def test_estimate_degree_distribution(nets):
    jnet, tnet = nets["plain"]
    got = test_.estimate_degree_distribution(tnet, 64, 12, prng.key(42))
    want = jest.estimate_degree_distribution(jnet, 64, 12, jax.random.PRNGKey(42))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_estimate_assortativity(nets):
    jnet, tnet = nets["plain"]
    got = test_.estimate_assortativity(tnet, "income", 64, 12, prng.key(43))
    want = jest.estimate_assortativity(jnet, "income", 64, 12, jax.random.PRNGKey(43))
    assert got == pytest.approx(want, rel=1e-6)


def test_estimate_component_mass(nets):
    jnet, tnet = nets["plain"]
    got = test_.estimate_component_mass(tnet, 32, 12, prng.key(44), n_probe=64)
    want = jest.estimate_component_mass(jnet, 32, 12, jax.random.PRNGKey(44), n_probe=64)
    assert got == pytest.approx(want, rel=1e-6)


def test_draws_run_on_the_given_device_only():
    """On the CPU the ops take the plain versions; nothing picks a route by
    catching a failure (a CUDA request without a card raises)."""
    bits = tops.threefry_bits(prng.key(1), 5, CPU)
    assert bits.device == CPU and bits.dtype == torch.int32
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tops.threefry_bits(prng.key(1), 5, torch.device("cuda"))
