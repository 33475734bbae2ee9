"""PyTorch port, the segmented union's routes on the CPU against the JAX
package: the count-only filtered degree, and the wide route for rows past
the in-block kernel's capacity (tiles, pairwise merges of their sorted
runs, one compaction) run through the plain versions of its three steps
with the tile width lowered to 64. Also ``addlayer(valued=True)``, where
the port departs from the reference on purpose.

Tolerance: none — int32 rows, masks and counts must be bit-identical.
The JAX union runs through its plain reference (``use_pallas=False``): its
Pallas kernel in interpret mode compares all pairs of a row. Inputs come
from ``np.random.default_rng`` with the seed named in each test.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import api as japi
from repro.core import dispatch as jdisp
from repro.core.csr import SENTINEL
from repro.kernels import ops as jops
from repro_torch.core import api as tapi
from repro_torch.core import dispatch as tdisp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.build import launch_counts

from _torch_parity import assert_same, port_layer, port_network

S = int(SENTINEL)
TILE = 64


def _rows(rng, B, K, ids: str):
    """Unsorted rows with SENTINEL holes; row 0 all-SENTINEL. ``dups``: ids
    in [0, K // 3), many repeats; ``negative``: ids in [-10^7, 10^7), few."""
    if ids == "dups":
        flat = rng.integers(0, max(K // 3, 2), (B, K))
    else:
        flat = rng.integers(-10**7, 10**7, (B, K))
    flat = flat.astype(np.int32)
    flat[rng.random((B, K)) < 0.3] = S
    flat[0] = S
    return flat


@pytest.mark.parametrize("ids", ["dups", "negative"])
@pytest.mark.parametrize("max_out", ["one", "below_tile", "above_width"])
@pytest.mark.parametrize("K", [65, 200, 1000])
def test_wide_route_matches_plain_and_jax(K, max_out, ids):
    rng = np.random.default_rng(3000 + K)  # seed 3000+K
    flat = _rows(rng, 6, K, ids)
    mo = {"one": 1, "below_tile": TILE - 24, "above_width": K + 7}[max_out]
    t = torch.from_numpy(flat)
    got_v, got_m = tops.segmented_union(t, mo, tile=TILE)
    want_v, want_m = tref.segmented_union_ref(t, mo)
    assert torch.equal(got_v, want_v) and torch.equal(got_m, want_m)
    jv, jm = jops.segmented_union(jnp.asarray(flat), mo, use_pallas=False)
    assert_same(got_v, jv)
    assert_same(got_m, jm)
    # count-only: the number of distinct ids, uncapped
    count = tops.segmented_union_count(t, tile=TILE)
    assert_same(count, np.asarray(jnp.sum(
        jops.segmented_union(jnp.asarray(flat), K, use_pallas=False)[1],
        axis=-1)).astype(np.int32))


@pytest.mark.parametrize("K", [65, 200, 1000])
def test_wide_route_steps_match_their_plain_composition(K):
    # each plain step against what it stands for: tile uniques are the
    # union of each tile, a merge level is a sort of each pair of runs,
    # and the compaction is the union of a sorted row
    rng = np.random.default_rng(3100 + K)  # seed 3100+K
    t = torch.from_numpy(_rows(rng, 5, K, "dups"))
    tiles = -(-K // TILE)
    runs = tref.union_tiles_ref(t, TILE, 16)
    assert runs.shape == (5, tiles * 16)
    for i in range(tiles):
        want, _ = tref.segmented_union_ref(t[:, i * TILE:(i + 1) * TILE], 16)
        assert torch.equal(runs[:, i * 16:(i + 1) * 16], want)
    merged = tref.union_merge_ref(runs, 16)
    for lo in range(0, tiles * 16, 32):
        assert torch.equal(merged[:, lo:lo + 32],
                           torch.sort(runs[:, lo:lo + 32], dim=-1).values)
    row = torch.sort(t, dim=-1).values
    assert torch.equal(tref.compact_sorted_ref(row, 40),
                       tref.segmented_union_ref(t, 40)[0])
    assert torch.equal(tref.compact_sorted_ref(row, None),
                       tref.segmented_union_count_ref(t))


def test_wide_route_counts_no_sort_rows_and_no_launch_on_the_cpu():
    rng = np.random.default_rng(3200)  # seed 3200
    t = torch.from_numpy(_rows(rng, 4, 300, "dups"))
    before = dict(launch_counts)
    tops.segmented_union(t, 50, tile=TILE)
    tops.segmented_union_count(t, tile=TILE)
    assert dict(launch_counts) == before  # no kernel launched on the CPU


def _two_mode(seed: int):
    """A seeded two-mode network: 300 nodes, 30 groups, one group of 120."""
    net = japi.createnetwork(japi.createnodeset(300))
    net = japi.generate(japi.addlayer(net, "wk", 2), "wk", type="2mode", h=30, a=4,
                        seed=seed)
    return net


@pytest.mark.parametrize("tile", ["capacity", "lowered"])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("seed", [3300, 3301])
def test_count_only_filtered_degree_matches_jax(monkeypatch, seed, filtered, tile):
    jnet = _two_mode(seed)  # seed 3300/3301
    jl = jnet.layer("wk")
    tl = port_layer("wk", jl)
    if tile == "lowered":
        monkeypatch.setattr(tdisp, "UNION_KERNEL_MAX_FLAT", TILE)
    rng = np.random.default_rng(seed + 100)  # seed 3400/3401
    u = rng.integers(0, 300, 120).astype(np.int32)
    # the reference takes a filter always: "no filter" is one that keeps all
    nf = rng.random(300) < 0.5 if filtered else np.ones(300, bool)
    got = tdisp.bucketed_filtered_degree(tl, torch.from_numpy(u), nf)
    assert_same(got, jdisp.bucketed_filtered_degree(jl, jnp.asarray(u), nf))
    assert_same(got, jl.filtered_degree(jnp.asarray(u), jnp.asarray(nf)))
    assert_same(tl.filtered_degree(torch.from_numpy(u), torch.from_numpy(nf)), got)


@pytest.mark.parametrize("max_alters", [5, 40, 300])
def test_wide_route_merges_one_mode_parts_with_filter_holes(monkeypatch, max_alters):
    # node_alters across one-mode and two-mode layers: the one-mode parts
    # carry SENTINEL holes where the filter drops a neighbour; with the tile
    # at 64 every cross-layer merge row is wide
    net = japi.createnetwork(japi.createnodeset(300))
    net = japi.generate(japi.addlayer(net, "er", 1), "er", type="er", p=0.05, seed=3500)
    net = japi.generate(japi.addlayer(net, "wk", 2), "wk", type="2mode", h=20, a=3,
                        seed=3501)
    income = np.random.default_rng(3502).integers(0, 100, 300)  # seed 3502
    jnet = japi.setnodeattr(net, "income", np.arange(300), income, kind="int")
    tnet = port_network(jnet)
    monkeypatch.setattr(tdisp, "UNION_KERNEL_MAX_FLAT", TILE)
    u = np.random.default_rng(3503).integers(0, 300, 50).astype(np.int32)
    jf = japi.selectnodes(jnet, "income", ">", 40)
    tf = tapi.selectnodes(tnet, "income", ">", 40)
    before = launch_counts["segmented_union_sort_rows"]
    tv, tm = tapi.getnodealters(tnet, u, max_alters=max_alters, filter=tf)
    jv, jm = japi.getnodealters(jnet, u, max_alters=max_alters, filter=jf)
    assert_same(tv, jv)
    assert_same(tm, jm)
    assert launch_counts["segmented_union_sort_rows"] == before


def test_addlayer_valued_builds_a_valued_layer():
    tnet = tapi.addlayer(tapi.createnetwork(tapi.createnodeset(10, device="cpu")),
                         "L", 1, valued=True)
    assert tnet.layer("L").valued
    assert not tapi.addlayer(tnet, "M", 1).layer("M").valued
    # the reference drops `valued` (ROADMAP Queue 3 fault 4): recorded here
    jnet = japi.addlayer(japi.createnetwork(japi.createnodeset(10)), "L", 1,
                         valued=True)
    assert jnet.layer("L").valued is False
