"""PyTorch port on the card: the CUDA kernels against their plain torch
versions, and the point-query and traversal api and the LM model on CUDA
against the same calls on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance of the graph kernels and api: none — int32 and float32 outputs
must be bit-identical. The LM kernels (rmsnorm, flash attention, SSD
scan) are float and sum in another order than their plain versions; each
test states its tolerance and why. The RG-LRU scan rounds as its plain
loop does and must be bit-identical. Inputs come from
``np.random.default_rng`` with the seed named in each test.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core.csr import SENTINEL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.flash_attention import uses_wgmma
from repro_torch.kernels.frontier import MAX_CAND
from repro_torch.kernels.segmented_union import MAX_FLAT
from repro_torch.kernels.ssd_scan import kernel_chunk, tma_ready, uses_tensor_cores

from _torch_parity import assert_network_identical

S = int(SENTINEL)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _sorted_rows(rng, B, K, universe):
    """Sorted unique rows, SENTINEL-padded; every 5th row all-SENTINEL."""
    rows = np.full((B, K), S, dtype=np.int32)
    for i in range(B):
        if i % 5 == 4:
            continue
        n = int(rng.integers(0, K + 1))
        rows[i, :n] = np.sort(rng.choice(universe, size=n, replace=False))
    return torch.from_numpy(rows)


def _flat_rows(rng, B, K, universe):
    """Unsorted rows with duplicates and SENTINEL holes; row 0 all-SENTINEL."""
    flat = rng.integers(0, universe, (B, K)).astype(np.int32)
    flat[rng.random((B, K)) < 0.3] = S
    flat[0] = S
    return torch.from_numpy(flat)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 32, 128, 300])
def test_intersect_kernel_matches_plain(cuda_device, K):
    rng = np.random.default_rng(400 + K)  # seed 400+K
    a = _sorted_rows(rng, 1000, K, universe=2000)
    b = _sorted_rows(rng, 1000, K + 3, universe=2000)
    before = launch_counts["intersect_count"]
    got = ops.intersect_count(a.to(cuda_device), b.to(cuda_device))
    assert launch_counts["intersect_count"] == before + 1
    torch.testing.assert_close(got.cpu(), ref.intersect_count_ref(a, b),
                               rtol=0, atol=0)


def _full_rows(rng, B, K, universe):
    """Sorted unique rows with no pad."""
    return torch.from_numpy(np.sort(np.stack(
        [rng.choice(universe, size=K, replace=False) for _ in range(B)]),
        axis=1).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("ka,kb,rows", [
    (1, 1, 8192), (4, 4, 8192), (6, 6, 8191), (7, 5, 129), (32, 32, 1000),
    (32, 33, 8192), (33, 7, 257), (512, 512, 300), (0, 6, 64), (6, 0, 64),
])
def test_intersect_count_routes_exact(cuda_device, ka, kb, rows):
    """Both routes of the padded-row kernel (rows of at most 32 entries a
    group of lanes a pair, wider a warp a pair) at and across the 32-entry
    edge: rows of all pads (every 5th), rows with no pad (the last 64 rows
    of a and b, from a small universe, so they share entries), Ka != Kb,
    and row counts that are not a multiple of a block's rows. The kernel
    and the plain version of its narrow plan are exact. Seed 29."""
    rng = np.random.default_rng(29)
    universe = max(2 * max(ka, kb), 4)
    a = _sorted_rows(rng, rows, ka, universe)
    b = _sorted_rows(rng, rows, kb, universe)
    tail = min(64, rows)
    if ka and kb:
        a[-tail:] = _full_rows(rng, tail, ka, universe)
        b[-tail:] = _full_rows(rng, tail, kb, universe)
    got = ops.intersect_count(a.to(cuda_device), b.to(cuda_device)).cpu()
    want = ref.intersect_count_ref(a, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(ref.intersect_count_lanes(a, b), want, rtol=0, atol=0)


# The CSR route's staging budget: the two rows of a pair with at most this
# many entries together are merged by one lane, longer ones by the warp; a
# warp stages at most ROWS_WARP_BUF entries at a time.
ROWS_BUDGET = 128
ROWS_WARP_BUF = 1280


def _rows_csr(rng, lengths, universe, ids_dtype, indptr_dtype, device):
    """A membership CSR whose row i holds lengths[i] sorted unique ids of
    ``universe``, stored in the given dtypes on ``device``."""
    from repro_torch.core.csr import csr_from_arrays

    lengths = np.asarray(lengths)
    indptr = np.zeros(lengths.size + 1, indptr_dtype)
    indptr[1:] = np.cumsum(lengths)
    ids = np.concatenate([np.sort(rng.choice(universe, n, replace=False))
                          for n in lengths] + [np.zeros(0, np.int64)])
    return csr_from_arrays(indptr, ids.astype(ids_dtype), None, lengths.size,
                           int(universe.max()) + 1, device)


def _rows_layer(seed, ids_dtype, indptr_dtype, overlay, device):
    """(base CSR, overlay or None) on ``device``: 600 rows of 0-40 ids, rows
    100-105 of 63-65 (the budget's edge: pairs of 127, 128 and 129
    entries), rows 110-141 of 60-64, rows 200-219 of 100-2,000 and rows
    220-224 of 1,281-3,000 (past a warp's shared buffer); ids above 2^15
    (uint16) or 2^16 (int32). The
    overlay dirties 120 rows and 10 rows past the base; its delta holds
    int32 ids and the other indptr dtype."""
    from repro_torch.core.overlay import DeltaOverlay

    rng = np.random.default_rng(seed)
    top = 60_000 if ids_dtype == np.uint16 else 1 << 20
    universe = np.arange(top - 6_000, top)
    lengths = rng.integers(0, 41, 600)
    b = ROWS_BUDGET // 2
    lengths[100:106] = [b - 1, b, b + 1, b - 1, b, b + 1]
    lengths[110:142] = rng.integers(b - 4, b + 1, 32)
    lengths[200:220] = rng.integers(100, 2001, 20)
    lengths[220:225] = [ROWS_WARP_BUF + 1, 2500, 3000, 2200, 2999]
    base = _rows_csr(rng, lengths, universe, ids_dtype, indptr_dtype, device)
    if not overlay:
        return base, None
    dirty = np.zeros(610, bool)
    dirty[rng.choice(600, 120, replace=False)] = True
    dirty[600:] = True
    dlen = np.where(dirty, rng.choice([0, 3, 32, 33, 150, 2500], 610), 0)
    delta = _rows_csr(rng, dlen, universe, np.int32,
                      np.int64 if indptr_dtype == np.int32 else np.int32, device)
    return base, DeltaOverlay(delta=delta, dirty=torch.from_numpy(dirty).to(device),
                              base_shadowed=0, dirty_host=dirty)


def _rows_pairs(seed, B):
    """B pairs over ids -3 .. 615: every warp of 32 mixes rows the lanes
    merge and hub rows the warp searches; the first 12 pairs take the
    budget's edge (63+64, 64+64, 64+65 entries and their mirror images),
    pairs 32-63 rows of 60-64 each (their 32 pairs pass a warp's buffer, so
    the warp stages them in rounds), the last five u = v."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-3, 616, B)
    v = rng.integers(-3, 616, B)
    hubs = np.arange(0, B, 7)
    v[hubs] = rng.integers(200, 225, hubs.size)
    wide = np.arange(32, min(B, 64))
    u[wide] = rng.integers(110, 142, wide.size)
    v[wide] = rng.integers(110, 142, wide.size)
    edge = [(100, 101), (101, 104), (101, 102), (102, 104), (103, 105), (105, 100)]
    for i, (a, b) in enumerate(edge[:B // 2]):
        u[2 * i], v[2 * i] = a, b
        u[2 * i + 1], v[2 * i + 1] = b, a
    u[-5:] = v[-5:]
    return u.astype(np.int32), v.astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 1000])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ids_dtype", [np.uint16, np.int32])
def test_intersect_rows_kernel_matches_plain(cuda_device, ids_dtype, indptr_dtype,
                                             overlay, filtered, B):
    from repro_torch.core.dispatch import DEFAULT_BUCKET_WIDTHS

    layer = _rows_layer(700, ids_dtype, indptr_dtype, overlay, cuda_device)  # seed 700
    u, v = _rows_pairs(701 + B, B)  # seed 701+B
    nf = np.random.default_rng(702).random(590) < 0.7 if filtered else None  # seed 702
    args = [torch.from_numpy(x).to(cuda_device) if x is not None else None
            for x in (u, v, nf)]
    # the plain version, the degree-bucketed route, on the same tensors
    want = ref.intersect_rows_ref(*layer, *args, DEFAULT_BUCKET_WIDTHS).cpu()
    before = dict(launch_counts)
    got = ops.intersect_rows(*layer, *args, widths=DEFAULT_BUCKET_WIDTHS)
    torch.cuda.synchronize()
    assert launch_counts["intersect_rows"] == before.get("intersect_rows", 0) + 1
    assert launch_counts["intersect_count"] == before.get("intersect_count", 0)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    if B == 1000:
        assert int((want > 0).sum()) > 100 and int(want.max()) > 40


@pytest.mark.cuda
def test_intersect_rows_wrapper_refuses_bad_operands(cuda_device):
    from repro_torch.kernels.intersect import intersect_rows_cuda

    base, _ = _rows_layer(703, np.int32, np.int32, False, cuda_device)  # seed 703
    ids = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        intersect_rows_cuda(base.indptr, base.indices, ids.long(), ids)
    with pytest.raises(ValueError):
        intersect_rows_cuda(base.indptr, base.indices, ids, ids[:4])
    with pytest.raises(ValueError):
        intersect_rows_cuda(base.indptr, base.indices, ids.cpu(), ids.cpu())
    with pytest.raises(TypeError):
        intersect_rows_cuda(base.indptr.short(), base.indices, ids, ids)
    with pytest.raises(ValueError):
        intersect_rows_cuda(base.indptr, base.indices, ids, ids,
                            node_filter=torch.zeros(0, dtype=torch.bool,
                                                    device=cuda_device))
    with pytest.raises(ValueError):
        intersect_rows_cuda(base.indptr, base.indices, ids, ids,
                            overlay=(torch.ones(3, dtype=torch.bool), base.indptr,
                                     base.indices))


@pytest.mark.cuda
def test_edge_queries_launch_the_csr_route_once_a_layer(cuda_device):
    net = _network(None)
    u, v = np.random.default_rng(704).integers(0, 2000, (2, 300))  # seed 704
    sel = api.selectnodes(net, "income", ">", 50)
    before = dict(launch_counts)
    for filt in (None, sel):
        api.getedge(net, "wk", u, v, filter=filt)
        api.checkedge(net, "sc", u, v, filter=filt)
    assert launch_counts["intersect_rows"] == before.get("intersect_rows", 0) + 4
    assert launch_counts["intersect_count"] == before.get("intersect_count", 0)


def _union_rows(rng, B, K, dups):
    """Unsorted rows with SENTINEL holes, row 0 all-SENTINEL: ``dups`` ids in
    [0, K // 2), many repeats; else signed ids in [-2^30, 2^30), almost
    none."""
    if dups:
        flat = rng.integers(0, max(K // 2, 2), (B, K))
    else:
        flat = rng.integers(-(2**30), 2**30, (B, K))
    flat = flat.astype(np.int32)
    flat[rng.random((B, K)) < 0.3] = S
    flat[0] = S
    return torch.from_numpy(flat)


_WIDE_STEPS = ("segmented_union_wide", "union_merge", "union_compact")


def _launched(keys, before):
    return all(launch_counts[k] > before.get(k, 0) for k in keys)


@pytest.mark.cuda
@pytest.mark.parametrize("dups", [True, False])
@pytest.mark.parametrize("K", [1, 8, 31, 33, 224, 225, 993, 4096, 15872, 15873,
                               MAX_FLAT - 1, MAX_FLAT, MAX_FLAT + 1, 40000, 200003])
def test_segmented_union_kernel_matches_plain(cuda_device, K, dups):
    rng = np.random.default_rng(500 + K + dups)  # seed 500+K+dups
    flat = _union_rows(rng, 40 if K < 100000 else 12, K, dups)
    uniq = int(ref.segmented_union_count_ref(flat).max())
    wide = K > MAX_FLAT
    rows_keys = _WIDE_STEPS if wide else ("segmented_union",)
    count_keys = _WIDE_STEPS if wide else ("segmented_union_count",)
    for max_out in (1, max(uniq, 1), K + 7):
        before = dict(launch_counts)
        gv, gm = ops.segmented_union(flat.to(cuda_device), max_out)
        assert _launched(rows_keys, before)
        wv, wm = ref.segmented_union_ref(flat, max_out)
        torch.testing.assert_close(gv.cpu(), wv, rtol=0, atol=0)
        assert torch.equal(gm.cpu(), wm)
    before = dict(launch_counts)
    got = ops.segmented_union_count(flat.to(cuda_device))
    assert _launched(count_keys, before)
    assert torch.equal(got.cpu(), ref.segmented_union_count_ref(flat))


@pytest.mark.cuda
@pytest.mark.parametrize("K,tile", [(65, 64), (5001, 64), (5001, 1000),
                                    (60000, 64), (60000, 1000), (60000, 5000)])
def test_wide_route_with_narrow_tiles_matches_plain(cuda_device, K, tile):
    # many tiles a row: deep merge levels, runs shorter and longer than a
    # merge block's 2,048 outputs, a lone last run at odd tile counts
    rng = np.random.default_rng(800 + K + tile)  # seed 800+K+tile
    flat = _union_rows(rng, 9, K, K < 10000)
    for max_out in (1, 100, K + 7):
        before = dict(launch_counts)
        gv, _ = ops.segmented_union(flat.to(cuda_device), max_out, tile=tile)
        assert _launched(_WIDE_STEPS, before)
        torch.testing.assert_close(gv.cpu(), ref.segmented_union_ref(flat, max_out)[0],
                                   rtol=0, atol=0)
    got = ops.segmented_union_count(flat.to(cuda_device), tile=tile)
    assert torch.equal(got.cpu(), ref.segmented_union_count_ref(flat))


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [1, 32, 33, 300, 4096, MAX_CAND - 1, MAX_CAND])
@pytest.mark.parametrize("Kv", [1, 257, 8193, 40000])
def test_frontier_kernel_matches_plain(cuda_device, Kc, Kv):
    # Kv 40,000 is wider than any rung's visited tile in shared memory
    rng = np.random.default_rng(700 + Kc + Kv)  # seed 700+Kc+Kv
    universe = max(Kc // 2, 2)
    cand = _flat_rows(rng, 24, Kc, universe)
    visited = _flat_rows(rng, 24, Kv, universe)
    for max_out in (1, 256, Kc + 7):
        before = launch_counts["frontier_compact"]
        gv, gm = ops.frontier_compact(cand.to(cuda_device), visited.to(cuda_device),
                                      max_out)
        assert launch_counts["frontier_compact"] == before + 1
        # the binary-search plain version (frontier_ref's all-pairs form
        # would hold 24 x Kc x Kv booleans); the CPU tests hold the two equal
        wv, wm = ref.frontier_search_ref(cand, torch.sort(visited).values, max_out)
        torch.testing.assert_close(gv.cpu(), wv, rtol=0, atol=0)
        assert torch.equal(gm.cpu(), wm)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels.frontier import frontier_compact_cuda
    from repro_torch.kernels.intersect import intersect_count_cuda
    from repro_torch.kernels.segmented_union import segmented_union_cuda

    x = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        intersect_count_cuda(x.long(), x)
    with pytest.raises(ValueError):
        intersect_count_cuda(x[:, ::2], x[:, ::2])
    with pytest.raises(ValueError):
        segmented_union_cuda(
            torch.zeros((2, MAX_FLAT + 1), dtype=torch.int32, device=cuda_device), 4
        )
    with pytest.raises(TypeError):
        frontier_compact_cuda(x.long(), x, 4)
    with pytest.raises(ValueError):
        frontier_compact_cuda(x[:, ::2], x, 4)
    with pytest.raises(ValueError):
        frontier_compact_cuda(
            torch.zeros((4, MAX_CAND + 1), dtype=torch.int32, device=cuda_device),
            x, 4,
        )


def _network(device, seed=600):
    """A small mixed-mode network (seed 600) built on ``device``."""
    net = api.createnetwork(api.createnodeset(2000, device=device))
    net = api.generate(api.addlayer(net, "er", 1), "er", type="er", p=0.004, seed=seed)
    net = api.generate(api.addlayer(net, "wk", 2), "wk", type="2mode", h=40, a=3,
                       seed=seed + 1)
    net = api.generate(api.addlayer(net, "sc", 2), "sc", type="2mode", h=3, a=2,
                       seed=seed + 2)
    income = np.random.default_rng(seed + 3).integers(0, 100, 2000)
    return api.setnodeattr(net, "income", np.arange(2000), income, kind="int")


@pytest.mark.cuda
def test_api_on_cuda_matches_cpu(cuda_device):
    cpu, gpu = _network("cpu"), _network(None)
    assert gpu.device.type == "cuda"
    rng = np.random.default_rng(601)  # seed 601
    u, v = rng.integers(0, 2000, 300), rng.integers(0, 2000, 300)
    for filtered in (False, True):
        fc = api.selectnodes(cpu, "income", ">", 50) if filtered else None
        fg = api.selectnodes(gpu, "income", ">", 50) if filtered else None
        for name in ("er", "wk", "sc"):
            assert torch.equal(api.getedge(cpu, name, u, v, filter=fc),
                               api.getedge(gpu, name, u, v, filter=fg))
            assert torch.equal(api.checkedge(cpu, name, u, v, filter=fc),
                               api.checkedge(gpu, name, u, v, filter=fg).cpu())
        for max_alters in (5, 4096):
            ac = api.getnodealters(cpu, u[:80], max_alters=max_alters, filter=fc)
            ag = api.getnodealters(gpu, u[:80], max_alters=max_alters, filter=fg)
            assert torch.equal(ac[0], ag[0]) and torch.equal(ac[1], ag[1])
        np.testing.assert_array_equal(api.getdegree(cpu, u, filter=fc),
                                      api.getdegree(gpu, u, filter=fg))


@pytest.mark.cuda
def test_traversal_api_on_cuda_matches_cpu(cuda_device):
    cpu, gpu = _network("cpu"), _network(None)
    src = np.random.default_rng(602).integers(0, 2000, 64)  # seed 602
    before = launch_counts["frontier_compact"]
    for filtered in (False, True):
        fc = api.selectnodes(cpu, "income", ">", 50) if filtered else None
        fg = api.selectnodes(gpu, "income", ">", 50) if filtered else None
        for layers in (None, ["wk"], ["er"]):
            assert api.khop(cpu, src, 2, layernames=layers, max_frontier=64,
                            filter=fc) == \
                api.khop(gpu, src, 2, layernames=layers, max_frontier=64, filter=fg)
        assert api.egosample(cpu, src[:16], max_alters=128, k=2, filter=fc) == \
            api.egosample(gpu, src[:16], max_alters=128, k=2, filter=fg)
        assert api.countcomponents(cpu, filter=fc) == \
            api.countcomponents(gpu, filter=fg)
    assert launch_counts["frontier_compact"] > before


# ---------------------------------------------------------------------------
# Threefry draws (csrc/threefry.cu): bit-identical to the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 1001, (1 << 20) + 3])
@pytest.mark.parametrize("key", [(0, 0), (0, 7), (3625411723, 1954958720)])
def test_threefry_bits_kernel_matches_plain(cuda_device, n, key):
    before = launch_counts["threefry_bits"]
    got = ops.threefry_bits(key, n, cuda_device)
    assert launch_counts["threefry_bits"] == before + 1
    assert torch.equal(got.cpu(), ref.threefry_bits_ref(key, n, torch.device("cpu")))


_RANDINT_BOUNDS = {
    "scalar": (0, 7),
    "scalar-2^16+1": (0, 65537),
    "large": (0, 10_000_000),
    "negative": (-50, 50),
    "full-int32": (-(2**31), 2**31 - 1),
    "span-1": (3, 4),
    "max-below-min": (9, 2),
    "per-element": (0, "spans"),
    "per-element-both": ("lows", "spans"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 333, 100_001])
@pytest.mark.parametrize("case", sorted(_RANDINT_BOUNDS))
def test_randint_kernel_matches_plain(cuda_device, case, n):
    from repro_torch.core import prng

    rng = np.random.default_rng(610)  # seed 610
    bounds = []
    for b in _RANDINT_BOUNDS[case]:
        if b == "spans":  # spans -2 .. 70,000: span 1 where hi <= lo
            b = torch.from_numpy(rng.integers(-2, 70_000, n).astype(np.int32))
        elif b == "lows":
            b = torch.from_numpy(rng.integers(-5, 5, n).astype(np.int32))
        bounds.append(b)
    k1, k2 = prng.split(prng.key(611))
    lo, hi = (b.to(cuda_device) if isinstance(b, torch.Tensor) else b for b in bounds)
    before = launch_counts["randint"]
    got = ops.randint(k1, k2, lo, hi, n, cuda_device)
    assert launch_counts["randint"] == before + 1
    want = ref.randint_ref(k1, k2, *bounds, n, torch.device("cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 2, 3, 5, 4 * 2501 + 1, 65_537, 1_638_402])
def test_threefry_bits_kernel_vector_tail(cuda_device, n):
    """Counts that end in a partial group of the kernel's four elements a
    thread (its scalar tail), none (no launch), small grids of narrowed
    blocks, and more than one resident wave (the grid-stride loop):
    bit-identical to the plain version."""
    key = (2718281828, 3141592653)
    before = launch_counts["threefry_bits"]
    got = ops.threefry_bits(key, n, cuda_device)
    assert launch_counts["threefry_bits"] == before + (n > 0)
    assert torch.equal(got.cpu(), ref.threefry_bits_ref(key, n, torch.device("cpu")))


_SCALAR_BOUNDS = sorted(k for k, b in _RANDINT_BOUNDS.items()
                        if all(isinstance(x, int) for x in b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4 * 2501 + 1, (1 << 20) + 3])
@pytest.mark.parametrize("case", _SCALAR_BOUNDS)
def test_randint_kernel_scalar_plans(cuda_device, case, n):
    """Scalar bounds, whose span, multiplier and reciprocal the host
    computes once (two hashes a draw, one where the multiplier is 0, span
    1 among them), at a ragged count and past one resident wave:
    bit-identical to the plain version."""
    from repro_torch.core import prng

    lo, hi = _RANDINT_BOUNDS[case]
    k1, k2 = prng.split(prng.key(619))
    before = launch_counts["randint"]
    got = ops.randint(k1, k2, lo, hi, n, cuda_device)
    assert launch_counts["randint"] == before + 1
    assert torch.equal(got.cpu(), ref.randint_ref(k1, k2, lo, hi, n, torch.device("cpu")))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 4 * 2501 + 3])
def test_randint_kernel_unaligned_bounds(cuda_device, n):
    """Per-element bounds that start 4 bytes past a 16-byte boundary (the
    kernel's element-wise loads) at ragged counts: bit-identical."""
    from repro_torch.core import prng

    rng = np.random.default_rng(620)  # seed 620
    lo = torch.from_numpy(rng.integers(-5, 5, n + 1).astype(np.int32))
    hi = torch.from_numpy(rng.integers(-2, 70_000, n + 1).astype(np.int32))
    k1, k2 = prng.split(prng.key(621))
    lo_d, hi_d = lo.to(cuda_device)[1:], hi.to(cuda_device)[1:]
    assert lo_d.data_ptr() % 16 == 4
    got = ops.randint(k1, k2, lo_d, hi_d, n, cuda_device)
    want = ref.randint_ref(k1, k2, lo[1:], hi[1:], n, torch.device("cpu"))
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1_000, 409_600])
def test_csr_row_sample_kernel_after_hash_change(cuda_device, n_rows):
    """409,600 rows (the sampling phase's heaviest launch) and 1,000 (a
    grid of narrowed blocks) of a layer with rows of 65,536 and 70,000 ids
    (the multiplier is 0 past 2^16) beside short and empty ones: the row
    sample, which shares the hash, the reduction and the grid with the
    draw kernels, stays bit-identical to its plain version."""
    from repro_torch.core import prng
    from repro_torch.core.csr import csr_from_arrays

    rng = np.random.default_rng(622)  # seed 622
    lengths = rng.integers(0, 13, 4000)
    lengths[[7, 31]] = [65_536, 70_000]
    indptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    ids = rng.integers(0, 1 << 20, int(indptr[-1])).astype(np.int32)
    rows = rng.integers(-3, 4003, n_rows).astype(np.int32)
    rows[:2] = [7, 31]
    k1, k2 = prng.split(prng.key(623))
    base = csr_from_arrays(indptr, ids, None, 4000, 1 << 20, cuda_device)
    cbase = csr_from_arrays(indptr, ids, None, 4000, 1 << 20, torch.device("cpu"))
    got, ok = ops.csr_row_sample(base, None, torch.from_numpy(rows).to(cuda_device), k1, k2)
    want, wok = ref.csr_row_sample_ref(cbase, None, torch.from_numpy(rows), k1, k2)
    assert torch.equal(got.cpu(), want) and torch.equal(ok.cpu(), wok)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 33, 1000])
@pytest.mark.parametrize("overlay", [False, True])
@pytest.mark.parametrize("indptr_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ids_dtype", [np.uint16, np.int32])
def test_csr_row_sample_kernel_matches_plain(cuda_device, ids_dtype, indptr_dtype,
                                             overlay, B):
    """Rows of 0-3,000 ids (empty rows among them), ids -3 .. 615 (past
    both ends), uint16 or int32 ids over int32 or int64 indptr, with and
    without a delta overlay (int32 ids, the other indptr dtype)."""
    from repro_torch.core import prng

    cpu = torch.device("cpu")
    base, ov = _rows_layer(612, ids_dtype, indptr_dtype, overlay, cuda_device)
    cbase, cov = _rows_layer(612, ids_dtype, indptr_dtype, overlay, cpu)
    rows = np.random.default_rng(613).integers(-3, 616, B).astype(np.int32)
    k1, k2 = prng.split(prng.key(614))
    before = launch_counts["csr_row_sample"]
    got, ok = ops.csr_row_sample(base, ov, torch.from_numpy(rows).to(cuda_device), k1, k2)
    assert launch_counts["csr_row_sample"] == before + 1
    want, wok = ref.csr_row_sample_ref(cbase, cov, torch.from_numpy(rows), k1, k2)
    assert torch.equal(got.cpu(), want) and torch.equal(ok.cpu(), wok)


def _sample_block() -> int:
    """Threads (rows) of csr_row_sample_kernel's widest block (the draw
    kernels' grid), read from csrc/threefry.cu."""
    text = (Path(ops.__file__).parents[1] / "csrc" / "threefry.cu").read_text()
    return int(re.search(r"constexpr int kDrawThreads = (\d+);", text)[1])


_SAMPLE_BLOCK = _sample_block()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, _SAMPLE_BLOCK - 1, _SAMPLE_BLOCK, _SAMPLE_BLOCK + 1,
                               262_144])
@pytest.mark.parametrize("overlay", [False, True])
def test_csr_row_sample_kernel_at_block_edges(cuda_device, overlay, n):
    """One row, one block of the kernel's rows less one, one block, one
    more, and the walk fleet's 262,144 rows: bit-identical to the plain
    version, with and without a delta overlay."""
    from repro_torch.core import prng

    cpu = torch.device("cpu")
    base, ov = _rows_layer(616, np.int32, np.int32, overlay, cuda_device)
    cbase, cov = _rows_layer(616, np.int32, np.int32, overlay, cpu)
    rows = np.random.default_rng(617 + n).integers(-3, 616, n).astype(np.int32)
    k1, k2 = prng.split(prng.key(618))
    before = launch_counts["csr_row_sample"]
    got, ok = ops.csr_row_sample(base, ov, torch.from_numpy(rows).to(cuda_device), k1, k2)
    assert launch_counts["csr_row_sample"] == before + 1
    want, wok = ref.csr_row_sample_ref(cbase, cov, torch.from_numpy(rows), k1, k2)
    assert torch.equal(got.cpu(), want) and torch.equal(ok.cpu(), wok)


@pytest.mark.cuda
def test_threefry_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels.threefry import (
        csr_row_sample_cuda, randint_cuda, threefry_bits_cuda,
    )

    base, _ = _rows_layer(615, np.int32, np.int32, False, cuda_device)
    rows = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        threefry_bits_cuda((0, 1), 4, torch.device("cpu"))
    with pytest.raises(ValueError):
        randint_cuda((0, 1), (2, 3), 0, rows[:4], 8, cuda_device)
    with pytest.raises(TypeError):
        randint_cuda((0, 1), (2, 3), 0, rows.long(), 8, cuda_device)
    with pytest.raises(TypeError):
        csr_row_sample_cuda(base.indptr, base.indices, rows.long(), (0, 1), (2, 3))
    with pytest.raises(TypeError):
        csr_row_sample_cuda(base.indptr.float(), base.indices, rows, (0, 1), (2, 3))
    with pytest.raises(ValueError):
        csr_row_sample_cuda(base.indptr, base.indices, rows.cpu(), (0, 1), (2, 3))


@pytest.mark.cuda
def test_sampling_and_analysis_api_on_cuda_matches_cpu(cuda_device):
    """Walk fleets, neighborhood samples, estimators, BFS and processing on
    the card against the same calls on the CPU: integer results equal (the
    layer choice's log on the card may differ from the CPU's by an ulp, so
    a tie could flip; none is expected at this size), floats within rel
    1e-6."""
    from repro_torch.core import analysis, estimators, prng, processing, walks

    cpu, gpu = _network("cpu"), _network(None)
    src = np.random.default_rng(616).integers(0, 2000, 128)  # seed 616
    before = dict(launch_counts)
    for layers, weights in ((None, [1.0, 2.0, 0.5]), (["wk"], None)):
        fc = api.selectnodes(cpu, "income", ">", 50)
        fg = api.selectnodes(gpu, "income", ">", 50)
        assert api.walkbatch(cpu, src, 12, walkers=3, seed=5, layernames=layers,
                             layer_weights=weights, filter=fc) == \
            api.walkbatch(gpu, src, 12, walkers=3, seed=5, layernames=layers,
                          layer_weights=weights, filter=fg)
    for method in ("walk", "alters"):
        hc = walks.neighborhood_sample(cpu, src[:32], [5, 3], prng.key(7), method=method)
        hg = walks.neighborhood_sample(gpu, src[:32], [5, 3], prng.key(7), method=method)
        assert all(torch.equal(a, b.cpu()) for a, b in zip(hc, hg))
    assert estimators.estimate_mean_degree(cpu, 5000, prng.key(8)) == pytest.approx(
        estimators.estimate_mean_degree(gpu, 5000, prng.key(8)), rel=1e-6)
    np.testing.assert_allclose(
        estimators.estimate_degree_distribution(gpu, 128, 16, prng.key(9)),
        estimators.estimate_degree_distribution(cpu, 128, 16, prng.key(9)), rtol=1e-6)
    for s in src[:4].tolist():
        assert torch.equal(analysis.bfs_distances(cpu, s),
                           analysis.bfs_distances(gpu, s).cpu())
        assert api.shortestpath(cpu, s, int(src[-1])) == \
            api.shortestpath(gpu, s, int(src[-1]))
    assert api.degreedist(cpu) == api.degreedist(gpu)
    sym_c = processing.symmetrize(cpu.layer("er"), "max")
    sym_g = processing.symmetrize(gpu.layer("er"), "max")
    assert torch.equal(sym_c.out.indices, sym_g.out.indices.cpu())
    for key in ("threefry_bits", "randint", "csr_row_sample", "segmented_union"):
        assert launch_counts[key] > before.get(key, 0), key


# ---------------------------------------------------------------------------
# LM kernels
# ---------------------------------------------------------------------------

# bf16 has 8 significant bits: the kernels round once where the plain
# versions round the f32 result too (rmsnorm_ref rounds three times), so
# results may differ by a unit or two in the last place, 2^-7 relative.
BF16_TOL = 2.0**-6


def _randn(rng, shape, dtype, device, scale=1.0):
    return (torch.from_numpy(rng.normal(size=shape).astype(np.float32)) * scale
            ).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 128), (1000, 2048), (333, 768),
                                    (64, 1536), (4097, 128), (5, 96), (3, 7)])
def test_rmsnorm_kernel_matches_plain(cuda_device, rows, d, dtype):
    rng = np.random.default_rng(800 + d)  # seed 800+d
    x = _randn(rng, (rows, d), dtype, cuda_device, 3.0)
    w = _randn(rng, (d,), torch.float32, cuda_device, 0.1)
    before = launch_counts["rmsnorm"]
    got = ops.rmsnorm(x, w, eps=1e-6, plus_one=True)
    assert launch_counts["rmsnorm"] == before + 1
    want = ref.rmsnorm_ref(x, w, eps=1e-6, plus_one=True)
    assert got.dtype == dtype and got.shape == x.shape
    # f32: the mean square is summed in another order (1e-5)
    tol = BF16_TOL if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S,Hq,Hkv,causal", [(1, 2, 1, True), (17, 2, 2, True),
                                             (128, 4, 2, True), (200, 4, 1, True),
                                             (256, 2, 2, False)])
def test_flash_attention_kernel_matches_plain(cuda_device, S, Hq, Hkv, causal, D,
                                              dtype):
    rng = np.random.default_rng(900 + S + D)  # seed 900+S+D
    B = 2
    q = _randn(rng, (B, Hq, S, D), dtype, cuda_device)
    k = _randn(rng, (B, Hkv, S, D), dtype, cuda_device)
    v = _randn(rng, (B, Hkv, S, D), dtype, cuda_device)
    route = "flash_attention" if uses_wgmma(dtype, D) else "flash_attention_fma"
    before = launch_counts[route]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert launch_counts[route] == before + 1
    want = ref.attention_ref(
        q.reshape(B * Hq, S, D), k.reshape(B * Hkv, S, D), v.reshape(B * Hkv, S, D),
        scale=D**-0.5, causal=causal, kv_group=Hq // Hkv,
    ).reshape(B, Hq, S, D)
    # f32: online softmax and another order over up to 256 keys (5e-5)
    tol = BF16_TOL if dtype == torch.bfloat16 else 5e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _within_bf16_limit(got, want):
    """chip_smoke.py's limit for a bf16 kernel against its plain version in
    f32: each element within 2^-7 of its reference value plus 2^-12 of the
    reference's largest (the kernel rounds P and the output to bf16)."""
    limit = 2.0**-7 * want.abs() + 2.0**-12 * want.abs().max()
    assert bool(torch.isfinite(got).all())
    excess = float(((got - want).abs() / limit.clamp_min(1e-30)).max())
    assert excess <= 1.0, f"worst ratio to the limit {excess:.3f}"


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 2049])
def test_flash_wgmma_matches_plain_in_f32(cuda_device, S, causal, group, D):
    rng = np.random.default_rng(1300 + S + group + D)  # seed 1300+S+group+D
    B, Hkv = 2, 2
    Hq = Hkv * group
    q = _randn(rng, (B, Hq, S, D), torch.bfloat16, cuda_device)
    k = _randn(rng, (B, Hkv, S, D), torch.bfloat16, cuda_device)
    v = _randn(rng, (B, Hkv, S, D), torch.bfloat16, cuda_device)
    before = dict(launch_counts)
    got = ops.flash_attention(q, k, v, causal=causal)
    assert launch_counts["flash_attention"] == before.get("flash_attention", 0) + 1
    assert launch_counts["flash_attention_fma"] == before.get("flash_attention_fma", 0)
    want = ref.attention_heads_ref(q.float(), k.float(), v.float(), scale=D**-0.5,
                                   causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Hq, S, D)
    _within_bf16_limit(got.float(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_reads_the_layer_layout_without_copies(cuda_device, D):
    rng = np.random.default_rng(1400 + D)  # seed 1400+D
    B, S, Hq, Hkv = 2, 300, 8, 2
    # the layer's [B, S, H, D] tensors, handed over as (B, H, S, D) views
    q = _randn(rng, (B, S, Hq, D), torch.bfloat16, cuda_device).transpose(1, 2)
    k = _randn(rng, (B, S, Hkv, D), torch.bfloat16, cuda_device).transpose(1, 2)
    v = _randn(rng, (B, S, Hkv, D), torch.bfloat16, cuda_device).transpose(1, 2)
    before = launch_counts["flash_attention_copies"]
    got = ops.flash_attention(q, k, v, causal=True)
    assert launch_counts["flash_attention_copies"] == before
    # o is written in the layer's layout: back to [B, S, Hq, D] with no copy
    assert got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal=True)
    assert torch.equal(got, want)  # the same kernel on the same values
    assert launch_counts["flash_attention_copies"] == before


@pytest.mark.cuda
def test_flash_wgmma_copies_an_operand_tma_cannot_read(cuda_device):
    rng = np.random.default_rng(1410)  # seed 1410
    # a head-dim stride of 2: TMA needs unit stride along D
    wide = _randn(rng, (1, 2, 100, 256), torch.bfloat16, cuda_device)
    q = wide[..., ::2]
    k = _randn(rng, (1, 2, 100, 128), torch.bfloat16, cuda_device)
    before = launch_counts["flash_attention_copies"]
    got = ops.flash_attention(q, k, k, causal=True)
    assert launch_counts["flash_attention_copies"] == before + 1
    assert torch.equal(got, ops.flash_attention(q.contiguous(), k, k, causal=True))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 64), (torch.float32, 128),
                                     (torch.bfloat16, 32), (torch.bfloat16, 256)])
def test_flash_other_routes_stay_on_the_fma_kernel(cuda_device, dtype, D):
    rng = np.random.default_rng(1420 + D)  # seed 1420+D
    q = _randn(rng, (2, 4, 70, D), dtype, cuda_device)
    k = _randn(rng, (2, 2, 70, D), dtype, cuda_device)
    before = dict(launch_counts)
    got = ops.flash_attention(q, k, k, causal=True)
    assert launch_counts["flash_attention_fma"] == before.get("flash_attention_fma", 0) + 1
    assert launch_counts["flash_attention"] == before.get("flash_attention", 0)
    want = ref.attention_heads_ref(q, k, k, scale=D**-0.5, causal=True)
    tol = BF16_TOL if dtype == torch.bfloat16 else 5e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 768, 1536, 2048, 4096, 1001])
def test_rmsnorm_kernel_widths_and_unaligned_base(cuda_device, d, dtype, offset):
    rng = np.random.default_rng(1500 + d)  # seed 1500+d
    rows = 517
    # offset 1: the rows start one element past a 16-byte boundary
    flat = _randn(rng, (rows * d + offset,), dtype, cuda_device, 2.0)
    x = flat[offset:].view(rows, d)
    w = _randn(rng, (d,), torch.float32, cuda_device, 0.1)
    before = launch_counts["rmsnorm"]
    got = ops.rmsnorm(x, w, eps=1e-6, plus_one=True)
    assert launch_counts["rmsnorm"] == before + 1
    want = ref.rmsnorm_ref(x.float(), w, eps=1e-6, plus_one=True)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.bfloat16:
        _within_bf16_limit(got.float(), want)
    else:  # the mean square is summed in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _ssd_inputs(rng, B, H, S, P, N, dtype, device):
    """x ~ N(0, 1), dt ~ U(0.1, 1), a_log = -dt U(0.5, 2), B and C ~ N(0,
    0.2^2), on ``device``."""
    x = _randn(rng, (B, H, S, P), dtype, device)
    dt = torch.from_numpy(rng.uniform(0.1, 1.0, (B, H, S)).astype(np.float32))
    a_log = -dt * torch.from_numpy(rng.uniform(0.5, 2.0, (B, H, S)).astype(np.float32))
    bm = _randn(rng, (B, S, N), dtype, device, 0.2)
    cm = _randn(rng, (B, S, N), dtype, device, 0.2)
    return x, dt.to(device), a_log.to(device), bm, cm


def _ssd_want(x, dt, a_log, bm, cm):
    """The sequential recurrence (``ref.ssd_scan_ref``) in f32 on the same
    values, in the op's (B, H, S, P) layout."""
    B, H, S, P = x.shape
    N = bm.shape[-1]
    bf = bm[:, None].expand(B, H, S, N).reshape(B * H, S, N)
    cf = cm[:, None].expand(B, H, S, N).reshape(B * H, S, N)
    return ref.ssd_scan_ref(x.reshape(B * H, S, P).float(), dt.reshape(B * H, S),
                            a_log.reshape(B * H, S), bf.float(), cf.float()
                            ).reshape(B, H, S, P)


def _ssd_route(x, bm, chunk):
    q = kernel_chunk(chunk, x.shape[2])
    return ("ssd_scan" if uses_tensor_cores(x.dtype, x.shape[-1], bm.shape[-1], q)
            else "ssd_scan_fma")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,P,N,chunk", [(1, 1, 64, 16, 16, 16),
                                             (2, 3, 100, 16, 16, 16),
                                             (1, 2, 192, 64, 128, 64),
                                             (2, 2, 300, 64, 128, 128),
                                             (1, 1, 5, 8, 24, 128)])
def test_ssd_scan_kernel_matches_plain(cuda_device, B, H, S, P, N, chunk, dtype):
    rng = np.random.default_rng(1000 + S + N)  # seed 1000+S+N
    x, dt, a_log, bm, cm = _ssd_inputs(rng, B, H, S, P, N, dtype, cuda_device)
    route = _ssd_route(x, bm, chunk)
    assert route == ("ssd_scan" if dtype == torch.bfloat16 and P == 64 else "ssd_scan_fma")
    before = dict(launch_counts)
    got = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk)
    assert launch_counts[route] == before.get(route, 0) + 1
    other = "ssd_scan_fma" if route == "ssd_scan" else "ssd_scan"
    assert launch_counts[other] == before.get(other, 0)
    want = _ssd_want(x, dt, a_log, bm, cm)
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.bfloat16:
        _within_bf16_limit(got.float(), want)
    else:  # chunked against sequential sums, as tests/test_kernels.py holds
        # the Pallas kernel: 1e-4
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("H", [1, 24])
@pytest.mark.parametrize("S", [1, 127, 128, 129, 300, 2048, 2049])
def test_ssd_tc_matches_plain_in_f32_at_mamba2_width(cuda_device, S, H):
    rng = np.random.default_rng(1600 + S + H)  # seed 1600+S+H
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 2, H, S, 64, 128, torch.bfloat16,
                                       cuda_device)
    before = dict(launch_counts)
    got = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=128)
    assert launch_counts["ssd_scan"] == before.get("ssd_scan", 0) + 1
    assert launch_counts["ssd_scan_fma"] == before.get("ssd_scan_fma", 0)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _within_bf16_limit(got.float(), _ssd_want(x, dt, a_log, bm, cm))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 32, 64])
@pytest.mark.parametrize("P,chunk", [(32, 16), (96, 64), (64, 100)])
def test_ssd_tc_other_states_head_dims_and_chunks(cuda_device, P, chunk, N):
    rng = np.random.default_rng(1650 + P + N + chunk)  # seed 1650+P+N+chunk
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 2, 3, 150, P, N, torch.bfloat16,
                                       cuda_device)
    before = launch_counts["ssd_scan"]
    got = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=chunk)
    assert launch_counts["ssd_scan"] == before + 1
    _within_bf16_limit(got.float(), _ssd_want(x, dt, a_log, bm, cm))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [129, 2048])
def test_ssd_tc_reads_the_layer_layout(cuda_device, S):
    """The Mamba layer hands over views of its [B, S, *] activations: x as
    a transposed (B, H, S, P) view, dt and a_log as (B, H, S) views with a
    step stride of H, B and C as column slices. The tensor-core route reads
    them as they lie and gives what it gives on contiguous copies."""
    rng = np.random.default_rng(1700 + S)  # seed 1700+S
    B, H, P, N = 2, 24, 64, 128
    di = H * P
    conv = _randn(rng, (B, S, di + 2 * N), torch.bfloat16, cuda_device)
    x = conv[..., :di].reshape(B, S, H, P).transpose(1, 2)
    bm, cm = conv[..., di:di + N], conv[..., di + N:]
    dt_l = torch.from_numpy(rng.uniform(0.1, 1.0, (B, S, H)).astype(np.float32)
                            ).to(cuda_device)
    a_l = -dt_l * 0.5
    dt, a_log = dt_l.transpose(1, 2), a_l.transpose(1, 2)
    assert not x.is_contiguous() and not dt.is_contiguous()
    assert tma_ready(x) and tma_ready(bm) and tma_ready(cm)
    got = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=128)
    want = ops.ssd_scan(*(t.contiguous() for t in (x, dt, a_log, bm, cm)), chunk=128)
    assert torch.equal(got, want)  # the same kernel on the same values
    _within_bf16_limit(got.float(), _ssd_want(x, dt, a_log, bm, cm))


@pytest.mark.cuda
def test_ssd_tc_copies_an_operand_tma_cannot_read(cuda_device):
    rng = np.random.default_rng(1710)  # seed 1710
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 1, 2, 70, 64, 128, torch.bfloat16,
                                       cuda_device)
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=cuda_device)
    x_odd = flat[1:].view(x.shape)  # base 2 bytes past a 16-byte boundary
    x_odd.copy_(x)
    assert not tma_ready(x_odd)
    before = launch_counts["ssd_scan"]
    got = ops.ssd_scan(x_odd, dt, a_log, bm, cm, chunk=128)
    assert launch_counts["ssd_scan"] == before + 1
    assert torch.equal(got, ops.ssd_scan(x, dt, a_log, bm, cm, chunk=128))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,P,N", [(torch.float32, 64, 128), (torch.bfloat16, 48, 128),
                                       (torch.bfloat16, 64, 48), (torch.bfloat16, 64, 256),
                                       (torch.bfloat16, 16, 16)])
def test_ssd_other_shapes_stay_on_the_fma_kernel(cuda_device, dtype, P, N):
    rng = np.random.default_rng(1720 + P + N)  # seed 1720+P+N
    x, dt, a_log, bm, cm = _ssd_inputs(rng, 1, 2, 150, P, N, dtype, cuda_device)
    before = dict(launch_counts)
    got = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=64)
    assert launch_counts["ssd_scan_fma"] == before.get("ssd_scan_fma", 0) + 1
    assert launch_counts["ssd_scan"] == before.get("ssd_scan", 0)
    want = _ssd_want(x, dt, a_log, bm, cm)
    if dtype == torch.bfloat16:
        _within_bf16_limit(got.float(), want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_lm_kernel_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    q = torch.zeros((1, 4, 16, 64), device=cuda_device)
    kv = torch.zeros((1, 2, 16, 64), device=cuda_device)
    kw = dict(scale=0.125, causal=True)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.half(), kv.half(), kv.half(), **kw)
    with pytest.raises(ValueError):
        flash_attention_cuda(q.cpu(), kv.cpu(), kv.cpu(), **kw)
    with pytest.raises(ValueError):
        flash_attention_cuda(q[0], kv[0], kv[0], **kw)
    with pytest.raises(ValueError):  # head dim 48
        flash_attention_cuda(q[..., :48], kv[..., :48], kv[..., :48], **kw)
    with pytest.raises(ValueError):  # kv heads do not divide the q heads
        flash_attention_cuda(q, q[:, :3], q[:, :3], **kw)
    with pytest.raises(ValueError):  # k and v differ in shape
        flash_attention_cuda(q, kv, q, **kw)
    with pytest.raises(TypeError):
        flash_attention_cuda(q, kv.bfloat16(), kv, **kw)

    x = torch.zeros((8, 128), device=cuda_device)
    w = torch.zeros(128, device=cuda_device)
    with pytest.raises(TypeError):
        rmsnorm_cuda(x.double(), w, eps=1e-6, plus_one=True)
    with pytest.raises(ValueError):
        rmsnorm_cuda(x.cpu(), w, eps=1e-6, plus_one=True)
    with pytest.raises(ValueError):
        rmsnorm_cuda(x, w[:64], eps=1e-6, plus_one=True)

    xs = torch.zeros((1, 2, 32, 16), device=cuda_device)
    dt = torch.zeros((1, 2, 32), device=cuda_device)
    bc = torch.zeros((1, 32, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ssd_scan_cuda(xs, dt.double(), dt, bc, bc, chunk=16)
    with pytest.raises(TypeError):
        ssd_scan_cuda(xs, dt, dt, bc.bfloat16(), bc.bfloat16(), chunk=16)
    with pytest.raises(TypeError):  # B and C must be in x's dtype
        ssd_scan_cuda(xs.bfloat16(), dt, dt, bc, bc, chunk=16)
    with pytest.raises(ValueError):
        ssd_scan_cuda(xs.cpu(), dt.cpu(), dt.cpu(), bc.cpu(), bc.cpu(), chunk=16)
    with pytest.raises(ValueError):
        ssd_scan_cuda(xs[0], dt, dt, bc, bc, chunk=16)
    with pytest.raises(ValueError):  # head dim not a multiple of 4
        ssd_scan_cuda(xs[..., :6], dt, dt, bc, bc, chunk=16)
    with pytest.raises(ValueError):
        ssd_scan_cuda(xs, dt, dt, bc[:, :16], bc[:, :16], chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "mamba2-130m"])
def test_model_on_cuda_matches_cpu(cuda_device, arch):
    from repro_torch.configs import get_config
    from repro_torch.models.lm_serve import Request, ServeEngine
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1200).integers(  # seed 1200
        0, cfg.vocab_size, (2, 40)))
    before = dict(launch_counts)
    with torch.no_grad():  # evaluation: the scans have no backward on the card
        lc, _ = cpu.apply(tokens)
        lg, _ = gpu.apply(tokens)
    # f32 throughout; kernels and cuBLAS sum in another order (1e-4, the
    # JAX package's own prefill/decode tolerance)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    last, caches = gpu.prefill(tokens[:, :32], 48)
    torch.testing.assert_close(last[:, 0].cpu(), lc[:, 31], rtol=1e-4, atol=1e-4)
    for t in range(32, 40):
        pos = torch.full((2,), t, dtype=torch.int32)
        logits, caches = gpu.decode_step(tokens[:, t:t + 1], caches, pos)
        torch.testing.assert_close(logits[:, 0].cpu(), lc[:, t], rtol=1e-4, atol=1e-4)
    # f32 attention and the f32 SSD scan run the CUDA-core routes
    kernel = "flash_attention_fma" if arch.startswith("qwen") else "ssd_scan_fma"
    assert launch_counts[kernel] > before.get(kernel, 0)
    assert launch_counts["rmsnorm"] > before.get("rmsnorm", 0)
    reqs = [Request(prompt=tokens[i, :16].numpy(), max_new_tokens=6, rid=i)
            for i in range(2)]
    got = ServeEngine(gpu, max_seq=32).generate(reqs)
    want = ServeEngine(cpu, max_seq=32).generate(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "recurrentgemma-9b",
                                  "internvl2-26b", "musicgen-large"])
def test_family_on_cuda_matches_cpu(cuda_device, arch):
    """The MoE, RG-LRU hybrid, VLM-prefix and audio families at their reduced
    size in f32: the card's apply, prefill and decode against the CPU's;
    the RG-LRU prefill launches ``rglru_scan`` (never the plain loop)."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm_serve import Request, ServeEngine
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).reduced()
    if cfg.n_experts:  # no drops: prefill and decode route as the full forward
        cfg = cfg.reduced(moe_capacity_factor=float(cfg.n_experts))
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1230)  # seed 1230
    shape = (2, 40, cfg.n_codebooks) if cfg.n_codebooks else (2, 40)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))
    n_pre = cfg.n_prefix_embeds
    prefix = (torch.from_numpy(rng.standard_normal((2, n_pre, cfg.d_model)).astype(
        np.float32)) if n_pre else None)
    before = dict(launch_counts)
    with torch.no_grad():  # evaluation: the scans have no backward on the card
        lc, aux_c = cpu.apply(tokens, prefix)
        lg, aux_g = gpu.apply(tokens, prefix)
    # f32 throughout; kernels and cuBLAS sum in another order (1e-4, the
    # JAX package's own prefill/decode tolerance)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    for k in aux_c:
        torch.testing.assert_close(aux_g[k].cpu(), aux_c[k], rtol=1e-4, atol=1e-4)
    last, caches = gpu.prefill(tokens[:, :32], 48 + n_pre, prefix)
    torch.testing.assert_close(last[:, 0].cpu(), lc[:, n_pre + 31], rtol=1e-4,
                               atol=1e-4)
    after_prefill = dict(launch_counts)
    for t in range(32, 40):
        pos = torch.full((2,), n_pre + t, dtype=torch.int32)
        logits, caches = gpu.decode_step(tokens[:, t:t + 1], caches, pos)
        torch.testing.assert_close(logits[:, 0].cpu(), lc[:, n_pre + t], rtol=1e-4,
                                   atol=1e-4)
    assert launch_counts["rmsnorm"] > before.get("rmsnorm", 0)
    n_rglru = sum(layer.kind == "rglru" for layer in gpu.layers)
    # two prefills (apply, prefill) launch the scan once a layer; decode never
    assert launch_counts["rglru_scan"] - before.get("rglru_scan", 0) == 2 * n_rglru
    assert launch_counts["rglru_scan"] == after_prefill.get("rglru_scan", 0)
    if n_pre == 0:
        reqs = [Request(prompt=tokens[i, :16].numpy(), max_new_tokens=6, rid=i)
                for i in range(2)]
        got = ServeEngine(gpu, max_seq=32).generate(reqs)
        want = ServeEngine(cpu, max_seq=32).generate(reqs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.tokens, w.tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,dr", [(1, 1, 1), (2, 100, 64), (3, 37, 1000),
                                    (8, 2048, 4096)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_kernel_matches_plain(cuda_device, B, S, dr, with_h0):
    """The kernel rounds each step as the plain loop does (a product, then
    a sum): bit-identical."""
    rng = np.random.default_rng(1240 + S)  # seed 1240+S
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, dr)).astype(np.float32)
                         ).to(cuda_device)
    b = torch.from_numpy(rng.standard_normal((B, S, dr)).astype(np.float32)
                         ).to(cuda_device)
    h0 = (torch.from_numpy(rng.standard_normal((B, dr)).astype(np.float32)
                           ).to(cuda_device) if with_h0 else None)
    before = launch_counts["rglru_scan"]
    got = ops.rglru_scan(a, b, h0)
    assert launch_counts["rglru_scan"] == before + 1
    torch.cuda.synchronize()
    want = ref.rglru_scan_ref(a, b, h0)
    assert got.shape == (B, S, dr) and got.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rglru_scan_wrapper_refuses_bad_operands(cuda_device):
    from repro_torch.kernels.rglru_scan import rglru_scan_cuda

    a = torch.zeros((2, 8, 16), device=cuda_device)
    with pytest.raises(TypeError):
        rglru_scan_cuda(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError):
        rglru_scan_cuda(a.cpu(), a.cpu())
    with pytest.raises(ValueError):
        rglru_scan_cuda(a, a[:, :4])
    with pytest.raises(ValueError):
        rglru_scan_cuda(a, a, torch.zeros((2, 8), device=cuda_device))
    with pytest.raises(ValueError):
        rglru_scan_cuda(a[0], a[0])


# ---------------------------------------------------------------------------
# Files, mutation, durability and the CLI on the card
# ---------------------------------------------------------------------------


def _storage_net(device, seed=1930, n=3000):
    """A two-mode layer of uint16 ids, one of int32 ids, an undirected
    valued layer and an attribute, built on ``device`` from one seed."""
    from repro_torch.core.layers import one_mode_from_edges, two_mode_from_memberships

    rng = np.random.default_rng(seed)
    net = api.createnetwork(api.createnodeset(n, device=device))
    net = api.generate(api.addlayer(net, "W", 2), "W", type="2mode", h=60, a=4, seed=seed)
    net = net.with_layer("R", two_mode_from_memberships(
        n, 70_000, rng.integers(0, n, 4000), rng.integers(0, 70_000, 4000), device=device))
    s, d = rng.integers(0, n, (2, 8000))
    net = net.with_layer("F", one_mode_from_edges(
        n, s, d, values=rng.random(8000).astype(np.float32), device=device))
    return api.setnodeattr(net, "age", np.arange(n), np.arange(n) % 90, kind="int")


@pytest.mark.cuda
@pytest.mark.parametrize("mmap", [False, True])
def test_file_load_on_cuda_matches_cpu(cuda_device, tmp_path, mmap):
    from repro_torch.core import io

    net = _storage_net(cuda_device)
    path = tmp_path / "n.npz"
    io.save_network(net, path, compress=not mmap)
    got = io.load_network(path, mmap=mmap, device=cuda_device)
    assert got.layer("W").memb.indices.is_cuda
    assert_network_identical(got, io.load_network(path, mmap=mmap, device="cpu"))
    assert_network_identical(got, net)


@pytest.mark.cuda
def test_staged_upload_spans_many_chunks(cuda_device, tmp_path):
    """An array several staging buffers long, mapped and in memory."""
    from repro_torch.core import io

    arr = np.random.default_rng(1931).integers(0, 2**31 - 1, 3 * io.STAGING_BYTES // 8 + 5)
    mm = np.memmap(tmp_path / "a.bin", dtype=np.int64, mode="w+", shape=arr.shape)
    mm[:] = arr
    mm.flush()
    mapped = np.memmap(tmp_path / "a.bin", dtype=np.int64, mode="r", shape=arr.shape)
    loader = io._Loader(cuda_device)
    try:
        for src in (mapped, arr.astype(np.uint16)):
            got = loader.tensor(src)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), torch.from_numpy(np.array(src)))
    finally:
        loader.close()


@pytest.mark.cuda
def test_mutation_on_cuda_matches_cpu(cuda_device):
    """The same batches on the card and on the CPU: identical overlays, the
    same compaction, and the point queries, alters and a walk fleet equal."""
    nets = {dev: _storage_net(dev) for dev in (cuda_device, torch.device("cpu"))}
    rng = np.random.default_rng(1932)
    a, b = rng.integers(0, 3000, (2, 300))
    vals = rng.random(300).astype(np.float32)
    for dev, net in nets.items():
        net = api.addedges(net, "W", a[:100], b[:100] % 60)
        net = api.addedges(net, "R", a[:50], 65_536 + b[:50] % 100)  # past uint16
        net = api.deleteedges(net, "W", a[100:150], b[100:150] % 60)
        net = api.addedges(net, "F", a, b, values=vals)
        net = api.deleteedges(net, "F", b[:40], a[:40])
        nets[dev] = net
    gpu, cpu = nets[cuda_device], nets[torch.device("cpu")]
    assert gpu.layer("R").memb_ov.delta.indices.dtype == torch.int32
    assert_network_identical(gpu, cpu)
    assert_network_identical(gpu.compacted(), cpu.compacted())
    u, v = rng.integers(0, 3000, (2, 512))
    for name in ("W", "R", "F"):
        assert torch.equal(api.getedge(gpu, name, u, v), api.getedge(cpu, name, u, v))
        assert torch.equal(api.checkedge(gpu, name, u, v).cpu(), api.checkedge(cpu, name, u, v))
    for x, y in zip(api.getnodealters(gpu, u[:64]), api.getnodealters(cpu, u[:64])):
        assert torch.equal(x, y)
    assert (api.walkbatch(gpu, u[:64], 8, walkers=2, seed=5, layernames=["W", "R"])
            == api.walkbatch(cpu, u[:64], 8, walkers=2, seed=5, layernames=["W", "R"]))


@pytest.mark.cuda
def test_store_and_cli_on_cuda_match_cpu(cuda_device, tmp_path):
    import json

    from repro_torch.core import snapshot, wal
    from repro_torch.core.cli import Session

    store = snapshot.DurableStore.create(tmp_path / "store", _storage_net(cuda_device))
    store.apply(wal.make_add_edges_op("W", torch.arange(5, device=cuda_device),
                                      torch.arange(5, device=cuda_device)))
    store.apply(wal.make_set_attr_op("age", [1, 2], [33, 44], kind="int"))
    want = store.net
    store.close()
    got, info = snapshot.recover(tmp_path / "store", device=cuda_device)
    assert info.replayed == 2
    assert_network_identical(got, want)
    assert_network_identical(got, snapshot.recover(tmp_path / "store", device="cpu")[0])
    script = (f'net = loadfile(file = "{tmp_path}/n.npz", mmap = true)\n'
              "addedges(net, W, src = 1;2, dst = 3;4)\n"
              "checkedge(net, W, 1, 2)\ngetnodealters(net, 1, layernames = W; F)\n"
              "khop(net, 1; 2, k = 2, layernames = W)\n")
    from repro_torch.core import io

    io.save_network(_storage_net("cpu"), tmp_path / "n.npz", compress=False)
    outs = {dev: [json.loads(o) for o in Session(mode="json", device=dev).run_script(script)]
            for dev in (cuda_device, "cpu")}
    assert outs[cuda_device] == outs["cpu"]


# ---------------------------------------------------------------------------
# Backward kernels (the training path): rmsnorm and flash attention
# ---------------------------------------------------------------------------

# bf16 gradients against their plain versions in f32: each element within
# 2^-6 of its reference value plus 2^-10 of the reference's largest (the
# kernels round their inputs' products once to bf16 at the end, and flash
# recomputes P from a bf16 o); f32 within 1e-4.
BWD_REL, BWD_FLOOR, BWD_F32 = 2.0**-6, 2.0**-10, 1e-4
SSD_BWD_F32_FLOOR = 1e-5  # of a gradient's largest, beside BWD_F32 of each element


def _within_bwd_limit(got, want, dtype, largest=None):
    """``largest``: the magnitude the floor scales with, by default the
    reference's own largest (a gradient that is exactly zero, as dq and dk
    are with one key, takes its call's largest gradient instead)."""
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=BWD_F32, atol=BWD_F32)
        return
    largest = want.abs().max() if largest is None else largest
    limit = BWD_REL * want.abs() + BWD_FLOOR * largest
    excess = float(((got - want).abs() / limit.clamp_min(1e-30)).max())
    assert excess <= 1.0, f"worst ratio to the limit {excess:.3f}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1, 128), (1000, 2048), (333, 768),
                                    (4097, 128), (5, 96), (3, 7), (8192, 2048)])
def test_rmsnorm_backward_kernel_matches_plain(cuda_device, rows, d, dtype):
    rng = np.random.default_rng(2300 + d)  # seed 2300+d
    x = _randn(rng, (rows, d), dtype, cuda_device, 3.0).requires_grad_(True)
    w = _randn(rng, (d,), torch.float32, cuda_device, 0.1).requires_grad_(True)
    dy = _randn(rng, (rows, d), dtype, cuda_device)
    before = dict(launch_counts)
    ops.rmsnorm(x, w, eps=1e-6, plus_one=True).backward(dy)
    assert launch_counts["rmsnorm_bwd"] == before.get("rmsnorm_bwd", 0) + 1
    assert x.grad.dtype == dtype and w.grad.dtype == torch.float32
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6, plus_one=True)
    _within_bwd_limit(x.grad.float(), want_dx, dtype)
    _within_bwd_limit(w.grad, want_dw, dtype)
    # no atomics: a second call gives the same bits
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    dx2, dw2 = rmsnorm_bwd_cuda(x.detach(), w.detach(), dy, eps=1e-6, plus_one=True)
    assert torch.equal(dx2, x.grad) and torch.equal(dw2, w.grad)


def _flash_grads(q, k, v, do):
    for t in (q, k, v):
        t.grad = None
    ops.flash_attention(q, k, v, causal=True).backward(do)
    return q.grad, k.grad, v.grad


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("S,Hq,Hkv,causal", [(1, 2, 1, True), (17, 2, 2, True),
                                             (128, 4, 2, True), (200, 4, 1, True),
                                             (256, 2, 2, False)])
def test_flash_attention_backward_matches_plain(cuda_device, S, Hq, Hkv, causal, D,
                                                dtype):
    rng = np.random.default_rng(2400 + S + D)  # seed 2400+S+D
    B = 2
    q, k, v = (_randn(rng, (B, h, S, D), dtype, cuda_device).requires_grad_(True)
               for h in (Hq, Hkv, Hkv))
    do = _randn(rng, (B, Hq, S, D), dtype, cuda_device)
    before = dict(launch_counts)
    ops.flash_attention(q, k, v, causal=causal).backward(do)
    # bf16 at D 64 and 128 takes the tensor-core backward, the rest the FMA one
    route = "flash_attention_bwd" if uses_wgmma(dtype, D) else "flash_attention_bwd_fma"
    other = "flash_attention_bwd_fma" if uses_wgmma(dtype, D) else "flash_attention_bwd"
    assert launch_counts[route] == before.get(route, 0) + 1
    assert launch_counts[other] == before.get(other, 0)
    assert launch_counts["flash_attention_bwd_copies"] == before.get(
        "flash_attention_bwd_copies", 0)
    want = ref.attention_bwd_ref(q, k, v, do, scale=D**-0.5, causal=causal)
    largest = max(float(w.abs().max()) for w in want)
    for got, w in zip((q.grad, k.grad, v.grad), want):
        assert got.dtype == dtype
        _within_bwd_limit(got.float(), w, dtype, largest)


@pytest.mark.cuda
def test_flash_backward_reads_the_layer_layout_and_repeats_bitwise(cuda_device):
    rng = np.random.default_rng(2500)  # seed 2500
    B, S, Hq, Hkv, D = 2, 300, 8, 4, 128
    base = [_randn(rng, (B, S, h, D), torch.bfloat16, cuda_device).requires_grad_(True)
            for h in (Hq, Hkv, Hkv)]
    q, k, v = (t.transpose(1, 2) for t in base)
    do = _randn(rng, (B, S, Hq, D), torch.bfloat16, cuda_device).transpose(1, 2)
    before = dict(launch_counts)
    o = ops.flash_attention(q, k, v, causal=True)
    o.backward(do)
    first = [t.grad.clone() for t in base]
    assert launch_counts["flash_attention_copies"] == before.get("flash_attention_copies", 0)
    assert launch_counts["flash_attention_bwd_copies"] == before.get(
        "flash_attention_bwd_copies", 0)
    for t in base:
        t.grad = None
    ops.flash_attention(q, k, v, causal=True).backward(do)
    assert all(torch.equal(a, t.grad) for a, t in zip(first, base))
    want = ref.attention_bwd_ref(q, k, v, do, scale=D**-0.5, causal=True)
    for got, w in zip(first, want):
        _within_bwd_limit(got.transpose(1, 2).float(), w, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("S", [1, 17, 128, 200, 300, 2048])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_wgmma_backward_matches_plain(cuda_device, D, S, group, causal):
    """The tensor-core backward from the forward's o, o_lo and lse against
    f32 autograd within the bf16 limit, and against its algorithm in plain
    torch (``ref.attention_bwd_blocked`` on the kernel's own residuals); a
    second call on the same inputs gives the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)

    rng = np.random.default_rng(2800 + S + D + group)  # seed 2800+S+D+group
    B, Hkv = 1, 2
    Hq = Hkv * group
    q, do = (_randn(rng, (B, Hq, S, D), torch.bfloat16, cuda_device) for _ in range(2))
    k, v = (_randn(rng, (B, Hkv, S, D), torch.bfloat16, cuda_device) for _ in range(2))
    kw = dict(scale=D**-0.5, causal=causal)
    o, o_lo, lse = flash_attention_cuda(q, k, v, residuals=True, **kw)
    before = dict(launch_counts)
    got = flash_attention_bwd_cuda(q, k, v, do, o, o_lo, lse, **kw)
    assert launch_counts["flash_attention_bwd"] == before.get("flash_attention_bwd", 0) + 1
    assert launch_counts["flash_attention_bwd_fma"] == before.get(
        "flash_attention_bwd_fma", 0)
    assert launch_counts["flash_attention_bwd_copies"] == before.get(
        "flash_attention_bwd_copies", 0)
    again = flash_attention_bwd_cuda(q, k, v, do, o, o_lo, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = ref.attention_bwd_ref(q, k, v, do, **kw)
    largest = max(float(w.abs().max()) for w in want)
    blocked = ref.attention_bwd_blocked(q, k, v, do, o, o_lo, lse, **kw)
    for g, w, a in zip(got, want, blocked):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _within_bwd_limit(g.float(), w, torch.bfloat16, largest)
        _within_bwd_limit(g.float(), a.float(), torch.bfloat16, largest)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("S", [17, 300])
def test_flash_wgmma_residuals_match_plain(cuda_device, S, D):
    """Under grad the tensor-core forward also writes o_lo, the rest of its
    f32 output (o + o_lo within 2^-14 of the largest f32 output), and each
    row's log-sum-exp (within 1e-5 of f32's), and its o is the bits of an
    ordinary call."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    rng = np.random.default_rng(2900 + S + D)  # seed 2900+S+D
    q = _randn(rng, (2, 4, S, D), torch.bfloat16, cuda_device)
    k, v = (_randn(rng, (2, 2, S, D), torch.bfloat16, cuda_device) for _ in range(2))
    o, o_lo, lse = flash_attention_cuda(q, k, v, scale=D**-0.5, causal=True,
                                        residuals=True)
    assert torch.equal(o, flash_attention_cuda(q, k, v, scale=D**-0.5, causal=True))
    assert o_lo.stride() == o.stride() and lse.shape == (8, S)
    _, _, want_lse = ref.attention_residuals_ref(q.float(), k.float(), v.float(),
                                                 scale=D**-0.5)
    o32 = ref.attention_heads_ref(q.float(), k.float(), v.float(), scale=D**-0.5)
    top = float(o32.abs().max())
    assert float((o.float() + o_lo.float() - o32).abs().max()) <= 2.0**-14 * top
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_flash_forward_writes_residuals_only_under_grad(cuda_device, monkeypatch):
    """``ops.flash_attention`` asks the forward for o_lo and lse only where a
    backward can follow: not under ``no_grad``, nor for inputs that need no
    gradient; the output is the same bits either way."""
    rng = np.random.default_rng(2950)  # seed 2950
    q, k, v = (_randn(rng, (1, 2, 100, 128), torch.bfloat16, cuda_device)
               for _ in range(3))
    asked = []
    inner = ops.flash_attention_cuda

    def record(*args, **kwargs):
        asked.append(kwargs.get("residuals", False))
        return inner(*args, **kwargs)

    monkeypatch.setattr(ops, "flash_attention_cuda", record)
    plain = ops.flash_attention(q, k, v)
    with torch.no_grad():
        no_grad = ops.flash_attention(q.requires_grad_(True), k, v)
    grad = ops.flash_attention(q, k, v)
    assert asked == [False, False, True]
    assert torch.equal(plain, no_grad) and torch.equal(plain, grad.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,offset", [(131072, 128, 0), (4096, 768, 0),
                                           (4096, 1536, 0), (8192, 2048, 0),
                                           (1000, 2048, 1), (3000, 128, 1)])
def test_rmsnorm_backward_widths_repeat_bitwise(cuda_device, rows, d, offset):
    """The backward at the training path's widths (qwen3's q/k norm over
    4 x 2,048 tokens and 16 heads, mamba2's hidden and gate, qwen3's hidden)
    and from a base one element past 16-byte alignment (the any-width
    route): within the bf16 limit of f32 autograd, dw within it of the
    register route's algorithm in plain torch, and the same bits again."""
    from repro_torch.kernels.rmsnorm import bwd_plan, rmsnorm_bwd_cuda

    rng = np.random.default_rng(3100 + d + offset)  # seed 3100+d+offset
    flat = _randn(rng, (rows * d + offset,), torch.bfloat16, cuda_device, 3.0)
    x = flat[offset:].view(rows, d)
    dy = _randn(rng, (rows, d), torch.bfloat16, cuda_device)
    w = _randn(rng, (d,), torch.float32, cuda_device, 0.1)
    before = launch_counts["rmsnorm_bwd"]
    dx, dw = rmsnorm_bwd_cuda(x, w, dy, eps=1e-6, plus_one=True)
    dx2, dw2 = rmsnorm_bwd_cuda(x, w, dy, eps=1e-6, plus_one=True)
    assert launch_counts["rmsnorm_bwd"] == before + 2
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x, w, dy, eps=1e-6, plus_one=True)
    _within_bwd_limit(dx.float(), want_dx, torch.bfloat16)
    _within_bwd_limit(dw, want_dw, torch.bfloat16)
    plan = bwd_plan(rows, d, torch.bfloat16, offset == 0)
    assert bool(plan["lanes"]) == (offset == 0)
    if plan["lanes"]:
        _, algo_dw = ref.rmsnorm_bwd_blocked(
            x, w, dy, eps=1e-6, plus_one=True, lanes=plan["lanes"],
            unroll=plan["unroll"], warps=plan["warps"], blocks=plan["blocks"],
            split=plan["split"])
        _within_bwd_limit(dw, algo_dw, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d,elem,aligned,lanes,vecs,unroll", [
    (128, 2, True, 16, 1, 8), (768, 2, True, 32, 3, 2), (1536, 2, True, 32, 6, 1),
    (2048, 2, True, 32, 8, 1), (4096, 2, True, 0, 0, 0), (2048, 4, True, 0, 0, 0),
    (128, 4, True, 32, 1, 8), (2048, 2, False, 0, 0, 0), (96, 2, True, 0, 0, 0)])
def test_rmsnorm_bwd_plan_routes_each_width(cuda_device, d, elem, aligned, lanes, vecs,
                                            unroll):
    """The backward's plan, which the kernels' library computes: the
    register route takes the forward's register widths with at most 8
    vectors a lane (all the training path's), 4 warps a block; wider,
    unaligned and other rows take the any-width route; at most 528 blocks,
    their partial rows summed in 16 runs (the plan the CPU algorithm test in
    tests/test_torch_bwd_algorithms.py runs at the training widths)."""
    from repro_torch.kernels.rmsnorm import bwd_plan

    dtype = {2: torch.bfloat16, 4: torch.float32}[elem]
    plan = bwd_plan(1 << 20, d, dtype, aligned)
    assert (plan["lanes"], plan["vecs"], plan["unroll"]) == (lanes, vecs, unroll)
    assert (plan["blocks"], plan["split"]) == (528, 16)
    assert plan["nvec"] == (d * elem // 16 if aligned and (d * elem) % 16 == 0 else d)
    assert plan["warps"] == (4 if lanes else min(8, 200 * 1024 // (4 * d)))
    small = bwd_plan(5, d, dtype, aligned)
    per_block = small["warps"] * ((32 // lanes) * unroll if lanes else 1)
    assert small["blocks"] == -(-5 // per_block)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,dr", [(1, 1, 1), (2, 37, 1000), (4, 2048, 4096)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_backward_matches_its_loop(cuda_device, B, S, dr, with_h0):
    """The backward kernel rounds as ``rglru_scan_bwd_loop`` does (a product,
    then a sum): bit-identical to it, from the forward's saved h, and within
    1e-5 (rtol and atol: autograd sums in its own order) of f32 autograd of
    the plain loop; a second launch gives the same bits."""
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda

    rng = np.random.default_rng(2700 + S)  # seed 2700+S
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, dr)).astype(np.float32)
                         ).to(cuda_device).requires_grad_(True)
    b = _randn(rng, (B, S, dr), torch.float32, cuda_device).requires_grad_(True)
    h0 = (_randn(rng, (B, dr), torch.float32, cuda_device).requires_grad_(True)
          if with_h0 else None)
    dh = _randn(rng, (B, S, dr), torch.float32, cuda_device)
    before = launch_counts["rglru_scan_bwd"]
    h = ops.rglru_scan(a, b, h0)
    h.backward(dh)
    assert launch_counts["rglru_scan_bwd"] == before + 1
    loop = ref.rglru_scan_bwd_loop(a.detach(), h.detach(), h0, dh)
    got = (a.grad, b.grad, None if h0 is None else h0.grad)
    for g, w in zip(got, loop):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)
    want = ref.rglru_scan_bwd_ref(a, b, h0, dh)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    again = rglru_scan_bwd_cuda(a.detach(), h.detach(), h0, dh)
    assert all(w is None or torch.equal(g, w) for g, w in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,dr,offset", [
    (2, 25, 6, 0),      # S under one 32-step stage; dr % 4 != 0: 4-byte copies
    (1, 64, 128, 0),    # S a multiple of the stage
    (2, 101, 200, 0),   # a ragged last stage; dr past one 128-channel block
    (1, 35, 132, 1),    # 16-byte-misaligned operands: 4-byte copies
])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_backward_ring_at_ragged_shapes(cuda_device, B, S, dr, offset,
                                                   with_h0):
    """The ring of stages (csrc/rglru_scan.cu) at sequence lengths that
    are not a multiple of its stage, widths that are not a multiple of its
    block and operands that are not 16-byte aligned: bit-identical to
    ``rglru_scan_bwd_loop``."""
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda

    rng = np.random.default_rng(2710 + S)  # seed 2710+S

    def operand(values):
        flat = torch.empty(values.numel() + offset, device=cuda_device)
        out = flat[offset:].view(values.shape)
        out.copy_(values)
        return out

    a = operand(torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, dr)).astype(np.float32)))
    b = _randn(rng, (B, S, dr), torch.float32, cuda_device)
    h0 = _randn(rng, (B, dr), torch.float32, cuda_device) if with_h0 else None
    h = operand(ops.rglru_scan(a, b, h0))
    dh = operand(_randn(rng, (B, S, dr), torch.float32, cuda_device))
    assert all((t.data_ptr() % 16 != 0) == bool(offset) for t in (a, h, dh))
    before = launch_counts["rglru_scan_bwd"]
    got = rglru_scan_bwd_cuda(a, h, h0, dh)
    assert launch_counts["rglru_scan_bwd"] == before + 1
    want = ref.rglru_scan_bwd_loop(a, h, h0, dh)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert torch.equal(g, w)


def _ssd_operands(rng, B, H, S, P, N, dtype, device):
    x = _randn(rng, (B, H, S, P), dtype, device)
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (B, H, S)).astype(np.float32)).to(device)
    a_log = dt * -torch.from_numpy(rng.uniform(0.5, 8.0, (1, H, 1)).astype(np.float32)
                                   ).to(device)
    bmat, cmat = (_randn(rng, (B, S, N), dtype, device) for _ in range(2))
    return x, dt, a_log, bmat, cmat


SSD_BWD_ROUTES = {True: ("ssd_scan_bwd_states", "ssd_scan_bwd"),
                  False: ("ssd_scan_bwd_states_fma", "ssd_scan_bwd_fma")}
SSD_BWD_BF16_REL, SSD_BWD_BLOCKED_F32 = 2.0**-7, 1e-3  # against ssd_scan_bwd_blocked


def _ssd_bwd_launched(before: dict, tc: bool) -> None:
    """The route's two kernels launched once each, the other route's not."""
    for key in SSD_BWD_ROUTES[tc]:
        assert launch_counts[key] == before.get(key, 0) + 1, key
    for key in SSD_BWD_ROUTES[not tc]:
        assert launch_counts[key] == before.get(key, 0), key


def _close_to_blocked(got, plain, largest_of, where):
    """The tensor-core route against its algorithm in plain torch on the same
    bf16 inputs (``ref.ssd_scan_bwd_blocked``): the sums run in another
    order, so dx, dB and dC (both rounded once to bf16) may differ by one
    bf16 rounding, 2^-7 of each value, plus 2^-12 of the largest; ddt and
    da_log (f32) within 1e-3 of each value plus 1e-5 of the largest."""
    for g, w, out in zip(got, plain, ("dx", "ddt", "da_log", "dB", "dC")):
        top = largest_of(w)
        rel, floor = ((SSD_BWD_BF16_REL, 2.0**-12) if w.dtype == torch.bfloat16
                      else (SSD_BWD_BLOCKED_F32, SSD_BWD_F32_FLOOR))
        err = float((g.float() - w.float()).abs().max())
        print(f"ssd_scan_bwd tensor cores {out} at {where} against ssd_scan_bwd_blocked: "
              f"max_abs_err {err:.3e}, largest {top:.3e}")
        torch.testing.assert_close(g.float(), w.float(), rtol=rel, atol=floor * top)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,S,P,N,chunk", [(1, 1, 1, 4, 1, 16), (2, 3, 45, 16, 16, 16),
                                             (1, 2, 100, 32, 64, 32),
                                             (2, 4, 300, 64, 128, 128),
                                             (1, 2, 77, 8, 256, 64)])
def test_ssd_scan_backward_matches_plain(cuda_device, B, H, S, P, N, chunk, dtype):
    """Both backward kernels of the call's route through ``ops.ssd_scan``'s
    Function (the tensor-core route for bf16 at P 32/64 and N up to 128, the
    FMA route otherwise; the other route's counts do not move) against f32
    autograd of the plain scan (f32: 1e-4 of each element plus 1e-5 of the
    gradient's largest, as ddt and da_log sum hundreds of terms of either
    sign; bf16: 2^-6 of each element plus 2^-10 of the largest, the train
    phase's limit) and, in f32, against ``ssd_scan_chunked_bwd`` at the
    kernel's own chunk (the same algorithm, the sums in another order: the
    f32 limit); the tensor-core route also against its algorithm
    ``ssd_scan_bwd_blocked`` (``_close_to_blocked``); a second call gives
    the same bits (no atomics)."""
    from repro_torch.kernels.ssd_scan import (
        bwd_chunk, bwd_uses_tensor_cores, ssd_scan_bwd_cuda,
    )

    rng = np.random.default_rng(2800 + S + N)  # seed 2800+S+N
    ops_in = [t.requires_grad_(True)
              for t in _ssd_operands(rng, B, H, S, P, N, dtype, cuda_device)]
    dy = _randn(rng, (B, H, S, P), dtype, cuda_device)
    tc = bwd_uses_tensor_cores(dtype, P, N)
    assert tc == (dtype == torch.bfloat16 and P in (32, 64) and N <= 128)
    before = dict(launch_counts)
    ops.ssd_scan(*ops_in, chunk=chunk).backward(dy)
    _ssd_bwd_launched(before, tc)
    got = [t.grad for t in ops_in]
    assert [g.dtype for g in got] == [dtype, torch.float32, torch.float32, dtype, dtype]
    want = ref.ssd_scan_bwd_ref(*ops_in, dy, chunk=chunk)
    largest = max(float(w.abs().max()) for w in want)

    def f32_close(g, w, against, out):
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        print(f"ssd_scan_bwd f32 {out} at {[B, H, S, P, N, chunk]} against {against}: "
              f"max_abs_err {err:.3e}, largest {top:.3e} ({err / (top or 1):.2e} of it)")
        torch.testing.assert_close(g, w, rtol=BWD_F32, atol=SSD_BWD_F32_FLOOR * top)

    names = ("dx", "ddt", "da_log", "dB", "dC")
    for g, w, out in zip(got, want, names):
        if dtype == torch.float32:
            f32_close(g, w, "autograd", out)
        else:  # an all-zero gradient (da_log at S = 1) takes the call's largest
            _within_bwd_limit(g.float(), w, dtype, float(w.abs().max()) or largest)
    q = bwd_chunk(chunk, S, N, P)
    if dtype == torch.float32:
        plain = ref.ssd_scan_chunked_bwd(*(t.detach() for t in ops_in), dy, chunk=q)
        for g, w, out in zip(got, plain, names):
            f32_close(g, w, "its chunked loop", out)
    if tc:
        plain = ref.ssd_scan_bwd_blocked(*(t.detach() for t in ops_in), dy, chunk=q)
        _close_to_blocked(got, plain, lambda w: float(w.float().abs().max()) or largest,
                          [B, H, S, P, N, q])
    again = ssd_scan_bwd_cuda(*(t.detach() for t in ops_in), dy, chunk=chunk)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 64, 150])
@pytest.mark.parametrize("P", [32, 64])
@pytest.mark.parametrize("N", [16, 32, 64, 128])
def test_ssd_scan_backward_tensor_cores_every_state(cuda_device, N, P, S):
    """The tensor-core route at every state size and head dim it is built
    for, S a multiple of its chunk of 64 and not, and S = 1: against f32
    autograd at the train limit and against ``ssd_scan_bwd_blocked``
    (``_close_to_blocked``); a second call gives the same bits."""
    from repro_torch.kernels.ssd_scan import bwd_chunk, ssd_scan_bwd_cuda

    rng = np.random.default_rng(3600 + S + N + P)  # seed 3600+S+N+P
    x, dt, a_log, bm, cm = _ssd_operands(rng, 2, 3, S, P, N, torch.bfloat16, cuda_device)
    dy = _randn(rng, (2, 3, S, P), torch.bfloat16, cuda_device)
    before = dict(launch_counts)
    got = ssd_scan_bwd_cuda(x, dt, a_log, bm, cm, dy, chunk=128)
    _ssd_bwd_launched(before, True)
    want = ref.ssd_scan_bwd_ref(x, dt, a_log, bm, cm, dy, chunk=128)
    largest = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        _within_bwd_limit(g.float(), w, torch.bfloat16, float(w.abs().max()) or largest)
    q = bwd_chunk(128, S, N, P)
    assert q == min(kernel_chunk(128, S), 64)
    plain = ref.ssd_scan_bwd_blocked(x, dt, a_log, bm, cm, dy, chunk=q)
    _close_to_blocked(got, plain, lambda w: float(w.float().abs().max()) or largest,
                      [2, 3, S, P, N, q])
    again = ssd_scan_bwd_cuda(x, dt, a_log, bm, cm, dy, chunk=128)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,P,N", [(torch.float32, 64, 128), (torch.bfloat16, 16, 64),
                                       (torch.bfloat16, 64, 256), (torch.bfloat16, 128, 128)])
def test_ssd_scan_backward_other_shapes_stay_on_the_fma_kernels(cuda_device, dtype, P, N):
    """f32, and bf16 at head dims or states the tensor-core route is not
    built for, launch the FMA kernels and not the tensor-core ones."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    rng = np.random.default_rng(3700 + P + N)  # seed 3700+P+N
    x, dt, a_log, bm, cm = _ssd_operands(rng, 1, 2, 70, P, N, dtype, cuda_device)
    dy = _randn(rng, (1, 2, 70, P), dtype, cuda_device)
    before = dict(launch_counts)
    got = ssd_scan_bwd_cuda(x, dt, a_log, bm, cm, dy, chunk=64)
    _ssd_bwd_launched(before, False)
    want = ref.ssd_scan_bwd_ref(x, dt, a_log, bm, cm, dy, chunk=64)
    for g, w in zip(got, want):
        _within_bwd_limit(g.float(), w, dtype)


@pytest.mark.cuda
def test_ssd_scan_backward_reads_the_layer_views(cuda_device):
    """The layer's operands are views of its [B, S, *] activations and dy
    arrives as a transposed view: the tensor-core route reads them as they
    lie, no copy counted, and its gradients land at those views' shapes,
    equal to the contiguous call's bits."""
    rng = np.random.default_rng(2900)  # seed 2900
    B, S, H, P, N = 2, 200, 4, 64, 128
    act = _randn(rng, (B, S, H * P + 2 * N), torch.bfloat16, cuda_device)
    dts = torch.from_numpy(rng.uniform(0.01, 0.5, (B, S, H)).astype(np.float32)
                           ).to(cuda_device)
    views = [act[..., :H * P].reshape(B, S, H, P).transpose(1, 2), dts.transpose(1, 2),
             (-2.0 * dts).transpose(1, 2), act[..., H * P:H * P + N], act[..., H * P + N:]]
    leaves = [v.detach().clone().requires_grad_(True) for v in views]
    views = [v.detach().requires_grad_(True) for v in views]
    dy = _randn(rng, (B, S, H, P), torch.bfloat16, cuda_device).transpose(1, 2)
    before = dict(launch_counts)
    ops.ssd_scan(*views, chunk=128).backward(dy)
    _ssd_bwd_launched(before, True)
    assert launch_counts["ssd_scan_bwd_copies"] == before.get("ssd_scan_bwd_copies", 0)
    ops.ssd_scan(*leaves, chunk=128).backward(dy.contiguous())
    for v, t in zip(views, leaves):
        assert v.grad.shape == v.shape and torch.equal(v.grad, t.grad)


@pytest.mark.cuda
def test_ssd_scan_backward_copies_an_operand_it_cannot_read(cuda_device):
    """A dy at an odd offset (not 16-byte aligned) is copied and counted;
    the gradients equal the aligned call's bits."""
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    rng = np.random.default_rng(2901)  # seed 2901
    x, dt, a_log, bm, cm = _ssd_operands(rng, 1, 2, 70, 64, 128, torch.bfloat16,
                                         cuda_device)
    dy = _randn(rng, (1, 2, 70, 64), torch.bfloat16, cuda_device)
    dy_odd = torch.empty(dy.numel() + 1, dtype=dy.dtype, device=cuda_device)[1:]
    dy_odd = dy_odd.view(dy.shape).copy_(dy)
    before = launch_counts["ssd_scan_bwd_copies"]
    got = ssd_scan_bwd_cuda(x, dt, a_log, bm, cm, dy_odd, chunk=64)
    assert launch_counts["ssd_scan_bwd_copies"] == before + 1
    want = ssd_scan_bwd_cuda(x, dt, a_log, bm, cm, dy, chunk=64)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-9b"])
def test_scan_family_gradients_on_cuda_match_cpu(cuda_device, arch):
    """A reduced mamba2 / recurrentgemma in f32: every parameter's gradient
    on the card, through the scans' backward kernels, against the CPU's
    plain autograd within 1e-4 of the largest (the kernels and cuBLAS sum
    in another order; f32 takes the SSD backward's FMA route)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch_at
    from repro_torch.models.model import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    batch = synthetic_batch_at(0, seed=7, batch_size=2, seq_len=45,
                               vocab_size=cfg.vocab_size, device="cpu")
    key = "ssd_scan_bwd_fma" if arch.startswith("mamba") else "rglru_scan_bwd"
    before = launch_counts[key]
    grads = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        loss, _ = model.loss(batch)
        named = list(model.named_parameters())
        gs = torch.autograd.grad(loss, [p for _, p in named])
        grads[name] = (float(loss), {n: g.cpu() for (n, _), g in zip(named, gs)})
    assert launch_counts[key] > before
    assert grads["gpu"][0] == pytest.approx(grads["cpu"][0], abs=1e-4)
    largest = max(float(g.abs().max()) for g in grads["cpu"][1].values())
    for n, g in grads["cpu"][1].items():
        torch.testing.assert_close(grads["gpu"][1][n], g, rtol=1e-4, atol=1e-4 * largest,
                                   msg=lambda m, n=n: f"{n}: {m}")


@pytest.mark.cuda
def test_backward_wrappers_refuse_bad_operands(cuda_device):
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd_cuda

    q = torch.zeros((1, 4, 16, 64), device=cuda_device)
    kv = torch.zeros((1, 2, 16, 64), device=cuda_device)
    kw = dict(scale=0.125, causal=True)
    with pytest.raises(TypeError):
        flash_attention_bwd_cuda(q, kv, kv, q.bfloat16(), **kw)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q, kv, kv, q[:, :, :8], **kw)
    with pytest.raises(ValueError):
        flash_attention_bwd_cuda(q.cpu(), kv, kv, q, **kw)
    x = torch.zeros((8, 128), device=cuda_device)
    w = torch.zeros(128, device=cuda_device)
    with pytest.raises(ValueError):
        rmsnorm_bwd_cuda(x, w, x[:4], eps=1e-6, plus_one=True)
    with pytest.raises(ValueError):
        rmsnorm_bwd_cuda(x, w, x.bfloat16(), eps=1e-6, plus_one=True)
    from repro_torch.kernels.rglru_scan import rglru_scan_bwd_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda

    a = torch.zeros((2, 8, 16), device=cuda_device)
    with pytest.raises(ValueError):
        rglru_scan_bwd_cuda(a, a[:, :4], None, a)
    with pytest.raises(ValueError):
        rglru_scan_bwd_cuda(a, a, torch.zeros((2, 8), device=cuda_device), a)
    x = torch.zeros((1, 2, 32, 16), device=cuda_device)
    dt = torch.zeros((1, 2, 32), device=cuda_device)
    bc = torch.zeros((1, 32, 16), device=cuda_device)
    with pytest.raises(ValueError):
        ssd_scan_bwd_cuda(x, dt, dt, bc, bc, x[:, :, :8], chunk=16)
    with pytest.raises(ValueError, match="power of two"):
        ssd_scan_bwd_cuda(x, dt, dt, bc[..., :12], bc[..., :12], x, chunk=16)
    with pytest.raises(TypeError):
        ssd_scan_bwd_cuda(x, dt, dt, bc.bfloat16(), bc, x, chunk=16)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["none", "full"])
def test_training_gradients_on_cuda_match_cpu(cuda_device, remat):
    """A reduced qwen3 in f32: ``Model.loss`` and every parameter's gradient
    on the card (through the backward kernels) against the CPU's plain
    autograd (f32 throughout; kernels and cuBLAS sum in another order: 1e-4
    of the largest), then one ``Trainer`` step on the card. Parameters
    after a step are not compared with the CPU's: AdamW's first step turns
    a 1e-9 difference in a near-zero gradient into a step of plus or minus
    lr."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch_at
    from repro_torch.models.model import Model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_loop import Trainer, TrainerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b").reduced(remat=remat)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    gpu = Model(cfg)
    gpu.load_state_dict(cpu.state_dict())
    batch = synthetic_batch_at(0, seed=7, batch_size=2, seq_len=64,
                               vocab_size=cfg.vocab_size, device="cpu")
    before = dict(launch_counts)
    grads = {}
    for name, model in (("cpu", cpu), ("gpu", gpu)):
        loss, _ = model.loss(batch)
        named = list(model.named_parameters())
        gs = torch.autograd.grad(loss, [p for _, p in named])
        grads[name] = (float(loss), {n: g.cpu() for (n, _), g in zip(named, gs)})
    for key in ("flash_attention_bwd_fma", "rmsnorm_bwd"):  # f32: the FMA backward
        assert launch_counts[key] > before.get(key, 0)
    assert grads["gpu"][0] == pytest.approx(grads["cpu"][0], abs=1e-4)
    largest = max(float(g.abs().max()) for g in grads["cpu"][1].values())
    for n, g in grads["cpu"][1].items():
        torch.testing.assert_close(grads["gpu"][1][n], g, rtol=1e-4, atol=1e-4 * largest,
                                   msg=lambda m, n=n: f"{n}: {m}")
    # one Trainer step on the card: finite, every parameter moved
    tr = Trainer(gpu, AdamWConfig(lr_peak=1e-3, warmup_steps=1, decay_steps=4),
                 TrainerConfig(steps=1))
    old = {n: p.detach().clone() for n, p in gpu.named_parameters()}
    state, metrics = tr.train_step(tr.state_of_model(), batch)
    assert float(metrics["loss"]) == pytest.approx(grads["gpu"][0], abs=1e-6)
    for n, p in state["params"].items():
        assert bool(torch.isfinite(p).all()) and not torch.equal(p, old[n]), n
