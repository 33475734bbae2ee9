"""PyTorch port on the card: the CUDA kernels against their plain torch
versions, and the point-query and traversal api on CUDA against the same
api on the CPU.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode). The file imports neither JAX nor the JAX
package, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: none — int32 and float32 outputs must be bit-identical.
Inputs come from ``np.random.default_rng`` with the seed named in each
test.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core.csr import SENTINEL
from repro_torch.kernels import ops, ref
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.frontier import MAX_CAND
from repro_torch.kernels.segmented_union import MAX_FLAT

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


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 300, 4096, MAX_FLAT])
def test_segmented_union_kernel_matches_plain(cuda_device, K):
    rng = np.random.default_rng(500 + K)  # seed 500+K
    flat = _flat_rows(rng, 40, K, universe=max(K // 2, 2))
    for max_out in (1, 64, K + 7):
        gv, gm = ops.segmented_union(flat.to(cuda_device), max_out)
        wv, wm = ref.segmented_union_ref(flat, max_out)
        torch.testing.assert_close(gv.cpu(), wv, rtol=0, atol=0)
        assert torch.equal(gm.cpu(), wm)


@pytest.mark.cuda
@pytest.mark.parametrize("Kc", [32, 300, 4096, MAX_CAND])
@pytest.mark.parametrize("Kv", [1, 257, 8193])
def test_frontier_kernel_matches_plain(cuda_device, Kc, Kv):
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
