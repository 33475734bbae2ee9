"""PyTorch port, the padded ``intersect_count`` kernel's plan on the CPU.

``kernels/ref.py::intersect_count_lanes`` is the narrow route of
``csrc/intersect.cu`` (rows of at most 32 entries) written in plain
torch: a group of next_pow2(max(Ka, Kb)) lanes a row pair holds the b row
padded with SENTINEL, and each a entry finds its lower bound there by a
branchless binary search. It must equal the port's all-pairs
``intersect_count_ref`` and the JAX package's ``intersect_count`` (its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it)
bit for bit, at the widths on both sides of the route's edge, with pads,
Ka != Kb, rows of all pads and rows that share everything or nothing.
Seeds are named in each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import SENTINEL
from repro.kernels import ops as jops
from repro_torch.kernels import ref

from _torch_parity import assert_same

S = int(SENTINEL)
ROWS = 24


def _rows(rng, k, universe, lengths):
    """Sorted unique rows of ``k`` slots, row i holding lengths[i] ids of
    ``universe``, SENTINEL after them."""
    out = np.full((len(lengths), k), S, dtype=np.int32)
    for i, n in enumerate(lengths):
        out[i, :n] = np.sort(rng.choice(universe, size=n, replace=False))
    return out


def _case(seed, ka, kb):
    """(a, b): random lengths (row 0 of a all pads, row 1 of b all pads),
    row 2 full in both from one shared id set (shares min(Ka, Kb)), row 3
    full in both over disjoint ids (shares none)."""
    rng = np.random.default_rng(seed)
    universe = max(2 * max(ka, kb), 2)
    a = _rows(rng, ka, universe, rng.integers(0, ka + 1, ROWS))
    b = _rows(rng, kb, universe, rng.integers(0, kb + 1, ROWS))
    a[0], b[1] = S, S
    same = np.sort(rng.choice(universe, size=max(ka, kb), replace=False))
    a[2], b[2] = same[:ka], same[:kb]
    if ka and kb:
        a[3] = np.arange(0, 2 * ka, 2)
        b[3] = np.arange(1, 2 * kb, 2)
    return a, b


@pytest.mark.parametrize("ka,kb", [(1, 1), (4, 4), (6, 6), (7, 7), (32, 32), (33, 33),
                                   (6, 4), (1, 7), (32, 5), (33, 6)])
def test_lane_plan_equals_all_pairs_and_the_jax_kernel(ka, kb):
    a, b = _case(2900 + ka * 64 + kb, ka, kb)  # seed 2900 + 64 Ka + Kb
    got = ref.intersect_count_lanes(torch.from_numpy(a), torch.from_numpy(b))
    want = ref.intersect_count_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(got, want)
    assert got.dtype == torch.int32
    assert_same(got, jops.intersect_count(jnp.asarray(a), jnp.asarray(b),
                                          use_pallas=True))
    assert int(got[0]) == int(got[1]) == 0
    assert int(got[2]) == min(ka, kb)
    assert int(got[3]) == 0


@pytest.mark.parametrize("ka,kb", [(0, 6), (6, 0), (0, 0)])
def test_lane_plan_on_empty_rows(ka, kb):
    a = torch.full((5, ka), S, dtype=torch.int32)
    b = torch.full((5, kb), S, dtype=torch.int32)
    assert torch.equal(ref.intersect_count_lanes(a, b), torch.zeros(5, dtype=torch.int32))


@pytest.mark.parametrize("kernel", ["intersect_count_kernel", "intersect_count_kernel_lanes"])
def test_smoke_counts_both_routes_device_events(kernel):
    """chip_smoke's lost-event check counts the device events of either
    route of the padded entry, under the demangled names the profiler
    reports, and no kernel whose name only begins like one."""
    import chip_smoke

    acts = {f"(anonymous namespace)::{kernel}(int const*, int const*, int*, long, "
            "int, int)": [54, 80.0],
            "void (anonymous namespace)::intersect_count_kernel_other(int*)": [7, 1.0]}
    assert chip_smoke.graph_kernel_events(acts) == 54
