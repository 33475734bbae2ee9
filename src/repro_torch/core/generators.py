"""Random graph generators: ER, WS, BA, random two-mode.

Generation is host-side numpy and seed-deterministic, ported verbatim
from the JAX package so identical seeds give identical CSR buffers; the
layers come out on ``device``.

* Erdős–Rényi uses the Batagelj–Brandes geometric-skip method: jump
  between selected edges with Geometric(p) gaps — O(m) for m edges.
* Watts–Strogatz: ring lattice (k nearest neighbors) + rewiring prob β.
* Barabási–Albert: preferential attachment via the repeated-nodes method.
* Random two-mode: each node draws Poisson(a) memberships over h
  hyperedges.
"""

from __future__ import annotations

import numpy as np

from .layers import (
    LayerOneMode,
    LayerTwoMode,
    one_mode_from_edges,
    two_mode_from_memberships,
)

__all__ = [
    "erdos_renyi",
    "watts_strogatz",
    "barabasi_albert",
    "random_two_mode",
]


def _pair_from_linear(idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Map linear indices over the strict lower triangle to (i, j), i > j."""
    i = np.floor((1.0 + np.sqrt(1.0 + 8.0 * idx.astype(np.float64))) / 2.0)
    i = i.astype(np.int64)
    # float rounding guard
    i = np.where(i * (i - 1) // 2 > idx, i - 1, i)
    i = np.where((i + 1) * i // 2 <= idx, i + 1, i)
    j = idx - i * (i - 1) // 2
    return i, j


def erdos_renyi(
    n_nodes: int, p: float, seed: int = 0, directed: bool = False,
    device=None,
) -> LayerOneMode:
    """G(n, p) via Batagelj–Brandes geometric skipping."""
    rng = np.random.default_rng(seed)
    n_pairs = n_nodes * (n_nodes - 1) // 2
    if p <= 0 or n_pairs == 0:
        return one_mode_from_edges(
            n_nodes, [], [], directed=directed, device=device
        )
    if p >= 1:
        idx = np.arange(n_pairs, dtype=np.int64)
    else:
        expected = int(n_pairs * p)
        chunks: list[np.ndarray] = []
        pos = -1
        while pos < n_pairs:
            block = max(1024, int(expected * 1.2) - sum(c.size for c in chunks))
            gaps = rng.geometric(p, size=block).astype(np.int64)
            steps = np.cumsum(gaps) + pos
            chunks.append(steps[steps < n_pairs])
            if steps[-1] >= n_pairs:
                break
            pos = int(steps[-1])
        idx = np.concatenate(chunks)
    i, j = _pair_from_linear(idx)
    return one_mode_from_edges(n_nodes, i, j, directed=directed, device=device)


def watts_strogatz(
    n_nodes: int, k: int, beta: float, seed: int = 0, device=None
) -> LayerOneMode:
    """Ring lattice with k neighbors per node (k/2 each side), rewire prob β."""
    if k % 2 != 0:
        raise ValueError("watts_strogatz requires even k")
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(n_nodes, dtype=np.int64), k // 2)
    offsets = np.tile(np.arange(1, k // 2 + 1, dtype=np.int64), n_nodes)
    dst = (src + offsets) % n_nodes
    rewire = rng.random(src.shape) < beta
    new_dst = rng.integers(0, n_nodes, size=src.shape, dtype=np.int64)
    dst = np.where(rewire, new_dst, dst)
    keep = src != dst
    return one_mode_from_edges(
        n_nodes, src[keep], dst[keep], directed=False, device=device
    )


def barabasi_albert(
    n_nodes: int, m: int, seed: int = 0, device=None
) -> LayerOneMode:
    """Preferential attachment, m edges per arriving node (repeated-nodes)."""
    if n_nodes <= m:
        raise ValueError("barabasi_albert requires n_nodes > m")
    rng = np.random.default_rng(seed)
    src = np.empty((n_nodes - m) * m, dtype=np.int64)
    dst = np.empty((n_nodes - m) * m, dtype=np.int64)
    # endpoint multiset: sampling uniformly from it = sampling ∝ degree
    repeated = np.empty(2 * (n_nodes - m) * m, dtype=np.int64)
    rep_len = 0
    # seed graph: star over the first m+1 nodes
    e = 0
    for j in range(m):
        src[e], dst[e] = m, j
        repeated[rep_len : rep_len + 2] = (m, j)
        rep_len += 2
        e += 1
    for v in range(m + 1, n_nodes):
        targets: set[int] = set()
        while len(targets) < m:
            cand = int(repeated[rng.integers(0, rep_len)])
            if cand != v:
                targets.add(cand)
        for t in targets:
            src[e], dst[e] = v, t
            repeated[rep_len : rep_len + 2] = (v, t)
            rep_len += 2
            e += 1
    return one_mode_from_edges(
        n_nodes, src[:e], dst[:e], directed=False, device=device
    )


def random_two_mode(
    n_nodes: int, h: int, a: float, seed: int = 0, device=None
) -> LayerTwoMode:
    """Each node draws Poisson(a) memberships over h hyperedges."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(a, size=n_nodes)
    total = int(counts.sum())
    node_ids = np.repeat(np.arange(n_nodes, dtype=np.int64), counts)
    hyperedge_ids = rng.integers(0, h, size=total, dtype=np.int64)
    return two_mode_from_memberships(
        n_nodes, h, node_ids, hyperedge_ids, device=device
    )
