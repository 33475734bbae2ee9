"""Analytics, multilayer-aware: degree and density summaries, BFS
shortest paths and connected components.

* degree centrality, degree distributions, density, attribute summaries —
  reductions (device, then host numpy where the JAX package uses numpy).
* BFS across any subset of layers of mixed modes: dense frontier
  expansion. Two-mode layers advance node frontier → hyperedge frontier →
  node frontier, so one pseudo-projected hop costs two bipartite passes and
  never touches the k(k−1)/2 projection. The JAX package's
  ``lax.while_loop``s become host loops over levels; each level's
  per-edge expansion (``out.at[indices].max(active)``) is a device scatter.
* connected components: ``traversal.components_batched``.

Frontier expansion reads per-edge source-row ids (``csr_row_ids``, one
int32 per membership and edge), built for the call and freed with it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .csr import CSR, csr_row_ids, to_numpy, widen_ids
from .layers import LayerTwoMode, compact_layer, has_overlay
from .network import Network

__all__ = [
    "degree_centrality",
    "projected_degree",
    "degree_distribution",
    "density",
    "attribute_summary",
    "bfs_distances",
    "shortest_path_length",
    "connected_components",
]

_INF = 2**31 - 1


# ---------------------------------------------------------------------------
# Simple metrics
# ---------------------------------------------------------------------------


def degree_centrality(net: Network, layer_names: Sequence[str] | None = None
                      ) -> torch.Tensor:
    """Per-node degree summed over selected layers (two-mode: memberships)
    -> int32[n_nodes]."""
    total = torch.zeros(net.n_nodes, dtype=torch.int32, device=net.device)
    for layer in net._select(layer_names):
        total = total + layer.degrees().to(torch.int32)
    return total


def projected_degree(
    net: Network,
    u,
    layer_names: Sequence[str] | None = None,
    max_alters: int | None = None,
    node_filter=None,
) -> torch.Tensor:
    """Exact *projected* degree per query node -> int32[B]: distinct alters
    across the selected layers (for a two-mode layer the degree in the
    never-built projection). ``max_alters`` caps the count; the default is
    the exact host bound ``dispatch.alters_bound``. ``node_filter`` counts
    only alters passing a predicate."""
    from . import dispatch

    u = net._batch(u)
    if max_alters is None:
        max_alters = dispatch.alters_bound(
            net._select(layer_names), u, net.n_nodes
        )
    _, mask = net.node_alters(u, max_alters, layer_names,
                              node_filter=node_filter)
    return mask.sum(dim=-1).to(torch.int32)


def degree_distribution(
    net: Network,
    layer_names: Sequence[str] | None = None,
    node_filter=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Degree histogram over all nodes -> (degrees int64[k], counts int64[k]).

    Degree is the summed per-layer degree (two-mode: membership count);
    ``node_filter`` restricts which nodes are counted. Zero-count degrees
    are omitted.
    """
    from .nodeset import node_filter_mask

    total = to_numpy(degree_centrality(net, layer_names)).astype(np.int64)
    nf = node_filter_mask(node_filter, net.n_nodes)
    if nf is not None:
        nf = to_numpy(nf) if isinstance(nf, torch.Tensor) else nf
        total = total[np.asarray(nf, dtype=bool)]
    if total.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    counts = np.bincount(total)
    degs = np.nonzero(counts)[0]
    return degs.astype(np.int64), counts[degs].astype(np.int64)


def density(layer) -> float:
    n = layer.n_nodes
    if n < 2:
        return 0.0
    if isinstance(layer, LayerTwoMode):
        # bipartite density: memberships / (n_nodes * n_hyperedges)
        return float(layer.n_memberships) / (n * max(layer.n_hyperedges, 1))
    possible = n * (n - 1)
    if not layer.directed:
        possible //= 2
    return float(layer.n_edges) / possible


def attribute_summary(net: Network, name: str) -> dict:
    col = net.nodeset.attrs.column(name)
    vals = to_numpy(col.values)
    out = {
        "name": name,
        "kind": col.kind,
        "n_set": col.n_set,
        "coverage": col.n_set / max(net.n_nodes, 1),
    }
    if col.kind in ("int", "float") and vals.size:
        out.update(
            mean=float(vals.mean()), min=float(vals.min()),
            max=float(vals.max()), std=float(vals.std()),
        )
    return out


# ---------------------------------------------------------------------------
# Frontier expansion
# ---------------------------------------------------------------------------


def _expand_csr(csr: CSR, row_ids: torch.Tensor, cols: torch.Tensor,
                frontier: torch.Tensor, n_out: int) -> torch.Tensor:
    """bool[n_rows] frontier -> bool[n_out] reached through csr's edges.

    Every edge whose source row is in the frontier writes True at its
    column; the rest write into a spare slot past the end, so every write
    of a slot writes True and their order cannot matter."""
    if csr.nnz == 0:
        return torch.zeros(n_out, dtype=torch.bool, device=frontier.device)
    active = frontier[row_ids]  # per edge: source in the frontier?
    out = torch.zeros(n_out + 1, dtype=torch.bool, device=frontier.device)
    out[torch.where(active, cols, n_out)] = True
    return out[:n_out]


class _LayerExpander:
    """Per-edge row ids and widened columns of a layer's CSRs, for one call."""

    def __init__(self, layer):
        if has_overlay(layer):
            # expansion reads raw CSR buffers; fold the delta overlay first
            # (bit-identical by the compaction contract)
            layer = compact_layer(layer)
        self.layer = layer
        if isinstance(layer, LayerTwoMode):
            self.parts = [
                (layer.memb, csr_row_ids(layer.memb), widen_ids(layer.memb.indices),
                 layer.n_hyperedges),
                (layer.members, csr_row_ids(layer.members),
                 widen_ids(layer.members.indices), None),
            ]
        else:
            self.parts = [(layer.out, csr_row_ids(layer.out),
                           widen_ids(layer.out.indices), None)]

    def expand(self, frontier: torch.Tensor, n_nodes: int) -> torch.Tensor:
        for csr, rows, cols, n_out in self.parts:
            frontier = _expand_csr(csr, rows, cols, frontier,
                                   n_nodes if n_out is None else n_out)
        return frontier


def _expanders(net: Network, layer_names) -> list[_LayerExpander]:
    return [_LayerExpander(l) for l in net._select(layer_names)]


def _next_frontier(expanders, frontier: torch.Tensor, n: int) -> torch.Tensor:
    nxt = torch.zeros(n, dtype=torch.bool, device=frontier.device)
    for e in expanders:
        nxt |= e.expand(frontier, n)
    return nxt


# ---------------------------------------------------------------------------
# BFS shortest paths
# ---------------------------------------------------------------------------


def bfs_distances(
    net: Network,
    source: int,
    layer_names: Sequence[str] | None = None,
    max_steps: int | None = None,
) -> torch.Tensor:
    """Unweighted multilayer BFS -> int32[n_nodes] distances (INT32_MAX
    where unreached). A pseudo-projected hop through a two-mode layer
    counts as ONE step. One host-loop pass a level, until the frontier is
    empty or ``max_steps`` levels have run."""
    n = net.n_nodes
    expanders = _expanders(net, layer_names)
    max_steps = n if max_steps is None else max_steps
    frontier = torch.zeros(n, dtype=torch.bool, device=net.device)
    frontier[int(source)] = True
    dist = torch.where(frontier, 0, _INF).to(torch.int32)
    d = 0
    while d < max_steps and bool(frontier.any()):
        nxt = _next_frontier(expanders, frontier, n) & (dist == _INF)
        dist = torch.where(nxt, d + 1, dist).to(torch.int32)
        frontier, d = nxt, d + 1
    return dist


def shortest_path_length(
    net: Network,
    source: int,
    target: int,
    layer_names: Sequence[str] | None = None,
) -> int:
    """CLI ``shortestpath`` — the hop count from source to target, -1 if
    unreachable. Stops at the level that reaches the target."""
    n = net.n_nodes
    expanders = _expanders(net, layer_names)
    frontier = torch.zeros(n, dtype=torch.bool, device=net.device)
    frontier[int(source)] = True
    visited = frontier.clone()
    d, found = 0, int(source) == int(target)
    while not found and d < n and bool(frontier.any()):
        frontier = _next_frontier(expanders, frontier, n) & ~visited
        visited |= frontier
        d += 1
        found = bool(frontier[int(target)])
    return d if found else -1


# ---------------------------------------------------------------------------
# Connected components
# ---------------------------------------------------------------------------


def connected_components(
    net: Network, layer_names: Sequence[str] | None = None, node_filter=None
) -> torch.Tensor:
    """Min-label propagation -> int32[n_nodes] component labels: delegates
    to ``traversal.components_batched`` (label sweeps with pointer jumping,
    two-mode layers through hyperedge labels). Directed layers count as
    undirected; ``node_filter`` restricts to the induced selection."""
    from .traversal import components_batched

    return components_batched(net, layer_names, node_filter=node_filter)
