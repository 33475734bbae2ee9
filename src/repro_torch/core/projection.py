"""Materialized one-mode projection — the oracle for pseudo-projection.

Expands each hyperedge of k nodes into k(k−1)/2 edges whose values count
shared hyperedges. Memory-prohibitive at scale, which is the point of
pseudo-projection; the tests use it on small graphs to check the query
paths.
"""

from __future__ import annotations

import numpy as np

from .layers import (
    LayerOneMode, LayerTwoMode, compact_layer, has_overlay,
    one_mode_from_edges,
)

__all__ = ["project_two_mode", "projection_nbytes"]


def project_two_mode(
    layer: LayerTwoMode, max_edges: int = 50_000_000
) -> LayerOneMode:
    """Materialize the one-mode projection (values = shared-hyperedge counts).

    Refuses projections above ``max_edges`` expanded pairs; a layer with
    a live overlay is folded first (``compact_layer``).
    """
    eq = layer.equivalent_projected_edges()
    if eq > max_edges:
        raise MemoryError(
            f"projection would materialize {eq:,} edges; "
            "use pseudo-projection queries instead"
        )
    if has_overlay(layer):
        layer = compact_layer(layer)
    device = layer.memb.device
    indptr = layer.members.indptr_host
    members = layer.members.indices.cpu().numpy()
    srcs, dsts = [], []
    for h in range(layer.n_hyperedges):
        nodes = members[indptr[h] : indptr[h + 1]]
        if nodes.size < 2:
            continue
        i, j = np.triu_indices(nodes.size, k=1)
        srcs.append(nodes[i])
        dsts.append(nodes[j])
    if not srcs:
        return one_mode_from_edges(
            layer.n_nodes, [], [], directed=False, device=device
        )
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    vals = np.ones(src.shape, dtype=np.float32)
    return one_mode_from_edges(
        layer.n_nodes, src, dst, values=vals,
        directed=False, sum_duplicates=True, device=device,
    )


def projection_nbytes(layer: LayerTwoMode, bytes_per_edge: int = 8) -> int:
    """Memory the materialized projection would need (paper Eq. 1 costing)."""
    return layer.equivalent_projected_edges() * bytes_per_edge
