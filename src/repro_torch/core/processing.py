"""Network transformations: symmetrize, dichotomize, filter, subnetworks.

Transformations are construction-time operations: they read a layer's
edges on the host (the CSR's host ``indptr`` mirror and a copy of its
ids and values), compute in numpy exactly as the JAX package does, and
rebuild the layer through the port's builders on the layer's device, so
identical inputs give byte-identical CSR buffers.
"""

from __future__ import annotations

import numpy as np

from .csr import CSR, to_numpy
from .layers import (
    LayerOneMode,
    LayerTwoMode,
    one_mode_from_edges,
    two_mode_from_memberships,
)

__all__ = [
    "symmetrize", "dichotomize", "filter_edges", "subgraph_layer",
    "induced_subnetwork",
]


def _coo(csr: CSR) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    rows = np.repeat(
        np.arange(csr.n_rows, dtype=np.int64), np.diff(csr.indptr_host)
    )
    cols = to_numpy(csr.indices).astype(np.int64)
    vals = None if csr.values is None else to_numpy(csr.values)
    return rows, cols, vals


def symmetrize(layer: LayerOneMode, method: str = "max") -> LayerOneMode:
    """Directed -> symmetric. method: 'max' | 'min' | 'sum' | 'or'.

    'or': binary union. 'min': keep only reciprocated ties (value = min).
    """
    rows, cols, vals = _coo(layer.out)
    if vals is None:
        vals = np.ones(rows.shape, dtype=np.float32)
    n = layer.out.n_rows
    both = np.concatenate([rows * n + cols, cols * n + rows])
    v2 = np.concatenate([vals, vals])
    order = np.argsort(both, kind="stable")
    both, v2 = both[order], v2[order]
    uniq, inv = np.unique(both, return_inverse=True)
    if method == "sum":
        agg = np.bincount(inv, weights=v2)
        # self-pairs got doubled by mirroring
        r, c = uniq // n, uniq % n
        agg = np.where(r == c, agg / 2, agg)
    elif method == "max" or method == "or":
        agg = np.full(uniq.shape, -np.inf)
        np.maximum.at(agg, inv, v2)
    elif method == "min":
        counts = np.bincount(inv)
        agg = np.full(uniq.shape, np.inf)
        np.minimum.at(agg, inv, v2)
        r, c = uniq // n, uniq % n
        keep = (counts == 2) | (r == c)
        uniq, agg = uniq[keep], agg[keep]
    else:
        raise ValueError(f"unknown symmetrize method {method!r}")
    r, c = uniq // n, uniq % n
    keep = r <= c  # one copy per undirected pair; the builder mirrors
    values = agg[keep].astype(np.float32) if layer.valued else None
    return one_mode_from_edges(
        n, r[keep], c[keep], values=values,
        directed=False, allow_self=layer.allow_self, device=layer.out.device,
    )


def dichotomize(
    layer: LayerOneMode, threshold: float = 0.0, op: str = "gt"
) -> LayerOneMode:
    """Valued -> binary: keep edges with value {gt|ge|lt|le} threshold."""
    rows, cols, vals = _coo(layer.out)
    if vals is None:
        vals = np.ones(rows.shape, dtype=np.float32)
    keep = {
        "gt": vals > threshold,
        "ge": vals >= threshold,
        "lt": vals < threshold,
        "le": vals <= threshold,
    }[op]
    rows, cols = rows[keep], cols[keep]
    if not layer.directed:
        m = rows <= cols
        rows, cols = rows[m], cols[m]
    return one_mode_from_edges(
        layer.out.n_rows, rows, cols, values=None,
        directed=layer.directed, allow_self=layer.allow_self,
        store_inbound=layer.store_inbound, device=layer.out.device,
    )


def filter_edges(layer: LayerOneMode, min_value: float) -> LayerOneMode:
    """Drop edges below min_value, keeping values (valued filter)."""
    rows, cols, vals = _coo(layer.out)
    if vals is None:
        raise ValueError("filter_edges requires a valued layer")
    keep = vals >= min_value
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    if not layer.directed:
        m = rows <= cols
        rows, cols, vals = rows[m], cols[m], vals[m]
    return one_mode_from_edges(
        layer.out.n_rows, rows, cols, values=vals,
        directed=layer.directed, allow_self=layer.allow_self,
        store_inbound=layer.store_inbound, device=layer.out.device,
    )


def _one_mode_subgraph(layer: LayerOneMode, keep_rows, new_id, n_new: int):
    rows, cols, vals = _coo(layer.out)
    keep = keep_rows[rows] & keep_rows[cols]
    rows, cols = new_id[rows[keep]], new_id[cols[keep]]
    vals = None if vals is None else vals[keep]
    if not layer.directed:
        m = rows <= cols
        rows, cols = rows[m], cols[m]
        vals = None if vals is None else vals[m]
    return one_mode_from_edges(
        n_new, rows, cols, values=vals,
        directed=layer.directed, allow_self=layer.allow_self,
        store_inbound=layer.store_inbound, device=layer.out.device,
    )


def induced_subnetwork(net, selection, orig_id_attr: str = "orig_id"):
    """Induced subnetwork over a selected nodeset (CLI ``subnetwork``):
    nodes are re-indexed compactly, every layer keeps only edges and
    memberships among selected nodes (two-mode: empty hyperedges dropped,
    hyperedge ids compacted), attribute columns are restricted and
    remapped, and the original ids are recorded as an int attribute
    (``orig_id_attr``; None skips it)."""
    from .network import Network, create_network
    from .nodeset import _sel_mask

    mask = _sel_mask(selection)
    if mask.shape[0] != net.n_nodes:
        raise ValueError(
            f"selection has {mask.shape[0]} entries, network has "
            f"{net.n_nodes} nodes"
        )
    old_ids = np.nonzero(mask)[0]
    n_new = int(old_ids.size)
    new_id = np.full(net.n_nodes, -1, dtype=np.int64)
    new_id[old_ids] = np.arange(n_new)

    ns = create_network(n_new, device=net.device).nodeset
    for aname, col in zip(net.nodeset.attrs.names, net.nodeset.attrs.columns):
        ids = to_numpy(col.node_ids)
        keep = mask[ids]
        ns = ns.set_attr(aname, col.kind, new_id[ids[keep]],
                         to_numpy(col.values)[keep])
    if orig_id_attr is not None:
        ns = ns.set_attr(
            orig_id_attr, "int", np.arange(n_new), old_ids.astype(np.int64)
        )
    sub = Network(nodeset=ns, layers=(), layer_names=())

    for lname, layer in zip(net.layer_names, net.layers):
        if isinstance(layer, LayerTwoMode):
            rows, cols, _ = _coo(layer.memb)
            keep = mask[rows]
            rows, cols = new_id[rows[keep]], cols[keep]
            live_h, cols = np.unique(cols, return_inverse=True)
            new_layer = two_mode_from_memberships(
                n_new, max(int(live_h.size), 1), rows, cols,
                device=layer.memb.device,
            )
        else:
            new_layer = _one_mode_subgraph(layer, mask, new_id, n_new)
        sub = sub.with_layer(lname, new_layer)
    return sub


def subgraph_layer(layer, node_mask: np.ndarray):
    """Restrict a layer to nodes where node_mask[i] is True (ids kept)."""
    node_mask = np.asarray(node_mask, dtype=bool)
    if isinstance(layer, LayerTwoMode):
        rows, cols, _ = _coo(layer.memb)
        keep = node_mask[rows]
        return two_mode_from_memberships(
            layer.n_nodes, layer.n_hyperedges, rows[keep], cols[keep],
            device=layer.memb.device,
        )
    return _one_mode_subgraph(layer, node_mask, np.arange(layer.n_nodes),
                              layer.n_nodes)
