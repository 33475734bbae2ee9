"""Script-style API mirroring the paper's command set: the point queries,
batched traversal (``khop``, ``egosample``) and component counts.

    nodes = createnodeset(createnodes=10_000_000)       # on the CUDA card
    net   = createnetwork(nodeset=nodes)
    net   = addlayer(net, "Random", mode=1)
    net   = generate(net, "Random", type="er", p=1e-6)
    checkedge(net, "Workplaces", 1_000_000, 5_000_000)

Functional like the JAX package: each mutation returns a new Network.
``createnodeset`` / ``createnetwork`` take ``device=None``, which means
the CUDA card, and raise when there is none; pass ``device="cpu"`` to
run on the CPU. Every later call follows the network's device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .csr import SENTINEL
from .generators import barabasi_albert, erdos_renyi, random_two_mode, watts_strogatz
from .layers import one_mode_from_edges, two_mode_empty
from .network import Network, create_network
from .nodeset import NodeSelection, Nodeset, create_nodeset
from .request import QueryRequest, merge_filter_kwargs, run_queries, run_query
from .traversal import components_batched

__all__ = [
    "createnodeset", "createnetwork", "addlayer", "generate",
    "checkedge", "getedge", "getnodealters", "getdegree",
    "setnodeattr", "selectnodes",
    "khop", "egosample", "countcomponents", "componentsfast",
]


def createnodeset(createnodes: int, device=None) -> Nodeset:
    return create_nodeset(createnodes, device=device)


def createnetwork(nodeset: Nodeset | int, device=None) -> Network:
    return create_network(nodeset, device=device)


def addlayer(
    net: Network, name: str, mode: int = 1, directed: bool = False,
    valued: bool = False, n_hyperedges: int = 1,
) -> Network:
    """An empty layer. ``valued=True`` gives a one-mode layer an (empty)
    values array, so it is valued; the JAX package drops ``valued`` and
    builds an unvalued layer (a departure on purpose, ROADMAP Queue 3)."""
    if mode == 2:
        return net.with_layer(
            name, two_mode_empty(net.n_nodes, n_hyperedges, device=net.device)
        )
    values = np.zeros(0, dtype=np.float32) if valued else None
    return net.with_layer(
        name,
        one_mode_from_edges(
            net.n_nodes, [], [], values=values, directed=directed,
            device=net.device,
        ),
    )


def generate(net: Network, name: str, type: str, seed: int = 0, **params) -> Network:
    """Fill a layer with a random graph: type in {er, ws, ba, 2mode}."""
    n = net.n_nodes
    dev = net.device
    if type == "er":
        layer = erdos_renyi(n, p=params["p"], seed=seed, device=dev)
    elif type == "ws":
        layer = watts_strogatz(
            n, k=params["k"], beta=params["beta"], seed=seed, device=dev
        )
    elif type == "ba":
        layer = barabasi_albert(n, m=params["m"], seed=seed, device=dev)
    elif type == "2mode":
        layer = random_two_mode(
            n, h=params["h"], a=params["a"], seed=seed, device=dev
        )
    else:
        raise ValueError(f"unknown generator type {type!r}")
    return net.with_layer(name, layer)


def checkedge(net: Network, layer: str, u, v, filter=None, node_filter=None):
    """Edge existence (pseudo-projected for two-mode layers).

    ``filter`` restricts targets: False whenever v fails the filter.
    (``node_filter=`` is a deprecated alias.)
    """
    filter = merge_filter_kwargs(filter, node_filter)
    out = net.check_edge_any(u, v, [layer], node_filter=filter)
    return bool(out[0]) if out.shape == (1,) else out


def getedge(net: Network, layer: str, u, v, filter=None):
    """Edge value (pseudo-projected co-membership count for two-mode).

    One :class:`QueryRequest` per pair, run through the shared request
    engine (pairs sharing layer and filter run as one batch).
    """
    un = np.atleast_1d(np.asarray(u, dtype=np.int64))
    vn = np.atleast_1d(np.asarray(v, dtype=np.int64))
    un, vn = np.broadcast_arrays(un, vn)
    vals = run_queries(net, [
        QueryRequest.getedge(layer, int(a), int(b), filter=filter)
        for a, b in zip(un, vn)
    ])
    if len(vals) == 1:
        return float(vals[0])
    return torch.from_numpy(np.asarray(vals, dtype=np.float32))


def getnodealters(
    net: Network, u, layernames: Sequence[str] | None = None,
    max_alters: int = 4096, filter=None, node_filter=None,
):
    """Alters of u across layers; ``filter`` (NodeSelection / bool mask /
    attr spec) keeps only alters passing an attribute predicate.
    (``node_filter=`` is a deprecated alias.)

    Routed through :class:`QueryRequest` per query node; the padded batch
    form is rebuilt from the per-node sorted alter lists.
    """
    filter = merge_filter_kwargs(filter, node_filter)
    ids = np.atleast_1d(np.asarray(u, dtype=np.int64))
    layers = None if layernames is None else list(layernames)
    rows = run_queries(net, [
        QueryRequest.alters(int(i), layers=layers, max_alters=int(max_alters),
                            filter=filter)
        for i in ids
    ])
    if ids.size == 1:
        return torch.from_numpy(np.asarray(rows[0], dtype=np.int32))
    vals = np.full((ids.size, int(max_alters)), int(SENTINEL), np.int32)
    mask = np.zeros((ids.size, int(max_alters)), bool)
    for i, r in enumerate(rows):
        r = np.asarray(r, dtype=np.int32)
        vals[i, : r.size] = r
        mask[i, : r.size] = True
    return torch.from_numpy(vals), torch.from_numpy(mask)


def getdegree(
    net: Network, u, layernames: Sequence[str] | None = None, filter=None,
    node_filter=None,
):
    """Per-node degree; with ``filter`` the filtered alter count (see
    Network.degree). (``node_filter=`` is a deprecated alias.)"""
    filter = merge_filter_kwargs(filter, node_filter)
    ids = np.atleast_1d(np.asarray(u, dtype=np.int64))
    layers = None if layernames is None else list(layernames)
    out = run_query(net, QueryRequest.degree(
        [int(i) for i in ids], layers=layers, filter=filter
    ))
    if ids.size == 1:
        return int(out) if np.isscalar(out) or np.ndim(out) == 0 else int(out[0])
    return np.asarray(out)


def countcomponents(
    net: Network, layernames: Sequence[str] | None = None, filter=None,
    node_filter=None,
) -> int:
    """Component count; ``filter`` restricts to the induced selection
    (filtered-out nodes count as singletons). (``node_filter=`` is a
    deprecated alias.)

    The JAX package goes through ``analysis.connected_components``, which
    only delegates to ``components_batched``; ``analysis.py`` is not
    ported yet (ROADMAP Queue 1 item 7), so this calls it directly.
    """
    filter = merge_filter_kwargs(filter, node_filter)
    labels = components_batched(net, layernames, node_filter=filter)
    return int(torch.unique(labels).numel())


def componentsfast(
    net: Network, layernames: Sequence[str] | None = None, filter=None,
    node_filter=None,
) -> int:
    """CLI ``componentsfast``: filter-aware component count, the same as
    ``countcomponents``. (``node_filter=`` is a deprecated alias.)"""
    filter = merge_filter_kwargs(filter, node_filter)
    return countcomponents(net, layernames, filter=filter)


# ---------------------------------------------------------------------------
# Batched traversal (core/traversal.py)
# ---------------------------------------------------------------------------


def khop(
    net: Network, sources, k: int,
    layernames: Sequence[str] | None = None,
    max_frontier: int | None = None, filter=None, node_filter=None,
) -> list[dict]:
    """CLI ``khop``: k-hop neighborhoods for a batch of sources.

    Returns one record per source: ``{"source", "count", "nodes", "hops"}``
    with ``nodes`` the reached ids (source excluded) grouped by hop order
    and ``hops`` the matching hop index per id. Routed through
    :class:`QueryRequest`. (``node_filter=`` is a deprecated alias.)
    """
    filter = merge_filter_kwargs(filter, node_filter)
    src = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    layers = None if layernames is None else list(layernames)
    return run_query(net, QueryRequest.khop(
        [int(s) for s in src], int(k), layers=layers,
        max_frontier=None if max_frontier is None else int(max_frontier),
        filter=filter,
    ))


def egosample(
    net: Network, egos, max_alters: int = 4096, k: int = 1,
    layernames: Sequence[str] | None = None, filter=None, node_filter=None,
) -> list[list[int]]:
    """CLI ``egosample``: batched (k-hop) ego networks, one sorted-unique
    alter list per ego. (``node_filter=`` is a deprecated alias.)"""
    filter = merge_filter_kwargs(filter, node_filter)
    ids = np.atleast_1d(np.asarray(egos, dtype=np.int64))
    vals, mask = net.ego_batch(
        ids.astype(np.int32), int(max_alters), k=int(k),
        layer_names=layernames, node_filter=filter,
    )
    vals, mask = vals.cpu().numpy(), mask.cpu().numpy()
    return [vals[i][mask[i]].tolist() for i in range(ids.size)]


# ---------------------------------------------------------------------------
# Attribute manager + node selections
# ---------------------------------------------------------------------------

_KIND_OF_PYTYPE = {bool: "bool", int: "int", float: "float"}


def _infer_kind(values) -> str:
    v = values[0] if isinstance(values, (list, tuple)) else values
    if isinstance(v, str):
        if len(v) == 1:
            return "char"
        raise ValueError(f"cannot infer attribute kind from string {v!r}")
    for py, kind in _KIND_OF_PYTYPE.items():
        if isinstance(v, py):
            return kind
    arr = np.asarray(values)
    if arr.dtype == np.bool_:
        return "bool"
    return "int" if np.issubdtype(arr.dtype, np.integer) else "float"


def _coerce_attr_values(kind: str, values):
    vals = values if isinstance(values, (list, tuple, np.ndarray)) else [values]
    if kind == "char":
        vals = [ord(v) if isinstance(v, str) else int(v) for v in vals]
    return np.asarray(vals)


def setnodeattr(
    net: Network, name: str, nodes, values, kind: str | None = None
) -> Network:
    """Set attribute values for one or many nodes (sparse upsert).

    ``kind`` defaults to the existing column's kind, else is inferred from
    the value type (bool / int / float / 1-char string).
    """
    ns = net.nodeset
    ids = np.atleast_1d(np.asarray(nodes, dtype=np.int64))
    if kind is None:
        kind = (
            ns.attrs.column(name).kind if name in ns.attrs.names
            else _infer_kind(values)
        )
    vals = _coerce_attr_values(kind, values)
    vals = np.broadcast_to(vals, ids.shape)
    if name in ns.attrs.names:
        col = ns.attrs.column(name)
        if col.kind != kind:
            raise ValueError(
                f"attribute {name!r} is {col.kind!r}, got kind={kind!r}"
            )
        old_ids = col.node_ids.cpu().numpy()
        old_vals = col.values.cpu().numpy()
        ids = np.concatenate([old_ids, ids])
        vals = np.concatenate([old_vals, vals.astype(old_vals.dtype)])
    return net.with_nodeset(ns.set_attr(name, kind, ids, vals))


def selectnodes(net: Network, name: str, op: str, value=None) -> NodeSelection:
    """Vectorized attribute predicate -> NodeSelection."""
    return net.nodeset.select(name, op, value)
