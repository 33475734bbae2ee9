"""Script-style API mirroring the paper's command set: the point queries,
batched traversal (``khop``, ``egosample``), walk fleets and node samples,
degree, density, path, component and memory reports, attributes, layers
and subnetworks, files (npz and TSV), edge mutation and the durable store
(WAL + snapshots).

    nodes = createnodeset(createnodes=10_000_000)       # on the CUDA card
    net   = createnetwork(nodeset=nodes)
    net   = addlayer(net, "Random", mode=1)
    net   = generate(net, "Random", type="er", p=1e-6)
    checkedge(net, "Workplaces", 1_000_000, 5_000_000)

Functional like the JAX package: each mutation returns a new Network.
``createnodeset`` / ``createnetwork`` take ``device=None``, which means
the CUDA card, and raise when there is none; pass ``device="cpu"`` to
run on the CPU. Every later call follows the network's device;
``loadfile`` and ``recovernet`` take ``device=`` as the builders do. The
serving calls (``serve``, ``servenet``, ``pingnet``) are not ported yet
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .analysis import (
    attribute_summary,
    connected_components,
    degree_distribution,
    density as layer_density,
    shortest_path_length,
)
from .csr import DEFAULT_POLICY, POLICY_INT32, SENTINEL
from .generators import barabasi_albert, erdos_renyi, random_two_mode, watts_strogatz
from .io import (
    IMPORT_CHUNK_ROWS,
    export_layer_tsv,
    import_layer_tsv,
    load_attrs_tsv,
    load_network,
    save_network,
)
from .layers import (
    LayerTwoMode,
    add_edges,
    delete_edges,
    one_mode_from_edges,
    two_mode_empty,
)
from .memory import memory_report
from .network import Network, create_network
from .nodeset import NodeSelection, Nodeset, create_nodeset
from .processing import induced_subnetwork
from .request import QueryRequest, merge_filter_kwargs, run_queries, run_query

__all__ = [
    "createnodeset", "createnetwork", "addlayer", "generate",
    "checkedge", "getedge", "getnodealters", "shortestpath", "memoryreport",
    "savefile", "loadfile",
    # attribute manager + selections
    "setnodeattr", "getnodeattr", "dropattr", "listattrs", "loadattrs",
    "selectnodes", "countnodes", "attributesummary",
    # degree / structure queries
    "getdegree", "degreedist", "getdensity", "countcomponents",
    # batched traversal and sampling
    "khop", "egosample", "walkbatch", "componentsfast", "samplenodes",
    # typed query currency (core/request.py) + one-shot execution
    "QueryRequest", "runquery",
    # serving (not ported yet: raise NotImplementedError)
    "serve", "servenet", "pingnet",
    # container surface
    "listlayers", "deletelayer", "describenet", "exportlayer",
    "importlayer", "subnetwork",
    # durability: batched edge mutation + store save/recover/log
    "addedges", "deleteedges", "savestore", "recovernet", "wallog",
]

UNPORTED = "ROADMAP Queue 1 item 11"


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


def shortestpath(
    net: Network, u: int, v: int, layernames: Sequence[str] | None = None
) -> int:
    return shortest_path_length(net, u, v, layernames)


def memoryreport(net: Network):
    return memory_report(net)


def savefile(obj: Network, file: str, compress: bool = True) -> None:
    save_network(obj, file, compress=compress)


def loadfile(file: str, mmap: bool = False, device=None) -> Network:
    """Load an npz network onto ``device`` (``None``: the CUDA card)."""
    return load_network(file, mmap=mmap, device=device)


def degreedist(
    net: Network, layernames: Sequence[str] | None = None, filter=None,
    node_filter=None,
) -> list[list[int]]:
    """Degree histogram -> [[degree, count], ...] ascending (CLI table).
    (``node_filter=`` is a deprecated alias for ``filter=``.)"""
    filter = merge_filter_kwargs(filter, node_filter)
    degs, counts = degree_distribution(net, layernames, node_filter=filter)
    return [[int(d), int(c)] for d, c in zip(degs, counts)]


def getdensity(net: Network, layer: str) -> float:
    return layer_density(net.layer(layer))


def countcomponents(
    net: Network, layernames: Sequence[str] | None = None, filter=None,
    node_filter=None,
) -> int:
    """Component count; ``filter`` restricts to the induced selection
    (filtered-out nodes count as singletons). (``node_filter=`` is a
    deprecated alias.)"""
    filter = merge_filter_kwargs(filter, node_filter)
    labels = connected_components(net, layernames, node_filter=filter)
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


def walkbatch(
    net: Network, starts, steps: int, walkers: int = 1, seed: int = 0,
    layernames: Sequence[str] | None = None,
    layer_weights: Sequence[float] | None = None, filter=None,
    node_filter=None,
) -> list[list[int]]:
    """CLI ``walkbatch``: a walk fleet — ``walkers`` walkers per start
    node, one path row each (see traversal.random_walk_batch), drawn from
    ``prng.key(seed)``. Routed through :class:`QueryRequest`.
    (``node_filter=`` is a deprecated alias.)"""
    filter = merge_filter_kwargs(filter, node_filter)
    ids = np.atleast_1d(np.asarray(starts, np.int64))
    layers = None if layernames is None else list(layernames)
    paths = run_query(net, QueryRequest.walkbatch(
        [int(s) for s in ids], int(steps), walkers=int(walkers),
        seed=int(seed), layers=layers,
        layer_weights=None if layer_weights is None else list(layer_weights),
        filter=filter,
    ))
    return np.asarray(paths).tolist()


def runquery(net: Network, request):
    """Execute one :class:`QueryRequest` (or trace-schema dict) against
    ``net`` -- the no-queue, no-cache reference path."""
    return run_query(net, QueryRequest.from_any(request))


# ---------------------------------------------------------------------------
# Serving (serve/ of the JAX package): not ported yet
# ---------------------------------------------------------------------------


def serve(net: Network, trace, **kw):
    raise NotImplementedError(f"serve is not ported yet ({UNPORTED})")


def servenet(net: Network, **kw):
    raise NotImplementedError(f"servenet is not ported yet ({UNPORTED})")


def pingnet(host: str, port: int, **kw):
    raise NotImplementedError(f"pingnet is not ported yet ({UNPORTED})")


def samplenodes(
    net: Network, n: int, seed: int = 0,
    selection: NodeSelection | None = None,
) -> np.ndarray:
    """Uniform node-id sample (without replacement when possible); with
    ``selection``, samples only selected nodes. Host numpy, as in the JAX
    package (``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    pool = selection.ids() if selection is not None else net.n_nodes
    pool_size = len(pool) if selection is not None else pool
    n = int(n)
    if pool_size == 0:
        return np.zeros(0, np.int64)
    replace = n > pool_size
    return np.sort(rng.choice(pool, size=n, replace=replace).astype(np.int64))


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


def getnodeattr(net: Network, name: str, nodes):
    """CLI ``getattr`` -> (values, has_mask) numpy arrays."""
    vals, has = net.nodeset.get_attr(name, net._batch(np.atleast_1d(nodes)))
    return vals.cpu().numpy(), has.cpu().numpy()


def loadattrs(
    net: Network, file: str, name: str | None = None, kind: str | None = None
) -> Network:
    """CLI ``loadattrs``: sparse TSV attribute import (see io.load_attrs_tsv)."""
    ns = net.nodeset
    for aname, akind, ids, vals in load_attrs_tsv(file, name=name, kind=kind):
        ns = ns.set_attr(aname, akind, ids, vals)
    return net.with_nodeset(ns)


def dropattr(net: Network, name: str) -> Network:
    return net.with_nodeset(net.nodeset.drop_attr(name))


def listattrs(net: Network) -> list[dict]:
    return [
        {"name": n, "kind": c.kind, "n_set": c.n_set}
        for n, c in zip(net.nodeset.attrs.names, net.nodeset.attrs.columns)
    ]


def selectnodes(net: Network, name: str, op: str, value=None) -> NodeSelection:
    """Vectorized attribute predicate -> NodeSelection."""
    return net.nodeset.select(name, op, value)


def countnodes(net: Network, selection: NodeSelection | None = None) -> int:
    if selection is None:
        return net.n_nodes
    return selection.count


def attributesummary(net: Network, name: str) -> dict:
    return attribute_summary(net, name)


# ---------------------------------------------------------------------------
# Container surface
# ---------------------------------------------------------------------------


def listlayers(net: Network) -> list[dict]:
    return [
        {
            "name": name,
            "mode": layer.mode,
            "edges": (
                layer.n_memberships if isinstance(layer, LayerTwoMode)
                else layer.n_edges
            ),
        }
        for name, layer in zip(net.layer_names, net.layers)
    ]


def deletelayer(net: Network, name: str) -> Network:
    return net.without_layer(name)


def describenet(net: Network) -> dict:
    """One-call structural summary (CLI ``describenet``); bytes are the
    tensors' bytes, wherever they lie."""
    return {
        "n_nodes": net.n_nodes,
        "n_layers": len(net.layers),
        "total_bytes": net.nbytes,
        "layers": [
            {
                "name": name,
                "mode": layer.mode,
                "bytes": layer.nbytes,
                **(
                    {
                        "memberships": layer.n_memberships,
                        "hyperedges": layer.n_hyperedges,
                        "equivalent_projected_edges":
                            layer.equivalent_projected_edges(),
                    }
                    if isinstance(layer, LayerTwoMode)
                    else {"edges": layer.n_edges, "directed": layer.directed}
                ),
            }
            for name, layer in zip(net.layer_names, net.layers)
        ],
        "attrs": listattrs(net),
    }


def subnetwork(net: Network, selection) -> Network:
    """CLI ``subnetwork``: induced subgraph over a NodeSelection, with
    compacted node ids and an ``orig_id`` attribute back-reference."""
    return induced_subnetwork(net, selection)


def exportlayer(net: Network, layer: str, file: str) -> None:
    export_layer_tsv(net, layer, file)


def importlayer(
    net: Network, name: str, file: str, mode: int = 1,
    directed: bool = False, valued: bool = False,
    n_hyperedges: int | None = None, default_value: float | None = None,
    chunk_rows: int | None = None, narrow: bool = True,
) -> Network:
    layer = import_layer_tsv(
        file, net.n_nodes, mode=mode, directed=directed, valued=valued,
        n_hyperedges=n_hyperedges, default_value=default_value,
        chunk_rows=IMPORT_CHUNK_ROWS if chunk_rows is None else chunk_rows,
        policy=DEFAULT_POLICY if narrow else POLICY_INT32, device=net.device,
    )
    return net.with_layer(name, layer)


# ---------------------------------------------------------------------------
# Durability: edge mutation, store save / recover / log
# ---------------------------------------------------------------------------


def addedges(net: Network, layer: str, src, dst, values=None) -> Network:
    """CLI ``addedges``: batched edge/membership insert (upsert on dupes)."""
    return net.with_layer(layer, add_edges(net.layer(layer), src, dst,
                                           values=values))


def deleteedges(net: Network, layer: str, src, dst) -> Network:
    """CLI ``deleteedges``: batched edge/membership delete (missing pairs
    are ignored)."""
    return net.with_layer(layer, delete_edges(net.layer(layer), src, dst))


def savestore(net: Network, dir: str) -> dict:
    """CLI ``savestore``: seed a durable store directory (snapshot + WAL)
    from ``net``; later mutations go through ``snapshot.DurableStore``."""
    from .snapshot import DurableStore

    store = DurableStore.create(dir, net)
    store.close()
    return {"dir": str(dir), "last_lsn": store.last_lsn}


def recovernet(dir: str, device=None) -> tuple[Network, dict]:
    """CLI ``recovernet``: rebuild a network on ``device`` from a durable
    store directory (latest intact snapshot + WAL tail replay) ->
    (net, recovery info)."""
    from .snapshot import recover

    net, info = recover(dir, device=device)
    return net, {
        "snapshot_lsn": info.snapshot_lsn, "replayed": info.replayed,
        "last_lsn": info.last_lsn,
        "snapshots_skipped": info.snapshots_skipped,
        "torn_bytes": info.torn_bytes,
    }


def wallog(dir: str, after: int = -1) -> list[dict]:
    """CLI ``wallog``: summarize the durable store's WAL records (lsn, op,
    and the op's key fields -- payload arrays reported as counts)."""
    from pathlib import Path

    from .snapshot import WAL_NAME
    from .wal import scan

    records, _, torn = scan(Path(dir) / WAL_NAME)
    out = []
    for r in records:
        if r.lsn <= after:
            continue
        entry = {"lsn": r.lsn, "op": r.op.get("op")}
        for key in ("name", "layer", "kind", "mode", "directed"):
            if r.op.get(key) is not None:
                entry[key] = r.op[key]
        for key in ("nodes", "src", "dst", "values"):
            if isinstance(r.op.get(key), list):
                entry[f"n_{key}"] = len(r.op[key])
        out.append(entry)
    if torn:
        out.append({"lsn": None, "op": "!torn-tail"})
    return out
