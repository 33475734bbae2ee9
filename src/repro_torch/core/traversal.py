"""Batched multi-source traversal over the pseudo-projection, in PyTorch.

Port of the JAX package's ``core/traversal.py``, the engine side of
threadleR's traversal-based analyses: thousands of sources per call.

* ``khop_neighborhood`` — frontier-based k-hop BFS for B sources at once.
  Each hop dedups the frontier across the whole batch on the host (a hub
  reached from hundreds of sources is expanded once), pushes the unique
  nodes through the degree-bucketed ``node_alters`` dispatch, scatters the
  alters back per source, and compacts the next frontier with
  ``kernels/ops.py::frontier_compact`` (the CUDA frontier kernel on the
  card): the sorted first occurrence of every candidate not yet visited.
* ``khop_records`` — the client-facing record per source.
* ``ego_batch`` — batched ego networks: sorted-unique k-hop alters.
* ``random_walk_batch`` — walk fleets: W walkers per start, one host loop
  over steps; each step's keys are split on the host and its row samples
  run in the threefry row-sample kernel, so paths equal the JAX package's
  bit for bit for the same key.
* ``components_batched`` — min-label propagation with pointer jumping;
  two-mode layers propagate through hyperedge labels without projecting.

PyTorch runs eagerly, so every source batch is concrete: per-node gather
widths come from exact host bounds (``dispatch.alters_bound``) unless the
caller passes ``max_alters_per_node``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import dispatch, prng
from .csr import SENTINEL, take_clip, to_numpy
from .layers import LayerTwoMode
from .overlay import eff_edge_stream, eff_nnz
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.frontier import MAX_CAND

__all__ = [
    "khop_neighborhood",
    "khop_records",
    "ego_batch",
    "random_walk_batch",
    "components_batched",
]

# Default per-hop frontier cap when the caller does not pass one.
DEFAULT_MAX_FRONTIER = 4096
# Flat-width budget for one hop-expansion gather: frontiers are processed
# in slot chunks so each (B, slots * cap) candidate row fits the frontier
# kernel. The JAX package uses 65,536; here it is the kernel's capacity,
# 32,768 (the in-block sort's 1,024 threads x 32 keys).
MAX_CAND_FLAT = MAX_CAND
# Widest candidate row the frontier kernel takes (32,768); wider rows (a
# single node's cap above it) take the counted plain path.
FRONTIER_KERNEL_MAX = MAX_CAND

_SENT = int(SENTINEL)
_INF = 2**31 - 1


def _hop_cap(
    net, frontier: np.ndarray, layer_names, max_alters_per_node: int | None
) -> int:
    """Per-node alter width for this hop's gathers: ``max_alters_per_node``
    when given, else the exact host bound over the frontier's nodes."""
    if max_alters_per_node is not None:
        return max(int(max_alters_per_node), 1)
    flat = frontier.reshape(-1).astype(np.int64)
    real = flat[flat != _SENT]
    if real.size == 0:
        return 1
    return dispatch.alters_bound(net._select(layer_names), real, net.n_nodes)


def _frontier_alters(
    net, frontier: np.ndarray, layer_names, nf, cap: int
) -> torch.Tensor:
    """Alters of every frontier slot -> candidate rows int32[B, F*cap].

    ``frontier`` is the host copy of int32[B, F], SENTINEL-padded. The
    batch is deduped first: the bucketed dispatch sees each distinct
    frontier node once, however many sources reached it this hop.
    """
    B, F = frontier.shape
    device = net.device
    flat = frontier.reshape(-1).astype(np.int64)
    real = flat != _SENT
    un = np.unique(flat[real])
    if un.size == 0:
        return torch.full((B, F), _SENT, dtype=torch.int32, device=device)
    alters, _ = net.node_alters(
        un.astype(np.int32), cap, layer_names, node_filter=nf
    )
    pos = np.searchsorted(un, np.where(real, flat, un[0]))
    cand = alters[torch.from_numpy(pos).to(device)]
    cand = torch.where(torch.from_numpy(real).to(device)[:, None], cand, _SENT)
    return cand.reshape(B, F * cap)


def _compact(
    cand: torch.Tensor, visited_sorted: torch.Tensor, max_out: int,
    use_kernel: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk's next frontier. Rows wider than the kernel's capacity
    take the plain path and are counted; ``use_kernel=False`` takes it for
    every row (the plain reference)."""
    if use_kernel and cand.shape[-1] <= FRONTIER_KERNEL_MAX:
        return kops.frontier_compact(
            cand, visited_sorted, max_out, visited_sorted=True
        )
    if use_kernel:
        launch_counts["frontier_sort_rows"] += int(cand.shape[0])
    return kref.frontier_search_ref(cand, visited_sorted, max_out)


def khop_neighborhood(
    net,
    sources,
    k: int,
    *,
    max_frontier: int | None = None,
    max_alters_per_node: int | None = None,
    layer_names: Sequence[str] | None = None,
    node_filter=None,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched k-hop neighborhoods -> (nodes, mask, hop_of_slot).

    ``nodes`` is int32[B, 1 + k*max_frontier]: slot 0 is the source, then
    k groups of ``max_frontier`` slots, group h holding the (sorted,
    SENTINEL-padded) nodes first reached at hop h. ``mask`` flags valid
    slots; ``hop_of_slot`` is int32[1 + k*max_frontier] giving each slot's
    hop index (identical for every source row).

    ``max_frontier`` caps each hop's per-source frontier (capped hops keep
    the ``max_frontier`` smallest new ids). ``node_filter``
    (NodeSelection / bool[n_nodes]) restricts expansion to selected
    alters; sources are always included. ``use_kernel=False`` compacts
    and merges with the plain torch paths (the reference on the card).
    """
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    src = net._batch(sources)
    if src.dim() != 1:
        raise ValueError(f"sources must be a vector, got shape {tuple(src.shape)}")
    B = src.shape[0]
    device = net.device
    nf = net._filter(node_filter)
    if max_frontier is None:
        max_frontier = min(net.n_nodes, DEFAULT_MAX_FRONTIER)
    max_frontier = max(int(max_frontier), 1)

    hop_of_slot = np.concatenate(
        [np.zeros(1, np.int32)]
        + [np.full(max_frontier, h, np.int32) for h in range(1, k + 1)]
    )
    visited = src[:, None]
    frontier = src[:, None]
    groups = [frontier]
    masks = [torch.ones((B, 1), dtype=torch.bool, device=device)]
    done_at = k  # hops actually expanded (early exit on an empty frontier)
    for h in range(1, k + 1):
        fh = to_numpy(frontier)
        # frontiers are sorted with SENTINEL pads last: slice to the
        # batch's max occupancy, rounded up to a power of two, before the
        # expansion (typical frontiers fill a fraction of max_frontier)
        if fh.shape[1] > 1:
            used = int((fh != _SENT).sum(axis=1).max())
            fw = 1
            while fw < used:
                fw <<= 1
            fh = fh[:, : min(fw, fh.shape[1])]
        cap = _hop_cap(net, fh, layer_names, max_alters_per_node)
        # slot chunks keep each candidate row within MAX_CAND_FLAT; their
        # frontiers merge through union_rows, bit-identical to one shot
        # (each chunk keeps its smallest new ids, and the union of those
        # holds the hop's smallest max_frontier ids)
        F = fh.shape[1]
        step = max(1, min(F, MAX_CAND_FLAT // cap))
        visited_hop = torch.sort(visited, dim=-1).values  # once per hop
        parts = [
            _compact(
                _frontier_alters(net, fh[:, lo : lo + step], layer_names, nf, cap),
                visited_hop, max_frontier, use_kernel,
            )
            for lo in range(0, F, step)
        ]
        if len(parts) == 1:
            frontier, fmask = parts[0]
        else:
            frontier, fmask = dispatch.union_rows(
                torch.cat([p[0] for p in parts], dim=-1),
                torch.cat([p[1] for p in parts], dim=-1),
                max_frontier, use_kernel=use_kernel,
            )
        groups.append(frontier)
        masks.append(fmask)
        visited = torch.cat([visited, frontier], dim=-1)
        if not bool(fmask.any()):
            done_at = h
            break
    pad = (k - done_at) * max_frontier
    nodes = torch.cat(groups, dim=-1)
    mask = torch.cat(masks, dim=-1)
    if pad:
        nodes = torch.nn.functional.pad(nodes, (0, pad), value=_SENT)
        mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    return nodes, mask, torch.from_numpy(hop_of_slot).to(device)


def khop_records(sources, nodes, mask, hop_of_slot) -> list[dict]:
    """``khop_neighborhood`` output -> one client-facing record per source:
    ``{"source", "count", "nodes", "hops"}`` with the source slot dropped."""
    nodes, mask, hops = (
        to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (nodes, mask, hop_of_slot)
    )
    out = []
    for i, s in enumerate(np.asarray(sources).reshape(-1)):
        keep = mask[i] & (hops > 0)  # drop the source slot
        out.append({
            "source": int(s),
            "count": int(keep.sum()),
            "nodes": nodes[i][keep].tolist(),
            "hops": hops[keep].tolist(),
        })
    return out


def ego_batch(
    net,
    egos,
    max_alters: int,
    *,
    k: int = 1,
    max_alters_per_node: int | None = None,
    layer_names: Sequence[str] | None = None,
    node_filter=None,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ego-network extraction -> (int32[B, max_alters], dedup mask).

    The k-hop alter set of each ego (ego excluded), sorted-unique and
    SENTINEL-padded. ``k=1`` is the multilayer ``node_alters`` union;
    ``k>1`` runs the frontier-based BFS with per-hop cap ``max_alters``
    and merges the hop groups.
    """
    egos = net._batch(egos)
    nf = net._filter(node_filter)
    if k == 1:
        return net.node_alters(egos, max_alters, layer_names, node_filter=nf)
    nodes, mask, _ = khop_neighborhood(
        net, egos, k, max_frontier=max_alters,
        max_alters_per_node=max_alters_per_node, layer_names=layer_names,
        node_filter=nf, use_kernel=use_kernel,
    )
    return dispatch.union_rows(
        nodes[:, 1:], mask[:, 1:], max_alters, use_kernel=use_kernel
    )


def walk_keys(key, n_steps: int) -> list[tuple[prng.Key, prng.Key]]:
    """The (layer-choice, step) keys of each of ``n_steps`` walk steps:
    the JAX scan's ``kk, k_layer, k_step = split(kk, 3)``, on the host."""
    out = []
    for _ in range(n_steps):
        key, k_layer, k_step = prng.split(key, 3)
        out.append((k_layer, k_step))
    return out


def random_walk_batch(
    net,
    start_nodes,
    n_steps: int,
    key,
    *,
    walkers_per_start: int = 1,
    layer_names: Sequence[str] | None = None,
    layer_weights: Sequence[float] | None = None,
    node_filter=None,
) -> torch.Tensor:
    """Walk fleet -> int32[B * walkers_per_start, n_steps + 1].

    Walker w of start b is row ``b * walkers_per_start + w``; all walkers
    advance together, one step per pass of a host loop (the JAX package's
    ``lax.scan``) with the step's keys split on the host (``walk_keys``).
    Each walker picks a layer per step from the normalized
    ``layer_weights`` (``prng.categorical``), every selected layer takes a
    step under its own key of ``split(k_step, n_layers)`` and the chosen
    layer's step is kept. ``node_filter`` rejects moves into filtered-out
    nodes (the walker stays put, as at a dangling node). Start nodes are
    emitted as they are, even when they fail the filter. ``key`` is a
    ``core/prng.py`` key; paths equal the JAX package's for the same key.
    """
    from .walks import _layer_logits

    layers = net._select(layer_names)
    logits = _layer_logits(len(layers), layer_weights).to(net.device)
    nf = net._filter(node_filter)
    if walkers_per_start < 1:
        raise ValueError(
            f"walkers_per_start must be >= 1, got {walkers_per_start}"
        )
    start = torch.repeat_interleave(net._batch(start_nodes), walkers_per_start)
    path = torch.empty((n_steps + 1, start.shape[0]), dtype=torch.int32,
                       device=net.device)
    path[0] = start
    u = start
    for t, (k_layer, k_step) in enumerate(walk_keys(key, n_steps)):
        if len(layers) == 1:
            v = layers[0].sample_neighbor(u, k_step)[0]
        else:
            choice = prng.categorical(k_layer, logits, u.shape)
            keys = prng.split(k_step, len(layers))
            candidates = torch.stack(
                [layer.sample_neighbor(u, kx)[0] for layer, kx in zip(layers, keys)]
            )
            v = torch.gather(candidates, 0, choice[None].long())[0]
        if nf is not None:
            v = torch.where(take_clip(nf, v), v, u)
        path[t + 1] = v
        u = v
    return path.T.contiguous()


def component_streams(layers) -> list[tuple]:
    """Each layer's effective (row, col) streams as int64 scatter indices,
    the input of ``propagate_labels``: ``(n_hyperedges, memb rows, memb
    cols, member rows, member cols)`` for a two-mode layer, ``(None, rows,
    cols, None, None)`` for a one-mode one; empty layers are left out.
    Min-label scatters are order-independent, so overlay streams give the
    labels of the rebuilt layer."""
    prep = []
    for layer in layers:
        if isinstance(layer, LayerTwoMode):
            if eff_nnz(layer.memb, layer.memb_ov):
                mrows, mcols = eff_edge_stream(layer.memb, layer.memb_ov)
                hrows, hcols = eff_edge_stream(layer.members, layer.members_ov)
                prep.append((layer.n_hyperedges, mrows.long(), mcols.long(),
                             hrows.long(), hcols.long()))
        elif eff_nnz(layer.out, layer.out_ov):
            rows, cols = eff_edge_stream(layer.out, layer.out_ov)
            prep.append((None, rows.long(), cols.long(), None, None))
    return prep


def propagate_labels(prep: list[tuple], labels: torch.Tensor,
                     nf: torch.Tensor | None) -> torch.Tensor:
    """One min-label propagation pass over ``component_streams``' layers,
    in place on ``labels`` (two-mode layers through hyperedge labels);
    nodes failing ``nf`` neither send nor receive."""
    for n_he, rows, cols, hrows, hcols in prep:
        if n_he is None:
            src_lab = labels[rows]
            dst_lab = labels[cols]
            if nf is not None:
                live = nf[rows] & take_clip(nf, cols)
                src_lab = torch.where(live, src_lab, _INF)
                dst_lab = torch.where(live, dst_lab, _INF)
            labels.scatter_reduce_(0, cols, src_lab, "amin")
            labels.scatter_reduce_(0, rows, dst_lab, "amin")
        else:
            mem_lab = labels[hcols]
            if nf is not None:
                mem_lab = torch.where(take_clip(nf, hcols), mem_lab, _INF)
            he = torch.full((n_he,), _INF, dtype=torch.int32, device=labels.device)
            he.scatter_reduce_(0, hrows, mem_lab, "amin")
            node_min = he[cols]
            if nf is not None:
                node_min = torch.where(take_clip(nf, rows), node_min, _INF)
            labels.scatter_reduce_(0, rows, node_min, "amin")
    return labels


def components_batched(
    net,
    layer_names: Sequence[str] | None = None,
    node_filter=None,
    max_sweeps: int | None = None,
) -> torch.Tensor:
    """Connected components -> int32[n_nodes] labels (min node id wins).

    Each sweep propagates labels one hop through every selected layer
    (two-mode layers through hyperedge labels, never projecting), then
    short-circuits chains with ``labels = min(labels, labels[labels])``;
    label doubling converges in O(log diameter) sweeps. Sweeps run on the
    host's loop until the labels stop changing or ``max_sweeps`` is
    reached; each is counted in ``launch_counts["components_sweeps"]``.

    ``node_filter`` computes components of the induced subnetwork:
    filtered-out nodes keep their own label. Directed layers are treated
    as undirected (weak components).
    """
    n = net.n_nodes
    nf = net._filter(node_filter)
    prep = component_streams(net._select(layer_names))

    def sweep(labels: torch.Tensor) -> torch.Tensor:
        launch_counts["components_sweeps"] += 1
        labels = propagate_labels(prep, labels.clone(), nf)
        # pointer jumping: a label is itself a same-component node id, so
        # relabeling through it never leaves the component
        return torch.minimum(labels, labels[labels.long()])

    labels0 = torch.arange(n, dtype=torch.int32, device=net.device)
    if not prep:
        return labels0
    limit = n if max_sweeps is None else max_sweeps
    prev, labels, it = labels0, sweep(labels0), 0
    while it < limit and not torch.equal(labels, prev):
        prev, labels = labels, sweep(labels)
        it += 1
    return labels
