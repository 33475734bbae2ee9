"""Node-range-sharded graph queries, in PyTorch.

Port of the JAX package's ``core/sharded.py``. The paper (§6) names the
single-machine architecture as Threadle's main limit; this module splits
every layer's rows by contiguous node ranges and answers queries with an
owner-computes pattern.

Two generations live here, as in the JAX package:

* ``ShardedTwoMode`` + ``make_sharded_edge_value`` /
  ``make_sharded_walk_step`` — ONE two-mode layer's memberships split by
  node range (local offsets, padded per shard), with the hyperedge→member
  directory replicated. A query batch goes to every shard; each answers
  the ids it owns and the owners' contributions are summed.
* ``ShardedNetwork`` / ``shard_network`` — the sharded query and
  traversal engine: every layer's CSR row-sliced by contiguous node
  ranges (global column ids, full row space kept, so an owned row is
  byte-identical to the source's), owner-routed ``edge_value`` /
  ``check_edge_any`` / ``node_alters`` / ``degree`` through each shard's
  own degree-bucketed dispatch, and ``khop`` / ``components`` with
  per-shard expansion and a cross-shard exchange between hops. Every
  result equals the unsharded ``Network``'s bit for bit: point queries
  run the same kernels on identical rows; a k-hop keeps, per shard, its
  segment's smallest new ids, and the union of those is the hop's
  smallest ``max_frontier`` new ids (the argument behind the slot chunks
  of ``traversal.khop_neighborhood``); components converge to the unique
  min-label fixed point however the sweeps are split.

On one card the hop cost is the algorithmic gain: a hop gathers
``Σ_s B·F_s·cap_s`` candidates, each shard paying its own exact alter
bound, instead of ``B·F·cap`` with every slot paying the hub's.

Where the port departs from the JAX package:

* There is no mesh (``launch/mesh.py`` is not ported): the ``shard_map``
  generation runs as a loop over shards on one device, the ``psum``
  becomes a sum of the masked per-shard contributions, the ``mesh`` /
  ``axis`` parameters are gone and the shard count is
  ``graph.n_shards``. ``make_sharded_edge_value`` counts with
  ``kernels/ops.py::intersect_count``, the same integer as the JAX
  package's ``(B, K, K)`` equality sum on deduplicated rows, and its
  walk step widens member ids to int32 before the ``+ 1`` of its
  contribution.
* Shards run in a plain loop on the calling thread; the JAX package's
  thread pool is not ported. Under the serving engine every launch must
  stay on the pump thread.
* PyTorch runs eagerly, so every id batch is concrete and there is no
  traced-input fallback.
* ``shard_network(devices=None)`` (or ``()``) leaves every shard on the
  source's device. An explicit list of torch devices places shard ``s``
  on ``devices[s % D]``; every exchange then moves partials to the
  source's device. Only the one-card placement is tested.
* On one card the exchange stays on the device: two-mode membership rows
  are assembled into one SENTINEL-padded tensor and counted by
  ``intersect_count``, k-hop partials merge through ``union_rows``, and
  component proposals min-combine there. The host sees only the
  frontier, whose widths size the next hop's launches.
* Sliced CSRs hold views of the source's ``indices`` / ``values`` (the
  source stays resident as ``ShardedNetwork.source``), so slicing copies
  nothing but each shard's ``indptr``, computed from the host mirror and
  uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import dispatch, prng, traversal
from .csr import CSR, SENTINEL, take_clip, take_ids, to_numpy, to_tensor
from .layers import LayerOneMode, LayerTwoMode
from .network import Network
from .nodeset import Nodeset, empty_attrs
from .overlay import DeltaOverlay, eff_host_degree_table
from repro_torch.kernels import ops as kops
from repro_torch.kernels.build import launch_counts

__all__ = [
    "ShardedTwoMode",
    "shard_two_mode",
    "make_sharded_edge_value",
    "make_sharded_walk_step",
    "ShardedNetwork",
    "shard_network",
    "reshard_deltas",
    "sharded_khop",
    "sharded_components",
]

_SENT = int(SENTINEL)


# ---------------------------------------------------------------------------
# ShardedTwoMode: one two-mode layer, memberships split by node range
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShardedTwoMode:
    """Node-range-sharded memberships + replicated member directory.

    memb_indptr  : int32[n_shards, rows_per_shard + 1] (local offsets)
    memb_indices : int32[n_shards, max_local_nnz] (hyperedge ids, padded)
    members      : the layer's hyperedge->node CSR arrays, shared
    """

    memb_indptr: torch.Tensor
    memb_indices: torch.Tensor
    members_indptr: torch.Tensor
    members_indices: torch.Tensor
    n_nodes: int
    n_shards: int
    rows_per_shard: int
    max_memberships: int


def shard_two_mode(layer: LayerTwoMode, n_shards: int) -> ShardedTwoMode:
    """Partition a LayerTwoMode's base memberships by contiguous node
    ranges (host-side), on the layer's device."""
    n = layer.n_nodes
    rows = -(-n // n_shards)  # ceil
    indptr = layer.memb.indptr_host
    indices = to_numpy(layer.memb.indices)

    local_ptrs, local_idx = [], []
    max_nnz = 0
    for s in range(n_shards):
        lo, hi = min(s * rows, n), min((s + 1) * rows, n)
        base = indptr[lo]
        ptr = indptr[lo : hi + 1] - base
        ptr = np.pad(ptr, (0, rows + 1 - len(ptr)), mode="edge")
        idx = indices[indptr[lo] : indptr[hi]]
        max_nnz = max(max_nnz, len(idx))
        local_ptrs.append(ptr)
        local_idx.append(idx)
    pad_idx = np.full((n_shards, max(max_nnz, 1)), _SENT, dtype=np.int32)
    for s, idx in enumerate(local_idx):
        pad_idx[s, : len(idx)] = idx

    device = layer.memb.device
    return ShardedTwoMode(
        memb_indptr=to_tensor(np.stack(local_ptrs).astype(np.int32), device),
        memb_indices=to_tensor(pad_idx, device),
        members_indptr=layer.members.indptr,
        members_indices=layer.members.indices,
        n_nodes=n,
        n_shards=n_shards,
        rows_per_shard=rows,
        max_memberships=layer.max_memberships,
    )


def _ids(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    return to_tensor(np.asarray(x, dtype=np.int32), device)


def _local_rows(indptr, indices, local_u, valid, k: int) -> torch.Tensor:
    """Gather up to k membership slots for local row ids (padded)."""
    start = take_clip(indptr, local_u).long()
    length = take_clip(indptr, local_u.long() + 1).long() - start
    offs = torch.arange(k, dtype=torch.int64, device=indptr.device)
    gather_at = start[:, None] + offs[None, :]
    ok = (offs[None, :] < length[:, None]) & valid[:, None]
    vals = take_clip(indices, torch.where(ok, gather_at, 0))
    return torch.where(ok, vals, _SENT)


def make_sharded_edge_value(graph: ShardedTwoMode):
    """Batched pseudo-projection edge_value over the shards.

    Returns fn(u int32[B], v int32[B]) -> f32[B]. Each shard resolves the
    membership rows of the nodes IT owns, for both endpoints; the partial
    rows combine by a sum of the masked contributions (rows are disjoint
    across owners), and ``intersect_count`` counts the shared hyperedges.
    """
    K = max(graph.max_memberships, 1)
    rows = graph.rows_per_shard
    device = graph.memb_indptr.device

    def owned_rows(nodes: torch.Tensor) -> torch.Tensor:
        full = torch.zeros((nodes.shape[0], K), dtype=torch.int32, device=device)
        for s in range(graph.n_shards):
            local = nodes - s * rows
            mine = (local >= 0) & (local < rows)
            r = _local_rows(graph.memb_indptr[s], graph.memb_indices[s],
                            local, mine, K)
            # non-owners contribute SENTINEL -> 0
            full += torch.where(r == _SENT, 0, r + 1)
        return torch.where(full == 0, _SENT, full - 1)

    def edge_value(u, v) -> torch.Tensor:
        a = owned_rows(_ids(u, device))  # (B, K) hyperedge ids, SENTINEL-padded
        b = owned_rows(_ids(v, device))
        return kops.intersect_count(a, b).to(torch.float32)

    return edge_value


def make_sharded_walk_step(graph: ShardedTwoMode):
    """Owner-routed pseudo-projected walk step over the sharded graph.

    fn(u int32[B], seed) -> int32[B]: the owner of each walker samples a
    hyperedge from its local membership row; the member hop uses the
    replicated directory; the owners' contributions are summed. Shard s
    draws under ``fold_in(fold_in(key(0), seed), s)`` with per-element
    bounds over the full batch, so the draws are the JAX package's.
    """
    rows = graph.rows_per_shard
    device = graph.memb_indptr.device
    h_indptr = graph.members_indptr
    h_indices = graph.members_indices
    n_h = h_indptr.shape[0]

    def walk_step(u, seed: int) -> torch.Tensor:
        u = _ids(u, device)
        combined = torch.zeros_like(u)
        base = prng.fold_in(prng.key(0), int(seed) & 0xFFFFFFFF)
        for s in range(graph.n_shards):
            ptr, idx = graph.memb_indptr[s], graph.memb_indices[s]
            local = u - s * rows
            mine = (local >= 0) & (local < rows)
            lc = local.clamp(0, rows - 1).long()
            start = ptr[lc]
            length = ptr[lc + 1] - start
            k1, k2 = prng.split(prng.fold_in(base, s))
            r1 = prng.randint(k1, u.shape, 0, length.clamp(min=1), device)
            he = take_clip(idx, start.long() + r1)
            # second hop through the replicated hyperedge directory
            hs = h_indptr[he.long().clamp(0, n_h - 2)]
            hl = h_indptr[(he.long() + 1).clamp(0, n_h - 1)] - hs
            r2 = prng.randint(k2, u.shape, 0, hl.clamp(min=1), device)
            pos = (hs.long() + r2).clamp(0, max(h_indices.shape[0] - 1, 0))
            nxt = take_ids(h_indices, pos)
            ok = mine & (length > 0) & (hl > 0)
            combined += torch.where(ok, nxt + 1, 0)
        return torch.where(combined == 0, u, combined - 1).to(torch.int32)

    return walk_step


# ---------------------------------------------------------------------------
# ShardedNetwork: the sharded query + traversal engine
# ---------------------------------------------------------------------------
#
# Layout: shard s owns the contiguous node range [bounds[s], bounds[s+1])
# and holds, per layer, a ROW-SLICED CSR: the indptr is clamped so rows
# outside the range are empty, the indices keep their GLOBAL column ids
# and the full row space is kept. An owned row is therefore byte-identical
# to the same row of the unsharded layer, so the degree-bucketed dispatch
# runs on a shard unchanged. Two-mode layers share the hyperedge->member
# directory and recompute the LOCAL max_memberships, which narrows the
# shard's pad widths without changing results.


def _move(t: torch.Tensor | None, device) -> torch.Tensor | None:
    return None if t is None else t.to(device)


def _move_csr(csr: CSR | None, device) -> CSR | None:
    if csr is None or csr.device == device:
        return csr
    return CSR(indptr=csr.indptr.to(device), indices=csr.indices.to(device),
               values=_move(csr.values, device), n_rows=csr.n_rows,
               n_cols=csr.n_cols, indptr_host=csr.indptr_host)


def _move_overlay(ov: DeltaOverlay | None, device) -> DeltaOverlay | None:
    if ov is None or ov.dirty.device == device:
        return ov
    return DeltaOverlay(delta=_move_csr(ov.delta, device), dirty=ov.dirty.to(device),
                        base_shadowed=ov.base_shadowed, dirty_host=ov.dirty_host)


def _slice_csr_rows(csr: CSR, lo: int, hi: int, device=None) -> CSR:
    """Row-range restriction: rows outside [lo, hi) become empty.

    new_indptr[i] = clip(indptr[i], indptr[lo], indptr[hi]) - indptr[lo],
    computed from the host mirror in int64 and cast back to the source's
    indptr dtype, keeps the full row space (n_rows unchanged); indices
    and values become views of the owned rows' entries. Owned rows are
    byte-identical to the source CSR's.
    """
    device = csr.device if device is None else device
    ptr = csr.indptr_host
    base, top = int(ptr[lo]), int(ptr[hi])
    new_ptr = (np.clip(ptr.astype(np.int64), base, top) - base).astype(ptr.dtype)
    return CSR(
        indptr=to_tensor(new_ptr, device),
        indices=csr.indices[base:top].to(device),
        values=None if csr.values is None else csr.values[base:top].to(device),
        n_rows=csr.n_rows,
        n_cols=csr.n_cols,
        indptr_host=new_ptr,
    )


def _slice_overlay(
    ov: DeltaOverlay | None, base_slice: CSR, lo: int, hi: int,
) -> DeltaOverlay | None:
    """Row-range restriction of a delta overlay.

    The delta CSR slices exactly like a base CSR (full row space kept,
    owned rows byte-identical). The dirty mask and its host mirror stay
    whole: a dirty row outside [lo, hi) selects an EMPTY delta row over an
    equally empty sliced-base row, so non-owned rows still resolve empty.
    ``base_shadowed`` is recomputed against the sliced base so the shard's
    effective-nnz accounting covers owned rows only.
    """
    if ov is None:
        return None
    device = base_slice.device
    delta = _slice_csr_rows(ov.delta, lo, hi, device)
    bdeg = np.diff(base_slice.indptr_host.astype(np.int64))
    dirty_np = ov.dirty_host[: base_slice.n_rows]
    return DeltaOverlay(
        delta=delta,
        dirty=ov.dirty.to(device),
        base_shadowed=int(bdeg[dirty_np].sum()),
        dirty_host=ov.dirty_host,
    )


def _local_max_memberships(layer: LayerTwoMode, lo: int, hi: int) -> int:
    deg = eff_host_degree_table(layer.memb, layer.memb_ov)[lo:hi]
    return max(int(deg.max()) if deg.size else 0, 1)


def _slice_layer(layer, lo: int, hi: int, device):
    """One shard's view of a layer: owned rows only, global column ids."""
    if isinstance(layer, LayerTwoMode):
        memb = _slice_csr_rows(layer.memb, lo, hi, device)
        return LayerTwoMode(
            memb=memb,
            members=_move_csr(layer.members, device),  # shared directory
            memb_ov=_slice_overlay(layer.memb_ov, memb, lo, hi),
            members_ov=_move_overlay(layer.members_ov, device),
            max_memberships=_local_max_memberships(layer, lo, hi),
            max_hyperedge_size=layer.max_hyperedge_size,
        )
    out = _slice_csr_rows(layer.out, lo, hi, device)
    in_ = None if layer.in_ is None else _slice_csr_rows(layer.in_, lo, hi, device)
    return LayerOneMode(
        out=out,
        in_=in_,
        out_ov=_slice_overlay(layer.out_ov, out, lo, hi),
        in_ov=(
            None if layer.in_ov is None
            else _slice_overlay(layer.in_ov, in_, lo, hi)
        ),
        directed=layer.directed,
        valued=layer.valued,
        allow_self=layer.allow_self,
        store_inbound=layer.store_inbound,
    )


def _host_ids(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = to_numpy(x)
    return np.atleast_1d(np.asarray(x)).astype(np.int64).reshape(-1)


class ShardedNetwork:
    """Per-shard row-sliced layer views + the owner-routing query engine.

    Implements the Network query protocol (``edge_value`` /
    ``check_edge_any`` / ``node_alters`` / ``degree`` / ``khop`` /
    ``components``) with results bit-identical to ``source``'s, so the
    serving engine's executors and ``api.runquery`` take either.
    ``source`` stays resident for walk fleets (batch-coupled draws cannot
    shard bit-identically), for layer and nodeset metadata, and as the
    storage the shards' index views point into. Results land on the
    source's device.
    """

    def __init__(self, source: Network, shards: tuple, bounds: np.ndarray):
        self.source = source
        self.shards = tuple(shards)
        self.bounds = np.asarray(bounds, dtype=np.int64)
        self.n_shards = len(self.shards)

    # -- container parity ----------------------------------------------------

    @property
    def n_nodes(self) -> int:
        return self.source.n_nodes

    @property
    def nodeset(self):
        return self.source.nodeset

    @property
    def device(self) -> torch.device:
        return self.source.device

    @property
    def layer_names(self) -> tuple[str, ...]:
        return self.source.layer_names

    def layer(self, name: str):
        return self.source.layer(name)

    def _select(self, layer_names):
        return self.source._select(layer_names)

    def _batch(self, x) -> torch.Tensor:
        return self.source._batch(x)

    def _filter(self, node_filter) -> torch.Tensor | None:
        return self.source._filter(node_filter)

    @property
    def nbytes(self) -> int:
        """The shard layers' bytes plus the nodeset's, as the JAX package
        counts them. The shards' indices are views of the source's and
        the member directories are shared, so this figure is larger than
        the bytes the shards actually allocate (their ``indptr`` arrays)."""
        return sum(
            sum(l.nbytes for l in sh.layers) for sh in self.shards
        ) + self.source.nodeset.nbytes

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning shard per node id (contiguous-range partition)."""
        own = np.searchsorted(self.bounds, ids, side="right") - 1
        return np.clip(own, 0, self.n_shards - 1)

    def _partition(self, ids: np.ndarray) -> list[tuple[int, np.ndarray]]:
        """[(shard, positions-into-ids)] for the shards that own any."""
        own = self.shard_of(ids)
        return [
            (s, np.nonzero(own == s)[0])
            for s in range(self.n_shards)
            if (own == s).any()
        ]

    def _routes(self, ids: np.ndarray, other: np.ndarray | None = None):
        """Per owning shard of ``ids``: (shard, its ids on its device,
        the paired ``other`` ids there or None, positions into ``ids`` on
        the source's device)."""
        for s, idx in self._partition(ids):
            shard = self.shards[s]
            yield (
                shard,
                to_tensor(ids[idx].astype(np.int32), shard.device),
                None if other is None
                else to_tensor(other[idx].astype(np.int32), shard.device),
                torch.from_numpy(idx).to(self.device),
            )

    @staticmethod
    def _on(nf: torch.Tensor | None, shard) -> torch.Tensor | None:
        return None if nf is None else nf.to(shard.device)

    # -- owner-routed point queries ------------------------------------------

    def edge_value(self, layer_name: str, u, v, node_filter=None) -> torch.Tensor:
        """Batched edge value, routed to owning shards.

        One-mode rows live wholly on owner(u), so pairs route there and
        run the shard's kernel on identical rows. Two-mode pairs may
        STRADDLE shards: each endpoint's membership row is gathered from
        its owner into one SENTINEL-padded tensor and ``intersect_count``
        counts the shared hyperedges — the same integer every unsharded
        path produces.
        """
        un, vn = _host_ids(u), _host_ids(v)
        nf = self._filter(node_filter)
        layer = self.source.layer(layer_name)
        if isinstance(layer, LayerTwoMode):
            if un.size == 0:
                return torch.zeros(0, dtype=torch.float32, device=self.device)
            a = self._member_rows(layer_name, un)
            b = self._member_rows(layer_name, vn)
            val = kops.intersect_count(a, b).to(torch.float32)
            if nf is not None:
                vt = to_tensor(vn.astype(np.int32), self.device)
                val = torch.where(take_clip(nf, vt), val, 0.0)
            return val
        out = torch.zeros(un.shape[0], dtype=torch.float32, device=self.device)
        for shard, us, vs, pos in self._routes(un, vn):
            vals = shard.layer(layer_name).edge_value(
                us, vs, node_filter=self._on(nf, shard))
            out[pos] = vals.to(self.device)
        return out

    def _member_rows(self, layer_name: str, ids: np.ndarray) -> torch.Tensor:
        """Membership rows gathered from their owners -> int32[B, K],
        SENTINEL-padded to the widest shard's width."""
        parts = []
        for shard, us, _, pos in self._routes(ids):
            a, m = shard.layer(layer_name).memberships(us)
            parts.append((pos, torch.where(m, a, _SENT).to(self.device)))
        K = max([a.shape[1] for _, a in parts] or [1])
        rows = torch.full((ids.shape[0], K), _SENT, dtype=torch.int32,
                          device=self.device)
        for pos, a in parts:
            rows[pos, : a.shape[1]] = a
        return rows

    def check_edge_any(self, u, v, layer_names=None, node_filter=None) -> torch.Tensor:
        """OR across selected layers (Network.check_edge_any parity)."""
        un, vn = _host_ids(u), _host_ids(v)
        nf = self._filter(node_filter)
        names = self.layer_names if layer_names is None else tuple(layer_names)
        out = torch.zeros(un.shape[0], dtype=torch.bool, device=self.device)
        routes = None
        for name in names:
            if isinstance(self.source.layer(name), LayerTwoMode):
                out |= self.edge_value(name, un, vn, node_filter=nf) > 0
                continue
            if routes is None:
                routes = list(self._routes(un, vn))
            for shard, us, vs, pos in routes:
                hit = shard.layer(name).check_edge(
                    us, vs, node_filter=self._on(nf, shard))
                out[pos] |= hit.to(self.device)
        return out

    def node_alters(self, u, max_alters: int, layer_names=None,
                    node_filter=None) -> tuple[torch.Tensor, torch.Tensor]:
        """Owner-routed multilayer alters union -> (vals, mask).

        Rows are independent, so each shard answers the queried nodes it
        owns through its own bucketed dispatch and the results scatter
        back — per row bit-identical to the unsharded call.
        """
        un = _host_ids(u)
        nf = self._filter(node_filter)
        vals = torch.full((un.shape[0], max_alters), _SENT, dtype=torch.int32,
                          device=self.device)
        mask = torch.zeros((un.shape[0], max_alters), dtype=torch.bool,
                           device=self.device)
        for shard, us, _, pos in self._routes(un):
            a, m = shard.node_alters(us, max_alters, layer_names,
                                     node_filter=self._on(nf, shard))
            vals[pos] = a.to(self.device)
            mask[pos] = m.to(self.device)
        return vals, mask

    def degree(self, u, layer_names=None, node_filter=None) -> torch.Tensor:
        """Owner-routed summed per-layer degree (Network.degree parity)."""
        un = _host_ids(u)
        nf = self._filter(node_filter)
        out = None
        for shard, us, _, pos in self._routes(un):
            d = shard.degree(us, layer_names, node_filter=self._on(nf, shard))
            if out is None:  # the unsharded sum's dtype
                out = torch.zeros(un.shape[0], dtype=d.dtype, device=self.device)
            out[pos] = d.to(self.device)
        if out is None:
            out = torch.zeros(un.shape[0], dtype=torch.int32, device=self.device)
        return out

    # -- sharded traversal ---------------------------------------------------

    def khop(self, sources, k: int, *, max_frontier: int | None = None,
             max_alters_per_node: int | None = None, layer_names=None,
             node_filter=None):
        return sharded_khop(
            self, sources, k, max_frontier=max_frontier,
            max_alters_per_node=max_alters_per_node,
            layer_names=layer_names, node_filter=node_filter,
        )

    def components(self, layer_names=None, node_filter=None,
                   max_sweeps: int | None = None) -> torch.Tensor:
        return sharded_components(
            self, layer_names=layer_names, node_filter=node_filter,
            max_sweeps=max_sweeps,
        )


def shard_network(
    net: Network, n_shards: int, devices: Sequence | None = None,
) -> ShardedNetwork:
    """Partition every layer of ``net`` by contiguous node ranges.

    ``devices=None`` or ``()`` leaves every shard on the source's device;
    an explicit list of torch devices places shard s on
    ``devices[s % len(devices)]``. More shards than nodes clamp to one
    shard a node.
    """
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    n = net.n_nodes
    n_shards = min(n_shards, max(n, 1))
    bounds = np.array(
        [(n * s) // n_shards for s in range(n_shards + 1)], np.int64
    )
    devices = tuple(torch.device(d) for d in (devices or ()))
    shards = []
    for s in range(n_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        device = devices[s % len(devices)] if devices else net.device
        nodeset = net.nodeset
        if nodeset.device != device:  # queries on a shard read no attribute
            nodeset = Nodeset(attrs=empty_attrs(), n_nodes=n, device=device)
        shards.append(Network(
            nodeset=nodeset,
            layers=tuple(_slice_layer(l, lo, hi, device) for l in net.layers),
            layer_names=net.layer_names,
        ))
    return ShardedNetwork(net, tuple(shards), bounds)


def _base_csrs(layer) -> tuple:
    if isinstance(layer, LayerTwoMode):
        return (layer.memb, layer.members)
    return (layer.out, layer.in_)


def reshard_deltas(
    snet: ShardedNetwork, new_net: Network,
) -> ShardedNetwork | None:
    """Cheap re-shard when only delta overlays changed.

    Overlay-only mutation keeps every base CSR object-identical, so the
    shards' row-sliced bases stay valid and only the changed layers'
    overlay slices are recomputed (each still clamps its delta's
    full-row-space ``indptr``, as the JAX package does). Returns ``None``
    when anything other than
    overlays changed (compaction, nodeset rebinding, layer set changes):
    the caller falls back to ``shard_network``.
    """
    old = snet.source
    if new_net is old:
        return snet
    if (
        new_net.nodeset is not old.nodeset
        or new_net.layer_names != old.layer_names
        or len(new_net.layers) != len(old.layers)
    ):
        return None
    for nl, ol in zip(new_net.layers, old.layers):
        if type(nl) is not type(ol):
            return None
        if any(a is not b for a, b in zip(_base_csrs(nl), _base_csrs(ol))):
            return None

    shards = []
    for s in range(snet.n_shards):
        lo, hi = int(snet.bounds[s]), int(snet.bounds[s + 1])
        old_sub = snet.shards[s]
        device = old_sub.device
        layers = []
        for nl, ol, osl in zip(new_net.layers, old.layers, old_sub.layers):
            if nl is ol:
                layers.append(osl)  # untouched layer: shard view reused
            elif isinstance(nl, LayerTwoMode):
                layers.append(LayerTwoMode(
                    memb=osl.memb,
                    members=_move_csr(nl.members, device),
                    memb_ov=_slice_overlay(nl.memb_ov, osl.memb, lo, hi),
                    members_ov=_move_overlay(nl.members_ov, device),
                    max_memberships=_local_max_memberships(nl, lo, hi),
                    max_hyperedge_size=nl.max_hyperedge_size,
                ))
            else:
                layers.append(LayerOneMode(
                    out=osl.out,
                    in_=osl.in_,
                    out_ov=_slice_overlay(nl.out_ov, osl.out, lo, hi),
                    in_ov=(
                        None if nl.in_ov is None
                        else _slice_overlay(nl.in_ov, osl.in_, lo, hi)
                    ),
                    directed=nl.directed,
                    valued=nl.valued,
                    allow_self=nl.allow_self,
                    store_inbound=nl.store_inbound,
                ))
        shards.append(Network(
            nodeset=old_sub.nodeset,
            layers=tuple(layers),
            layer_names=new_net.layer_names,
        ))
    return ShardedNetwork(new_net, tuple(shards), snet.bounds)


def sharded_khop(
    snet: ShardedNetwork,
    sources,
    k: int,
    *,
    max_frontier: int | None = None,
    max_alters_per_node: int | None = None,
    layer_names=None,
    node_filter=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-shard frontier expansion with a cross-shard hop exchange.

    Mirrors ``traversal.khop_neighborhood`` hop for hop. Frontier rows
    are sorted with SENTINEL pads, and shard ranges are contiguous, so
    each row's shard-s nodes form one contiguous segment (found by two
    rank counts on the host copy of the frontier). Per hop, each shard
    expands its owned segment through its OWN bucketed dispatch under its
    OWN exact alter bound, in slot chunks under
    ``traversal.MAX_CAND_FLAT``, and compacts the candidates against the
    hop's shared visited set with ``frontier_compact``; the per-shard
    partial frontiers then merge through ``dispatch.union_rows`` on the
    source's device — the frontier exchange.
    """
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    src = snet._batch(sources)
    if src.dim() != 1:
        raise ValueError(f"sources must be a vector, got shape {tuple(src.shape)}")
    B = src.shape[0]
    n = snet.n_nodes
    device = snet.device
    nf = snet._filter(node_filter)
    if max_frontier is None:
        max_frontier = min(n, traversal.DEFAULT_MAX_FRONTIER)
    max_frontier = max(int(max_frontier), 1)

    hop_of_slot = np.concatenate(
        [np.zeros(1, np.int32)]
        + [np.full(max_frontier, h, np.int32) for h in range(1, k + 1)]
    )
    visited = src[:, None]
    frontier = src[:, None]
    groups = [frontier]
    masks = [torch.ones((B, 1), dtype=torch.bool, device=device)]
    done_at = k
    rows_b = np.arange(B)[:, None]
    for h in range(1, k + 1):
        f_np = to_numpy(frontier)
        F = f_np.shape[1]
        visited_hop = torch.sort(visited, dim=-1).values
        partials = []
        for s, shard in enumerate(snet.shards):
            # rows are sorted with SENTINEL (> any node id) pads, so the
            # entries in [lo, hi) sit at positions [rank(lo), rank(hi))
            lo, hi = int(snet.bounds[s]), int(snet.bounds[s + 1])
            left = (f_np < lo).sum(axis=1)
            widths = (f_np < hi).sum(axis=1) - left
            fs_w = int(widths.max())
            if fs_w == 0:
                continue
            Fs = 1
            while Fs < fs_w:  # power-of-two width, as the unsharded hop
                Fs <<= 1
            cols = left[:, None] + np.arange(Fs)[None, :]
            valid = np.arange(Fs)[None, :] < widths[:, None]
            seg = np.where(
                valid, f_np[rows_b, np.minimum(cols, F - 1)], _SENT
            ).astype(np.int32)
            if max_alters_per_node is not None:
                cap = max(int(max_alters_per_node), 1)
            else:
                real = np.unique(seg[seg != _SENT].astype(np.int64))
                cap = dispatch.alters_bound(shard._select(layer_names), real, n)
            step = max(1, min(Fs, traversal.MAX_CAND_FLAT // cap))
            nf_s = None if nf is None else nf.to(shard.device)
            vis = visited_hop.to(shard.device)
            parts = [
                traversal._compact(
                    traversal._frontier_alters(
                        shard, seg[:, lo2 : lo2 + step], layer_names, nf_s, cap),
                    vis, max_frontier, True,
                )
                for lo2 in range(0, Fs, step)
            ]
            if len(parts) > 1:
                pv, pm = dispatch.union_rows(
                    torch.cat([p[0] for p in parts], dim=-1),
                    torch.cat([p[1] for p in parts], dim=-1),
                    max_frontier,
                )
            else:
                pv, pm = parts[0]
            partials.append((pv.to(device), pm.to(device)))
        if not partials:
            frontier = torch.full((B, max_frontier), _SENT, dtype=torch.int32,
                                  device=device)
            fmask = torch.zeros((B, max_frontier), dtype=torch.bool, device=device)
        elif len(partials) == 1:
            frontier, fmask = partials[0]
        else:
            frontier, fmask = dispatch.union_rows(
                torch.cat([p[0] for p in partials], dim=-1),
                torch.cat([p[1] for p in partials], dim=-1),
                max_frontier,
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


def sharded_components(
    snet: ShardedNetwork,
    layer_names=None,
    node_filter=None,
    max_sweeps: int | None = None,
) -> torch.Tensor:
    """Connected components over the sharded views -> int32[n] labels.

    Each round runs one min-label sweep PER SHARD over its owned rows
    (two-mode sweeps through the shared hyperedge directory) — the body
    of ``traversal.components_batched``'s sweep — min-combines the
    per-shard proposals on the source's device, applies one
    pointer-jumping pass, and repeats to the fixed point (each round
    counted in ``launch_counts["components_sweeps"]``). The converged
    labeling (min node id per component; filtered-out nodes keep their
    own id) is the unique fixed point of min-label propagation, so it
    equals ``components_batched``'s bit for bit however the sweeps were
    split.
    """
    n = snet.n_nodes
    device = snet.device
    nf = snet._filter(node_filter)
    shard_prep = []
    for shard in snet.shards:
        prep = traversal.component_streams(shard._select(layer_names))
        if prep:
            shard_prep.append(
                (shard.device, prep, None if nf is None else nf.to(shard.device)))

    labels = torch.arange(n, dtype=torch.int32, device=device)
    if not shard_prep:
        return labels
    limit = n if max_sweeps is None else int(max_sweeps)
    for _ in range(max(limit, 1)):
        launch_counts["components_sweeps"] += 1
        new = labels
        for sdev, prep, nf_s in shard_prep:
            proposal = traversal.propagate_labels(
                prep, labels.to(sdev, copy=True), nf_s)
            new = torch.minimum(new, proposal.to(device))
        jumped = torch.minimum(new, new[new.long()])
        if torch.equal(jumped, labels):
            break
        labels = jumped
    return labels
