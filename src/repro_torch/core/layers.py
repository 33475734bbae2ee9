"""Network layers, query side: one-mode (unipartite) and two-mode (hyperedge).

* ``LayerOneMode`` — per-node edge lists as CSR (+ optional inbound CSR).
* ``LayerTwoMode`` — a set of hyperedges with a dual index: node ->
  memberships CSR and hyperedge -> members CSR. Queries go through the
  same interface as one-mode layers (pseudo-projection): edge existence
  is "share ≥1 hyperedge", edge value is "count of shared hyperedges",
  alters are "union of co-members" — the projection is never built.

Both classes implement ``check_edge / edge_value / node_alters /
filtered_degree / degrees``, so multilayer operations never branch on
mode at the call site. Query methods take batches of node ids (int32
tensors on the layer's device). Two-mode queries always run through the
degree-bucketed dispatcher (``core/dispatch.py``); the ``*_padded``
methods are the global-max padded paths, kept as the oracle.

Builders run on the host (numpy) and upload the finished CSRs. Mutation
(``add_edges`` / ``delete_edges``) lands in a delta overlay
(``core/overlay.py``) and folds back into the base past
``DEFAULT_COMPACT_RATIO``, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from . import dispatch
from .csr import (
    CSR,
    SENTINEL,
    DtypePolicy,
    coo_chunks_to_host_csr,
    csr_empty,
    csr_from_arrays,
    host_csr_transpose,
    resolve_device,
    sorted_isin,
    take_clip,
    widen_ids,
)
from .overlay import (
    DeltaOverlay,
    eff_contains,
    eff_coo,
    eff_degrees,
    eff_host_degree_table,
    eff_max_degree,
    eff_n_rows,
    eff_nnz,
    eff_row_gather,
    eff_row_sample,
    eff_value_at,
    fold_overlay,
    overlay_ratio,
    overlay_update,
)

__all__ = [
    "LayerOneMode",
    "LayerTwoMode",
    "one_mode_from_edges",
    "one_mode_from_edge_chunks",
    "two_mode_from_memberships",
    "two_mode_from_membership_chunks",
    "two_mode_empty",
    "has_overlay",
    "compact_layer",
    "layer_overlay_ratio",
    "add_edges",
    "delete_edges",
    "DEFAULT_COMPACT_RATIO",
]

_SENT = int(SENTINEL)

# Compaction policy: fold the overlay into the base CSR once the delta
# grows past this fraction of the base nnz (and always on snapshot).
DEFAULT_COMPACT_RATIO = 0.25


def _ov_nbytes(ov: DeltaOverlay | None) -> int:
    return 0 if ov is None else ov.nbytes


# ---------------------------------------------------------------------------
# One-mode layers
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerOneMode:
    """Unipartite layer: CSR out-edges (+ optional CSR in-edges).

    Symmetric layers store each undirected edge in both rows (so ``out``
    is its own transpose and ``in_`` is None). Directed layers keep a
    separate inbound CSR unless ``store_inbound=False``.
    """

    out: CSR
    in_: CSR | None
    directed: bool
    valued: bool
    allow_self: bool
    store_inbound: bool
    out_ov: DeltaOverlay | None = None
    in_ov: DeltaOverlay | None = None

    @property
    def mode(self) -> int:
        return 1

    @property
    def n_nodes(self) -> int:
        return self.out.n_rows

    @property
    def n_edges(self) -> int:
        """Logical edge count (undirected edges counted once)."""
        nnz = eff_nnz(self.out, self.out_ov)
        return nnz if self.directed else nnz // 2

    def check_edge(self, u: torch.Tensor, v: torch.Tensor,
                   node_filter=None) -> torch.Tensor:
        hit = eff_contains(self.out, self.out_ov, u, v)
        if node_filter is not None:
            hit = hit & take_clip(self._device_filter(node_filter), v)
        return hit

    def edge_value(self, u: torch.Tensor, v: torch.Tensor,
                   node_filter=None) -> torch.Tensor:
        val = eff_value_at(self.out, self.out_ov, u, v)
        if node_filter is not None:
            nf = self._device_filter(node_filter)
            val = torch.where(take_clip(nf, v), val, 0.0)
        return val

    def node_alters(
        self, u: torch.Tensor, max_alters: int, inbound: bool = False,
        node_filter=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded outbound (or inbound) neighbor lists -> (int32[B,K], mask).

        ``node_filter`` (device bool[n_nodes]) drops neighbors failing an
        attribute predicate (mask holes; ids replaced by SENTINEL).
        """
        csr, ov = self._in_pair() if inbound else (self.out, self.out_ov)
        vals, mask = eff_row_gather(csr, ov, u, max_alters)
        if node_filter is not None:
            mask = mask & take_clip(self._device_filter(node_filter), vals)
            vals = torch.where(mask, vals, _SENT)
        return vals, mask

    def filtered_degree(self, u: torch.Tensor, node_filter) -> torch.Tensor:
        """Count of out-neighbors passing ``node_filter`` -> int32[B]."""
        return dispatch.bucketed_filtered_degree(self, u, node_filter)

    def filtered_degree_padded(self, u: torch.Tensor,
                               node_filter) -> torch.Tensor:
        """Oracle for ``filtered_degree``: an O(nnz) per-node count of
        passing neighbors (the overlay's dirty rows take the delta's)."""
        nf = self._device_filter(node_filter)

        def per_node_counts(csr: CSR) -> torch.Tensor:
            rows = torch.repeat_interleave(
                torch.arange(csr.n_rows, device=csr.device),
                csr.degrees().long(),
            )
            contrib = take_clip(nf, widen_ids(csr.indices)).to(torch.int32)
            return torch.zeros(
                csr.n_rows, dtype=torch.int32, device=csr.device
            ).index_add_(0, rows, contrib)

        per_node = per_node_counts(self.out)
        if self.out_ov is not None:
            per_node = torch.where(
                self.out_ov.dirty, per_node_counts(self.out_ov.delta), per_node
            )
        return take_clip(per_node, u)

    def sample_neighbor(
        self, u: torch.Tensor, key
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Uniform random out-neighbor per query node (random walk step)."""
        return eff_row_sample(self.out, self.out_ov, u, key)

    def degrees(self) -> torch.Tensor:
        return eff_degrees(self.out, self.out_ov)

    def _device_filter(self, node_filter) -> torch.Tensor:
        return dispatch.device_mask(node_filter, self.out.device)

    def max_degree(self) -> int:
        return eff_max_degree(self.out, self.out_ov)

    def _in_pair(self) -> tuple[CSR, DeltaOverlay | None]:
        if not self.directed:
            return self.out, self.out_ov
        if self.in_ is None:
            raise ValueError(
                "inbound edges not stored (store_inbound=False); "
                "re-import the layer with inbound storage enabled"
            )
        return self.in_, self.in_ov

    @property
    def nbytes(self) -> int:
        n = self.out.nbytes + _ov_nbytes(self.out_ov)
        if self.in_ is not None:
            n += self.in_.nbytes + _ov_nbytes(self.in_ov)
        return n

    def drop_inbound(self) -> "LayerOneMode":
        """Disable inbound storage, ~halving a directed layer's memory."""
        return replace(self, in_=None, in_ov=None, store_inbound=False)


def one_mode_from_edges(
    n_nodes: int,
    src: np.ndarray,
    dst: np.ndarray,
    values: np.ndarray | None = None,
    directed: bool = False,
    allow_self: bool = False,
    store_inbound: bool = True,
    sum_duplicates: bool = False,
    policy: DtypePolicy | None = None,
    device=None,
) -> LayerOneMode:
    """Build a one-mode layer from an edge list (host-side)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    if values is not None:
        values = np.asarray(values, dtype=np.float32)
    return one_mode_from_edge_chunks(
        n_nodes,
        [(src, dst, values)],
        directed=directed,
        allow_self=allow_self,
        store_inbound=store_inbound,
        sum_duplicates=sum_duplicates,
        valued=values is not None,
        policy=policy,
        device=device,
    )


def one_mode_from_edge_chunks(
    n_nodes: int,
    chunks,
    directed: bool = False,
    allow_self: bool = False,
    store_inbound: bool = True,
    sum_duplicates: bool = False,
    valued: bool = False,
    policy: DtypePolicy | None = None,
    device=None,
) -> LayerOneMode:
    """Streaming one-mode build from ``(src, dst[, values])`` chunk tuples.

    ``chunks`` may be an iterable of chunk tuples, or a zero-arg callable
    returning a fresh iterator. Duplicate (u, v) pairs dedup to the FIRST
    arrival. Undirected builds from a re-iterable source walk it twice —
    every forward edge, then every mirror — so the arrival order is
    independent of chunking; a one-shot iterator interleaves each chunk's
    mirror right after it.
    """
    device = resolve_device(device)

    def norm(ch):
        src, dst = np.asarray(ch[0]), np.asarray(ch[1])
        vals = ch[2] if len(ch) > 2 else None
        if vals is not None:
            vals = np.asarray(vals, dtype=np.float32)
        if not allow_self:
            keep = src != dst
            src, dst = src[keep], dst[keep]
            if vals is not None:
                vals = vals[keep]
        if valued and vals is None:
            vals = np.ones(src.shape, np.float32)
        return src, dst, vals

    factory = (
        chunks if callable(chunks)
        else (lambda: iter(chunks)) if isinstance(chunks, (list, tuple))
        else None
    )

    def gen():
        if directed:
            for ch in (factory() if factory else chunks):
                yield norm(ch)
        elif factory is not None:
            for ch in factory():
                yield norm(ch)
            for ch in factory():
                src, dst, vals = norm(ch)
                yield (dst, src, vals)
        else:
            for ch in chunks:
                src, dst, vals = norm(ch)
                yield (src, dst, vals)
                yield (dst, src, vals)

    host = coo_chunks_to_host_csr(
        gen(), n_nodes, n_nodes,
        dedup=not sum_duplicates, sum_duplicates=sum_duplicates,
        valued=valued, policy=policy,
    )
    out = csr_from_arrays(*host, n_nodes, n_nodes, device)
    in_ = None
    if directed and store_inbound:
        in_ = csr_from_arrays(
            *host_csr_transpose(*host, n_nodes, n_nodes, policy),
            n_nodes, n_nodes, device,
        )
    return LayerOneMode(
        out=out,
        in_=in_,
        directed=directed,
        valued=valued,
        allow_self=allow_self,
        store_inbound=store_inbound,
    )


# ---------------------------------------------------------------------------
# Two-mode layers (pseudo-projection)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerTwoMode:
    """Bipartite/affiliation layer stored as hyperedge memberships.

    Dual index:
      memb    : CSR node -> hyperedge ids   (N rows, H cols)
      members : CSR hyperedge -> node ids   (H rows, N cols)

    ``max_memberships`` / ``max_hyperedge_size`` are the row maxima — the
    padding bounds of the global-max paths.
    """

    memb: CSR
    members: CSR
    max_memberships: int
    max_hyperedge_size: int
    memb_ov: DeltaOverlay | None = None
    members_ov: DeltaOverlay | None = None

    @property
    def mode(self) -> int:
        return 2

    @property
    def n_nodes(self) -> int:
        return self.memb.n_rows

    @property
    def n_hyperedges(self) -> int:
        return eff_n_rows(self.members, self.members_ov)

    @property
    def n_memberships(self) -> int:
        return eff_nnz(self.memb, self.memb_ov)

    @property
    def nbytes(self) -> int:
        return (
            self.memb.nbytes + self.members.nbytes
            + _ov_nbytes(self.memb_ov) + _ov_nbytes(self.members_ov)
        )

    # -- pseudo-projection queries (batched) --------------------------------

    def memberships(
        self, u: torch.Tensor, max_len: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        k = self.max_memberships if max_len is None else max_len
        return eff_row_gather(self.memb, self.memb_ov, u, max(k, 1))

    def member_rows(
        self, he: torch.Tensor, max_len: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Padded member lists per hyperedge id (overlay-merged gather)."""
        k = self.max_hyperedge_size if max_len is None else max_len
        return eff_row_gather(self.members, self.members_ov, he, max(k, 1))

    def check_edge(self, u: torch.Tensor, v: torch.Tensor,
                   node_filter=None) -> torch.Tensor:
        """Pseudo-projected edge existence: do u and v share a hyperedge?"""
        return self.edge_value(u, v, node_filter=node_filter) > 0

    def edge_value(self, u: torch.Tensor, v: torch.Tensor,
                   node_filter=None) -> torch.Tensor:
        """Pseudo-projected edge value: number of shared hyperedges (f32[B]).

        ``node_filter`` restricts targets: pairs whose ``v`` fails it
        return 0 and skip the bucketed work.
        """
        return dispatch.bucketed_edge_value(self, u, v, node_filter=node_filter)

    def edge_value_padded(self, u: torch.Tensor, v: torch.Tensor,
                          node_filter=None) -> torch.Tensor:
        """Global-max-padded reference path (binary-search ``sorted_isin``)."""
        a, am = self.memberships(u)
        b, bm = self.memberships(v)
        hits = sorted_isin(a, am, b, bm)
        val = hits.sum(dim=-1).to(torch.float32)
        if node_filter is not None:
            nf = dispatch.device_mask(node_filter, self.memb.device)
            val = torch.where(take_clip(nf, v), val, 0.0)
        return val

    def node_alters(
        self, u: torch.Tensor, max_alters: int, inbound: bool = False,
        node_filter=None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pseudo-projected alters: union of co-members across u's hyperedges.

        Returns (int32[B, max_alters] sorted padded, mask), degree-bucketed.
        ``node_filter`` (bool[n_nodes]) keeps only alters passing a
        predicate; the ``max_alters`` cap applies post-filter.
        """
        return dispatch.bucketed_node_alters(
            self, u, max_alters, node_filter=node_filter
        )

    def node_alters_padded(
        self, u: torch.Tensor, max_alters: int, node_filter=None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Global-max-padded reference path: the union over
        max_memberships × max_hyperedge_size gathered slots, deduped by the
        plain sort path and capped at ``max_alters``."""
        from repro_torch.kernels import ops as kops

        return kops.pseudo_node_alters(
            self, u, max_alters,
            node_filter=dispatch.device_mask(node_filter, self.memb.device),
            use_kernel=False,
        )

    def filtered_degree(self, u: torch.Tensor, node_filter) -> torch.Tensor:
        """Distinct co-members passing ``node_filter`` -> int32[B].

        The degree of u in the never-built projection restricted to the
        selection (≠ ``degrees()``, which counts memberships).
        """
        return dispatch.bucketed_filtered_degree(self, u, node_filter)

    def filtered_degree_padded(self, u: torch.Tensor,
                               node_filter) -> torch.Tensor:
        """Oracle for ``filtered_degree``: the padded path's mask count at
        the layer-global flat width."""
        bound = max(self.max_memberships * self.max_hyperedge_size, 1)
        _, mask = self.node_alters_padded(u, bound, node_filter=node_filter)
        return mask.sum(dim=-1).to(torch.int32)

    def sample_neighbor(
        self, u: torch.Tensor, key
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Pseudo-projected walk step without computing alters.

        Sample a hyperedge h uniformly from u's memberships, then a member v
        of h uniformly: a draw from the projected neighborhood with weight
        ∝ Σ_{shared h} 1/k_h, in O(1). A self-draw (v == u) is resampled
        once, then kept as 'stay'. Three row samples over the three keys of
        ``split(key, 3)``, as in the JAX package.
        """
        from . import prng

        k1, k2, k3 = prng.split(key, 3)
        he, he_valid = eff_row_sample(self.memb, self.memb_ov, u, k1)
        he = torch.where(he_valid, he, 0)
        v, m_valid = eff_row_sample(self.members, self.members_ov, he, k2)
        # one resample round for self-draws
        v2, _ = eff_row_sample(self.members, self.members_ov, he, k3)
        v = torch.where(v == u, v2, v)
        valid = he_valid & m_valid
        return torch.where(valid, v, u.to(torch.int32)), valid

    def degrees(self) -> torch.Tensor:
        """Membership counts per node (bipartite degree, not projected)."""
        return eff_degrees(self.memb, self.memb_ov)

    def max_degree(self) -> int:
        return eff_max_degree(self.memb, self.memb_ov)

    def hyperedge_sizes(self) -> torch.Tensor:
        return eff_degrees(self.members, self.members_ov)

    def equivalent_projected_edges(self) -> int:
        """Σ_h k_h(k_h−1)/2 — the size of the never-built projection,
        summed in int64 on the host from the indptr mirrors."""
        k = eff_host_degree_table(self.members, self.members_ov)
        return int(np.sum(k * (k - 1) // 2, dtype=np.int64))


def two_mode_from_memberships(
    n_nodes: int,
    n_hyperedges: int,
    node_ids: np.ndarray,
    hyperedge_ids: np.ndarray,
    policy: DtypePolicy | None = None,
    device=None,
) -> LayerTwoMode:
    """Build a two-mode layer from (node, hyperedge) membership pairs."""
    return two_mode_from_membership_chunks(
        n_nodes, n_hyperedges,
        [(np.asarray(node_ids), np.asarray(hyperedge_ids))],
        policy=policy, device=device,
    )


def two_mode_from_membership_chunks(
    n_nodes: int,
    n_hyperedges: int,
    chunks,
    policy: DtypePolicy | None = None,
    device=None,
) -> LayerTwoMode:
    """Streaming two-mode build from (node_ids, hyperedge_ids) chunk tuples.

    Both directions of the dual index come out DtypePolicy-narrowed; the
    transpose is one counting-sort pass over the finished host memb CSR.
    """
    device = resolve_device(device)
    memb = coo_chunks_to_host_csr(
        ((np.asarray(n), np.asarray(h)) for n, h in chunks),
        n_nodes, n_hyperedges, policy=policy,
    )
    members = host_csr_transpose(*memb, n_nodes, n_hyperedges, policy)
    max_memb = int(np.diff(memb[0]).max()) if memb[1].size else 0
    max_size = int(np.diff(members[0]).max()) if members[1].size else 0
    return LayerTwoMode(
        memb=csr_from_arrays(*memb, n_nodes, n_hyperedges, device),
        members=csr_from_arrays(*members, n_hyperedges, n_nodes, device),
        max_memberships=max(max_memb, 1),
        max_hyperedge_size=max(max_size, 1),
    )


def two_mode_empty(n_nodes: int, n_hyperedges: int, device=None) -> LayerTwoMode:
    return LayerTwoMode(
        memb=csr_empty(n_nodes, n_hyperedges, device=device),
        members=csr_empty(n_hyperedges, n_nodes, device=device),
        max_memberships=1,
        max_hyperedge_size=1,
    )


# ---------------------------------------------------------------------------
# Overlay folding and mutation
# ---------------------------------------------------------------------------


def has_overlay(layer) -> bool:
    """True when the layer carries uncompacted delta state."""
    if isinstance(layer, LayerTwoMode):
        return layer.memb_ov is not None or layer.members_ov is not None
    return layer.out_ov is not None or layer.in_ov is not None


def _one_mode_logical_edges(
    layer: LayerOneMode,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """The layer's effective logical edge list (undirected edges once)."""
    rows, cols, vals = eff_coo(layer.out, layer.out_ov)
    if not layer.directed:
        keep = rows <= cols  # each undirected edge stored in both rows
        rows, cols = rows[keep], cols[keep]
        vals = None if vals is None else vals[keep]
    return rows, cols, vals


def layer_overlay_ratio(layer) -> float:
    """Largest delta-to-base nnz ratio across the layer's overlays."""
    if isinstance(layer, LayerTwoMode):
        return max(
            overlay_ratio(layer.memb, layer.memb_ov),
            overlay_ratio(layer.members, layer.members_ov),
        )
    r = overlay_ratio(layer.out, layer.out_ov)
    if layer.in_ is not None:
        r = max(r, overlay_ratio(layer.in_, layer.in_ov))
    return r


def compact_layer(layer):
    """Fold the delta overlay into a fresh base CSR (bit-identical).

    The result is exactly the layer a from-scratch construction of the
    same edges would produce, on the layer's device: each CSR of the
    layer is folded with its own overlay (``overlay.fold_overlay``) at
    the default policy's widths. The overlays of a layer are kept in
    step (``members`` with ``memb``, ``in_`` with ``out``), so the folded
    pairs are each other's transposes, as the builders' are.
    """
    if not has_overlay(layer):
        return layer
    if isinstance(layer, LayerTwoMode):
        n, h = layer.n_nodes, layer.n_hyperedges
        dev = layer.memb.device
        memb = fold_overlay(layer.memb, layer.memb_ov, n, h)
        members = fold_overlay(layer.members, layer.members_ov, h, n)
        return LayerTwoMode(
            memb=csr_from_arrays(*memb, n, h, dev),
            members=csr_from_arrays(*members, h, n, dev),
            max_memberships=max(int(np.diff(memb[0]).max(initial=0)), 1),
            max_hyperedge_size=max(int(np.diff(members[0]).max(initial=0)), 1),
        )
    n, dev = layer.n_nodes, layer.out.device
    out = fold_overlay(layer.out, layer.out_ov, n, n)
    if not layer.directed and out[2] is not None:
        # the rebuild takes each undirected edge from its row-min side
        # (``_one_mode_logical_edges``): the (v, u) copy gets (u, v)'s value.
        # The structure is symmetric, so the transpose's entries line up.
        t_vals = host_csr_transpose(*out, n, n)[2]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(out[0]))
        out = (out[0], out[1], np.where(rows > out[1], t_vals, out[2]))
    in_ = None
    if layer.directed and layer.store_inbound:
        in_ = (fold_overlay(layer.in_, layer.in_ov, n, n) if layer.in_ is not None
               else host_csr_transpose(*out, n, n))
    return LayerOneMode(
        out=csr_from_arrays(*out, n, n, dev),
        in_=None if in_ is None else csr_from_arrays(*in_, n, n, dev),
        directed=layer.directed,
        valued=out[2] is not None,
        allow_self=layer.allow_self,
        store_inbound=layer.store_inbound,
    )


def _maybe_compact(layer, compact_ratio):
    if compact_ratio is not None and layer_overlay_ratio(layer) > compact_ratio:
        return compact_layer(layer)
    return layer


def _host_ids(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.atleast_1d(np.asarray(x, dtype=np.int64))


def _two_mode_update(layer: "LayerTwoMode", memb_ov, members_ov, compact_ratio):
    new = replace(
        layer,
        memb_ov=memb_ov,
        members_ov=members_ov,
        max_memberships=max(eff_max_degree(layer.memb, memb_ov), 1),
        max_hyperedge_size=max(eff_max_degree(layer.members, members_ov), 1),
    )
    return _maybe_compact(new, compact_ratio)


def add_edges(layer, src, dst, values=None, *,
              compact_ratio=DEFAULT_COMPACT_RATIO):
    """Batched edge insert -> new layer (functional; overlay fast path).

    One-mode layers take (src, dst[, values]) edge triples: an edge that
    already exists takes the NEW value when ``values`` is given, and KEEPS
    its stored value when ``values=None`` (new edges default to 1.0).
    Two-mode layers take (node, hyperedge) membership pairs; the
    hyperedge space grows if a new id exceeds it.

    The batch lands in the layer's delta overlay: only the touched rows
    are re-resolved. Queries merge the overlay, bit-identical to a full
    rebuild; once the delta outgrows ``compact_ratio`` x base nnz the
    overlay is folded back into the base (``compact_ratio=0`` forces an
    immediate rebuild, ``None`` never auto-compacts).
    """
    src, dst = _host_ids(src), _host_ids(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    if isinstance(layer, LayerTwoMode):
        if values is not None:
            raise ValueError("two-mode memberships carry no edge values")
        if src.size == 0:
            return layer
        n_hyper = max(layer.n_hyperedges, int(dst.max()) + 1)
        memb_ov = overlay_update(
            layer.memb, layer.memb_ov, src, dst, None, n_cols=n_hyper,
        )
        members_ov = overlay_update(
            layer.members, layer.members_ov, dst, src, None, n_rows=n_hyper,
        )
        return _two_mode_update(layer, memb_ov, members_ov, compact_ratio)
    if layer.valued:
        # values given: the batch goes FIRST, so the first-occurrence
        # dedup upserts the NEW value. values=None: existing content goes
        # first -- an existing edge KEEPS its stored value and only new
        # edges get the 1.0 default.
        new_first = values is not None
        if isinstance(values, torch.Tensor):
            values = values.detach().cpu().numpy()
        vals = (
            np.ones(src.shape, np.float32) if values is None
            else np.broadcast_to(np.asarray(values, dtype=np.float32), src.shape)
        )
    else:
        if values is not None:
            raise ValueError(
                "layer is unvalued; re-import it valued to carry values"
            )
        new_first = True
        vals = None
    if not layer.allow_self:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if vals is not None:
            vals = vals[keep]
    if src.size == 0:
        return layer
    if layer.directed:
        bs, bd, bv = src, dst, vals
    else:
        # canonicalize to (min, max) then mirror: both stored rows of an
        # undirected edge resolve to the same winning value, whichever
        # orientation the batch used
        lo, hi = np.minimum(src, dst), np.maximum(src, dst)
        bs, bd = np.concatenate([lo, hi]), np.concatenate([hi, lo])
        bv = None if vals is None else np.concatenate([vals, vals])
    out_ov = overlay_update(
        layer.out, layer.out_ov, bs, bd, bv,
        valued=layer.valued, new_first=new_first,
    )
    in_ov = layer.in_ov
    if layer.directed and layer.in_ is not None:
        in_ov = overlay_update(
            layer.in_, layer.in_ov, dst, src, vals,
            valued=layer.valued, new_first=new_first,
        )
    new = replace(layer, out_ov=out_ov, in_ov=in_ov)
    return _maybe_compact(new, compact_ratio)


def delete_edges(layer, src, dst, *, compact_ratio=DEFAULT_COMPACT_RATIO):
    """Batched edge delete -> new layer (missing pairs are ignored).

    One-mode undirected layers treat (u, v) and (v, u) as the same edge;
    two-mode layers delete (node, hyperedge) membership pairs. Deletes are
    tombstones in the delta overlay, with ``add_edges``' compaction policy.
    """
    src, dst = _host_ids(src), _host_ids(dst)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    if isinstance(layer, LayerTwoMode):
        ok = (
            (src >= 0) & (src < layer.n_nodes)
            & (dst >= 0) & (dst < layer.n_hyperedges)
        )
        src, dst = src[ok], dst[ok]
        if src.size == 0:
            return layer
        memb_ov = overlay_update(
            layer.memb, layer.memb_ov, src, dst, None, delete=True,
        )
        members_ov = overlay_update(
            layer.members, layer.members_ov, dst, src, None, delete=True,
        )
        return _two_mode_update(layer, memb_ov, members_ov, compact_ratio)
    n = layer.n_nodes
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    src, dst = src[ok], dst[ok]
    if src.size == 0:
        return layer
    if layer.directed:
        bs, bd = src, dst
    else:
        bs, bd = np.concatenate([src, dst]), np.concatenate([dst, src])
    out_ov = overlay_update(
        layer.out, layer.out_ov, bs, bd, None,
        delete=True, valued=layer.valued,
    )
    in_ov = layer.in_ov
    if layer.directed and layer.in_ is not None:
        in_ov = overlay_update(
            layer.in_, layer.in_ov, dst, src, None,
            delete=True, valued=layer.valued,
        )
    new = replace(layer, out_ov=out_ov, in_ov=in_ov)
    return _maybe_compact(new, compact_ratio)
