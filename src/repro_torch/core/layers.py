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

Builders run on the host (numpy) and upload the finished CSRs.
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
]

_SENT = int(SENTINEL)


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
# Overlay folding (read side: analysis expands raw CSR buffers)
# ---------------------------------------------------------------------------


def has_overlay(layer) -> bool:
    """True when the layer carries uncompacted delta state."""
    if isinstance(layer, LayerTwoMode):
        return layer.memb_ov is not None or layer.members_ov is not None
    return layer.out_ov is not None or layer.in_ov is not None


def compact_layer(layer):
    """Fold the delta overlay into a fresh base CSR (bit-identical).

    The effective edge set goes back through the standard builders, so
    the result is exactly the layer a from-scratch construction of the
    same edges would produce, on the layer's device.
    """
    if not has_overlay(layer):
        return layer
    if isinstance(layer, LayerTwoMode):
        rows, cols, _ = eff_coo(layer.memb, layer.memb_ov)
        return two_mode_from_memberships(
            layer.n_nodes, layer.n_hyperedges, rows, cols,
            device=layer.memb.device,
        )
    rows, cols, vals = eff_coo(layer.out, layer.out_ov)
    if not layer.directed:
        keep = rows <= cols  # each undirected edge stored in both rows
        rows, cols = rows[keep], cols[keep]
        vals = None if vals is None else vals[keep]
    return one_mode_from_edges(
        layer.n_nodes, rows, cols, values=vals, directed=layer.directed,
        allow_self=layer.allow_self, store_inbound=layer.store_inbound,
        device=layer.out.device,
    )
