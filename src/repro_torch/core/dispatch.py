"""Degree-bucketed batched query dispatch for the pseudo-projection paths.

Batched two-mode queries padded to the layer-global maxima would pay for
one hub node or giant hyperedge in every row of every batch. The
dispatcher, as in the JAX package's ``core/dispatch.py``:

  1. reads row degrees on the host, from the CSRs' host ``indptr``
     mirrors (no device round trip per batch),
  2. splits the batch into padding buckets (``DEFAULT_BUCKET_WIDTHS``
     then the layer max),
  3. pads each bucket's row count to a power of two,
  4. runs each bucket through the kernels (``kernels/ops.py``: the CUDA
     kernels on the card, their plain torch versions on the CPU),
  5. scatters per-bucket results back into the original batch order.

GetEdgeValue / CheckEdge take none of these steps on the card: one
``ops.intersect_rows`` call over the whole batch launches a kernel that
finds each pair's effective membership rows in the CSR and its overlay
itself, so there is no host degree read, bucket, padding, gather or
scatter. Their plain version, which the CPU runs, buckets by degree as
above (``ref.intersect_rows_ref``), without the power-of-two padding.

The port always buckets: PyTorch runs eagerly, so every batch is concrete
and the JAX package's ``can_dispatch`` (traced vs concrete) has no
counterpart. The global-max padded paths stay, as the oracle.

Thresholds re-derived for the H100:

* The JAX package's ``PALLAS_MIN_WIDTH = 128`` kept narrow buckets off
  its TPU kernel because that kernel pads rows to a full 128-lane tile;
  the CUDA kernel reads rows of any length as they lie, so the threshold
  does not apply.
* Union rows up to ``UNION_KERNEL_MAX_FLAT`` entries (the in-block
  kernel's capacity, 32,768: 1,024 threads x 32 keys held in registers)
  go to the segmented-union kernel in one piece; the JAX package's
  ``UNION_PALLAS_MAX_FLAT = 2048`` was sized for its all-pairs VMEM
  tiles. Wider rows take the kernels' wide route (``ops.union_wide``:
  tiles of ``UNION_KERNEL_MAX_FLAT``, pairwise merges in device memory,
  one compaction pass), so no union row leaves the kernels for torch's
  sort on the card; ``padded_unique`` is only the plain version and the
  ``use_kernel=False`` oracle. The filtered degree asks the kernels for
  counts only (``ops.segmented_union_count``), not for rows it would
  count.
"""

from __future__ import annotations

import numpy as np
import torch

from .csr import SENTINEL, take_clip, to_tensor
from .overlay import (
    eff_host_degree_table,
    eff_host_degrees,
    eff_row_gather,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.segmented_union import MAX_FLAT

__all__ = [
    "DEFAULT_BUCKET_WIDTHS",
    "UNION_KERNEL_MAX_FLAT",
    "plan_buckets",
    "bucketed_edge_value",
    "bucketed_check_edge",
    "bucketed_node_alters",
    "bucketed_filtered_degree",
    "alters_bound",
    "union_rows",
    "node_max_hyperedge_size",
]

# Bucket pad widths tried in order; the layer-global max closes the list.
DEFAULT_BUCKET_WIDTHS = (8, 32, 128)
# Widest union row the in-block kernel takes (its capacity), and the tile
# width of the wide route beyond it.
UNION_KERNEL_MAX_FLAT = MAX_FLAT

_SENT = int(SENTINEL)


# ---------------------------------------------------------------------------
# Host-side planning
# ---------------------------------------------------------------------------


def _width_ladder(max_width: int, widths) -> list[int]:
    max_width = max(int(max_width), 1)
    return [w for w in widths if w < max_width] + [max_width]


def plan_buckets(
    deg: np.ndarray,
    max_width: int,
    widths=DEFAULT_BUCKET_WIDTHS,
) -> list[tuple[np.ndarray, int]]:
    """Assign each query the smallest bucket width covering its degree.

    Returns [(original_positions, pad_width)] for each non-empty bucket,
    ascending by width. Degree-0 rows land in the smallest bucket.
    """
    ladder = _width_ladder(max_width, widths)
    assign = np.searchsorted(np.asarray(ladder), deg, side="left")
    out = []
    for bi, w in enumerate(ladder):
        idx = np.nonzero(assign == bi)[0]
        if idx.size:
            out.append((idx, int(w)))
    return out


def _pow2_rows(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _pad_rows(ids: np.ndarray, n: int, device) -> torch.Tensor:
    out = np.zeros((n,), dtype=np.int32)
    out[: ids.size] = ids
    return torch.from_numpy(out).to(device)


def _host_ids(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.int64).reshape(-1)


def _device_ids(x, device) -> torch.Tensor:
    """Query ids as a flat int32 tensor on ``device`` (int64 ids wrap, as
    the int32 row padding of the bucket plan wraps them)."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).to(device=device, dtype=torch.int32)
    return to_tensor(np.asarray(x, dtype=np.int64).reshape(-1).astype(np.int32),
                     device)


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def device_mask(nf, device) -> torch.Tensor | None:
    """A node filter (numpy or torch bool[n_nodes]) as a device tensor."""
    if nf is None:
        return None
    if isinstance(nf, torch.Tensor):
        return nf.to(device=device, dtype=torch.bool)
    return to_tensor(np.asarray(nf, dtype=bool), device)


def _scatter(out: torch.Tensor, idx: np.ndarray, res: torch.Tensor) -> None:
    out[torch.from_numpy(idx).to(out.device)] = res[: idx.size]


# Per-layer cache: node -> max hyperedge size over its memberships.
# Keyed by id() of the membership indices buffers, which are pinned in the
# value so a recycled id is caught by an identity check. Bounded LRU.
_NODE_WIDTH_CACHE: dict[tuple, tuple[tuple, np.ndarray]] = {}
_NODE_WIDTH_CACHE_MAX = 64


def node_max_hyperedge_size(layer) -> np.ndarray:
    """int32[n_nodes]: largest hyperedge each node belongs to (host, cached).

    Bounds the second-hop gather width for ``node_alters`` per query
    node, replacing the layer-global ``max_hyperedge_size``. The first
    call per layer copies the membership ids to the host once.
    """
    memb_ov = layer.memb_ov
    members_ov = layer.members_ov
    pins = (
        layer.memb.indices,
        None if memb_ov is None else memb_ov.delta.indices,
        None if members_ov is None else members_ov.delta.indices,
    )
    key = tuple(id(p) for p in pins)
    hit = _NODE_WIDTH_CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], pins)):
        _NODE_WIDTH_CACHE.pop(key, None)
        _NODE_WIDTH_CACHE[key] = hit
        return hit[1]
    indptr = layer.memb.indptr_host
    indices = layer.memb.indices.cpu().numpy()
    he_sizes = eff_host_degree_table(layer.members, members_ov).astype(
        np.int32
    )
    out = np.zeros(layer.memb.n_rows, dtype=np.int32)
    if indices.size:
        per_memb = he_sizes[indices]
        lengths = np.diff(indptr)
        nonempty = lengths > 0
        starts = indptr[:-1][nonempty]
        out[nonempty] = np.maximum.reduceat(per_memb, starts)
    if memb_ov is not None:
        dirty = memb_ov.dirty_host
        dind = memb_ov.delta.indptr_host
        dids = memb_ov.delta.indices.cpu().numpy()
        out[dirty] = 0
        if dids.size:
            dlen = np.diff(dind)
            dne = (dlen > 0) & dirty
            dstarts = dind[:-1][dne]
            out[dne] = np.maximum.reduceat(he_sizes[dids], dstarts)
    _NODE_WIDTH_CACHE.pop(key, None)
    while len(_NODE_WIDTH_CACHE) >= _NODE_WIDTH_CACHE_MAX:
        del _NODE_WIDTH_CACHE[next(iter(_NODE_WIDTH_CACHE))]
    _NODE_WIDTH_CACHE[key] = (pins, out)
    return out


def _second_hop_width(layer, un: np.ndarray, idx: np.ndarray, widths) -> int:
    per_node_wn = node_max_hyperedge_size(layer)
    needed = int(per_node_wn[np.clip(un[idx], 0, per_node_wn.size - 1)].max())
    return next(
        w for w in _width_ladder(layer.max_hyperedge_size, widths)
        if w >= needed
    )


# ---------------------------------------------------------------------------
# Fixed-width bucket bodies
# ---------------------------------------------------------------------------


def _node_alters_bucket(layer, ids: np.ndarray, nf, wm: int, wn: int,
                        max_alters: int):
    """Union of co-members for one bucket of query ids (rows padded to a
    power of two)."""
    u = _pad_rows(ids, _pow2_rows(ids.size), layer.memb.device)
    return kops.pseudo_node_alters(
        layer, u, max_alters, width_m=wm, width_n=wn, node_filter=nf,
        tile=UNION_KERNEL_MAX_FLAT,
    )


# ---------------------------------------------------------------------------
# Dispatchers
# ---------------------------------------------------------------------------


def bucketed_edge_value(
    layer,
    u,
    v,
    *,
    node_filter=None,
    widths=DEFAULT_BUCKET_WIDTHS,
) -> torch.Tensor:
    """GetEdgeValue over a query batch -> f32[...], in one
    ``ops.intersect_rows`` call.

    On the card that is one kernel launch over the whole batch; on the
    CPU its plain version buckets by max(deg(u), deg(v)) over ``widths``.
    ``node_filter`` (bool[n_nodes]) restricts targets: pairs whose ``v``
    fails it return 0 and their rows are never read.
    """
    device = layer.memb.device
    counts = kops.intersect_rows(
        layer.memb, layer.memb_ov, _device_ids(u, device), _device_ids(v, device),
        device_mask(node_filter, device), widths=widths,
    )
    return counts.to(torch.float32).reshape(_shape(u))


def bucketed_check_edge(layer, u, v, **kw) -> torch.Tensor:
    return bucketed_edge_value(layer, u, v, **kw) > 0


def bucketed_node_alters(
    layer,
    u,
    max_alters: int,
    *,
    node_filter=None,
    widths=DEFAULT_BUCKET_WIDTHS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Degree-bucketed GetNodeAlters -> (int32[..., max_alters], mask).

    First-hop width = membership-degree bucket; second-hop width = the
    max hyperedge size among the bucket's nodes, rounded up the same
    width ladder. Rows are sorted-unique and capped at ``max_alters``.
    ``node_filter`` masks alters inside each bucket, before the union.
    """
    device = layer.memb.device
    shape = _shape(u)
    un = _host_ids(u)
    B = un.size
    vals = torch.full((B, max_alters), _SENT, dtype=torch.int32, device=device)
    if B > 0:
        nf = device_mask(node_filter, device)
        deg = eff_host_degrees(layer.memb, layer.memb_ov, un)
        for idx, wm in plan_buckets(deg, layer.max_memberships, widths):
            wn = _second_hop_width(layer, un, idx, widths)
            va, _ = _node_alters_bucket(layer, un[idx], nf, wm, wn, max_alters)
            _scatter(vals, idx, va)
    vals = vals.reshape(shape + (max_alters,))
    return vals, vals != _SENT


def bucketed_filtered_degree(
    layer,
    u,
    node_filter,
    *,
    widths=DEFAULT_BUCKET_WIDTHS,
) -> torch.Tensor:
    """Degree-bucketed filtered-alter count -> int32[...].

    One-mode: neighbors passing the filter (gather at the bucket width +
    mask-sum). Two-mode: *distinct* co-members passing the filter — each
    bucket counts the filtered co-members of its exact flat width (wm × wn)
    with the count-only union, so the count is uncapped and exact.
    """
    two_mode = hasattr(layer, "memb")
    base = layer.memb if two_mode else layer.out
    device = base.device
    shape = _shape(u)
    un = _host_ids(u)
    B = un.size
    out = torch.zeros((B,), dtype=torch.int32, device=device)
    if B == 0:
        return out.reshape(shape)
    nf = device_mask(node_filter, device)
    if not two_mode:
        deg = eff_host_degrees(layer.out, layer.out_ov, un)
        for idx, w in plan_buckets(deg, max(int(deg.max()), 1), widths):
            rows = _pad_rows(un[idx], _pow2_rows(idx.size), device)
            vals, mask = eff_row_gather(layer.out, layer.out_ov, rows, w)
            hit = mask & take_clip(nf, vals)
            _scatter(out, idx, hit.sum(dim=-1).to(torch.int32))
        return out.reshape(shape)
    deg = eff_host_degrees(layer.memb, layer.memb_ov, un)
    for idx, wm in plan_buckets(deg, layer.max_memberships, widths):
        wn = _second_hop_width(layer, un, idx, widths)
        rows = _pad_rows(un[idx], _pow2_rows(idx.size), device)
        flat = kops.pseudo_alters_flat(layer, rows, width_m=wm, width_n=wn,
                                       node_filter=nf)
        _scatter(out, idx,
                 kops.segmented_union_count(flat, tile=UNION_KERNEL_MAX_FLAT))
    return out.reshape(shape)


def alters_bound(layers, u, n_nodes: int) -> int:
    """Host-side upper bound on distinct alters across ``layers`` for batch u.

    Two-mode layers contribute ≤ deg(u) × (max hyperedge size among u's
    hyperedges − 1); one-mode layers their out-degree.
    """
    un = _host_ids(u)
    if un.size == 0:
        return 1
    total = np.zeros(un.size, dtype=np.int64)
    for layer in layers:
        if hasattr(layer, "memb"):
            deg = eff_host_degrees(layer.memb, layer.memb_ov, un)
            wn = node_max_hyperedge_size(layer)
            wn_u = wn[np.clip(un, 0, wn.size - 1)]
            total += deg * np.maximum(wn_u - 1, 0)
        else:
            total += eff_host_degrees(layer.out, layer.out_ov, un)
    return int(np.clip(total.max(), 1, n_nodes))


def union_rows(
    vals: torch.Tensor,
    valid: torch.Tensor,
    max_out: int,
    *,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sorted-unique rows capped at ``max_out`` (multilayer alters merge).

    Rows up to ``UNION_KERNEL_MAX_FLAT`` wide go to the in-block
    segmented-union kernel, wider ones to its wide route.
    ``use_kernel=False`` takes the plain sort path for every row (the
    plain reference of the traversal).
    """
    flat = torch.where(valid, vals, _SENT)
    if not use_kernel:
        return kref.segmented_union_ref(flat, max_out)
    return kops.segmented_union(flat, max_out, tile=UNION_KERNEL_MAX_FLAT)
