"""Public wrappers around the hand-written CUDA kernels.

On a CUDA tensor each op launches its kernel (``kernels/intersect.py``,
``kernels/segmented_union.py``, ``kernels/frontier.py``, and for the LM
stack ``kernels/rmsnorm.py``, ``kernels/flash_attention.py``,
``kernels/ssd_scan.py``); on a CPU tensor it runs the plain torch version
from ``kernels/ref.py``. The choice is made by the device of the
tensors given, never by catching a failure: a CUDA tensor that the kernel
refuses raises.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.csr import SENTINEL, take_clip
from . import ref
from .flash_attention import flash_attention_cuda
from .frontier import frontier_compact_cuda
from .intersect import intersect_count_cuda
from .rmsnorm import rmsnorm_cuda
from .segmented_union import segmented_union_cuda
from .ssd_scan import ssd_scan_cuda

_SENT = int(SENTINEL)


# ---------------------------------------------------------------------------
# intersect (pseudo-projection GetEdgeValue / CheckEdge)
# ---------------------------------------------------------------------------


def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched |row∩row| for SENTINEL-padded sorted rows -> int32[B]."""
    if a.is_cuda:
        return intersect_count_cuda(a.contiguous(), b.contiguous())
    return ref.intersect_count_ref(a, b)


def pseudo_edge_value(layer, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """LayerTwoMode.edge_value at the layer-global membership width."""
    a, am = layer.memberships(u)
    b, bm = layer.memberships(v)
    a = torch.where(am, a, _SENT)
    b = torch.where(bm, b, _SENT)
    return intersect_count(a, b).to(torch.float32)


# ---------------------------------------------------------------------------
# segmented union (pseudo-projection GetNodeAlters)
# ---------------------------------------------------------------------------


def segmented_union(
    flat: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dedup + sort + compact SENTINEL-padded rows -> (int32[..., max_out], mask)."""
    if not flat.is_cuda:
        return ref.segmented_union_ref(flat, max_out)
    batch_shape = flat.shape[:-1]
    out = segmented_union_cuda(
        flat.reshape(-1, flat.shape[-1]).contiguous(), max_out
    )
    out = out.reshape(batch_shape + (max_out,))
    return out, out != _SENT


# ---------------------------------------------------------------------------
# frontier compaction (batched k-hop BFS)
# ---------------------------------------------------------------------------


def frontier_compact(
    cand: torch.Tensor,
    visited: torch.Tensor,
    max_out: int,
    *,
    visited_sorted: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-BFS-frontier compaction -> (int32[..., max_out], mask).

    Keeps the first occurrence of every SENTINEL-padded candidate that is
    not present in the matching ``visited`` row, sorted ascending and
    capped at ``max_out``. ``visited_sorted=True`` promises each visited
    row is already sorted ascending (SENTINEL pads last): callers
    compacting several candidate chunks against one visited buffer sort
    it once; otherwise it is sorted here.
    """
    vs = visited if visited_sorted else torch.sort(visited, dim=-1).values
    if not cand.is_cuda:
        return ref.frontier_search_ref(cand, vs, max_out)
    batch_shape = cand.shape[:-1]
    out = frontier_compact_cuda(
        cand.reshape(-1, cand.shape[-1]).contiguous(),
        vs.reshape(-1, vs.shape[-1]).contiguous(),
        max_out,
    )
    out = out.reshape(batch_shape + (max_out,))
    return out, out != _SENT


def pseudo_node_alters(
    layer,
    u: torch.Tensor,
    max_alters: int,
    *,
    width_m: int | None = None,
    width_n: int | None = None,
    node_filter: torch.Tensor | None = None,
    use_kernel: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LayerTwoMode.node_alters: two-hop gather then segmented union.

    ``width_m`` / ``width_n`` override the gather pad widths (membership
    count / hyperedge size); None means the layer-global maxima.
    ``node_filter`` (device bool[n_nodes]) drops gathered co-members that
    fail a predicate before the union, so the cap applies post-filter.
    ``use_kernel=False`` dedups with the plain sort path (the padded
    oracle, and the dispatcher's rule for rows wider than the kernel's
    capacity).
    """
    he, he_mask = layer.memberships(u, width_m)
    wn = layer.max_hyperedge_size if width_n is None else max(width_n, 1)
    mem, mem_mask = layer.member_rows(torch.where(he_mask, he, 0), wn)
    mem_mask = mem_mask & he_mask[..., None]
    if node_filter is not None:
        mem_mask = mem_mask & take_clip(node_filter, mem)
    flat = torch.where(mem_mask, mem, _SENT).reshape(u.shape + (-1,))
    flat = torch.where(flat == u[..., None], _SENT, flat)  # drop ego
    if use_kernel:
        return segmented_union(flat, max_alters)
    return ref.segmented_union_ref(flat, max_alters)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Grouped-query attention, q head h reading kv head h // (Hq/Hkv)
    -> (B, Hq, S, D) in q's dtype. Any strides: the layer passes
    transposed views of [B, S, H, D], which the tensor-core kernel reads as
    they lie, and on the card the result may be a view of [B, S, Hq, D].
    The kernel picks its own tiles (the JAX op's ``block_q``/``block_k``
    have no counterpart)."""
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} not a multiple of kv heads {Hkv}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, scale=scale, causal=causal)
    return ref.attention_heads_ref(q, k, v, scale=scale, causal=causal)


# ---------------------------------------------------------------------------
# Mamba2 SSD scan
# ---------------------------------------------------------------------------


def ssd_scan(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S)
    a_log: torch.Tensor,  # (B, H, S)
    bmat: torch.Tensor,  # (B, S, N) shared single group
    cmat: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 128,
) -> torch.Tensor:
    """Mamba2 SSD scan -> (B, H, S, P) in x's dtype; on the CPU
    ``ref.ssd_scan_heads_ref``. On the card the route is
    ``ssd_scan.uses_tensor_cores``'s: bf16 at mamba2's widths on the tensor
    cores, f32 and other shapes on the CUDA cores."""
    if x.is_cuda:
        return ssd_scan_cuda(x, dt, a_log, bmat, cmat, chunk=chunk)
    return ref.ssd_scan_heads_ref(x, dt, a_log, bmat, cmat, chunk=chunk)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm(
    x: torch.Tensor,  # (..., D)
    w: torch.Tensor,  # (D,)
    *,
    eps: float = 1e-6,
    plus_one: bool = False,
) -> torch.Tensor:
    """x·rsqrt(mean(x²)+eps)·(w [+1]) over the last axis, in x's dtype."""
    if x.is_cuda:
        return rmsnorm_cuda(x, w, eps=eps, plus_one=plus_one)
    return ref.rmsnorm_ref(x, w, eps=eps, plus_one=plus_one)
