"""Public wrappers around the hand-written CUDA kernels.

On a CUDA tensor each op launches its kernel (``kernels/intersect.py``,
``kernels/segmented_union.py``, ``kernels/frontier.py``, the sampling
path's ``kernels/threefry.py``, and for the LM stack ``kernels/rmsnorm.py``,
``kernels/flash_attention.py``, ``kernels/ssd_scan.py``,
``kernels/rglru_scan.py``); on a CPU tensor
(or, for the draws, a CPU device) it runs the plain torch version
from ``kernels/ref.py``. The choice is made by the device of the
tensors given, never by catching a failure: a CUDA tensor that the kernel
refuses raises.

The LM kernels also take DTensors (the multi-card path, under a policy
over a device mesh, ``models/sharding.py``): each is then run through
``local_map``, every rank's kernel (or, on the CPU, plain version) on its
own shard at the local shapes, and never on a gathered full tensor. The
shards are those the operands arrive with (the layers lay them out by the
policy: batch on dp, heads or channels on tp); a partial sum, a split of
a dim the kernel reads whole, or an uneven split is made whole first.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.csr import SENTINEL, take_clip
from . import ref
from .flash_attention import flash_attention_bwd_cuda, flash_attention_cuda
from .frontier import frontier_compact_cuda
from .intersect import intersect_count_cuda, intersect_rows_cuda
from .rglru_scan import rglru_scan_bwd_cuda, rglru_scan_cuda
from .rmsnorm import rmsnorm_bwd_cuda, rmsnorm_cuda
from .segmented_union import (
    MAX_FLAT,
    segmented_union_count_cuda,
    segmented_union_cuda,
    union_compact_cuda,
    union_merge_cuda,
    union_tiles_cuda,
)
from .ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
from .threefry import csr_row_sample_cuda, randint_cuda, threefry_bits_cuda

_SENT = int(SENTINEL)


# ---------------------------------------------------------------------------
# intersect (pseudo-projection GetEdgeValue / CheckEdge)
# ---------------------------------------------------------------------------


def intersect_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched |row∩row| for SENTINEL-padded sorted rows -> int32[B]."""
    if a.is_cuda:
        return intersect_count_cuda(a.contiguous(), b.contiguous())
    return ref.intersect_count_ref(a, b)


def intersect_rows(
    base, ov, u: torch.Tensor, v: torch.Tensor,
    node_filter: torch.Tensor | None = None, *, widths,
) -> torch.Tensor:
    """GetEdgeValue's count for each pair of int32 ids -> int32[B]: the
    hyperedges u[i] and v[i] share in the membership CSR ``base`` with its
    overlay ``ov``, 0 where v[i] fails ``node_filter`` (bool[n], clipped).

    On CUDA tensors one launch of the kernel, which finds each pair's rows
    in the CSR itself; on CPU tensors the plain version, the degree-bucketed
    route over ``widths`` (``ref.intersect_rows_ref``)."""
    if u.is_cuda:
        overlay = None if ov is None else (ov.dirty, ov.delta.indptr, ov.delta.indices)
        return intersect_rows_cuda(base.indptr, base.indices, u.contiguous(),
                                   v.contiguous(), overlay=overlay,
                                   node_filter=node_filter)
    return ref.intersect_rows_ref(base, ov, u, v, node_filter, widths)


def pseudo_edge_value(layer, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """LayerTwoMode.edge_value at the layer-global membership width."""
    a, am = layer.memberships(u)
    b, bm = layer.memberships(v)
    a = torch.where(am, a, _SENT)
    b = torch.where(bm, b, _SENT)
    return intersect_count(a, b).to(torch.float32)


# ---------------------------------------------------------------------------
# threefry draws (core/prng.py, row samples of the walk step)
# ---------------------------------------------------------------------------


def threefry_bits(key, n: int, device: torch.device) -> torch.Tensor:
    """Element i < n of ``jax.random.bits(key, (n,))`` -> int32[n] (the
    uint32 bits) on ``device``."""
    if device.type == "cuda":
        return threefry_bits_cuda(key, n, device)
    return ref.threefry_bits_ref(key, n, device)


def randint(k1, k2, lo, hi, n: int, device: torch.device) -> torch.Tensor:
    """``jax.random.randint``'s int32 draw of n elements over the subkeys
    k1, k2 of ``split(key)``; ``lo`` / ``hi`` ints or int32[n] tensors."""
    if device.type == "cuda":
        return randint_cuda(k1, k2, lo, hi, n, device)
    return ref.randint_ref(k1, k2, lo, hi, n, device)


def csr_row_sample(base, ov, rows: torch.Tensor, k1, k2
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """One column drawn uniformly from each row ``rows`` of the CSR
    ``base`` with its overlay ``ov`` -> (int32 samples, bool valid) shaped
    like ``rows``; k1, k2: the subkeys of ``split(key)``. On CUDA tensors
    one launch of the kernel; on CPU tensors ``ref.csr_row_sample_ref``."""
    if not rows.is_cuda:
        return ref.csr_row_sample_ref(base, ov, rows, k1, k2)
    overlay = None if ov is None else (ov.dirty, ov.delta.indptr, ov.delta.indices)
    flat = rows.reshape(-1).to(torch.int32).contiguous()
    sample, valid = csr_row_sample_cuda(base.indptr, base.indices, flat, k1, k2,
                                        overlay=overlay)
    return sample.reshape(rows.shape), valid.reshape(rows.shape)


# ---------------------------------------------------------------------------
# segmented union (pseudo-projection GetNodeAlters)
# ---------------------------------------------------------------------------


def segmented_union(
    flat: torch.Tensor, max_out: int, *, tile: int = MAX_FLAT
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dedup + sort + compact SENTINEL-padded rows -> (int32[..., max_out], mask).

    Rows up to ``tile`` wide go through one in-block kernel on the card
    (the plain sort on the CPU); wider rows take the wide route
    (``union_wide``)."""
    batch, k = flat.shape[:-1], flat.shape[-1]
    if k <= tile and not flat.is_cuda:
        return ref.segmented_union_ref(flat, max_out)
    rows = flat.reshape(math.prod(batch), k).contiguous()
    if k > tile:
        out = union_wide(rows, max_out, tile=tile)
    else:
        out = segmented_union_cuda(rows, max_out)
    out = out.reshape(batch + (max_out,))
    return out, out != _SENT


def segmented_union_count(
    flat: torch.Tensor, *, tile: int = MAX_FLAT
) -> torch.Tensor:
    """Number of distinct non-SENTINEL values per row -> int32[...]: the
    filtered degree's count, with no row written out."""
    batch, k = flat.shape[:-1], flat.shape[-1]
    if k <= tile and not flat.is_cuda:
        return ref.segmented_union_count_ref(flat)
    rows = flat.reshape(math.prod(batch), k).contiguous()
    if k > tile:
        out = union_wide(rows, None, tile=tile)
    else:
        out = segmented_union_count_cuda(rows)
    return out.reshape(batch)


def union_wide_plan(
    rows: int, k: int, max_out: int | None, tile: int = MAX_FLAT
) -> tuple[int, int, int]:
    """``union_wide``'s plan for int32[rows, k]: (tiles a row, entries kept
    a tile, rows a chunk). Each chunk's two [rows, tiles * kept] run
    buffers together stay within the input's own size."""
    tiles = max(-(-k // tile), 1)
    m = tile if max_out is None else min(max_out, tile)
    return tiles, m, max(1, (rows * k) // (2 * tiles * m))


def union_wide(
    flat: torch.Tensor, max_out: int | None, *, tile: int = MAX_FLAT
) -> torch.Tensor:
    """Rows of int32[B, K] wider than ``tile`` -> int32[B, max_out] sorted
    uniques (``max_out=None``: their number, int32[B]).

    Each row is cut into T = ceil(K / tile) tiles; each tile keeps its
    sorted uniques capped at m = min(max_out, tile) (the smallest max_out
    uniques of a row are among the smallest max_out of each tile), the T
    runs merge pairwise, ceil(log2(T)) levels, and one pass keeps the
    distinct values. Each step is a kernel on the card and its plain
    version on the CPU. Rows go in chunks (``union_wide_plan``).
    """
    B, K = flat.shape
    tiles, m, chunk = union_wide_plan(B, K, max_out, tile)
    n = tiles * m
    on_card = flat.is_cuda
    parts = []
    for r0 in range(0, B, chunk):
        part = flat[r0:r0 + chunk]
        if on_card:
            runs = union_tiles_cuda(part, tile, m)
        else:
            runs = ref.union_tiles_ref(part, tile, m)
        run = m
        while run < n:
            runs = (union_merge_cuda(runs, run) if on_card
                    else ref.union_merge_ref(runs, run))
            run *= 2
        parts.append(union_compact_cuda(runs, max_out) if on_card
                     else ref.compact_sorted_ref(runs, max_out))
    if not parts:
        shape = (0,) if max_out is None else (0, max_out)
        return torch.empty(shape, dtype=torch.int32, device=flat.device)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


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
    tile: int = MAX_FLAT,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LayerTwoMode.node_alters: two-hop gather then segmented union.

    ``width_m`` / ``width_n`` override the gather pad widths (membership
    count / hyperedge size); None means the layer-global maxima.
    ``node_filter`` (device bool[n_nodes]) drops gathered co-members that
    fail a predicate before the union, so the cap applies post-filter.
    ``use_kernel=False`` dedups with the plain sort path (the padded
    oracle); ``tile`` is ``segmented_union``'s.
    """
    flat = pseudo_alters_flat(layer, u, width_m=width_m, width_n=width_n,
                              node_filter=node_filter)
    if use_kernel:
        return segmented_union(flat, max_alters, tile=tile)
    return ref.segmented_union_ref(flat, max_alters)


def pseudo_alters_flat(
    layer,
    u: torch.Tensor,
    *,
    width_m: int | None = None,
    width_n: int | None = None,
    node_filter: torch.Tensor | None = None,
) -> torch.Tensor:
    """The two-hop gather of ``pseudo_node_alters`` before its union:
    int32[..., wm * wn] co-members of u, SENTINEL where a slot is padding,
    fails ``node_filter`` or is u itself."""
    he, he_mask = layer.memberships(u, width_m)
    wn = layer.max_hyperedge_size if width_n is None else max(width_n, 1)
    mem, mem_mask = layer.member_rows(torch.where(he_mask, he, 0), wn)
    mem_mask = mem_mask & he_mask[..., None]
    if node_filter is not None:
        mem_mask = mem_mask & take_clip(node_filter, mem)
    flat = torch.where(mem_mask, mem, _SENT).reshape(u.shape + (-1,))
    return torch.where(flat == u[..., None], _SENT, flat)  # drop ego


# ---------------------------------------------------------------------------
# DTensor operands: each rank's kernel on its own shard
# ---------------------------------------------------------------------------


def _dt():
    from torch.distributed import tensor

    return tensor


def is_placed(t) -> bool:
    """Whether ``t`` is a DTensor."""
    return isinstance(t, _dt().DTensor)


def _local_layout(t, dims) -> list:
    """``t``'s placements where they split one of ``dims`` evenly (every
    rank's share the same size), ``Replicate()`` on the other mesh dims: a
    partial sum, a split of another dim, or an uneven one is made whole."""
    mesh = t.device_mesh
    ways = {d: math.prod(mesh.size(m) for m, p in enumerate(t.placements)
                         if p.is_shard(d)) for d in dims}
    return [p if any(p.is_shard(d) and t.shape[d] % ways[d] == 0 for d in dims)
            else _dt().Replicate() for p in t.placements]


def _as(t, mesh, placements) -> torch.Tensor:
    """``t`` laid out by ``placements`` over ``mesh``; a plain tensor (the
    same on every rank) is taken as whole."""
    dt = _dt()
    if not is_placed(t):
        t = dt.DTensor.from_local(t, mesh, [dt.Replicate()] * mesh.ndim, run_check=False)
    return t if list(t.placements) == placements else t.redistribute(mesh, placements)


def _batch_only(placements) -> list:
    """The placements that split dim 0 (the batch); ``Replicate()`` else."""
    return [p if p.is_shard(0) else _dt().Replicate() for p in placements]


def _grad_placements(operand, out) -> list:
    """The placements of an operand's gradient as a rank's kernel gives it:
    a partial sum on each mesh dim where the operand is replicated and the
    output sharded, the operand's own placement elsewhere."""
    dt = _dt()
    return [dt.Partial() if isinstance(o, dt.Shard) and not isinstance(p, dt.Shard)
            else p for p, o in zip(operand, out)]


def _local_map(fn, out, ins, grads, mesh):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh)


def _kv_for_heads(k, v, h0: int, hl: int, group: int):
    """The kv heads that q heads [h0, h0 + hl) read (head h reads h // group),
    laid out so that the kernel's own grouping maps local head j to them: a
    slice where the range covers whole groups or one group, else one kv
    head a q head."""
    lo, hi = h0 // group, (h0 + hl - 1) // group + 1
    if hi - lo == 1 or (h0 % group == 0 and hl % group == 0):
        return k[:, lo:hi], v[:, lo:hi]
    idx = torch.arange(h0, h0 + hl, device=k.device) // group
    return k.index_select(1, idx), v.index_select(1, idx)


def _flash_placed(q, k, v, causal: bool, scale: float):
    """``flash_attention`` on DTensors: q on its batch and head shards as
    it lies (the layer puts batch on dp and heads on tp). k and v take q's
    batch shards, and its head shards where the kv heads divide as many
    ways; else every rank holds them all and hands its kernel the ones its
    q heads read (their gradient a partial sum)."""
    mesh, Hq, Hkv = q.device_mesh, q.shape[1], k.shape[1]
    qp = _local_layout(q, (0, 1))
    heads = [m for m, p in enumerate(qp) if p.is_shard(1)]
    ways = math.prod(mesh.size(m) for m in heads)
    split = Hkv % ways == 0  # each rank's q heads read only its own kv heads
    kvp = qp if split else _batch_only(qp)
    q, k, v = _as(q, mesh, qp), _as(k, mesh, kvp), _as(v, mesh, kvp)
    h0 = 0
    for m in heads:  # a dim split over several mesh dims: major to minor
        h0 = h0 * mesh.size(m) + mesh.get_local_rank(m)
    h0 *= Hq // ways

    def local(ql, kl, vl):
        if not split:
            kl, vl = _kv_for_heads(kl, vl, h0, ql.shape[1], Hq // Hkv)
        return flash_attention(ql, kl, vl, causal=causal, scale=scale)

    kvg = _grad_placements(kvp, qp)
    return _local_map(local, qp, (qp, kvp, kvp), (qp, kvg, kvg), mesh)(q, k, v)


def _ssd_placed(x, dt_, a_log, bmat, cmat, chunk: int):
    """``ssd_scan`` on DTensors: x on its batch and head shards as it lies
    (the layer puts batch on dp and heads on tp), dt and a_log with it; B
    and C, shared by the heads, on x's batch shards and whole on the
    rest."""
    mesh = x.device_mesh
    xp = _local_layout(x, (0, 1))
    bp = _batch_only(xp)
    x, dt_, a_log = (_as(t, mesh, xp) for t in (x, dt_, a_log))
    bmat, cmat = _as(bmat, mesh, bp), _as(cmat, mesh, bp)
    bg = _grad_placements(bp, xp)
    return _local_map(
        lambda *a: ssd_scan(*a, chunk=chunk), xp, (xp, xp, xp, bp, bp),
        (xp, xp, xp, bg, bg), mesh)(x, dt_, a_log, bmat, cmat)


def _rglru_placed(a, b, h0):
    """``rglru_scan`` on DTensors: a on its batch and channel shards as it
    lies, b with it, h0 (B, dr) on the same shards."""
    mesh = a.device_mesh
    ap = _local_layout(a, (0, 2))
    a, b = _as(a, mesh, ap), _as(b, mesh, ap)
    if h0 is None:
        return _local_map(lambda al, bl: rglru_scan(al, bl), ap, (ap, ap), (ap, ap),
                          mesh)(a, b)
    hp = [_dt().Shard(1) if p.is_shard(2) else p for p in ap]
    h0 = _as(h0, mesh, hp)
    return _local_map(rglru_scan, ap, (ap, ap, hp), (ap, ap, hp), mesh)(a, b, h0)


def _rmsnorm_placed(x, w, eps: float, plus_one: bool):
    """``rmsnorm`` on DTensors: rows as ``x`` lies (its last dim whole), the
    weight whole on every rank (its gradient a partial sum over the mesh
    dims that split the rows)."""
    mesh = x.device_mesh
    xp = _local_layout(x, range(x.ndim - 1))
    whole = [_dt().Replicate()] * mesh.ndim
    x, w = _as(x, mesh, xp), _as(w, mesh, whole)
    return _local_map(lambda xl, wl: rmsnorm(xl, wl, eps=eps, plus_one=plus_one), xp,
                      (xp, whole), (xp, _grad_placements(whole, xp)), mesh)(x, w)


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
    if is_placed(q):
        return _flash_placed(q, k, v, causal, scale)
    if not q.is_cuda:
        return ref.attention_heads_ref(q, k, v, scale=scale, causal=causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, causal)
    return flash_attention_cuda(q, k, v, scale=scale, causal=causal)


class _FlashAttention(torch.autograd.Function):
    """The flash kernel with the hand-written backward, for calls under
    grad (an ordinary call launches the forward alone and writes nothing
    more). Saves q, k and v as they lie (the layer's transposed views of
    [B, S, H, D]), which the backward kernels read at their strides, with
    the forward's o and, on the tensor-core route, its o_lo and lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, o_lo, lse = flash_attention_cuda(q, k, v, scale=scale, causal=causal,
                                            residuals=True)
        ctx.save_for_backward(q, k, v, o, o_lo, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, o_lo, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, do.to(q.dtype), o, o_lo, lse, scale=ctx.scale, causal=ctx.causal)
        return dq, dk, dv, None, None


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
    ``ref.ssd_scan_heads_ref`` (autograd differentiates it). On the card the
    route is ``ssd_scan.uses_tensor_cores``'s: bf16 at mamba2's widths on
    the tensor cores, f32 and other shapes on the CUDA cores; the gradient
    is the backward kernels'."""
    if is_placed(x):
        return _ssd_placed(x, dt, a_log, bmat, cmat, chunk)
    if x.is_cuda:
        return _SSDScan.apply(x, dt, a_log, bmat, cmat, chunk)
    return ref.ssd_scan_heads_ref(x, dt, a_log, bmat, cmat, chunk=chunk)


class _SSDScan(torch.autograd.Function):
    """The SSD scan kernel with the hand-written backward. Saves the
    operands as they lie (the layer's views); the backward kernels recompute
    the chunks' states from them."""

    @staticmethod
    def forward(ctx, x, dt, a_log, bmat, cmat, chunk):
        ctx.save_for_backward(x, dt, a_log, bmat, cmat)
        ctx.chunk = chunk
        return ssd_scan_cuda(x, dt, a_log, bmat, cmat, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, a_log, bmat, cmat = ctx.saved_tensors
        grads = ssd_scan_bwd_cuda(x, dt, a_log, bmat, cmat, dy.to(x.dtype),
                                  chunk=ctx.chunk)
        return (*grads, None)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------


def rglru_scan(
    a: torch.Tensor,  # (B, S, dr) f32
    b: torch.Tensor,  # (B, S, dr) f32
    h0: torch.Tensor | None = None,  # (B, dr) f32, or None for 0
) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t h_(t-1) + b_t`` -> every h_t
    (B, S, dr) f32; on the CPU ``ref.rglru_scan_ref`` (autograd
    differentiates it), on the card the kernel and its backward kernel."""
    if is_placed(a):
        return _rglru_placed(a, b, h0)
    if a.is_cuda:
        return _RGLRUScan.apply(a, b, h0)
    return ref.rglru_scan_ref(a, b, h0)


class _RGLRUScan(torch.autograd.Function):
    """The RG-LRU scan kernel with the hand-written backward, which reads a,
    h0 and the saved output h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        return rglru_scan_bwd_cuda(a, h, h0, dh.float())


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
    if is_placed(x):
        return _rmsnorm_placed(x, w, eps, plus_one)
    if x.is_cuda:
        return _RMSNorm.apply(x, w, eps, plus_one)
    return ref.rmsnorm_ref(x, w, eps=eps, plus_one=plus_one)


class _RMSNorm(torch.autograd.Function):
    """The RMSNorm kernel with the hand-written backward: dx in x's dtype,
    dw in f32 (cast to w's dtype)."""

    @staticmethod
    def forward(ctx, x, w, eps, plus_one):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.plus_one = eps, plus_one
        return rmsnorm_cuda(x, w, eps=eps, plus_one=plus_one)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(x, w, dy.to(x.dtype), eps=ctx.eps,
                                  plus_one=ctx.plus_one)
        return dx, dw.to(w.dtype), None, None
