"""Plain torch versions of the kernels (the correctness contracts).

Each function is the simplest obviously-correct implementation, ported
from ``src/repro/kernels/ref.py``. They run wherever torch runs: the CPU
tests use them as the port's path, and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.csr import (
    SENTINEL, padded_unique, sorted_isin, take_clip, take_ids,
)
from repro_torch.core.overlay import eff_row_gather, eff_row_lengths

_SENT = int(SENTINEL)


def intersect_count_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|row_a ∩ row_b| for SENTINEL-padded rows with unique real entries.

    a: int32[B, Ka], b: int32[B, Kb] -> int32[B]. All-pairs equality.
    """
    valid = a != _SENT
    eq = (a[:, :, None] == b[:, None, :]) & valid[:, :, None]
    return eq.sum(dim=(1, 2)).to(torch.int32)


def intersect_rows_ref(base, ov, u, v, node_filter, widths) -> torch.Tensor:
    """|row(u[i]) ∩ row(v[i])| over the effective rows of the membership
    CSR ``base`` with its overlay ``ov`` -> int32[B], 0 where v[i] fails
    ``node_filter`` (bool[n], clipped): the degree-bucketed route.

    Pairs that fail the filter are dropped first. The rest are bucketed by
    max(deg u, deg v) on the ladder ``widths`` closed by the batch's
    largest degree; each bucket's rows are gathered at its width
    (``eff_row_gather``) and counted by binary search (``sorted_isin``, the
    JAX package's bucket body off its TPU kernel), which holds O(B * width)
    memory where an all-pairs count holds O(B * width^2).
    """
    out = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    pos = torch.arange(u.shape[0], device=u.device)
    if node_filter is not None:
        pos = pos[take_clip(node_filter, v)]
    u, v = u[pos], v[pos]
    deg = torch.maximum(eff_row_lengths(base, ov, u), eff_row_lengths(base, ov, v))
    if deg.numel() == 0:
        return out
    top = max(int(deg.max()), 1)
    lo = -1
    for w in [w for w in widths if w < top] + [top]:
        sel = (deg > lo) & (deg <= w)
        lo = w
        if not bool(sel.any()):
            continue
        a, am = eff_row_gather(base, ov, u[sel], w)
        b, bm = eff_row_gather(base, ov, v[sel], w)
        out[pos[sel]] = sorted_isin(a, am, b, bm).sum(dim=-1).to(torch.int32)
    return out


def segmented_union_ref(
    flat: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dedup of SENTINEL-padded rows, capped at ``max_out``.

    flat: int32[..., K] (unsorted, duplicates allowed) ->
    (int32[..., max_out] sorted unique SENTINEL-padded, mask).
    """
    uniq, mask = padded_unique(flat, flat != _SENT)
    k = uniq.shape[-1]
    if k < max_out:
        pad = (0, max_out - k)
        uniq = torch.nn.functional.pad(uniq, pad, value=_SENT)
        mask = torch.nn.functional.pad(mask, pad, value=False)
    return uniq[..., :max_out], mask[..., :max_out]


def segmented_union_count_ref(flat: torch.Tensor) -> torch.Tensor:
    """Distinct non-SENTINEL values per row: int32[..., K] -> int32[...]."""
    return compact_sorted_ref(torch.sort(flat, dim=-1).values, None)


# The wide route's three steps (``ops.segmented_union`` on rows wider than
# its tile): tile uniques, pairwise merges of sorted runs, one compaction.


def union_tiles_ref(flat: torch.Tensor, tile: int, m: int) -> torch.Tensor:
    """Each row of int32[B, K] cut into T = ceil(K / tile) tiles, each tile's
    sorted uniques capped at ``m`` -> int32[B, T * m] (T sorted runs)."""
    B, K = flat.shape
    tiles = max(-(-K // tile), 1)
    padded = torch.nn.functional.pad(flat, (0, tiles * tile - K), value=_SENT)
    runs, _ = segmented_union_ref(padded.reshape(B * tiles, tile), m)
    return runs.reshape(B, tiles * m)


def union_merge_ref(x: torch.Tensor, run: int) -> torch.Tensor:
    """Rows of sorted runs of ``run`` entries -> rows of sorted runs of
    ``2 * run`` (a sort of each window of two runs is their merge)."""
    B, n = x.shape
    w = 2 * run
    full = -(-n // w) * w
    padded = torch.nn.functional.pad(x, (0, full - n), value=_SENT)
    merged = torch.sort(padded.reshape(B, full // w, w), dim=-1).values
    return merged.reshape(B, full)[:, :n]


def compact_sorted_ref(x: torch.Tensor, max_out: int | None) -> torch.Tensor:
    """Sorted rows (SENTINEL last) -> their distinct non-SENTINEL values,
    int32[..., max_out] SENTINEL-padded, or with ``max_out=None`` their
    number, int32[...]."""
    keep = x != _SENT
    keep[..., 1:] &= x[..., 1:] != x[..., :-1]
    if max_out is None:
        return keep.sum(dim=-1).to(torch.int32)
    rank = torch.cumsum(keep, dim=-1) - 1
    slot = torch.where(keep & (rank < max_out), rank, max_out)
    out = torch.full(x.shape[:-1] + (max_out + 1,), _SENT, dtype=x.dtype,
                     device=x.device)
    out.scatter_(-1, slot, torch.where(slot < max_out, x, _SENT))
    return out[..., :max_out]


def frontier_ref(
    cand: torch.Tensor, visited: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Next-frontier oracle: drop candidates present in the visited row,
    then dedup/sort/cap like ``segmented_union_ref``.

    cand: int32[..., Kc] SENTINEL-padded (unsorted, duplicates allowed);
    visited: int32[..., Kv] SENTINEL-padded (any order). All-pairs
    membership, O(Kc*Kv): the simplest obviously-correct form.
    """
    valid = cand != _SENT
    seen = (
        (cand[..., :, None] == visited[..., None, :]) & valid[..., :, None]
    ).any(dim=-1)
    flat = torch.where(valid & ~seen, cand, _SENT)
    return segmented_union_ref(flat, max_out)


def frontier_search_ref(
    cand: torch.Tensor, visited_sorted: torch.Tensor, max_out: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``frontier_ref`` by binary search, O(Kc log Kv): the plain path of
    ``ops.frontier_compact``. Each visited row must be sorted ascending
    (SENTINEL pads last); outputs are bit-identical to ``frontier_ref``.
    """
    valid = cand != _SENT
    seen = sorted_isin(cand, valid, visited_sorted, visited_sorted != _SENT)
    flat = torch.where(valid & ~seen, cand, _SENT)
    return segmented_union_ref(flat, max_out)


def filtered_alters_ref(
    vals: torch.Tensor,
    mask: torch.Tensor,
    node_filter: torch.Tensor,
    max_out: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Post-filter oracle for attribute-filtered GetNodeAlters: drop the
    alters of an UNfiltered full-width result that fail ``node_filter``,
    then re-compact to ``max_out`` sorted-unique entries."""
    keep = mask & take_clip(node_filter, torch.where(mask, vals, 0))
    flat = torch.where(keep, vals, _SENT)
    return segmented_union_ref(flat, max_out)


def filtered_degree_ref(
    vals: torch.Tensor, mask: torch.Tensor, node_filter: torch.Tensor
) -> torch.Tensor:
    """Post-filter oracle for attribute-filtered degree: count the alters
    of an UNfiltered full-width query that pass ``node_filter``."""
    keep = mask & take_clip(node_filter, torch.where(mask, vals, 0))
    return keep.sum(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Threefry draws (``core/prng.py``): bits, randint, CSR row samples
# ---------------------------------------------------------------------------
#
# uint32 words are held in int64 tensors, masked to 32 bits after every
# add and shift (torch has few uint32 ops); results come out as int32
# tensors holding the same bits.

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32_ref(key, x0: torch.Tensor, x1: torch.Tensor):
    """threefry-2x32 (20 rounds) of counter words x0, x1 (int64 in
    [0, 2^32)) under ``key``, a pair of uint32 ints -> two int64 words."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _bits64(key, n: int, device) -> torch.Tensor:
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32_ref(key, i >> 32, i & _M32)
    return b0 ^ b1


def threefry_bits_ref(key, n: int, device) -> torch.Tensor:
    """Element i of ``jax.random.bits(key, (n,))`` (partitionable scheme:
    the xor of the hash of counter (i >> 32, i & 0xFFFFFFFF)) -> int32[n]."""
    return _as_int32(_bits64(key, n, device))


def randint_ref(k1, k2, lo, hi, n: int, device) -> torch.Tensor:
    """``jax.random.randint``'s reduction for int32 over subkeys k1, k2 (the
    two halves of ``split(key)``) -> int32[n]. ``lo`` and ``hi`` are ints
    or int32[n] tensors; span = uint32(hi - lo), 1 where hi <= lo; the
    products and the sum wrap mod 2^32 as JAX's uint32 arithmetic does (so
    the multiplier (2^16 mod span)^2 is 0 for any span above 2^16)."""
    higher, lower = _bits64(k1, n, device), _bits64(k2, n, device)
    lo64 = lo.to(torch.int64) if isinstance(lo, torch.Tensor) else int(lo)
    hi64 = hi.to(torch.int64) if isinstance(hi, torch.Tensor) else int(hi)
    span = torch.full((n,), 0, dtype=torch.int64, device=device) + ((hi64 - lo64) & _M32)
    span = torch.where(torch.as_tensor(hi64 <= lo64, device=device), 1, span)
    mult = torch.remainder(2**16, span)
    mult = torch.remainder((mult * mult) & _M32, span)  # 2^16 * 2^16 wraps to 0
    off = ((torch.remainder(higher, span) * mult) & _M32) + torch.remainder(lower, span)
    off = torch.remainder(off & _M32, span)
    return _as_int32((lo64 + off) & _M32)


def _csr_row_sample_one(csr, rows: torch.Tensor, k1, k2):
    r = rows.reshape(-1).long()
    start = take_clip(csr.indptr, r).long()
    length = take_clip(csr.indptr, r + 1).long() - start
    own = rows.reshape(-1).to(torch.int32)
    if csr.nnz == 0:
        return own, torch.zeros(own.shape, dtype=torch.bool, device=own.device)
    draw = randint_ref(k1, k2, 0, length.clamp(min=1), r.numel(), r.device)
    sample = take_ids(csr.indices, (start + draw).clamp(0, csr.nnz - 1))
    valid = length > 0
    return torch.where(valid, sample, own), valid


def csr_row_sample_ref(base, ov, rows: torch.Tensor, k1, k2):
    """``csr_row_sample`` (``eff_row_sample`` with an overlay): one column
    drawn uniformly from each queried row -> (int32 samples, bool valid),
    shaped like ``rows``. Row r's bounds are indptr[clip(r)] and
    indptr[clip(r + 1)]; the draw is ``randint`` over subkeys k1, k2 with
    span max(length, 1); an empty row gives r itself and valid False.
    With a delta overlay both branches draw with the same subkeys and
    dirty[clip(r)] picks the delta's."""
    sample, valid = _csr_row_sample_one(base, rows, k1, k2)
    if ov is not None:
        sd, vd = _csr_row_sample_one(ov.delta, rows, k1, k2)
        d = take_clip(ov.dirty, rows.reshape(-1))
        sample, valid = torch.where(d, sd, sample), torch.where(d, vd, valid)
    return sample.reshape(rows.shape), valid.reshape(rows.shape)


# ---------------------------------------------------------------------------
# LM kernels (float): attention, SSD scan, RMSNorm
# ---------------------------------------------------------------------------


def attention_ref(
    q: torch.Tensor,  # (BH, S, D)
    k: torch.Tensor,  # (BHkv, S, D)
    v: torch.Tensor,  # (BHkv, S, D)
    *,
    scale: float,
    causal: bool = True,
    kv_group: int = 1,
) -> torch.Tensor:
    """Naive softmax attention with GQA via explicit kv repeat (row
    ``bh`` of q reads kv row ``bh // kv_group``); f32 math, masked
    scores -1e30, output in q's dtype."""
    if kv_group > 1:
        k = torch.repeat_interleave(k, kv_group, dim=0)
        v = torch.repeat_interleave(v, kv_group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask[None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def attention_heads_ref(
    q: torch.Tensor,  # (B, Hq, S, D)
    k: torch.Tensor,  # (B, Hkv, S, D)
    v: torch.Tensor,  # (B, Hkv, S, D)
    *,
    scale: float,
    causal: bool = True,
) -> torch.Tensor:
    """``attention_ref`` in the op's (B, H, S, D) layout, any strides:
    q head h reads kv head h // (Hq / Hkv)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    out = attention_ref(q.reshape(B * Hq, S, D), k.reshape(B * Hkv, S, D),
                        v.reshape(B * Hkv, S, D), scale=scale, causal=causal,
                        kv_group=Hq // Hkv)
    return out.reshape(B, Hq, S, D)


def ssd_scan_ref(
    x: torch.Tensor,  # (BH, S, P)
    dt: torch.Tensor,  # (BH, S)
    a_log: torch.Tensor,  # (BH, S) log-decay per step (dt * A, negative)
    bmat: torch.Tensor,  # (BH, S, N)
    cmat: torch.Tensor,  # (BH, S, N)
) -> torch.Tensor:
    """Sequential SSD recurrence: S_t = a_t S_{t-1} + (dt_t B_t) x_t^T,
    y_t = C_t S_t, in f32. The oracle for the chunked forms."""
    BH, S, P = x.shape
    N = bmat.shape[-1]
    xf, dtf, af = x.float(), dt.float(), a_log.float()
    bf, cf = bmat.float(), cmat.float()
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = torch.exp(af[:, t])[:, None, None] * state + (
            (dtf[:, t, None] * bf[:, t])[:, :, None] * xf[:, t, None, :]
        )
        ys.append(torch.einsum("bn,bnp->bp", cf[:, t], state))
    if not ys:
        return torch.zeros_like(x)
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_scan_chunked_ref(
    x: torch.Tensor,  # (BH, S, P)
    dt: torch.Tensor,  # (BH, S)
    a_log: torch.Tensor,  # (BH, S)
    bmat: torch.Tensor,  # (BH, S, N)
    cmat: torch.Tensor,  # (BH, S, N)
    chunk: int = 128,
) -> torch.Tensor:
    """Chunked SSD in plain torch: per chunk of Q steps, the intra-chunk
    (L ∘ C B̃ᵀ) X, the inter-chunk C·exp(l)·S_prev and the state pass,
    with the (N, P) state carried across chunks. S must be a multiple of
    ``min(chunk, S)``."""
    BH, S, P = x.shape
    N = bmat.shape[-1]
    chunk = min(chunk, S)
    assert S % chunk == 0
    nc = S // chunk
    f32 = torch.float32
    xc = x.reshape(BH, nc, chunk, P).to(f32)
    dtc = dt.reshape(BH, nc, chunk, 1).to(f32)
    ac = a_log.reshape(BH, nc, chunk, 1).to(f32)
    bc = bmat.reshape(BH, nc, chunk, N).to(f32)
    cc = cmat.reshape(BH, nc, chunk, N).to(f32)
    lower = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    state = torch.zeros((BH, N, P), dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xb, dtb, ab, bb, cb = xc[:, c], dtc[:, c], ac[:, c], bc[:, c], cc[:, c]
        l = torch.cumsum(ab, dim=1)  # (BH, Q, 1)
        # mask the EXPONENT, not the exp: exp(l_i - l_j) overflows for i < j
        diff = torch.where(lower, l - l.transpose(1, 2), -torch.inf)
        L = torch.exp(diff)
        bt = bb * dtb
        cb_t = torch.einsum("bqn,bkn->bqk", cb, bt)
        y = torch.einsum("bqk,bkp->bqp", cb_t * L, xb)
        y = y + torch.einsum("bqn,bnp->bqp", cb * torch.exp(l), state)
        l_tot = l[:, -1:]  # (BH, 1, 1)
        decay = torch.exp(l_tot - l)
        state = torch.exp(l_tot[:, 0])[..., None] * state + torch.einsum(
            "bkn,bkp->bnp", bt * decay, xb
        )
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(BH, S, P).to(x.dtype)


def ssd_scan_heads_ref(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S)
    a_log: torch.Tensor,  # (B, H, S)
    bmat: torch.Tensor,  # (B, S, N) shared by the H heads
    cmat: torch.Tensor,  # (B, S, N)
    chunk: int = 128,
) -> torch.Tensor:
    """The plain path of ``ops.ssd_scan`` in its (B, H, S, P) layout, as the
    JAX op's: B and C repeated over the heads, then the chunked form when S
    is a multiple of ``min(chunk, S)``, else the sequential one."""
    B, H, S, P = x.shape
    N = bmat.shape[-1]
    flat = (
        x.reshape(B * H, S, P), dt.reshape(B * H, S), a_log.reshape(B * H, S),
        bmat[:, None].expand(B, H, S, N).reshape(B * H, S, N),
        cmat[:, None].expand(B, H, S, N).reshape(B * H, S, N),
    )
    if S and S % min(chunk, S) == 0:
        out = ssd_scan_chunked_ref(*flat, chunk=min(chunk, S))
    else:
        out = ssd_scan_ref(*flat)
    return out.reshape(B, H, S, P)


def rmsnorm_ref(
    x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
    plus_one: bool = False,
) -> torch.Tensor:
    """x·rsqrt(mean(x²)+eps)·(w [+1]) with the JAX reference's rounding:
    the mean square in f32, then ``mult`` and ``scale`` rounded to x's
    dtype before the two multiplies (``src/repro/kernels/ref.py:224-230``).
    The CUDA kernel rounds once, at the end; in bf16 the two differ by a
    few ulp."""
    ms = x.float().square().mean(dim=-1)
    mult = torch.rsqrt(ms + eps)[..., None].to(x.dtype)
    wf = w.float()
    scale = (wf + 1.0 if plus_one else wf).to(x.dtype)
    return x * mult * scale


def rmsnorm_bwd_ref(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6,
    plus_one: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``rmsnorm_ref`` in f32 by ``torch.autograd.grad``:
    (dx, dw) for an output gradient ``dy``, both f32 (the plain version of
    the backward kernel, which rounds dx to x's dtype)."""
    with torch.enable_grad():
        xf = x.detach().float().requires_grad_(True)
        wf = w.detach().float().requires_grad_(True)
        y = rmsnorm_ref(xf, wf, eps=eps, plus_one=plus_one)
        dx, dw = torch.autograd.grad(y, (xf, wf), dy.float())
    return dx, dw


def attention_bwd_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    scale: float, causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``attention_heads_ref`` in f32 by
    ``torch.autograd.grad``: (dq, dk, dv) for an output gradient ``do``, all
    f32 (the plain version of the flash backward kernels)."""
    with torch.enable_grad():
        qf, kf, vf = (t.detach().float().requires_grad_(True) for t in (q, k, v))
        o = attention_heads_ref(qf, kf, vf, scale=scale, causal=causal)
        return torch.autograd.grad(o, (qf, kf, vf), do.float())


def attention_residuals_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What the tensor-core forward writes under grad, in plain torch: the
    output o in q's dtype, o_lo = (o_f32 - o) rounded to q's dtype, and each
    row's natural log-sum-exp of its scaled, masked scores, f32 [B·Hq, S]
    (q (B, Hq, S, D), k, v (B, Hkv, S, D))."""
    B, Hq, S, D = q.shape
    group = Hq // k.shape[1]
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    if causal:
        s = torch.where(torch.ones((S, S), dtype=torch.bool, device=q.device).tril(),
                        s, -1e30)
    o32 = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vf)
    o = o32.to(q.dtype)
    return o, (o32 - o.float()).to(q.dtype), torch.logsumexp(s, dim=-1).reshape(B * Hq, S)


def _bf16_pair(x: torch.Tensor) -> torch.Tensor:
    """x as the kernels feed it to a bf16 product: hi = bf16(x) plus lo =
    bf16(x − hi), 16 significant bits, in f32."""
    hi = x.bfloat16().float()
    return hi + (x - hi).bfloat16().float()


def attention_bwd_blocked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    o: torch.Tensor, o_lo: torch.Tensor, lse: torch.Tensor, *, scale: float,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor-core flash backward's algorithm in plain torch, from the
    forward's o, o_lo and lse (``attention_residuals_ref``): Dd =
    rowsum(dO ∘ (o + o_lo)) in f32; S and dP = dO Vᵀ in f32; P =
    exp(S·scale − LSE), 0 where masked; dS = P ∘ (dP − Dd); P and dS each
    split into two bf16 parts, hi = bf16(x) and lo = bf16(x − hi), before the
    products dV = Pᵀ dO, dK = scale·dSᵀ Q and dQ = scale·dS K (f32 sums,
    the group's q heads summed into their kv head) -> (dq, dk, dv) in q's
    dtype. A single bf16 P or dS errs by 2^-9 of each term, which on
    gradients of standard-normal inputs reaches 1.8 times the backward's
    limit (2^-6 of each value plus 2^-10 of the largest)."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k.float(), group, dim=1)
    vf = torch.repeat_interleave(v.float(), group, dim=1)
    dd = (dof * (o.float() + o_lo.float())).sum(-1, keepdim=True)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    p = torch.exp(s * scale - lse.reshape(B, Hq, S, 1))
    if causal:
        p = torch.where(torch.ones((S, S), dtype=torch.bool, device=q.device).tril(),
                        p, 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - dd)
    p16, ds16 = _bf16_pair(p), _bf16_pair(ds)
    dv = torch.einsum("bhqk,bhqd->bhkd", p16, dof)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds16, qf) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds16, kf) * scale
    dk, dv = (t.reshape(B, Hkv, group, S, D).sum(2) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def rmsnorm_bwd_blocked(
    x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6,
    plus_one: bool = False, lanes: int, unroll: int, warps: int, blocks: int,
    split: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The register route of the RMSNorm backward (``rmsnorm_bwd_rows_kernel``
    then ``rmsnorm_dw_kernel``) in plain torch, with its launch plan
    (``rmsnorm.bwd_plan``, ``split`` its runs of partial rows): dx per
    row in f32, rounded once to x's dtype; dw = Σ dy·x·r summed in the
    kernels' order, each step rounded to f32. Row ((t·blocks + b)·warps +
    w)·G·unroll + u·G + g (G = 32 / lanes rows a warp at once) goes to lane
    group g of warp w of block b, which adds its rows t-major, u-minor; the
    lane groups fold in order, then the warps, into one partial row a
    block; run j of ``split`` sums partial rows j, j + split, ... in order,
    and dw is the runs summed in order -> (dx, dw f32)."""
    d = x.shape[-1]
    xf, gf = x.reshape(-1, d).float(), dy.reshape(-1, d).float()
    wf = w.float() + (1.0 if plus_one else 0.0)
    rows = xf.shape[0]
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    c = r ** 3 * (gf * wf * xf).mean(-1, keepdim=True)
    dx = (r * (gf * wf) - c * xf).to(x.dtype).reshape(x.shape)
    g = 32 // lanes
    per = blocks * warps * g * unroll
    n_it = -(-rows // per)
    terms = torch.zeros((n_it * per, d), dtype=torch.float32, device=x.device)
    terms[:rows] = gf * xf * r
    terms = terms.reshape(n_it, blocks, warps, unroll, g, d)
    acc = torch.zeros((blocks, warps, g, d), dtype=torch.float32, device=x.device)
    for t in range(n_it):
        for u in range(unroll):
            acc = acc + terms[t, :, :, u]
    lane = acc[:, :, 0]
    for k in range(1, g):
        lane = lane + acc[:, :, k]
    partial = lane[:, 0]
    for k in range(1, warps):
        partial = partial + lane[:, k]
    runs = []
    for j in range(split):
        run = torch.zeros((d,), dtype=torch.float32, device=x.device)
        for b in range(j, blocks, split):
            run = run + partial[b]
        runs.append(run)
    dw = runs[0]
    for run in runs[1:]:
        dw = dw + run
    return dx, dw


def rglru_scan_ref(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None
) -> torch.Tensor:
    """The RG-LRU recurrence ``h_t = a_t h_(t-1) + b_t`` over axis 1 of f32
    a, b (B, S, dr), from h0 (B, dr) or 0 -> every h_t (B, S, dr) f32: a
    sequential loop (the reference's ``jax.lax.associative_scan``,
    ``src/repro/models/layers.py:689``, associates in another order)."""
    a, b = a.float(), b.float()
    h = (torch.zeros_like(a[:, 0]) if h0 is None else h0.float())
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(
    a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None, dh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The gradient of ``rglru_scan_ref`` in f32 by ``torch.autograd.grad``:
    (da, db, dh0) for an output gradient ``dh`` (B, S, dr); dh0 is None
    without h0."""
    with torch.enable_grad():
        af, bf = (t.detach().float().requires_grad_(True) for t in (a, b))
        h0f = None if h0 is None else h0.detach().float().requires_grad_(True)
        h = rglru_scan_ref(af, bf, h0f)
        leaves = (af, bf) if h0f is None else (af, bf, h0f)
        grads = torch.autograd.grad(h, leaves, dh.float())
    return grads[0], grads[1], None if h0f is None else grads[2]


def rglru_scan_bwd_loop(
    a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor | None, dh: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """The backward kernel's algorithm (``csrc/rglru_scan.cu``) in plain
    torch, from a and the forward's output h: walking t from S-1 down,
    ``g = dh_t + a_(t+1) g`` (a product, then a sum, as the kernel rounds),
    ``db_t = g``, ``da_t = g h_(t-1)`` with ``h_(-1) = h0`` or 0, and
    ``dh0 = a_0 g`` -> (da, db, dh0) f32; dh0 is None without h0."""
    a, h, dh = a.float(), h.float(), dh.float()
    da, db = torch.empty_like(a), torch.empty_like(a)
    g = torch.zeros_like(a[:, 0])
    a_next = torch.zeros_like(g)
    start = g if h0 is None else h0.float()
    for t in reversed(range(a.shape[1])):
        g = dh[:, t] + a_next * g
        db[:, t] = g
        da[:, t] = g * (h[:, t - 1] if t else start)
        a_next = a[:, t]
    return da, db, None if h0 is None else a_next * g


def ssd_scan_bwd_ref(
    x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, bmat: torch.Tensor,
    cmat: torch.Tensor, dy: torch.Tensor, *, chunk: int = 128,
) -> tuple[torch.Tensor, ...]:
    """The gradient of ``ssd_scan_heads_ref`` in f32 by
    ``torch.autograd.grad``: (dx, ddt, da_log, dB, dC) for an output
    gradient ``dy`` (B, H, S, P), all f32; dB and dC (B, S, N) are summed
    over the H heads that share B and C."""
    with torch.enable_grad():
        leaves = [t.detach().float().requires_grad_(True)
                  for t in (x, dt, a_log, bmat, cmat)]
        y = ssd_scan_heads_ref(*leaves, chunk=chunk)
        return torch.autograd.grad(y, leaves, dy.float())


def ssd_scan_chunked_bwd(
    x: torch.Tensor,  # (B, H, S, P)
    dt: torch.Tensor,  # (B, H, S)
    a_log: torch.Tensor,  # (B, H, S)
    bmat: torch.Tensor,  # (B, S, N) shared by the H heads
    cmat: torch.Tensor,  # (B, S, N)
    dy: torch.Tensor,  # (B, H, S, P)
    *,
    chunk: int,
) -> tuple[torch.Tensor, ...]:
    """The SSD backward kernels' algorithm (``csrc/ssd_scan_bwd.cu``) in
    plain torch, explicit formulas and no autograd -> (dx, ddt, da_log, dB,
    dC) f32, dB and dC summed over the heads. Steps past S are zero-padded
    up to a multiple of ``chunk`` and take no gradient.

    Per chunk of Q steps (l the inclusive cumsum of a_log in the chunk,
    l_Q its last, B̃ = B dt, S_c the state entering the chunk, D the
    gradient of the state leaving it, L_ij = exp(l_i - l_j) for j <= i):

    - states pass: S_(c+1) = exp(l_Q) S_c + Σ_j exp(l_Q - l_j) B̃_j x_jᵀ;
    - reverse pass: D_(c-1) = exp(l_Q) D_c + Σ_i exp(l_i) C_i dy_iᵀ, from
      D = 0 for the last chunk;
    - per chunk, with M = (C B̃ᵀ) ∘ L and E = (dy xᵀ) ∘ L:
      dx = Mᵀ dy + exp(l_Q - l) ∘ (B̃ D); dB̃ = Eᵀ C + exp(l_Q - l) ∘ (x Dᵀ);
      dC = E B̃ + exp(l) ∘ (dy S_cᵀ); dB = dB̃ dt, ddt = rowsum(dB̃ ∘ B);
      dl_i = Σ_j R_ij - Σ_k R_ki (R = E ∘ C B̃ᵀ strictly below the
      diagonal) + exp(l_i) C_i·(S_c dy_i) - w_i, with w_j = exp(l_Q - l_j)
      B̃_j·(D x_j), and dl_Q also takes Σ_j w_j + exp(l_Q) <D, S_c>;
      da_log is dl summed from the end of the chunk back.
    """
    Bn, H, S, P = x.shape
    N = bmat.shape[-1]
    Q = max(int(chunk), 1)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32

    def split(t, seq_axis, shape):  # zero-pad the sequence axis, then cut it
        widths = [0, 0] * (t.dim() - seq_axis - 1) + [0, pad]
        return torch.nn.functional.pad(t.to(f32), widths).reshape(shape)

    xc, dyc = (split(t, 2, (Bn, H, nc, Q, P)) for t in (x, dy))
    dtc, ac = (split(t, 2, (Bn, H, nc, Q)) for t in (dt, a_log))
    bc, cc = (split(t, 1, (Bn, 1, nc, Q, N)) for t in (bmat, cmat))
    l = torch.cumsum(ac, dim=-1)
    lq = l[..., -1:]
    el, dec, eq = torch.exp(l), torch.exp(lq - l), torch.exp(lq[..., 0])
    bt = bc * dtc[..., None]

    local = torch.einsum("bhcqn,bhcqp->bhcnp", bt * dec[..., None], xc)
    s = torch.zeros((Bn, H, N, P), dtype=f32, device=x.device)
    states = []
    for c in range(nc):
        states.append(s)
        s = eq[:, :, c, None, None] * s + local[:, :, c]
    sc = torch.stack(states, dim=2) if states else local
    into = torch.einsum("bhcqn,bhcqp->bhcnp", cc * el[..., None], dyc)
    d = torch.zeros_like(s)
    ends = [d] * nc
    for c in reversed(range(nc)):
        ends[c] = d
        d = eq[:, :, c, None, None] * d + into[:, :, c]
    dend = torch.stack(ends, dim=2) if ends else into

    lower = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(lower, l[..., :, None] - l[..., None, :], -torch.inf))
    G = torch.einsum("bhcin,bhcjn->bhcij", cc, bc)
    M = G * dtc[..., None, :] * L
    E = torch.einsum("bhcip,bhcjp->bhcij", dyc, xc) * L
    R = torch.where(lower.tril(-1), E * G * dtc[..., None, :], 0.0)
    V = torch.einsum("bhcnp,bhcip->bhcin", sc, dyc)
    W = torch.einsum("bhcnp,bhcjp->bhcjn", dend, xc)
    dbt = torch.einsum("bhcij,bhcin->bhcjn", E, cc) + dec[..., None] * W
    w = dec * dtc * (bc * W).sum(-1)
    dl = R.sum(-1) - R.sum(-2) + el * (cc * V).sum(-1) - w
    dl[..., -1] += w.sum(-1) + eq * (dend * sc).sum((-1, -2))
    dx = torch.einsum("bhcij,bhcip->bhcjp", M, dyc) + (dec * dtc)[..., None] * (
        torch.einsum("bhcjn,bhcnp->bhcjp", bc.expand(-1, H, -1, -1, -1), dend))
    dc = (torch.einsum("bhcij,bhcjn->bhcin", E * dtc[..., None, :], bc)
          + el[..., None] * V)
    da = torch.flip(torch.cumsum(torch.flip(dl, (-1,)), -1), (-1,))
    ddt = (dbt * bc).sum(-1)

    def seq(t):  # (B, H?, nc, Q, ...) -> the first S steps
        return t.reshape(*t.shape[:2], nc * Q, *t.shape[4:])[:, :, :S]

    return (seq(dx), seq(ddt), seq(da),
            seq((dbt * dtc[..., None]).sum(1, keepdim=True))[:, 0],
            seq(dc.sum(1, keepdim=True))[:, 0])
