"""CSR (compressed sparse row) storage for the PyTorch port.

Same layout as the JAX package's ``core/csr.py``:

  indptr  : int32[n_rows + 1]   row offsets
  indices : uint16|int32[nnz]   column ids, sorted within each row
  values  : float32[nnz] | None optional edge values (valued layers)

Construction runs on the host in numpy (the chunked two-pass counting
sort, ported verbatim so identical inputs give byte-identical buffers);
the finished arrays are uploaded to ``device``. Each CSR also keeps a
host numpy mirror of ``indptr``: the degree-bucketed dispatcher plans
every query batch from row lengths, and reading a 10M-row ``indptr``
back from the card per batch would cost a 40 MB copy. Nothing in this
slice mutates a CSR, so the mirror cannot go stale.

Device queries are torch ops on int32 tensors. Torch indexing does not
clip, so every gather clamps its positions first, where the JAX package
relies on ``jnp.take(..., mode="clip")``. ``uint16`` indices are widened
to int32 as they are gathered (through an int16 view, which every torch
index kernel accepts), so narrowed storage is invisible to queries.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch

# Padding sentinel for gathered rows: INT32_MAX keeps sorted rows sorted.
SENTINEL = np.int32(2**31 - 1)

_INT32_MAX = 2**31 - 1
_UINT16_MAX = 2**16 - 1


def resolve_device(device=None) -> torch.device:
    """The device a builder places its tensors on.

    ``None`` means the CUDA card. Without one, ``None`` raises rather than
    quietly running on the CPU: a caller that wants the CPU says so.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclass(frozen=True)
class DtypePolicy:
    """Integer/value width policy for CSR storage (paper-scale memory knob).

    * ``narrow_indices`` — store column ids as uint16 when ``n_cols``
      fits (ids ≤ 65535), else int32.
    * ``widen_indptr`` — allow int64 row offsets when nnz exceeds the
      int32 range (host-side only: device queries need nnz < 2^31).
    * ``value_dtype`` — edge-value storage dtype (valued layers).
    """

    narrow_indices: bool = True
    widen_indptr: bool = True
    value_dtype: str = "float32"

    def index_dtype(self, n_cols: int) -> np.dtype:
        if n_cols - 1 > _INT32_MAX:
            raise ValueError(
                f"n_cols={n_cols} exceeds int32 id range; shard the layer"
            )
        if self.narrow_indices and n_cols - 1 <= _UINT16_MAX:
            return np.dtype(np.uint16)
        return np.dtype(np.int32)

    def indptr_dtype(self, nnz: int) -> np.dtype:
        if nnz > _INT32_MAX:
            if not self.widen_indptr:
                raise ValueError(
                    f"nnz={nnz} exceeds int32 indptr range; enable "
                    "widen_indptr or shard the layer"
                )
            return np.dtype(np.int64)
        return np.dtype(np.int32)

    def values_dtype(self) -> np.dtype:
        return np.dtype(self.value_dtype)


# Narrowing on: the engine-wide default.
DEFAULT_POLICY = DtypePolicy()
# The always-int32 layout.
POLICY_INT32 = DtypePolicy(narrow_indices=False)


@dataclass(frozen=True)
class CSR:
    indptr: torch.Tensor  # int32[n_rows + 1], on the device
    indices: torch.Tensor  # uint16|int32[nnz]
    values: torch.Tensor | None  # float32[nnz] | None
    n_rows: int
    n_cols: int
    indptr_host: np.ndarray  # host mirror of indptr (bucket planning)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    @property
    def nbytes(self) -> int:
        n = self.indptr.nbytes + self.indices.nbytes
        if self.values is not None:
            n += self.values.nbytes
        return int(n)

    def degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def max_degree(self) -> int:
        if self.nnz == 0:
            return 0
        return int(np.max(np.diff(self.indptr_host)))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """Host array -> tensor on ``device`` (read-only arrays are copied)."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def csr_from_arrays(
    indptr: np.ndarray,
    indices: np.ndarray,
    values: np.ndarray | None,
    n_rows: int,
    n_cols: int,
    device,
) -> CSR:
    """Upload host CSR buffers as they are (dtypes kept) to ``device``."""
    device = resolve_device(device)
    return CSR(
        indptr=to_tensor(indptr, device),
        indices=to_tensor(indices, device),
        values=None if values is None else to_tensor(values, device),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        indptr_host=np.ascontiguousarray(indptr),
    )


def take_ids(indices: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``indices[pos]`` widened to int32 (``pos`` already in range)."""
    if indices.dtype == torch.uint16:
        return indices.view(torch.int16)[pos].to(torch.int32) & 0xFFFF
    return indices[pos].to(torch.int32)


def widen_ids(indices: torch.Tensor) -> torch.Tensor:
    """Stored column ids as int32 (uint16 storage widens through int16)."""
    if indices.dtype == torch.uint16:
        return indices.view(torch.int16).to(torch.int32) & 0xFFFF
    return indices.to(torch.int32)


def take_clip(x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """``jnp.take(x, pos, mode="clip")``: out-of-range positions clamp."""
    return x[pos.long().clamp(0, x.shape[0] - 1)]


# ---------------------------------------------------------------------------
# Construction (host-side numpy): chunked two-pass counting sort
# ---------------------------------------------------------------------------

# Default COO chunk length for the streaming builders.
DEFAULT_CHUNK = 4_000_000


class ChunkArena:
    """Scratch buffers reused across COO chunks (sized to the largest)."""

    def __init__(self) -> None:
        self._bufs: dict[tuple[str, np.dtype], np.ndarray] = {}

    def get(self, name: str, n: int, dtype) -> np.ndarray:
        dtype = np.dtype(dtype)
        buf = self._bufs.get((name, dtype))
        if buf is None or buf.size < n:
            buf = np.empty(max(n, 1), dtype=dtype)
            self._bufs[(name, dtype)] = buf
        return buf[:n]


def _run_offsets(sorted_keys: np.ndarray, out: np.ndarray) -> np.ndarray:
    """Position of each element within its run of equal (sorted) keys."""
    n = sorted_keys.size
    if n == 0:
        return out[:0]
    starts = np.empty(n, dtype=np.int64)
    starts[0] = 0
    np.cumsum(sorted_keys[1:] != sorted_keys[:-1], out=starts[1:])
    run_first = np.zeros(int(starts[-1]) + 1, dtype=np.int64)
    first_mask = np.empty(n, dtype=bool)
    first_mask[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=first_mask[1:])
    run_first[starts[first_mask]] = np.flatnonzero(first_mask)
    offs = out[:n]
    np.subtract(np.arange(n, dtype=np.int64), run_first[starts], out=offs)
    return offs


def _stable_scatter_chunk(
    keys: np.ndarray,
    cursor: np.ndarray,
    payloads: list[tuple[np.ndarray, np.ndarray]],
    arena: ChunkArena,
) -> None:
    """One stable counting-sort placement step for a chunk.

    ``keys[i]`` names the destination bucket of element i; ``cursor``
    holds each bucket's next free position and is advanced in place.
    """
    n = keys.size
    if n == 0:
        return
    order = np.argsort(keys, kind="stable")
    sorted_keys = arena.get("keys", n, keys.dtype)
    np.take(keys, order, out=sorted_keys)
    offs = _run_offsets(sorted_keys, arena.get("offs", n, np.int64))
    dest = arena.get("dest", n, np.int64)
    np.add(cursor[sorted_keys], offs, out=dest)
    for src, dst in payloads:
        dst[dest] = src[order]
    cursor[:] += np.bincount(keys, minlength=cursor.size)


def _as_chunks(chunks) -> Iterator[tuple]:
    for ch in chunks:
        if isinstance(ch, np.ndarray):
            raise TypeError("chunks must be (rows, cols[, values]) tuples")
        yield ch if len(ch) == 3 else (ch[0], ch[1], None)


def coo_chunks_to_host_csr(
    chunks: Iterable[tuple],
    n_rows: int,
    n_cols: int,
    dedup: bool = True,
    sum_duplicates: bool = False,
    valued: bool = False,
    policy: DtypePolicy | None = None,
    arena: ChunkArena | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Host half of :func:`csr_from_coo_chunks` -> (indptr, indices, values).

    A two-pass counting sort (by column, then stably by row): rows come
    out column-sorted with arrival order kept among duplicates.
    ``dedup`` keeps the FIRST occurrence of a (row, col) pair;
    ``sum_duplicates`` accumulates values instead.
    """
    policy = DEFAULT_POLICY if policy is None else policy
    arena = ChunkArena() if arena is None else arena
    idx_dt = policy.index_dtype(n_cols)
    row_dt = np.dtype(np.int32) if n_rows - 1 <= _INT32_MAX else np.dtype(np.int64)
    val_dt = policy.values_dtype()

    # -- pass 0: validate, narrow, buffer, count ----------------------------
    rows_buf: list[np.ndarray] = []
    cols_buf: list[np.ndarray] = []
    vals_buf: list[np.ndarray] = []
    col_counts = np.zeros(n_cols, dtype=np.int64)
    row_counts = np.zeros(n_rows, dtype=np.int64)
    has_values = valued
    nnz = 0
    for rows, cols, values in _as_chunks(chunks):
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if rows.shape != cols.shape:
            raise ValueError("rows/cols shape mismatch")
        if rows.size == 0:
            continue
        if int(rows.min()) < 0 or int(rows.max()) >= n_rows:
            raise ValueError("row id out of range")
        if int(cols.min()) < 0 or int(cols.max()) >= n_cols:
            raise ValueError("col id out of range")
        col_counts += np.bincount(cols, minlength=n_cols)
        row_counts += np.bincount(rows, minlength=n_rows)
        rows_buf.append(rows.astype(row_dt, copy=rows.dtype != row_dt))
        cols_buf.append(cols.astype(idx_dt, copy=cols.dtype != idx_dt))
        if values is not None:
            has_values = True
        vals_buf.append(
            None if values is None else np.asarray(values, dtype=val_dt)
        )
        nnz += rows.size
    if has_values:
        vals_buf = [
            np.ones(r.size, dtype=val_dt) if v is None else v
            for r, v in zip(rows_buf, vals_buf)
        ]
    indptr_dt = policy.indptr_dtype(nnz)

    # -- pass 1: stable counting sort by COLUMN -----------------------------
    col_cursor = np.zeros(n_cols, dtype=np.int64)
    np.cumsum(col_counts[:-1], out=col_cursor[1:])
    col_indptr = np.concatenate([col_cursor, [nnz]])
    rows_by_col = np.empty(nnz, dtype=row_dt)
    vals_by_col = np.empty(nnz, dtype=val_dt) if has_values else None
    while rows_buf:
        r, c = rows_buf.pop(0), cols_buf.pop(0)
        v = vals_buf.pop(0) if vals_buf else None
        payloads = [(r, rows_by_col)]
        if has_values:
            payloads.append((v, vals_by_col))
        _stable_scatter_chunk(c, col_cursor, payloads, arena)

    # -- pass 2: stable counting sort by ROW over the col-ordered stream ----
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(row_counts, out=indptr[1:])
    row_cursor = indptr[:-1].copy()
    indices = np.empty(nnz, dtype=idx_dt)
    values_out = np.empty(nnz, dtype=val_dt) if has_values else None
    chunk = DEFAULT_CHUNK
    for s in range(0, nnz, chunk):
        e = min(s + chunk, nnz)
        r = rows_by_col[s:e]
        c_slice = arena.get("colof", e - s, idx_dt)
        np.subtract(
            np.searchsorted(col_indptr, np.arange(s, e), side="right"),
            1, out=arena.get("colof64", e - s, np.int64),
        )
        c_slice[:] = arena.get("colof64", e - s, np.int64)
        payloads = [(c_slice, indices)]
        if has_values:
            payloads.append((vals_by_col[s:e], values_out))
        _stable_scatter_chunk(r, row_cursor, payloads, arena)
    del rows_by_col, vals_by_col

    # -- dedup / duplicate accumulation (adjacent after the two passes) -----
    if (dedup or sum_duplicates) and nnz:
        uniq = np.empty(nnz, dtype=bool)
        uniq[0] = True
        np.not_equal(indices[1:], indices[:-1], out=uniq[1:])
        # equal cols across a row boundary are distinct pairs
        uniq[indptr[:-1][row_counts > 0]] = True
        if sum_duplicates and has_values:
            seg = np.cumsum(uniq) - 1
            values_out = np.bincount(seg, weights=values_out).astype(val_dt)
        elif has_values:
            values_out = values_out[uniq]
        indices = indices[uniq]
        kept_before = np.zeros(nnz + 1, dtype=np.int64)
        np.cumsum(uniq, out=kept_before[1:])
        indptr = kept_before[indptr]
        nnz = int(indices.size)
        indptr_dt = policy.indptr_dtype(nnz)

    if nnz >= int(SENTINEL):
        raise ValueError(
            "nnz exceeds the int32 device range; shard the layer "
            "(int64 indptr is host/serialization-only)"
        )
    return indptr.astype(indptr_dt, copy=False), indices, values_out


def csr_from_coo_chunks(
    chunks: Iterable[tuple],
    n_rows: int,
    n_cols: int,
    dedup: bool = True,
    sum_duplicates: bool = False,
    valued: bool = False,
    policy: DtypePolicy | None = None,
    arena: ChunkArena | None = None,
    device=None,
) -> CSR:
    """Build a CSR from an iterator of COO chunks — the streaming path.

    Each chunk is ``(rows, cols)`` or ``(rows, cols, values)``. The host
    build is :func:`coo_chunks_to_host_csr`; the buffers then go to
    ``device``.
    """
    indptr, indices, values = coo_chunks_to_host_csr(
        chunks, n_rows, n_cols, dedup=dedup, sum_duplicates=sum_duplicates,
        valued=valued, policy=policy, arena=arena,
    )
    return csr_from_arrays(indptr, indices, values, n_rows, n_cols, device)


def csr_from_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    n_rows: int,
    n_cols: int,
    values: np.ndarray | None = None,
    dedup: bool = True,
    sum_duplicates: bool = False,
    policy: DtypePolicy | None = None,
    device=None,
) -> CSR:
    """Build a CSR from COO pairs (single-chunk front end)."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    if rows.shape != cols.shape:
        raise ValueError("rows/cols shape mismatch")
    n = rows.size
    chunks: list[tuple] = []
    for s in range(0, max(n, 0), DEFAULT_CHUNK):
        e = min(s + DEFAULT_CHUNK, n)
        chunks.append((
            rows[s:e], cols[s:e],
            None if values is None else np.asarray(values)[s:e],
        ))
    return csr_from_coo_chunks(
        chunks, n_rows, n_cols,
        dedup=dedup, sum_duplicates=sum_duplicates,
        valued=values is not None, policy=policy, device=device,
    )


def csr_empty(
    n_rows: int, n_cols: int, valued: bool = False,
    policy: DtypePolicy | None = None, device=None,
) -> CSR:
    policy = DEFAULT_POLICY if policy is None else policy
    return csr_from_arrays(
        np.zeros(n_rows + 1, dtype=np.int32),
        np.zeros((0,), dtype=policy.index_dtype(n_cols)),
        np.zeros((0,), dtype=policy.values_dtype()) if valued else None,
        n_rows, n_cols, device,
    )


def host_csr_transpose(
    indptr: np.ndarray,
    indices: np.ndarray,
    vals: np.ndarray | None,
    n_rows: int,
    n_cols: int,
    policy: DtypePolicy | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Host transpose -> (indptr, indices, values) of the n_cols-row CSR.

    The CSR stream in storage order is sorted by (row, col); with roles
    swapped it is sorted by the new column, so one stable counting sort
    by new row finishes the transpose.
    """
    policy = DEFAULT_POLICY if policy is None else policy
    nnz = int(indices.size)
    idx_dt = policy.index_dtype(n_rows)
    out_counts = np.bincount(indices, minlength=n_cols)
    out_indptr = np.zeros(n_cols + 1, dtype=np.int64)
    np.cumsum(out_counts, out=out_indptr[1:])
    cursor = out_indptr[:-1].copy()
    out_indices = np.empty(nnz, dtype=idx_dt)
    out_values = None if vals is None else np.empty(nnz, dtype=vals.dtype)
    arena = ChunkArena()
    for s in range(0, nnz, DEFAULT_CHUNK):
        e = min(s + DEFAULT_CHUNK, nnz)
        rowof = arena.get("rowof", e - s, idx_dt)
        rowof[:] = np.searchsorted(
            indptr, np.arange(s, e), side="right"
        ) - 1
        payloads = [(rowof, out_indices)]
        if vals is not None:
            payloads.append((vals[s:e], out_values))
        _stable_scatter_chunk(
            np.asarray(indices[s:e], dtype=np.int64), cursor, payloads, arena
        )
    return (
        out_indptr.astype(policy.indptr_dtype(nnz), copy=False),
        out_indices,
        out_values,
    )


def csr_transpose(csr: CSR, policy: DtypePolicy | None = None) -> CSR:
    """Transpose (inbound edges / dual index), built on the host."""
    indptr, indices, values = host_csr_transpose(
        csr.indptr_host,
        to_numpy(csr.indices),
        None if csr.values is None else to_numpy(csr.values),
        csr.n_rows, csr.n_cols, policy,
    )
    return csr_from_arrays(
        indptr, indices, values, csr.n_cols, csr.n_rows, csr.device
    )


def csr_row_ids(csr: CSR) -> torch.Tensor:
    """Expanded per-edge source row ids, int32[nnz], on the CSR's device."""
    rows = torch.arange(csr.n_rows, dtype=torch.int32, device=csr.device)
    return torch.repeat_interleave(
        rows, csr.degrees().long(), output_size=csr.nnz
    )


# ---------------------------------------------------------------------------
# Batched device-side queries
# ---------------------------------------------------------------------------


def bsearch_range(
    indices: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    target: torch.Tensor,
    n_steps: int = 32,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless binary search of ``target`` in ``indices[lo:hi)`` (sorted).

    lo/hi/target broadcast together. Returns (position_of_first_geq,
    found_mask) with int32 positions; ``n_steps=32`` covers any int32
    range. Positions are held in int64 while searching, so ``lo + hi``
    cannot wrap.
    """
    lo = lo.to(torch.int64)
    hi0 = hi.to(torch.int64)
    if indices.shape[0] == 0:
        shape = torch.broadcast_shapes(lo.shape, target.shape)
        return lo.to(torch.int32), torch.zeros(shape, dtype=torch.bool,
                                               device=lo.device)
    target = target.to(torch.int32)
    last = indices.shape[0] - 1
    l, h = lo, hi0
    for _ in range(n_steps):
        active = l < h
        mid = torch.div(l + h, 2, rounding_mode="floor")
        v = take_ids(indices, mid.clamp(0, last))
        go_right = v < target
        l = torch.where(active & go_right, mid + 1, l)
        h = torch.where(active & ~go_right, mid, h)
    pos = l
    found = (pos < hi0) & (take_ids(indices, pos.clamp(0, last)) == target)
    return pos.to(torch.int32), found


def _row_bounds(csr: CSR, rows: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    r = rows.long()
    return take_clip(csr.indptr, r), take_clip(csr.indptr, r + 1)


def csr_contains(csr: CSR, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Batched membership test: is (rows[i], cols[i]) an edge? -> bool[B]."""
    lo, hi = _row_bounds(csr, rows)
    _, found = bsearch_range(csr.indices, lo, hi, cols)
    return found


def csr_value_at(csr: CSR, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Batched edge value lookup; 0.0 when absent / layer unvalued -> f32[B]."""
    lo, hi = _row_bounds(csr, rows)
    pos, found = bsearch_range(csr.indices, lo, hi, cols)
    if csr.values is None:
        return found.to(torch.float32)
    if csr.values.shape[0] == 0:
        return torch.zeros(found.shape, dtype=torch.float32, device=found.device)
    vals = take_clip(csr.values, pos).to(torch.float32)
    return torch.where(found, vals, torch.zeros_like(vals))


def csr_row_gather(
    csr: CSR, rows: torch.Tensor, max_len: int, fill: int = int(SENTINEL)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather up to ``max_len`` column ids per queried row.

    Returns (cols int32[..., max_len] padded with ``fill``, valid mask).
    Rows longer than max_len are truncated.
    """
    start, end = _row_bounds(csr, rows)
    start = start.long()
    length = end.long() - start
    offs = torch.arange(max_len, dtype=torch.int64, device=start.device)
    valid = offs < length[..., None]
    if csr.nnz == 0:
        return (
            torch.full(valid.shape, fill, dtype=torch.int32, device=valid.device),
            torch.zeros_like(valid),
        )
    idx = torch.where(valid, start[..., None] + offs, 0).clamp(0, csr.nnz - 1)
    vals = take_ids(csr.indices, idx)
    return torch.where(valid, vals, fill), valid


def csr_row_sample(
    csr: CSR, rows: torch.Tensor, key
) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniformly sample one column from each queried row (``key``: a
    ``core/prng.py`` key).

    Returns (samples int32, valid bool) shaped like ``rows``; an empty row
    returns the queried row's own id, invalid, so callers can 'stay in
    place'. The draw is ``randint(key, rows.shape, 0, max(length, 1))``,
    bit for bit the JAX package's; on the card one launch of the threefry
    row-sample kernel (``overlay.eff_row_sample`` without an overlay).
    """
    from repro_torch.core.overlay import eff_row_sample

    return eff_row_sample(csr, None, rows, key)


def sorted_isin(
    a: torch.Tensor, a_valid: torch.Tensor, b: torch.Tensor, b_valid: torch.Tensor
) -> torch.Tensor:
    """For sorted padded rows a[B,Ka], b[B,Kb]: mask of a's entries in b.

    Pad slots (a_valid False) never match. Per-element binary search in b
    (pad SENTINEL keeps b sorted), O(Ka log Kb).
    """
    kb = b.shape[-1]
    a2 = a.reshape(-1, a.shape[-1]).contiguous()
    b2 = b.reshape(-1, kb).contiguous()
    pos = torch.searchsorted(b2, a2)
    hit = torch.gather(b2, 1, pos.clamp(0, kb - 1)) == a2
    hits = (hit & (pos < kb)).reshape(a.shape)
    return hits & a_valid & (a != int(SENTINEL))


def padded_unique(
    vals: torch.Tensor, valid: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort + dedup padded rows. vals[B,K] with pad SENTINEL.

    Returns (sorted vals with duplicates/pads replaced by SENTINEL and
    pushed to the end, uniq mask). Sorts twice, like the JAX package.
    """
    sent = int(SENTINEL)
    v = torch.where(valid, vals, sent)
    v = torch.sort(v, dim=-1).values
    first = torch.ones(v.shape[:-1] + (1,), dtype=torch.bool, device=v.device)
    uniq = torch.cat([first, v[..., 1:] != v[..., :-1]], dim=-1)
    uniq = uniq & (v != sent)
    v = torch.where(uniq, v, sent)
    v = torch.sort(v, dim=-1).values
    return v, v != sent
