"""Delta overlays, read side: the query-time merge of a base CSR and a delta.

A ``DeltaOverlay`` pairs a base CSR with a resolved-row delta CSR (each
dirty row's exact post-mutation content) and a per-row dirty mask. Every
``eff_*`` accessor runs the matching ``csr_*`` query against base AND
delta and picks the delta answer for dirty rows, so results equal those
of the rebuilt layer bit for bit.

The overlay keeps a host mirror of ``dirty`` beside the device mask for
bucket planning, like ``CSR.indptr_host``. ``eff_coo`` and
``eff_edge_stream`` read the effective entries (clean base rows + dirty
delta rows) for the min-label component sweeps.

Mutation (``overlay_update``) re-resolves only the touched rows into a
fresh delta, on the host in numpy as in the JAX package. The touched
rows' current entries are gathered on the device and only they cross the
bus: row bounds come from the ``indptr_host`` mirrors, never from a copy
of ``indices``. The new delta CSR keeps the reference's layout (its
indptr spans the whole effective row space) and is uploaded whole, with
``dirty`` and its host mirror built together.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .csr import (
    CSR,
    DEFAULT_POLICY,
    SENTINEL,
    DtypePolicy,
    csr_contains,
    csr_from_coo_chunks,
    csr_row_gather,
    csr_row_ids,
    csr_value_at,
    take_clip,
    take_ids,
    to_numpy,
    to_tensor,
    widen_ids,
)

__all__ = [
    "DeltaOverlay",
    "eff_nnz",
    "eff_n_rows",
    "eff_n_cols",
    "eff_contains",
    "eff_value_at",
    "eff_row_gather",
    "eff_row_sample",
    "eff_row_lengths",
    "eff_degrees",
    "eff_max_degree",
    "eff_host_degrees",
    "eff_host_degree_table",
    "eff_coo",
    "eff_edge_stream",
    "overlay_update",
    "overlay_ratio",
    "fold_overlay",
]


@dataclass(frozen=True)
class DeltaOverlay:
    """Resolved-row delta over a base CSR.

    ``delta`` spans the effective row/col space but holds content only
    for dirty rows. ``dirty`` is a device bool[delta.n_rows] with its host
    mirror ``dirty_host``; ``base_shadowed`` counts the base entries
    hidden behind dirty rows.
    """

    delta: CSR
    dirty: torch.Tensor
    base_shadowed: int
    dirty_host: np.ndarray

    @property
    def nbytes(self) -> int:
        return self.delta.nbytes + int(self.dirty.nbytes)


# ---------------------------------------------------------------------------
# Effective-shape accessors
# ---------------------------------------------------------------------------


def eff_nnz(base: CSR, ov: DeltaOverlay | None) -> int:
    if ov is None:
        return base.nnz
    return base.nnz - ov.base_shadowed + ov.delta.nnz


def eff_n_rows(base: CSR, ov: DeltaOverlay | None) -> int:
    return base.n_rows if ov is None else ov.delta.n_rows


def eff_n_cols(base: CSR, ov: DeltaOverlay | None) -> int:
    return base.n_cols if ov is None else ov.delta.n_cols


# ---------------------------------------------------------------------------
# Query-time merge (device)
# ---------------------------------------------------------------------------


def eff_contains(
    base: CSR, ov: DeltaOverlay | None, rows: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    if ov is None:
        return csr_contains(base, rows, cols)
    hb = csr_contains(base, rows, cols)
    hd = csr_contains(ov.delta, rows, cols)
    return torch.where(take_clip(ov.dirty, rows), hd, hb)


def eff_value_at(
    base: CSR, ov: DeltaOverlay | None, rows: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    if ov is None:
        return csr_value_at(base, rows, cols)
    vb = csr_value_at(base, rows, cols)
    vd = csr_value_at(ov.delta, rows, cols)
    return torch.where(take_clip(ov.dirty, rows), vd, vb)


def eff_row_gather(
    base: CSR,
    ov: DeltaOverlay | None,
    rows: torch.Tensor,
    max_len: int,
    fill: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    kw = {} if fill is None else {"fill": fill}
    if ov is None:
        return csr_row_gather(base, rows, max_len, **kw)
    vb, mb = csr_row_gather(base, rows, max_len, **kw)
    vd, md = csr_row_gather(ov.delta, rows, max_len, **kw)
    d = take_clip(ov.dirty, rows)[..., None]
    return torch.where(d, vd, vb), torch.where(d, md, mb)


def eff_row_sample(
    base: CSR, ov: DeltaOverlay | None, rows: torch.Tensor, key
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row uniform sample with the overlay merged, bit-identical to
    sampling the rebuilt CSR: the draw has per-element bounds, so a dirty
    row's delta branch sees exactly the rebuilt row's length, and both
    branches consume the same key. One launch on the card."""
    from repro_torch.core import prng
    from repro_torch.kernels import ops as kops

    k1, k2 = prng.split(key)
    return kops.csr_row_sample(base, ov, rows, k1, k2)


def eff_row_lengths(
    base: CSR, ov: DeltaOverlay | None, rows: torch.Tensor
) -> torch.Tensor:
    """int64 length of each queried row, with ``eff_row_gather``'s clip."""

    def length(csr: CSR) -> torch.Tensor:
        r = rows.long()
        return take_clip(csr.indptr, r + 1).long() - take_clip(csr.indptr, r).long()

    if ov is None:
        return length(base)
    return torch.where(take_clip(ov.dirty, rows), length(ov.delta), length(base))


def eff_degrees(base: CSR, ov: DeltaOverlay | None) -> torch.Tensor:
    if ov is None:
        return base.degrees()
    db = base.degrees().to(torch.int32)
    n = ov.delta.n_rows
    if n > base.n_rows:
        db = torch.nn.functional.pad(db, (0, n - base.n_rows))
    dd = ov.delta.degrees().to(torch.int32)
    return torch.where(ov.dirty, dd, db)


# ---------------------------------------------------------------------------
# Host-side planning (reads the host mirrors only)
# ---------------------------------------------------------------------------


def eff_host_degrees(
    base: CSR, ov: DeltaOverlay | None, rows: np.ndarray
) -> np.ndarray:
    """Row lengths for host-side bucket planning (mirrors the device clip)."""
    rows = np.asarray(rows, dtype=np.int64)
    bind = base.indptr_host
    rb = np.clip(rows, 0, max(base.n_rows - 1, 0))
    db = (bind[rb + 1] - bind[rb]).astype(np.int64)
    if ov is None:
        return db
    dind = ov.delta.indptr_host
    rd = np.clip(rows, 0, max(ov.delta.n_rows - 1, 0))
    dd = (dind[rd + 1] - dind[rd]).astype(np.int64)
    return np.where(ov.dirty_host[rd], dd, db)


def eff_host_degree_table(base: CSR, ov: DeltaOverlay | None) -> np.ndarray:
    """int64[eff_n_rows] of effective row lengths."""
    db = np.diff(base.indptr_host).astype(np.int64)
    if ov is None:
        return db
    n = ov.delta.n_rows
    if n > base.n_rows:
        db = np.concatenate([db, np.zeros(n - base.n_rows, np.int64)])
    dd = np.diff(ov.delta.indptr_host).astype(np.int64)
    return np.where(ov.dirty_host, dd, db)


def eff_max_degree(base: CSR, ov: DeltaOverlay | None) -> int:
    if ov is None:
        return base.max_degree()
    tab = eff_host_degree_table(base, ov)
    return int(tab.max()) if tab.size else 0


def _csr_coo_np(csr: CSR) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    rows = np.repeat(
        np.arange(csr.n_rows, dtype=np.int64), np.diff(csr.indptr_host)
    )
    cols = to_numpy(csr.indices).astype(np.int64)
    vals = None if csr.values is None else to_numpy(csr.values)
    return rows, cols, vals


def eff_coo(
    base: CSR, ov: DeltaOverlay | None
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Effective host COO: clean base rows + dirty delta rows.

    Each row's entries stay contiguous and column-sorted. O(nnz) host
    copy: compaction/export cost, never on a query path.
    """
    if ov is None:
        return _csr_coo_np(base)
    br, bc, bv = _csr_coo_np(base)
    keep = ~ov.dirty_host[: base.n_rows][br]
    dr, dc, dv = _csr_coo_np(ov.delta)
    rows = np.concatenate([br[keep], dr])
    cols = np.concatenate([bc[keep], dc])
    if bv is None and dv is None:
        vals = None
    else:
        vals = np.concatenate([
            bv[keep] if bv is not None else np.ones(int(keep.sum()), np.float32),
            dv if dv is not None else np.ones(dr.size, np.float32),
        ])
    return rows, cols, vals


def eff_edge_stream(
    base: CSR, ov: DeltaOverlay | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (row, col) int32 device streams (min-label sweeps).

    Overlay-free CSRs expand on the device; a live overlay goes through
    the host ``eff_coo`` read.
    """
    if ov is None:
        return csr_row_ids(base), widen_ids(base.indices)
    rows, cols, _ = eff_coo(base, ov)
    return (
        to_tensor(rows.astype(np.int32), base.device),
        to_tensor(cols.astype(np.int32), base.device),
    )


# ---------------------------------------------------------------------------
# Mutation: re-resolve touched rows into a fresh delta
# ---------------------------------------------------------------------------


def _take_rows(
    csr: CSR, rows: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Host COO of the given (sorted unique) rows; rows past n_rows are empty.

    Row bounds come from the host ``indptr`` mirror; the entries are
    gathered on the CSR's device and only they are copied back.
    """
    rows = rows[rows < csr.n_rows]
    if rows.size == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty.copy(), (
            None if csr.values is None else np.zeros(0, np.float32)
        )
    indptr = csr.indptr_host
    starts = indptr[rows].astype(np.int64)
    lens = (indptr[rows + 1] - indptr[rows]).astype(np.int64)
    total = int(lens.sum())
    r_out = np.repeat(rows, lens)
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    dev = csr.device
    shift = torch.repeat_interleave(
        to_tensor(starts - first, dev), to_tensor(lens, dev), output_size=total
    )
    pos = shift + torch.arange(total, dtype=torch.int64, device=dev)
    c_out = to_numpy(take_ids(csr.indices, pos)).astype(np.int64)
    v_out = None if csr.values is None else to_numpy(csr.values[pos])
    return r_out, c_out, v_out


def _rows_content(
    base: CSR, ov: DeltaOverlay | None, rows: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Current *effective* content of the given rows (sorted unique)."""
    if ov is None:
        return _take_rows(base, rows)
    dirty = ov.dirty_host
    in_mask = rows < dirty.size
    was_dirty = np.zeros(rows.shape, bool)
    was_dirty[in_mask] = dirty[rows[in_mask]]
    dr, dc, dv = _take_rows(ov.delta, rows[was_dirty])
    br, bc, bv = _take_rows(base, rows[~was_dirty])
    rows_out = np.concatenate([dr, br])
    cols_out = np.concatenate([dc, bc])
    if dv is None and bv is None:
        vals_out = None
    else:
        vals_out = np.concatenate([
            dv if dv is not None else np.ones(dr.size, np.float32),
            bv if bv is not None else np.ones(br.size, np.float32),
        ])
    return rows_out, cols_out, vals_out


def overlay_update(
    base: CSR,
    ov: DeltaOverlay | None,
    rows: np.ndarray,
    cols: np.ndarray,
    values: np.ndarray | None,
    *,
    delete: bool = False,
    valued: bool = False,
    new_first: bool = True,
    n_rows: int | None = None,
    n_cols: int | None = None,
    policy: DtypePolicy | None = None,
) -> DeltaOverlay:
    """Apply an insert/tombstone batch, returning a fresh overlay.

    Inserts: ``new_first=True`` places the batch before each touched
    row's current content, so the first-occurrence dedup upserts the NEW
    value; ``new_first=False`` preserves an existing pair's value (the
    ``values=None``-on-a-valued-layer default). Deletes drop the named
    (row, col) pairs (missing pairs are ignored).

    ``n_rows``/``n_cols`` grow the effective space (two-mode hyperedge
    growth); untouched dirty rows carry over from the previous delta.
    Cost: O(batch + touched-row content + previous delta + n_rows) on the
    host, plus the touched entries' copy from the device and the new
    delta's upload.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    eff_rows_old = eff_n_rows(base, ov)
    eff_cols_old = eff_n_cols(base, ov)
    n_rows = max(eff_rows_old, n_rows or 0)
    n_cols = max(eff_cols_old, n_cols or 0)

    dirty_old = ov.dirty_host if ov is not None else np.zeros(base.n_rows, bool)
    if dirty_old.size < n_rows:
        dirty_old = np.concatenate(
            [dirty_old, np.zeros(n_rows - dirty_old.size, bool)]
        )
    touched = np.unique(rows)
    if touched.size and (int(touched[0]) < 0 or int(touched[-1]) >= n_rows):
        raise ValueError("row id out of range")
    dirty_new = dirty_old.copy()
    dirty_new[touched] = True

    cur_r, cur_c, cur_v = _rows_content(base, ov, touched)
    chunks: list[tuple] = []
    if ov is not None:
        # untouched dirty rows carry over verbatim from the old delta
        dr, dc, dv = _csr_coo_np(ov.delta)
        touched_mask = np.zeros(n_rows, bool)
        touched_mask[touched] = True
        keep = ~touched_mask[dr]
        chunks.append((
            dr[keep], dc[keep], None if dv is None else dv[keep]
        ))
    if delete:
        nc = np.int64(n_cols)
        gone = rows * nc + cols
        keep = ~np.isin(cur_r * nc + cur_c, gone)
        chunks.append((
            cur_r[keep], cur_c[keep],
            None if cur_v is None else cur_v[keep],
        ))
    elif new_first:
        chunks.append((rows, cols, values))
        chunks.append((cur_r, cur_c, cur_v))
    else:
        chunks.append((cur_r, cur_c, cur_v))
        chunks.append((rows, cols, values))

    delta = csr_from_coo_chunks(
        chunks, n_rows, n_cols, dedup=True, valued=valued, policy=policy,
        device=base.device,
    )
    bdeg = np.diff(base.indptr_host).astype(np.int64)
    shadowed = int(bdeg[dirty_new[: base.n_rows]].sum())
    return DeltaOverlay(
        delta=delta,
        dirty=to_tensor(dirty_new, base.device),
        base_shadowed=shadowed,
        dirty_host=dirty_new,
    )


def overlay_ratio(base: CSR, ov: DeltaOverlay | None) -> float:
    """Compaction-policy signal: delta size relative to the base."""
    if ov is None:
        return 0.0
    return ov.delta.nnz / max(base.nnz, 1)


def fold_overlay(
    base: CSR, ov: DeltaOverlay | None, n_rows: int, n_cols: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Host (indptr, indices, values) of the effective CSR: clean base rows
    and dirty delta rows, in row order, at the default policy's widths
    (compaction's, as the builders it stands in for use).

    Every row of either CSR is column-sorted and free of duplicates, so
    these are the buffers the builders make from the same entries (their
    two counting-sort passes would only restore this order): compaction
    gathers each row once instead of sorting every entry.
    """
    policy = DEFAULT_POLICY
    deg = eff_host_degree_table(base, ov)
    if deg.size < n_rows:
        deg = np.concatenate([deg, np.zeros(n_rows - deg.size, np.int64)])
    indptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    nnz = int(indptr[-1])
    if nnz >= int(SENTINEL):
        raise ValueError("nnz exceeds the int32 device range; shard the layer")
    starts = np.zeros(n_rows, np.int64)
    starts[: base.n_rows] = base.indptr_host[:-1][: n_rows]
    srcs = [base]
    if ov is not None:
        dirty = np.zeros(n_rows, bool)
        dirty[: ov.dirty_host.size] = ov.dirty_host[:n_rows]
        starts[dirty] = base.nnz + ov.delta.indptr_host[:-1][dirty]
        srcs.append(ov.delta)
    pos = np.repeat(starts - indptr[:-1], deg) + np.arange(nnz, dtype=np.int64)
    ids = np.concatenate([to_numpy(c.indices).astype(np.int64) for c in srcs])
    indices = ids[pos].astype(policy.index_dtype(n_cols))
    values = None
    if any(c.values is not None for c in srcs):
        values = np.concatenate([
            to_numpy(c.values) if c.values is not None
            else np.ones(c.nnz, np.float32) for c in srcs
        ])[pos].astype(policy.values_dtype())
    return indptr.astype(policy.indptr_dtype(nnz)), indices, values
