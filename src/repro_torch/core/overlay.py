"""Delta overlays, read side: the query-time merge of a base CSR and a delta.

A ``DeltaOverlay`` pairs a base CSR with a resolved-row delta CSR (each
dirty row's exact post-mutation content) and a per-row dirty mask. Every
``eff_*`` accessor runs the matching ``csr_*`` query against base AND
delta and picks the delta answer for dirty rows, so results equal those
of the rebuilt layer bit for bit.

Overlays reach the port ready-made (``core/convert.py``); building and
updating them (``overlay_update``) is mutation, which this slice does not
port. The overlay keeps a host mirror of ``dirty`` beside the device mask
for bucket planning, like ``CSR.indptr_host``. ``eff_coo`` and
``eff_edge_stream`` read the effective entries (clean base rows + dirty
delta rows) for the min-label component sweeps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .csr import (
    CSR,
    csr_contains,
    csr_row_gather,
    csr_row_ids,
    csr_value_at,
    take_clip,
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
