"""Network snapshots + the DurableStore crash-recovery manager.

A *store directory* holds everything needed to reconstruct a network
after a crash:

    store/
      wal.log                      append-only mutation log (core/wal.py)
      snap-<lsn20>.npz             full network image (io.save_network)
      snap-<lsn20>.json            manifest: {"lsn", "sha256", "npz", ...}

A snapshot at lsn L covers every WAL record with lsn <= L; recovery
loads the newest snapshot whose npz bytes match the manifest's sha256
(corrupt/partial snapshots are skipped, older ones tried) and replays
the WAL records after it. Snapshot writes are atomic: the npz is
written to a dotted temp name, fsync'd, renamed into place, and only
then is the manifest written (same dance) — a manifest's existence
implies a complete npz, and the sha256 catches bit rot anyway.

``DurableStore`` is the fail-closed mutation manager:

    1. the op is applied to the in-memory network first (validation —
       a bad op never reaches the log),
    2. the op is appended to the WAL and fsync'd — on failure the
       mutation is REJECTED (``WALWriteError``) and the store's network
       is unchanged,
    3. only then is the new network committed in memory.

A crash between (2) and (3) replays to the post-mutation state, a crash
before (2) recovers the pre-mutation state; no intermediate state is
ever observable. Full-network replacement (``update_network`` in the
serve engine) cannot be usefully logged as a delta, so ``replace``
checkpoints it as a fresh snapshot at the current WAL position.

The layout, manifests and fail-closed ordering are the JAX package's: a
store written by either package recovers in the other. Snapshot images
use ``save_network``'s default ``compress=True`` (zlib on the host), so
their bytes differ from run to run (zip timestamps) while the loaded
buffers do not. Recovery loads onto a device (``None``: the CUDA card).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass
from pathlib import Path

from . import wal as _wal
from .io import load_network, save_network

__all__ = [
    "DurableStore",
    "RecoveryInfo",
    "SnapshotMissingError",
    "latest_snapshot",
    "list_snapshots",
    "recover",
    "write_snapshot",
]

WAL_NAME = "wal.log"
_SNAP_RE = re.compile(r"^snap-(\d{20})\.json$")
_SNAP_FMT = "threadle-snap/1"


class SnapshotMissingError(FileNotFoundError):
    """No loadable snapshot exists in the store directory."""


@dataclass(frozen=True)
class RecoveryInfo:
    """What ``recover`` did, for logging/CLI display."""

    snapshot_lsn: int        # lsn covered by the snapshot that loaded
    replayed: int            # WAL records re-applied after the snapshot
    last_lsn: int            # lsn of the recovered state
    snapshots_skipped: int   # corrupt/unreadable snapshots passed over
    torn_bytes: int          # trailing WAL bytes dropped as torn


def _lsn_tag(lsn: int) -> str:
    # lsn -1 (initial snapshot, covers nothing) sorts before lsn 0
    return f"{lsn + 1:020d}"


def _fsync_dir(dirpath: Path) -> None:
    try:
        fd = os.open(dirpath, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _atomic_write(path: Path, data: bytes, *, fsync: bool = True) -> None:
    tmp = path.parent / f".tmp-{path.name}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        _fsync_dir(path.parent)


def write_snapshot(net, store_dir: str | Path, *, lsn: int,
                   fsync: bool = True) -> Path:
    """Atomically snapshot ``net`` as covering WAL records up to ``lsn``."""
    store_dir = Path(store_dir)
    store_dir.mkdir(parents=True, exist_ok=True)
    tag = _lsn_tag(lsn)
    npz_path = store_dir / f"snap-{tag}.npz"
    tmp_npz = store_dir / f".tmp-snap-{tag}.npz"
    save_network(net, tmp_npz)
    data = tmp_npz.read_bytes()
    if fsync:
        with open(tmp_npz, "rb") as f:
            os.fsync(f.fileno())
    os.replace(tmp_npz, npz_path)
    manifest = {
        "format": _SNAP_FMT,
        "lsn": int(lsn),
        "npz": npz_path.name,
        "sha256": hashlib.sha256(data).hexdigest(),
        "bytes": len(data),
    }
    _atomic_write(store_dir / f"snap-{tag}.json",
                  json.dumps(manifest, indent=1).encode(), fsync=fsync)
    return npz_path


def list_snapshots(store_dir: str | Path) -> list[tuple[int, Path, dict]]:
    """All snapshots with a readable manifest, newest first."""
    store_dir = Path(store_dir)
    out: list[tuple[int, Path, dict]] = []
    if not store_dir.is_dir():
        return out
    for p in store_dir.iterdir():
        m = _SNAP_RE.match(p.name)
        if not m:
            continue
        try:
            manifest = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
        if manifest.get("format") != _SNAP_FMT:
            continue
        out.append((int(manifest["lsn"]), p.parent / manifest["npz"],
                    manifest))
    out.sort(key=lambda t: t[0], reverse=True)
    return out


def latest_snapshot(store_dir: str | Path, device=None):
    """-> (lsn, net, skipped): newest snapshot that verifies and loads."""
    skipped = 0
    for lsn, npz_path, manifest in list_snapshots(store_dir):
        try:
            data = npz_path.read_bytes()
            if hashlib.sha256(data).hexdigest() != manifest["sha256"]:
                skipped += 1
                continue
            net = load_network(npz_path, device=device)
        except (OSError, ValueError, KeyError):
            skipped += 1
            continue
        return lsn, net, skipped
    raise SnapshotMissingError(
        f"no loadable snapshot in {store_dir} ({skipped} corrupt)"
    )


def recover(store_dir: str | Path, device=None):
    """Rebuild the network from disk -> (net, RecoveryInfo).

    Loads the newest intact snapshot and replays the WAL tail beyond it.
    Torn WAL tails are measured but NOT truncated here — recovery is
    read-only; opening a ``DurableStore`` performs the truncation.
    """
    store_dir = Path(store_dir)
    snap_lsn, net, skipped = latest_snapshot(store_dir, device=device)
    wal_path = store_dir / WAL_NAME
    replayed = 0
    torn_bytes = 0
    last_lsn = snap_lsn
    if wal_path.exists():
        records, valid_end, torn = _wal.scan(wal_path)
        if torn:
            torn_bytes = wal_path.stat().st_size - max(
                valid_end, len(_wal.WAL_MAGIC))
        tail = [r for r in records if r.lsn > snap_lsn]
        net, replayed = _wal.replay(net, tail)
        if tail:
            last_lsn = tail[-1].lsn
        elif records:
            last_lsn = max(snap_lsn, records[-1].lsn)
    return net, RecoveryInfo(
        snapshot_lsn=snap_lsn, replayed=replayed, last_lsn=last_lsn,
        snapshots_skipped=skipped, torn_bytes=max(torn_bytes, 0),
    )


class DurableStore:
    """Crash-safe network owner: WAL-ahead mutations + snapshot cadence.

    ``create`` seeds a directory with an initial snapshot (lsn -1,
    covering an empty log); ``open`` recovers snapshot + WAL tail and
    truncates any torn bytes so the log is append-clean. ``apply`` is
    the single mutation gate — see the module docstring for the
    fail-closed ordering contract.
    """

    def __init__(self, store_dir: Path, net, wal: _wal.WriteAheadLog, *,
                 snapshot_every: int | None = None, fsync: bool = True,
                 recovery: RecoveryInfo | None = None):
        self.dir = Path(store_dir)
        self._net = net
        self._wal = wal
        self.snapshot_every = snapshot_every
        self.fsync = fsync
        self.recovery = recovery
        self._ops_since_snapshot = 0

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, store_dir: str | Path, net, *,
               snapshot_every: int | None = None,
               fsync: bool = True) -> "DurableStore":
        store_dir = Path(store_dir)
        store_dir.mkdir(parents=True, exist_ok=True)
        write_snapshot(net, store_dir, lsn=-1, fsync=fsync)
        wal = _wal.WriteAheadLog.create(store_dir / WAL_NAME, fsync=fsync)
        return cls(store_dir, net, wal,
                   snapshot_every=snapshot_every, fsync=fsync)

    @classmethod
    def open(cls, store_dir: str | Path, *,
             snapshot_every: int | None = None,
             fsync: bool = True, device=None) -> "DurableStore":
        store_dir = Path(store_dir)
        net, info = recover(store_dir, device=device)
        wal = _wal.WriteAheadLog.open(store_dir / WAL_NAME, fsync=fsync)
        if wal.last_lsn < info.last_lsn:
            # the WAL was compacted up to a snapshot; keep lsns monotonic
            wal.last_lsn = info.last_lsn
        return cls(store_dir, net, wal,
                   snapshot_every=snapshot_every, fsync=fsync,
                   recovery=info)

    def close(self) -> None:
        self._wal.close()

    def __enter__(self) -> "DurableStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- state ---------------------------------------------------------------

    @property
    def net(self):
        return self._net

    @property
    def last_lsn(self) -> int:
        return self._wal.last_lsn

    # -- mutation gate -------------------------------------------------------

    def apply(self, op: dict):
        """Validate, durably log, then commit one mutation op -> new net.

        Raises ``WALWriteError`` (mutation rejected, state unchanged) if
        the record cannot be made durable; raises whatever ``apply_op``
        raises if the op itself is invalid (nothing logged).
        """
        new_net = _wal.apply_op(self._net, op)   # (1) validate by applying
        self._wal.append(op)                     # (2) durable or rejected
        self._net = new_net                      # (3) commit
        self._ops_since_snapshot += 1
        if (self.snapshot_every is not None
                and self._ops_since_snapshot >= self.snapshot_every):
            self.snapshot()
        # snapshot() may have folded delta overlays into the base; hand
        # callers the committed (possibly compacted) network, not the
        # pre-compaction object
        return self._net

    def replace(self, net) -> None:
        """Swap in a whole new network (update_network) via checkpoint.

        Logged as a snapshot, not a WAL delta: the new image covers the
        current WAL position, so recovery after the rename sees the new
        network and replays nothing. A crash mid-write recovers the old
        network — full replacement is atomic at the snapshot rename.
        """
        write_snapshot(net, self.dir, lsn=self._wal.last_lsn,
                       fsync=self.fsync)
        self._net = net
        self._ops_since_snapshot = 0

    # -- maintenance ---------------------------------------------------------

    def snapshot(self) -> Path:
        """Checkpoint the current network at the current WAL position.

        Snapshots double as overlay compaction points: any delta
        overlays accumulated by incremental ``add_edges``/
        ``delete_edges`` fold into rebuilt base CSRs, the image on disk
        stores the plain CSRs, and the in-memory network rebinds to the
        compacted form (queries are bit-identical by the overlay
        contract).
        """
        self._net = self._net.compacted()
        path = write_snapshot(self._net, self.dir, lsn=self._wal.last_lsn,
                              fsync=self.fsync)
        self._ops_since_snapshot = 0
        return path

    def compact(self, keep_snapshots: int = 2) -> int:
        """Snapshot, reset the WAL, and prune old snapshots -> bytes freed.

        Safe ordering: the snapshot at lsn L lands (atomic rename)
        *before* the WAL is reset, so every record dropped from the log
        is already covered by an intact snapshot.
        """
        self.snapshot()
        last_lsn = self._wal.last_lsn
        freed = (self.dir / WAL_NAME).stat().st_size - len(_wal.WAL_MAGIC)
        self._wal.close()
        tmp = self.dir / f".tmp-{WAL_NAME}"
        with open(tmp, "wb") as f:
            f.write(_wal.WAL_MAGIC)
            f.flush()
            if self.fsync:
                os.fsync(f.fileno())
        os.replace(tmp, self.dir / WAL_NAME)
        if self.fsync:
            _fsync_dir(self.dir)
        self._wal = _wal.WriteAheadLog(self.dir / WAL_NAME, fsync=self.fsync)
        self._wal.last_lsn = last_lsn
        self._wal._open_append()
        snaps = list_snapshots(self.dir)
        for lsn, npz_path, manifest in snaps[max(keep_snapshots, 1):]:
            for p in (npz_path,
                      self.dir / f"snap-{_lsn_tag(lsn)}.json"):
                try:
                    freed += p.stat().st_size
                    p.unlink()
                except OSError:
                    pass
        return max(freed, 0)
