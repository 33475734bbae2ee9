"""Write-ahead log for network mutations (durable-execution style).

Threadle serves long-lived register-data networks that receive
incremental updates; a process crash must not lose them. Every mutating
op is recorded here *before* it is acknowledged, Temporal-style: crash →
reload the latest snapshot (core/snapshot.py) → replay the WAL tail.

File format (``THDLWAL1``):

    header   : 8-byte magic ``b"THDLWAL1"``
    record   : ``<II`` little-endian (payload_len, crc32(payload))
               followed by ``payload_len`` bytes of compact JSON

Each payload is one mutation op dict carrying a monotonically increasing
``lsn`` (log sequence number). ``append`` flushes and ``os.fsync``s
before returning, so an acknowledged record survives power loss.

Torn writes are expected, not fatal: a crash mid-append leaves a short
or checksum-failing tail record. ``scan`` stops at the last valid record
boundary and reports the torn tail; ``WriteAheadLog.open`` truncates it
so the log is append-clean again. Anything *after* a bad record is
unreachable by construction (no resynchronization — a WAL tail is only
ever torn, never hole-punched).

Op schema (JSON-safe; edge/attr payloads are inlined so recovery never
depends on external files still existing):

    {"op": "set_attr",     "lsn": n, "name": a, "kind": k,
                           "nodes": [...], "values": [...]}
    {"op": "delete_layer", "lsn": n, "name": L}
    {"op": "import_layer", "lsn": n, "name": L, "mode": 1|2,
                           "directed": b, "valued": b, "n_hyperedges": h,
                           "src": [...], "dst": [...], "values": [...]|null}
    {"op": "add_edges",    "lsn": n, "layer": L, "src": [...],
                           "dst": [...], "values": [...]|null}
    {"op": "delete_edges", "lsn": n, "layer": L, "src": [...], "dst": [...]}

``apply_op`` executes one op against a Network (functional: returns the
new network); ``replay`` folds a record stream. Both raise
``WALReplayError`` with the offending lsn on an inapplicable record —
records are validated at log time (see snapshot.DurableStore.apply), so
a replay failure means the store directory was tampered with.

This is the JAX package's log, format and op schema unchanged: the same
op sequence writes a byte-identical ``wal.log`` in either package, and a
log written by one replays in the other. The op constructors take host
copies of tensor arguments (a CUDA tensor has no numpy view); replay
applies each op on the network's own device.
"""

from __future__ import annotations

import io as _io
import json
import os
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator

import numpy as np
import torch

__all__ = [
    "WAL_MAGIC",
    "WALCorruptHeaderError",
    "WALReplayError",
    "WALWriteError",
    "WalRecord",
    "WriteAheadLog",
    "apply_op",
    "iter_ops",
    "make_set_attr_op",
    "make_delete_layer_op",
    "make_import_layer_op",
    "make_add_edges_op",
    "make_delete_edges_op",
    "replay",
    "scan",
]

WAL_MAGIC = b"THDLWAL1"
_REC_HEAD = struct.Struct("<II")  # (payload_len, crc32)
# Backstop against reading a corrupted length field as a multi-GB alloc:
# far above any real mutation record, far below address-space trouble.
_MAX_RECORD_BYTES = 1 << 30


class WALCorruptHeaderError(ValueError):
    """The file exists but does not start with the WAL magic."""


class WALWriteError(OSError):
    """An append could not be made durable; the mutation must be rejected."""


class WALReplayError(ValueError):
    """A logged record could not be re-applied during recovery."""

    def __init__(self, lsn: int, op: str, cause: Exception):
        super().__init__(
            f"WAL record lsn={lsn} op={op!r} failed to replay: "
            f"{type(cause).__name__}: {cause}"
        )
        self.lsn = lsn
        self.op = op


@dataclass(frozen=True)
class WalRecord:
    lsn: int
    op: dict
    offset: int      # file offset of this record's length prefix
    end_offset: int  # file offset one past this record's payload


def _encode(op: dict) -> bytes:
    payload = json.dumps(op, separators=(",", ":")).encode()
    return _REC_HEAD.pack(len(payload), zlib.crc32(payload)) + payload


def scan(path: str | Path) -> tuple[list[WalRecord], int, bool]:
    """Read every valid record -> (records, valid_end_offset, torn).

    Stops at the first short / checksum-failing / undecodable record;
    ``torn`` reports whether any bytes follow the valid prefix. Never
    raises on tail damage — only on a missing/garbled *header* (that is
    not a torn write, it is the wrong file).
    """
    path = Path(path)
    data = path.read_bytes()
    if len(data) < len(WAL_MAGIC) or data[: len(WAL_MAGIC)] != WAL_MAGIC:
        # an empty/short file can be a crash during creation: truncate-able
        if WAL_MAGIC.startswith(data):
            return [], 0, len(data) > 0
        raise WALCorruptHeaderError(
            f"{path} does not start with {WAL_MAGIC!r}"
        )
    records: list[WalRecord] = []
    pos = len(WAL_MAGIC)
    while True:
        head_end = pos + _REC_HEAD.size
        if head_end > len(data):
            break
        length, crc = _REC_HEAD.unpack_from(data, pos)
        end = head_end + length
        if length > _MAX_RECORD_BYTES or end > len(data):
            break
        payload = data[head_end:end]
        if zlib.crc32(payload) != crc:
            break
        try:
            op = json.loads(payload)
        except ValueError:
            break
        if not isinstance(op, dict) or "op" not in op:
            break
        records.append(
            WalRecord(lsn=int(op.get("lsn", -1)), op=op,
                      offset=pos, end_offset=end)
        )
        pos = end
    return records, pos, pos < len(data)


class WriteAheadLog:
    """Append-only mutation log with fsync'd, checksummed records.

    ``open`` scans the existing file, truncates any torn tail, and
    positions for appending; ``create`` starts a fresh log. ``append``
    is durable when it returns (write + flush + fsync) — on any OS
    error it raises ``WALWriteError`` and the caller must treat the
    mutation as rejected (fail closed), because the on-disk suffix is
    now unspecified (it will be re-truncated on next open).
    """

    def __init__(self, path: str | Path, *, fsync: bool = True):
        self.path = Path(path)
        self.fsync = fsync
        self._f: _io.BufferedWriter | None = None
        self.last_lsn = -1
        self.n_records = 0
        self.truncated_bytes = 0
        self._size = 0        # valid on-disk byte length (append offset)
        self._poisoned = False

    # -- lifecycle -----------------------------------------------------------

    @classmethod
    def create(cls, path: str | Path, *, fsync: bool = True) -> "WriteAheadLog":
        wal = cls(path, fsync=fsync)
        wal.path.parent.mkdir(parents=True, exist_ok=True)
        with open(wal.path, "wb") as f:
            f.write(WAL_MAGIC)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        wal._open_append()
        return wal

    @classmethod
    def open(cls, path: str | Path, *, fsync: bool = True) -> "WriteAheadLog":
        wal = cls(path, fsync=fsync)
        if not wal.path.exists():
            return cls.create(path, fsync=fsync)
        records, valid_end, torn = scan(wal.path)
        size = wal.path.stat().st_size
        if torn or size < len(WAL_MAGIC):
            # torn tail (crash mid-append) — cut back to the last valid
            # record boundary; a file shorter than the magic is a crash
            # mid-create and restarts empty
            valid_end = max(valid_end, 0)
            with open(wal.path, "r+b" if size else "wb") as f:
                if size < len(WAL_MAGIC):
                    f.seek(0)
                    f.write(WAL_MAGIC)
                    f.truncate(len(WAL_MAGIC))
                else:
                    f.truncate(max(valid_end, len(WAL_MAGIC)))
                f.flush()
                if fsync:
                    os.fsync(f.fileno())
            wal.truncated_bytes = size - max(valid_end, len(WAL_MAGIC))
        if records:
            wal.last_lsn = records[-1].lsn
            wal.n_records = len(records)
        wal._open_append()
        return wal

    def _open_append(self) -> None:
        self._f = open(self.path, "ab")
        self._size = self.path.stat().st_size

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self) -> "WriteAheadLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- appending -----------------------------------------------------------

    def append(self, op: dict) -> int:
        """Durably log one op; returns its lsn. Fail-closed on OS errors.

        A failure may leave a partially-written record on disk; the
        record is rolled back (truncate to the pre-append offset) so the
        rejected op can never resurface at recovery as if it had been
        acknowledged. If even the rollback fails, the log poisons
        itself: every later append is rejected (reopen the store to
        resume — ``open`` re-truncates the unspecified tail).
        """
        if self._f is None:
            raise WALWriteError("WAL is closed")
        if self._poisoned:
            raise WALWriteError(
                f"{self.path} is poisoned by an unrolled-back write "
                "failure; reopen the store to recover"
            )
        lsn = self.last_lsn + 1
        rec = dict(op)
        rec["lsn"] = lsn
        data = _encode(rec)
        try:
            self._f.write(data)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
        except OSError as e:
            self._rollback()
            raise WALWriteError(
                f"could not durably append lsn={lsn} to {self.path}: {e}"
            ) from e
        self._size += len(data)
        self.last_lsn = lsn
        self.n_records += 1
        return lsn

    def _rollback(self) -> None:
        """Cut the file back to the last acknowledged record boundary."""
        try:
            self._f.close()
            with open(self.path, "r+b") as f:
                f.truncate(self._size)
                f.flush()
                try:
                    if self.fsync:
                        os.fsync(f.fileno())
                except OSError:
                    # the logical repair (truncate) landed; losing its
                    # durability guarantee is no worse than the failed
                    # append we are rolling back
                    pass
            self._open_append()
        except OSError:
            self._poisoned = True

    # -- reading -------------------------------------------------------------

    def records(self, after_lsn: int = -1) -> list[WalRecord]:
        records, _, _ = scan(self.path)
        return [r for r in records if r.lsn > after_lsn]


# ---------------------------------------------------------------------------
# Op constructors (JSON-safe payloads, data inlined)
# ---------------------------------------------------------------------------


def _host(x):
    """A host copy of a tensor (a CUDA tensor has no numpy view); any
    other argument as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _id_list(x) -> list[int]:
    return [int(i) for i in np.atleast_1d(np.asarray(_host(x))).reshape(-1)]


def _value_list(values, kind: str | None = None) -> list:
    values = _host(values)
    vals = np.atleast_1d(np.asarray(values)).reshape(-1)
    if kind == "char":
        return [v if isinstance(v, str) else int(v)
                for v in np.atleast_1d(values)]
    if vals.dtype == np.bool_:
        return [bool(v) for v in vals]
    if np.issubdtype(vals.dtype, np.integer):
        return [int(v) for v in vals]
    return [float(v) for v in vals]


def make_set_attr_op(name: str, nodes, values, kind: str | None = None) -> dict:
    return {
        "op": "set_attr", "name": str(name), "kind": kind,
        "nodes": _id_list(nodes),
        "values": _value_list(values, kind),
    }


def make_delete_layer_op(name: str) -> dict:
    return {"op": "delete_layer", "name": str(name)}


def make_import_layer_op(
    name: str, src, dst, *, mode: int = 1, directed: bool = False,
    values=None, n_hyperedges: int | None = None,
) -> dict:
    return {
        "op": "import_layer", "name": str(name), "mode": int(mode),
        "directed": bool(directed),
        "n_hyperedges": None if n_hyperedges is None else int(n_hyperedges),
        "src": _id_list(src), "dst": _id_list(dst),
        "values": None if values is None else _value_list(values),
    }


def make_add_edges_op(layer: str, src, dst, values=None) -> dict:
    return {
        "op": "add_edges", "layer": str(layer),
        "src": _id_list(src), "dst": _id_list(dst),
        "values": None if values is None else _value_list(values),
    }


def make_delete_edges_op(layer: str, src, dst) -> dict:
    return {
        "op": "delete_edges", "layer": str(layer),
        "src": _id_list(src), "dst": _id_list(dst),
    }


# ---------------------------------------------------------------------------
# Applying ops (the replay executor)
# ---------------------------------------------------------------------------


def apply_op(net, op: dict):
    """Execute one op against ``net`` -> new Network (functional)."""
    from . import api
    from .layers import (
        add_edges, delete_edges, one_mode_from_edges,
        two_mode_from_memberships,
    )

    kind = op.get("op")
    if kind == "set_attr":
        values = op["values"]
        return api.setnodeattr(
            net, op["name"], op["nodes"], values, kind=op.get("kind")
        )
    if kind == "delete_layer":
        return net.without_layer(op["name"])
    if kind == "import_layer":
        src = np.asarray(op["src"], dtype=np.int64)
        dst = np.asarray(op["dst"], dtype=np.int64)
        if op["mode"] == 2:
            h = op.get("n_hyperedges")
            if h is None:
                h = int(dst.max()) + 1 if dst.size else 1
            layer = two_mode_from_memberships(
                net.n_nodes, h, src, dst, device=net.device
            )
        else:
            vals = op.get("values")
            layer = one_mode_from_edges(
                net.n_nodes, src, dst,
                values=None if vals is None
                else np.asarray(vals, dtype=np.float32),
                directed=bool(op.get("directed", False)),
                device=net.device,
            )
        return net.with_layer(op["name"], layer)
    if kind == "add_edges":
        layer = add_edges(
            net.layer(op["layer"]), op["src"], op["dst"],
            values=op.get("values"),
        )
        return net.with_layer(op["layer"], layer)
    if kind == "delete_edges":
        layer = delete_edges(net.layer(op["layer"]), op["src"], op["dst"])
        return net.with_layer(op["layer"], layer)
    raise ValueError(f"unknown WAL op {kind!r}")


def replay(net, records: Iterable[WalRecord | dict]):
    """Fold a record stream over ``net`` -> (net, n_applied)."""
    n = 0
    for rec in records:
        op = rec.op if isinstance(rec, WalRecord) else rec
        lsn = op.get("lsn", -1)
        try:
            net = apply_op(net, op)
        except Exception as e:
            raise WALReplayError(int(lsn), str(op.get("op")), e) from e
        n += 1
    return net, n


def iter_ops(path: str | Path, after_lsn: int = -1) -> Iterator[dict]:
    """Convenience: valid ops in ``path`` with lsn > after_lsn."""
    records, _, _ = scan(path)
    for r in records:
        if r.lsn > after_lsn:
            yield r.op
