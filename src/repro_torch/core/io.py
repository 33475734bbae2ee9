"""File IO: binary serialization + text edge lists.

Binary format: a single ``.npz`` holding every array under structured
keys plus a JSON manifest describing layer types, flags, attribute kinds
and the stored array dtypes. It is the JAX package's format, manifest
``format`` string included (``threadle-jax/2``; ``threadle-jax/1`` files,
with no dtype metadata, still load), so a file saved by either package
loads in the other with identical buffers and dtypes: uint16 ids and
int32 or int64 ``indptr`` are written and restored as stored.
``save_network(compress=False)`` writes STORED (raw) zip members, which
``load_network(mmap=True)`` reads in place.

Loading to the card streams every array in bounded chunks through one
pinned staging buffer of fixed size (``STAGING_BYTES``, two halves: one
fills while the other uploads). With ``mmap=True`` the chunks are read
from the file's byte ranges (the page cache) straight into the staging
buffer, so no host copy of the big arrays is made and the mapping's
pages are never touched; only the ``indptr`` host mirrors that the
dispatcher plans from are read into host memory.

Text format: TSV edge / membership lists (``.tsv`` / ``.tsv.gz``),
imported through fixed-size numpy chunk buffers feeding the chunked CSR
builders, so peak import memory tracks the finished layer rather than a
Python list per column of the raw file.
"""

from __future__ import annotations

import gzip
import json
import zipfile
from pathlib import Path

import numpy as np
import torch

from .csr import CSR, DtypePolicy, resolve_device, to_numpy, to_tensor
from .layers import (
    LayerOneMode,
    LayerTwoMode,
    compact_layer,
    has_overlay,
    one_mode_from_edge_chunks,
    two_mode_from_membership_chunks,
)
from .network import Network, create_network
from .nodeset import AttrColumn, Nodeset

__all__ = [
    "TruncatedFileError",
    "IMPORT_CHUNK_ROWS",
    "STAGING_BYTES",
    "save_network",
    "load_network",
    "export_layer_tsv",
    "import_layer_tsv",
    "load_attrs_tsv",
]

# Default row count per import chunk: 1M rows = 16 MB of int64 id buffer
# (+4 MB of values when valued) regardless of file size.
IMPORT_CHUNK_ROWS = 1_000_000

# Pinned host bytes a load to the card streams every array through.
STAGING_BYTES = 64 << 20


class TruncatedFileError(ValueError):
    """A text import hit a file cut off mid-record.

    Raised with the 1-based line number of the torn record (or the line
    reached when a gzip stream ended early): importing a partial network
    silently would hand the caller a plausible layer with a bite taken
    out of it.
    """

    def __init__(self, path, lineno: int, detail: str):
        super().__init__(f"{path}:{lineno}: truncated file — {detail}")
        self.path = str(path)
        self.lineno = lineno


def _pack_csr(arrays: dict, prefix: str, csr: CSR) -> dict:
    indptr = csr.indptr_host
    indices = to_numpy(csr.indices)
    arrays[f"{prefix}.indptr"] = indptr
    arrays[f"{prefix}.indices"] = indices
    meta = {"n_rows": csr.n_rows, "n_cols": csr.n_cols,
            "valued": csr.values is not None,
            "dtypes": {"indptr": indptr.dtype.name,
                       "indices": indices.dtype.name}}
    if csr.values is not None:
        values = to_numpy(csr.values)
        arrays[f"{prefix}.values"] = values
        meta["dtypes"]["values"] = values.dtype.name
    return meta


class _Loader:
    """Turns the stored arrays of one file into tensors on ``device``.

    Arrays mapped by ``_mmap_npz`` are read from their byte range of the
    file, never through the mapping; other arrays are copied from memory.
    On a CUDA device each array goes up in chunks through one pinned
    staging buffer of ``STAGING_BYTES``.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._files: dict[str, object] = {}
        self._buf = None
        self._events: list = [None, None]
        self._turn = 0

    def close(self) -> None:
        for ev in self._events:
            if ev is not None:
                ev.synchronize()
        for f in self._files.values():
            f.close()
        self._files.clear()

    def _read(self, arr: np.ndarray, start: int, out: np.ndarray) -> None:
        """Bytes [start, start + out.size) of ``arr`` into the uint8 ``out``."""
        if isinstance(arr, np.memmap) and arr.filename is not None:
            f = self._files.get(arr.filename)
            if f is None:
                f = self._files[arr.filename] = open(arr.filename, "rb",
                                                     buffering=0)
            f.seek(arr.offset + start)
            view = memoryview(out)
            got = 0
            while got < out.size:
                n = f.readinto(view[got:])
                if not n:
                    raise ValueError(f"{arr.filename}: file ends inside an array")
                got += n
        else:
            src = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
            out[:] = src[start:start + out.size]

    def host(self, arr: np.ndarray) -> np.ndarray:
        """A host array with ``arr``'s contents (a mapped one read from
        its file; an array in memory as it is)."""
        if not isinstance(arr, np.memmap):
            return np.ascontiguousarray(arr)
        out = np.empty(arr.shape, arr.dtype)
        self._read(arr, 0, out.reshape(-1).view(np.uint8))
        return out

    def tensor(self, arr: np.ndarray) -> torch.Tensor:
        if self.device.type != "cuda":
            return to_tensor(self.host(arr), self.device)
        if self._buf is None:
            self._buf = torch.empty(STAGING_BYTES, dtype=torch.uint8,
                                    pin_memory=True)
        half = STAGING_BYTES // 2
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        out = torch.empty(arr.shape, dtype=dtype, device=self.device)
        dst = out.reshape(-1).view(torch.uint8)
        for s in range(0, dst.numel(), half):
            slot = self._turn % 2
            self._turn += 1
            if self._events[slot] is not None:
                self._events[slot].synchronize()  # its last upload is done
            stage = self._buf[slot * half:slot * half + min(half, dst.numel() - s)]
            self._read(arr, s, stage.numpy())
            dst[s:s + stage.numel()].copy_(stage, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._events[slot] = ev
        return out

    def csr(self, z, prefix: str, meta: dict) -> CSR:
        indptr = z[f"{prefix}.indptr"]
        indices = z[f"{prefix}.indices"]
        values = z[f"{prefix}.values"] if meta["valued"] else None
        # dtype metadata (threadle-jax/2+) cross-checks the stored members;
        # legacy manifests have none -- the npz dtype is authoritative
        for name, arr in (("indptr", indptr), ("indices", indices),
                          ("values", values)):
            want = meta.get("dtypes", {}).get(name)
            if want is not None and arr is not None and arr.dtype.name != want:
                raise ValueError(
                    f"{prefix}.{name}: manifest records dtype {want} but the "
                    f"stored array is {arr.dtype.name} — corrupt file"
                )
        indptr_host = self.host(indptr)
        return CSR(
            indptr=self.tensor(indptr_host),
            indices=self.tensor(indices),
            values=None if values is None else self.tensor(values),
            n_rows=meta["n_rows"],
            n_cols=meta["n_cols"],
            indptr_host=indptr_host,
        )


def save_network(
    net: Network, path: str | Path, compress: bool = True
) -> None:
    """Serialize to one ``.npz``. ``compress=False`` writes STORED zip
    members (larger on disk, but ``load_network(mmap=True)``-able).

    Delta overlays are folded into rebuilt base CSRs first: the on-disk
    format stores plain CSRs, and a reloaded network is bit-identical to
    the overlay-carrying one by the compaction contract."""
    net = net.compacted()
    arrays: dict[str, np.ndarray] = {}
    manifest: dict = {"format": "threadle-jax/2", "n_nodes": net.n_nodes,
                      "layers": [], "attrs": []}
    for name, layer in zip(net.layer_names, net.layers):
        key = f"layer.{name}"
        if isinstance(layer, LayerTwoMode):
            manifest["layers"].append({
                "name": name, "mode": 2,
                "memb": _pack_csr(arrays, f"{key}.memb", layer.memb),
                "members": _pack_csr(arrays, f"{key}.members", layer.members),
                "max_memberships": layer.max_memberships,
                "max_hyperedge_size": layer.max_hyperedge_size,
            })
        else:
            entry = {
                "name": name, "mode": 1,
                "out": _pack_csr(arrays, f"{key}.out", layer.out),
                "directed": layer.directed, "valued": layer.valued,
                "allow_self": layer.allow_self,
                "store_inbound": layer.store_inbound,
                "has_in": layer.in_ is not None,
            }
            if layer.in_ is not None:
                entry["in"] = _pack_csr(arrays, f"{key}.in", layer.in_)
            manifest["layers"].append(entry)
    for aname, col in zip(net.nodeset.attrs.names, net.nodeset.attrs.columns):
        arrays[f"attr.{aname}.ids"] = to_numpy(col.node_ids)
        arrays[f"attr.{aname}.values"] = to_numpy(col.values)
        manifest["attrs"].append({"name": aname, "kind": col.kind})
    arrays["__manifest__"] = np.frombuffer(
        json.dumps(manifest).encode(), dtype=np.uint8
    )
    if compress:
        np.savez_compressed(Path(path), **arrays)
    else:
        np.savez(Path(path), **arrays)


def _mmap_npz(path: Path) -> dict[str, np.ndarray]:
    """Memory-map every member of an UNCOMPRESSED npz.

    A STORED zip member is a raw ``.npy`` byte range inside the archive,
    so each array is an ``np.memmap`` at its absolute data offset (its
    ``offset`` and ``filename`` name that range). Raises on DEFLATE
    members.
    """
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as raw:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"{path}: member {info.filename} is compressed; "
                    "mmap load needs save_network(..., compress=False)"
                )
            # local file header: 30 fixed bytes + name + extra field
            raw.seek(info.header_offset + 26)
            name_len = int.from_bytes(raw.read(2), "little")
            extra_len = int.from_bytes(raw.read(2), "little")
            data_off = info.header_offset + 30 + name_len + extra_len
            raw.seek(data_off)
            version = np.lib.format.read_magic(raw)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(raw)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(raw)
            key = info.filename[:-4] if info.filename.endswith(".npy") else info.filename
            out[key] = np.memmap(
                path, dtype=dtype, mode="r", offset=raw.tell(), shape=shape,
                order="F" if fortran else "C",
            )
    return out


def load_network(path: str | Path, mmap: bool = False, device=None) -> Network:
    """Deserialize a network onto ``device`` (``None``: the CUDA card).

    ``mmap=True`` maps an uncompressed npz instead of reading the archive
    up front; the arrays then stream from the file into the device
    buffers with no intermediate host copy."""
    device = resolve_device(device)
    z = _mmap_npz(Path(path)) if mmap else np.load(Path(path))
    manifest = json.loads(bytes(z["__manifest__"]).decode())
    if manifest.get("format") not in ("threadle-jax/1", "threadle-jax/2"):
        raise ValueError(f"unknown file format in {path}")
    loader = _Loader(device)
    try:
        net = create_network(int(manifest["n_nodes"]), device=device)
        ns = net.nodeset
        for a in manifest["attrs"]:
            col = AttrColumn(
                node_ids=loader.tensor(z[f"attr.{a['name']}.ids"]),
                values=loader.tensor(z[f"attr.{a['name']}.values"]),
                kind=a["kind"],
            )
            ns = Nodeset(attrs=ns.attrs.with_column(a["name"], col),
                         n_nodes=ns.n_nodes, device=device)
        net = Network(nodeset=ns, layers=(), layer_names=())
        for entry in manifest["layers"]:
            key = f"layer.{entry['name']}"
            if entry["mode"] == 2:
                layer = LayerTwoMode(
                    memb=loader.csr(z, f"{key}.memb", entry["memb"]),
                    members=loader.csr(z, f"{key}.members", entry["members"]),
                    max_memberships=entry["max_memberships"],
                    max_hyperedge_size=entry["max_hyperedge_size"],
                )
            else:
                layer = LayerOneMode(
                    out=loader.csr(z, f"{key}.out", entry["out"]),
                    in_=loader.csr(z, f"{key}.in", entry["in"])
                    if entry["has_in"] else None,
                    directed=entry["directed"], valued=entry["valued"],
                    allow_self=entry["allow_self"],
                    store_inbound=entry["store_inbound"],
                )
            net = net.with_layer(entry["name"], layer)
    finally:
        loader.close()
    return net


# ---------------------------------------------------------------------------
# Text IO
# ---------------------------------------------------------------------------


def _open_text(path: Path, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode + "t")
    return open(path, mode)


def _iter_lines(f, path: Path):
    """Yield lines, converting a mid-stream gzip EOF into TruncatedFileError."""
    lineno = 0
    it = iter(f)
    while True:
        try:
            line = next(it)
        except StopIteration:
            return
        except EOFError:
            raise TruncatedFileError(
                path, lineno + 1, "compressed stream ended mid-record"
            ) from None
        lineno += 1
        yield line


def export_layer_tsv(net: Network, layer_name: str, path: str | Path) -> None:
    """One-mode: ``src\\tdst[\\tvalue]`` rows; two-mode: ``node\\thyperedge``.

    Written line by line from host copies of the layer's buffers, in the
    JAX package's format, byte for byte."""
    layer = net.layer(layer_name)
    if has_overlay(layer):
        layer = compact_layer(layer)
    path = Path(path)
    with _open_text(path, "w") as f:
        if isinstance(layer, LayerTwoMode):
            indptr = layer.memb.indptr_host
            idx = to_numpy(layer.memb.indices)
            for u in range(layer.n_nodes):
                for h in idx[indptr[u] : indptr[u + 1]]:
                    f.write(f"{u}\t{h}\n")
        else:
            indptr = layer.out.indptr_host
            idx = to_numpy(layer.out.indices)
            vals = None if layer.out.values is None else to_numpy(layer.out.values)
            for u in range(layer.n_nodes):
                for k in range(indptr[u], indptr[u + 1]):
                    v = idx[k]
                    if not layer.directed and v < u:
                        continue  # write each undirected edge once
                    if vals is None:
                        f.write(f"{u}\t{v}\n")
                    else:
                        f.write(f"{u}\t{v}\t{vals[k]}\n")


def _iter_tsv_chunks(
    path: Path,
    valued: bool,
    default_value: float | None,
    chunk_rows: int,
):
    """Parse a TSV edge/membership file into fixed-size numpy chunks.

    Yields ``(src int64[k], dst int64[k], vals float32[k]|None)`` with
    ``k <= chunk_rows``; the preallocated chunk buffers are the only
    import-side storage, so peak parse memory is constant in file size.
    """
    sbuf = np.empty(chunk_rows, dtype=np.int64)
    dbuf = np.empty(chunk_rows, dtype=np.int64)
    vbuf = np.empty(chunk_rows, dtype=np.float32) if valued else None
    k = 0
    with _open_text(path, "r") as f:
        for lineno, line in enumerate(_iter_lines(f, path), 1):
            parts = line.rstrip("\n").split("\t")
            if not line.strip():
                continue  # blank/trailing lines are fine
            if len(parts) < 2:
                # a non-blank single-field row is a record cut mid-write
                raise TruncatedFileError(
                    path, lineno,
                    f"edge row {parts[0]!r} has no destination column",
                )
            try:
                sbuf[k] = int(parts[0])
                dbuf[k] = int(parts[1])
            except ValueError:
                raise ValueError(
                    f"{path}:{lineno}: cannot parse edge row {line!r}"
                ) from None
            if valued:
                if len(parts) > 2 and parts[2] != "":
                    vbuf[k] = float(parts[2])
                elif default_value is not None:
                    vbuf[k] = default_value
                else:
                    raise ValueError(
                        f"{path}:{lineno}: valued import but row "
                        f"{parts[0]!r}\\t{parts[1]!r} has no value column; "
                        "fix the file or pass default_value to fill"
                    )
            k += 1
            if k == chunk_rows:
                yield (sbuf[:k].copy(), dbuf[:k].copy(),
                       None if vbuf is None else vbuf[:k].copy())
                k = 0
    if k:
        yield (sbuf[:k].copy(), dbuf[:k].copy(),
               None if vbuf is None else vbuf[:k].copy())


def import_layer_tsv(
    path: str | Path,
    n_nodes: int,
    mode: int = 1,
    directed: bool = False,
    valued: bool = False,
    n_hyperedges: int | None = None,
    default_value: float | None = None,
    chunk_rows: int = IMPORT_CHUNK_ROWS,
    policy: DtypePolicy | None = None,
    device=None,
):
    """Inverse of export_layer_tsv. Returns a layer object on ``device``.

    Streams the file in ``chunk_rows``-sized numpy chunks straight into
    the chunked CSR builders. For one-pass streaming of a two-mode layer,
    pass ``n_hyperedges``; without it the hyperedge-id space has to be
    discovered, so the parsed chunks are buffered first.

    With ``valued=True`` every row must carry a third (value) column; a
    missing value raises, unless ``default_value`` fills the gap.
    """
    path = Path(path)
    if mode == 1 and valued and not directed:
        # re-iterable source: the undirected builder parses twice so
        # duplicate-value resolution is chunk-size invariant
        chunks = lambda: _iter_tsv_chunks(  # noqa: E731
            path, valued, default_value, chunk_rows
        )
    else:
        chunks = _iter_tsv_chunks(path, valued, default_value, chunk_rows)
    if mode == 2:
        h = n_hyperedges
        if h is None:
            buffered = list(chunks)
            h = max(
                (int(d.max()) + 1 for _, d, _ in buffered if d.size),
                default=1,
            )
            chunks = iter(buffered)
        return two_mode_from_membership_chunks(
            n_nodes, h, ((s, d) for s, d, _ in chunks), policy=policy,
            device=device,
        )
    return one_mode_from_edge_chunks(
        n_nodes, chunks, directed=directed, valued=valued, policy=policy,
        device=device,
    )


def _parse_bool_cell(s: str) -> bool:
    t = s.strip().lower()
    if t in ("true", "1", "t", "yes"):
        return True
    if t in ("false", "0", "f", "no"):
        return False
    raise ValueError(f"not a bool: {s!r}")


def _parse_char_cell(s: str) -> int:
    t = s.strip()
    if len(t) != 1:
        raise ValueError(f"char needs exactly 1 character, got {s!r}")
    return ord(t)


# Attribute TSV parsing: per-kind value readers; all raise ValueError on
# malformed cells.
_ATTR_PARSERS = {
    "int": lambda s: int(float(s)),
    "float": float,
    "bool": _parse_bool_cell,
    "char": _parse_char_cell,
}


def load_attrs_tsv(
    path: str | Path,
    name: str | None = None,
    kind: str | None = None,
) -> list[tuple[str, str, np.ndarray, np.ndarray]]:
    """Sparse node-attribute TSV import (CLI ``loadattrs``).

    Two accepted shapes:

    * header format — first line ``node<TAB>name:kind[<TAB>name:kind...]``,
      one column per attribute; an *empty cell* means the node has no value
      for that attribute;
    * two columns ``node<TAB>value`` with ``name``/``kind`` passed in.

    Returns ``[(name, kind, node_ids, values)]`` ready for
    ``Nodeset.set_attr``.
    """
    path = Path(path)
    with _open_text(path, "r") as f:
        numbered = [(i, l.rstrip("\n"))
                    for i, l in enumerate(_iter_lines(f, path), 1)]
    numbered = [(i, l) for i, l in numbered if l.strip()]
    if not numbered:
        return []
    lines = [l for _, l in numbered]
    head = lines[0].split("\t")
    if head[0].lstrip("#").strip().lower() == "node" and len(head) > 1:
        cols = []
        for spec in head[1:]:
            if ":" not in spec:
                raise ValueError(
                    f"{path}: header column {spec!r} is not 'name:kind'"
                )
            cname, ckind = (s.strip() for s in spec.rsplit(":", 1))
            if ckind not in _ATTR_PARSERS:
                raise ValueError(
                    f"{path}: unknown attribute kind {ckind!r} in header"
                )
            cols.append((cname, ckind, [], []))
        for lineno, line in numbered[1:]:
            parts = line.split("\t")
            try:
                node = int(parts[0])
            except ValueError:
                raise TruncatedFileError(
                    path, lineno,
                    f"row starts with non-id field {parts[0]!r}",
                ) from None
            for ci, (cname, ckind, ids, vals) in enumerate(cols):
                cell = parts[ci + 1].strip() if ci + 1 < len(parts) else ""
                if cell == "":
                    continue  # sparse: absent value costs nothing
                try:
                    vals.append(_ATTR_PARSERS[ckind](cell))
                except (ValueError, IndexError):
                    raise ValueError(
                        f"{path}:{lineno}: cannot parse {cell!r} as {ckind}"
                    ) from None
                ids.append(node)
        return [
            (cname, ckind, np.asarray(ids, np.int64), np.asarray(vals))
            for cname, ckind, ids, vals in cols
        ]
    if name is None or kind is None:
        raise ValueError(
            f"{path} has no 'node<TAB>name:kind' header; pass name= and kind="
        )
    if kind not in _ATTR_PARSERS:
        raise ValueError(f"unknown attribute kind {kind!r}")
    ids, vals = [], []
    for lineno, line in numbered:
        parts = line.split("\t")
        if len(parts) < 2 or parts[1].strip() == "":
            raise TruncatedFileError(
                path, lineno, "expected node<TAB>value"
            )
        try:
            ids.append(int(parts[0]))
        except ValueError:
            raise ValueError(
                f"{path}:{lineno}: node id {parts[0]!r} is not an integer"
            ) from None
        try:
            vals.append(_ATTR_PARSERS[kind](parts[1].strip()))
        except ValueError:
            raise ValueError(
                f"{path}:{lineno}: cannot parse {parts[1].strip()!r} "
                f"as {kind}"
            ) from None
    return [(name, kind, np.asarray(ids, np.int64), np.asarray(vals))]
