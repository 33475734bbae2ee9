"""Nodesets and the sparse node-attribute manager.

Each attribute is a sparse column — (sorted node_ids int32[k],
values[k]) on the device — so a node costs nothing in a column it has no
value in. Lookups are batched binary searches; absent values come back
masked. Selections (``Nodeset.select``) are host boolean masks: they
drive host-side query planning, and the query paths upload them once per
call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .csr import resolve_device, to_tensor

_ATTR_DTYPES = {
    "int": np.int32,
    "float": np.float32,
    "bool": np.bool_,
    "char": np.uint8,
}

_DEFAULTS = {
    "int": np.int32(0),
    "float": np.float32(np.nan),
    "bool": np.bool_(False),
    "char": np.uint8(0),
}

# Selection operators: canonical name -> numpy comparison.
_OPS = {
    "eq": np.equal,
    "ne": np.not_equal,
    "lt": np.less,
    "le": np.less_equal,
    "gt": np.greater,
    "ge": np.greater_equal,
}

_OP_ALIASES = {
    "==": "eq", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
    "has": "has", "exists": "has",
}


class NodeSelection:
    """A selected set of nodes: dense host boolean mask + set algebra."""

    __slots__ = ("mask",)

    def __init__(self, mask: np.ndarray):
        self.mask = np.asarray(mask, dtype=bool)

    @property
    def n_nodes(self) -> int:
        return int(self.mask.shape[0])

    @property
    def count(self) -> int:
        return int(self.mask.sum())

    def ids(self) -> np.ndarray:
        """Selected node ids, ascending int32."""
        return np.nonzero(self.mask)[0].astype(np.int32)

    def device_mask(self, device) -> torch.Tensor:
        return to_tensor(self.mask, device)

    def __and__(self, other: "NodeSelection") -> "NodeSelection":
        return NodeSelection(self.mask & _sel_mask(other))

    def __or__(self, other: "NodeSelection") -> "NodeSelection":
        return NodeSelection(self.mask | _sel_mask(other))

    def __invert__(self) -> "NodeSelection":
        return NodeSelection(~self.mask)

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return f"NodeSelection({self.count}/{self.n_nodes} nodes)"


def _sel_mask(sel) -> np.ndarray:
    if isinstance(sel, NodeSelection):
        return sel.mask
    return np.asarray(sel, dtype=bool)


def node_filter_mask(node_filter, n_nodes: int):
    """Normalize a node filter argument to a mask, or pass None through.

    Accepts a NodeSelection, any boolean array-like of shape [n_nodes]
    (numpy or torch), or None. Raises on a length mismatch.
    """
    if node_filter is None:
        return None
    if isinstance(node_filter, NodeSelection):
        node_filter = node_filter.mask
    shape = getattr(node_filter, "shape", None)
    if shape is not None and len(shape) == 1 and shape[0] != n_nodes:
        raise ValueError(
            f"node filter has {shape[0]} entries, network has {n_nodes} nodes"
        )
    return node_filter


@dataclass(frozen=True)
class AttrColumn:
    node_ids: torch.Tensor  # int32[k], sorted ascending
    values: torch.Tensor  # kind-typed [k]
    kind: str  # 'int' | 'float' | 'bool' | 'char'

    @property
    def n_set(self) -> int:
        return int(self.node_ids.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.node_ids.nbytes + self.values.nbytes)

    def get(self, nodes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Batched lookup -> (values[B], has_mask[B])."""
        k = self.node_ids.shape[0]
        default = torch.from_numpy(np.asarray(_DEFAULTS[self.kind])).to(
            self.values.device
        )
        if k == 0:
            return (
                default.expand(nodes.shape).clone(),
                torch.zeros(nodes.shape, dtype=torch.bool, device=nodes.device),
            )
        nodes = nodes.to(torch.int32)
        pos = torch.searchsorted(self.node_ids, nodes)
        posc = pos.clamp(0, k - 1)
        has = (pos < k) & (self.node_ids[posc] == nodes)
        return torch.where(has, self.values[posc], default), has


def attr_column(kind: str, node_ids: np.ndarray, values: np.ndarray,
                device) -> AttrColumn:
    if kind not in _ATTR_DTYPES:
        raise ValueError(f"unknown attribute kind {kind!r}; use {list(_ATTR_DTYPES)}")
    node_ids = np.asarray(node_ids, dtype=np.int32)
    order = np.argsort(node_ids, kind="stable")
    node_ids = node_ids[order]
    if node_ids.size and np.any(node_ids[1:] == node_ids[:-1]):
        # last write wins, like dict assignment
        keep = np.ones(node_ids.shape, dtype=bool)
        keep[:-1] = node_ids[:-1] != node_ids[1:]
        order = order[keep]
        node_ids = node_ids[keep]
    values = np.asarray(values)[order].astype(_ATTR_DTYPES[kind])
    return AttrColumn(
        node_ids=torch.from_numpy(np.ascontiguousarray(node_ids)).to(device),
        values=torch.from_numpy(np.ascontiguousarray(values)).to(device),
        kind=kind,
    )


@dataclass(frozen=True)
class AttributeStore:
    columns: tuple[AttrColumn, ...]
    names: tuple[str, ...]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.columns)

    def column(self, name: str) -> AttrColumn:
        try:
            return self.columns[self.names.index(name)]
        except ValueError:
            raise KeyError(f"no attribute {name!r}; have {self.names}") from None

    def get(self, name: str, nodes: torch.Tensor):
        return self.column(name).get(nodes)

    def with_column(self, name: str, col: AttrColumn) -> "AttributeStore":
        if name in self.names:
            i = self.names.index(name)
            cols = self.columns[:i] + (col,) + self.columns[i + 1 :]
            return AttributeStore(columns=cols, names=self.names)
        return AttributeStore(
            columns=self.columns + (col,), names=self.names + (name,)
        )

    def without_column(self, name: str) -> "AttributeStore":
        i = self.names.index(name)
        return AttributeStore(
            columns=self.columns[:i] + self.columns[i + 1 :],
            names=self.names[:i] + self.names[i + 1 :],
        )


def empty_attrs() -> AttributeStore:
    return AttributeStore(columns=(), names=())


@dataclass(frozen=True)
class Nodeset:
    """Node universe: contiguous ids 0..n_nodes-1 + attributes on ``device``."""

    attrs: AttributeStore
    n_nodes: int
    device: torch.device

    @property
    def nbytes(self) -> int:
        return self.attrs.nbytes

    def get_attr(self, name: str, nodes: torch.Tensor):
        return self.attrs.get(name, nodes)

    def set_attr(
        self, name: str, kind: str, node_ids: np.ndarray, values: np.ndarray
    ) -> "Nodeset":
        ids = np.asarray(node_ids)
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_nodes):
            raise ValueError("attribute node id out of range")
        col = attr_column(kind, ids, values, self.device)
        return Nodeset(
            attrs=self.attrs.with_column(name, col), n_nodes=self.n_nodes,
            device=self.device,
        )

    def drop_attr(self, name: str) -> "Nodeset":
        return Nodeset(
            attrs=self.attrs.without_column(name), n_nodes=self.n_nodes,
            device=self.device,
        )

    def select(self, name: str, op: str, value=None) -> NodeSelection:
        """Vectorized attribute predicate -> NodeSelection.

        ``op`` is one of eq/ne/lt/le/gt/ge (or ==, !=, <, <=, >, >=) plus
        ``has``/``exists``. Nodes *without* the attribute never match a
        comparison, ``ne`` included (SQL NULL semantics). The predicate is
        evaluated over the column's k stored entries only.
        """
        canon, want = self.check_select(name, op, value)
        col = self.attrs.column(name)
        ids = col.node_ids.cpu().numpy()
        mask = np.zeros(self.n_nodes, dtype=bool)
        if canon == "has":
            mask[ids] = True
            return NodeSelection(mask)
        vals = col.values.cpu().numpy()
        hit = _OPS[canon](vals, want)
        mask[ids[hit]] = True
        return NodeSelection(mask)

    def check_select(self, name: str, op: str, value=None) -> tuple:
        """Validate a ``select`` predicate without touching the column's
        buffers -> (canonical op, coerced value). Raises what ``select``
        raises for the same arguments: an unknown op or a missing or
        ill-typed comparison value (``ValueError``), an unknown attribute
        (``KeyError``)."""
        canon = _OP_ALIASES.get(op)
        if canon is None:
            raise ValueError(
                f"unknown selection op {op!r}; use {sorted(set(_OP_ALIASES))}"
            )
        col = self.attrs.column(name)
        if canon == "has":
            return canon, None
        return canon, _coerce_value(col.kind, value)

    def select_ids(self, name: str, op: str, value=None) -> np.ndarray:
        return self.select(name, op, value).ids()


def _coerce_value(kind: str, value):
    """Coerce a predicate comparison value to the column's compact type."""
    if value is None:
        raise ValueError("comparison ops require a value")
    if kind == "char":
        if isinstance(value, str):
            if len(value) != 1:
                raise ValueError(f"char comparison needs 1 character, got {value!r}")
            return np.uint8(ord(value))
        return np.uint8(value)
    if kind == "bool":
        if isinstance(value, str):
            return np.bool_(value.lower() in ("true", "1", "t"))
        return np.bool_(value)
    if kind == "int":
        return np.int32(value)
    return np.float32(value)


def create_nodeset(n_nodes: int, device=None) -> Nodeset:
    return Nodeset(
        attrs=empty_attrs(), n_nodes=int(n_nodes),
        device=resolve_device(device),
    )
