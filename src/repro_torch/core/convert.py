"""Build the port's Network from plain numpy arrays (the carried-over state).

For a storage engine the "weights" are the network's buffers. The tree
that :func:`network_from_arrays` reads holds only numpy arrays and Python
scalars, so any producer can write it (the JAX package's tests do)::

    {"n_nodes": int,
     "layers": [{"name": str, "mode": 1, "directed": bool, "valued": bool,
                 "allow_self": bool, "store_inbound": bool,
                 "out": CSR, "in": CSR | None,
                 "out_ov": OV | None, "in_ov": OV | None},
                {"name": str, "mode": 2,
                 "memb": CSR, "members": CSR,
                 "max_memberships": int, "max_hyperedge_size": int,
                 "memb_ov": OV | None, "members_ov": OV | None}, ...],
     "attrs": [{"name": str, "kind": str, "node_ids": arr, "values": arr}]}

    CSR = {"indptr", "indices", "values" (or None), "n_rows", "n_cols"}
    OV  = {"delta": CSR, "dirty": bool arr, "base_shadowed": int}

Stored dtypes are kept, uint16-narrowed indices included (queries widen
them to int32 as they gather).
"""

from __future__ import annotations

import numpy as np

from .csr import CSR, csr_from_arrays, resolve_device, to_tensor
from .layers import LayerOneMode, LayerTwoMode
from .network import Network
from .nodeset import AttrColumn, AttributeStore, Nodeset
from .overlay import DeltaOverlay

__all__ = ["network_from_arrays"]


def _csr(tree: dict | None, device) -> CSR | None:
    if tree is None:
        return None
    return csr_from_arrays(
        np.asarray(tree["indptr"]), np.asarray(tree["indices"]),
        None if tree["values"] is None else np.asarray(tree["values"]),
        tree["n_rows"], tree["n_cols"], device,
    )


def _overlay(tree: dict | None, device) -> DeltaOverlay | None:
    if tree is None:
        return None
    dirty = np.ascontiguousarray(tree["dirty"], dtype=bool)
    return DeltaOverlay(
        delta=_csr(tree["delta"], device),
        dirty=to_tensor(dirty, device),
        base_shadowed=int(tree["base_shadowed"]),
        dirty_host=dirty,
    )


def _layer(tree: dict, device):
    if tree["mode"] == 2:
        return LayerTwoMode(
            memb=_csr(tree["memb"], device),
            members=_csr(tree["members"], device),
            max_memberships=int(tree["max_memberships"]),
            max_hyperedge_size=int(tree["max_hyperedge_size"]),
            memb_ov=_overlay(tree.get("memb_ov"), device),
            members_ov=_overlay(tree.get("members_ov"), device),
        )
    return LayerOneMode(
        out=_csr(tree["out"], device),
        in_=_csr(tree.get("in"), device),
        directed=bool(tree["directed"]),
        valued=bool(tree["valued"]),
        allow_self=bool(tree["allow_self"]),
        store_inbound=bool(tree["store_inbound"]),
        out_ov=_overlay(tree.get("out_ov"), device),
        in_ov=_overlay(tree.get("in_ov"), device),
    )


def network_from_arrays(tree: dict, device=None) -> Network:
    """The port's Network, on ``device``, from the array tree above."""
    device = resolve_device(device)
    columns = tuple(
        AttrColumn(
            node_ids=to_tensor(np.asarray(a["node_ids"], dtype=np.int32), device),
            values=to_tensor(np.asarray(a["values"]), device),
            kind=str(a["kind"]),
        )
        for a in tree.get("attrs", ())
    )
    names = tuple(str(a["name"]) for a in tree.get("attrs", ()))
    nodeset = Nodeset(
        attrs=AttributeStore(columns=columns, names=names),
        n_nodes=int(tree["n_nodes"]), device=device,
    )
    layers = tuple(_layer(t, device) for t in tree["layers"])
    return Network(
        nodeset=nodeset, layers=layers,
        layer_names=tuple(str(t["name"]) for t in tree["layers"]),
    )
