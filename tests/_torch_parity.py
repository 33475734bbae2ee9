"""Helpers shared by the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX package is the reference: a test builds state with it, carries
the buffers across as plain numpy arrays (the port's
``network_from_arrays`` tree), runs the same queries in both packages on
the CPU, and compares the results as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def csr_tree(c) -> dict | None:
    if c is None:
        return None
    return {
        "indptr": np.asarray(c.indptr),
        "indices": np.asarray(c.indices),
        "values": None if c.values is None else np.asarray(c.values),
        "n_rows": c.n_rows,
        "n_cols": c.n_cols,
    }


def overlay_tree(ov) -> dict | None:
    if ov is None:
        return None
    return {
        "delta": csr_tree(ov.delta),
        "dirty": np.asarray(ov.dirty),
        "base_shadowed": ov.base_shadowed,
    }


def layer_tree(name: str, layer) -> dict:
    if layer.mode == 2:
        return {
            "name": name, "mode": 2,
            "memb": csr_tree(layer.memb), "members": csr_tree(layer.members),
            "max_memberships": layer.max_memberships,
            "max_hyperedge_size": layer.max_hyperedge_size,
            "memb_ov": overlay_tree(layer.memb_ov),
            "members_ov": overlay_tree(layer.members_ov),
        }
    return {
        "name": name, "mode": 1,
        "directed": layer.directed, "valued": layer.valued,
        "allow_self": layer.allow_self, "store_inbound": layer.store_inbound,
        "out": csr_tree(layer.out), "in": csr_tree(layer.in_),
        "out_ov": overlay_tree(layer.out_ov), "in_ov": overlay_tree(layer.in_ov),
    }


def network_tree(net) -> dict:
    """A JAX ``Network`` as the numpy tree ``network_from_arrays`` reads."""
    attrs = net.nodeset.attrs
    return {
        "n_nodes": net.n_nodes,
        "layers": [layer_tree(n, l) for n, l in zip(net.layer_names, net.layers)],
        "attrs": [
            {"name": n, "kind": c.kind, "node_ids": np.asarray(c.node_ids),
             "values": np.asarray(c.values)}
            for n, c in zip(attrs.names, attrs.columns)
        ],
    }


def port_network(jax_net):
    from repro_torch.core.convert import network_from_arrays

    return network_from_arrays(network_tree(jax_net), device="cpu")


def port_layer(name: str, jax_layer):
    from repro_torch.core.convert import _layer

    return _layer(layer_tree(name, jax_layer), torch.device("cpu"))


def np_of(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_same(a, b) -> None:
    """Bit-identical: same dtype, same shape, same values."""
    a, b = np_of(a), np_of(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def assert_csr_identical(port_csr, jax_csr) -> None:
    """Byte identity of every CSR buffer (dtypes included)."""
    assert (port_csr.n_rows, port_csr.n_cols) == (jax_csr.n_rows, jax_csr.n_cols)
    assert_same(port_csr.indptr, jax_csr.indptr)
    assert_same(port_csr.indptr_host, jax_csr.indptr)
    if hasattr(jax_csr, "indptr_host"):  # both sides the port's
        assert_same(jax_csr.indptr_host, jax_csr.indptr)
    assert_same(port_csr.indices, jax_csr.indices)
    assert (port_csr.values is None) == (jax_csr.values is None)
    if jax_csr.values is not None:
        assert_same(port_csr.values, jax_csr.values)


def assert_overlay_identical(port_ov, jax_ov) -> None:
    """Byte identity of a delta overlay: its delta CSR, dirty mask (and the
    port's host mirror of it) and shadowed count."""
    assert (port_ov is None) == (jax_ov is None), (port_ov, jax_ov)
    if jax_ov is None:
        return
    assert_csr_identical(port_ov.delta, jax_ov.delta)
    assert_same(port_ov.dirty, jax_ov.dirty)
    assert_same(port_ov.dirty_host, jax_ov.dirty)
    if hasattr(jax_ov, "dirty_host"):
        assert_same(jax_ov.dirty_host, jax_ov.dirty)
    assert port_ov.base_shadowed == jax_ov.base_shadowed


def assert_layer_identical(port_layer, jax_layer) -> None:
    assert port_layer.mode == jax_layer.mode
    if jax_layer.mode == 2:
        assert_csr_identical(port_layer.memb, jax_layer.memb)
        assert_csr_identical(port_layer.members, jax_layer.members)
        assert (port_layer.max_memberships, port_layer.max_hyperedge_size) == (
            jax_layer.max_memberships, jax_layer.max_hyperedge_size)
        assert_overlay_identical(port_layer.memb_ov, jax_layer.memb_ov)
        assert_overlay_identical(port_layer.members_ov, jax_layer.members_ov)
        return
    for flag in ("directed", "valued", "allow_self", "store_inbound"):
        assert getattr(port_layer, flag) == getattr(jax_layer, flag), flag
    assert_csr_identical(port_layer.out, jax_layer.out)
    assert (port_layer.in_ is None) == (jax_layer.in_ is None)
    if jax_layer.in_ is not None:
        assert_csr_identical(port_layer.in_, jax_layer.in_)
    assert_overlay_identical(port_layer.out_ov, jax_layer.out_ov)
    assert_overlay_identical(port_layer.in_ov, jax_layer.in_ov)


def assert_network_identical(port_net, jax_net) -> None:
    """Every buffer of a network byte-identical, dtypes included: layers,
    overlays and attribute columns (either side may be either package's)."""
    assert port_net.n_nodes == jax_net.n_nodes
    assert port_net.layer_names == jax_net.layer_names
    for a, b in zip(port_net.layers, jax_net.layers):
        assert_layer_identical(a, b)
    pa, ja = port_net.nodeset.attrs, jax_net.nodeset.attrs
    assert pa.names == ja.names
    for a, b in zip(pa.columns, ja.columns):
        assert a.kind == b.kind
        assert_same(a.node_ids, b.node_ids)
        assert_same(a.values, b.values)
