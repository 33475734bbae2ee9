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
    assert_same(port_csr.indices, jax_csr.indices)
    assert (port_csr.values is None) == (jax_csr.values is None)
    if jax_csr.values is not None:
        assert_same(port_csr.values, jax_csr.values)
