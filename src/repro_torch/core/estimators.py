"""Sample- and traversal-based estimators (threadleR's sampling analyses).

The standard walker-based estimators, over the engine's O(1) multilayer
(pseudo-projected) walk steps, so they run at population scale:

* ``estimate_mean_degree`` — uniform node sampling.
* ``estimate_degree_distribution`` — stationary-walk samples with 1/d
  importance reweighting (walks visit nodes ∝ degree).
* ``estimate_assortativity`` — attribute mixing over walker-sampled edges.
* ``estimate_component_mass`` — fraction of probes whose short walks hit
  the main walker trace.

Node samples and walks draw through ``core/prng.py``, so for the same key
they are the JAX package's bit for bit; the reductions after them stay
host numpy as in the JAX package (the mean degree is a float32 mean on the
device, whose summation order differs from XLA's).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import prng
from .csr import to_numpy
from .network import Network
from .walks import random_walk

__all__ = [
    "estimate_mean_degree",
    "estimate_degree_distribution",
    "estimate_assortativity",
    "estimate_component_mass",
]


def _uniform_nodes(net: Network, n: int, key) -> torch.Tensor:
    return prng.randint(key, (n,), 0, net.n_nodes, net.device)


def estimate_mean_degree(
    net: Network,
    n_samples: int,
    key,
    layer_names: Sequence[str] | None = None,
) -> float:
    """Mean degree via uniform node sampling (unbiased)."""
    degs = net.degree(_uniform_nodes(net, n_samples, key), layer_names)
    return float(torch.mean(degs.to(torch.float32)))


def estimate_degree_distribution(
    net: Network,
    n_walkers: int,
    n_steps: int,
    key,
    layer_names: Sequence[str] | None = None,
    max_degree: int = 64,
) -> np.ndarray:
    """P(deg = k) for k < max_degree, from walk-stationary samples.

    Walks visit nodes ∝ degree; weighting each visited node by 1/deg
    recovers the uniform distribution. The first half of each walk is
    discarded as burn-in.
    """
    k1, k2 = prng.split(key)
    paths = random_walk(net, _uniform_nodes(net, n_walkers, k1), n_steps, k2,
                        layer_names)
    visited = to_numpy(paths[:, n_steps // 2 :]).ravel()
    degs = to_numpy(net.degree(visited, layer_names))
    keep = degs > 0
    w = 1.0 / degs[keep]
    hist = np.zeros(max_degree)
    np.add.at(hist, np.clip(degs[keep], 0, max_degree - 1), w)
    return hist / max(hist.sum(), 1e-12)


def estimate_assortativity(
    net: Network,
    attr: str,
    n_walkers: int,
    n_steps: int,
    key,
    layer_names: Sequence[str] | None = None,
) -> float:
    """Pearson assortativity of a numeric attribute over sampled edges:
    each walk transition (u_t, u_{t+1}) with u_t ≠ u_{t+1} samples an edge
    of the (multilayer, pseudo-projected) graph."""
    k1, k2 = prng.split(key)
    paths = to_numpy(random_walk(
        net, _uniform_nodes(net, n_walkers, k1), n_steps, k2, layer_names
    ))
    u = paths[:, :-1].ravel()
    v = paths[:, 1:].ravel()
    moved = u != v
    u, v = u[moved], v[moved]
    au, hu = net.nodeset.get_attr(attr, net._batch(u))
    av, hv = net.nodeset.get_attr(attr, net._batch(v))
    ok = to_numpy(hu) & to_numpy(hv)
    x = to_numpy(au).astype(np.float64)[ok]
    y = to_numpy(av).astype(np.float64)[ok]
    if x.size < 2:
        return float("nan")
    # symmetrize (undirected edge samples)
    x2 = np.concatenate([x, y])
    y2 = np.concatenate([y, x])
    return float(np.corrcoef(x2, y2)[0, 1])


def estimate_component_mass(
    net: Network,
    n_walkers: int,
    n_steps: int,
    key,
    layer_names: Sequence[str] | None = None,
    n_probe: int = 512,
) -> float:
    """Estimated fraction of nodes in walker-reachable components: probes
    uniform nodes and checks whether short walks from them join the main
    walker trace (a collision test, no BFS over the graph)."""
    k1, k2, k3, k4 = prng.split(key, 4)
    trace = set(to_numpy(random_walk(
        net, _uniform_nodes(net, n_walkers, k1), n_steps, k2, layer_names
    )).ravel().tolist())
    probe_paths = to_numpy(random_walk(
        net, _uniform_nodes(net, n_probe, k3), max(n_steps // 4, 4), k4,
        layer_names,
    ))
    hit = np.fromiter(
        (len(trace.intersection(row.tolist())) > 0 for row in probe_paths),
        dtype=bool, count=n_probe,
    )
    return float(hit.mean())
