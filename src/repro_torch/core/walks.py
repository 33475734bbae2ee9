"""Multilayer random walks and neighborhood samples — the sampling workload.

Threadle exists to drive sample- and traversal-based analytics (walk
fleets, ego networks, neighborhood samples) over population graphs:

* one-mode step: a uniform CSR-row neighbor sample;
* two-mode step: a hyperedge from the node's memberships, then a member
  of it — a draw from the pseudo-projected neighborhood with weight ∝
  Σ_{shared h} 1/k_h, without building the projection;
* multilayer step: each walker draws a layer from a categorical, then
  steps within it.

Every draw goes through ``core/prng.py``, so for the same key the port's
walks and samples equal the JAX package's bit for bit; on the card the row
samples run in the threefry row-sample kernel. The fleet's host loop lives
in ``traversal.random_walk_batch``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import prng
from .network import Network

__all__ = [
    "random_walk",
    "random_walk_batch",
    "ego_sample",
    "neighborhood_sample",
]


def _layer_logits(
    n_layers: int, layer_weights: Sequence[float] | None
) -> torch.Tensor:
    """Normalized float32 log-probs for the per-walker layer choice,
    computed on the host's CPU (the card's path copies them over)."""
    if layer_weights is None:
        probs = torch.full((n_layers,), 1.0 / n_layers, dtype=torch.float32)
    else:
        w = torch.as_tensor(list(layer_weights), dtype=torch.float32)
        probs = w / torch.sum(w)
    return torch.log(probs)


def random_walk(
    net: Network,
    start_nodes,
    n_steps: int,
    key,
    layer_names: Sequence[str] | None = None,
    layer_weights: Sequence[float] | None = None,
) -> torch.Tensor:
    """Batched multilayer random walk -> int32[B, n_steps + 1].

    One walker per start node, unfiltered; walkers with no valid move stay
    in place. The one fleet implementation is
    ``traversal.random_walk_batch``."""
    from .traversal import random_walk_batch as _rwb

    return _rwb(
        net, start_nodes, n_steps, key,
        layer_names=layer_names, layer_weights=layer_weights,
    )


def random_walk_batch(net: Network, *args, **kwargs) -> torch.Tensor:
    """Walk fleet: W walkers per start honoring ``layer_weights`` and
    ``node_filter`` — see ``traversal.random_walk_batch``."""
    from .traversal import random_walk_batch as _rwb

    return _rwb(net, *args, **kwargs)


def ego_sample(
    net: Network,
    egos,
    max_alters: int,
    layer_names: Sequence[str] | None = None,
    k: int = 1,
    node_filter=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Ego-network extraction: padded, deduped alters within k hops across
    layers of any mode (``traversal.ego_batch``)."""
    from .traversal import ego_batch

    return ego_batch(
        net, egos, max_alters, k=k, layer_names=layer_names,
        node_filter=node_filter,
    )


def neighborhood_sample(
    net: Network,
    seeds,
    fanout: Sequence[int],
    key,
    layer_names: Sequence[str] | None = None,
    layer_weights: Sequence[float] | None = None,
    method: str = "walk",
    max_alters_per_hop: int = 64,
) -> list[torch.Tensor]:
    """GraphSAGE-style multi-hop neighbor sampling with per-hop fanout.

    Returns a list of int32 tensors, hop i holding B * fanout[0] * ... *
    fanout[i] samples, seed-major.

    ``method="walk"``: each draw is one walk step (two-mode draws weighted
    ∝ Σ_{shared h} 1/k_h); the layer choice honors ``layer_weights``.

    ``method="alters"``: each hop gathers the multilayer alter set of each
    seed's whole frontier (``net.node_alters``, at most
    ``max_alters_per_hop`` smallest-id alters a frontier node), dedups it
    per seed (``dispatch.union_rows``: the segmented-union kernel on the
    card) and draws the hop's samples uniformly from that union; a seed
    with no alters stays in place. ``layer_weights`` does not apply.
    """
    from . import dispatch

    if method not in ("walk", "alters"):
        raise ValueError(f"unknown method {method!r}; use 'walk' or 'alters'")
    layers = net._select(layer_names)
    logits = _layer_logits(len(layers), layer_weights).to(net.device)
    frontier = net._batch(seeds)
    B = frontier.shape[0]
    hops = []
    for f in fanout:
        key, k_layer, k_step = prng.split(key, 3)
        if method == "alters":
            # (B seeds, F frontier nodes each): the union is per seed, not
            # per duplicated frontier entry
            f2d = frontier.reshape(B, -1)
            F = f2d.shape[-1]
            width = F * max_alters_per_hop
            alters, amask = net.node_alters(
                f2d.reshape(-1), max_alters_per_hop, layer_names
            )
            uni, umask = dispatch.union_rows(
                alters.reshape(B, width), amask.reshape(B, width), width
            )
            counts = umask.sum(dim=-1).to(torch.int32)
            r = prng.randint(k_step, (B, F * f), 0,
                             counts.clamp(min=1)[:, None], net.device)
            picked = torch.gather(uni, 1, r.long())
            picked = torch.where(  # seeds with no alters stay in place
                counts[:, None] > 0, picked,
                torch.repeat_interleave(f2d, f, dim=-1),
            )
            frontier = picked.to(torch.int32).reshape(-1)
            hops.append(frontier)
            continue
        flat = torch.repeat_interleave(frontier, f)
        if len(layers) == 1:
            nxt = layers[0].sample_neighbor(flat, k_step)[0]
        else:
            choice = prng.categorical(k_layer, logits, flat.shape)
            keys = prng.split(k_step, len(layers))
            candidates = torch.stack(
                [l.sample_neighbor(flat, kk)[0] for l, kk in zip(layers, keys)]
            )
            nxt = torch.gather(candidates, 0, choice[None].long())[0]
        hops.append(nxt)
        frontier = nxt
    return hops
