"""Carry LM parameters between the JAX package's tree and the port.

``params_from_jax`` takes the tree ``repro.models.model.Model.init``
returns, with its leaves turned into numpy arrays (or torch tensors) by
the caller, and gives the port's state dict: each pattern slot's
parameters are stacked over the ``n_groups`` scanned groups there
(``src/repro/models/model.py:92-100``) and are unstacked here into
``layers.<g * len(pattern) + slot>``; tail layers follow. Leaf names are
the same in both packages. ``params_to_jax`` is its inverse: any tree
keyed like the port's state dict (the parameters, their gradients, an
optimizer moment) -> the JAX layout, groups stacked. Checkpoints are
written in that layout, so they cross packages both ways.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy-to-torch path
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _flat(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flat(val, name + ".")
        else:
            yield name, val


def params_from_jax(params_np: dict, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX parameter tree (numpy leaves) -> the port ``Model``'s state dict."""
    out = {}
    for name in ("embed", "head"):
        if name in params_np:
            out[name] = _tensor(params_np[name])
    out["final_ln.w"] = _tensor(params_np["final_ln"]["w"])
    pat = len(cfg.block_pattern)
    for i in range(pat):
        for name, stacked in _flat(params_np["groups"][f"slot{i}"]):
            if not isinstance(stacked, torch.Tensor):
                stacked = np.asarray(stacked)
            if stacked.shape[0] != cfg.n_groups:
                raise ValueError(
                    f"groups.slot{i}.{name}: leading axis {stacked.shape[0]}, "
                    f"expected n_groups={cfg.n_groups}"
                )
            for g in range(cfg.n_groups):
                out[f"layers.{g * pat + i}.{name}"] = _tensor(stacked[g])
    for i in range(len(cfg.tail_pattern)):
        for name, val in _flat(params_np["tail"][f"tail{i}"]):
            out[f"layers.{cfg.n_groups * pat + i}.{name}"] = _tensor(val)
    return out


def _nest(tree: dict, dotted: str, value) -> None:
    *path, leaf = dotted.split(".")
    for key in path:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def params_to_jax(state: dict, cfg: ModelConfig) -> dict:
    """A tree keyed like the port ``Model``'s state dict (name -> tensor) ->
    the JAX package's parameter tree: ``embed``, ``head``, ``final_ln``,
    ``groups.slot<i>`` with each leaf stacked over the groups (a new tensor
    on the leaves' device), ``tail.tail<i>``."""
    out: dict = {}
    for name in ("embed", "head"):
        if name in state:
            out[name] = state[name]
    out["final_ln"] = {"w": state["final_ln.w"]}
    pat = len(cfg.block_pattern)
    layers: dict[int, dict[str, torch.Tensor]] = {}
    for name, val in state.items():
        if name.startswith("layers."):
            idx, rest = name[len("layers."):].split(".", 1)
            layers.setdefault(int(idx), {})[rest] = val
    groups: dict = {}
    for i in range(pat):
        for rest in layers[i]:
            stacked = torch.stack([layers[g * pat + i][rest]
                                   for g in range(cfg.n_groups)])
            _nest(groups.setdefault(f"slot{i}", {}), rest, stacked)
    out["groups"] = groups
    tail: dict = {}
    for i in range(len(cfg.tail_pattern)):
        for rest, val in layers[cfg.n_groups * pat + i].items():
            _nest(tail.setdefault(f"tail{i}", {}), rest, val)
    if tail:
        out["tail"] = tail
    return out
