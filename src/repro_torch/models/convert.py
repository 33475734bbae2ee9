"""Carry the JAX package's LM parameters across to the port.

``params_from_jax`` takes the tree ``repro.models.model.Model.init``
returns, with its leaves turned into numpy arrays by the caller, and gives
the port's state dict: each pattern slot's parameters are stacked over
the ``n_groups`` scanned groups there (``src/repro/models/model.py:92-100``)
and are unstacked here into ``layers.<g * len(pattern) + slot>``; tail
layers follow. Leaf names are the same in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ModelConfig


def _tensor(a) -> torch.Tensor:
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
