"""Frozen-dataclass helpers for the port's data structures.

The JAX package registers its containers as pytrees so they flow through
``jit``. PyTorch runs eagerly, so here every container (CSR, layers,
networks) is a plain frozen ``dataclasses.dataclass`` holding tensors and
host metadata, and functional updates go through :func:`replace`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

_T = TypeVar("_T")


def replace(obj: _T, **changes: Any) -> _T:
    """``dataclasses.replace`` for the port's frozen containers."""
    return dataclasses.replace(obj, **changes)
