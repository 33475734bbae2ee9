"""Counter-based random draws that equal ``jax.random``'s bit for bit.

The JAX package draws every random number from threefry-2x32 keys
(``jax.random.PRNGKey``): walk steps, row samples, layer choices, the
estimators' node samples. This module reimplements that generator so
that the port's draws are the JAX package's for the same seed:

* a key is a host pair of uint32 words, held as a tuple of two Python
  ints (``Key``); ``key(seed)`` is ``PRNGKey(seed)``: ``(0, seed mod
  2^32)``, as JAX builds it with 64-bit integers disabled;
* ``split``, ``fold_in`` and the subkeys inside ``randint`` are computed
  on the host in numpy, so deriving a key never waits for the card;
* ``random_bits``, ``randint``, ``uniform`` and ``categorical`` draw
  arrays on a device: on a CUDA device through the threefry kernel
  (``csrc/threefry.cu``, ``kernels/ops.py``), on the CPU through its plain
  torch version (``kernels/ref.py``).

Only JAX's *partitionable* scheme is implemented
(``jax_threefry_partitionable=True``, JAX's default since 0.5.0): element
i of a draw hashes the counter pair (i >> 32, i & 0xFFFFFFFF) under the
key, and its 32 bits are the xor of the two output words; key i of a
``split`` is the two output words of counter i. The first K elements of a
draw therefore depend only on the key and on K, never on the draw's
length. The older scheme is not implemented.

Integer draws are exact. ``uniform`` maps bits to floats exactly as
JAX's ``_uniform`` does; ``categorical`` takes ``-log(-log(u))`` with the
device's ``log``, so on the card a near-tie between two categories may
resolve otherwise than on the CPU.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

__all__ = [
    "Key",
    "key",
    "split",
    "fold_in",
    "threefry2x32",
    "random_bits",
    "randint",
    "uniform",
    "normal",
    "categorical",
]

Key = tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# float32's smallest normal number: the low end of the Gumbel's uniform
_F32_TINY = float(np.finfo(np.float32).tiny)


def threefry2x32(k: Key, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key ``k``, on the host: uint32 arrays in, uint32 arrays out."""
    k0, k1 = np.uint32(k[0]), np.uint32(k[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3]  # array + scalar: wraps without a warning
        x1 = x1 + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed's low 32 bits, high word 0."""
    return (0, int(seed) & _M32)


def split(k: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(k, num)`` as a list of keys."""
    i = np.arange(num, dtype=np.uint64)
    b0, b1 = threefry2x32(
        k, (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)
    )
    return [(int(a), int(b)) for a, b in zip(b0, b1)]


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for ``0 <= data < 2^32``."""
    data = int(data)
    if not 0 <= data <= _M32:
        raise OverflowError(f"fold_in data {data} is out of bounds for uint32")
    b0, b1 = threefry2x32(k, np.zeros(1, np.uint32), np.full(1, data, np.uint32))
    return (int(b0[0]), int(b1[0]))


def _shape(shape) -> tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def random_bits(k: Key, shape, device) -> torch.Tensor:
    """32 random bits per element -> int32 tensor of ``shape`` holding the
    uint32 bit patterns of ``jax.random.bits(k, shape)``."""
    from repro_torch.kernels import ops as kops

    shape = _shape(shape)
    return kops.threefry_bits(k, math.prod(shape), torch.device(device)).reshape(shape)


def _bound(x, shape, device) -> int | torch.Tensor:
    """A randint bound as a Python int or an int32 tensor of ``shape``,
    clipped to int32 as ``_randint`` converts it."""
    if isinstance(x, torch.Tensor):
        x = x.to(device=device)
        if x.dim() == 0:
            return int(x)
        if x.is_floating_point():
            x = x.long()
        x = x.clamp(-(2**31), 2**31 - 1).to(torch.int32)
        return x.expand(shape).reshape(-1).contiguous()
    return int(min(max(int(x), -(2**31)), 2**31 - 1))


def randint(k: Key, shape, minval, maxval, device) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (int32) -> int32.

    ``minval`` and ``maxval`` are ints or integer tensors broadcastable to
    ``shape`` (per-element bounds, as ``_randint`` broadcasts them); where
    ``maxval <= minval`` the draw is ``minval``."""
    from repro_torch.kernels import ops as kops

    shape = _shape(shape)
    device = torch.device(device)
    k1, k2 = split(k)
    lo, hi = _bound(minval, shape, device), _bound(maxval, shape, device)
    out = kops.randint(k1, k2, lo, hi, math.prod(shape), device)
    return out.reshape(shape)


def uniform(k: Key, shape, device, minval: float = 0.0, maxval: float = 1.0
            ) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: the top 23
    bits as a float in [1, 2), minus 1, scaled, floored at ``minval``."""
    bits = random_bits(k, shape, device)
    mant = torch.bitwise_and(torch.bitwise_right_shift(bits, 9), 0x7FFFFF)
    floats = torch.bitwise_or(mant, 0x3F800000).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


# the low end of ``normal``'s uniform: the float32 after -1 towards 0
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def normal(k: Key, shape, device) -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)``: a uniform draw in
    (-1, 1) from the bits, then ``sqrt(2) * erfinv``. The bits and the
    uniform equal JAX's exactly; ``torch.erfinv`` may differ from XLA's in
    the last bits."""
    u = uniform(k, shape, device, minval=_NORMAL_LO, maxval=1.0)
    return torch.erfinv(u) * float(np.float32(np.sqrt(2)))


def categorical(k: Key, logits: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.categorical(k, logits, shape=shape)`` for a float32
    vector of logits -> int32[shape]: the argmax over the last axis of
    Gumbel noise (JAX's "low" mode) plus the logits."""
    shape = _shape(shape)
    u = uniform(k, shape + (logits.shape[-1],), logits.device, minval=_F32_TINY)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)
