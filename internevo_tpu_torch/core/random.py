"""JAX's threefry random numbers in torch, bit for bit (the ``jax.random``
calls the JAX package makes: ``PRNGKey``, ``fold_in``, ``split``, ``bits``,
``uniform``, ``bernoulli``; and ``gpc.rng(name)``,
``internevo_tpu/core/context.py:291-305``).

The JAX package runs jax 0.9.0 with ``jax_threefry_partitionable`` on, so
every draw is threefry2x32 of the key and the element's logical index: the
flat index's high and low 32-bit words are the counter, and 32 random bits
are the xor of the two output words.  ``fold_in(key, d)`` hashes the counter
(0, d), and ``split(key, n)[i]`` is the hash of (0, i), which is
``fold_in(key, i)``.

A key is a pair of Python ints (two uint32 words) held on the host, so
deriving a layer's or a step's key costs no device work and no sync.  Only
``bits`` and what is built on it run over a tensor; uint32 values are held in
int64 tensors and masked to 32 bits after every add and shift.
``threefry2x32`` takes Python ints or int64 tensors alike.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

Key = tuple[int, int]

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
# bits drawn per pass of the tensor version, which bounds its int64 temporaries
_CHUNK = 1 << 22


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds, as ``jax._src.prng`` applies it: key
    (k0, k1), counter words (x0, x1) as Python ints or int64 tensors of
    uint32 values.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ (((x1 << r) & M32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def PRNGKey(seed: int) -> Key:  # noqa: N802  (the jax.random name)
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits: (0, seed)."""
    return 0, int(seed) & M32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the key's hash of the counter (0, data)."""
    return threefry2x32(key[0], key[1], 0, int(data) & M32)


def split(key: Key, num: int = 2) -> list[Key]:
    """``jax.random.split(key, num)`` as a list of keys."""
    return [threefry2x32(key[0], key[1], i >> 32, i & M32) for i in range(num)]


def _shape(shape) -> tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def bits(key: Key, shape: int | Sequence[int] = (), *, device) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: uint32 values in an int64
    tensor on ``device``, which the caller names (a draw on the wrong device
    would be copied silently)."""
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=device)
    for lo in range(0, n, _CHUNK):
        idx = torch.arange(lo, min(n, lo + _CHUNK), dtype=torch.int64, device=device)
        y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & M32)
        out[lo:lo + idx.shape[0]] = y0 ^ y1
    return out.reshape(shape)


def bits_scalar(key: Key) -> int:
    """``jax.random.bits(key)`` (shape ()) as a host int, with no tensor."""
    y0, y1 = threefry2x32(key[0], key[1], 0, 0)
    return y0 ^ y1


def uniform_from_bits(b: torch.Tensor) -> torch.Tensor:
    """JAX's float32 uniform on [0, 1) from uint32 bits: the top 23 bits as
    the mantissa of a float in [1, 2), minus 1; that is (b >> 9) * 2**-23,
    exactly."""
    return (b >> 9).to(torch.float32) * 2.0**-23


def uniform(key: Key, shape: int | Sequence[int] = (), minval: float = 0.0, maxval: float = 1.0, *,
            device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``.  XLA
    contracts ``u * (maxval - minval) + minval`` into one fused multiply-add;
    the product of two float32 values is exact in float64, so the sum is
    formed there and rounded once to float32."""
    u = uniform_from_bits(bits(key, shape, device=device))
    if (minval, maxval) == (0.0, 1.0):
        return u
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    width = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    return torch.maximum(lo, (u.double() * width.double() + lo.double()).float())


def bernoulli(key: Key, p: float = 0.5, shape: int | Sequence[int] = (), *, device) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a Python float ``p``:
    the float32 uniform below float32(p)."""
    return uniform(key, shape, device=device) < torch.tensor(p, dtype=torch.float32, device=device)


def stable_hash(name: str) -> int:
    """FNV-1a over the name's utf-8 bytes (``core/context.py::_stable_hash``)."""
    h = 2166136261
    for ch in name.encode():
        h = ((h ^ ch) * 16777619) & M32
    return h


def rng(seed: int, name: str) -> Key:
    """``gpc.rng(name)`` under ``gpc.set_seed(seed)``: the named stream."""
    return fold_in(PRNGKey(seed), stable_hash(name))
