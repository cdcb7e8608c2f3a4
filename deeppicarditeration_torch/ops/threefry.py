"""Host reference of jax's threefry2x32 key tree, in numpy.

The JAX package draws seeded problem instances (the OU equation's Gaussian
mixture, ``equations/hjb.py``) with ``jax.random``; the card's machine has
no jax, so the port carries its own copy of the generator to give one seed
the same instance in both packages. Threefry-2x32 (Salmon et al., SC'11,
20 rounds) with jax's key derivation under ``jax_threefry_partitionable``
(the default since jax 0.5): counters are the flat iota of the requested
shape split into two 32-bit words, and 32-bit draws are the xor of the
two output words. ``uniform`` builds f32 uniforms in [0, 1) from the bits as
``jax.random.uniform`` does (top 23 bits OR the bits of 1.0, minus 1).
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_M32 = np.uint64(0xFFFFFFFF)


def _rotl(v, r: int):
    return ((v << np.uint64(r)) | (v >> np.uint64(32 - r))) & _M32


def threefry2x32(key, x0, x1):
    """The two output words of threefry-2x32 under ``key`` (two uint32) on
    counter words ``x0``, ``x1`` (uint32 arrays of one shape)."""
    k0, k1 = (np.uint64(int(k)) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(0x1BD11BDA))
    x0 = (np.asarray(x0, np.uint64) + ks[0]) & _M32
    x1 = (np.asarray(x1, np.uint64) + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + np.uint64(i + 1)) & _M32
    return x0.astype(np.uint32), x1.astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` with 32-bit integers (jax's default,
    x64 off): (0, seed mod 2^32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _hash(key, n: int):
    """Output words of the counters 0 .. n - 1 (the iota's hi, lo words)."""
    idx = np.arange(n, dtype=np.uint64)
    return threefry2x32(key, idx >> np.uint64(32), idx & _M32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter (0, data)."""
    a, b = threefry2x32(key, np.array([0], np.uint32),
                        np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([a[0], b[0]], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split``: key i is the hash of the counter i."""
    a, b = _hash(key, num)
    return np.stack([a, b], axis=1)


def random_bits(key, shape) -> np.ndarray:
    """32-bit draws of ``shape``: the xor of the two output words."""
    n = int(np.prod(shape, dtype=np.int64))
    a, b = _hash(key, n)
    return (a ^ b).reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    bits = random_bits(key, shape)
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)
