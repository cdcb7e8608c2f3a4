"""Host reference of jax's threefry2x32 key tree, in numpy.

The JAX package draws seeded problem instances (the OU equation's Gaussian
mixture, ``equations/hjb.py``) with ``jax.random``; the card's machine has
no jax, so the port carries its own copy of the generator to give one seed
the same instance in both packages. Threefry-2x32 (Salmon et al., SC'11,
20 rounds) with jax's key derivation under ``jax_threefry_partitionable``
(the default since jax 0.5): counters are the flat iota of the requested
shape split into two 32-bit words, and 32-bit draws are the xor of the
two output words. ``uniform`` builds f32 uniforms in [0, 1) from the bits as
``jax.random.uniform`` does (top 23 bits OR the bits of 1.0, minus 1), and
``normal`` f32 normals as ``jax.random.normal`` does (sqrt(2) erfinv of a
uniform on (-1, 1)), through replicas of XLA's CPU log, log1p and erfinv so
that they are bit for bit jax's (the FN equation's w and v).
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


def fma_f32(a, b, c):
    """f32 fused multiply-add a b + c, rounded once: the product is exact
    in f64, and the f64 sum's rounding error (TwoSum) breaks the one tie
    that rounding the f64 sum to f32 could get wrong, an f32 midpoint."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    mid = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(1 << 28)
    s = np.where(mid & (err != 0), np.nextafter(s, s + err), s)
    return s.astype(np.float32)


def xla_log_f32(v: np.ndarray) -> np.ndarray:
    """log of positive f32 values as XLA computes it on the CPU (Cephes'
    polynomial, its products fused as the compiled code fuses them), so
    that values drawn through it (the OU mixture's log-weights) equal the
    JAX package's bit for bit; numpy's log is 1 ulp off on about a fifth
    of the inputs."""
    f = np.float32
    x = np.maximum(np.asarray(v, f), f(1.17549435e-38))
    bits = x.view(np.uint32)
    e = f(1.0) + ((bits >> 23).astype(np.int32) - 127).astype(f)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f)
    below = m < f(0.70710677)
    x = (m - f(1.0)) + np.where(below, m, f(0.0))
    e = e - np.where(below, f(1.0), f(0.0))
    x2 = x * x
    x3 = x2 * x
    y1 = fma_f32(fma_f32(x, f(7.0376836292e-2), f(-1.1514610310e-1)), x,
                 f(1.1676998740e-1))
    y2 = fma_f32(fma_f32(x, f(-1.2420140846e-1), f(1.4249322787e-1)), x,
                 f(-1.6668057665e-1))
    y3 = fma_f32(fma_f32(x, f(2.0000714765e-1), f(-2.4999993993e-1)), x,
                 f(3.3333331174e-1))
    y = fma_f32(fma_f32(fma_f32(y1, x3, y2), x3, y3), x3,
                f(-2.12194440e-4) * e)
    out = ((x - f(0.5) * x2) + y) + f(0.693359375) * e
    return np.where(np.asarray(v, f) == 0, f(-np.inf), out).astype(f)


# Cephes' rational log1p for |x| < sqrt(2) - 1, as XLA's CPU emitter
# evaluates it (Horner, the products fused)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(coeffs, x):
    f = np.float32
    r = np.full_like(x, f(coeffs[0]))
    for c in coeffs[1:]:
        r = fma_f32(r, x, f(c))
    return r


def xla_log1p_f32(v: np.ndarray) -> np.ndarray:
    """log(1 + v) of f32 values as XLA computes it on the CPU: the rational
    approximation below |v| = sqrt(2) - 1, ``xla_log_f32(1 + v)`` above."""
    f = np.float32
    x = np.asarray(v, f)
    x2 = x * x
    small = (_horner(_LOG1P_NUM, x) / _horner(_LOG1P_DEN, x)).astype(f)
    small = x + fma_f32(f(-0.5), x2, (x * x2) * small)
    large = xla_log_f32(x + f(1.0))
    return np.where(np.abs(x) < f(0.41421356237309504880), small,
                    large).astype(f)


# Giles' single-precision erfinv (XLA's ErfInv32): coefficients below and
# above w = -log(1 - x^2) = 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def xla_erfinv_f32(v: np.ndarray) -> np.ndarray:
    """erfinv of f32 values in (-1, 1) as XLA computes it on the CPU."""
    f = np.float32
    x = np.asarray(v, f)
    w = -xla_log1p_f32(-(x * x))
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0])).astype(f)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma_f32(p, w, np.where(lt, f(a), f(b)))
    out = p * x
    return np.where(np.abs(x) == f(1.0), x * np.finfo(f).max,
                    out).astype(f)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: sqrt(2) erfinv(u) with u
    uniform on [nextafter(-1, 0), 1), as jax's ``_normal_real`` draws it."""
    f = np.float32
    lo = np.nextafter(f(-1.0), f(0.0))
    u = np.maximum(lo, uniform(key, shape) * (f(1.0) - lo) + lo)
    return (f(np.sqrt(2.0)) * xla_erfinv_f32(u)).astype(f)
