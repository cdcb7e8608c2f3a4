"""Host reference of ``csrc/philox.cuh``: the CUDA kernels' normals in numpy.

Philox4x32-10 (Salmon et al., SC'11) in exact uint64 arithmetic, the
mantissa-trick uniform and Box-Muller with both outputs, written apart from
the device code so that the kernels' in-kernel draws can be held against
it value for value. It rebuilds each kernel's counter layout (see
``philox.cuh``):

* ``normals_flat``: the normals kernel, value at flat index i from counter
  (i / 4 lo, i / 4 hi, stream 3, seed_hi), key (seed_lo, 0);
* ``estimator_normals`` / ``estimator_times``: the estimator kernels' dW
  rows and time uniforms of given points, counter (draw, quad, stream,
  seed_hi), key (seed_lo, point), point = the row of tx in the launch;
* ``path_normals``: the rollout kernel's increments xi[k, b, j], counter
  (k / 4, j, stream 4, seed_hi), key (seed_lo, b);
* ``probe_units``: the rate probe's draws, counter (quad, iteration,
  stream 5, seed_hi), key (seed_lo, block).

Fed as external noise to a kernel's plain version, these draws must give
what the kernel computes with its own (``chip_smoke.py``,
``tests/test_torch_gpu.py``). Box-Muller is evaluated in float64 from the
same float32 uniforms and angle, so values agree with the card's
``logf``/``sqrtf``/``sincosf`` to a few float32 ulps.
"""

from __future__ import annotations

import numpy as np

STREAM_TERMINAL, STREAM_INTEGRAL, STREAM_TIME, STREAM_NORMALS = 0, 1, 2, 3
STREAM_PATHS, STREAM_PROBE = 4, 5
# the rate probe's tile: LANES columns, PROBE_ROWS partial-sum rows, and
# PROBE_BLK rows of units per iteration (probe.cu)
LANES, PROBE_ROWS, PROBE_BLK = 128, 8, 256

_U64 = np.uint64
_MASK = _U64(0xFFFFFFFF)
_SHIFT = _U64(32)
_MUL = (_U64(0xD2511F53), _U64(0xCD9E8D57))
_WEYL = (_U64(0x9E3779B9), _U64(0xBB67AE85))
_TWO_PI = np.float32(6.283185307179586)


def philox4x32_10(ctr, key):
    """Philox4x32-10 of counters ``ctr`` (4 arrays) under keys ``key`` (2
    arrays), all broadcast together; returns 4 uint32 arrays."""
    c = [np.asarray(v).astype(_U64) for v in ctr]
    k0, k1 = (np.asarray(v).astype(_U64) for v in key)
    for r in range(10):
        if r:
            k0 = (k0 + _WEYL[0]) & _MASK
            k1 = (k1 + _WEYL[1]) & _MASK
        p0 = _MUL[0] * c[0]  # < 2^64: exact
        p1 = _MUL[1] * c[2]
        c = [(p1 >> _SHIFT) ^ c[1] ^ k0, p1 & _MASK,
             (p0 >> _SHIFT) ^ c[3] ^ k1, p0 & _MASK]
    return [v.astype(np.uint32) for v in c]


def uniform_from_bits(bits) -> np.ndarray:
    """uint32 -> float32 in (0, 1]: the top 23 bits as the mantissa of a
    float in [1, 2), subtracted from 2."""
    bits = np.asarray(bits, dtype=np.uint32)
    one_two = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32)
    return np.float32(2.0) - one_two


def box_muller(b1, b2):
    """Two normals (float32) from two uint32 words, as ``box_muller``."""
    u1 = uniform_from_bits(b1).astype(np.float64)
    angle = (_TWO_PI * uniform_from_bits(b2)).astype(np.float64)
    r = np.sqrt(-2.0 * np.log(u1))
    return ((r * np.cos(angle)).astype(np.float32),
            (r * np.sin(angle)).astype(np.float32))


def _split(seed: int):
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & 0xFFFFFFFF, seed >> 32


def _quad_normals(words):
    """(..., 4) float32: the 4 normals of each Philox output."""
    n0, n1 = box_muller(words[0], words[1])
    n2, n3 = box_muller(words[2], words[3])
    return np.stack([n0, n1, n2, n3], axis=-1)


def normals_flat(seed: int, start: int, count: int) -> np.ndarray:
    """Values ``start`` .. ``start + count`` of the normals kernel's flat
    buffer for ``seed`` (float32)."""
    lo, hi = _split(seed)
    q0, q1 = start // 4, (start + count + 3) // 4
    q = np.arange(q0, q1, dtype=np.uint64)
    words = philox4x32_10(
        (q & _MASK, q >> _SHIFT, STREAM_NORMALS, hi), (lo, 0))
    flat = _quad_normals(words).reshape(-1)
    return flat[start - 4 * q0:start - 4 * q0 + count]


def estimator_normals(seed: int, points, rows: int, nx: int,
                      stream: int) -> np.ndarray:
    """(len(points), rows, nx) float32: the dW draws of an estimator
    kernel's chain ``stream`` at the given points (rows of tx in the
    launch): draw k, dimensions 4q .. 4q + 3 from counter (k, q, stream,
    seed_hi), key (seed_lo, point)."""
    lo, hi = _split(seed)
    p = np.asarray(points, dtype=np.uint64)[:, None, None]
    k = np.arange(rows, dtype=np.uint64)[None, :, None]
    q = np.arange((nx + 3) // 4, dtype=np.uint64)[None, None, :]
    words = philox4x32_10((k, q, stream, hi), (lo, p))
    words = [np.broadcast_to(w, (len(p), rows, q.shape[-1])) for w in words]
    out = _quad_normals(words).reshape(len(p), rows, -1)
    return np.ascontiguousarray(out[:, :, :nx])


def estimator_times(seed: int, points, rows: int) -> np.ndarray:
    """(len(points), rows, 1) float32: the integral chain's time uniforms u
    at the given points, from word 0 of counter (k, 0, stream 2, seed_hi),
    key (seed_lo, point)."""
    lo, hi = _split(seed)
    p = np.asarray(points, dtype=np.uint64)[:, None]
    k = np.arange(rows, dtype=np.uint64)[None, :]
    w0 = philox4x32_10((k, 0, STREAM_TIME, hi), (lo, p))[0]
    return uniform_from_bits(np.broadcast_to(w0, (len(p), rows)))[..., None]


def path_normals(seed: int, K: int, b: int, nx: int) -> np.ndarray:
    """(K, b, nx) float32: the rollout kernel's increments. xi[k, b, j] is
    normal k % 4 of counter (k / 4, j, stream 4, seed_hi) under key
    (seed_lo, b): Box-Muller of words 0-1 gives steps 4c and 4c + 1, of
    words 2-3 steps 4c + 2 and 4c + 3."""
    lo, hi = _split(seed)
    c = np.arange((K + 3) // 4, dtype=np.uint64)[:, None, None]
    rows = np.arange(b, dtype=np.uint64)[None, :, None]
    j = np.arange(nx, dtype=np.uint64)[None, None, :]
    words = philox4x32_10((c, j, STREAM_PATHS, hi), (lo, rows))
    words = [np.broadcast_to(w, (c.shape[0], b, nx)) for w in words]
    quads = _quad_normals(words)  # (K / 4, b, nx, 4)
    out = quads.transpose(0, 3, 1, 2).reshape(-1, b, nx)
    return np.ascontiguousarray(out[:K])


def probe_units(seed: int, which: str, grid: int, iters: int) -> np.ndarray:
    """(grid, iters, PROBE_BLK, LANES) float32: the units the rate probe
    draws in block g and iteration i, "bits" (uniforms) or "normals". The
    4 units of rows 4w .. 4w + 3 in column c come from counter
    (w * LANES + c, i, stream 5, seed_hi) under key (seed_lo, g)."""
    lo, hi = _split(seed)
    g = np.arange(grid, dtype=np.uint64)[:, None, None, None]
    i = np.arange(iters, dtype=np.uint64)[None, :, None, None]
    w = np.arange(PROBE_BLK // 4, dtype=np.uint64)[None, None, :, None]
    c = np.arange(LANES, dtype=np.uint64)[None, None, None, :]
    words = philox4x32_10((w * _U64(LANES) + c, i, STREAM_PROBE, hi),
                          (lo, g))
    shape = (grid, iters, PROBE_BLK // 4, LANES)
    words = [np.broadcast_to(v, shape) for v in words]
    if which == "bits":
        units = np.stack([uniform_from_bits(v) for v in words], axis=-1)
    elif which == "normals":
        units = _quad_normals(words)
    else:
        raise ValueError(f"unknown probe draw {which!r}")
    # (grid, iters, quad row w, column c, 4) -> rows 4w .. 4w + 3
    return np.ascontiguousarray(
        units.transpose(0, 1, 2, 4, 3).reshape(grid, iters, PROBE_BLK,
                                               LANES))
