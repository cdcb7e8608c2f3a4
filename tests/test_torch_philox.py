"""The host Philox reference (``ops/philox.py``) of the CUDA kernels' draws.

It is what the kernels' in-kernel normals are held against value for value
on the card, so here it is held against Random123's published known-answer
vectors for Philox4x32-10, and its counter layouts against one another.
"""

import numpy as np
import pytest

from deeppicarditeration_torch.ops import philox

# Random123 kat_vectors: philox4x32 10, counter, key -> output
KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_matches_the_known_answer_vectors(ctr, key, want):
    got = philox.philox4x32_10(ctr, key)
    assert [int(v) for v in got] == list(want)
    # vectorised: the same answer in every lane of a batch
    batch = philox.philox4x32_10([np.full(5, c, np.uint32) for c in ctr],
                                 key)
    assert all((w == v).all() for w, v in zip(batch, want))


def test_uniforms_lie_in_the_half_open_unit_interval():
    u = philox.uniform_from_bits(
        np.array([0, 0x1FF, 0x200, 0xFFFFFFFF], np.uint32))
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, np.float32([1.0, 1.0, 1 - 2 ** -23,
                                                 2 ** -23]))


def test_normals_flat_depends_on_seed_and_index_alone():
    seed = (7 << 32) | 5
    whole = philox.normals_flat(seed, 0, 4099)
    assert whole.dtype == np.float32 and whole.shape == (4099,)
    for start, count in ((0, 1), (3, 10), (1001, 3), (4090, 9)):
        np.testing.assert_array_equal(
            philox.normals_flat(seed, start, count),
            whole[start:start + count])
    assert not np.array_equal(philox.normals_flat(seed + 1, 0, 64),
                              whole[:64])
    # the high word of the seed is a counter word
    assert not np.array_equal(philox.normals_flat(5, 0, 64), whole[:64])
    # index i is quad i // 4: Box-Muller of its Philox words
    c = 1001 // 4
    words = philox.philox4x32_10((c, 0, philox.STREAM_NORMALS, 7), (5, 0))
    n0, n1 = philox.box_muller(words[0], words[1])
    n2, n3 = philox.box_muller(words[2], words[3])
    np.testing.assert_array_equal(whole[4 * c:4 * c + 4],
                                  np.float32([n0, n1, n2, n3]))


def test_estimator_layout_points_streams_and_times():
    seed, rows, nx = 2 ** 40 + 3, 6, 10
    pts = [0, 1, 4095]
    d0 = philox.estimator_normals(seed, pts, rows, nx,
                                  philox.STREAM_TERMINAL)
    d1 = philox.estimator_normals(seed, pts, rows, nx,
                                  philox.STREAM_INTEGRAL)
    assert d0.shape == (3, rows, nx) and d0.dtype == np.float32
    assert not np.array_equal(d0, d1)
    # a point's draws do not depend on the other points asked for
    np.testing.assert_array_equal(
        philox.estimator_normals(seed, [4095], rows, nx, 0)[0], d0[2])
    # draw k, dimensions 4q .. 4q + 3: counter (k, q, stream, seed_hi),
    # key (seed_lo, point); nx = 10 uses half of the last quad
    k, q, p = 4, 2, 4095
    words = philox.philox4x32_10((k, q, 0, seed >> 32), (3, p))
    n0, n1 = philox.box_muller(words[0], words[1])
    np.testing.assert_array_equal(d0[2, k, 8:10], np.float32([n0, n1]))
    u = philox.estimator_times(seed, pts, rows)
    assert u.shape == (3, rows, 1) and u.dtype == np.float32
    assert ((u > 0) & (u <= 1)).all()
    w = philox.philox4x32_10((k, 0, philox.STREAM_TIME, seed >> 32),
                             (3, p))[0]
    assert u[2, k, 0] == philox.uniform_from_bits(w)


def test_box_muller_normals_have_standard_moments():
    x = philox.normals_flat(11, 0, 2 ** 20).astype(np.float64)
    se = 2.0 ** -10
    assert abs(x.mean()) < 5 * se
    assert abs((x * x).mean() - 1.0) < 5 * np.sqrt(2.0) * se
    assert abs((x ** 4).mean() - 3.0) < 5 * np.sqrt(96.0) * se
    for lag in range(1, 9):
        assert abs((x[lag:] * x[:-lag]).mean()) < 5 * se, lag


def test_path_normals_layout_and_shape_independence():
    """The rollout kernel's xi[k, b, j]: normal k % 4 of counter (k / 4, j,
    stream 4, seed_hi) under key (seed_lo, b), a function of (seed, k, b,
    j) alone, so any (K, B, nx) is a corner of a larger draw."""
    seed, K, b, nx = (7 << 32) | 5, 10, 6, 9
    xi = philox.path_normals(seed, K, b, nx)
    assert xi.shape == (K, b, nx) and xi.dtype == np.float32
    np.testing.assert_array_equal(philox.path_normals(seed, 3, 2, 4),
                                  xi[:3, :2, :4])
    k, row, j = 6, 4, 7  # quad 1, words 2-3
    words = philox.philox4x32_10((k // 4, j, philox.STREAM_PATHS, 7),
                                 (5, row))
    n2, n3 = philox.box_muller(words[2], words[3])
    np.testing.assert_array_equal(xi[6:8, row, j], np.float32([n2, n3]))
    assert not np.array_equal(philox.path_normals(seed + 1, K, b, nx), xi)
    # its own stream: not the estimator kernels' stream 0-3 draws
    assert philox.STREAM_PATHS not in (philox.STREAM_TERMINAL,
                                       philox.STREAM_INTEGRAL,
                                       philox.STREAM_TIME,
                                       philox.STREAM_NORMALS)
    big = philox.path_normals(11, 64, 64, 64).astype(np.float64)
    se = big.size ** -0.5
    assert abs(big.mean()) < 5 * se
    assert abs((big * big).mean() - 1.0) < 5 * np.sqrt(2.0) * se
