"""The rate probe's plain version (``ops/kernels.py:probe_plain``).

The probe kernel (``csrc/probe.cu``) and its plain version sum the same
units: the host Philox draws of ``ops/philox.py`` (bits, normals) or the
ELU chain on its normals. Here the plain version is held against a numpy
computation on those draws, and its ELU against the JAX probe's formula
(``scripts/probe_vpu_roofline.py:_probe_kernel``) on the same x0: rtol =
atol = 1e-5 (f32 sums of 32 x iters units in another order). The kernel
itself is held against the plain version on the card
(``tests/test_torch_gpu.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_torch.ops import kernels, philox
from deeppicarditeration_torch.utils import probe_roofline

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
SEED, GRID, ITERS = (7 << 32) | 5, 3, 4


def _partials(z):
    """(grid, 256, 128) units of one iteration -> (grid, 8, 128) sums of
    rows 32r .. 32r + 31."""
    return z.reshape(z.shape[0], 8, 32, 128).astype(np.float64).sum(axis=2)


@pytest.mark.parametrize("which", ["bits", "normals"])
def test_plain_probe_sums_the_host_philox_draws(which):
    units = philox.probe_units(SEED, which, GRID, ITERS)
    assert units.shape == (GRID, ITERS, 256, 128)
    want = sum(_partials(units[:, i]) for i in range(ITERS))
    got = kernels.probe_plain(which, SEED, GRID, ITERS)
    assert got.shape == (GRID * 8, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.reshape(GRID * 8, 128),
                               **TOL)
    if which == "bits":
        assert ((units > 0) & (units <= 1)).all()
    # CPU tensors take the plain version; the kernel's grid is explicit
    assert torch.equal(kernels.probe_cuda(which, SEED, ITERS, "cpu", GRID),
                       got)


def test_plain_probe_elu_chain_matches_the_jax_probes_formula():
    x0 = philox.probe_units(SEED, "normals", GRID, 1)[:, 0]
    acc = np.zeros((GRID, 8, 128), np.float32)
    for _ in range(ITERS):
        x = jnp.asarray(x0.reshape(GRID, 8, 32, 128)) \
            + jnp.asarray(acc)[:, :, None, :] * 1e-30
        y = jnp.where(x > 0, x, jnp.exp(x) - 1.0)
        ge = jnp.where(x > 0, 1.0, y + 1.0)
        acc = acc + np.asarray(jnp.sum(y * ge, axis=2))
    got = kernels.probe_plain("elu", SEED, GRID, ITERS)
    np.testing.assert_allclose(got.numpy(), acc.reshape(GRID * 8, 128),
                               **TOL)


def test_probe_units_layout():
    """Rows 4w .. 4w + 3 of column c in block g, iteration i: the 4 words
    of counter (w * 128 + c, i, stream 5, seed_hi) under key (seed_lo, g)."""
    u = philox.probe_units(SEED, "bits", 2, 3)
    n = philox.probe_units(SEED, "normals", 2, 3)
    g, i, w, c = 1, 2, 17, 5
    words = philox.philox4x32_10((w * 128 + c, i, philox.STREAM_PROBE, 7),
                                 (5, g))
    np.testing.assert_array_equal(u[g, i, 4 * w:4 * w + 4, c],
                                  philox.uniform_from_bits(
                                      np.array(words, np.uint32)))
    n0, n1 = philox.box_muller(words[0], words[1])
    np.testing.assert_array_equal(n[g, i, 4 * w:4 * w + 2, c],
                                  np.float32([n0, n1]))
    # a block's draws do not depend on the grid
    np.testing.assert_array_equal(philox.probe_units(SEED, "bits", 1, 3),
                                  u[:1])


def test_probe_entry_point_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        probe_roofline.probe("normals", device="cpu")
    with pytest.raises(ValueError):
        kernels.probe_plain("tanh", SEED, 1, 1)
    assert probe_roofline.units_per_call(264, 1024) == 264 * 256 * 128 * 1024


_SASS = """\
\t\tFunction : _ZN4_GLOBAL_12probe_kernelILi2EEEvPfijj
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/                   MOV R2, RZ ;
        /*0020*/                   MUFU.EX2 R3, R2 ;
        /*0030*/                   FFMA R4, R3, R3, R2 ;
        /*0040*/                   IMAD.WIDE.U32 R6, R4, 0x3, RZ ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
\t\tFunction : _ZN4_GLOBAL_12probe_kernelILi0EEEvPfijj
        /*0000*/                   LOP3.LUT R1, R2, R3, R4, 0x96, !PT ;
        /*0010*/                   LOP3.LUT R1, R2, R3, R4, 0x96, !PT ;
        /*0020*/               @P6 BRA 0x10 ;
        /*0030*/                   BRA 0x30;
"""


def test_loop_opcodes_counts_the_iteration_loop_of_each_mode():
    """The loop is the longest backward branch of the mode's kernel; the
    trailing self-branch and the code around the loop do not count."""
    elu = probe_roofline.loop_opcodes(_SASS, "elu")
    assert elu == {"MUFU": 1, "FFMA": 1, "IMAD": 1, "BRA": 1}
    assert probe_roofline.loop_opcodes(_SASS, "bits") == {"LOP3": 1,
                                                           "BRA": 1}
    with pytest.raises(RuntimeError, match="no probe kernel"):
        probe_roofline.loop_opcodes(_SASS, "normals")
