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


def _generate_sass(draw_imad: int) -> str:
    """A width-256 merged kernel's SASS: a loop with the products (HGMMA,
    and a MUFU of the epilogues') and a draw loop (one quad: ``draw_imad``
    IMAD, 2 MUFU, 4 FFMA, an LDS)."""
    lines = ["\t\tFunction : _ZN4_GLOBAL_18generate_tc_kernelILi3ELi256EEEvN3dpi2tc6ParamsE"]
    ops = ["HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24", "MUFU.EX2 R3, R2",
           "@!P0 BRA 0x0"]
    ops += ["IMAD.WIDE.U32 R6, R4, 0x3, RZ"] * draw_imad + [
        "MUFU.RSQ R5, R4", "MUFU.RSQ R7, R6", "LDS R8, [R9]"] + [
        "FFMA R10, R8, R5, R10"] * 4
    ops += [f"@P1 BRA 0x{16 * 3:x}", "EXIT", "BRA 0x0"]
    for k, op in enumerate(ops):
        lines.append(f"        /*{16 * k:04x}*/                   {op} ;")
    return "\n".join(lines) + "\n"


def test_generate_draw_mix_reads_the_own_draw_loop():
    """``generate_draw_mix``: the loop without products with the most MUFU,
    its instructions over 4 normals per 2 MUFU (one quad here), by group;
    a loop whose IMAD cannot hold a Philox per quad raises."""
    got = probe_roofline.generate_draw_mix(_generate_sass(14))
    assert got["quads_per_iteration"] == 1
    mix = got["draw_loop"]
    assert mix["all"] == (14 + 2 + 1 + 4 + 1) / 4
    assert (mix["int"], mix["fp32"], mix["sfu"], mix["lds"]) == (
        14 / 4, 4 / 4, 2 / 4, 1 / 4)
    with pytest.raises(RuntimeError, match="not a Philox per quad"):
        probe_roofline.generate_draw_mix(_generate_sass(13))


def _narrow_sass(slab_imad: int, with_terminal: bool = True) -> str:
    """A width-128 merged kernel's SASS: layer 1's K-slab loop (its
    products, their fence and turn, and its variants of a slab: loads;
    shuffles; 8 quads drawn, ``slab_imad`` IMAD, 2 MUFU, 10 FFMA and a
    128-bit store each; those quads each behind a branch), a hidden
    layer's loop
    (products and its epilogue's 16 MUFU.EX2), and the terminal warps'
    loops over a point's draws (quads of 14 IMAD, 2 MUFU and 10 FFMA, and
    their sums' shared-memory updates, LDS and STS): 4 quads with the warp
    sums of 4 draws (20 SHFL), 4 with 2 (10), 8 with 2 (10), 8 with one
    (5), each with a sigmoid (2 MUFU)."""
    lines = ["\t\tFunction : _ZN4_GLOBAL_18generate_tc_kernelILi3ELi128EEEvN3dpi2tc6ParamsE"]
    ops = []

    def loop(body):
        start = len(ops)
        body()
        ops.append(f"@P1 BRA 0x{16 * start:x}")

    def quad(imad, extra):
        ops.extend(["IMAD.WIDE.U32 R6, R4, 0x3, RZ"] * imad
                   + ["MUFU.RSQ R5, R4"] * 2 + ["FFMA R10, R8, R5, R10"] * 10
                   + extra)

    def slab():
        # the variants of a slab, as generate.cu picks them at run time:
        # external noise (loads), antithetic pairs (shuffles), a full slab
        # (8 quads' draws, no branch), the ragged one (each quad behind its
        # own short branch); then the products
        forks, jumps = [], []

        def variant(body, last=False):
            if not last:
                forks.append(len(ops))
                ops.append("@P0 BRA 0x0")
            body()
            jumps.append(len(ops))
            ops.append("BRA 0x0")
            if not last:
                ops[forks[-1]] = f"@P0 BRA 0x{16 * len(ops):x}"

        variant(lambda: ops.extend(["LDG.E.128 R8, [R2]"] * 8
                                   + ["FADD R1, R2, R3"] * 60))
        variant(lambda: [quad(slab_imad, ["STG.E.128 [R2], R8",
                                          "SHFL.BFLY PT, R3, R2, 0x4, 0x1f"])
                         for _ in range(4)])
        variant(lambda: [quad(slab_imad, ["STG.E.128 [R2], R8"])
                         for _ in range(8)])

        def ragged():
            for _ in range(8):
                ops.extend(["ISETP.GE.AND P3, PT, R1, R2, PT",
                            f"@P3 BRA 0x{16 * (len(ops) + 2 + slab_imad + 13):x}"])
                quad(slab_imad, ["STG.E.128 [R2], R8"])
        variant(ragged, last=True)
        for k in jumps:
            ops[k] = f"BRA 0x{16 * len(ops):x}"
        ops.extend(["BAR.SYNC.DEFER_BLOCKING R0, R1", "WARPGROUP.ARRIVE"]
                   + ["HGMMA.64x128x16.F32.BF16 R24, R0, gdesc[UR4], R24"]
                   * 12 + ["WARPGROUP.DEPBAR.LE gsb0, 0x0"])

    def terminal(quads, shfl):
        for _ in range(quads):
            quad(14, ["LDS.128 R8, [R9]", "STS.128 [R9], R8"])
        ops.extend(["SHFL.BFLY PT, R3, R2, 0x1, 0x1f"] * shfl
                   + ["MUFU.EX2 R3, R2", "MUFU.RCP R3, R2"])
    loop(slab)
    loop(lambda: ops.extend(
        ["HGMMA.64x128x16.F32.BF16 R24, R0, gdesc[UR4], R24"] * 24
        + ["MUFU.EX2 R3, R2"] * 16 + ["IMAD R6, R4, 0x3, RZ"] * 4))
    if with_terminal:
        for quads, shfl in ((4, 20), (4, 10), (8, 10), (8, 5)):
            loop(lambda quads=quads, shfl=shfl: terminal(quads, shfl))
    ops += ["EXIT", "BRA 0x0"]
    for k, op in enumerate(ops):
        lines.append(f"        /*{16 * k:04x}*/                   {op} ;")
    return "\n".join(lines) + "\n"


def test_generate_narrow_draw_mix_reads_the_own_loops():
    """``generate_narrow_draw_mix``: the terminal chain's loop at nx (QPL
    quads a lane of D draws a turn: nx = 512 takes two warp sums and 8
    quads; nx = 256 two warp sums and 4 quads, not the loop of 8 that also
    holds two; nx = 100 four warp sums of a quad each) over its normals a
    lane (the loop's static span); layer 1's K-slab loop on the path of
    its full-slab variant (8 quads' draws without branches: not the loads,
    the shuffles, nor the ragged variant's longer path) without its
    products, fence and turn, over 4 normals per 2 MUFU. Without the
    terminal loops, or with too few IMAD a quad in layer 1, it raises."""
    got = probe_roofline.generate_narrow_draw_mix(_narrow_sass(14), 512)
    term, integral = got["terminal"], got["integral"]
    assert (got["terminal_quads"], got["integral_quads"]) == (8, 8)
    per_quad = 14 + 2 + 10
    assert term["all"] == (8 * (per_quad + 2) + 10 + 2 + 1) / 32
    assert (term["shfl"], term["sfu"], term["lds"]) == (10 / 32, 18 / 32,
                                                         8 / 32)
    # the full slab's path: 8 quads, the three variant branches it passes
    # (its own to the ragged variant too), its jump to the products and the
    # loop's own branch
    assert integral["all"] == (8 * (per_quad + 1) + 3 + 1 + 1) / 32
    assert (integral["int"], integral["fp32"], integral["sfu"]) == (
        8 * 14 / 32, 8 * 10 / 32, 16 / 32)
    at_x = probe_roofline.generate_narrow_draw_mix(_narrow_sass(14), 256)
    assert at_x["terminal_quads"] == 4
    assert at_x["terminal"]["shfl"] == 10 / 16
    at_a = probe_roofline.generate_narrow_draw_mix(_narrow_sass(14), 100)
    assert at_a["terminal"]["shfl"] == 20 / 16
    assert probe_roofline.terminal_turn(1000) == (8, 1)
    with pytest.raises(RuntimeError, match="no terminal or layer-1"):
        probe_roofline.generate_narrow_draw_mix(
            _narrow_sass(14, with_terminal=False), 512)
    with pytest.raises(RuntimeError, match="no terminal or layer-1"):
        probe_roofline.generate_narrow_draw_mix(_narrow_sass(13), 512)


def _pis_sass(instance: str, nest_imad: int) -> str:
    """An HJB kernel's SASS: the mixture's set-up loop (an integer
    division: IMAD, MUFU, a store, few FP32), a tile loop with a product
    around the integral chain's draw loop (one quad: 14 IMAD, 2 MUFU, 40
    FP32, a 128-bit store), and the terminal chain's loop over draws
    (``nest_imad`` IMAD, 8 MUFU, 25 SHFL) around its two quad loops (14
    IMAD, 2 MUFU and 60 FP32 with 10 LDS; 14 IMAD, 2 MUFU, 30 FP32 and a
    store)."""
    lines = [f"\t\tFunction : _ZN4_GLOBAL_19{instance}EvN12_GLOBAL__N_16ParamsE"]
    ops = []

    def loop(body):
        start = len(ops)
        body()
        ops.append(f"@P1 BRA 0x{16 * start:x}")

    def quad(fp32, extra):
        ops.extend(["IMAD.WIDE.U32 R6, R4, 0x3, RZ"] * 14
                   + ["MUFU.RSQ R5, R4"] * 2 + ["FFMA R10, R8, R5, R10"] * fp32
                   + extra)

    loop(lambda: ops.extend(["IMAD.HI.U32 R6, R4, R5, RZ"] * 16
                            + ["MUFU.RCP R5, R4"] * 3 + ["STS [R8], R7"]))
    loop(lambda: (ops.append("HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24"),
                  loop(lambda: quad(40, ["STG.E.128 [R2], R8"]))))

    def nest():
        ops.extend(["IMAD R6, R4, 0x3, RZ"] * nest_imad
                   + ["MUFU.EX2 R3, R2"] * 8
                   + ["SHFL.BFLY PT, R3, R2, 0x1, 0x1f"] * 25)
        loop(lambda: quad(60, ["LDS.128 R8, [R9]"] * 10))
        loop(lambda: quad(30, ["ST.E.128 [R2], R8"]))
    loop(nest)
    ops += ["EXIT", "BRA 0x0"]
    for k, op in enumerate(ops):
        lines.append(f"        /*{16 * k:04x}*/                   {op} ;")
    return "\n".join(lines) + "\n"


def test_generate_pis_draw_mix_reads_the_own_loops():
    """``generate_pis_draw_mix``: the integral chain's draw loop is the
    storing quad loop outside the terminal nest (not the set-up loop, nor
    the tile loop with its product), a quad an iteration; the terminal
    chain's per normal is its nest's body plus Q / 32 passes of each quad
    loop (nx = 512: 4) over 16 normals in the wide instance, Q / 4 over 4
    Q / 4 in the narrow one (nx = 100: 6.25); without the nest it
    raises."""
    wide = probe_roofline.GENERATE_PIS_WIDE
    got = probe_roofline.generate_pis_draw_mix(_pis_sass(wide, 20), 512,
                                               wide)
    integral, terminal = got["integral"], got["terminal"]
    assert integral["all"] == (14 + 2 + 40 + 1 + 1) / 4
    assert (integral["int"], integral["fp32"], integral["sfu"]) == (
        14 / 4, 40 / 4, 2 / 4)
    p1, p2 = 14 + 2 + 60 + 10 + 1, 14 + 2 + 30 + 1 + 1
    assert terminal["all"] == (20 + 8 + 25 + 1 + 4 * (p1 + p2)) / 16
    assert terminal["int"] == (20 + 4 * 28) / 16
    assert (terminal["shfl"], terminal["lds"]) == (25 / 16, 40 / 16)
    narrow = probe_roofline.GENERATE_PIS_NARROW
    got = probe_roofline.generate_pis_draw_mix(_pis_sass(narrow, 20), 100,
                                               narrow)
    assert got["terminal"]["int"] == (20 + 6.25 * 28) / 25
    no_nest = _pis_sass(wide, 20).replace("MUFU.RSQ R5, R4",
                                          "FMUL R5, R4, R4")
    with pytest.raises(RuntimeError, match="no integral or terminal"):
        probe_roofline.generate_pis_draw_mix(no_nest, 512, wide)
