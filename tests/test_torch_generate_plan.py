"""The L2 traffic of the merged tensor-core kernel as the Python side
counts it from a launch plan, on the CPU.

``ops/kernels.py:generate_tc_l2_bytes`` counts the bytes one launch moves
through L2 from the plan the built ``csrc/generate.cu`` reports
(``library_tc_plan``); chip_smoke.py prints that count. Also the benches'
hooks that run here: the wrappers' ``lib`` argument on CPU tensors, and
chip_smoke's timing in turns.
"""

import numpy as np
import pytest
import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import kernels

torch.set_num_threads(1)

# path A's plan (nx = 100, 4x128) as generate.cu takes it: the tiles'
# normals in shared memory (drawn by layer 1 into its A fragments, W1's
# columns in quad order: "quad_frags"), a ring of 4 stages, the saved
# derivatives in global scratch
PATH_A_PLAN = {"stages": 4, "save_smem": False, "dw_smem": True,
               "smem_bytes": 189152, "scratch_floats": 2 * 3 * 64 * 128,
               "on_chip": False, "a_staged": False, "stage_bytes": 32768,
               "quad_frags": True}


# path R (nx = 512, 4x128): the tiles' normals (drawn by layer 1, kept for
# the sums) and the saved derivatives in global scratch, a ring of 4
# stages; no row of shared memory for output columns past the consumers'
# registers (they keep every column's sums). Path S (nx = 1024, 4x256): the
# width-256 instance, its layer chain on chip (each warpgroup's tile image,
# 64 KB), a ring of 4 stages of 16 KB; in global scratch the saved
# derivatives of 3 layers and each warpgroup's tile of normals of both
# chains
# (tests/test_torch_highd.py counts their L2 traffic;
# tests/test_torch_gpu.py holds them to the built kernel)
PATH_R_PLAN = {"stages": 4, "save_smem": False, "dw_smem": False,
               "smem_bytes": 151136,
               "scratch_floats": 2 * 3 * 64 * 128 + 2 * 64 * 512,
               "on_chip": False, "a_staged": False, "stage_bytes": 32768,
               "quad_frags": True}
# ... and R's plan before layer 1 drew its normals (the normals drawn to
# scratch, read back by layer 1 and by the sums), whose count the new one
# is held against
PATH_R_PARENT_PLAN = {**PATH_R_PLAN, "quad_frags": False}
PATH_S_PLAN = {"stages": 4, "save_smem": False, "dw_smem": False,
               "smem_bytes": 221840,
               "scratch_floats": 2 * (3 * 64 * 256 + 2 * 64 * 1024),
               "on_chip": True, "a_staged": False, "stage_bytes": 16384,
               "quad_frags": False}
# ... and S's plan under the wide pass before it (the tiles' normals, the
# saved derivatives and two buffers of layer outputs a warpgroup in
# scratch), whose count the new one is held against
PATH_S_WIDE_PLAN = {"stages": 4, "save_smem": False, "dw_smem": False,
                    "smem_bytes": 171648,
                    "scratch_floats": (2 * 3 * 64 * 256 + 2 * 64 * 1024
                                       + 2 * 2 * 128 * 128),
                    "on_chip": False}

# Paths U (4x512, nx 100), V (6x512, nx 256) and W (2x1024, nx 512): the
# wide pass's plan, its producer staging the products' A (the layer
# inputs' bf16 images) beside the weights in stages of 48 KB under bf16x3
# (two k16 chunks of a 256-row weight slab and of both tiles' A, hi and
# lo), 4 of them; in shared memory beside the ring the point's x, the
# tiles' rows, the terminal warps' sums and the barriers (generate.cu:
# gplan_wide); in global scratch each warpgroup's saved derivatives
# (L - 1 layers), two images of layer outputs, its tile's normals and
# layer 1's input image (64 x tc_k1(nx)) (tests/test_torch_gpu.py holds
# them to the built kernel)
def _wide_plan(nx, n_hidden, width, smem):
    return {"stages": 4, "save_smem": False, "dw_smem": False,
            "smem_bytes": smem,
            "scratch_floats": 2 * ((n_hidden + 1) * 64 * width + 64 * nx
                                   + 64 * kernels.tc_k1(nx)),
            "on_chip": False, "a_staged": True, "stage_bytes": 49152,
            "quad_frags": False}


# (nx, hidden layers, width) of paths U, V, W, and the new plan's shared
# memory: 4 stages of 49152 bytes and the rest
WIDTH_PATH_NETS = {"U": (100, 4, 512), "V": (256, 6, 512),
                   "W": (512, 2, 1024)}
PATH_WIDE_PLANS = {
    "U": _wide_plan(100, 4, 512, 4 * 49152 + 6952),
    "V": _wide_plan(256, 6, 512, 4 * 49152 + 11944),
    "W": _wide_plan(512, 2, 1024, 4 * 49152 + 20168)}
# ... and the parent design's plans there (A split from f32 layer outputs
# read back by the consumers, 4 stages): only U's tile of normals fits in
# shared memory; L2 counts 2.10, 3.62 and 3.13 TB a launch under bf16x3
PATH_WIDE_PARENT_PLANS = {
    path: {"stages": 4, "save_smem": False, "dw_smem": path == "U",
           "on_chip": False}
    for path in "UVW"}

# The HJB kernel's plans (csrc/generate_pis.cu, ``library_pis_plan``): path
# H's (nx = 100, the narrow instance, either mode: the tile's normals in
# shared memory, a ring of 4 stages, the terminal sums in shared memory)
# and path T's (nx = 512, the wide instance: the tile's normals read back
# from scratch 4 times, w's mixture term, the terminal sums and the
# terminal warps' three strips through scratch, 56 / 224 registers; 4 ring
# stages under "default", 3 under bf16x3). PATH_T_PIS_EARLIER_PLAN: T's
# plan in the wide instance's earlier layout (the terminal chain 4 lanes a
# draw with its sums in shared memory, the normals read back 5 times, 40 /
# 232 registers; 3 and 2 ring stages), whose count the new one is held
# against (tests/test_torch_highd.py counts their L2 traffic;
# tests/test_torch_gpu.py holds H's and T's to the built kernel)
_PIS_PLAN = {"dw_smem": False, "term_strips": 0, "scratch_strips": 0,
             "term_sums_smem": True, "producer_regs": 40,
             "consumer_regs": 232, "normals_reads": 0,
             "w_term_scratch": False}
PATH_H_PIS_PLAN = {**_PIS_PLAN, "stages": 4, "dw_smem": True,
                   "smem_bytes": 231840,
                   "scratch_floats": 64 * 128 + 4 * 64 * 512}
_T_SCRATCH = 64 * 512 + 4 * 64 * 512
PATH_T_PIS_PLAN = {
    mode: {**_PIS_PLAN, "stages": stages, "smem_bytes": smem,
           "scratch_floats": _T_SCRATCH + (2 * 64 + 3) * 512 + 3 * 513 + 1,
           "scratch_strips": 3, "term_sums_smem": False,
           "producer_regs": 56, "consumer_regs": 224, "normals_reads": 4,
           "w_term_scratch": True}
    for mode, stages, smem in (("default", 4, 231344),
                               ("bf16x3", 3, 223152))}
PATH_T_PIS_EARLIER_PLAN = {
    mode: {**_PIS_PLAN, "stages": stages, "smem_bytes": smem,
           "scratch_floats": _T_SCRATCH + 64 * 512, "normals_reads": 5}
    for mode, stages, smem in (("default", 3, 210880),
                               ("bf16x3", 2, 219072))}


def _plan(save_smem, dw_smem):
    return {**PATH_A_PLAN, "save_smem": save_smem, "dw_smem": dw_smem}


@pytest.mark.parametrize("precision,slab", [("bf16x3", 32768),
                                            ("default", 16384)])
def test_l2_bytes_at_the_main_path(precision, slab):
    """Path A: each ring pass (two warpgroups' tiles, 128 samples) stages
    layer 1's 2 K-slabs and 4 slabs of each of the 3 hidden layers; the
    derivatives of 3 layers are written and read once a tile."""
    v = kernels.generate_tc_l2_bytes(4096, 4096, 100, 4, precision,
                                     PATH_A_PLAN)
    assert v["weights"] == 4096 * 32 * 14 * slab
    assert v["scratch"] == 4096 * 64 * 3 * 64 * 128 * 4 * 2
    assert v["total"] == v["weights"] + v["scratch"]


def test_l2_bytes_count_the_empty_tile_of_an_odd_count():
    """M = 4000: 63 tiles of a point, 32 ring passes (the second
    warpgroup's last tile empty), the same traffic as M = 4096."""
    plan = _plan(False, True)
    assert (kernels.generate_tc_l2_bytes(131, 4000, 7, 4, "bf16x3", plan)
            == kernels.generate_tc_l2_bytes(131, 4096, 7, 4, "bf16x3", plan))
    assert kernels.generate_tc_l2_bytes(8, 64, 100, 0, "bf16x3", plan) == {
        "weights": 0, "scratch": 0, "total": 0}


@pytest.mark.parametrize("save_smem,dw_smem", [(False, False), (True, False),
                                               (False, True), (True, True)])
@pytest.mark.parametrize("n_hidden", [1, 4])
def test_l2_bytes_leave_out_what_the_plan_keeps_on_chip(save_smem, dw_smem,
                                                        n_hidden):
    """nx = 511, one 64-sample point: the scratch traffic holds the saved
    derivatives (written and read once a tile) unless the plan keeps them
    in shared memory, and the tiles' normals (rows of whole quads: written
    once by layer 1, read once by the sums) unless it keeps those there; a
    single hidden layer saves none."""
    v = kernels.generate_tc_l2_bytes(8, 64, 511, n_hidden, "bf16x3",
                                     _plan(save_smem, dw_smem))
    assert v["weights"] == 8 * 1 * (512 // 64 + 4 * (n_hidden - 1)) * 32768
    saves = 0 if save_smem else (n_hidden - 1) * 64 * 128 * 4 * 2
    normals = 0 if dw_smem else 64 * 512 * 4 * 2
    assert v["scratch"] == 8 * 2 * (saves + normals)
    assert v["total"] == v["weights"] + v["scratch"]


@pytest.mark.parametrize("path,total_tb", [("U", 2.10), ("V", 3.62),
                                           ("W", 3.13)])
def test_l2_bytes_of_the_parent_wide_plan_at_the_matrix_paths(path,
                                                              total_tb):
    """B = M = 4096, bf16x3, the design before the staged A: each ring pass
    stages nb = width / 128 column blocks of layer 1's K-slabs and nb x
    width / 64 K-slabs each way of every hidden layer (32 KB each); in
    scratch the layer outputs (f32: written once a layer, read nb times by
    each hidden product), the saved derivatives and, past U, the tiles'
    normals (written once, read by the sums and nb times by layer 1)."""
    nx, n_hidden, width = WIDTH_PATH_NETS[path]
    plan = PATH_WIDE_PARENT_PLANS[path]
    v = kernels.generate_tc_l2_bytes(4096, 4096, nx, n_hidden, "bf16x3",
                                     plan, width)
    nb, tiles, layer = width // 128, 4096 * 64, 64 * width * 4
    slabs = nb * kernels.tc_k1(nx) // 64 + 2 * nb * (width // 64) * (
        n_hidden - 1)
    assert v["weights"] == 4096 * 32 * slabs * 32768
    normals = 0 if plan["dw_smem"] else 64 * nx * 4 * (2 + nb)
    assert v["scratch"] == tiles * (
        (n_hidden - 1) * layer * 2 + normals
        + layer * (2 * n_hidden - 2 + nb * 2 * (n_hidden - 1)))
    assert round(v["total"] / 1e12, 2) == total_tb


@pytest.mark.parametrize("precision,pieces", [("bf16x3", 2),
                                              ("default", 1)])
@pytest.mark.parametrize("path", ["U", "V", "W"])
def test_l2_bytes_of_the_staged_a_plan_at_the_matrix_paths(path, precision,
                                                           pieces):
    """B = M = 4096: the same weight slabs as the parent's plan, and
    beside them each block's A: every product's input image (layer 1's
    tc_k1(nx) columns, then 2 (L - 1) inputs of width columns, a bf16 piece
    a mode's pass reads) staged once for each of the width / 256 column
    blocks and written once; the saved derivatives written and read once a
    tile (f32 in both modes), the tiles' normals written and read once.
    Under bf16x3 the count is 80-82 % of the parent's (the layer inputs
    read half as often), under "default" 43-46 %."""
    nx, n_hidden, width = WIDTH_PATH_NETS[path]
    plan = PATH_WIDE_PLANS[path]
    v = kernels.generate_tc_l2_bytes(4096, 4096, nx, n_hidden, precision,
                                     plan, width)
    nb, tiles = width // 256, 4096 * 64
    ks = kernels.tc_k1(nx) + 2 * (n_hidden - 1) * width
    assert v["weights"] == 4096 * 32 * width * ks * 2 * pieces
    assert v["scratch"] == tiles * (
        64 * ks * 2 * pieces * (nb + 1)
        + (n_hidden - 1) * 64 * width * 4 * 2 + 64 * nx * 4 * 2)
    parent = kernels.generate_tc_l2_bytes(
        4096, 4096, nx, n_hidden, "bf16x3", PATH_WIDE_PARENT_PLANS[path],
        width)["total"]
    if precision == "bf16x3":
        assert 0.79 < v["total"] / parent < 0.83
        assert v["weights"] == kernels.generate_tc_l2_bytes(
            4096, 4096, nx, n_hidden, precision,
            PATH_WIDE_PARENT_PLANS[path], width)["weights"]
    else:
        assert 0.42 < v["total"] / parent < 0.47


@pytest.mark.parametrize("nx,width", [(100, 128), (512, 128), (7, 64),
                                      (513, 64)])
def test_quad_frags_pack_w1_in_quad_order(nx, width):
    """``pack_mlp_tc(quad_frags=True)`` (generate.cu's narrow instances):
    W1's image is the plain one with its columns moved within each k16
    chunk so that thread t's A-fragment columns 2 t, 2 t + 1, 2 t + 8,
    2 t + 9 of chunk c hold input columns 16 c + 4 t .. + 3 (one Philox
    quad); the hidden layers' images and the vectors (the column sums over
    x included) are the plain ones."""
    g = torch.Generator().manual_seed(nx)
    mod = MLP(1 + nx, (width,) * 3, ("ELU",) * 3, 1, generator=g)
    img, vec = kernels.pack_mlp_tc(mod, nx)
    qimg, qvec = kernels.pack_mlp_tc(mod, nx, quad_frags=True)
    k1 = kernels.tc_k1(nx)
    pos = kernels.quad_frag_columns(k1)
    assert sorted(pos.tolist()) == list(range(k1))
    for c in range(k1 // 16):
        for t in range(4):
            cols = [16 * c + 2 * t + e for e in (0, 1, 8, 9)]
            assert pos[16 * c + 4 * t:16 * c + 4 * t + 4].tolist() == cols

    def untile(flat, k):  # the _core_tiles layout of a (width, k) image
        return flat.reshape(width // 8, k // 8, 8, 8).permute(
            0, 2, 1, 3).reshape(width, k)

    n1 = width * k1
    for piece in range(2):
        plain = untile(img[piece * n1:(piece + 1) * n1], k1)
        moved = untile(qimg[piece * n1:(piece + 1) * n1], k1)
        assert torch.equal(moved[:, pos], plain)
    assert torch.equal(qimg[2 * n1:], img[2 * n1:])
    assert torch.equal(qvec, vec)


def test_wrappers_take_another_build_only_on_the_card():
    """The benches' ``lib`` argument: on CPU tensors the wrappers return the
    plain version, whatever library is named."""
    other = kernels.CudaLibrary("generate.cu", lambda lib: None)
    nx, b, m = 5, 3, 24
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    sol = Solution.from_net(MLP(1 + nx, (8,), ("ELU",), 1), "Value", nx)
    rng = np.random.default_rng(0)
    tx = torch.from_numpy(np.concatenate(
        [rng.uniform(0, 0.9, (b, 1)), rng.normal(size=(b, nx))],
        1).astype(np.float32))
    out = kernels.generate_with_gradients_cuda(3, eq, sol, tx, m,
                                               precision="bf16x3", lib=other)
    ref = kernels.generate_with_gradients_plain(3, eq, sol, tx, m,
                                                precision="bf16x3")
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert torch.equal(kernels.normals_cuda(4, (7, 3), "cpu", lib=other),
                       kernels.normals_plain(4, (7, 3)))
    assert other.launches == 0 and other._lib is None


def test_chip_smoke_times_versions_in_turns(monkeypatch):
    """chip_smoke._in_turns: a, b, c, c, b, a, each version's two turns
    averaged."""
    import chip_smoke

    seen, ms = [], iter([1.0, 2.0, 3.0, 5.0, 4.0, 7.0])
    monkeypatch.setattr(chip_smoke, "_time_ms",
                        lambda fn, reps: (seen.append(fn()), next(ms))[1])
    got = chip_smoke._in_turns({"a": lambda: "a", "b": lambda: "b",
                                "c": lambda: "c"}, 3)
    assert seen == ["a", "b", "c", "c", "b", "a"]
    assert got == {"a": 4.0, "b": 3.0, "c": 4.0}


@pytest.mark.parametrize("nx,n_hidden", [(100, 2), (1024, 1)])
def test_chunk_major_images_of_the_width_256_instance(nx, n_hidden):
    """``pack_mlp_tc(chunk_major=True)``: chunk c of a forward image (W1's
    pieces, each hidden W's) is the 8 KB block of W's input columns 16 c ..
    in 8 x 8 cores (core (i, j) at (2 i + j) * 64); each hidden W's pieces
    follow in core order; the vectors are the default packing's."""
    g = torch.Generator().manual_seed(nx)
    mod = MLP(1 + nx, (256,) * n_hidden, ("ELU",) * n_hidden, 1, generator=g)
    img, vec = kernels.pack_mlp_tc(mod, nx, chunk_major=True)
    core, vec0 = kernels.pack_mlp_tc(mod, nx)
    assert torch.equal(vec, vec0)
    k1 = kernels.tc_k1(nx)

    def chunk(flat, k, c):  # chunk c as the (256, 16) block of W
        return flat[c * 4096:(c + 1) * 4096].reshape(32, 2, 8, 8) \
            .permute(0, 2, 1, 3).reshape(256, 16)

    def untile(flat, k):  # the default core layout, (256, k)
        return flat.reshape(32, k // 8, 8, 8).permute(0, 2, 1, 3) \
            .reshape(256, k)

    o = 0
    for im in range(2):  # W1's hi and lo
        w = untile(core[im * 256 * k1:(im + 1) * 256 * k1], k1)
        mine = img[o:o + 256 * k1]
        for c in (0, 1, k1 // 16 - 1):
            assert torch.equal(chunk(mine, k1, c), w[:, 16 * c:16 * c + 16])
        o += 256 * k1
    base = 2 * 256 * k1
    for layer in range(n_hidden - 1):
        for im in range(2):
            w = untile(core[base + (2 * layer + im) * 65536:
                            base + (2 * layer + im + 1) * 65536], 256)
            assert torch.equal(chunk(img[o:o + 65536], 256, 5),
                               w[:, 80:96])
            o += 65536
        for im in range(2):
            assert torch.equal(img[o:o + 65536],
                               core[base + (2 * layer + im) * 65536:
                                    base + (2 * layer + im + 1) * 65536])
            o += 65536
    assert o == img.numel()
