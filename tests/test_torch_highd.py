"""High dimension: the merged estimator kernels' cover at the JAX package's
d = 512 and d = 1024 records, against the JAX package, on the CPU.

* The plain merged estimator with a 2x256 ELU MLP (the widths
  ``csrc/generate.cu`` now covers), carried across by ``models/convert.py``,
  against ``generate_with_gradients_pallas`` in interpret mode on the same
  external noise, with and without antithetic pairing: rtol = atol = 1e-5
  (b = m = 16 and nx = 8 keep the f32 sums short).
* The plain PIS estimator above the PIS kernel's old nx cap (nx = 136: the
  wide instance, whose head and x columns of N_0^T are 512 rows) with a
  2x512 PISGradNet against the JAX kernel, in bf16x3 and highest as
  tests/test_torch_hjb.py compares them, at its tolerance (rtol 5e-5, atol
  1e-5 of the largest magnitude). Not "default": there an f32 value an ulp
  apart on the two sides rounds to another bf16, and targets of ~1e4 move
  by ~1 % (measured: 0.6 % at nx = 136).
* ``merged_covers`` and ``generation_route`` decide the route from the
  structure alone; the fault this slice repairs: at the old limits (nx <=
  511) "auto" took the merged kernel at nx = 512, which then raised at the
  launch.
* The OU mixture at nx = 512 bit for bit, and paths R, S, T's recipes as
  both packages load them.
The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.config import load_cfg as jax_load_cfg
from deeppicarditeration_tpu.equations import make_equation as jax_make_eq
from deeppicarditeration_tpu.models.networks import MLP as JaxMLP
from deeppicarditeration_tpu.models.networks import (
    PISGradNet as JaxPISGradNet,
)
from deeppicarditeration_tpu.models.solution import Solution as JaxSolution
from deeppicarditeration_tpu.ops.pallas_kernels import (
    generate_with_gradients_pallas,
)
from deeppicarditeration_tpu.utils.static_fn import StaticFn
from deeppicarditeration_torch.config import load_cfg
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.convert import (
    mlp_state_dict_from_flax,
    pisgradnet_state_dict_from_flax,
)
from deeppicarditeration_torch.models.networks import MLP, PISGradNet
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels
from tests.test_torch_generate_plan import (
    PATH_H_PIS_PLAN,
    PATH_R_PARENT_PLAN,
    PATH_R_PLAN,
    PATH_S_PLAN,
    PATH_S_WIDE_PLAN,
    PATH_T_PIS_EARLIER_PLAN,
    PATH_T_PIS_PLAN,
)

torch.set_num_threads(1)

T_ = torch.from_numpy


def _inputs(seed, b, rows, nx):
    rng = np.random.default_rng(seed)
    t = (rng.uniform(size=(b, 1)) * 0.8).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * np.sqrt(t)).astype(np.float32)
    return (np.concatenate([t, x], axis=1),
            rng.uniform(size=(b, rows, 1)).astype(np.float32),
            rng.normal(size=(b, rows, nx)).astype(np.float32),
            rng.normal(size=(b, rows, nx)).astype(np.float32))


def _mlp_pair(nx, neurons, seed=0):
    jmod = JaxMLP(neurons=neurons, activations=("ELU",) * len(neurons),
                  out_dim=1)
    params = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, 1 + nx)))
    tmod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1)
    tmod.load_state_dict(mlp_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return (JaxSolution.from_net(jmod, params, "Value", nx),
            Solution.from_net(tmod, "Value", nx))


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernel at the new widths and nx
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("antithetic", [False, True])
def test_plain_merged_matches_jax_kernel_with_a_width_256_net(antithetic):
    nx, b, m = 8, 16, 16
    rows = m // 2 if antithetic else m
    jeq = jax_make_eq("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    teq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    jsol, tsol = _mlp_pair(nx, (256, 256))
    assert kernels.merged_covers(teq, tsol, "bf16x3") is None
    tx, u01, nt, ni = _inputs(7, b, rows, nx)
    ref = generate_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
        antithetic=antithetic, u01=jnp.asarray(u01),
        noise_t=jnp.asarray(nt), noise_i=jnp.asarray(ni))
    out = kernels.generate_with_gradients_plain(
        0, teq, tsol, T_(tx), m, T_(u01), T_(nt), T_(ni),
        antithetic=antithetic, chunk_rows=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("precision", ["bf16x3", "highest"])
def test_plain_pis_matches_jax_kernel_above_the_old_cap(precision):
    nx, b, m, hidden = 136, 8, 8, (512, 512)
    jeq = jax_make_eq("OUProcessEquation", nx=nx, num_components=3, seed=5)
    teq = make_equation("OUProcessEquation", nx=nx, num_components=3,
                        seed=5)
    jmod = JaxPISGradNet(hidden_shapes=hidden, dim=nx,
                         g0=StaticFn(jeq.g, ("g", id(jeq))), T=jeq.T)
    params = jmod.init(jax.random.PRNGKey(1), jnp.zeros((1, 1 + nx)))
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), params)
    tmod = PISGradNet(nx, hidden, (teq.gmm_means, teq.gmm_vars,
                                   teq.gmm_log_weights), T=teq.T)
    tmod.load_state_dict(pisgradnet_state_dict_from_flax(params))
    jsol = JaxSolution.from_net(jmod, params, "Value", nx)
    tsol = Solution.from_net(tmod, "Value", nx)
    assert nx > kernels.PIS_NARROW_NX
    assert kernels.pis_covers(teq, tsol, "bf16x3", False) is None
    tx, u01, nt, ni = _inputs(3, b, m, nx)
    ref = np.asarray(generate_with_gradients_pallas(
        0, jeq, jsol, jnp.asarray(tx), m, tile_b=8, mblk=8,
        u01=jnp.asarray(u01), noise_t=jnp.asarray(nt),
        noise_i=jnp.asarray(ni), mxu_precision=precision))
    out = kernels.generate_with_gradients_plain(
        0, teq, tsol, T_(tx), m, T_(u01), T_(nt), T_(ni),
        precision=precision)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-5,
                               atol=1e-5 * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# the cover and the route, from the structure alone
# ---------------------------------------------------------------------------

def _cha(nx, neurons):
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    if not neurons:
        return eq, Solution.zero(nx)
    mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1)
    return eq, Solution.from_net(mod, "Value", nx)


def _gen(precision="bf16x3", mode="auto", m=64):
    return est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                         pallas_generate=mode, pallas_precision=precision)


@pytest.mark.parametrize("nx", [512, 1024])
@pytest.mark.parametrize("neurons", [(128,) * 4, (256,) * 4])
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
def test_auto_takes_the_merged_kernel_at_the_records(nx, neurons, precision,
                                                     capsys, monkeypatch):
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    eq, sol = _cha(nx, neurons)
    assert kernels.merged_covers(eq, sol, precision) is None
    assert est.generation_route(eq, sol, _gen(precision)) == est.MERGED
    assert "split estimators" not in capsys.readouterr().out


@pytest.mark.parametrize("nx,neurons,precision,why", [
    (1025, (128,) * 4, "bf16x3", "nx=1025 exceeds its 1024"),
    (2048, (256,) * 2, "default", "nx=2048 exceeds its 1024"),
    (100, (192,) * 4, "bf16x3", "all of width 64, 128, 256, 384"),
    (100, (256, 128), "bf16x3", "all of width 64, 128, 256, 384"),
    (100, (256,) * 4, "highest", "all of width 128,"),
    (512, (128,) * 4, "highest", "nx=512 exceeds its 511"),
])
def test_auto_splits_with_one_notice_where_the_kernel_does_not_cover(
        nx, neurons, precision, why, capsys, monkeypatch):
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    eq, sol = _cha(nx, neurons)
    reason = kernels.merged_covers(eq, sol, precision)
    assert reason is not None and why in reason
    for _ in range(2):
        assert est.generation_route(eq, sol, _gen(precision)) == est.SPLIT
    out = capsys.readouterr().out
    assert out.count("using the split estimators") == 1 and why in out


def test_forced_merged_raises_before_any_launch_without_a_device():
    """A forced PALLAS_GENERATE: true keeps the merged route; its wrapper
    raises NotImplementedError with merged_covers' reason off the CPU
    before it loads the library or checks the device (a tensor on the
    meta device: no memory, no card)."""
    eq, sol = _cha(1025, (128,) * 2)
    gen = _gen(mode=True)
    assert est.generation_route(eq, sol, gen) == est.MERGED
    tx = torch.empty((4, 1026), device="meta")
    launches = kernels.GENERATE.launches
    with pytest.raises(NotImplementedError, match="exceeds its 1024"):
        est.generate_with_gradients(0, eq, sol, tx, gen)
    with pytest.raises(NotImplementedError, match="exceeds its 511"):
        kernels.generate_with_gradients_cuda(
            0, *_cha(512, (128,))[:2], torch.empty((4, 513), device="meta"),
            64, precision="highest")
    assert kernels.GENERATE.launches == launches and kernels.GENERATE._lib \
        is None
    # a covered case reaches the device check instead
    eq, sol = _cha(1024, (256,) * 2)
    with pytest.raises(ValueError, match="unsupported device meta"):
        kernels.generate_with_gradients_cuda(
            0, eq, sol, torch.empty((4, 1025), device="meta"), 64,
            precision="bf16x3")


@pytest.mark.parametrize("limits", ["parent", "this tree"])
def test_auto_never_routes_to_a_merged_kernel_that_cannot_launch(
        limits, monkeypatch):
    """The fault this slice repairs: "auto" decided on the net's width
    alone, so at nx = 512 with the w1.0 recipe's 4x128 net it took the
    merged kernel, which then raised at the launch (nx > 511). With the
    parent's limits (nx <= 511, width 128) the route at nx = 512 must be
    SPLIT; with this tree's it is MERGED, and covered."""
    if limits == "parent":
        monkeypatch.setattr(kernels, "GENERATE_TC_MAX_NX", 511)
        monkeypatch.setattr(kernels, "GENERATE_TC_WIDTHS", (128,))
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    for nx in (511, 512, 1024, 1025):
        for neurons in ((128,) * 4, (256,) * 4):
            eq, sol = _cha(nx, neurons)
            covered = kernels.merged_covers(eq, sol, "bf16x3") is None
            route = est.generation_route(eq, sol, _gen())
            assert route == (est.MERGED if covered else est.SPLIT)
            assert covered == (nx <= kernels.GENERATE_TC_MAX_NX
                               and neurons[0] in kernels.GENERATE_TC_WIDTHS)
    eq, sol = _cha(512, (128,) * 4)
    assert (est.generation_route(eq, sol, _gen()) == est.MERGED) == (
        limits == "this tree")


@pytest.mark.parametrize("nx,want", [(512, est.MERGED), (513, est.SPLIT)])
def test_hjb_route_at_the_pis_cap(nx, want, monkeypatch):
    monkeypatch.setattr(est, "_FALLBACK_NOTICED", set())
    eq = make_equation("OUProcessEquation", nx=nx, num_components=5)
    mod = PISGradNet(nx, (512,) * 4, (eq.gmm_means, eq.gmm_vars,
                                      eq.gmm_log_weights))
    sol = Solution.from_net(mod, "Value", nx)
    assert est.generation_route(eq, sol, _gen("default")) == want
    assert kernels.merged_covers(eq, sol, "default") is not None


# ---------------------------------------------------------------------------
# the launch plans' L2 counts at paths R's and S's shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision,slab", [("bf16x3", 32768),
                                            ("default", 16384)])
def test_l2_bytes_at_path_r(precision, slab):
    """R: a ring pass (two tiles of 64) stages layer 1's 9 K-slabs (K =
    576) and 4 of each of the 3 hidden layers; the derivatives of 3 layers
    written and read, the normals written once (by layer 1, which draws
    them) and read once (by the sums), a tile."""
    b, m, nx = 4096, 16384, 512
    v = kernels.generate_tc_l2_bytes(b, m, nx, 4, precision, PATH_R_PLAN)
    passes = m // 128
    assert v["weights"] == b * passes * (9 + 12) * slab
    tiles = b * passes * 2
    assert v["scratch"] == tiles * (3 * 64 * 128 * 4 * 2 + 64 * nx * 4 * 2)
    assert v["total"] == v["weights"] + v["scratch"]


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
def test_l2_bytes_of_a_path_r_call_against_the_parent_plan(precision):
    """One generation call at R's shape (B = 4096, M = 16384): the new
    plan's scratch (0.48 TB: the normals written and read once, the
    derivatives) against the plan before it (0.62 TB: the normals read back
    by layer 1 as well); the weight slabs alike."""
    b, m, nx = 4096, 16384, 512
    v = kernels.generate_tc_l2_bytes(b, m, nx, 4, precision, PATH_R_PLAN)
    old = kernels.generate_tc_l2_bytes(b, m, nx, 4, precision,
                                       PATH_R_PARENT_PLAN)
    assert v["weights"] == old["weights"]
    assert v["scratch"] == 481_036_337_152
    assert old["scratch"] == 618_475_290_624
    assert old["scratch"] - v["scratch"] == 4096 * 256 * 64 * nx * 4


@pytest.mark.parametrize("precision,slab", [("bf16x3", 32768),
                                            ("default", 16384)])
def test_l2_bytes_at_path_s(precision, slab):
    """S (width 256, the layer chain on chip): a pass stages layer 1's 65
    k16 chunks (1 + nx = 1025 columns) once and 16 chunks of each hidden
    layer forward and backward, each chunk all 256 rows (half a 128-row
    K-slab's bytes); the scratch is the derivatives of 3 layers and the
    tile's normals of both chains, each written and read once a tile."""
    b, m, nx = 8192, 32768, 1024
    v = kernels.generate_tc_l2_bytes(b, m, nx, 4, precision, PATH_S_PLAN,
                                     256)
    passes = m // 128
    assert v["weights"] == b * passes * (65 + 2 * 16 * 3) * slab // 2
    tiles = b * passes * 2
    layer = 64 * 256 * 4
    assert v["scratch"] == tiles * (3 * layer + 2 * 64 * nx * 4) * 2
    assert {w: kernels.TC_SAVE_LAYER_FLOATS[w] for w in (128, 256)} == {
        128: 64 * 128, 256: 64 * 256}


@pytest.mark.parametrize("precision,weights,scratch", [
    ("bf16x3", 2_765_958_938_624, 3_023_656_976_384),
    ("default", 1_382_979_469_312, 3_023_656_976_384)])
def test_l2_bytes_of_a_path_s_call_against_the_wide_plan(precision, weights,
                                                         scratch):
    """One generation call at S's shape (B = 4096, M = 32768): the
    width-256 plan's counted bytes, and the wide pass's before it (8.32 TB
    under bf16x3, 5.50 TB of it scratch: the tiles' normals read four
    times, the layer outputs, the derivatives), whose layer outputs it
    keeps on chip and whose normals it reads once."""
    b, m, nx = 4096, 32768, 1024
    v = kernels.generate_tc_l2_bytes(b, m, nx, 4, precision, PATH_S_PLAN,
                                     256)
    assert (v["weights"], v["scratch"]) == (weights, scratch)
    old = kernels.generate_tc_l2_bytes(b, m, nx, 4, precision,
                                       PATH_S_WIDE_PLAN, 256)
    assert old["scratch"] == 5_497_558_138_880
    assert old["weights"] == (2_817_498_546_176 if precision == "bf16x3"
                              else 1_408_749_273_088)
    assert v["total"] < 0.7 * old["total"]


def _pis_stage_bytes(nx, precision):
    """The bytes generate_pis.cu's producer copies for one tile, layer by
    layer from pis_layer_shapes: the gate's and the encoder's 64 rows of
    each k16 slab (4 slabs a stage; hi and lo), a 512-row layer's slabs
    whole (two a stage under "default", a last stage of an odd count
    whole; hi and lo in a stage each under bf16x3), a 128-row head's 4
    slabs a stage ("default") or 2 (bf16x3), hi and lo."""
    x3 = precision == "bf16x3"
    total = 0
    for i, (n, k) in enumerate(kernels.pis_layer_shapes(4, nx)):
        rows, slabs = (64 if i <= 6 else n), k // 16
        per = (1 if x3 else 2) if rows == 512 else (2 if x3 and rows == 128
                                                    else 4)
        stages = 2 * slabs if x3 and rows == 512 else -(-slabs // per)
        total += stages * (1 if x3 and rows == 512 else per) * rows * 32 * (
            2 if x3 and rows != 512 else 1)
    return total


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
def test_pis_l2_bytes_at_path_h(precision):
    """H (nx = 100, B = M = 4096): a tile's weight stages, the head's
    output and 4 layers' ELU' written and read, the normals and the
    terminal sums on chip; 3.81 MB of weights a tile under "default"."""
    b, m, nx = 4096, 4096, 100
    v = kernels.generate_pis_l2_bytes(b, m, nx, 4, precision,
                                      PATH_H_PIS_PLAN)
    tiles = b * m // 64
    assert v["weights"] == tiles * _pis_stage_bytes(nx, precision)
    assert v["weights"] == {"default": 998_579_896_320,
                            "bf16x3": 1_979_979_923_456}[precision]
    assert v["scratch"] == tiles * (64 * 128 + 4 * 64 * 512) * 4 * 2
    assert v["total"] == v["weights"] + v["scratch"]


@pytest.mark.parametrize("precision,weights", [
    ("default", 5_643_587_026_944), ("bf16x3", 11_287_174_053_888)])
def test_pis_l2_bytes_at_path_t(precision, weights):
    """T (nx = 512, B = M = 8192), one tile of 64 samples a ring pass: 5.38
    MB of weights a tile under "default", twice under bf16x3, in both
    layouts; the scratch of the earlier one (the normals written once and
    read 5 times) and of the new one (read 4 times, w's mixture term
    written and read, the terminal sums of each point written and read,
    each draw's terminal strip read and written; ELU'(z) in f32 in both,
    as the JAX reference keeps it)."""
    b, m, nx = 8192, 8192, 512
    tiles = b * m // 64
    tile = 64 * nx * 4
    net = (64 * 512 + 4 * 64 * 512) * 4 * 2
    old = kernels.generate_pis_l2_bytes(b, m, nx, 4, precision,
                                        PATH_T_PIS_EARLIER_PLAN[precision])
    new = kernels.generate_pis_l2_bytes(b, m, nx, 4, precision,
                                        PATH_T_PIS_PLAN[precision])
    assert old["weights"] == new["weights"] == weights
    assert weights == tiles * _pis_stage_bytes(nx, precision)
    assert old["scratch"] == tiles * (net + 6 * tile) == 2_199_023_255_552
    assert new["scratch"] == (tiles * (net + 7 * tile) + b * 3 * 513 * 8
                              + b * m * nx * 4 * 2)
    assert new["total"] == new["weights"] + new["scratch"]


@pytest.mark.parametrize("precision,bound_ms", [("default", 365.22),
                                              ("bf16x3", 1095.65)])
def test_pis_work_with_the_kernels_own_loops(precision, bound_ms):
    """chip_smoke's work model of a generate_pis call at T's shape: its
    TENSOR bound (365.22 ms "default", three passes under bf16x3); given
    the kernel's own loops (``own``: per normal, holding the terminal
    chain's per-dimension work and the integral chain's X_s and
    responsibilities), counts equal to the terminal kernel's draw plus
    the terms they hold give the same work, and larger ones more."""
    import chip_smoke

    b, m, nx, hidden, ncomp, n_w = 8192, 8192, 512, (512,) * 4, 5, 10 ** 6
    work = chip_smoke._pis_work(b, m, nx, hidden, ncomp, n_w, precision)
    ms, by, pipe = chip_smoke._bound(work)
    assert (by, pipe) == ("operations", "TENSOR")
    assert ms == pytest.approx(bound_ms, abs=0.01)
    fp32, i32, sfu, other = chip_smoke.PER_NORMAL
    own = {"terminal": (fp32 + 4 + 3 * ncomp, i32, sfu + ncomp, other),
           "integral": (fp32 + 2 + 3 * ncomp, i32, sfu + ncomp, other)}
    same = chip_smoke._pis_work(b, m, nx, hidden, ncomp, n_w, precision, own)
    assert same == pytest.approx(work)
    more = {k: (v[0] + 8, *v[1:]) for k, v in own.items()}
    bigger = chip_smoke._pis_work(b, m, nx, hidden, ncomp, n_w, precision,
                                  more)
    assert bigger[0] == pytest.approx(work[0] + 2 * 8 * b * m * nx)
    assert bigger[1:] == pytest.approx(work[1:])


@pytest.mark.parametrize("precision,bound_ms", [("bf16x3", 86.58),
                                              ("default", 85.04)])
def test_merged_work_with_the_kernels_own_loops(precision, bound_ms):
    """chip_smoke's work model of a merged call at R's shape (B = 4096, M =
    16384, nx = 512, 4x128): its ISSUE bound (86.58 ms bf16x3, the tensor
    pipe's 66.76 under it); given the width-128 instance's own draw loops
    (``own``: per normal, the terminal warps' loop and layer 1's draws),
    counts equal to the terminal kernel's draw give the same work, and
    larger ones on a chain add that chain's normals' worth."""
    import chip_smoke

    b, m, nx, neurons = 4096, 16384, 512, (128,) * 4
    n_w = 513 * 128 + 128 + 3 * (128 * 128 + 128) + 128 + 1
    work = chip_smoke._merged_work(b, m, nx, False, neurons, n_w, precision)
    ms, by, pipe = chip_smoke._bound(work)
    assert (by, pipe) == ("operations", "ISSUE")
    assert ms == pytest.approx(bound_ms, abs=0.01)
    assert work[4] / chip_smoke.PEAK_BF16_TENSOR * 1e3 == pytest.approx(
        66.76 if precision == "bf16x3" else 66.76 / 3, abs=0.01)
    own = dict.fromkeys(("terminal", "integral"), chip_smoke.PER_NORMAL)
    same = chip_smoke._merged_work(b, m, nx, False, neurons, n_w, precision,
                                   own)
    assert same == pytest.approx(work)
    fp32, i32, sfu, other = chip_smoke.PER_NORMAL
    more = {**own, "terminal": (fp32, i32 + 8, sfu, other)}
    bigger = chip_smoke._merged_work(b, m, nx, False, neurons, n_w,
                                     precision, more)
    assert bigger[1] == pytest.approx(work[1] + 8 * b * m * nx)
    assert bigger[0] == pytest.approx(work[0])
    assert chip_smoke._narrow_own({
        k: {"all": 40.0, "fp32": 20.0, "int": 12.0, "sfu": 0.5}
        for k in ("terminal", "integral")}) == dict.fromkeys(
            ("terminal", "integral"), (40.0, 12.0, 0.5, 7.5))


@pytest.mark.parametrize("path,width,instance", [
    ("A", 128, 128), ("R", 128, 128), ("S", 256, 256), ("U", 512, "wide"),
    ("V", 512, "wide"), ("W", 1024, "wide"), ("X", 64, 64)])
def test_paths_keep_their_instance(path, width, instance):
    """The merged kernel's instance by path, from the net's width alone
    (generate.cu's instance_of): S moves to the width-256 instance; A, R
    (4x128), U, V, W (the wide pass) and X (width 64) keep theirs."""
    import json

    import chip_smoke

    if path in chip_smoke.WIDTH_PATHS:
        assert chip_smoke.WIDTH_PATHS[path][0][0] == width
    elif path in chip_smoke.HIGHD_PATHS:
        over = dict(zip(*[iter(chip_smoke.HIGHD_PATHS[path][1])] * 2))
        assert json.loads(over.get("NETWORK.NEURONS", "[128]"))[0] == width
    assert kernels.generate_tc_instance(width) == instance


# ---------------------------------------------------------------------------
# the OU mixture at nx = 512 and paths R, S, T's recipes
# ---------------------------------------------------------------------------

def test_ou_mixture_at_512_is_bit_equal():
    """Path T's equation (the HJB recipe at nx = 512: 5 components, mean
    scale 1, variance scale 2): the same means, variances and log-weights
    as the JAX package's, bit for bit."""
    kw = dict(nx=512, alpha=1.0, T=1.0, num_components=5, mean_scale=1.0,
              var_scale=2.0, alpha_scale=4.0)
    jeq = jax_make_eq("OUProcessEquation", **kw)
    teq = make_equation("OUProcessEquation", **kw)
    for name in ("gmm_means", "gmm_vars", "gmm_log_weights"):
        np.testing.assert_array_equal(getattr(teq, name).numpy(),
                                      np.asarray(getattr(jeq, name)))


@pytest.mark.parametrize("path", ["R", "S", "T"])
def test_highd_recipes_load_as_in_jax(path):
    """Paths R, S, T: the recipe with the record's overrides as chip_smoke
    reads it (the port's YAML reader) is the JAX package's load_cfg tree,
    DEVICE apart; the generation flags map alike."""
    import chip_smoke
    from deeppicarditeration_torch.training.picard import (
        gen_config_from_cfg,
    )
    from deeppicarditeration_tpu.training.picard import (
        gen_config_from_cfg as jax_gen_config_from_cfg,
    )

    recipe, overrides, _, first, budget = chip_smoke.HIGHD_PATHS[path]
    root = chip_smoke.ROOT
    port = chip_smoke.path_cfg(path, budget, "cpu").to_dict()
    assert port == load_cfg(root / recipe, list(overrides) + [
        "PICARD.N", str(budget), "DEVICE", "cpu"]).to_dict()
    assert port.pop("DEVICE") == "cpu"
    jcfg = jax_load_cfg(root / recipe, list(overrides)
                        + ["PICARD.N", str(budget)])
    assert port == jcfg.to_dict()
    gen = gen_config_from_cfg(chip_smoke.path_cfg(path, budget, "cpu"))
    jgen = jax_gen_config_from_cfg(jcfg, 1)
    for field in ("n_estimate_terminal", "n_estimate_integral",
                  "pallas_generate", "pallas_precision", "antithetic"):
        assert getattr(gen, field) == getattr(jgen, field), field
    rec = chip_smoke._record_rrmse(path)
    assert len(rec) == budget and tuple(rec[:3]) == first
