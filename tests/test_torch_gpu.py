"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card with nvcc (sm_90a); elsewhere they skip.
They import neither JAX nor the JAX package, so they run where only torch
is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest.py imports JAX.)
"""

import copy
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.models.networks import MLP
from deeppicarditeration_torch.models.solution import Solution
from deeppicarditeration_torch.ops import estimators as est
from deeppicarditeration_torch.ops import kernels, philox
from deeppicarditeration_torch.training.fused import WARMUP

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu

# FP32 sums over M samples in another order than the plain version's
# (sequential FMA in the kernel, pairwise in torch): a few 1e-6 here.
RTOL = ATOL = 5e-5
# Under the one-pass "default" mode that order can flip the bf16 rounding
# of one activation or gradient in a sample (2^-8 of it, where bf16x3's
# residual keeps 2^-16): 7.8e-5 seen at m = 50 on an H100, so 5e-4.
ONE_PASS_TOL = 5e-4
# ... and the merged kernel's with a net over more than 256 points, where
# the max runs further into a flip's tail (chip_smoke.py:
# ONE_PASS_WIDE_TOL, set from the plain version's own distance under
# permuted hidden units)
ONE_PASS_WIDE_TOL = 1.5e-3
# chip_smoke.py's ONE_PASS_SCALE_CAP, ONE_PASS_CONTROL, HIGHEST_CONTROL_M
# and HIGHEST_CONTROL: the integral kernel's wide "default" gate scaled by
# 4096 / m (8192 / m antithetic) at most twice, and under half the plain
# version's distance from its bf16x3; its "highest" under half its bf16x3's
# distance from the plain version in f64 on the value column at 128 samples
# a point
ONE_PASS_SCALE_CAP = 2.0
ONE_PASS_CONTROL = 0.5
HIGHEST_CONTROL_M = 128
HIGHEST_CONTROL = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _problem(cuda, b, m, nx=100, net=True, seed=0):
    g = torch.Generator().manual_seed(seed)
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    if net:
        mod = MLP(1 + nx, (128,) * 4, ("ELU",) * 4, 1, generator=g).to(cuda)
        sol = Solution.from_net(mod, "Value", nx)
    else:
        sol = Solution.zero(nx)
    t = torch.rand((b, 1), generator=g) * 0.99
    x = torch.randn((b, nx), generator=g) * t.sqrt()
    tx = torch.cat([t, x], 1).to(cuda)
    u01 = torch.rand((b, m, 1), generator=g).to(cuda)
    nt = torch.randn((b, m, nx), generator=g).to(cuda)
    ni = torch.randn((b, m, nx), generator=g).to(cuda)
    return eq, sol, tx, u01, nt, ni


@pytest.mark.parametrize("net,m,nx", [(False, 64, 100), (True, 64, 100),
                                      (True, 50, 100), (True, 70, 7)])
def test_kernel_matches_plain_on_external_noise(cuda, net, m, nx):
    eq, sol, tx, u01, nt, ni = _problem(cuda, 16, m, nx, net)
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt,
                                               ni)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


def test_inkernel_philox_within_clt_bounds(cuda):
    """In-kernel normals vs torch.Generator normals: each of the 1 + nx
    means within 5 standard errors of the difference."""
    b, m = 32, 4096
    eq, sol, tx, *_ = _problem(cuda, b, m)
    out = kernels.generate_with_gradients_cuda(1234, eq, sol, tx, m)
    again = kernels.generate_with_gradients_cuda(1234, eq, sol, tx, m)
    other = kernels.generate_with_gradients_cuda(1235, eq, sol, tx, m)
    ref, var = kernels.generate_with_gradients_plain(99, eq, sol, tx, m,
                                                     return_var=True)
    assert torch.equal(out, again)  # deterministic for a fixed seed
    assert not torch.equal(out, other)
    z = (out - ref) / torch.sqrt(2.0 * var / m).clamp(min=1e-12)
    assert torch.isfinite(out).all()
    assert float(z.abs().max()) < 5.0, float(z.abs().max())


def test_launch_counter_and_dispatcher(cuda):
    eq, sol, tx, *_ = _problem(cuda, 8, 32)
    n0 = kernels.GENERATE.launches
    gen = est.GenConfig(n_estimate_terminal=32, n_estimate_integral=32)
    out = est.generate_with_gradients(5, eq, sol, tx, gen)
    assert kernels.GENERATE.launches == n0 + 1
    assert out.shape == (8, 101) and out.is_cuda
    tanh = Solution.from_net(
        MLP(101, (128,), ("Tanh",), 1).to(cuda), "Value", 100)
    # "auto": a net the merged kernel does not cover takes the split path
    out = est.generate_with_gradients(5, eq, tanh, tx, gen)
    assert out.is_cuda and torch.isfinite(out).all()
    forced = est.GenConfig(n_estimate_terminal=32, n_estimate_integral=32,
                           pallas_generate=True)
    with pytest.raises(NotImplementedError):
        est.generate_with_gradients(5, eq, tanh, tx, forced)
    assert kernels.GENERATE.launches == n0 + 1


# The terminal kernel's edges (csrc/terminal.cu): nx at each quads-per-lane
# template (1, 2, 4: nx <= 128, 256, 512) and warps per block (3 at 512),
# a last quad cut short (nx % 4), M odd and not a multiple of the 32 draws
# a warp takes at once, B = 1 and B not a multiple of the 4 warps' points.
@pytest.mark.parametrize("anti,m,nx,b", [
    (False, 64, 100, 16), (True, 64, 100, 16), (False, 50, 7, 16),
    (True, 70, 300, 16), (False, 33, 1, 16), (True, 70, 4, 5),
    (False, 97, 128, 3), (True, 66, 129, 7), (False, 45, 257, 2),
    (True, 40, 512, 3), (False, 31, 100, 1), (True, 130, 100, 1)])
def test_terminal_kernel_matches_plain_on_external_noise(cuda, anti, m, nx,
                                                         b):
    eq, _, tx, _, nt, _ = _problem(cuda, b, m, nx, net=False)
    noise = nt[:, :m // 2].contiguous() if anti else nt
    out = kernels.terminal_with_gradients_cuda(0, eq, tx, m, noise,
                                               antithetic=anti)
    ref = kernels.terminal_with_gradients_plain(0, eq, tx, m, noise,
                                                antithetic=anti)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("anti,m,nx", [(False, 37, 1), (True, 66, 7),
                                       (False, 33, 129), (True, 40, 512)])
def test_terminal_own_draws_equal_the_host_philox_at_edge_widths(cuda, anti,
                                                                 m, nx):
    """The terminal kernel's own draws (the hoisted Philox of terminal.cu)
    equal the host Philox's at nx off the main path's, and a fixed seed
    gives the same result twice."""
    b, seed = 6, (7 << 32) | 5
    eq, _, tx, *_ = _problem(cuda, b, 2, nx, net=False)
    pts = list(range(b))
    noise = torch.from_numpy(philox.estimator_normals(
        seed, pts, m // 2 if anti else m, nx,
        philox.STREAM_TERMINAL)).to(cuda)
    out = kernels.terminal_with_gradients_cuda(seed, eq, tx, m,
                                               antithetic=anti)
    again = kernels.terminal_with_gradients_cuda(seed, eq, tx, m,
                                                 antithetic=anti)
    ref = kernels.terminal_with_gradients_plain(0, eq, tx, m, noise,
                                                antithetic=anti)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


def test_terminal_box_muller_is_philox_cuh_at_every_uniform(cuda):
    """The terminal kernel's guard-free Box-Muller returns philox.cuh's
    bits at all 2^23 uniforms a draw word gives."""
    assert kernels.terminal_draw_mismatches(cuda) == 0


def test_terminal_plan_is_the_kernels(cuda):
    """The kernel's plan (terminal.cu) fits a block's shared memory at
    every nx it covers; past MAX_NX it has none and the wrapper raises."""
    lib = kernels.TERMINAL.lib()
    max_nx = lib.dpi_terminal_max_nx()
    assert max_nx == 512
    for nx in range(1, max_nx + 1):
        assert 0 < lib.dpi_terminal_smem_bytes(nx) <= kernels.MAX_SMEM_BYTES
    assert lib.dpi_terminal_smem_bytes(max_nx + 1) == -1
    assert lib.dpi_terminal_smem_bytes(0) == -1
    eq, _, tx, *_ = _problem(cuda, 2, 2, max_nx + 1, net=False)
    with pytest.raises(NotImplementedError):
        kernels.terminal_with_gradients_cuda(0, eq, tx, 2)


@pytest.mark.parametrize("net,anti,m,nx", [
    (False, False, 64, 100), (True, False, 64, 100), (True, True, 64, 100),
    (True, False, 50, 7), (True, True, 70, 7)])
def test_integral_kernel_matches_plain_on_external_noise(cuda, net, anti, m,
                                                         nx):
    eq, sol, tx, u01, _, ni = _problem(cuda, 16, m, nx, net)
    if anti:
        u01, ni = u01[:, :m // 2].contiguous(), ni[:, :m // 2].contiguous()
    out = kernels.integral_with_gradients_cuda(0, eq, sol, tx, m, u01, ni,
                                               antithetic=anti)
    ref = kernels.integral_with_gradients_plain(0, eq, sol, tx, m, u01, ni,
                                                antithetic=anti)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


def test_merged_kernel_antithetic_matches_plain(cuda):
    m = 64
    eq, sol, tx, u01, nt, ni = _problem(cuda, 16, m)
    h = [v[:, :m // 2].contiguous() for v in (u01, nt, ni)]
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, *h,
                                               antithetic=True)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, *h,
                                                antithetic=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["terminal", "integral"])
@pytest.mark.parametrize("anti", [False, True])
def test_standalone_philox_within_clt_bounds(cuda, which, anti):
    b, m = 32, 4096
    eq, sol, tx, *_ = _problem(cuda, b, m)
    if which == "terminal":
        run = lambda s: kernels.terminal_with_gradients_cuda(  # noqa: E731
            s, eq, tx, m, antithetic=anti)
        ref, var = kernels.terminal_with_gradients_plain(
            99, eq, tx, m, antithetic=anti, return_var=True)
    else:
        run = lambda s: kernels.integral_with_gradients_cuda(  # noqa: E731
            s, eq, sol, tx, m, antithetic=anti)
        ref, var = kernels.integral_with_gradients_plain(
            99, eq, sol, tx, m, antithetic=anti, return_var=True)
    out = run(1234)
    assert torch.equal(out, run(1234))  # deterministic for a fixed seed
    assert not torch.equal(out, run(1235))
    z = (out - ref) / torch.sqrt(2.0 * var / m).clamp(min=1e-12)
    assert torch.isfinite(out).all()
    assert float(z.abs().max()) < 5.0, float(z.abs().max())


@pytest.mark.parametrize("which", ["generate", "terminal", "integral"])
@pytest.mark.parametrize("anti", [False, True])
def test_inkernel_draws_equal_the_host_philox(cuda, which, anti):
    """A kernel with its own draws equals its plain version fed the host
    Philox's draws (ops/philox.py) at the first and last points."""
    b, m, nx, seed = 64, 256, 100, (7 << 32) | 5
    eq, sol, tx, *_ = _problem(cuda, b, m)
    pts = [0, 1, 2, b - 2, b - 1]
    rows = m // 2 if anti else m

    def host(a):
        return torch.from_numpy(a).to(cuda)

    u = host(philox.estimator_times(seed, pts, rows))
    nt = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_TERMINAL))
    ni = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_INTEGRAL))
    if which == "generate":
        out = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m,
                                                   antithetic=anti)
        ref = kernels.generate_with_gradients_plain(
            0, eq, sol, tx[pts], m, u, nt, ni, antithetic=anti)
    elif which == "terminal":
        out = kernels.terminal_with_gradients_cuda(seed, eq, tx, m,
                                                   antithetic=anti)
        ref = kernels.terminal_with_gradients_plain(0, eq, tx[pts], m, nt,
                                                    antithetic=anti)
    else:
        out = kernels.integral_with_gradients_cuda(seed, eq, sol, tx, m,
                                                   antithetic=anti)
        ref = kernels.integral_with_gradients_plain(
            0, eq, sol, tx[pts], m, u, ni, antithetic=anti)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[pts], ref, rtol=RTOL, atol=ATOL)


def test_normals_kernel_equals_the_host_philox(cuda):
    seed, n = (7 << 32) | 5, 2 ** 22
    v = kernels.normals_cuda(seed, (n,), cuda)
    for start in (0, 12345, n - 4099):
        ref = torch.from_numpy(philox.normals_flat(seed, start, 4099))
        torch.testing.assert_close(v[start:start + 4099].cpu(), ref,
                                   rtol=1e-5, atol=1e-5)


def test_normals_kernel_moments_and_layout(cuda):
    n0 = kernels.NORMALS.launches
    v = kernels.normals_cuda(7, (4096, 64, 100), cuda)
    assert kernels.NORMALS.launches == n0 + 1
    assert v.shape == (4096, 64, 100) and v.dtype == torch.float32
    x = v.double().reshape(-1)
    n = x.numel()
    se = 1.0 / n ** 0.5
    assert abs(float(x.mean())) < 5 * se
    assert abs(float((x * x).mean()) - 1.0) < 5 * 2 ** 0.5 * se
    assert abs(float((x ** 4).mean()) - 3.0) < 5 * 96 ** 0.5 * se
    assert abs(float((x[1:] * x[:-1]).mean())) < 5 * se
    # the value at flat index i depends on (seed, i) alone
    w = kernels.normals_cuda(7, (1001, 3), cuda)
    assert torch.equal(w.reshape(-1), v.reshape(-1)[:3003])
    assert not torch.equal(kernels.normals_cuda(8, (1001, 3), cuda), w)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 1001, 4 * 270337 + 3])
def test_normals_kernel_at_tiny_and_ragged_lengths(cuda, n):
    """A buffer of a few values, and one whose length is not a multiple of
    the kernel's quads (its last quad stored value by value): every value
    is the host Philox's."""
    seed = (7 << 32) | 5
    v = kernels.normals_cuda(seed, (n,), cuda)
    ref = torch.from_numpy(philox.normals_flat(seed, 0, n))
    torch.testing.assert_close(v.cpu(), ref, rtol=1e-5, atol=1e-5)


def test_split_route_launch_counts(cuda):
    m = 64
    eq, sol, tx, *_ = _problem(cuda, 8, m)
    c0 = [lib.launches for lib in kernels.ALL]
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        pallas_generate=False, pallas_terminal=True,
                        pallas_integral=True)
    est.generate_with_gradients(5, eq, sol, tx, gen)
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        pallas_generate=False, tpu_prng=True,
                        chunk_elems=8 * 100 * 16)
    est.generate_with_gradients(5, eq, sol, tx, gen)
    d = {lib.source.stem: lib.launches - c
         for lib, c in zip(kernels.ALL, c0)}
    # the normals kernel: 4 + 4 chunks of 16 samples; no other kernel
    assert d == {"generate": 0, "generate_pis": 0, "terminal": 1,
                 "integral": 1, "normals": 8, "rollout": 0, "probe": 0}, d


# ---- the tensor-core net pass (csrc/value_mlp_tc.cuh) -----------------------

def _deep(cuda, nx, neurons, seed=3):
    g = torch.Generator().manual_seed(seed)
    mod = MLP(1 + nx, neurons, ("ELU",) * len(neurons), 1, generator=g)
    return Solution.from_net(mod.to(cuda), "Value", nx)


@pytest.mark.parametrize("which", ["generate", "integral"])
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("net,anti,m,nx", [
    (True, False, 64, 100), (True, True, 128, 100), (False, False, 64, 100),
    (True, False, 70, 7), (True, True, 50, 37)])
def test_tensor_core_kernels_match_plain_in_their_mode(cuda, which,
                                                       precision, net, anti,
                                                       m, nx):
    """Both kernels in a bf16 mode against the plain version in the same
    mode on the same noise: with antithetic pairing, a ragged last tile
    (m not a multiple of 64) and nx not a multiple of 16."""
    eq, sol, tx, u01, nt, ni = _problem(cuda, 16, m, nx, net)
    if anti:
        u01, nt, ni = (v[:, :m // 2].contiguous() for v in (u01, nt, ni))
    kw = dict(antithetic=anti, precision=precision)
    if which == "generate":
        lib = kernels.GENERATE
        run = kernels.generate_with_gradients_cuda
        plain = kernels.generate_with_gradients_plain
        args = (0, eq, sol, tx, m, u01, nt, ni)
    else:
        lib = kernels.INTEGRAL
        run = kernels.integral_with_gradients_cuda
        plain = kernels.integral_with_gradients_plain
        args = (0, eq, sol, tx, m, u01, ni)
    n0 = lib.launches
    out = run(*args, **kw)
    assert lib.launches == n0 + 1
    ref = plain(*args, **kw)
    torch.cuda.synchronize()
    tol = RTOL if precision == "bf16x3" else ONE_PASS_TOL
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    assert lib.mode_launches[precision] >= 1
    if net:  # the mode reaches the kernel: not the FP32 result
        f32 = run(*args, antithetic=anti)
        assert float((out - f32).abs().max()) > 0


@pytest.mark.parametrize("which", ["generate", "integral"])
@pytest.mark.parametrize("anti", [False, True])
def test_tensor_core_draws_equal_the_host_philox(cuda, which, anti):
    """Under bf16x3 each kernel's own draws equal the host Philox's
    (ops/philox.py), and the FP32-FMA kernel's: the same counters."""
    b, m, nx, seed = 64, 256, 100, (7 << 32) | 5
    eq, sol, tx, *_ = _problem(cuda, b, m)
    pts = [0, 1, 2, b - 2, b - 1]
    rows = m // 2 if anti else m

    def host(a):
        return torch.from_numpy(a).to(cuda)

    u = host(philox.estimator_times(seed, pts, rows))
    nt = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_TERMINAL))
    ni = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_INTEGRAL))
    kw = dict(antithetic=anti, precision="bf16x3")
    if which == "generate":
        out = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
        ref = kernels.generate_with_gradients_plain(0, eq, sol, tx[pts], m,
                                                    u, nt, ni, **kw)
    else:
        out = kernels.integral_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
        ref = kernels.integral_with_gradients_plain(0, eq, sol, tx[pts], m,
                                                    u, ni, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[pts], ref, rtol=RTOL, atol=ATOL)
    assert torch.equal(out, (kernels.generate_with_gradients_cuda
                             if which == "generate" else
                             kernels.integral_with_gradients_cuda)(
        seed, eq, sol, tx, m, **kw))  # deterministic


@pytest.mark.parametrize("nx,neurons", [(300, (128,) * 4), (100, (128,) * 6),
                                        (100, (128,)), (511, (128,) * 2),
                                        (200, (128,) * 2)])
def test_tensor_core_kernels_cover_deep_and_wide_nets(cuda, nx, neurons):
    """Every launch plan (value_mlp_tc.cuh: choose_gplan): the saved
    derivatives in global scratch (nx = 100, 300, 511) or in shared memory
    (nx = 200), the tiles' normals in scratch (the integral kernel at nx =
    511); layer 1 in several K-slabs; a single hidden layer. The integral
    kernel in its three modes."""
    m = 64
    eq, _, tx, u01, nt, ni = _problem(cuda, 8, m, nx, net=False)
    sol = _deep(cuda, nx, neurons)
    for run, plain, args, modes in (
            (kernels.generate_with_gradients_cuda,
             kernels.generate_with_gradients_plain,
             (0, eq, sol, tx, m, u01, nt, ni), ("bf16x3",)),
            (kernels.integral_with_gradients_cuda,
             kernels.integral_with_gradients_plain,
             (0, eq, sol, tx, m, u01, ni), kernels.PRECISIONS)):
        for precision in modes:
            out = run(*args, precision=precision)
            ref = plain(*args, precision=precision)
            torch.cuda.synchronize()
            tol = ONE_PASS_TOL if precision == "default" else RTOL
            torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


def test_dispatch_takes_the_tensor_cores_by_default(cuda):
    """GenConfig's default precision (bf16x3) launches the tensor-core
    kernel: its result is the plain bf16x3 version's, not the f32 one's."""
    m = 64
    eq, sol, tx, *_ = _problem(cuda, 8, m)
    n0 = kernels.GENERATE.launches
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m)
    out = est.generate_with_gradients(5, eq, sol, tx, gen)
    assert kernels.GENERATE.launches == n0 + 1
    torch.testing.assert_close(
        out, kernels.generate_with_gradients_cuda(5, eq, sol, tx, m,
                                                  precision="bf16x3"),
        rtol=0, atol=0)


# ---- rollout kernel (csrc/rollout.cu) ---------------------------------------

# Kernel draws vs the host Philox, and kernel paths vs the plain version
# fed those draws: f32 Box-Muller on the card vs float64 on the host, a
# few ulps; the sums are the same sequential f32 sums (rtol = atol).
PATH_TOL = 1e-5


def _path_inputs(cuda, b, nx, seed=0):
    g = torch.Generator().manual_seed(seed)
    x0 = torch.randn((b, nx), generator=g)
    t0 = torch.rand((b, 1), generator=g)
    # the baseline's tail-shrunk steps: dt where t0 + K dt <= T, else less
    dts = torch.where(t0 + 20 * 0.005 <= 1.0, torch.full_like(t0, 0.005),
                      (1.0 - t0) / 20)
    return x0.to(cuda), dts.sqrt().to(cuda)


def test_rollout_kernel_equals_the_host_philox_and_the_plain_version(cuda):
    seed, K, b, nx = (7 << 32) | 5, 20, 64, 100
    x0, sdt = _path_inputs(cuda, b, nx)
    n0 = kernels.ROLLOUT.launches
    xs, xi = kernels.paths_cuda(seed, x0, sdt, 1.3, K)
    torch.cuda.synchronize()
    assert kernels.ROLLOUT.launches == n0 + 1
    assert xs.shape == (K + 1, b, nx) and xi.shape == (K, b, nx)
    host = torch.from_numpy(philox.path_normals(seed, K, b, nx)).to(cuda)
    torch.testing.assert_close(xi, host, rtol=PATH_TOL, atol=PATH_TOL)
    ref, _ = kernels.paths_plain(0, x0, sdt, 1.3, K, host)
    torch.testing.assert_close(xs, ref, rtol=PATH_TOL, atol=PATH_TOL)
    assert torch.equal(xs[0], x0)
    torch.testing.assert_close(xs[1:] - xs[:-1], sdt[None] * 1.3 * xi,
                               rtol=PATH_TOL, atol=PATH_TOL)
    # xi[k, b, j] depends on (seed, k, b, j) alone: the same at another B
    xs17, xi17 = kernels.paths_cuda(seed, x0[:17].contiguous(),
                                    sdt[:17].contiguous(), 1.3, K)
    assert torch.equal(xi17, xi[:, :17]) and torch.equal(xs17, xs[:, :17])
    other = kernels.paths_cuda(seed + 1, x0, sdt, 1.3, K)[1]
    assert not torch.equal(other, xi)


@pytest.mark.parametrize("K,b,nx", [(20, 511, 7), (50, 511, 7),
                                     (70, 33, 100)])
def test_rollout_kernel_at_ragged_shapes(cuda, K, b, nx):
    """Columns B nx not a multiple of the 32-column tile (nor of 4: element
    stores), and K = 70 in two step chunks: the host Philox's draws and the
    plain version's paths on them."""
    seed = (5 << 32) | 9
    x0, sdt = _path_inputs(cuda, b, nx, seed=3)
    xs, xi = kernels.paths_cuda(seed, x0, sdt, 1.3, K)
    host = torch.from_numpy(philox.path_normals(seed, K, b, nx)).to(cuda)
    torch.testing.assert_close(xi, host, rtol=PATH_TOL, atol=PATH_TOL)
    ref, _ = kernels.paths_plain(0, x0, sdt, 1.3, K, host)
    torch.testing.assert_close(xs, ref, rtol=PATH_TOL, atol=PATH_TOL)
    assert torch.equal(xs[0], x0)


def test_rollout_seed_table_in_a_captured_graph(cuda):
    """The kernel reads its seed from a SeedTable and the wrapper advances
    the index inside the graph: three replays of one capture draw the host
    Philox's values at table entries 0, 1, 2."""
    K, b, nx = 20, 512, 100
    x0, sdt = _path_inputs(cuda, b, nx)
    seeds = [(7 << 32) | 5, 12345, (1 << 64) - 7]
    table = kernels.SeedTable(4, cuda)
    table.fill(seeds)
    kernels.paths_cuda(table, x0, sdt, 1.3, K)  # eager: entry 0
    torch.cuda.synchronize()
    assert int(table.index[0]) == 1
    table.fill(seeds)
    n0 = kernels.ROLLOUT.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        xs, xi = kernels.paths_cuda(table, x0, sdt, 1.3, K)
    assert int(table.index[0]) == 0  # the capture ran nothing
    assert kernels.ROLLOUT.launches == n0  # and counted nothing
    for i, seed in enumerate(seeds):
        graph.replay()
        torch.cuda.synchronize()
        assert int(table.index[0]) == i + 1
        host = torch.from_numpy(philox.path_normals(seed, K, b, nx)).to(cuda)
        torch.testing.assert_close(xi, host, rtol=PATH_TOL, atol=PATH_TOL)
        ref, _ = kernels.paths_plain(0, x0, sdt, 1.3, K, host)
        torch.testing.assert_close(xs, ref, rtol=PATH_TOL, atol=PATH_TOL)
    assert kernels.ROLLOUT.launches == n0  # a replay runs no wrapper


def test_profiler_sees_the_rollout_kernel_once_per_replay(cuda):
    """What chip_smoke reads for the launches inside graphs: a
    torch.profiler trace of 4 replays of a captured rollout shows 4 device
    events of the kernel, and the wrapper's count stays where it was."""
    from torch.profiler import ProfilerActivity, profile

    K, b, nx = 20, 64, 8
    x0, sdt = _path_inputs(cuda, b, nx)
    table = kernels.SeedTable(4, cuda)
    table.fill([1, 2, 3, 4])
    kernels.paths_cuda(table, x0, sdt, 1.0, K)  # builds and warms
    table.fill([1, 2, 3, 4])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kernels.paths_cuda(table, x0, sdt, 1.0, K)
    n0 = kernels.ROLLOUT.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            graph.replay()
        torch.cuda.synchronize()
    assert kernels.ROLLOUT.launches == n0
    assert kernels.trace_launches(prof, kernels.ROLLOUT_KERNEL) == 4


def test_rollout_kernel_law_of_the_endpoint(cuda):
    """X_K ~ N(x0, alpha K dt) per element: mean and variance of the
    standardized endpoint within 5 standard errors."""
    K, b, nx, dt, alpha_sqrt = 20, 4096, 100, 0.005, 1.3
    x0 = torch.zeros((b, nx), device=cuda)
    sdt = torch.full((b, 1), dt ** 0.5, device=cuda)
    xs, _ = kernels.paths_cuda(11, x0, sdt, alpha_sqrt, K)
    z = (xs[-1] / (alpha_sqrt * (K * dt) ** 0.5)).double().reshape(-1)
    n = z.numel()
    assert abs(float(z.mean())) < 5 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 5 * (2 / n) ** 0.5


def test_rollout_wrapper_checks_its_inputs(cuda):
    x0, sdt = _path_inputs(cuda, 8, 4)
    with pytest.raises(ValueError):
        kernels.paths_cuda(0, x0.t(), sdt, 1.0, 4)  # not contiguous
    with pytest.raises(ValueError):
        kernels.paths_cuda(0, x0, sdt[:4].contiguous(), 1.0, 4)
    with pytest.raises(ValueError):
        kernels.paths_cuda(0, x0.double(), sdt, 1.0, 4)


# ---- Adam on the card against optax's arithmetic -----------------------------

def optax_adam_f32(params, grads, lr):
    """``optax.adam(lr)``'s arithmetic in numpy float32 (``scale_by_adam``,
    then ``scale(-lr)`` and the add): the moments' factors 1 - b1, 1 - b2
    rounded from Python floats, the bias correction 1 - b ** count in f32,
    eps 1e-8 outside the square root. ``params``: f32 arrays; ``grads``:
    one list like ``params`` per step. Returns the parameters and the
    moments (mu, nu) after the steps. Held to optax itself on the CPU in
    tests/test_torch_fn.py; imports no JAX."""
    f = np.float32
    b1, b2, eps = 0.9, 0.999, 1e-8
    ps = [np.asarray(p, np.float32).copy() for p in params]
    mu = [np.zeros_like(p) for p in ps]
    nu = [np.zeros_like(p) for p in ps]
    for count, gs in enumerate(grads, start=1):
        bc1 = f(1) - f(b1) ** f(count)
        bc2 = f(1) - f(b2) ** f(count)
        for i, g in enumerate(gs):
            g = np.asarray(g, np.float32)
            mu[i] = f(1 - b1) * g + f(b1) * mu[i]
            nu[i] = f(1 - b2) * (g * g) + f(b2) * nu[i]
            u = (mu[i] / bc1) / (np.sqrt(nu[i] / bc2) + f(eps))
            ps[i] = ps[i] + u * f(-lr)
    return ps, mu, nu


def adam_case(seed=0, steps=30):
    """Parameters shaped as a DBDP pair's first layers (nx = 8, 32 hidden)
    and ``steps`` gradients whose scales span 1e-6 to 1 (so eps matters
    for some), made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    shapes = [(32, 9), (32,), (32, 32), (32,), (1, 32), (1,)]
    params = [rng.standard_normal(sh).astype(np.float32) * 0.3
              for sh in shapes]
    grads = [[(rng.standard_normal(sh) * 10.0 ** rng.uniform(-6, 0, sh))
              .astype(np.float32) for sh in shapes] for _ in range(steps)]
    return params, grads


def test_capturable_adam_matches_optax_arithmetic(cuda):
    """DBDP's Adam on the card (``capturable``: the step count on the
    device and the bias correction in f32, as ``CapturedPairFit`` and the
    eager reference use it) against optax.adam's arithmetic
    (``optax_adam_f32``), the JAX package's DBDP optimizer, on the same
    parameters and 30 gradients: parameters within 1e-6 (a few f32 ulps
    of values ~1, against steps of ~1e-3); moments within 1e-6 of each
    tensor's largest (torch's lerp against optax's two products and a
    sum: a few ulps of the terms, which may cancel to far smaller
    values)."""
    from deeppicarditeration_torch.training.baselines import BASELINE_LR

    params, grads = adam_case()
    ps = [torch.nn.Parameter(torch.from_numpy(p).to(cuda)) for p in params]
    opt = torch.optim.Adam(ps, lr=BASELINE_LR, capturable=True)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(cuda)
        opt.step()
    want, mu, nu = optax_adam_f32(params, grads, BASELINE_LR)
    for p, w, m, v in zip(ps, want, mu, nu):
        st = opt.state[p]
        torch.testing.assert_close(p.detach().cpu(), torch.from_numpy(w),
                                   rtol=0, atol=1e-6)
        for got, ref in ((st["exp_avg"], m), (st["exp_avg_sq"], v)):
            ref = torch.from_numpy(ref)
            torch.testing.assert_close(got.cpu(), ref, rtol=0,
                                       atol=1e-6 * float(ref.abs().max()))
        assert float(st["step"]) == len(grads)


# ---- rate probe (csrc/probe.cu) ---------------------------------------------

# f32 partial sums of 32 x iters units in another order than the plain
# version's, on draws that agree to a few ulps (rtol = atol)
PROBE_TOL = 1e-5


@pytest.mark.parametrize("which", kernels.PROBE_MODES)
def test_probe_kernel_matches_its_plain_version(cuda, which):
    seed, grid, iters = (7 << 32) | 5, 6, 3
    n0 = kernels.PROBE.launches
    out = kernels.probe_cuda(which, seed, iters, cuda, grid)
    torch.cuda.synchronize()
    assert kernels.PROBE.launches == n0 + 1
    ref = kernels.probe_plain(which, seed, grid, iters, cuda)
    torch.testing.assert_close(out, ref, rtol=PROBE_TOL, atol=PROBE_TOL)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert kernels.probe_grid(which) % n_sm == 0


# ---- the D-DBSDE baseline through the rollout kernel -------------------------

def test_diffusion_baseline_runs_through_the_rollout_kernel(cuda, tmp_path):
    import json

    from deeppicarditeration_torch.config import default_cfg
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = default_cfg()
    cfg.merge({"NAME": "diff_gpu", "FORCE": True,
               "EQUATION": {"cls": "Cha", "kwargs": {"nx": 8, "alpha": 1.0,
                                                     "k": 1.0, "T": 1.0}},
               "METHOD": {"cls": "Diffusion", "K": 5, "dt": 0.05},
               "PICARD": {"N": 1},
               "TRAIN": {"BATCH_SIZE": 64, "N_EPOCHS": 30,
                         "LOSS": {"beta": 10.0}},
               "NETWORK": {"NEURONS": [32, 32],
                           "ACTIVATIONS": ["ELU", "ELU"]},
               "EVAL": {"FREQ": 10, "L2_N_POINTS": 200, "TEST_GRAD": True}},
              allow_new=False)
    runner = PicardRunner(cfg.freeze(), exp_root=tmp_path)
    n0 = kernels.ROLLOUT.launches
    runner.run()
    # the rollout inside the epoch's graph: the wrapper counts the
    # capture's warm-up calls, the only eager launches
    assert runner.rollout_calls == runner.graph_replays == 30
    assert kernels.ROLLOUT.launches - n0 == WARMUP
    rows = [json.loads(ln) for ln in
            (runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    evals = [r["rRMSE"] for r in rows if r["context"] == "eval"]
    assert len(evals) == 3 and all(e is not None for e in evals)
    assert next(runner.u_current.module.parameters()).is_cuda


def test_diffusion_epoch_graph_draws_the_eager_draws(cuda, tmp_path):
    """The D-DBSDE epoch's draws inside a captured graph (t0, x0, xT from
    registered generators seeded per epoch, the paths from the seed table)
    equal the eager draws of the same epochs bit for bit, at every
    replay."""
    from deeppicarditeration_torch.config import default_cfg
    from deeppicarditeration_torch.training import baselines
    from deeppicarditeration_torch.training.fused import FusedStep
    from deeppicarditeration_torch.training.picard import PicardRunner
    from deeppicarditeration_torch.training.trainer import reset_optimizer

    cfg = default_cfg()
    cfg.merge({"NAME": "diff_draws", "FORCE": True,
               "EQUATION": {"cls": "Cha", "kwargs": {"nx": 8, "alpha": 1.0,
                                                     "k": 1.0, "T": 1.0}},
               "METHOD": {"cls": "Diffusion", "K": 5, "dt": 0.2},
               "TRAIN": {"BATCH_SIZE": 64, "LOSS": {"beta": 10.0}}},
              allow_new=False)
    runner = PicardRunner(cfg.freeze(), exp_root=tmp_path)
    runner.i = 1
    gens = baselines.epoch_generators(runner)
    seeds = kernels.SeedTable(4, cuda)
    seeds.fill([baselines.derive_seed(runner.seed, 1, e, baselines.PATHS)
                for e in range(4)])
    mod = torch.nn.Linear(1, 1).to(cuda)
    opt = torch.optim.Adam(mod.parameters(), capturable=True)
    reset_optimizer(opt)

    def body():
        return [v.clone() for v in baselines.diffusion_inputs(
            runner, gens, seeds, 10.0)]

    step = FusedStep(body, {}, mod, opt, generators=list(gens.values()),
                     state=[seeds.index])
    for epoch in range(4):
        baselines.seed_epoch(runner, gens, epoch)
        got = step()
        want = baselines.diffusion_draws(runner, epoch, 10.0)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), epoch
    assert step.replays == 4 and int(seeds.index[0]) == 4


# ---- the fused fit as CUDA-graph replays ---------------------------------

def _fit_cfg(fused):
    from deeppicarditeration_torch.config import default_cfg

    cfg = default_cfg()
    cfg.merge({"NAME": f"fit_{fused}", "FORCE": True,
               "EQUATION": {"cls": "Cha", "kwargs": {"nx": 100, "alpha": 1.0,
                                                     "k": 5.0, "T": 1.0}},
               "PICARD": {"N": 1},
               "DATA": {"DATA_SIZE": 4096, "SAMPLE_BOUND": 2.0,
                        "kwargs": {"t_always_uniform": True,
                                   "n_estimate_terminal": 256,
                                   "n_estimate_integral": 256}},
               "TRAIN": {"N_EPOCHS": 16, "BATCH_SIZE": 512,
                         "SUPERVISE_GRADIENT": True, "FUSED": fused,
                         "LOSS": {"SCALER": {"cls": "FixedLossScaler",
                                             "kwargs": {"fixed_weight": 1.0}}}},
               "NETWORK": {"NEURONS": [128] * 4, "ACTIVATIONS": ["ELU"] * 4},
               "EVAL": {"L2_N_POINTS": 10000, "FREQ": 8, "TEST_GRAD": True}},
              allow_new=False)
    return cfg.freeze()


def test_captured_fit_matches_the_eager_fit(cuda, tmp_path):
    """Path A's fit (128 steps, 16 evals) captured and as a loop, on the same
    dataset and draws (one iteration from the zero iterate). Capturable Adam
    computes its bias correction on the card in f32, the loop on the host
    in f64; the difference grows with the steps: the first segment within
    1e-5 relative, the last within 1e-3."""
    import json

    from deeppicarditeration_torch.training.picard import PicardRunner

    rows = {}
    for fused in ("auto", "false"):
        runner = PicardRunner(_fit_cfg(fused), exp_root=tmp_path)
        runner.run()
        assert runner.graph_replays == (16 if fused == "auto" else 0)
        rows[fused] = [json.loads(ln) for ln in (
            runner.exp_dir / "metrics.jsonl").read_text().splitlines()]
    segs = {k: [r for r in v if r["context"] in ("train", "eval")]
            for k, v in rows.items()}
    assert [(r["context"], r["step"]) for r in segs["auto"]] == [
        (r["context"], r["step"]) for r in segs["false"]]
    rel = []
    for a, b in zip(segs["auto"], segs["false"]):
        keys = ("train_loss",) if a["context"] == "train" else (
            "rRMSE", "rRMSEg")
        rel.append(max(abs(a[k] - b[k]) / abs(b[k]) for k in keys))
    print(f"captured vs loop, relative difference by segment: {rel}")
    assert max(rel[:2]) <= 1e-5 and max(rel[-2:]) <= 1e-3, rel


def test_failed_capture_raises(cuda):
    """A host sync in the body fails the capture: FusedStep raises, and
    nothing runs the body eagerly instead."""
    from deeppicarditeration_torch.training.fused import FusedStep
    from deeppicarditeration_torch.training.trainer import reset_optimizer

    mod = torch.nn.Linear(4, 1).to(cuda)
    opt = torch.optim.Adam(mod.parameters(), capturable=True)
    reset_optimizer(opt)
    x = torch.randn((8, 4), device=cuda)

    def body():
        opt.zero_grad(set_to_none=True)
        loss = mod(x).square().mean()
        loss.backward()
        opt.step()
        if loss.item() < 0:  # a host sync: not capturable
            raise AssertionError
        return loss.detach()

    step = FusedStep(body, {"x": x}, mod, opt)
    with pytest.raises(RuntimeError):
        step()
    assert step.graph is None and step.replays == 0
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the HJB instance of the merged kernel: OU + PISGradNet (generate_pis.cu)
# ---------------------------------------------------------------------------

# max |kernel - plain| over max |plain| (at least 1), for the value column
# and for the gradient columns: f32 sums in another order, and under the
# one-pass mode a bf16 rounding that an f32 difference can flip
PIS_REL_TOL = {"bf16x3": 1e-4, "default": 1e-3}


def pis_rel_err(out, ref):
    """(value column, gradient columns) relative errors of PIS_REL_TOL."""
    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)

    return rel(out[:, :1], ref[:, :1]), rel(out[:, 1:], ref[:, 1:])


def _pis_problem(cuda, b, m, nx=100, net=True, seed=0, hidden=(512,) * 4):
    from deeppicarditeration_torch.models.networks import PISGradNet

    g = torch.Generator().manual_seed(seed)
    eq = make_equation("OUProcessEquation", nx=nx, num_components=5,
                       seed=seed).to(cuda)
    sol = Solution.zero(nx)
    if net:
        mod = PISGradNet(nx, hidden, (eq.gmm_means, eq.gmm_vars,
                                      eq.gmm_log_weights), generator=g)
        with torch.no_grad():  # a phase and a gate away from their init
            mod.timestep_phase.normal_(generator=g)
        sol = Solution.from_net(mod.to(cuda), "Value", nx)
    t = torch.rand((b, 1), generator=g) * 0.99
    x = torch.randn((b, nx), generator=g) * (2.0 * (1.0 + t).sqrt())
    tx = torch.cat([t, x], 1).to(cuda)
    u01 = torch.rand((b, m, 1), generator=g).to(cuda)
    nt = torch.randn((b, m, nx), generator=g).to(cuda)
    ni = torch.randn((b, m, nx), generator=g).to(cuda)
    return eq, sol, tx, u01, nt, ni


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
@pytest.mark.parametrize("net,m,nx", [(True, 100, 100), (False, 64, 100),
                                      (True, 64, 37)])
def test_pis_kernel_matches_plain_at_full_width(cuda, precision, net, m,
                                                nx):
    """The PIS kernel on the 4x512 PISGradNet (and the zero iterate)
    against the plain version in the same mode on the same noise, with a
    ragged last tile (m = 100) and nx not a multiple of 16."""
    eq, sol, tx, u01, nt, ni = _pis_problem(cuda, 8, m, nx, net)
    n0 = kernels.GENERATE_PIS.launches
    out = kernels.generate_pis_cuda(0, eq, sol, tx, m, u01, nt, ni,
                                    precision=precision)
    assert kernels.GENERATE_PIS.launches == n0 + 1
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, precision=precision)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ev, eg = pis_rel_err(out, ref)
    assert ev <= PIS_REL_TOL[precision] and eg <= PIS_REL_TOL[precision], \
        (ev, eg)


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
def test_pis_kernel_draws_equal_the_host_philox(cuda, precision):
    """Its own draws equal the host Philox's (ops/philox.py): the kernel
    on its draws against the plain version fed the host's, at the first
    and last points; and it is deterministic."""
    b, m, nx, seed = 16, 128, 100, (7 << 32) | 5
    eq, sol, tx, *_ = _pis_problem(cuda, b, m, nx)
    pts = [0, 1, b - 2, b - 1]

    def host(a):
        return torch.from_numpy(a).to(cuda)

    u = host(philox.estimator_times(seed, pts, m))
    nt = host(philox.estimator_normals(seed, pts, m, nx,
                                       philox.STREAM_TERMINAL))
    ni = host(philox.estimator_normals(seed, pts, m, nx,
                                       philox.STREAM_INTEGRAL))
    out = kernels.generate_pis_cuda(seed, eq, sol, tx, m,
                                    precision=precision)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx[pts], m, u,
                                                nt, ni, precision=precision)
    torch.cuda.synchronize()
    ev, eg = pis_rel_err(out[pts], ref)
    assert ev <= PIS_REL_TOL[precision] and eg <= PIS_REL_TOL[precision], \
        (ev, eg)
    assert torch.equal(out, kernels.generate_pis_cuda(seed, eq, sol, tx, m,
                                                      precision=precision))


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
@pytest.mark.parametrize("net,b,m,nx", [
    (True, 3, 1, 1),      # one sample: a tile of one live row
    (True, 5, 65, 16),    # a live row past the first tile
    (True, 7, 130, 128),  # nx at its limit: the fewest ring stages
    (True, 133, 33, 37),  # B past the grid, not a multiple of it
    (False, 3, 100, 128),
    (False, 133, 17, 1),
])
def test_pis_kernel_matches_plain_at_its_boundaries(cuda, precision, net, b,
                                                    m, nx):
    """The PIS kernel against the plain version in the same mode on the
    same noise where its schedule has edges: M not a multiple of the
    64-row tile, nx from 1 (one quad of one lane of a draw's four) to 128
    (a lane's eight quads; the largest tiles and the fewest stages), B
    below and past the persistent grid, and the zero iterate."""
    eq, sol, tx, u01, nt, ni = _pis_problem(cuda, b, m, nx, net)
    out = kernels.generate_pis_cuda(0, eq, sol, tx, m, u01, nt, ni,
                                    precision=precision)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, precision=precision)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    ev, eg = pis_rel_err(out, ref)
    assert ev <= PIS_REL_TOL[precision] and eg <= PIS_REL_TOL[precision], \
        (ev, eg)


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
@pytest.mark.parametrize("nx", [100, 129, 300, 511, 512])
def test_pis_kernel_is_deterministic(cuda, precision, nx):
    """Two launches on its own draws are bit-equal, with two and three
    points on a block and a ragged last tile, in the narrow instance (nx =
    100) and the wide one (nx past 128, off and on multiples of 4): every
    sum over draws, rows and warps runs in a fixed order."""
    b, m = 300, 200
    eq, sol, tx, *_ = _pis_problem(cuda, b, m, nx)
    seed = (3 << 32) | 11
    first = kernels.generate_pis_cuda(seed, eq, sol, tx, m,
                                      precision=precision)
    second = kernels.generate_pis_cuda(seed, eq, sol, tx, m,
                                       precision=precision)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


def test_pis_forced_merged_route_raises_where_the_kernel_does_not_cover(
        cuda):
    """A forced PALLAS_GENERATE: true raises on the card for "highest"
    with a PISGradNet, other widths and antithetic pairing; "auto" takes
    the split route for them (and the kernel where it covers)."""
    eq, sol, tx, *_ = _pis_problem(cuda, 4, 64)
    _, narrow, *_ = _pis_problem(cuda, 4, 64, hidden=(64,) * 4)
    forced = est.GenConfig(n_estimate_terminal=64, n_estimate_integral=64,
                           pallas_generate=True, pallas_precision="highest")
    with pytest.raises(NotImplementedError, match="highest"):
        est.generate_with_gradients(0, eq, sol, tx, forced)
    for gen, s in ((dataclasses.replace(forced,
                                            pallas_precision="default"),
                    narrow),
                   (dataclasses.replace(forced, antithetic=True,
                                            pallas_precision="default"),
                    sol)):
        with pytest.raises(NotImplementedError):
            est.generate_with_gradients(0, eq, s, tx, gen)
        assert est.generation_route(
            eq, s, dataclasses.replace(gen, pallas_generate="auto")) \
            == est.SPLIT
    auto = dataclasses.replace(forced, pallas_generate="auto",
                                   pallas_precision="default")
    n0 = kernels.GENERATE_PIS.launches
    est.generate_with_gradients(0, eq, sol, tx, auto)
    assert kernels.GENERATE_PIS.launches == n0 + 1


# ---- the FN family: the rollout kernel under DBDP, normals under SDGD -------

def test_rollout_kernel_at_the_dbdp_shape(cuda):
    """K = 50 steps of dt = 0.02 from x0 ~ N(0, 4 I), B = 512, nx = 100 (the
    DBDP recipes' paths): the kernel's draws are the host Philox's, its
    paths the plain version's on those draws."""
    seed, K, b, nx = (9 << 32) | 3, 50, 512, 100
    g = torch.Generator().manual_seed(1)
    x0 = (2.0 * torch.randn((b, nx), generator=g)).to(cuda)
    sdt = torch.full((b, 1), 0.02 ** 0.5, device=cuda)
    xs, xi = kernels.paths_cuda(seed, x0, sdt, 1.0, K)
    host = torch.from_numpy(philox.path_normals(seed, K, b, nx)).to(cuda)
    torch.testing.assert_close(xi, host, rtol=PATH_TOL, atol=PATH_TOL)
    ref, _ = kernels.paths_plain(0, x0, sdt, 1.0, K, host)
    torch.testing.assert_close(xs, ref, rtol=PATH_TOL, atol=PATH_TOL)
    assert torch.equal(xs[0], x0)


def test_normals_kernel_at_the_fn_chunk_shape(cuda):
    """The FN recipe's chunk draw (2048, 32, 100): the host Philox's values
    at both ends of the buffer, and N(0, 1) moments."""
    seed, shape = (7 << 32) | 5, (2048, 32, 100)
    v = kernels.normals_cuda(seed, shape, cuda).reshape(-1)
    n = v.numel()
    for start in (0, n - 4099):
        ref = torch.from_numpy(philox.normals_flat(seed, start, 4099))
        torch.testing.assert_close(v[start:start + 4099].cpu(), ref,
                                   rtol=1e-5, atol=1e-5)
    x = v.double()
    assert abs(float(x.mean())) < 5 / n ** 0.5
    assert abs(float(x.var()) - 1.0) < 5 * (2 / n) ** 0.5


@pytest.mark.parametrize("prng", [False, True])
def test_fn_targets_on_the_card_agree_with_the_cpu_within_clt(cuda, prng):
    """One FN generation call (GBM, SDGD v = nx, bf16 Hessian store, a
    3x64 net) on the card (the normals kernel under DATA.TPU.PRNG) against
    the same call on the CPU: each output within 5 standard errors of the
    difference over 32 replicates of 8 points."""
    nx, b, m, reps = 16, 8, 64, 32
    eq = make_equation("GBMEquationComplexExact", nx=nx)
    g = torch.Generator().manual_seed(2)
    mod = MLP(1 + nx, (64,) * 3, ("ELU",) * 3, 1, generator=g)
    t = torch.rand((b, 1), generator=g) * 0.98
    x = 0.5 * torch.randn((b, nx), generator=g)
    tx = torch.cat([t, x], 1).repeat(reps, 1)
    gen = est.GenConfig(n_estimate_terminal=m, n_estimate_integral=m,
                        chunk_elems=reps * b * nx * 16, sdgd_v=nx,
                        hess_store="bf16", tpu_prng=prng)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        sol = Solution.from_net(mod.to(dev), "Value", nx)
        n0 = kernels.NORMALS.launches
        outs[dev.type] = est.generate_with_gradients(
            11, eq.to(dev), sol, tx.to(dev), gen).cpu().double().reshape(
            reps, b, -1)
        if dev.type == "cuda":
            assert kernels.NORMALS.launches - n0 == (8 if prng else 0)
    a, c = outs["cuda"], outs["cpu"]
    se = ((a.var(0) + c.var(0)) / reps).sqrt().clamp(min=1e-12)
    z = (a.mean(0) - c.mean(0)) / se
    assert torch.isfinite(a).all()
    assert float(z.abs().max()) < 5.0, float(z.abs().max())
    assert 0.3 < float((z * z).mean()) < 3.0


def test_forced_terminal_kernel_raises_on_gbm(cuda):
    """The terminal kernel has Cha's g only: a forced PALLAS_TERMINAL on
    the FN equation raises on the card, naming the equation."""
    eq = make_equation("GBMEquationComplexExact", nx=8).to(cuda)
    tx = torch.cat([torch.full((4, 1), 0.5), torch.zeros(4, 8)], 1).to(cuda)
    gen = est.GenConfig(n_estimate_terminal=16, n_estimate_integral=16,
                        pallas_terminal=True, sdgd_v=8)
    with pytest.raises(NotImplementedError, match="GBMEquationComplexExact"):
        est.estimate_terminal_with_gradients(0, eq, tx, gen)


# ---- DBDP's sub-iterations as CUDA-graph replays -----------------------------

@pytest.mark.parametrize("eq_cls,enforce", [
    ("GBMEquationComplexExact", False), ("GBMEquationComplexExact", True),
    ("OUProcessEquation", False)])
def test_captured_dbdp_grid_times_equal_the_eager_loop(cuda, tmp_path,
                                                       eq_cls, enforce):
    """The terminal pre-fit (or the enforcing ansatz's last step) and one
    interior grid time, 5 sub-iterations each, as graph replays of the
    static working pair against the per-pair eager loop on the same seeds
    (nx = 8, B = 64, K = 4), both with capturable Adams: every pair's
    parameters within 1e-5 of the largest |parameter| (graph replays and
    eager launches of the same kernels). One replay per sub-iteration;
    the wrapper counts each eager launch: every sub-iteration of the eager
    loop, only each graph's warm-up of the captured one."""
    from deeppicarditeration_torch.config import default_cfg
    from deeppicarditeration_torch.training import baselines
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = default_cfg()
    cfg.merge({"NAME": "dbdp_gpu", "FORCE": True,
               "EQUATION": {"cls": eq_cls,
                            "kwargs": {"nx": 8, "alpha": 1.0, "T": 0.2}},
               "METHOD": {"cls": "FullyNonlinearSolver", "dt": 0.05,
                          "num_sub_iter": 5},
               "TRAIN": {"BATCH_SIZE": 64},
               "NETWORK": {"NEURONS": [32, 32],
                           "ACTIVATIONS": ["ELU", "ELU"],
                           **({"cls": "PicardSolutionEnforceTerminal"}
                              if enforce else {})}},
              allow_new=False)
    nets = {}
    for name, cls in (("eager", baselines.EagerPairFit),
                      ("captured", baselines.CapturedPairFit)):
        runner = PicardRunner(cfg.freeze(), exp_root=tmp_path / name)
        runner.i = 1
        sw = baselines.DBDPSweep(runner)
        nets[name] = baselines.init_dbdp_nets(runner, sw.K)
        fit = cls(sw, nets[name])
        n0 = kernels.ROLLOUT.launches
        kks = ([] if enforce else [sw.K + 1]) + [sw.K, sw.K - 1]
        for kk in kks:
            if kk < sw.K:
                nets[name].copy_pair(kk, kk - 1)
            fit(0, kk)
        torch.cuda.synchronize()
        subs = 5 * len(kks)
        assert runner.rollout_calls == subs
        if name == "captured":
            assert runner.graph_replays == subs
            assert kernels.ROLLOUT.launches - n0 == WARMUP * len(fit.steps)
        else:
            assert kernels.ROLLOUT.launches - n0 == subs
    a = torch.cat([p.reshape(-1) for p in nets["captured"].parameters()])
    b = torch.cat([p.reshape(-1) for p in nets["eager"].parameters()])
    err = float((a - b).abs().max() / b.abs().max())
    print(f"captured vs eager DBDP, max |diff| / max |param|: {err:.3e}")
    assert err <= 1e-5


# ---- the merged tensor-core kernel at ragged shapes (csrc/generate.cu) ------

# B off the grid, M off the 128 rows a ring pass serves (63 tiles: the second
# warpgroup's last tile empty), nx = 7 and 100
RAGGED = [(131, 4000, 7), (4095, 1000, 100)]


@pytest.mark.parametrize("b,m,nx", RAGGED)
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
def test_merged_kernel_matches_plain_at_ragged_shapes(cuda, b, m, nx,
                                                      precision, anti):
    eq, sol, tx, *_ = _problem(cuda, b, 1, nx)
    rows = m // 2 if anti else m
    g = torch.Generator(device=cuda).manual_seed(3)
    u01 = torch.rand((b, rows, 1), generator=g, device=cuda)
    nt = torch.randn((b, rows, nx), generator=g, device=cuda)
    ni = torch.randn((b, rows, nx), generator=g, device=cuda)
    kw = dict(antithetic=anti, precision=precision)
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt,
                                               ni, **kw)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, **kw)
    torch.cuda.synchronize()
    tol = (RTOL if precision == "bf16x3" else
           ONE_PASS_TOL if b <= 256 else ONE_PASS_WIDE_TOL)
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("b,m,nx", RAGGED)
@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
def test_merged_kernel_draws_equal_the_host_philox_at_ragged_shapes(
        cuda, b, m, nx, precision, anti):
    """Its own draws at the first and last points (keyed by their rows in
    the launch) equal the host Philox's fed to the plain version."""
    seed = (7 << 32) | 5
    eq, sol, tx, *_ = _problem(cuda, b, 1, nx)
    rows = m // 2 if anti else m
    pts = [0, 1, b - 2, b - 1]

    def host(a):
        return torch.from_numpy(a).to(cuda)

    u = host(philox.estimator_times(seed, pts, rows))
    nt = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_TERMINAL))
    ni = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_INTEGRAL))
    kw = dict(antithetic=anti, precision=precision)
    out = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx[pts], m, u,
                                                nt, ni, **kw)
    torch.cuda.synchronize()
    tol = RTOL if precision == "bf16x3" else ONE_PASS_TOL
    torch.testing.assert_close(out[pts], ref, rtol=tol, atol=tol)


# the integral kernel's ragged cases: B off the grid, an odd tile count
# (4000: 63 tiles, the second warpgroup's last tile empty; 192: 3), nx = 7,
# 100 and 511 (its normals in global scratch)
INTEGRAL_RAGGED = [(131, 4000, 7), (4095, 1000, 100), (37, 192, 511)]


@pytest.mark.parametrize("b,m,nx", INTEGRAL_RAGGED)
@pytest.mark.parametrize("precision", kernels.PRECISIONS)
@pytest.mark.parametrize("anti", [False, True])
def test_integral_kernel_matches_plain_at_ragged_shapes(cuda, b, m, nx,
                                                        precision, anti):
    """The integral kernel in each mode against its plain version on the
    same noise ("default" at chip_smoke's gates), and its "highest"
    instance against its bf16x3 one (chip_smoke's HIGHEST_CONTROL)."""
    eq, sol, tx, *_ = _problem(cuda, b, 1, nx)
    rows = m // 2 if anti else m
    g = torch.Generator(device=cuda).manual_seed(3)
    u01 = torch.rand((b, rows, 1), generator=g, device=cuda)
    ni = torch.randn((b, rows, nx), generator=g, device=cuda)
    kw = dict(antithetic=anti, precision=precision)
    n0 = kernels.INTEGRAL.mode_launches.get(precision, 0)
    out = kernels.integral_with_gradients_cuda(0, eq, sol, tx, m, u01, ni,
                                               **kw)
    assert kernels.INTEGRAL.mode_launches[precision] == n0 + 1
    ref = kernels.integral_with_gradients_plain(0, eq, sol, tx, m, u01, ni,
                                                **kw)
    torch.cuda.synchronize()
    tol = RTOL if precision != "default" else ONE_PASS_TOL
    if precision == "default" and b > 256:
        # chip_smoke's wide gate: ONE_PASS_WIDE_TOL scaled by 4096 / m
        # (8192 / m antithetic) at most ONE_PASS_SCALE_CAP times, and under
        # ONE_PASS_CONTROL of the plain version's distance from its bf16x3
        x3 = kernels.integral_with_gradients_plain(
            0, eq, sol, tx, m, u01, ni, antithetic=anti, precision="bf16x3")
        scale = min(max(1.0, (8192 if anti else 4096) / m),
                    ONE_PASS_SCALE_CAP)
        tol = min(ONE_PASS_WIDE_TOL * scale,
                  ONE_PASS_CONTROL * float((x3 - ref).abs().max()))
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    if precision == "highest":
        # the six-pass instance against the three-pass one on the value
        # column (weighted by Tt alone) at a short sum of samples, where the
        # net's precision shows above the f32 sums, from the plain version
        # in f64
        rows = HIGHEST_CONTROL_M // 2 if anti else HIGHEST_CONTROL_M
        u01, ni = u01[:, :rows].contiguous(), ni[:, :rows].contiguous()
        s64 = Solution.from_net(copy.deepcopy(sol.module).double(), "Value",
                                nx)
        ref = kernels.integral_with_gradients_plain(
            0, eq, s64, tx.double(), HIGHEST_CONTROL_M, u01.double(),
            ni.double(), antithetic=anti)[:, 0]
        d6, d3 = (float((kernels.integral_with_gradients_cuda(
            0, eq, sol, tx, HIGHEST_CONTROL_M, u01, ni, antithetic=anti,
            precision=mode)[:, 0].double() - ref).abs().max())
            for mode in ("highest", "bf16x3"))
        assert d6 < HIGHEST_CONTROL * d3, (d6, d3)


@pytest.mark.parametrize("b,m,nx", INTEGRAL_RAGGED)
@pytest.mark.parametrize("precision", kernels.PRECISIONS)
@pytest.mark.parametrize("anti", [False, True])
def test_integral_kernel_draws_equal_the_host_philox_at_ragged_shapes(
        cuda, b, m, nx, precision, anti):
    """Its own draws (the draw warps') at the first and last points equal
    the host Philox's fed to the plain version, and the kernel gives the
    same output twice."""
    seed = (7 << 32) | 5
    eq, sol, tx, *_ = _problem(cuda, b, 1, nx)
    rows = m // 2 if anti else m
    pts = [0, 1, b - 2, b - 1]

    def host(a):
        return torch.from_numpy(a).to(cuda)

    u = host(philox.estimator_times(seed, pts, rows))
    ni = host(philox.estimator_normals(seed, pts, rows, nx,
                                       philox.STREAM_INTEGRAL))
    kw = dict(antithetic=anti, precision=precision)
    out = kernels.integral_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    ref = kernels.integral_with_gradients_plain(0, eq, sol, tx[pts], m, u,
                                                ni, **kw)
    torch.cuda.synchronize()
    tol = RTOL if precision != "default" else ONE_PASS_TOL
    torch.testing.assert_close(out[pts], ref, rtol=tol, atol=tol)
    assert torch.equal(out, kernels.integral_with_gradients_cuda(
        seed, eq, sol, tx, m, **kw))


@pytest.mark.parametrize("n_hidden", [0, 1, 4, 6])
@pytest.mark.parametrize("precision", kernels.PRECISIONS)
def test_integral_kernel_has_a_plan_at_every_nx(cuda, n_hidden, precision):
    """The built integral kernel has a launch plan within a block's shared
    memory at every nx the wrapper covers (up to 511) in every mode, with a
    ring of 2 to 4 stages where there is a net and both buffers of normals
    in shared memory at path B's nx = 100."""
    for nx in range(1, 512):
        plan = kernels.integral_tc_plan(nx, n_hidden, precision)
        assert plan is not None and plan["smem_bytes"] <= 232448, nx
        assert (2 <= plan["stages"] <= 4) if n_hidden else (
            plan["stages"] == 0), nx
    assert kernels.integral_tc_plan(100, n_hidden, precision)["dw_smem"]


@pytest.mark.parametrize("n_hidden", [0, 1, 2, 4, 6])
def test_merged_kernel_has_a_plan_at_every_nx(cuda, n_hidden):
    """The built merged tensor-core kernel has a launch plan within a
    block's shared memory at every nx the wrapper covers (up to 511), with
    a ring of 2 to 4 stages where there is a net; at path A's (nx = 100,
    4x128) it is the plan whose L2 traffic the CPU tests count
    (tests/test_torch_generate_plan.py: PATH_A_PLAN)."""
    for nx in range(1, 512):
        plan = kernels.library_tc_plan(nx, n_hidden)
        assert plan is not None and plan["smem_bytes"] <= 232448, nx
        assert (2 <= plan["stages"] <= 4) if n_hidden else (
            plan["stages"] == 0), nx
    if n_hidden == 4:
        assert kernels.library_tc_plan(100, 4) == {
            "stages": 4, "save_smem": False, "dw_smem": True,
            "smem_bytes": 189152, "scratch_floats": 2 * 3 * 64 * 128,
            "on_chip": False, "a_staged": False, "stage_bytes": 32768,
            "quad_frags": True}


# ---- the PINN baseline and RESUME on the card ---------------------------

PINN_GPU = {
    "burgers": {"EQUATION": {"cls": "Cha",
                             "kwargs": {"nx": 16, "alpha": 1.0, "k": 1.0,
                                        "T": 1.0}},
                "METHOD": {"cls": "PINN", "num_v_samples": 4},
                "TRAIN": {"BATCH_SIZE": 64, "LOSS": {"beta": 10.0}}},
    "fn": {"EQUATION": {"cls": "GBMEquationComplexExact",
                        "kwargs": {"nx": 16}},
           "METHOD": {"cls": "PINN"},
           "DATA": {"HESSIAN_APPROXIMATION": {"method": "SDGD",
                                              "kwargs": {"v": 16}}},
           "TRAIN": {"BATCH_SIZE": 64, "LOSS": {"beta": 10.0}}},
}
@pytest.mark.parametrize("family", list(PINN_GPU))
def test_pinn_captured_epoch_equals_the_eager_epoch(cuda, tmp_path, family):
    from deeppicarditeration_torch.config import default_cfg
    from deeppicarditeration_torch.training.picard import PicardRunner

    cfg = default_cfg()
    cfg.merge({"NAME": f"pinn_{family}", "FORCE": True,
               "NETWORK": {"NEURONS": [32, 32],
                           "ACTIVATIONS": ["ELU", "ELU"]},
               **PINN_GPU[family]}, allow_new=False)
    runner = PicardRunner(cfg.freeze(), exp_root=tmp_path)
    # chip_smoke's phase 19 comparison: 3 epochs through the epoch's graph
    # against the same epochs run eagerly (the same kernels)
    from chip_smoke import PINN_CAPTURED_REL, pinn_captured_vs_eager

    rel = pinn_captured_vs_eager(runner)
    print(f"PINN {family}: captured vs eager after 3 epochs {rel:.3e}")
    assert rel <= PINN_CAPTURED_REL


@pytest.mark.parametrize("method", ["PINN", "Diffusion"])
def test_resume_on_the_card_equals_an_uninterrupted_run(cuda, tmp_path,
                                                        method):
    """A baseline killed after its first log interval and continued with
    RESUME: its final weights equal an uninterrupted run's (1e-6 of the
    largest magnitude; the resumed run captures its epoch graph anew)."""
    from deeppicarditeration_torch.config import default_cfg
    from deeppicarditeration_torch.training import checkpoint
    from deeppicarditeration_torch.training.picard import PicardRunner

    def cfg(resume):
        c = default_cfg()
        c.merge({"NAME": "resume", "FORCE": True, "RESUME": resume,
                 "EQUATION": {"cls": "Cha",
                              "kwargs": {"nx": 8, "alpha": 1.0, "k": 1.0,
                                         "T": 1.0}},
                 "METHOD": {"cls": method, "K": 5, "dt": 0.05,
                            "num_v_samples": 4},
                 "TRAIN": {"BATCH_SIZE": 64, "N_EPOCHS": 30,
                           "LOSS": {"beta": 10.0}},
                 "NETWORK": {"NEURONS": [32, 32],
                             "ACTIVATIONS": ["ELU", "ELU"]},
                 "EVAL": {"FREQ": 10, "L2_N_POINTS": 200}},
                allow_new=False)
        return c.freeze()

    PicardRunner(cfg(False), exp_root=tmp_path / "whole").run()
    real, calls = checkpoint.save_state, []

    class Stop(Exception):
        pass

    def save_state(*args):
        calls.append(1)
        if len(calls) > 1:
            raise Stop
        real(*args)

    checkpoint.save_state = save_state
    try:
        with pytest.raises(Stop):
            PicardRunner(cfg(False), exp_root=tmp_path / "cut").run()
    finally:
        checkpoint.save_state = real
    resumed = PicardRunner(cfg(True), exp_root=tmp_path / "cut")
    resumed.run()
    assert resumed.graph_replays == 20
    a = checkpoint.read(tmp_path / "whole" / "resume" / "model_1")
    b = checkpoint.read(tmp_path / "cut" / "resume" / "model_1")
    for k in a:
        assert float((a[k] - b[k]).abs().max()) <= 1e-6 * float(
            a[k].abs().max()), k


# ---- high dimension: the merged kernels at nx up to 1024 / 512 -------------

def test_cover_constants_equal_the_built_libraries(cuda):
    """ops/kernels.py's limits, which merged_covers and pis_covers read
    before any launch, are the built kernels' own."""
    dll = kernels.GENERATE.lib()
    widths = (ctypes.c_int * kernels.TC_WIDTHS_CAP)()
    n = dll.dpi_generate_tc_widths(widths)
    assert tuple(widths[:n]) == kernels.GENERATE_TC_WIDTHS
    assert dll.dpi_generate_tc_max_nx() == kernels.GENERATE_TC_MAX_NX
    assert dll.dpi_generate_hidden_width() == kernels.GENERATE_FMA_WIDTH
    assert dll.dpi_generate_max_nx() == kernels.GENERATE_FMA_MAX_NX
    pis = kernels.GENERATE_PIS.lib()
    assert pis.dpi_generate_pis_max_nx() == kernels.PIS_MAX_NX
    assert pis.dpi_generate_pis_hidden_width() == kernels.PIS_WIDTH
    assert pis.dpi_generate_pis_channels() == kernels.PIS_CHANNELS


def test_merged_plans_at_the_high_dimension_paths(cuda):
    """The built kernel's plans at paths R's and S's shapes are the ones
    whose L2 traffic the CPU tests count
    (tests/test_torch_generate_plan.py: PATH_R_PLAN, PATH_S_PLAN; S's
    width-256 instance keeps its layer chain on chip, a ring of 4 stages
    beside it, and only the saved derivatives in scratch); every nx up to
    1024 has one at every width."""
    assert kernels.library_tc_plan(512, 4) == {
        "stages": 4, "save_smem": False, "dw_smem": False,
        "smem_bytes": 151136,
        "scratch_floats": 2 * 3 * 64 * 128 + 2 * 64 * 512,
        "on_chip": False, "a_staged": False, "stage_bytes": 32768,
        "quad_frags": True}
    assert kernels.library_tc_plan(1024, 4, width=256) == {
        "stages": 4, "save_smem": False, "dw_smem": False,
        "smem_bytes": 221840,
        "scratch_floats": 2 * (3 * 64 * 256 + 2 * 64 * 1024),
        "on_chip": True, "a_staged": False, "stage_bytes": 16384,
        "quad_frags": False}
    for width in kernels.GENERATE_TC_WIDTHS:
        for nx in range(1, kernels.GENERATE_TC_MAX_NX + 1, 7):
            plan = kernels.library_tc_plan(nx, 4, width=width)
            assert plan is not None and 2 <= plan["stages"] <= 4, (nx, width)


# The wide pass's plans at paths U, V and W, as
# tests/test_torch_generate_plan.py pins them (PATH_WIDE_PLANS): 4 stages
# of 48 KB under bf16x3, 8 of 24 KB under "default" (the producer staging
# both tiles' A beside the weights), the rest of shared memory the point's
# x, the tiles' rows, the terminal warps' sums and the barriers; in
# scratch each warpgroup's saved derivatives, two images of layer outputs,
# its tile's normals and layer 1's input image
@pytest.mark.parametrize("precision,stages,stage_bytes", [
    ("bf16x3", 4, 49152), ("default", 8, 24576)])
@pytest.mark.parametrize("nx,n_hidden,width,rest", [
    (100, 4, 512, 6952), (256, 6, 512, 11944), (512, 2, 1024, 20168)])
def test_merged_plans_at_the_matrix_paths(cuda, nx, n_hidden, width, rest,
                                          precision, stages, stage_bytes):
    assert kernels.library_tc_plan(nx, n_hidden, width=width,
                                   precision=precision) == {
        "stages": stages, "save_smem": False, "dw_smem": False,
        "smem_bytes": 4 * 49152 + rest,
        "scratch_floats": 2 * ((n_hidden + 1) * 64 * width + 64 * nx
                               + 64 * kernels.tc_k1(nx)),
        "on_chip": False, "a_staged": True, "stage_bytes": stage_bytes,
        "quad_frags": False}


# the PIS kernel's plans at paths H's and T's shapes, as
# tests/test_torch_generate_plan.py pins them (PATH_H_PIS_PLAN,
# PATH_T_PIS_PLAN): the narrow instance's at H in either mode; the wide
# instance's at T, 4 ring stages under "default" and 3 under bf16x3
_PIS_H = {"stages": 4, "dw_smem": True, "smem_bytes": 231840,
          "scratch_floats": 64 * 128 + 4 * 64 * 512, "term_strips": 0,
          "scratch_strips": 0, "term_sums_smem": True, "producer_regs": 40,
          "consumer_regs": 232, "normals_reads": 0, "w_term_scratch": False}
_PIS_T = {"dw_smem": False,
          "scratch_floats": (64 + 4 * 64 + 2 * 64 + 3) * 512 + 3 * 513 + 1,
          "term_strips": 0, "scratch_strips": 3, "term_sums_smem": False,
          "producer_regs": 56, "consumer_regs": 224, "normals_reads": 4,
          "w_term_scratch": True}


@pytest.mark.parametrize("precision,stages,smem", [
    ("default", 4, 231344), ("bf16x3", 3, 223152)])
def test_pis_plans_at_paths_h_and_t(cuda, precision, stages, smem):
    """The built PIS kernel's plans at paths H's and T's shapes are the
    ones whose L2 traffic the CPU tests count; every nx up to 512 has one
    in either mode."""
    assert kernels.library_pis_plan(100, 4, precision) == _PIS_H
    assert kernels.library_pis_plan(512, 4, precision) == {
        **_PIS_T, "stages": stages, "smem_bytes": smem}
    for nx in range(1, kernels.PIS_MAX_NX + 1, 7):
        plan = kernels.library_pis_plan(nx, 4, precision)
        assert plan is not None and plan["stages"] >= 2, nx


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("nx,width,n_hidden,m", [
    (512, 128, 4, 128), (1024, 128, 2, 100), (1024, 256, 4, 128),
    (513, 256, 1, 64), (1000, 256, 3, 70), (100, 256, 2, 130)])
def test_merged_kernel_at_high_dimension_matches_plain(cuda, precision, anti,
                                                       nx, width, n_hidden,
                                                       m):
    """The tensor-core kernel at nx 512-1024, widths 128 and 256 (the
    width-256 pass), against the plain version in the same mode on the
    same noise; a ragged last tile and nx off the 64-column slabs."""
    b, rows = 8, m // 2 if anti else m
    eq, _, tx, u01, nt, ni = _problem(cuda, b, rows, nx, net=False)
    sol = _deep(cuda, nx, (width,) * n_hidden)
    kw = dict(antithetic=anti, precision=precision)
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt,
                                               ni, **kw)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, **kw)
    torch.cuda.synchronize()
    tol = ONE_PASS_TOL if precision == "default" else RTOL
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


# points of the matrix widths' cases by M: 140 at M = 130, off the grid of
# 132 blocks (eight blocks take two points), else 8
MATRIX_B = {130: 140}


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("nx,width,n_hidden,m", [
    (256, 64, 3, 128), (33, 64, 1, 70), (100, 64, 6, 64),
    (100, 512, 4, 128), (256, 512, 6, 64), (512, 1024, 2, 128),
    (7, 1024, 1, 64), (100, 384, 3, 70), (1024, 896, 2, 64),
    (100, 640, 3, 128), (300, 768, 2, 70), (1024, 512, 2, 64),
    (256, 512, 4, 136), (100, 1024, 2, 130)])
def test_merged_kernel_at_the_matrix_widths_matches_plain(cuda, precision,
                                                          anti, nx, width,
                                                          n_hidden, m):
    """The tensor-core kernel at the JAX package's dispatcher-matrix nets
    (3x64, 4x512, 6x512, 2x1024: the width-64 pass and the wide pass's
    column blocks) and at other depths and widths of both passes (one
    hidden layer, 384, 640 and 896: a last block of 128 columns, 768),
    width 512 at nx 1024 (the wide pass's ring at its fewest stages), M
    off the 64-sample tiles with an odd count of them (136: the second
    warpgroup's last tile empty) and B off the grid (MATRIX_B), against the
    plain version in the same mode on the same noise."""
    b, rows = MATRIX_B.get(m, 8), m // 2 if anti else m
    eq, _, tx, u01, nt, ni = _problem(cuda, b, rows, nx, net=False)
    sol = _deep(cuda, nx, (width,) * n_hidden)
    assert kernels.merged_covers(eq, sol, precision) is None
    kw = dict(antithetic=anti, precision=precision)
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt,
                                               ni, **kw)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, **kw)
    torch.cuda.synchronize()
    tol = ONE_PASS_TOL if precision == "default" else RTOL
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("width", [64, 128, 256, 512, 1024])
def test_merged_kernel_draws_equal_the_host_philox_at_1024(cuda, width):
    b, m, nx = 4, 128, 1024
    eq, _, tx, *_ = _problem(cuda, b, 1, nx, net=False)
    sol = _deep(cuda, nx, (width,) * 2)
    seed, pts = (7 << 32) | 5, [0, b - 1]
    draws = [torch.from_numpy(a).to(cuda) for a in (
        philox.estimator_times(seed, pts, m),
        philox.estimator_normals(seed, pts, m, nx, philox.STREAM_TERMINAL),
        philox.estimator_normals(seed, pts, m, nx, philox.STREAM_INTEGRAL))]
    out = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m,
                                               precision="bf16x3")[pts]
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx[pts], m,
                                                *draws, precision="bf16x3")
    torch.testing.assert_close(out, ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("nx,width,n_hidden", [
    (512, 1024, 2), (100, 512, 4), (37, 640, 1), (100, 384, 3)])
def test_merged_wide_pass_is_deterministic(cuda, precision, anti, nx, width,
                                           n_hidden):
    """The wide pass launched twice on its own draws gives the same output
    bit for bit, with two points on some blocks (B = 140) and a ragged
    last tile (M = 200): every sum runs in a fixed order, and each layer's
    input is complete before the producer stages it (a last block of 128
    columns at 640 and 384)."""
    b, m = 140, 200
    eq, _, tx, *_ = _problem(cuda, b, 1, nx, net=False)
    sol = _deep(cuda, nx, (width,) * n_hidden)
    kw = dict(antithetic=anti, precision=precision)
    seed = (5 << 32) | 9
    first = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    second = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


# the width-128 instance at high nx (layer 1 drawing its normals into its A
# fragments, the terminal chain one warp a draw): nx off and on the 64-
# and 4-column grids, 1024 its last; B = 140, off the grid of 132 blocks
# (eight blocks take two points); M = 136, three tiles (the second
# warpgroup's last one empty) and the last one ragged
WIDTH128_NX = [511, 512, 513, 1000, 1024]
WIDTH128_B, WIDTH128_M = 140, 136


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("nx", WIDTH128_NX)
def test_merged_width128_matches_plain_at_high_nx(cuda, precision, anti, nx):
    """The width-128 instance on external noise against the plain version
    in the same mode (4x128 ELU net)."""
    b, m = WIDTH128_B, WIDTH128_M
    rows = m // 2 if anti else m
    eq, sol, tx, u01, nt, ni = _problem(cuda, b, rows, nx)
    kw = dict(antithetic=anti, precision=precision)
    out = kernels.generate_with_gradients_cuda(0, eq, sol, tx, m, u01, nt,
                                               ni, **kw)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, **kw)
    torch.cuda.synchronize()
    tol = RTOL if precision == "bf16x3" else ONE_PASS_TOL
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("nx", WIDTH128_NX)
def test_merged_width128_draws_equal_the_host_philox_at_high_nx(cuda, anti,
                                                                nx):
    """The width-128 instance's own draws at the first and last points
    (keyed by their rows in the launch) equal the host Philox's fed to the
    plain version, bf16x3."""
    b, m, seed = WIDTH128_B, WIDTH128_M, (7 << 32) | 5
    eq, sol, tx, *_ = _problem(cuda, b, 1, nx)
    rows = m // 2 if anti else m
    pts = [0, 1, b - 2, b - 1]
    draws = [torch.from_numpy(a).to(cuda) for a in (
        philox.estimator_times(seed, pts, rows),
        philox.estimator_normals(seed, pts, rows, nx, philox.STREAM_TERMINAL),
        philox.estimator_normals(seed, pts, rows, nx,
                                 philox.STREAM_INTEGRAL))]
    kw = dict(antithetic=anti, precision="bf16x3")
    out = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx[pts], m,
                                                *draws, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[pts], ref, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("precision", ["bf16x3", "default"])
@pytest.mark.parametrize("anti", [False, True])
@pytest.mark.parametrize("nx", WIDTH128_NX)
def test_merged_width128_is_deterministic(cuda, precision, anti, nx):
    """The width-128 instance launched twice on its own draws gives the
    same output bit for bit: every sum (the terminal warps' and the
    consumers') runs in a fixed order."""
    b, m = WIDTH128_B, WIDTH128_M
    eq, sol, tx, *_ = _problem(cuda, b, 1, nx)
    kw = dict(antithetic=anti, precision=precision)
    seed = (5 << 32) | 9
    first = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    second = kernels.generate_with_gradients_cuda(seed, eq, sol, tx, m, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all()
    assert torch.equal(first, second)


# points of the wide instance's cases by M: 140 at M = 200, off the grid of
# 132 blocks (eight blocks take two points), else 8
PIS_HIGHD_B = {200: 140}


@pytest.mark.parametrize("precision", ["default", "bf16x3"])
@pytest.mark.parametrize("net,m,nx", [(True, 100, 512), (True, 64, 136),
                                      (False, 64, 512), (True, 70, 301),
                                      (True, 100, 129), (True, 70, 300),
                                      (True, 100, 511), (True, 200, 512),
                                      (False, 200, 300)])
def test_pis_kernel_at_high_dimension_matches_plain(cuda, precision, net, m,
                                                    nx):
    """The PIS kernel's wide instance (nx > 128: the head and the x columns
    of N_0^T 512 rows, the tile's normals and the terminal sums in global
    scratch, the terminal chain one warp a draw) against the plain version
    at nx 129-512, M off the 64-sample tiles and B off the grid
    (PIS_HIGHD_B); the zero iterate's terminal chain on the consumers."""
    eq, sol, tx, u01, nt, ni = _pis_problem(cuda, PIS_HIGHD_B.get(m, 8), m,
                                            nx, net)
    out = kernels.generate_pis_cuda(0, eq, sol, tx, m, u01, nt, ni,
                                    precision=precision)
    ref = kernels.generate_with_gradients_plain(0, eq, sol, tx, m, u01, nt,
                                                ni, precision=precision)
    torch.cuda.synchronize()
    tol = {"default": 1e-3, "bf16x3": 1e-4}[precision]
    for cols in (slice(0, 1), slice(1, None)):
        rel = float((out[:, cols] - ref[:, cols]).abs().max()) / max(
            float(ref[:, cols].abs().max()), 1.0)
        assert rel <= tol, (cols, rel)


def test_past_the_limits_raises_before_any_launch(cuda):
    """nx = 1025 (the merged kernel), nx = 512 in "highest" (its FP32-FMA
    pass) and nx = 513 (the PIS kernel): NotImplementedError from the
    structure, and no launch."""
    n0, p0 = kernels.GENERATE.launches, kernels.GENERATE_PIS.launches
    for nx, precision in ((kernels.GENERATE_TC_MAX_NX + 1, "bf16x3"),
                          (512, "highest")):
        eq, _, tx, *_ = _problem(cuda, 2, 1, nx, net=False)
        with pytest.raises(NotImplementedError, match="exceeds"):
            kernels.generate_with_gradients_cuda(
                0, eq, _deep(cuda, nx, (128,)), tx, 64, precision=precision)
    eq, _, tx, *_ = _pis_problem(cuda, 2, 1, kernels.PIS_MAX_NX + 1, False)
    with pytest.raises(NotImplementedError, match="exceeds"):
        kernels.generate_pis_cuda(0, eq, Solution.zero(eq.nx), tx, 64,
                                  precision="default")
    assert (kernels.GENERATE.launches, kernels.GENERATE_PIS.launches) == (
        n0, p0)
