"""The port's Brownian path rollout (``ops/rollout.py``) and the rollout
kernel's plain version against the JAX package's ``ops/rollout.py``; the
kernel's seed table; the kernel's source built for the host.

Both sides get the same increments: the test recreates JAX's closed-form
draw ``jax.random.normal(key, (K, B, nx))`` and hands it to the port. On the
CPU JAX's ``_paths_pallas`` takes the closed form with the same key, so the
draw is the same for ``use_pallas`` False and True. xs is x0 + a cumulative
sum of f32 steps on both sides, in the same order: rtol = atol = 1e-6.
An equation that overrides ``transition`` takes the sequential loop, whose
draws come from different generators on the two sides: its law is checked.
"""

import pathlib
import re
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeppicarditeration_tpu.equations import make_equation as jax_make_equation
from deeppicarditeration_tpu.ops.rollout import (
    brownian_paths as jax_brownian_paths,
)
from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.ops import kernels, philox
from deeppicarditeration_torch.ops import rollout
from test_torch_terminal import _HOST_RUNTIME, _host_cxx

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(b=16, nx=5, K=6, dt=0.05, seed=0):
    """t0 in [0, 1): the rows with t0 + K dt > T take the tail-shrunk step,
    as the D-DBSDE baseline makes them."""
    rng = np.random.default_rng(seed)
    t0 = rng.uniform(0.0, 1.0, size=(b, 1)).astype(np.float32)
    x0 = rng.normal(size=(b, nx)).astype(np.float32)
    dts = np.where(t0 + K * dt <= 1.0, np.float32(dt),
                   (1.0 - t0) / K).astype(np.float32)
    assert (dts < dt).any() and (dts == np.float32(dt)).any()
    return t0, x0, dts


@pytest.mark.parametrize("use_pallas", [False, True])
def test_paths_match_jax_on_the_same_draws(use_pallas):
    b, nx, K, alpha = 16, 5, 6, 1.3
    t0, x0, dts = _inputs(b, nx, K)
    key = jax.random.PRNGKey(3)
    jeq = jax_make_equation("Cha", nx=nx, alpha=alpha, k=1.0, T=1.0)
    jts, jxs, jxi = jax_brownian_paths(key, jeq, jnp.asarray(t0),
                                       jnp.asarray(x0), jnp.asarray(dts), K,
                                       use_pallas=use_pallas)
    xi = np.array(jax.random.normal(key, (K, b, nx), jnp.float32))
    np.testing.assert_array_equal(np.asarray(jxi), xi)  # the recreated draw

    teq = make_equation("Cha", nx=nx, alpha=alpha, k=1.0, T=1.0)
    ts, xs, txi = rollout.brownian_paths(
        None, teq, torch.from_numpy(t0), torch.from_numpy(x0),
        torch.from_numpy(dts), K, xi=torch.from_numpy(xi))
    assert ts.shape == (K + 1, b, 1) and xs.shape == (K + 1, b, nx)
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), **TOL)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), **TOL)
    np.testing.assert_array_equal(txi.numpy(), xi)
    # the kernel's plain version on the same draws
    pxs, _ = kernels.paths_plain(0, torch.from_numpy(x0),
                                 torch.from_numpy(np.sqrt(dts)),
                                 teq.alpha_sqrt, K, torch.from_numpy(xi))
    np.testing.assert_allclose(pxs.numpy(), np.asarray(jxs), **TOL)


def test_use_pallas_on_cpu_takes_the_kernels_plain_version():
    """On CPU tensors ``use_pallas`` reaches ``paths_cuda``, which takes the
    plain version with a torch.Generator seeded by the kernel's seed; no
    launch is counted."""
    b, nx, K = 8, 3, 5
    t0, x0, dts = (torch.from_numpy(a) for a in _inputs(b, nx, K))
    eq = make_equation("Cha", nx=nx, alpha=2.0, k=1.0, T=1.0)
    n0 = kernels.ROLLOUT.launches
    _, xs, xi = rollout.brownian_paths(None, eq, t0, x0, dts, K,
                                       use_pallas=True, seed=77)
    assert kernels.ROLLOUT.launches == n0
    ref_xs, ref_xi = kernels.paths_plain(77, x0, dts.sqrt(), eq.alpha_sqrt,
                                         K)
    assert torch.equal(xs, ref_xs) and torch.equal(xi, ref_xi)
    # the closed form with a generator of the same seed draws the same
    g = torch.Generator().manual_seed(77)
    _, xs2, _ = rollout.brownian_paths(g, eq, t0, x0, dts, K)
    assert torch.equal(xs2, xs)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_increment_relation_and_time_grid(use_pallas):
    """X_{k+1} - X_k = sqrt(dt) sqrt(alpha) xi_k and ts = t0 + k dts, as
    the JAX package's tests/test_rollout.py asks of its rollout."""
    b, nx, K = 32, 4, 7
    t0, x0, dts = (torch.from_numpy(a) for a in _inputs(b, nx, K, 0.05, 1))
    eq = make_equation("Cha", nx=nx, alpha=1.3, k=1.0, T=1.0)
    ts, xs, xi = rollout.brownian_paths(torch.Generator().manual_seed(1),
                                        eq, t0, x0, dts, K,
                                        use_pallas=use_pallas, seed=5)
    torch.testing.assert_close(ts[3], t0 + 3 * dts, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(xs[1:] - xs[:-1],
                               dts.sqrt()[None] * eq.alpha_sqrt * xi,
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(xs[0], x0)


def test_fallback_for_an_overridden_transition():
    """An equation that overrides transition (here a drift) takes the
    sequential loop through its own law, also under use_pallas: the drift
    shows, E[x_K - x_0] = K dt 1.5, on both sides (the JAX package's
    tests/test_rollout.py:47-66)."""
    b, nx, K, dt = 8, 3, 4, 0.1

    teq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)

    class Drifted(type(teq)):
        def transition(self, generator, t, s, x):
            dw = torch.randn(x.shape, generator=generator, dtype=x.dtype)
            return x + (s - t) * 1.5 + torch.sqrt(s - t) * dw, dw

    eq2 = Drifted(**{f: getattr(teq, f)
                     for f in teq.__dataclass_fields__})
    assert not rollout.uses_base_transition(eq2)
    assert rollout.uses_base_transition(teq)
    g = torch.Generator().manual_seed(9)
    t0 = torch.rand((b, 1), generator=g) * 0.5
    x0 = torch.randn((b, nx), generator=g)
    dts = torch.full_like(t0, dt)
    n0 = kernels.ROLLOUT.launches
    for use_pallas in (False, True):
        ts, xs, xi = rollout.brownian_paths(g, eq2, t0, x0, dts, K,
                                            use_pallas=use_pallas)
        assert xs.shape == (K + 1, b, nx) and xi.shape == (K, b, nx)
        drift = float((xs[-1] - xs[0]).mean())
        assert abs(drift - K * dt * 1.5) < 0.25, drift
        torch.testing.assert_close(xs[1:] - xs[:-1],
                                   dts[None] * 1.5 + dts.sqrt()[None] * xi,
                                   rtol=1e-5, atol=1e-6)
    assert kernels.ROLLOUT.launches == n0

    # the JAX package's fallback shows the same drift
    jeq = jax_make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)

    class JaxDrifted(type(jeq)):
        def transition(self, k, t, s, x):
            dw = jax.random.normal(k, x.shape, x.dtype)
            return x + (s - t) * 1.5 + jnp.sqrt(s - t) * dw, dw

    jeq2 = JaxDrifted(**{f: getattr(jeq, f)
                         for f in jeq.__dataclass_fields__})
    _, jxs, _ = jax_brownian_paths(jax.random.PRNGKey(9), jeq2,
                                   jnp.asarray(t0.numpy()),
                                   jnp.asarray(x0.numpy()),
                                   jnp.asarray(dts.numpy()), K)
    jdrift = float(jnp.mean(jxs[-1] - jxs[0]))
    assert abs(jdrift - K * dt * 1.5) < 0.25, jdrift


def test_closed_form_law_of_the_endpoint():
    """X_K ~ N(x0, alpha K dt I): the closed form's endpoint moments within
    CLT bounds, as for the JAX package's closed form."""
    b, nx, K, dt = 4096, 3, 10, 0.02
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=1.0, T=1.0)
    t0 = torch.zeros((b, 1))
    _, xs, _ = rollout.brownian_paths(torch.Generator().manual_seed(2), eq,
                                      t0, torch.zeros((b, nx)),
                                      torch.full_like(t0, dt), K)
    xk = xs[-1].double()
    var = K * dt
    assert abs(float(xk.mean())) < 4 * (var / (b * nx)) ** 0.5
    np.testing.assert_allclose(float(xk.var()), var, rtol=0.15)


# ---- the seed table ----------------------------------------------------------

@pytest.mark.parametrize("b,nx,K", [(16, 5, 6), (511, 7, 9)])
def test_plain_version_with_a_seed_table_draws_the_selected_seed(b, nx, K):
    """A launch with a seed table draws what a launch with the int seed at
    its index draws, and advances the index: three launches take entries
    0, 1, 2 (a seed above 2^63 included: the table holds its int64 bit
    pattern). B = 511, nx = 7 is a ragged shape of the kernel's tiles."""
    t0, x0, dts = (torch.from_numpy(a) for a in _inputs(b, nx, K))
    sdt = dts.sqrt()
    seeds = [77, (1 << 64) - 3, (7 << 32) | 5]
    table = kernels.SeedTable(4, "cpu")
    table.fill(seeds)
    n0 = kernels.ROLLOUT.launches
    for i, seed in enumerate(seeds):
        assert int(table.index[0]) == i
        xs, xi = kernels.paths_cuda(table, x0, sdt, 1.3, K)
        ref_xs, ref_xi = kernels.paths_plain(seed, x0, sdt, 1.3, K)
        assert torch.equal(xs, ref_xs) and torch.equal(xi, ref_xi)
    assert int(table.index[0]) == 3 and kernels.ROLLOUT.launches == n0
    # through brownian_paths, into the caller's buffers
    table.fill(seeds[1:])
    out = (torch.empty(K + 1, b, nx), torch.empty(K, b, nx))
    eq = make_equation("Cha", nx=nx, alpha=1.3 ** 2, k=1.0, T=1.0)
    _, xs, _ = rollout.brownian_paths(None, eq, t0, x0, dts, K,
                                      use_pallas=True, seed=table, out=out)
    assert xs is out[0]
    torch.testing.assert_close(
        xs, kernels.paths_plain(seeds[1], x0, sdt, eq.alpha_sqrt, K)[0],
        rtol=0, atol=0)


def test_seed_table_fill_checks_its_size():
    table = kernels.SeedTable(2, "cpu")
    with pytest.raises(ValueError):
        table.fill([1, 2, 3])
    with pytest.raises(ValueError):
        table.fill([])
    table.fill([5])
    assert table.take() == 5 and int(table.index[0]) == 1


# ---- the kernel's source on the host ---------------------------------------
# csrc/rollout.cu compiled by a host C++20 compiler against the stand-in CUDA
# runtime of tests/test_torch_terminal.py (a block's threads are
# std::threads, __syncthreads a barrier; shared memory starts as NaNs), so
# that its tiles, step chunks, masks, 16-byte and element stores and seed
# table are held against the host Philox and the plain version without a
# card. logf and sincosf are the C library's, so the draws agree with the
# host Philox's to a few float32 ulps (the card tests hold the card's).

_ROLLOUT_RUNTIME = _HOST_RUNTIME + r"""
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline void __trap() { std::abort(); }
inline dim3 gridDim;
template <class F, class... A>
void host_launch_v(F kernel, int grid, int threads, A... args) {
  blockDim.x = threads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    HostBlock blk;
    blk.all = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      blk.warp.push_back(std::make_unique<std::barrier<>>(32));
    memset(g_smem, 0xff, sizeof g_smem);
    g_block = &blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""

_ROLLOUT_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "rollout_host.cu"
// argv: in.bin out.bin; in: int rows, nx, K, mode (0 immediate seed, 1 seed
// table[index], 2 immediate with outputs one float off 16-byte alignment),
// index; u64 seed (or the table's 4 entries); f32 alpha_sqrt; x0[rows nx],
// sqrt_dts[rows]. out: xs[(K + 1) rows nx], xi[K rows nx]. Or argv:
// "smem K": dpi_paths_smem_bytes(K).
int main(int argc, char** argv) {
  if (argc == 3 && argv[1][0] == 's') {
    printf("%lld\n", dpi_paths_smem_bytes(atoi(argv[2])));
    return 0;
  }
  FILE* f = fopen(argv[1], "rb");
  int h[5]; long long seeds[4]; float a;
  if (fread(h, 4, 5, f) != 5 || fread(seeds, 8, 4, f) != 4 ||
      fread(&a, 4, 1, f) != 1) return 2;
  const int rows = h[0], nx = h[1], K = h[2], mode = h[3];
  const long long index = h[4];
  const size_t n = (size_t)rows * nx;
  std::vector<float> x0(n), sdt(rows), xs(n * (K + 1) + 4), xi(n * K + 4);
  if (fread(x0.data(), 4, n, f) != n ||
      fread(sdt.data(), 4, rows, f) != (size_t)rows) return 2;
  fclose(f);
  const int off = mode == 2 ? 1 : 0;
  const int rc = dpi_paths(
      x0.data(), sdt.data(), xs.data() + off, xi.data() + off, rows, nx, K,
      (unsigned long long)seeds[0], mode == 1 ? seeds : nullptr,
      mode == 1 ? &index : nullptr, 4, a, nullptr);
  f = fopen(argv[2], "wb");
  fwrite(xs.data() + off, 4, n * (K + 1), f);
  fwrite(xi.data() + off, 4, n * K, f);
  fclose(f);
  return rc;
}
"""


@pytest.fixture(scope="module")
def host_rollout(tmp_path_factory):
    gxx = _host_cxx()
    if gxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to build the "
                    "kernel's source on the host")
    d = tmp_path_factory.mktemp("rollout_host")
    src = kernels.ROLLOUT.source.read_text()
    swaps = [("extern __shared__ float4 smem4[];",
              "float4* smem4 = reinterpret_cast<float4*>(g_smem);")]
    for old, new in swaps:
        assert old in src, old
        src = src.replace(old, new)
    src, n = re.subn(r"paths_kernel<<<\(unsigned\)blocks, (.*?),.*?>>>\(",
                     r"host_launch_v(paths_kernel, (int)blocks, \1, ",
                     src, flags=re.S)
    assert n == 1
    (d / "cuda_runtime.h").write_text(_ROLLOUT_RUNTIME)
    (d / "rollout_host.cu").write_text(src)
    (d / "main.cpp").write_text(_ROLLOUT_MAIN)
    exe = d / "rollout_host"
    subprocess.run([gxx, "-std=c++20", "-O1", f"-I{d}",
                    f"-I{pathlib.Path(kernels.CSRC_DIR)}", "-include",
                    "cuda_runtime.h", "-o", str(exe), str(d / "main.cpp"),
                    "-lpthread"], check=True, capture_output=True)
    return exe


def _host_run(exe, tmp_path, rows, nx, K, mode, seeds, index=0, alpha=1.3):
    rng = np.random.default_rng(rows * nx + K)
    x0 = rng.normal(size=(rows, nx)).astype(np.float32)
    sdt = np.sqrt(rng.uniform(0.001, 0.02, (rows, 1))).astype(np.float32)
    table = np.array((list(seeds) + [0] * 4)[:4], np.uint64)
    blob = (np.array([rows, nx, K, mode, index], np.int32).tobytes()
            + table.tobytes() + np.array([alpha], np.float32).tobytes()
            + x0.tobytes() + sdt.tobytes())
    (tmp_path / "in.bin").write_bytes(blob)
    subprocess.run([str(exe), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    out = np.fromfile(tmp_path / "out.bin", np.float32)
    n = rows * nx
    xs = out[:n * (K + 1)].reshape(K + 1, rows, nx)
    xi = out[n * (K + 1):].reshape(K, rows, nx)
    return torch.from_numpy(x0), torch.from_numpy(sdt), xs, xi


@pytest.mark.parametrize("rows,nx,K,mode", [
    (4, 50, 20, 0),    # n % 4 == 0: 16-byte stores, a ragged last tile
    (5, 7, 9, 0),      # n = 35: ragged tiles, K not a multiple of 4
    (3, 100, 50, 0),   # the DBDP recipes' K in one chunk
    (2, 40, 130, 0),   # three step chunks (64 + 64 + 2)
    (4, 48, 13, 2),    # outputs off 16-byte alignment: element stores
    (5, 7, 6, 1),      # the seed from the table at index 2
    (2, 3, 0, 0)])     # K = 0: xs = x0 alone
def test_host_build_of_the_kernel_matches_the_host_philox_and_plain(
        host_rollout, tmp_path, rows, nx, K, mode):
    """The kernel's source, built for the host: its draws are the host
    Philox's (philox.path_normals, the card's reference) to 1e-5, its
    states the plain version's on those draws to 1e-6, xs[0] = x0."""
    seeds = [(7 << 32) | 5, 11, (1 << 64) - 9, 3]
    x0, sdt, xs, xi = _host_run(host_rollout, tmp_path, rows, nx, K, mode,
                                seeds, index=2)
    seed = seeds[2] if mode == 1 else seeds[0]
    host = philox.path_normals(seed, K, rows, nx)
    np.testing.assert_allclose(xi, host, rtol=1e-5, atol=1e-5)
    ref, _ = kernels.paths_plain(0, x0, sdt, 1.3, K, torch.from_numpy(xi))
    np.testing.assert_allclose(xs, ref.numpy(), rtol=1e-6, atol=1e-6)
    assert np.array_equal(xs[0], x0.numpy())


def test_host_build_shared_memory_per_block(host_rollout):
    """Two slabs of min(K, 64) steps x 32 columns of f32: 12.8 KB at the
    DBDP recipes' K = 50, so that 16 blocks of 128 threads (a full SM's
    threads) fit an SM's 228 KB; at most 16 KB."""
    def smem(K):
        return int(subprocess.run([str(host_rollout), "s", str(K)],
                                  check=True, capture_output=True,
                                  text=True).stdout)

    assert smem(0) == 0 and smem(20) == 5120 and smem(50) == 12800
    assert smem(64) == smem(1000) == 16384 <= kernels.MAX_SMEM_BYTES
    assert 16 * (smem(50) + 1024) <= 233472
