"""The standalone terminal kernel's host side, on the CPU.

* the kernel's launch plan (``csrc/terminal.cu``: quads per lane, warps
  per block, tile stride, shared memory), read from its source built for
  the host (below) at every nx it covers: shared memory within a block's
  limit, tiles whose 128-bit stores are conflict-free, quads per lane that
  cover nx; no plan (-1, where the wrapper raises) outside 1 <= nx <= 512.
  The card test ``test_terminal_plan_is_the_kernels`` reads the built
  kernel's.
* ``probe_roofline.sass_mix``: the instruction mix per normal of the
  kernel's draw loop, read from a small SASS listing.
* the wrapper on CPU tensors is the plain version, which
  ``tests/test_torch_split.py`` holds against the JAX kernel.
* the kernel's source built with a host C++ compiler against a stand-in
  CUDA runtime, held against the plain version and philox.cuh.
"""

import os
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from deeppicarditeration_torch.equations import make_equation
from deeppicarditeration_torch.ops import kernels, philox
from deeppicarditeration_torch.utils import probe_roofline

torch.set_num_threads(1)

# an SM's shared memory (233,472 bytes) and what the runtime keeps per block
SM_SMEM_BYTES, RESERVED_PER_BLOCK = 233472, 1024


def _sass(name, lines):
    """A ``cuobjdump -sass`` listing of function ``name``: ``lines`` are
    instructions, a branch's target given as an index into ``lines``."""
    out = [f"\t\tFunction : {name}"]
    for k, line in enumerate(lines):
        ins, target = line if isinstance(line, tuple) else (line, None)
        if target is not None:
            ins = f"{ins} 0x{16 * target:x}"
        out.append(f"        /*{16 * k:04x}*/ {ins} ;")
    return "\n".join(out) + "\n"


_IMAD = "IMAD.WIDE.U32 R2, R3, R4, RZ"
_SASS = _sass(
    "_ZN4_GLOBAL_15terminal_kernelILi2EEEvNS_6ParamsE",
    ["STS.128 [R8], R4", "MUFU.RSQ R6, R5", "MUFU.RSQ R6, R5"]
    + [_IMAD] * 20 + [("@!P0 BRA", 0)]) + _sass(
    "_ZN4_GLOBAL_15terminal_kernelILi1EEEvNS_6ParamsE",
    ["LDC R1, c[0x0][0x28]",
     _IMAD,                                      # 1: the batch loop
     "LOP3.LUT R5, R2, R3, R4, 0x96, !PT"]      # 2: the draw loop
    + [_IMAD] * 14                               # 3-16
    + ["MUFU.RSQ R6, R5", "MUFU.RSQ R7, R5",     # 17, 18
       "FSETP.GE.AND P1, PT, |R13|, 105615, PT",
       ("@!P1 BRA", 24),                         # 20: over a loop
       "LDG.E.CONSTANT R18, desc[UR6][R30.64]",
       ("@P6 BRA", 21),
       "DMUL R18, R18, UR4",
       "ISETP.GT.U32.AND P0, PT, R13, 0x727fffff, PT",
       ("@!P0 BRA", 28),                         # 25: over a CALL
       "CALL.REL.NOINC 0x400",
       ("BRA", 29),
       "FFMA R7, R6, R6, R5",
       ("@P2 BRA", 31),                          # 29: over the store
       "STS.128 [R8], R4",
       ("@!P0 BRA", 2),                          # 31
       "LDS.128 R4, [R9]",
       "SHFL.BFLY PT, R3, R2, 0x1, 0x1f",
       ("@!P2 BRA", 1),                          # 34
       "EXIT",
       ("BRA", 36)])


def test_sass_mix_reads_the_fast_path_of_the_draw_loop():
    """The draw loop (2-31: it stores, holds the Box-Muller and has the
    most IMAD) on its fast path: the branches over a loop (20) and over a
    CALL (25) are taken, the one over the store (29) falls through; 25
    instructions over the 4 normals of its one STS. The batch loop (1-34)
    does not store on its own path; the other instantiation does not
    count."""
    mix = probe_roofline.sass_mix(_SASS)
    assert mix["quads_per_iteration"] == 1
    d = mix["draw_loop"]
    assert d["all"] == 25 / 4
    assert (d["int"], d["fp32"], d["sfu"], d["sts"], d["lds"]) == (
        16 / 4, 2 / 4, 2 / 4, 1 / 4, 0)


@pytest.mark.parametrize("old,new", [
    ("STS.128", "STL.128"),             # no loop stores normals
    ("MUFU.RSQ", "FMUL"),               # the loop that stores has no MUFU
    ("MUFU.RSQ R7", "FMUL R7"),         # one Box-Muller for a quad
    ("LOP3.LUT", "STS.128 [R9], R4,")])  # two quads' stores, one Philox
def test_sass_mix_raises_without_the_draws(old, new):
    with pytest.raises(RuntimeError):
        probe_roofline.sass_mix(_SASS.replace(old, new))


def test_terminal_wrapper_on_cpu_is_the_plain_version():
    rng = np.random.default_rng(3)
    nx, b, m = 5, 4, 6
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    t = rng.uniform(0.0, 0.99, (b, 1))
    tx = torch.tensor(np.concatenate([t, rng.normal(size=(b, nx))], 1),
                      dtype=torch.float32)
    noise = torch.tensor(rng.normal(size=(b, m // 2, nx)),
                         dtype=torch.float32)
    n0 = kernels.TERMINAL.launches
    out = kernels.terminal_with_gradients_cuda(0, eq, tx, m, noise,
                                               antithetic=True)
    ref = kernels.terminal_with_gradients_plain(0, eq, tx, m, noise,
                                                antithetic=True)
    assert torch.equal(out, ref)
    assert kernels.TERMINAL.launches == n0


# ---- the kernel's source on the host ---------------------------------------
# csrc/terminal.cu compiled by a host C++20 compiler against a stand-in for the CUDA runtime
# (a block's threads are std::threads; __syncwarp, __syncthreads and the warp
# shuffle are barriers), so that its arithmetic, masks and sums over draws
# are held against the plain version here, and its hoisted Philox against
# philox.cuh's, without a card. Box-Muller's rsqrt is 1 / sqrtf here, and
# logf and sincosf are the C library's, so draws agree with the card's to a
# few float32 ulps (the card test holds them bit for bit).

_HOST_RUNTIME = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
struct uint2 { uint32_t x, y; };
struct uint4 { uint32_t x, y, z, w; };
struct float4 { float x, y, z, w; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return {a, b, c, d};
}
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline int __float2int_rn(float f) { return (int)std::nearbyint(f); }
template <class T> T atomicAdd(T* p, T v) { T o = *p; *p += v; return o; }
struct HostBlock {
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warp;
  std::vector<float> xch;
};
inline HostBlock* g_block = nullptr;
alignas(16) inline float g_smem[1 << 16];
inline void __syncthreads() { g_block->all->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  g_block->warp[threadIdx.x / 32]->arrive_and_wait();
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  g_block->xch[threadIdx.x] = v;
  __syncwarp();
  const float r = g_block->xch[threadIdx.x ^ o];
  __syncwarp();
  return r;
}
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize,
       cudaFuncAttributePreferredSharedMemoryCarveout };
enum { cudaSharedmemCarveoutMaxShared = 100 };
typedef int cudaError_t;
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F, class P>
void host_launch(F kernel, int grid, int threads, const P& p) {
  blockDim.x = threads;
  for (int b = 0; b < grid; ++b) {
    HostBlock blk;
    blk.all = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < threads / 32; ++w)
      blk.warp.push_back(std::make_unique<std::barrier<>>(32));
    blk.xch.assign(threads, 0.0f);
    memset(g_smem, 0xff, sizeof g_smem);  // NaNs: a stale read shows
    g_block = &blk;
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(p);
      });
    for (auto& th : ts) th.join();
  }
}
"""

_HOST_MAIN = r"""
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include "terminal_host.cu"
// argv: in.bin out.bin; in: int B, M, nx, anti, own; u64 seed; f32 T, a, k;
// t[B], x[B nx], g0[B], noise[B rows nx] (absent when own). Or argv:
// "philox": DrawCounter against philox4x32_10, prints the mismatches;
// "plan": MAX_NX, MAX_WARPS, DRAWS, MAX_SMEM, then per nx in 1..MAX_NX
// the launch's quads per lane, warps, tile stride and shared memory;
// "smem N": dpi_terminal_smem_bytes(N).
int main(int argc, char** argv) {
  if (argc == 2 && !strcmp(argv[1], "plan")) {
    printf("%d %d %d %d\n", MAX_NX, MAX_WARPS, DRAWS, MAX_SMEM);
    for (int nx = 1; nx <= MAX_NX; ++nx)
      printf("%d %d %d %d %lld\n", nx, quads_per_lane(nx), warps_for(nx),
             tile_stride(nx), dpi_terminal_smem_bytes(nx));
    return 0;
  }
  if (argc == 3 && !strcmp(argv[1], "smem")) {
    printf("%lld\n", dpi_terminal_smem_bytes(atoi(argv[2])));
    return 0;
  }
  if (argc == 2) {
    std::mt19937 g(1);
    int bad = 0;
    for (int i = 0; i < 100000; ++i) {
      const uint32_t kd = i % 3 ? g() : g() % 8192, q = g() % 4096, hi = g();
      const uint2 key = make_uint2(g(), g());
      const uint4 a = dpi::philox4x32_10(make_uint4(kd, q, 0u, hi), key);
      const uint4 b = DrawCounter(kd, hi, key).bits(q);
      bad += a.x != b.x || a.y != b.y || a.z != b.z || a.w != b.w;
    }
    printf("%d\n", bad);
    return 0;
  }
  FILE* f = fopen(argv[1], "rb");
  int h[5]; unsigned long long seed; float s[3];
  if (fread(h, 4, 5, f) != 5 || fread(&seed, 8, 1, f) != 1 ||
      fread(s, 4, 3, f) != 3) return 2;
  const int B = h[0], M = h[1], nx = h[2], anti = h[3], own = h[4];
  const size_t rows = anti ? M / 2 : M;
  std::vector<float> t(B), x((size_t)B * nx), g0(B),
      noise(own ? 0 : (size_t)B * rows * nx), out((size_t)B * (1 + nx));
  if (fread(t.data(), 4, t.size(), f) != t.size() ||
      fread(x.data(), 4, x.size(), f) != x.size() ||
      fread(g0.data(), 4, g0.size(), f) != g0.size() ||
      fread(noise.data(), 4, noise.size(), f) != noise.size()) return 2;
  fclose(f);
  const int rc = dpi_terminal(t.data(), x.data(), g0.data(),
                              own ? nullptr : noise.data(), out.data(), B, M,
                              nx, anti, seed, s[0], s[1], s[2], nullptr);
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return rc;
}
"""


def _host_cxx():
    """A host C++ compiler: g++, c++, or a target-prefixed g++-N."""
    for name in ("g++", "c++"):
        if shutil.which(name):
            return shutil.which(name)
    for d in os.environ.get("PATH", "").split(os.pathsep):
        found = sorted(pathlib.Path(d).glob("*-linux-gnu-g++-*")) if d \
            else []
        if found:
            return str(found[-1])
    return None


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = _host_cxx()
    if gxx is None:
        pytest.skip("needs a host C++20 compiler (g++) to build the "
                    "kernel's source on the host")
    d = tmp_path_factory.mktemp("terminal_host")
    src = kernels.TERMINAL.source.read_text()
    swaps = [
        ("extern __shared__ __align__(16) float smem[];",
         "float* smem = g_smem;"),
        ("terminal_kernel<QPL><<<p.B, warps * 32, smem, stream>>>(p);",
         "host_launch(terminal_kernel<QPL>, p.B, warps * 32, p);"),
        ('asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(s));',
         "y = 1.0f / std::sqrt(s);"),
        ("check_draws_kernel<<<(1 << 23) / 256, 256, 0, "
         "(cudaStream_t)stream>>>(bad);", "(void)bad;")]
    for old, new in swaps:
        assert old in src, old
        src = src.replace(old, new)
    (d / "cuda_runtime.h").write_text(_HOST_RUNTIME)
    (d / "terminal_host.cu").write_text(src)
    (d / "main.cpp").write_text(_HOST_MAIN)
    exe = d / "terminal_host"
    subprocess.run([gxx, "-std=c++20", "-O1", f"-I{d}",
                    f"-I{pathlib.Path(kernels.CSRC_DIR)}", "-include",
                    "cuda_runtime.h", "-o", str(exe), str(d / "main.cpp"),
                    "-lpthread"], check=True, capture_output=True)
    return exe


@pytest.fixture(scope="module")
def host_plan(host_kernel):
    """The kernel's constants (MAX_NX, MAX_WARPS, DRAWS, MAX_SMEM) and its
    plan by nx: (quads per lane, warps, stride, shared memory bytes)."""
    lines = subprocess.run([str(host_kernel), "plan"], check=True,
                           capture_output=True, text=True).stdout.split("\n")
    consts = tuple(int(v) for v in lines[0].split())
    plan = {}
    for line in lines[1:]:
        if line:
            nx, *rest = (int(v) for v in line.split())
            plan[nx] = tuple(rest)
    return consts, plan


def test_terminal_plan_fits_at_every_nx(host_plan):
    (max_nx, max_warps, draws, max_smem), plan = host_plan
    assert max_nx == 512 and max_smem <= kernels.MAX_SMEM_BYTES
    assert sorted(plan) == list(range(1, max_nx + 1))
    for nx, (qpl, warps, stride, smem) in plan.items():
        quads = (nx + 3) // 4
        assert smem <= max_smem, nx
        assert 1 <= warps <= max_warps
        assert 128 * qpl >= nx and qpl in (1, 2, 4)
        # one row per draw holds the draw's quads, the block's sums fit a
        # tile
        assert stride >= 4 * quads and stride % 4 == 0
        assert draws * stride >= 1 + nx
        assert smem == 4 * warps * draws * (stride + 1)
        # 8 lanes (8 draws) storing one quad each hit 8 distinct groups of
        # 4 banks: a row of an odd number of quads
        assert len({(lane * stride // 4) % 8 for lane in range(8)}) == 8
        # no fewer warps than fit
        if warps < max_warps:
            assert smem // warps * (warps + 1) > max_smem


@pytest.mark.parametrize("nx", [0, -3, 513, 1000])
def test_terminal_plan_raises_outside_its_range(host_kernel, nx):
    """No plan (-1) outside 1 <= nx <= 512: the wrapper raises
    NotImplementedError there (the card test
    ``test_terminal_plan_is_the_kernels``)."""
    out = subprocess.run([str(host_kernel), "smem", str(nx)], check=True,
                         capture_output=True, text=True).stdout
    assert int(out) == -1


def test_terminal_plan_at_the_main_path(host_plan):
    """nx = 100: one quad per lane, 4 warps, rows of 25 quads, and 4 blocks
    (16 warps) per SM in shared memory."""
    _, plan = host_plan
    assert plan[100] == (1, 4, 100, 51712)
    assert 4 * (plan[100][3] + RESERVED_PER_BLOCK) <= SM_SMEM_BYTES
    assert plan[512][1] == 3
    assert [plan[n][0] for n in (128, 129, 256, 257)] == [1, 2, 2, 4]


def test_host_build_hoisted_philox_equals_philox_cuh(host_kernel):
    out = subprocess.run([str(host_kernel), "philox"], check=True,
                         capture_output=True, text=True).stdout
    assert int(out) == 0


@pytest.mark.parametrize("b,m,nx,anti,own", [
    (3, 70, 100, False, True), (2, 66, 100, True, True),
    (2, 33, 7, False, False), (1, 40, 129, True, False),
    (2, 31, 1, False, True), (2, 20, 512, True, True),
    (2, 37, 257, False, False)])
def test_host_build_of_the_kernel_matches_plain(host_kernel, tmp_path, b, m,
                                                nx, anti, own):
    """The kernel's source, built for the host, equals the plain version
    fed the same draws: the host Philox's (own draws) or external noise."""
    rng = np.random.default_rng(nx + m)
    eq = make_equation("Cha", nx=nx, alpha=1.0, k=5.0, T=1.0)
    rows = m // 2 if anti else m
    seed = (7 << 32) | 5
    t = rng.uniform(0.0, 0.99, (b, 1)).astype(np.float32)
    x = (rng.normal(size=(b, nx)) * np.sqrt(t)).astype(np.float32)
    tx = torch.from_numpy(np.concatenate([t, x], 1))
    g0 = eq.g(tx[:, 1:]).numpy()
    noise = (philox.estimator_normals(seed, list(range(b)), rows, nx,
                                      philox.STREAM_TERMINAL) if own
             else rng.normal(size=(b, rows, nx)).astype(np.float32))
    blob = (np.array([b, m, nx, int(anti), int(own)], np.int32).tobytes()
            + np.array([seed], np.uint64).tobytes()
            + np.array([eq.T, eq.alpha_sqrt, eq.k], np.float32).tobytes()
            + t.tobytes() + x.tobytes() + g0.astype(np.float32).tobytes()
            + (b"" if own else noise.astype(np.float32).tobytes()))
    (tmp_path / "in.bin").write_bytes(blob)
    subprocess.run([str(host_kernel), str(tmp_path / "in.bin"),
                    str(tmp_path / "out.bin")], check=True)
    out = torch.from_numpy(np.fromfile(tmp_path / "out.bin", np.float32)
                           .reshape(b, 1 + nx))
    ref = kernels.terminal_with_gradients_plain(
        0, eq, tx, m, torch.from_numpy(np.asarray(noise, np.float32)),
        antithetic=anti)
    torch.testing.assert_close(out, ref, rtol=5e-5, atol=5e-5)
