// Exact drift-free K-step Brownian paths: the D-DBSDE baseline's rollout,
// one launch per epoch.
//
// Replaces the TPU kernel deeppicarditeration_tpu/ops/rollout.py:
// _paths_kernel (launched by _paths_pallas), which keeps a batch tile's
// running path state in VMEM, draws the increments from the hardware PRNG
// and stores both the state and the increment at every step.
//
// Outputs, for x0 (B, nx), per-row step scale s_b = sqrt(dts[b]) sqrt(alpha):
//   xi[k, b, j] ~ N(0, 1), k < K, a function of (seed, k, b, j) alone:
//     normal k % 4 of Philox4x32-10 with counter (k / 4, j, stream 4,
//     seed_hi) and key (seed_lo, b) (philox.cuh; Box-Muller of words 0-1
//     gives steps 4c, 4c + 1, of words 2-3 steps 4c + 2, 4c + 3). So the
//     draws do not depend on the launch shape or on B.
//   xs[0] = x0, xs[k + 1, b, j] = x0[b, j] + sum_{k' <= k} s_b xi[k', b, j]
//     with the sum kept in a register in step order, and every product and
//     sum rounded on its own (no FMA contraction): the arithmetic of the
//     plain version's x0 + cumsum(s xi).
//
// What bounds it on an H100: per element (b, j) the kernel reads x0 once
// and writes K + 1 states and K increments, (2K + 2) * 4 bytes; per normal
// it does a quarter of a Philox call (~17 integer operations) and half a
// Box-Muller. At the Burgers recipe's K=20, B=512, nx=100 that is 8.6 MB
// (2.6 us at 3.35 TB/s of HBM3) and 1.0 M normals (~1 us on the integer
// pipe): the launch itself takes longer than either. The design is the
// simple one: one thread per element, threads adjacent along j so that
// every load and store of a warp is coalesced, a loop over the K steps with
// one Philox call per 4 steps, the running sum in a register.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace dpi;

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
paths_kernel(const float* __restrict__ x0, const float* __restrict__ sqrt_dts,
             float* __restrict__ xs, float* __restrict__ xi, int rows,
             int nx, int K, float alpha_sqrt, uint32_t seed_lo,
             uint32_t seed_hi) {
  const long long n = (long long)rows * nx;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= n) return;
  const int b = (int)(e / nx);
  const uint32_t j = (uint32_t)(e - (long long)b * nx);
  const uint2 key = make_uint2(seed_lo, (uint32_t)b);
  const float scale = __fmul_rn(sqrt_dts[b], alpha_sqrt);
  const float start = x0[e];
  xs[e] = start;
  float acc = 0.0f;
  for (int c = 0; 4 * c < K; ++c) {
    float v[4];
    normals4((uint32_t)c, j, STREAM_PATHS, seed_hi, key, v);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int k = 4 * c + w;
      if (k < K) {
        xi[(long long)k * n + e] = v[w];
        acc = __fadd_rn(acc, __fmul_rn(scale, v[w]));
        xs[(long long)(k + 1) * n + e] = __fadd_rn(start, acc);
      }
    }
  }
}

}  // namespace

extern "C" {

// x0 (rows, nx), sqrt_dts (rows, 1) -> xs (K + 1, rows, nx), xi (K, rows,
// nx), all f32 and contiguous, on `stream`; returns cudaGetLastError() (0
// on success).
int dpi_paths(const float* x0, const float* sqrt_dts, float* xs, float* xi,
              int rows, int nx, int K, unsigned long long seed,
              float alpha_sqrt, void* stream) {
  const long long n = (long long)rows * nx;
  if (n <= 0 || K < 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  paths_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      x0, sqrt_dts, xs, xi, rows, nx, K, alpha_sqrt,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // extern "C"
