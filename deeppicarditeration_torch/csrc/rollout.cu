// Exact drift-free K-step Brownian paths: the D-DBSDE and DBDP baselines'
// rollout, one launch per epoch or sub-iteration.
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
//     with the sum kept in step order, and every product and sum rounded
//     on its own (no FMA contraction): the arithmetic of the plain
//     version's x0 + cumsum(s xi).
//   The seed is an immediate, or table[index[0]] read from device memory,
//   so that a launch captured in a CUDA graph draws a new seed at every
//   replay (the caller advances the index after the launch; the kernel
//   never writes it, since its blocks would race on it).
//
// What bounds it on an H100: per element (b, j) the kernel reads x0 once
// and writes K + 1 states and K increments, (2K + 2) * 4 bytes; at DBDP's
// K = 50, B = 512, nx = 100 that is 20.9 MB, 6.2 us at 3.35 TB/s of HBM3
// (a fill of as many bytes takes 7.2 us on an H100), and 2.56 M normals,
// ~38 issue slots each (2.9 us). The first design (one thread per element,
// its K / 4 Philox calls one after another) took 12.1 us: its stores alone
// 7.8 us, its draws alone 10.2 us (12 warps an SM, a long chain per
// thread); the two did not overlap. This design takes the draws off one
// thread's chain:
//   1. a block owns a tile of TILE flattened (b, j) columns across all
//      steps (in chunks of STEPS); threads over (step quad, column) make
//      the chunk's Philox calls in parallel and put the normals in shared
//      memory;
//   2. one thread per column runs the sum over the chunk's steps in order
//      from shared memory (four loads ahead), the running sum in a
//      register across chunks, and puts the states in shared memory;
//   3. all threads store both (steps, TILE) slabs, each slab row a
//      contiguous run of TILE floats in the output, as 16-byte stores
//      (element by element where the outputs are not 16-byte aligned or
//      the tile is ragged).
// TILE = 32, STEPS = 64 and 128 threads keep a block at 16 KB of shared
// memory (12.8 KB at K = 50), so 16 blocks share an SM. Variants timed on
// an H100 (utils/rollout_bench.py; PERF.md): 64- and 128-column tiles,
// 16- to 64-step chunks, a warp per step quad, the sum a chunk behind the
// draws on its own warp; none took the stores' time off the draws'.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace dpi;

constexpr int THREADS = 128;
constexpr int TILE = 32;    // columns per block
constexpr int STEPS = 64;   // steps per chunk, a multiple of 4
constexpr int ROW4 = TILE / 4;  // 16-byte stores per slab row
static_assert(THREADS % TILE == 0, "a thread keeps one column");

__host__ __device__ constexpr int chunk_rows(int K) {
  return K < STEPS ? K : STEPS;
}

__global__ void __launch_bounds__(THREADS)
paths_kernel(const float* __restrict__ x0, const float* __restrict__ sqrt_dts,
             float* __restrict__ xs, float* __restrict__ xi, int rows,
             int nx, int K, float alpha_sqrt, unsigned long long seed_imm,
             const long long* __restrict__ seed_table,
             const long long* __restrict__ seed_index, long long table_len) {
  extern __shared__ float4 smem4[];
  float* xi_s = reinterpret_cast<float*>(smem4);  // (chunk, TILE)
  float* xs_s = xi_s + chunk_rows(K) * TILE;      // states 1.. of the chunk
  const int n = rows * nx;
  const int tile0 = blockIdx.x * TILE;
  const int col = threadIdx.x % TILE;
  const int e = tile0 + col;
  const bool live = e < n;
  const int b = live ? e / nx : 0;
  const uint32_t j = (uint32_t)(e - b * nx);
  unsigned long long seed = seed_imm;
  if (seed_table != nullptr) {
    const long long i = *seed_index;
    if (i < 0 || i >= table_len) __trap();  // the caller overran its table
    seed = (unsigned long long)seed_table[i];
  }
  const uint32_t seed_hi = (uint32_t)(seed >> 32);
  const uint2 key = make_uint2((uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)b);
  const bool summer = threadIdx.x < TILE;
  float start = 0.0f, scale = 0.0f, acc = 0.0f;
  if (summer && live) {
    start = x0[e];
    scale = __fmul_rn(sqrt_dts[b], alpha_sqrt);
    xs[e] = start;
  }
  const bool vec = ((uintptr_t)xs % 16 == 0) && ((uintptr_t)xi % 16 == 0) &&
                   n % 4 == 0 && tile0 + TILE <= n;
  for (int k0 = 0; k0 < K; k0 += STEPS) {
    const int kc = K - k0 < STEPS ? K - k0 : STEPS;
    if (live) {
      for (int q = threadIdx.x / TILE; 4 * q < kc; q += THREADS / TILE) {
        float v[4];
        normals4((uint32_t)(k0 / 4 + q), j, STREAM_PATHS, seed_hi, key, v);
#pragma unroll
        for (int w = 0; w < 4; ++w)
          if (4 * q + w < kc) xi_s[(4 * q + w) * TILE + col] = v[w];
      }
    }
    __syncthreads();
    if (summer && live) {
      int k = 0;
      for (; k + 4 <= kc; k += 4) {
        float v[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) v[w] = xi_s[(k + w) * TILE + col];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          acc = __fadd_rn(acc, __fmul_rn(scale, v[w]));
          xs_s[(k + w) * TILE + col] = __fadd_rn(start, acc);
        }
      }
      for (; k < kc; ++k) {
        acc = __fadd_rn(acc, __fmul_rn(scale, xi_s[k * TILE + col]));
        xs_s[k * TILE + col] = __fadd_rn(start, acc);
      }
    }
    __syncthreads();
    if (vec) {
      const float4* xi4 = reinterpret_cast<const float4*>(xi_s);
      const float4* xs4 = reinterpret_cast<const float4*>(xs_s);
      for (int i = threadIdx.x; i < 2 * kc * ROW4; i += THREADS) {
        const int r = i / ROW4, v = i - r * ROW4;
        if (r < kc)
          reinterpret_cast<float4*>(xi + (long long)(k0 + r) * n + tile0)[v] =
              xi4[r * ROW4 + v];
        else
          reinterpret_cast<float4*>(xs + (long long)(k0 + r - kc + 1) * n +
                                    tile0)[v] = xs4[(r - kc) * ROW4 + v];
      }
    } else if (live) {
      for (int r = threadIdx.x / TILE; r < 2 * kc; r += THREADS / TILE) {
        if (r < kc)
          xi[(long long)(k0 + r) * n + e] = xi_s[r * TILE + col];
        else
          xs[(long long)(k0 + r - kc + 1) * n + e] = xs_s[(r - kc) * TILE + col];
      }
    }
    if (k0 + STEPS < K) __syncthreads();
  }
}

}  // namespace

extern "C" {

// Bytes of shared memory a block takes at K steps.
long long dpi_paths_smem_bytes(int K) {
  return K <= 0 ? 0 : 2LL * chunk_rows(K) * TILE * (long long)sizeof(float);
}

// x0 (rows, nx), sqrt_dts (rows, 1) -> xs (K + 1, rows, nx), xi (K, rows,
// nx), all f32 and contiguous, rows * nx < 2^31, on `stream`. The seed is
// `seed`, or where `seed_table` is not null seed_table[*seed_index] (int64
// on the card, `table_len` entries; an index outside the table traps).
// Returns cudaGetLastError() (0 on success).
int dpi_paths(const float* x0, const float* sqrt_dts, float* xs, float* xi,
              int rows, int nx, int K, unsigned long long seed,
              const long long* seed_table, const long long* seed_index,
              long long table_len, float alpha_sqrt, void* stream) {
  const long long n = (long long)rows * nx;
  if (n <= 0 || K < 0) return 0;
  if (n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + TILE - 1) / TILE;
  paths_kernel<<<(unsigned)blocks, THREADS, (size_t)dpi_paths_smem_bytes(K),
                 (cudaStream_t)stream>>>(
      x0, sqrt_dts, xs, xi, rows, nx, K, alpha_sqrt, seed, seed_table,
      seed_index, table_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
