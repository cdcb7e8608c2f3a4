// Standard normal buffer: the chunk estimators' increments under
// DATA.TPU.PRNG.
//
// Replaces the TPU kernel deeppicarditeration_tpu/ops/pallas_kernels.py:
// _normals_kernel (launched by tpu_normals), which fills a (rows, 128) f32
// buffer with Box-Muller normals from the hardware PRNG.
//
// The value at flat index i is a function of (seed, i) alone: quad c = i / 4
// is Philox4x32-10 with counter (c lo, c hi, stream 3, seed_hi) and key
// (seed_lo, 0) (philox.cuh); its 4 outputs give 2 Box-Muller pairs, both
// outputs of each used, uniforms in (0, 1] by the mantissa trick. So the
// draws do not depend on the launch shape or the buffer's shape.
//
// What bounds it on an H100: per normal the kernel writes 4 bytes and
// issues ~38 instructions (a quarter of a Philox call, the uniform, half a
// Box-Muller); the store at 3.35 TB/s of HBM3 and the schedulers' 128
// instructions per SM and clock come within a few per cent of each other.
// What the first design lost, and what this one does about it:
//   * the library's logf, sqrtf and sincosf spend a quarter of their
//     instructions on guards a uniform in [2^-23, 1] never needs: the
//     guard-free Box-Muller of draws.cuh (the same bits at every uniform);
//   * a fixed grid of 132 x 16 blocks of 256 threads is two waves at 8
//     resident blocks per SM, and a buffer of 1.6 M quads (paths K and L's
//     chunk) left a quarter of the threads a fourth pass: the grid is one
//     wave of the blocks the card holds at once (or fewer for a small
//     buffer), so every thread takes the same number of quads to within
//     one;
//   * a grid-stride loop over quads, one Philox call and one 16-byte store
//     (coalesced across the warp) a quad; only the last quad of a buffer
//     whose size is not a multiple of 4 is stored element by element. Two,
//     four or eight quads in flight a thread, their chains issued before
//     their stores, ran slower at both chunk shapes (their registers cost
//     resident warps).

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"
#include "philox.cuh"

namespace {

using namespace dpi;

constexpr int THREADS = 256;

__device__ __forceinline__ float4 quad_at(long long c, uint32_t seed_hi,
                                          uint2 key) {
  return unit_normals4(philox4x32_10(
      make_uint4((uint32_t)c, (uint32_t)(c >> 32), STREAM_NORMALS, seed_hi),
      key));
}

__global__ void __launch_bounds__(THREADS)
normals_kernel(float* out, long long n, uint32_t seed_lo, uint32_t seed_hi) {
  const uint2 key = make_uint2(seed_lo, 0u);
  const long long full = n / 4, nq = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  float4* out4 = reinterpret_cast<float4*>(out);
  long long c = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (; c < full; c += stride) out4[c] = quad_at(c, seed_hi, key);
  if (c < nq) {  // the last quad, cut short
    const float4 v = quad_at(c, seed_hi, key);
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (long long i = 4 * c; i < n; ++i) out[i] = e[i - 4 * c];
  }
}

// blocks the card runs at once (one wave), cached: -1 if not known
int wave_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, normals_kernel,
                                                      THREADS, 0) !=
            cudaSuccess ||
        per_sm < 1)
      return -1;
    blocks = sms * per_sm;
  }
  return blocks;
}

}  // namespace

extern "C" {

// Fills out[0 .. n) (16-byte aligned) on `stream`; returns
// cudaGetLastError() (0 on success).
int dpi_normals(float* out, long long n, unsigned long long seed,
                void* stream) {
  if (n <= 0) return 0;
  const int wave = wave_blocks();
  if (wave < 1) {
    const cudaError_t e = cudaGetLastError();
    return e != cudaSuccess ? (int)e : (int)cudaErrorUnknown;
  }
  const long long nq = (n + 3) / 4;
  const long long want = (nq + THREADS - 1) / THREADS;
  const int blocks = (int)(want < wave ? want : wave);
  normals_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      out, n, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // extern "C"
