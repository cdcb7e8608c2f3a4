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
// What bounds it on an H100: per normal the kernel writes 4 bytes and does
// a quarter of a Philox call plus the uniform (~17 integer operations) and
// half a Box-Muller; the 4-byte store at 3.35 TB/s of HBM3 and the integer
// pipe at 64 operations per SM and clock come within 20 % of each other,
// and the store binds. The design: a grid-stride loop
// over quads, one Philox call per thread and quad, one 16-byte store of the
// 4 normals (coalesced across the warp); only the ragged tail of a buffer
// whose size is not a multiple of 4 is stored element by element.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace dpi;

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100

__global__ void __launch_bounds__(THREADS)
normals_kernel(float* out, long long n, uint32_t seed_lo, uint32_t seed_hi) {
  const uint2 key = make_uint2(seed_lo, 0u);
  const long long nq = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long c = (long long)blockIdx.x * THREADS + threadIdx.x; c < nq;
       c += stride) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)c, (uint32_t)(c >> 32), STREAM_NORMALS, seed_hi),
        key);
    float4 v;
    box_muller(r.x, r.y, &v.x, &v.y);
    box_muller(r.z, r.w, &v.z, &v.w);
    if (4 * c + 4 <= n) {
      reinterpret_cast<float4*>(out)[c] = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
      for (long long i = 4 * c; i < n; ++i) out[i] = e[i - 4 * c];
    }
  }
}

}  // namespace

extern "C" {

// Fills out[0 .. n) (16-byte aligned) on `stream`; returns
// cudaGetLastError() (0 on success).
int dpi_normals(float* out, long long n, unsigned long long seed,
                void* stream) {
  if (n <= 0) return 0;
  const long long nq = (n + 3) / 4;
  const long long want = (nq + THREADS - 1) / THREADS;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  normals_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      out, n, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // extern "C"
