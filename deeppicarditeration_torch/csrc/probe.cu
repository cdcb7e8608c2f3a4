// Rate microprobe of the estimator kernels' non-matrix work: Philox bits,
// Box-Muller normals and the ELU forward pass with its derivative.
//
// Replaces the TPU kernel scripts/probe_vpu_roofline.py:_probe_kernel
// (launched by probe), which measured the same three rates in VMEM with the
// TPU's hardware PRNG. Each block owns an (8, 128) tile of partial sums;
// in each of `iters` iterations it makes a (256, 128) tile of units and
// adds rows 32r .. 32r + 31 of column c into partial sum (r, c):
//   bits:    uniforms in (0, 1] from Philox words (mantissa trick);
//   normals: Box-Muller normals, both outputs of each pair;
//   elu:     z = y * ge with y = ELU(x), ge = ELU'(x), x = x0 + acc * 1e-30,
//            x0 a normal drawn once before the loop and acc the thread's
//            own partial sum, so every iteration depends on the one before
//            and the compiler cannot hoist the ELU out of the loop.
// The units of rows 4w .. 4w + 3 in column c come from Philox4x32-10 with
// counter (w * 128 + c, iteration, stream 5, seed_hi), key (seed_lo, block)
// (philox.cuh); the ELU's x0 are the normals of iteration 0. Nothing but the
// (8, 128) sums per block is stored.
//
// What bounds it on an H100: nothing but the pipe each mode exercises. Per
// unit, bits: a quarter of a Philox call (~17 integer operations); normals:
// that plus half a Box-Muller (log, sqrt, sin, cos per pair: 2 special
// functions per normal); elu: one exp (one special function) and ~9 FP32
// operations. The design: 1024 threads per block, one per partial sum, 32
// units per thread and iteration (8 Philox calls), and as many blocks as
// fill every SM (dpi_probe_grid), so that the rate is the card's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using namespace dpi;

constexpr int LANES = 128;
constexpr int ROWS = 8;
constexpr int THREADS = ROWS * LANES;
constexpr int BLK = 256;                 // unit rows per iteration
constexpr int QUADS = BLK / ROWS / 4;    // Philox calls per thread, iteration
constexpr int MODE_BITS = 0, MODE_NORMALS = 1, MODE_ELU = 2;

template <int MODE>
__global__ void __launch_bounds__(THREADS)
probe_kernel(float* __restrict__ out, int iters, uint32_t seed_lo,
             uint32_t seed_hi) {
  const int r = threadIdx.x / LANES;
  const int c = threadIdx.x % LANES;
  const uint2 key = make_uint2(seed_lo, blockIdx.x);
  float acc = 0.0f;
  float x0[MODE == MODE_ELU ? 4 * QUADS : 1];
  if constexpr (MODE == MODE_ELU) {
#pragma unroll
    for (int w = 0; w < QUADS; ++w)
      normals4((uint32_t)((r * QUADS + w) * LANES + c), 0u, STREAM_PROBE,
               seed_hi, key, &x0[4 * w]);
  }
  for (int i = 0; i < iters; ++i) {
    float part = 0.0f;
    if constexpr (MODE == MODE_ELU) {
      const float shift = acc * 1e-30f;
#pragma unroll
      for (int u = 0; u < 4 * QUADS; ++u) {
        const float x = x0[u] + shift;
        const float y = x > 0.0f ? x : expf(x) - 1.0f;
        const float ge = x > 0.0f ? 1.0f : y + 1.0f;
        part += y * ge;
      }
    } else {
#pragma unroll
      for (int w = 0; w < QUADS; ++w) {
        const uint32_t q = (uint32_t)((r * QUADS + w) * LANES + c);
        if constexpr (MODE == MODE_BITS) {
          const uint4 bits = philox4x32_10(
              make_uint4(q, (uint32_t)i, STREAM_PROBE, seed_hi), key);
          part += uniform_from_bits(bits.x);
          part += uniform_from_bits(bits.y);
          part += uniform_from_bits(bits.z);
          part += uniform_from_bits(bits.w);
        } else {
          float v[4];
          normals4(q, (uint32_t)i, STREAM_PROBE, seed_hi, key, v);
          part += v[0];
          part += v[1];
          part += v[2];
          part += v[3];
        }
      }
    }
    acc += part;
  }
  out[((long long)blockIdx.x * ROWS + r) * LANES + c] = acc;
}

template <int MODE>
int launch(float* out, int grid, int iters, unsigned long long seed,
           cudaStream_t stream) {
  probe_kernel<MODE><<<grid, THREADS, 0, stream>>>(
      out, iters, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

template <int MODE>
int blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, probe_kernel<MODE>, THREADS, 0) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Blocks that fill the current device for `mode` (0 bits, 1 normals, 2
// elu): SMs times the blocks one SM holds at once; negative on an error.
int dpi_probe_grid(int mode) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const int per_sm = mode == MODE_BITS      ? blocks_per_sm<MODE_BITS>()
                     : mode == MODE_NORMALS ? blocks_per_sm<MODE_NORMALS>()
                                            : blocks_per_sm<MODE_ELU>();
  return per_sm > 0 ? sms * per_sm : -1;
}

// out: (grid * 8, 128) f32 partial sums, on `stream`; returns
// cudaGetLastError() (0 on success), or -1 for an unknown mode.
int dpi_probe(float* out, int mode, int grid, int iters,
              unsigned long long seed, void* stream) {
  if (grid <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case MODE_BITS: return launch<MODE_BITS>(out, grid, iters, seed, s);
    case MODE_NORMALS: return launch<MODE_NORMALS>(out, grid, iters, seed, s);
    case MODE_ELU: return launch<MODE_ELU>(out, grid, iters, seed, s);
    default: return -1;
  }
}

}  // extern "C"
