// Counter-based normals shared by the estimator kernels and the standalone
// normals kernel: Philox4x32-10 (Salmon et al., SC'11) and Box-Muller with
// both outputs. Replaces the TPU's hardware PRNG (pltpu.prng_random_bits)
// and the Box-Muller of deeppicarditeration_tpu/ops/pallas_kernels.py:
// _normals / _uniform_from_bits.
//
// A draw is a pure function of (key, counter), so the numbers never depend
// on the launch shape. Counter words in use (seed = seed_hi:seed_lo):
//   estimator kernels: key (seed_lo, point), counter (sample, quad of
//     dimensions, stream, seed_hi); stream 0 = terminal normals,
//     1 = integral normals, 2 = the integral's time draw u;
//   normals kernel:    key (seed_lo, 0), counter (quad index lo, quad
//     index hi, stream 3, seed_hi);
//   rollout kernel:    key (seed_lo, row b), counter (step / 4, dimension,
//     stream 4, seed_hi);
//   rate probe:        key (seed_lo, block), counter (quad in the tile,
//     iteration, stream 5, seed_hi).
// Distinct streams or seeds never share a counter. Its host reference,
// which the kernels' draws are checked against value for value, is
// deeppicarditeration_torch/ops/philox.py. Also the warp reduction the
// kernels use for their per-sample sums over dimensions.

#pragma once

#include <stdint.h>

namespace dpi {

constexpr float TWO_PI = 6.283185307179586f;
constexpr uint32_t STREAM_TERMINAL = 0u;
constexpr uint32_t STREAM_INTEGRAL = 1u;
constexpr uint32_t STREAM_TIME = 2u;
constexpr uint32_t STREAM_NORMALS = 3u;
constexpr uint32_t STREAM_PATHS = 4u;
constexpr uint32_t STREAM_PROBE = 5u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      key.x += 0x9E3779B9u;
      key.y += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ key.x, lo1, hi0 ^ c.w ^ key.y, lo0);
  }
  return c;
}

// uint32 bits -> uniform in (0, 1]: top 23 bits into an f32 mantissa with
// exponent 0 gives [1, 2), and 2 - f maps it to (0, 1], so log stays finite.
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  return 2.0f - __uint_as_float((bits >> 9) | 0x3F800000u);
}

__device__ __forceinline__ void box_muller(uint32_t b1, uint32_t b2,
                                           float* n0, float* n1) {
  const float r = sqrtf(-2.0f * logf(uniform_from_bits(b1)));
  float s, c;
  sincosf(TWO_PI * uniform_from_bits(b2), &s, &c);
  *n0 = r * c;
  *n1 = r * s;
}

// four normals for dimensions 4q .. 4q + 3 of sample k, chain `stream`
__device__ __forceinline__ void normals4(uint32_t k, uint32_t q,
                                         uint32_t stream, uint32_t seed_hi,
                                         uint2 key, float v[4]) {
  const uint4 r = philox4x32_10(make_uint4(k, q, stream, seed_hi), key);
  box_muller(r.x, r.y, &v[0], &v[1]);
  box_muller(r.z, r.w, &v[2], &v[3]);
}

// the integral chain's time draw u in (0, 1] for sample k
__device__ __forceinline__ float time_uniform(uint32_t k, uint32_t seed_hi,
                                              uint2 key) {
  return uniform_from_bits(
      philox4x32_10(make_uint4(k, 0u, STREAM_TIME, seed_hi), key).x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace dpi
