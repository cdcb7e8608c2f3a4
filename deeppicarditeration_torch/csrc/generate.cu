// Merged terminal + integral control-variate estimator of the DPI targets,
// with the frozen value network's forward and backward pass in the kernel.
//
// Replaces the TPU kernel deeppicarditeration_tpu/ops/pallas_kernels.py:
// _generate_kernel (launched by generate_with_gradients_pallas). For each
// collocation point (t, x), with Tt = max(T - t, 1e-6):
//   terminal: X_T = x + sqrt(Tt) sqrt(a) dWt,
//             acc += (g(X_T) - g0) * (1, dWt / (sqrt(Tt) sqrt(a)))
//   integral: s = t + u Tt, X_s = x + sqrt(s - t) sqrt(a) dWi,
//             (u, u_x) of the frozen net at (s, X_s), f = ff(s, X_s, u, u_x),
//             acc += Tt (f - f0) * (1, dWi / (sqrt(max(s - t, 1e-6)) sqrt(a)))
//   out = acc / M + (g0 + f0 Tt, 0),  shape (B, 1 + nx) f32.
// Specialised to the Burgers equation "Cha" (g and ff below) and a Value
// MLP of ELU hidden layers of one width, at any depth, with no output
// clamp: on the tensor cores of width 64, 128, or 256 to 1024 in steps of
// 128 at nx <= 1024 (the nets of the JAX package's dispatcher matrix,
// 3x64, 4x512, 6x512 and 2x1024, among them); in "highest" of width 128 at
// nx <= 511 (ops/kernels.py:merged_covers holds those limits; the card
// tests hold them to dpi_generate_tc_widths, dpi_generate_tc_max_nx,
// dpi_generate_hidden_width, dpi_generate_max_nx).
//
// Antithetic pairing (anti = 1): samples 2p and 2p + 1 share draw p, the
// second with both increments negated and the same time u; external noise
// then has M / 2 rows. The sum over samples is that of the TPU kernel, which
// mirrors per inner block instead.
//
// Two kernels, by the precision of the net's dots (the TPU kernel's
// mxu_precision, DATA.TPU.PALLAS_PRECISION):
//   * "bf16x3" (the default) and "default": generate_tc_kernel, the net on
//     the tensor cores (net_pass_narrow below; the block layout and the
//     plan are value_mlp_tc.cuh's, shared with integral.cu). Its bound is
//     the tensor pipe (3 x 111.5 k bf16 multiply-adds per sample under
//     bf16x3). What
//     held the first tensor-core design (one warpgroup of consumers, two
//     blocks an SM) at 5.7x that bound, and what this one does about it:
//       - the terminal chain ran on the consumers between the products, a
//         draw at a time across a warp (a shuffle sum and a sigmoid a draw,
//         25 of 32 lanes busy at nx = 100): it runs on three warps of the
//         producer warpgroup beside the products (terminal_warps), a warp a
//         draw, D draws a turn, each lane QPL quads of a draw (term_point),
//         so that each normal is drawn once and kept in registers while a
//         warp sum gives the draw's weight (one sigmoid a draw), then added
//         times that weight to the sums of the lane's own quads in shared
//         memory; its sums join the integral chain's at a point's end, in a
//         fixed order;
//       - each weight byte staged from L2 served one 64-row tile: two
//         consumer warpgroups take tiles 2i and 2i + 1 of a point and read
//         every ring stage, so a byte serves 128 samples;
//       - 2 ring stages (two blocks an SM): one block an SM with a ring of
//         up to 4 stages;
//       - the two warpgroups' products issued in turns (PingPong), so that
//         one's epilogue can run while the other's products do.
//     Layer 1 draws its own input: W1's columns stand in quad order in its
//     images (ops/kernels.py:pack_mlp_tc, quad_frags), so that a
//     consumer's A fragments of a k16 chunk are one Philox quad of each of
//     its two rows, which it draws there (layer1_slab: draws.cuh's
//     guard-free Box-Muller; no branch between a slab's quads where the
//     slab lies in nx and the tile in M, so their draws interleave; with
//     antithetic pairing a pair's rows lie in partner lanes, each draw made
//     once and shuffled across) and keeps, a float4 a quad, in the tile's
//     rows (shared memory where the plan fits them, as at nx = 100; else
//     the block's global scratch), which the integral sums read once, a
//     quad a thread over the tile's rows in row order, 8 rows' loads in
//     flight (accumulate_quads). Why (utils/generate_bench.py --stamps at
//     path R's shape, B = 4096, M = 16384, nx = 512, 4x128; H100 80GB HBM3
//     700 W; PERF.md §6): the design before it drew the integral
//     normals to scratch in a phase of their own, read them back to build
//     layer 1's A and again for the sums, a scalar a thread (247 k of
//     ~336 k cycles a tile pair under bf16x3), and its terminal warps, a
//     lane a draw, drew each normal twice (279 k cycles of work a warp).
//     In turns with that design at B = 4096: R 699.99 -> 418.87 ms bf16x3,
//     641.27 -> 315.82 "default"; path A (nx = 100, M = 4096) 46.16 ->
//     44.40, 36.12 -> 31.04, antithetic (M = 8192) 84.27 -> 82.72; the
//     width-64 instance at path X (3x64, nx = 256) 72.83 -> 45.27. The
//     integral draws first ran each in a branch of its own (external
//     noise, bounds): no two interleaved, ~1.8 k cycles a quad at A.
//     Each layer is one wgmma m64n128 product per k16 chunk with A split
//     into bf16 hi and lo in registers, the producer warp staging the
//     weights in 32 KB slabs with cp.async.bulk and mbarriers; the saved
//     ELU derivatives stay in shared memory where the plan fits them, else
//     in the block's global scratch (at nx = 100 and 4x128: the normals in
//     shared memory, the derivatives in scratch, 4 stages; at nx = 512 and
//     1024, 128 KB and 256 KB of a tile's normals: both in scratch, 4
//     stages); a consumer keeps its quads' sums in registers, a point's
//     1 + nx outputs at any nx up to 1024; a persistent grid.
//     Four passes, one instance each a mode (generate_tc_kernel<P, HW>):
//       - width 128 (net_pass_narrow<X3, 128>, above);
//       - width 64 (net_pass_narrow<X3, 64>): a layer is one wgmma m64n64
//         product per k16 chunk into a 32-float accumulator, a hidden
//         layer's K = 64 one slab (the 64 x 64 image of W, read K-major
//         forward and MN-major backward), the output in registers as at
//         width 128;
//       - width 256 (net_pass256, HW = N256): the layer chain on chip,
//         both chains on the consumers (the note at net_pass256). It
//         replaced the wide pass at that width for path S (nx = 1024, B =
//         4096 a call, M = 32768), where the wide pass took 4275.93 ms,
//         8.0x its bound: its stamp trace (utils/generate_bench.py
//         --stamps, per tile pair, H100 80GB HBM3 700 W) put 426 k of
//         its ~1.02 M cycles in building layer 1's A from the tiles'
//         normals in global scratch (67 MB of them over the grid: HBM, not
//         L2), and the terminal warps worked 503 k, latency-bound (one warp
//         a scheduler, 4.6 cycles an instruction); with every scratch
//         access taken out the kernel still took 62 % of its time.
//         Measured in turns with that build at S's shape (B = 4096, M =
//         32768; utils/generate_bench.py, H100 80GB HBM3 700 W): bf16x3
//         2930.59 against 4302.44 ms, "default" 2343.65 against 3857.07,
//         antithetic (B = 1056, M = 65536) 1464.94 against 2159.36; what
//         binds it now: the draws (158 k cycles a tile pair), layer 1's A
//         from the kept normals (207 k) and the epilogues of 128
//         accumulators, which spill (182 k), against 126 k of products.
//       - widths 384 to 1024 (net_pass_wide, HW = WIDE, the width a
//         runtime value): each warpgroup keeps its own tile and takes a
//         layer in ceil(hw / 256) column blocks of m64n256, each over all
//         of the layer's K, with A (each layer's input, written once as
//         bf16 images by the layer before) staged in shared memory by the
//         producer beside the weights (why, and what it replaced: at
//         net_pass_wide);
//     At the JAX package's dispatcher-matrix nets, B = M = 4096, bf16x3
//     (chip_smoke paths U, V, W, X, H100 80GB HBM3 700 W): 4x512 at nx =
//     100 449.34 ms, 6x512 at 256 736.68, 2x1024 at 512 645.58 (2.7, 2.6
//     and 2.4x the tensor pipe's bound; in turns with the wide pass before
//     A was staged: 544.39, 914.56, 1148.56, utils/generate_bench.py), 3x64
//     at 256 45.27 (72.83 before the narrow instances' terminal chain and
//     layer-1 draws were redesigned; the draws bind there, not the net).
//   * "highest": generate_kernel, the FP32-FMA design
//     (value_mlp.cuh), one block per point, inner blocks of S = 32
//     samples, 8 per warp through the whole net, activations and both
//     chains' normals in shared memory, weights through L1/L2; bound by
//     the FP32 pipe (~62.7 k multiply-adds forward, ~49.4 k backward per
//     sample at nx = 100).
// Normals come from Philox4x32-10 keyed by (seed, point) and counted by
// (sample, quad of dimensions, chain) (philox.cuh) in both, so the draws do
// not depend on the launch shape or the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"
#include "philox.cuh"
#include "value_mlp.cuh"
#include "value_mlp_tc.cuh"

namespace {

using namespace dpi;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int S = WARPS * SPW;      // samples per inner block
constexpr int MAXJ = 4;             // accumulator slots per thread

struct Params {
  const float* t;        // (B, 1)
  const float* x;        // (B, nx)
  const float* g0;       // (B, 1)  g(x)
  const float* f0;       // (B, 1)  get_f(t, x)
  const float* w;        // packed net (see pack order in ops/kernels.py)
  const float* u01;      // (B, Md) or null: in-kernel draws
  const float* noise_t;  // (B, Md, nx) or null
  const float* noise_i;  // (B, Md, nx) or null
  float* out;            // (B, 1 + nx)
  int B, M, nx, L, has_net, anti;  // Md = anti ? M / 2 : M
  uint32_t seed_lo, seed_hi;
  float T, alpha_sqrt, k, c0;
};

__host__ __device__ constexpr size_t smem_floats(int nx, int L) {
  return (size_t)L * S * H + 3 * (size_t)S * nx + nx + H + 5 * S;
}

__global__ void __launch_bounds__(THREADS)
generate_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  const int Md = p.anti ? p.M / 2 : p.M;
  float* hbuf = smem;                       // L x S x H activations/grads
  float* xs = hbuf + (size_t)L * S * H;     // S x nx  X_s
  float* dwt = xs + S * nx;                 // S x nx  terminal normals
  float* dwi = dwt + S * nx;                // S x nx  integral normals
  float* xrow = dwi + S * nx;               // nx      the point's x
  float* wcol = xrow + nx;                  // H       sum_j W1[n, 1 + j]
  float* s_val = wcol + H;                  // S       s
  float* sig = s_val + S;                   // S       sqrt(s - t) sqrt(a)
  float* c_t = sig + S;                     // S       g(X_T) - g0
  float* c_i = c_t + S;                     // S       Tt (f - f0)
  float* c_iy = c_i + S;                    // S       1/ys, then c_i / ys

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float t = p.t[b], g0 = p.g0[b], f0 = p.f0[b];
  const float Tt = fmaxf(p.T - t, 1e-6f);
  const float sqrt_Tt = sqrtf(Tt);
  const float cT = sqrt_Tt * p.alpha_sqrt;
  const float inv_yT = 1.0f / (sqrt_Tt * p.alpha_sqrt);
  const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
  const ValueMlp net = value_mlp(p.w, nx, L);

  for (int j = tid; j < nx; j += THREADS) xrow[j] = p.x[(size_t)b * nx + j];
  if (p.has_net) column_sums(net, nx, wcol, tid, THREADS);
  float acc_t[MAXJ], acc_i[MAXJ];
#pragma unroll
  for (int r = 0; r < MAXJ; ++r) acc_t[r] = acc_i[r] = 0.0f;
  __syncthreads();

  const int nblk = (p.M + S - 1) / S;
  const int Q = (nx + 3) / 4;
  const int s0 = warp * SPW;  // this warp's first sample slot
  for (int kb = 0; kb < nblk; ++kb) {
    // ---- per-sample time draws: lanes 0..SPW-1 -------------------------
    if (lane < SPW) {
      const int sl = s0 + lane;
      const int k = kb * S + sl;
      float u = 0.0f;
      if (k < p.M) {
        const int kd = p.anti ? k >> 1 : k;
        u = p.u01 ? p.u01[(size_t)b * Md + kd] : time_uniform(kd, p.seed_hi, key);
      }
      const float s = t + u * Tt;
      const float st = s - t;
      s_val[sl] = s;
      sig[sl] = sqrtf(st) * p.alpha_sqrt;
      c_iy[sl] = 1.0f / (sqrtf(fmaxf(st, ST_FLOOR)) * p.alpha_sqrt);
    }
    __syncwarp();

    // ---- normals of both chains, and X_s --------------------------------
    if (p.noise_t) {
      for (int e = lane; e < SPW * nx; e += 32) {
        const int i = e / nx, j = e - i * nx, sl = s0 + i;
        const int k = kb * S + sl;
        float a = 0.0f, c = 0.0f;
        if (k < p.M) {
          const int kd = p.anti ? k >> 1 : k;
          const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
          const size_t o = ((size_t)b * Md + kd) * nx + j;
          a = sg * p.noise_t[o];
          c = sg * p.noise_i[o];
        }
        dwt[sl * nx + j] = a;
        dwi[sl * nx + j] = c;
        xs[sl * nx + j] = xrow[j] + sig[sl] * c;
      }
    } else {
      for (int e = lane; e < SPW * Q; e += 32) {
        const int i = e / Q, q = e - i * Q, sl = s0 + i;
        const int k = kb * S + sl;
        float nt[4] = {0.0f, 0.0f, 0.0f, 0.0f}, ni[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k < p.M) {
          const int kd = p.anti ? k >> 1 : k;
          const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
          normals4(kd, q, STREAM_TERMINAL, p.seed_hi, key, nt);
          normals4(kd, q, STREAM_INTEGRAL, p.seed_hi, key, ni);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            nt[r] *= sg;
            ni[r] *= sg;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * q + r;
          if (j < nx) {
            dwt[sl * nx + j] = nt[r];
            dwi[sl * nx + j] = ni[r];
            xs[sl * nx + j] = xrow[j] + sig[sl] * ni[r];
          }
        }
      }
    }
    __syncwarp();

    // ---- terminal chain: g(X_T) - g0, g(x) = sigmoid(T + k sum x) -------
    float diff_t[SPW];
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const float* dw = dwt + (s0 + i) * nx;
      float part = 0.0f;
      for (int j = lane; j < nx; j += 32) part += xrow[j] + cT * dw[j];
      part = warp_sum(part);
      diff_t[i] = 1.0f / (1.0f + expf(-(p.T + p.k * part))) - g0;
    }

    // ---- integral chain: (u, sum_j u_x_j) of the frozen net at (s, X_s) -
    float u[SPW], sux[SPW];
#pragma unroll
    for (int i = 0; i < SPW; ++i) u[i] = sux[i] = 0.0f;
    if (p.has_net)
      value_and_grad_sum(net, nx, S, s0, lane, xs, s_val, hbuf, wcol, u, sux);

    // ---- f = ff(s, X_s, u, u_x) for Cha, and the per-sample weights -----
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        const int sl = s0 + i;
        const bool valid = kb * S + sl < p.M;
        const float coef = p.k * u[i] - p.c0;
        const float f = p.alpha_sqrt * coef * (p.alpha_sqrt * sux[i]);
        const float di = valid ? Tt * (f - f0) : 0.0f;
        c_t[sl] = valid ? diff_t[i] : 0.0f;
        c_i[sl] = di;
        c_iy[sl] = di * c_iy[sl];
      }
    }
    __syncthreads();

    // ---- accumulate the point's 1 + nx sums (slot 0: value) -------------
#pragma unroll
    for (int r = 0; r < MAXJ; ++r) {
      const int j = tid + r * THREADS;
      if (j == 0) {
        for (int sl = 0; sl < S; ++sl) acc_t[r] += c_t[sl] + c_i[sl];
      } else if (j <= nx) {
        const float* dt = dwt + (j - 1);
        const float* di = dwi + (j - 1);
        for (int sl = 0; sl < S; ++sl) {
          acc_t[r] = fmaf(c_t[sl], dt[sl * nx], acc_t[r]);
          acc_i[r] = fmaf(c_iy[sl], di[sl * nx], acc_i[r]);
        }
      }
    }
    __syncthreads();
  }

  const float inv_m = 1.0f / (float)p.M;
  float* out = p.out + (size_t)b * (1 + nx);
#pragma unroll
  for (int r = 0; r < MAXJ; ++r) {
    const int j = tid + r * THREADS;
    if (j == 0) {
      out[0] = acc_t[r] * inv_m + g0 + f0 * Tt;
    } else if (j <= nx) {
      out[j] = (acc_t[r] * inv_yT + acc_i[r]) * inv_m;
    }
  }
}

__device__ __forceinline__ float g_cha(float T, float k, float sum_x) {
  return 1.0f / (1.0f + expf(-(T + k * sum_x)));
}

// ---- the tensor-core kernel ---------------------------------------------

using tc::AUX_THREADS;
using tc::AUX_WARPS;
using tc::BAR_CONSUMERS;
using tc::BAR_TERM_FREE;
using tc::BAR_TERM_FULL;
using tc::BAR_WG;
using tc::NWG;
using tc::TC_CONSUMERS;
using tc::TC_THREADS;
constexpr int WG = tc::CONSUMERS;  // a warpgroup: 128 threads
// the consumers and the terminal warps (the producer warpgroup's others)
constexpr int TERM_BAR_THREADS = TC_CONSUMERS + AUX_THREADS;

// The tensor-core kernel's cover: nx (its output columns past the
// consumers' registers in shared memory) and the hidden widths it is built
// for: H64 = 64 and H = 128 (net_pass_narrow) and every multiple of 128
// from 256 to GEN_MAX_WIDTH: 256 (net_pass256, instance N256), the rest
// net_pass_wide (one instance: WIDE).
constexpr int GEN_MAX_NX = 1024;
constexpr int H64 = 64;
constexpr int WIDE = 0;  // the instance of widths 384 .. GEN_MAX_WIDTH
constexpr int GEN_MAX_WIDTH = 1024;

// the width-256 instance's tile images and ring stages (net_pass256)
constexpr int N256 = 256;
constexpr int A256_CHUNK = 2 * 8 * 128;      // a k16 chunk of a tile image
constexpr int A256_IMAGE = 16 * A256_CHUNK;  // 64 x 256 bf16: 32 KB
constexpr int A256_BYTES = 2 * A256_IMAGE;   // hi and lo
constexpr int N256_IMAGE = N256 * 16 * 2;    // a 256-row k16 slab: 8 KB
constexpr int STAGE256 = 2 * N256_IMAGE;     // hi and lo
// arrivals that free a ring stage: one a consumer warp
constexpr int EMPTY256_ARRIVALS = tc::TC_CONSUMERS / 32;

// the wide pass's ring stages (net_pass_wide): WCPS k16 chunks each, of
// the weights' 256-row slab of a column block and of both tiles' A, a
// piece each of what the mode reads; at most 4 of them (192 KB) under
// bf16x3, and "default" runs twice as many of half the bytes
constexpr int WCPS = 2;                           // k16 chunks a stage
constexpr int WB_IMG = 256 * 16 * 2 * WCPS;       // a weight piece: 16 KB
constexpr int WA_IMG = tc::TILE * 16 * 2 * WCPS;  // a tile's A piece: 4 KB
constexpr int WIDE_STAGE = 2 * (WB_IMG + tc::NWG * WA_IMG);  // bf16x3: 48 KB
constexpr int WIDE_MAX_STAGES = 8;  // barriers: "default"'s stages

__host__ __device__ inline int wide_stage_bytes(int pieces) {
  return pieces * (WB_IMG + tc::NWG * WA_IMG);
}
// the ring's stages in a mode: the plan's (bf16x3) count, or under
// "default" twice as many stages of half the bytes
__host__ __device__ inline int wide_stages(int stages_x3, int pieces) {
  const int st = pieces == 1 ? 2 * stages_x3 : stages_x3;
  return st < WIDE_MAX_STAGES ? st : WIDE_MAX_STAGES;
}

// global scratch floats of a warpgroup of the wide pass (WideScratch): the
// saved elu'(z) of L - 1 layers, its tile's normals, layer 1's input image
// and two images of layer outputs (bf16 hi and lo: a float an element)
__host__ __device__ inline size_t wide_floats_wg(int nx, int L, int hw) {
  const size_t layers = L > 1 ? (size_t)(L + 1) * tc::TILE * hw : 0;
  return layers + (size_t)tc::TILE * nx + (size_t)tc::TILE * tc::k1_of(nx);
}
__host__ __device__ inline size_t scratch_floats_wide(int nx, int L, int hw) {
  return (size_t)tc::NWG * wide_floats_wg(nx, L, hw);
}

// layer 1's k16 chunks: 1 + nx columns
__host__ __device__ inline int chunks1(int nx) { return (nx + 16) / 16; }

__host__ __device__ inline bool covered_width(int hw) {
  return hw == H64 || hw == H ||
         (hw >= 2 * H && hw <= GEN_MAX_WIDTH && hw % H == 0);
}

// the instance (template HW) of a covered width, from the width alone
// (ops/kernels.py:generate_tc_instance)
__host__ __device__ inline int instance_of(int hw) {
  return hw == H64 || hw == H || hw == N256 ? hw : WIDE;
}

// The merged kernel's shared memory beside the ring: each consumer
// warpgroup's tile of normals (rows of nx padded to whole quads, a float4
// a quad), the terminal warps' sums, 32 KB stages (hi and lo images of a
// 128-row slab; at width 64 of a 64-row one), the saved derivatives of
// TILE x hw a layer. ops/kernels.py:library_tc_plan reads the plan.
__host__ __device__ inline tc::Layout gen_layout(int nx, int hw) {
  tc::Layout k{1, 1, 4 * ((nx + 3) / 4), 2 * tc::IMAGE_BYTES};
  k.save_layer = tc::TILE * hw;
  if (instance_of(hw) == N256) k.stage_bytes = STAGE256;
  return k;
}

// The width-256 instance's shared memory: the two warpgroups' tile images
// (hi and lo), the ring of 256-row k16 slabs, the point's x, the tiles'
// rows (NROWS256 arrays), the point's sum_j x_j (at tred), and (at red)
// each warpgroup's sums of both chains over the point (1 + nx each); no
// tile of normals, no saved derivatives, no terminal warps' sums
constexpr int NROWS256 = tc::NROWS + 2;
__host__ __device__ inline size_t sums256_floats(int nx) {
  return tc::align16((size_t)(1 + nx) * 4) / 4;
}
__host__ __device__ inline tc::GPlan gplan256(int nx, int stages) {
  using namespace tc;
  GPlan p = gplan(nx, 0, gen_layout(nx, N256), 0, 0, 0);
  size_t o = 0;
  p.stages = stages;
  p.act = o;
  o += (size_t)NWG * A256_BYTES;
  p.ring = o;
  o += (size_t)stages * STAGE256;
  p.save = p.dw = p.xrow = o;
  o += align16((size_t)nx * 4);
  p.rows = o;
  o += (size_t)NWG * NROWS256 * TILE * 4;
  p.tacc = p.tred = o;
  o += 16;
  p.red = o;
  o += (size_t)NWG * 2 * sums256_floats(nx) * 4;
  p.isum = p.sums = p.bars = o;
  o += (size_t)2 * MAX_STAGES * 8;
  p.total = o;
  return p;
}

// the deepest ring of 2..MAX_STAGES stages that fits; stages = -1 if none
__host__ __device__ inline tc::GPlan choose_gplan256(int nx) {
  for (int st = tc::MAX_STAGES; st >= 2; --st) {
    const tc::GPlan p = gplan256(nx, st);
    if (p.total <= tc::SMEM_LIMIT) return p;
  }
  tc::GPlan bad = gplan256(nx, 0);
  bad.stages = -1;
  return bad;
}

// global scratch floats a block of the width-256 instance keeps: each
// warpgroup's L - 1 layers of saved elu'(z), then each warpgroup's tile of
// normals of both chains (a float4 a quad of dimensions)
__host__ __device__ inline size_t saves256_floats(int L) {
  return L > 1 ? (size_t)(L - 1) * tc::TILE * N256 : 0;
}
__host__ __device__ inline size_t scratch_floats256(int nx, int L) {
  return (size_t)tc::NWG *
         (saves256_floats(L) + (size_t)2 * tc::TILE * 4 * ((nx + 3) / 4));
}

// output columns a consumer of the wide pass keeps in registers (MAXJ
// slots); the columns past them in shared memory, a row of each
// warpgroup's (isum)
__host__ __device__ inline int isum_floats(int nx) {
  return 1 + nx > tc::MAXJ * tc::CONSUMERS ? 1 + nx - tc::MAXJ * tc::CONSUMERS
                                           : 0;
}

// The wide pass's shared memory (net_pass_wide): the ring of stages of
// WIDE_STAGE bytes (the bf16x3 count; "default" runs twice as many of half
// the bytes), the point's x, the tiles' rows, the terminal warps' sums,
// the consumers' sums past their registers, the ring's barriers and the
// barrier of the published layer outputs (ready); the tiles' normals and
// saved derivatives in scratch
__host__ __device__ inline tc::GPlan gplan_wide(int nx, int stages) {
  using namespace tc;
  GPlan p = {};
  size_t o = 0;
  p.stages = stages;
  p.ring = o;
  o += (size_t)stages * WIDE_STAGE;
  p.save = p.dw = p.xrow = o;
  o += align16((size_t)nx * 4);
  p.rows = o;
  o += (size_t)NWG * NROWS * TILE * 4;
  p.tacc = o;
  o += (size_t)AUX_WARPS * align16((size_t)nx * 4);
  p.tred = o;
  o += align16((size_t)AUX_WARPS * (1 + nx) * 4);
  p.red = o;
  o += align16((size_t)(1 + nx) * 4);
  p.isum = o;
  o += (size_t)NWG * align16((size_t)isum_floats(nx) * 4);
  p.sums = p.bars = o;
  o += (size_t)(2 * WIDE_MAX_STAGES + 1) * 8;
  p.total = o;
  return p;
}

// the deepest ring of 2..WIDE_MAX_STAGES / 2 stages that fits; stages = -1
// if none
__host__ __device__ inline tc::GPlan choose_gplan_wide(int nx) {
  for (int st = WIDE_MAX_STAGES / 2; st >= 2; --st) {
    const tc::GPlan p = gplan_wide(nx, st);
    if (p.total <= tc::SMEM_LIMIT) return p;
  }
  tc::GPlan bad = gplan_wide(nx, 0);
  bad.stages = -1;
  return bad;
}

// the plan of a covered width's instance
__host__ __device__ inline tc::GPlan plan_of(int nx, int L, int hw) {
  const int inst = instance_of(hw);
  return inst == N256   ? choose_gplan256(nx)
         : inst == WIDE ? choose_gplan_wide(nx)
                        : tc::choose_gplan(nx, L, gen_layout(nx, hw));
}
__host__ __device__ inline size_t scratch_of(const tc::GPlan& pl, int nx,
                                             int L, int hw) {
  const int inst = instance_of(hw);
  return inst == N256   ? scratch_floats256(nx, L)
         : inst == WIDE ? scratch_floats_wide(nx, L, hw)
                        : tc::scratch_floats(pl, gen_layout(nx, hw), L);
}

}  // namespace

// generate.cu's own pass, in the shared pass's namespace
namespace dpi {
namespace tc {

// ---- the merged kernel's own pass (one m64nW group per K-slab) ----------
// In turns at path A's shapes (PERF.md §6), value_mlp_tc.cuh's net_pass
// (the same groups, its epilogues: the biases and saved derivatives
// loaded ahead, the head and column sums summed inside them) made this
// kernel spill 220 bytes a thread at the 208 registers its consumers get
// beside the terminal warps' 88 and ran 15 % slower in bf16x3; its
// products with this pass's epilogues, 2.2 % slower (1.4 % antithetic).
// net_pass_narrow serves widths W = 128 and 64: a layer is one m64nW
// product per k16 chunk into an accumulator of W / 2 floats a thread
// (NA below), so its output stays in registers and the next layer splits
// it into its A fragments; a hidden layer's K = W is two slabs at 128
// (hidden_layer128) and one at 64 (the 64 x 64 image of W, staged at the
// offsets of a 128-row slab's).

template <int N>
__device__ __forceinline__ void fence_frags2(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// d (64 x 128, f32) += A (64 x 16 bf16, registers) B (16 x 128 bf16,
// shared memory at desc_b; TRANS_B = 1: read MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n(float (&d)[NACC],
                                        const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) B (16 x 64 bf16)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n(float (&d)[H64 / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1),
        "n"(TRANS_B));
}

// a, b -> their bf16 hi parts and bf16-rounded residuals, packed in pairs
// (the lower column in the low half, as a wgmma A fragment holds them)
__device__ __forceinline__ void split_hi_lo(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 ha = __float2bfloat16_rn(a);
  const __nv_bfloat16 hb = __float2bfloat16_rn(b);
  __nv_bfloat162 h;
  h.x = ha;
  h.y = hb;
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __bfloat162float(ha),
                                                 b - __bfloat162float(hb));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// an accumulator of NA floats (a layer of 2 NA columns) as NA / 8 k-chunks
// of A fragments
template <int NA>
__device__ __forceinline__ void to_frags(const float (&acc)[NA],
                                         uint32_t (&ah)[NA / 8][4],
                                         uint32_t (&al)[NA / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < NA / 8; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_hi_lo(acc[8 * kc + 2 * r], acc[8 * kc + 2 * r + 1], ah[kc][r],
                 al[kc][r]);
}

// One k-chunk of a staged slab into an accumulator of NA floats (its
// W = 2 NA output columns): hi*hi (+ lo*hi + hi*lo under bf16x3).
// Forward slabs are K-major (column slab of W: W / 8 core rows of 8
// cores), backward slabs MN-major (row slab of W: 8 core rows of W / 8
// cores, W / 8 x 128 bytes a row). The mode is a template parameter: a
// branch between two wgmma makes ptxas wait for the first to finish.
template <int TRANS_B, bool X3, int NA>
__device__ __forceinline__ void mma_chunk(float (&acc)[NA],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t stage, int kk) {
  constexpr uint32_t row = 2 * NA / 8 * 128;
  const uint32_t b = stage + (TRANS_B ? kk * 2 * row : kk * 256);
  const uint32_t lbo = TRANS_B ? row : 128, sbo = TRANS_B ? 128 : 1024;
  const uint64_t bh = gmma_desc(b, lbo, sbo);
  wgmma_n<TRANS_B>(acc, ah, bh);
  if (X3) {
    wgmma_n<TRANS_B>(acc, al, bh);
    wgmma_n<TRANS_B>(acc, ah, gmma_desc(b + IMAGE_BYTES, lbo, sbo));
  }
}

// Issue acc += A's k-chunks K0 .. K0 + 3 (ah, al: N chunks) times the
// next staged slab, as one wgmma group.
template <int TRANS_B, bool X3, int K0, int N, int NA>
__device__ __forceinline__ void slab_issue(float (&acc)[NA],
                                           uint32_t (&ah)[N][4],
                                           uint32_t (&al)[N][4],
                                           Ring& ring) {
  const uint32_t stage = ring.acquire();
  fence_acc(acc);
  fence_frags2(ah);
  fence_frags2(al);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SLAB_K / 16; ++kk)
    mma_chunk<TRANS_B, X3>(acc, ah[K0 + kk], al[K0 + kk], stage, kk);
  wgmma_commit();
}

// Wait until at most PENDING groups are in flight, then free the oldest
// slab taken and not yet freed.
template <int PENDING, int NA>
__device__ __forceinline__ void slab_retire(float (&acc)[NA], Ring& ring,
                                            int& freed) {
  wgmma_wait<PENDING>();
  fence_acc(acc);
  ring.release_slab(freed++);
}

// One K-slab's products in one turn, waited for, the slab freed.
template <int TRANS_B, bool X3, int NA, class Turn>
__device__ __forceinline__ void slab_turn(float (&acc)[NA],
                                          uint32_t (&ah)[4][4],
                                          uint32_t (&al)[4][4], Ring& ring,
                                          const Turn& turn) {
  int freed = ring.it;
  turn.wait();
  slab_issue<TRANS_B, X3, 0>(acc, ah, al, ring);
  turn.pass();
  slab_retire<0>(acc, ring, freed);
}

// A hidden layer of width 128: both slabs in flight together, then freed
// in order.
template <int TRANS_B, bool X3, class Turn>
__device__ __forceinline__ void hidden_layer128(float (&acc)[NACC],
                                             uint32_t (&ah)[KC][4],
                                             uint32_t (&al)[KC][4],
                                             Ring& ring, const Turn& turn) {
  int freed = ring.it;
  turn.wait();
  slab_issue<TRANS_B, X3, 0>(acc, ah, al, ring);
  slab_issue<TRANS_B, X3, 4>(acc, ah, al, ring);
  turn.pass();
  slab_retire<1>(acc, ring, freed);
  slab_retire<0>(acc, ring, freed);
}

// Bias and ELU of layer l's accumulator (NA floats: width W = 2 NA).
// Below the last layer the activation stays in acc and elu'(z) is saved;
// at the last layer the head gives u (rows written by lanes t = 0) and acc
// becomes the head's gradient times elu'(z).
template <bool X3, int NA>
__device__ __forceinline__ void layer_out(const Params& p, const Tile& s,
                                          float (&acc)[NA], int l,
                                          int ctid) {
  constexpr int W = 2 * NA;
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const float* bias = p.vec + (size_t)(l - 1) * W;
  if (l < p.L) {
    float2* sv = s.save + (size_t)(l - 1) * (NA / 2) * CONSUMERS + ctid;
#pragma unroll
    for (int q = 0; q < NA / 2; ++q) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * q + e;
        const float z = acc[i] + __ldg(bias + acc_col(i, t));
        const float ez = __expf(fminf(z, 0.0f));
        acc[i] = z > 0.0f ? z : ez - 1.0f;
        d[e] = z > 0.0f ? 1.0f : ez;
      }
      sv[(size_t)q * CONSUMERS] = make_float2(d[0], d[1]);
    }
    return;
  }
  const float* w_out = p.vec + (size_t)p.L * W;
  float u[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int col = acc_col(i, t);
    const float z = acc[i] + __ldg(bias + col);
    const float ez = __expf(fminf(z, 0.0f));
    const float h = z > 0.0f ? z : ez - 1.0f;
    const float w = __ldg(w_out + col);
    const float wh = bf16_round(w), hh = bf16_round(h);
    float term = hh * wh, gw = wh;
    if (X3) {
      const float wl = bf16_round(w - wh);
      term += bf16_round(h - hh) * wh + hh * wl;
      gw += wl;
    }
    u[(i >> 1) & 1] += term;
    acc[i] = gw * (z > 0.0f ? 1.0f : ez);
  }
  const float b_out = __ldg(p.vec + (size_t)(p.L + 3) * W);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    u[r] += __shfl_xor_sync(0xffffffffu, u[r], 1);
    u[r] += __shfl_xor_sync(0xffffffffu, u[r], 2);
  }
  if (t == 0) {
    s.u[16 * warp + g] = u[0] + b_out;
    s.u[16 * warp + g + 8] = u[1] + b_out;
  }
}

// The integral normals of quad q (input columns 4 q .. 4 q + 3) of tile
// kb's row (the odd sample of an antithetic pair mirrors its draw; EXT:
// from the external noise). FULL: the quad lies in nx and the row in M, so
// the draw needs no branch (the k16 chunks' draws then interleave); else
// none past nx or M (zero).
template <bool EXT, bool FULL>
__device__ __forceinline__ float4 layer1_normals(const Params& p, int b,
                                                 int kb, uint2 key, int row,
                                                 int q) {
  const int nx = p.nx, k = kb * TILE + row;
  float n[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (FULL || (4 * q < nx && k < p.M)) {
    const int kd = p.anti ? k >> 1 : k;
    const float sg = p.anti && (k & 1) ? -1.0f : 1.0f;
    if (EXT) {
      const int Md = p.anti ? p.M / 2 : p.M;
      const float* src = p.noise_i + ((size_t)b * Md + kd) * nx + 4 * q;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        n[r] = FULL || 4 * q + r < nx ? sg * src[r] : 0.0f;
    } else {
      const float4 v = unit_normals4(philox4x32_10(
          make_uint4((uint32_t)kd, (uint32_t)q, STREAM_INTEGRAL, p.seed_hi),
          key));
      n[0] = sg * v.x;
      n[1] = FULL || 4 * q + 1 < nx ? sg * v.y : 0.0f;
      n[2] = FULL || 4 * q + 2 < nx ? sg * v.z : 0.0f;
      n[3] = FULL || 4 * q + 3 < nx ? sg * v.w : 0.0f;
    }
  }
  return make_float4(n[0], n[1], n[2], n[3]);
}

// Layer 1's input at quad q of tile kb's row (x at X_s, then s, then zero
// padding) from the row's normals n, which go to the tile's rows of
// normals (s.dw, a float4 a quad) for the sums
template <bool FULL>
__device__ __forceinline__ float4 layer1_input(const Params& p, const Tile& s,
                                               int kb, int row, int q,
                                               float4 n) {
  const int nx = p.nx;
  if (FULL || (4 * q < nx && kb * TILE + row < p.M))
    reinterpret_cast<float4*>(s.dw)[row * (s.ld / 4) + q] = n;
  const float e[4] = {n.x, n.y, n.z, n.w};
  float a[4];
  const float sig = s.sig[row];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = 4 * q + r;
    a[r] = FULL || j < nx ? s.xrow[j] + sig * e[r]
                          : (j == nx ? s.s_val[row] : 0.0f);
  }
  return make_float4(a[0], a[1], a[2], a[3]);
}

// Layer 1's A fragments of K-slab sb (W1's columns in quad order,
// pack_mlp_tc's quad_frags): k16 chunk c = 4 sb + kk holds, in registers h
// and h + 2 of row h (r0, r1), quad 4 c + t of that row, drawn here. ANTI
// (FULL, own draws, antithetic pairing): the rows of a pair, 2 p and
// 2 p + 1, lie in lanes 4 g + t and its partner lane ^ 4 (g even, g + 1),
// so each lane draws one pair's quad (an even lane its row r0's, an odd
// one its row r1's) and takes the other's from its partner: each draw is
// made once.
template <bool EXT, bool FULL, bool ANTI>
__device__ __forceinline__ void layer1_slab(const Params& p, const Tile& s,
                                            int b, int kb, uint2 key, int r0,
                                            int r1, int t, int sb,
                                            uint32_t (&ah)[4][4],
                                            uint32_t (&al)[4][4]) {
  const bool odd = r0 & 1;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int q = 4 * (4 * sb + kk) + t;
    float4 n[2];
    if constexpr (ANTI) {
      // the even row of this lane's pair: its draw, unmirrored
      const float4 v = layer1_normals<false, true>(p, b, kb, key,
                                                   odd ? r1 - 1 : r0, q);
      float4 w;
      w.x = __shfl_xor_sync(0xffffffffu, v.x, 4);
      w.y = __shfl_xor_sync(0xffffffffu, v.y, 4);
      w.z = __shfl_xor_sync(0xffffffffu, v.z, 4);
      w.w = __shfl_xor_sync(0xffffffffu, v.w, 4);
      n[0] = odd ? make_float4(-w.x, -w.y, -w.z, -w.w) : v;
      n[1] = odd ? make_float4(-v.x, -v.y, -v.z, -v.w) : w;
    } else {
      n[0] = layer1_normals<EXT, FULL>(p, b, kb, key, r0, q);
      n[1] = layer1_normals<EXT, FULL>(p, b, kb, key, r1, q);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = layer1_input<FULL>(p, s, kb, h ? r1 : r0, q, n[h]);
      split_hi_lo(v.x, v.y, ah[kk][h], al[kk][h]);
      split_hi_lo(v.z, v.w, ah[kk][h + 2], al[kk][h + 2]);
    }
  }
}

// u and sum_j u_x_j of the frozen net (hidden width W: 128 or 64) at
// (s, X_s) for the tile's rows (written to s.u, s.sux). All consumers,
// warp-uniformly; each group of products issued in its turn.
template <bool X3, int W, class Turn>
__device__ __forceinline__ void net_pass_narrow(const Params& p,
                                                const Tile& s, Ring& ring,
                                                int ctid, const Turn& turn,
                                                int b, int kb, uint2 key) {
  constexpr int NA = W / 2;
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int L = p.L, nx = p.nx, n1 = k1_of(nx) / SLAB_K;
  float acc[NA];

  // layer 1: [X_s, s] W1p^T in K-slabs, each slab's A drawn in registers
  // (layer1_slab: without a branch where the slab lies in nx and the tile
  // in M) and the normals kept in the tile's rows for the sums
  zero(acc);
  const bool ext = p.noise_i != nullptr;
  const bool rows = (kb + 1) * TILE <= p.M;
  for (int sb = 0; sb < n1; ++sb) {
    uint32_t ah[4][4], al[4][4];
    const bool full = rows && SLAB_K * (sb + 1) <= nx;
    if (ext)
      layer1_slab<true, false, false>(p, s, b, kb, key, r0, r1, t, sb, ah,
                                      al);
    else if (full && p.anti)
      layer1_slab<false, true, true>(p, s, b, kb, key, r0, r1, t, sb, ah, al);
    else if (full)
      layer1_slab<false, true, false>(p, s, b, kb, key, r0, r1, t, sb, ah,
                                      al);
    else
      layer1_slab<false, false, false>(p, s, b, kb, key, r0, r1, t, sb, ah,
                                       al);
    slab_turn<0, X3>(acc, ah, al, ring, turn);
  }
  layer_out<X3>(p, s, acc, 1, ctid);

  // hidden layers 2..L forward
  for (int l = 2; l <= L; ++l) {
    uint32_t ah[NA / 8][4], al[NA / 8][4];
    to_frags(acc, ah, al);
    zero(acc);
    if constexpr (W == H)
      hidden_layer128<0, X3>(acc, ah, al, ring, turn);
    else
      slab_turn<0, X3>(acc, ah, al, ring, turn);
    layer_out<X3>(p, s, acc, l, ctid);
  }

  // backward through hidden layers L..2: g_{l-1} = (g_l W_l) elu'(z_{l-1})
  for (int l = L; l >= 2; --l) {
    uint32_t ah[NA / 8][4], al[NA / 8][4];
    to_frags(acc, ah, al);
    zero(acc);
    if constexpr (W == H)
      hidden_layer128<1, X3>(acc, ah, al, ring, turn);
    else
      slab_turn<1, X3>(acc, ah, al, ring, turn);
    const float2* sv = s.save + (size_t)(l - 2) * (NA / 2) * CONSUMERS + ctid;
#pragma unroll
    for (int q = 0; q < NA / 2; ++q) {
      const float2 d = sv[(size_t)q * CONSUMERS];
      acc[2 * q] *= d.x;
      acc[2 * q + 1] *= d.y;
    }
  }

  // sum_j u_x_j = sum_n g1_n sum_j W1[n, 1 + j], with _split3's products
  const float* wc_hi = p.vec + (size_t)(L + 1) * W;
  const float* wc_lo = p.vec + (size_t)(L + 2) * W;
  float sx[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int col = acc_col(i, t);
    const float gh = bf16_round(acc[i]), ch = __ldg(wc_hi + col);
    float term = gh * ch;
    if (X3) term += gh * __ldg(wc_lo + col) + bf16_round(acc[i] - gh) * ch;
    sx[(i >> 1) & 1] += term;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sx[r] += __shfl_xor_sync(0xffffffffu, sx[r], 1);
    sx[r] += __shfl_xor_sync(0xffffffffu, sx[r], 2);
  }
  if (t == 0) {
    s.sux[r0] = sx[0];
    s.sux[r1] = sx[1];
  }
}

// The producer warp at width 64: per tile pair, layer 1's K-slabs (W1's 64
// rows, input columns 64 sb ..: 8 rows of 8 cores), then each hidden
// layer's whole 64 x 64 image forward (2 .. L) and backward (L .. 2), one
// copy of 8 KB a piece.
__device__ __forceinline__ void produce64(const Params& p, uint32_t ring,
                                          uint32_t full, uint32_t empty,
                                          int lane, int stages,
                                          int stage_bytes, int copies,
                                          int nimg) {
  const int L = p.L, K1 = k1_of(p.nx);
  const int n1 = K1 / SLAB_K, nslab = n1 + 2 * (L - 1);
  const int ntile = (p.M + TILE - 1) / TILE;
  const __nv_bfloat16* hidden = p.img + (size_t)nimg * H64 * K1;
  int it = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; kb += NWG)
      for (int sl = 0; sl < nslab; ++sl, ++it) {
        const int st = it % stages, round = it / stages;
        if (round > 0) mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
        const __nv_bfloat16* src;
        size_t img_off, row_stride = 0;
        int rows = 8, row_bytes = 1024;
        if (sl < n1) {  // W1, input columns 64 sl ..
          src = p.img + (size_t)8 * sl * 64;
          img_off = (size_t)H64 * K1;
          row_stride = (size_t)K1 * 8;
        } else {
          const int f = sl - n1;
          const int l = f < L - 1 ? 2 + f : L - (f - (L - 1));
          src = hidden + (size_t)(l - 2) * nimg * H64 * H64;
          img_off = (size_t)H64 * H64;
          rows = 1;
          row_bytes = H64 * H64 * 2;
        }
        const uint32_t bar = full + 8 * st;
        if (lane == 0)
          mbar_expect_tx(bar, (uint32_t)(rows * row_bytes * copies));
        __syncwarp();
        for (int c = lane; c < rows * copies; c += 32) {
          const int im = c / rows, r = c - im * rows;
          bulk_copy(ring + (uint32_t)(st * stage_bytes + im * IMAGE_BYTES +
                                      r * row_bytes),
                    src + im * img_off + r * row_stride, (uint32_t)row_bytes,
                    bar);
        }
      }
}

// ---- width 256: the layer chain on chip (generate_tc_kernel<P, N256>) -----
// At width 256 a tile's layer output, kept as the bf16 images (hi, and lo
// under bf16x3) that the next product reads, is 32 KB an image: each
// consumer warpgroup keeps its own 64-row tile's in shared memory (64 KB,
// act), and a layer is one m64n256 product per k16 chunk (128 f32
// accumulators a thread) with A read from that image and B from the ring,
// whose stages are 256-row k16 slabs (8 KB an image, hi and lo: 16 KB, one
// contiguous copy each: pack_mlp_tc's chunk_major images), so that every
// input chunk and every weight slab is read once a layer; the products
// overwrite nothing until their last wait, so the epilogue writes the
// output over the input. Both warpgroups read every stage (a weight byte
// serves 128 samples), without turns, one group in flight while the next
// is issued; a stage is freed by each consumer warp's lane 0.
// Both chains run on the consumers (no terminal warps: the producer
// warpgroup keeps 40 registers, the consumers take 232). A tile's normals
// are drawn once, before its net pass, in a phase of their own with no
// accumulator live (draw_tile256: both chains, two quads of each at a
// time, the terminal chain's first pass summed there), into the
// warpgroup's rows in global scratch; layer 1 builds each chunk's A from
// them (the next chunk's loaded while the current one is built) into a
// 2 KB slot of the image, and the sums read them once more after the net
// (accumulate256). Why: the wide pass built layer 1's A from normals in
// scratch with each load on the products' path, and its terminal warps
// (one a scheduler) ran latency-bound; drawing the normals again where
// they are used, inside the product loops, left too few registers beside
// the 128 accumulators (spills), and the draws are bound by the card's
// rate for them, not by their latency (PERF.md §6), so each normal
// is drawn once, where nothing else is live. The saved ELU derivatives (TILE x 256
// f32 a layer) stay in scratch too, as float4, prefetched to L2 while the
// backward layer's products run.

// d (64 x 256 f32) += A (64 x 16 bf16, shared memory at da) B (16 x 256
// bf16, shared memory at db; TRANS_B = 1: read MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma256(float (&d)[2 * NACC], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      " %0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}

// A tile image: core matrices of 8 rows x 8 columns (128 B), core (row /
// 8, col / 8) at ((col / 8) x 8 + row / 8) x 128 B, so a k16 chunk is 2 KB
// (LBO 1024 B along K, SBO 128 B along M); B slabs: forward K-major, 32
// core rows of 2 cores (LBO 128 B, SBO 256 B), backward the 16 rows of W
// MN-major, 2 core rows of 32 cores (LBO 4096 B along K, SBO 128 B)
__device__ __forceinline__ uint32_t act_off256(int row, int col) {
  return (uint32_t)(((((col >> 3) << 3) + (row >> 3)) << 7) +
                    ((row & 7) << 4) + ((col & 7) << 1));
}
__device__ __forceinline__ uint64_t desc_a256(uint32_t a) {
  return gmma_desc(a, 1024, 128);
}
template <int TRANS_B>
__device__ __forceinline__ uint64_t desc_b256(uint32_t b) {
  return TRANS_B ? gmma_desc(b, 4096, 128) : gmma_desc(b, 128, 256);
}

// One k16 chunk's products, as one wgmma group: hi*hi (+ lo*hi + hi*lo
// under bf16x3), A's chunk at byte a (hi image; lo A256_IMAGE after), B
// the stage at st (hi image; lo N256_IMAGE after)
template <int TRANS_B, bool X3>
__device__ __forceinline__ void chunk256(float (&acc)[2 * NACC], uint32_t a,
                                         uint32_t st) {
  fence_acc(acc);
  wgmma_fence();
  const uint64_t da = desc_a256(a), db = desc_b256<TRANS_B>(st);
  wgmma256<TRANS_B>(acc, da, db);
  if (X3) {
    wgmma256<TRANS_B>(acc, desc_a256(a + A256_IMAGE), db);
    wgmma256<TRANS_B>(acc, da, desc_b256<TRANS_B>(st + N256_IMAGE));
  }
  wgmma_commit();
}

// After chunk c's group was issued: wait for chunk c - 1's and free its
// stage (nothing at c = 0)
// (a stage is free once each consumer warp's lane 0 released it:
// EMPTY256_ARRIVALS)
__device__ __forceinline__ void release256(Ring& ring, int n) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) ring.release_slab(n);
}
__device__ __forceinline__ void retire256(float (&acc)[2 * NACC], Ring& ring,
                                          int c, int& freed) {
  if (c > 0) {
    wgmma_wait<1>();
    fence_acc(acc);
    release256(ring, freed++);
  }
}
__device__ __forceinline__ void drain256(float (&acc)[2 * NACC], Ring& ring,
                                         int& freed) {
  wgmma_wait<0>();
  fence_acc(acc);
  release256(ring, freed++);
}

// the shared-memory writes of this warpgroup's threads, made visible to
// its products
__device__ __forceinline__ void publish256(int wg) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(BAR_WG + wg, CONSUMERS);
}

// columns (col, col + 1) of row, f32 values a, b, into the tile image:
// split_hi_lo's pieces, each pair rounded by one packing conversion
template <bool X3>
__device__ __forceinline__ void put_pair256(unsigned char* act, int row,
                                            int col, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t o = act_off256(row, col);
  *reinterpret_cast<__nv_bfloat162*>(act + o) = h;
  if (X3)
    *reinterpret_cast<__nv_bfloat162*>(act + A256_IMAGE + o) =
        __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
}

// a point's terms of the terminal chain: cT = sqrt(Tt) sqrt(a), sum_j x_j,
// g(x)
struct PointTerm {
  float cT, sx, g0;
};

// a warpgroup's sums over a point's samples in shared memory (1 + nx
// each: the value, then the columns): the terminal chain's and the
// integral chain's
struct Sums256 {
  float* t;
  float* i;
};

// the normals of quad q (dimensions 4 q ..) of draw kd on a chain (its
// external noise, or its own draws on `stream`: draws.cuh's guard-free
// Box-Muller, philox.cuh's bits), zero past nx
__device__ __forceinline__ void quad256(const Params& p, const float* noise,
                                        uint32_t stream, int b, int kd, int q,
                                        uint2 key, float (&v)[4]) {
  const int nx = p.nx;
  if (noise) {
    const int Md = p.anti ? p.M / 2 : p.M;
    const float* src = noise + ((size_t)b * Md + kd) * nx;
#pragma unroll
    for (int r = 0; r < 4; ++r) v[r] = 4 * q + r < nx ? src[4 * q + r] : 0.0f;
    return;
  }
  const float4 n = unit_normals4(philox4x32_10(
      make_uint4((uint32_t)kd, (uint32_t)q, stream, p.seed_hi), key));
  v[0] = n.x;
  v[1] = 4 * q + 1 < nx ? n.y : 0.0f;
  v[2] = 4 * q + 2 < nx ? n.z : 0.0f;
  v[3] = 4 * q + 3 < nx ? n.w : 0.0f;
}

// Layer 1's chunk c of the tile's A, [X_s, s] (zero past it), into slot c
// mod 16 of the image: 64 rows x 4 quads, two (row, quad) a thread, rows
// ctid / 4 and ctid / 4 + 32, quad 4 c + ctid mod 4, from their integral
// normals v (draw_tile256's, the odd sample's mirrored)
template <bool X3>
__device__ __forceinline__ void layer1_chunk256(const Params& p,
                                                const Tile& s,
                                                unsigned char* act, int c,
                                                int ctid,
                                                const float4 (&v)[2]) {
  const int nx = p.nx, qq = ctid & 3, q = 4 * c + qq;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (ctid >> 2) + 32 * h;
    const float n[4] = {v[h].x, v[h].y, v[h].z, v[h].w};
    float xs[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * q + r;
      xs[r] = j < nx ? s.xrow[j] + s.sig[row] * n[r]
                     : (j == nx ? s.s_val[row] : 0.0f);
    }
    const int col = 16 * (c & 15) + 4 * qq;
    put_pair256<X3>(act, row, col, xs[0], xs[1]);
    put_pair256<X3>(act, row, col + 2, xs[2], xs[3]);
  }
}

// this thread's integral normals of layer 1's chunk c (zero past the tile's
// rows and past nx), from scratch
__device__ __forceinline__ void chunk_normals256(const Params& p,
                                                 const Tile& s, int c,
                                                 int kb, int ctid,
                                                 float4 (&v)[2]) {
  const int q = 4 * c + (ctid & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (ctid >> 2) + 32 * h;
    v[h] = 4 * q < p.nx && kb * TILE + row < p.M
               ? reinterpret_cast<const float4*>(s.dw)[row * s.ld + q]
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The tile's draws, before its net pass (no accumulator live): for this
// thread's 128 (row, quad) items, quad 4 m + ctid mod 4 of rows ctid / 4
// and ctid / 4 + 32, both chains' normals (the integral chain's mirrored
// for the odd sample of a pair) to the tile's rows in scratch (s.dw, then
// the terminal chain's TILE rows on), and the terminal chain's first pass
// (a draw's sum over its dimensions) into sn; two quads of each chain at a
// time. EXT: from the external noise; else its own draws, in a loop of
// their own (chip_smoke.py counts its SASS per normal)
template <bool EXT>
__device__ __forceinline__ void draw_tile256(const Params& p, const Tile& s,
                                             int b, int kb, uint2 key,
                                             int ctid, float (&sn)[2]) {
  const int nx = p.nx, qq = ctid & 3;
  float4* dwi = reinterpret_cast<float4*>(s.dw);
  float4* dwt = dwi + TILE * s.ld;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int row = (ctid >> 2) + 32 * h, k = kb * TILE + row;
    if (k >= p.M) continue;
    const int kd = p.anti ? k >> 1 : k;
    const float sg = p.anti && (k & 1) ? -1.0f : 1.0f;
    float sum = 0.0f;
#pragma unroll 1
    for (int m = 0; m < 64; m += 2) {
      const int q = 4 * m + qq;
      if (4 * q >= nx) break;
      const bool two = 4 * q + 16 < nx;
      float w[2][4], v[2][4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (EXT) {
          quad256(p, p.noise_t, STREAM_TERMINAL, b, kd, q + 4 * e, key, w[e]);
          quad256(p, p.noise_i, STREAM_INTEGRAL, b, kd, q + 4 * e, key, v[e]);
        } else {
          quad256(p, nullptr, STREAM_TERMINAL, b, kd, q + 4 * e, key, w[e]);
          quad256(p, nullptr, STREAM_INTEGRAL, b, kd, q + 4 * e, key, v[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e && !two) break;
        dwt[row * s.ld + q + 4 * e] =
            make_float4(w[e][0], w[e][1], w[e][2], w[e][3]);
        dwi[row * s.ld + q + 4 * e] = make_float4(
            sg * v[e][0], sg * v[e][1], sg * v[e][2], sg * v[e][3]);
        sum += (w[e][0] + w[e][1]) + (w[e][2] + w[e][3]);
      }
    }
    sn[h] = sum;
  }
}

// One hidden layer's products (TRANS_B = 0 forward, 1 backward) from the
// tile image into acc, 16 chunks, one group in flight while the next is
// issued; side(): work of the consumers' own beside each group (it touches
// neither acc nor the image)
template <int TRANS_B, bool X3, class Side>
__device__ __forceinline__ void layer256(float (&acc)[2 * NACC],
                                         uint32_t act_s, Ring& ring, int wg,
                                         Side side) {
  publish256(wg);
  zero(acc);
  int freed = ring.it;
  for (int c = 0; c < N256 / 16; ++c) {
    const uint32_t st = ring.acquire();
    chunk256<TRANS_B, X3>(acc, act_s + (uint32_t)(c * A256_CHUNK), st);
    side(c);
    retire256(acc, ring, c, freed);
  }
  drain256(acc, ring, freed);
}

// keeps the compiler from hoisting the next elements' loads above the
// elements before: an epilogue's 128 accumulators leave few registers
__device__ __forceinline__ void batch_fence() {
  asm volatile("" ::: "memory");
}

// g1 contracted with W1's column sums over x, _split3's products (the
// columns in colsum_wide's order)
template <bool X3>
__device__ __forceinline__ void colsum256(const Params& p,
                                          const float (&acc)[2 * NACC],
                                          int t, float (&sx)[2]) {
  const float* wc_hi = p.vec + (size_t)(p.L + 1) * N256;
  const float* wc_lo = p.vec + (size_t)(p.L + 2) * N256;
#pragma unroll
  for (int i = 0; i < 2 * NACC; ++i) {
    const int col = acc_col(i, t);
    const float gh = bf16_round(acc[i]), ch = __ldg(wc_hi + col);
    float term = gh * ch;
    if (X3) term += gh * __ldg(wc_lo + col) + bf16_round(acc[i] - gh) * ch;
    sx[(i >> 1) & 1] += term;
    if ((i & 15) == 15) batch_fence();
  }
}

// layer j's saved elu'(z) of this thread in the block's scratch: a float4
// (columns 8 m + 2 t, + 1 of rows r0 and r0 + 8) for m = 0 .. 31, each
// CONSUMERS apart
__device__ __forceinline__ float4* save256(const Tile& s, int j, int ctid) {
  return reinterpret_cast<float4*>(s.save) + (size_t)j * (NACC / 2) *
                                                 CONSUMERS + ctid;
}

// Bias and ELU of layer l's accumulator, as epi_fwd_wide's (exp on
// MUFU.EX2, as value_mlp_tc.cuh's fwd_epilogue): below the last layer the
// activation goes to the tile image and elu'(z) to scratch;
// at the last layer the head's partial sums go to u and the head's
// gradient times elu'(z) to the image (or, for a net of one layer, its
// contraction with W1's column sums to sx)
template <bool X3>
__device__ __forceinline__ void epi_fwd256(const Params& p, const Tile& s,
                                           float (&acc)[2 * NACC], int l,
                                           int ctid, unsigned char* act,
                                           float (&u)[2], float (&sx)[2]) {
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  const float* bias = p.vec + (size_t)(l - 1) * N256;
  if (l < p.L) {
    float4* sv = save256(s, l - 1, ctid);
#pragma unroll
    for (int m = 0; m < NACC / 2; ++m) {
      const int col = 8 * m + 2 * t;
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
      float d[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // rows r0 (e < 2) and r0 + 8
        const float z = acc[4 * m + e] + ((e & 1) ? bv.y : bv.x);
        const float ez = __expf(fminf(z, 0.0f));
        acc[4 * m + e] = z > 0.0f ? z : ez - 1.0f;
        d[e] = z > 0.0f ? 1.0f : ez;
      }
      sv[(size_t)m * CONSUMERS] = make_float4(d[0], d[1], d[2], d[3]);
      put_pair256<X3>(act, r0, col, acc[4 * m], acc[4 * m + 1]);
      put_pair256<X3>(act, r0 + 8, col, acc[4 * m + 2], acc[4 * m + 3]);
      if ((m & 3) == 3) batch_fence();
    }
    return;
  }
  const float* w_out = p.vec + (size_t)p.L * N256;
#pragma unroll
  for (int i = 0; i < 2 * NACC; ++i) {
    const int col = acc_col(i, t);
    const float z = acc[i] + __ldg(bias + col);
    const float ez = __expf(fminf(z, 0.0f));
    const float a = z > 0.0f ? z : ez - 1.0f;
    const float w = __ldg(w_out + col);
    const float wh = bf16_round(w), ah = bf16_round(a);
    float term = ah * wh, gw = wh;
    if (X3) {
      const float wl = bf16_round(w - wh);
      term += bf16_round(a - ah) * wh + ah * wl;
      gw += wl;
    }
    u[(i >> 1) & 1] += term;
    acc[i] = gw * (z > 0.0f ? 1.0f : ez);
    if ((i & 15) == 15) batch_fence();
  }
  if (p.L == 1) {
    colsum256<X3>(p, acc, t, sx);
    return;
  }
#pragma unroll
  for (int q = 0; q < NACC; ++q) {
    put_pair256<X3>(act, r0 + 8 * (q & 1), 8 * (q >> 1) + 2 * t, acc[2 * q],
                    acc[2 * q + 1]);
    if ((q & 7) == 7) batch_fence();
  }
}

// The backward epilogue at layer l: the gradient times the saved
// elu'(z_{l-1}) (loaded 16 pairs at a time), to the tile image, or at l = 2
// contracted with W1's column sums
template <bool X3>
__device__ __forceinline__ void epi_bwd256(const Params& p, const Tile& s,
                                           float (&acc)[2 * NACC], int l,
                                           int ctid, unsigned char* act,
                                           float (&sx)[2]) {
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;
  const float4* sv = save256(s, l - 2, ctid);
#pragma unroll
  for (int m0 = 0; m0 < NACC / 2; m0 += 8) {
    float4 d[8];
#pragma unroll
    for (int m = 0; m < 8; ++m) d[m] = sv[(size_t)(m0 + m) * CONSUMERS];
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      acc[4 * (m0 + m)] *= d[m].x;
      acc[4 * (m0 + m) + 1] *= d[m].y;
      acc[4 * (m0 + m) + 2] *= d[m].z;
      acc[4 * (m0 + m) + 3] *= d[m].w;
    }
  }
  if (l == 2) {
    colsum256<X3>(p, acc, t, sx);
    return;
  }
#pragma unroll
  for (int q = 0; q < NACC; ++q) {
    put_pair256<X3>(act, r0 + 8 * (q & 1), 8 * (q >> 1) + 2 * t, acc[2 * q],
                    acc[2 * q + 1]);
    if ((q & 7) == 7) batch_fence();
  }
}

// The terminal chain's weights of tile kb's rows from their sums of
// normals (sn: this thread's quads, rows ctid / 4 and ctid / 4 + 32),
// summed over the row's 4 threads: ct, the weight of the row's draw's
// normals (the odd sample of an antithetic pair: its mirror's), and cv,
// g(X_T) - g0 (0 past M); g(x) = sigmoid(T + k sum x), sum X_T = sum x +
// cT sum dW
__device__ __forceinline__ void term_weights256(const Params& p,
                                                const Tile& s, int kb,
                                                int ctid, float (&sn)[2],
                                                const PointTerm& pt) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sn[h] += __shfl_xor_sync(0xffffffffu, sn[h], 1);
    sn[h] += __shfl_xor_sync(0xffffffffu, sn[h], 2);
  }
  if (ctid & 3) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = (ctid >> 2) + 32 * h, k = kb * TILE + row;
    const bool odd = p.anti && (k & 1);
    const float sw = odd ? -sn[h] : sn[h];
    const float d = g_cha(p.T, p.k, fmaf(pt.cT, sw, pt.sx)) - pt.g0;
    const bool valid = k < p.M;
    s.ct[row] = valid ? (odd ? -d : d) : 0.0f;
    s.cv[row] = valid ? d : 0.0f;
  }
}

// u and sum_j u_x_j of a 256-wide net at (s, X_s) for tile kb's rows
// (written to s.u, s.sux); act: this warpgroup's tile image
template <bool X3>
__device__ __forceinline__ void net_pass256(const Params& p, const Tile& s,
                                            Ring& ring, int ctid, int wg,
                                            unsigned char* act, int kb) {
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int L = p.L, n1 = chunks1(p.nx);
  const uint32_t act_s = smem_u32(act);
  float u[2] = {0.0f, 0.0f}, sx[2] = {0.0f, 0.0f};
  float acc[2 * NACC];

  // layer 1: each chunk's A into its slot from the kept normals (the next
  // chunk's loaded before), then its products
  zero(acc);
  int freed = ring.it;
  float4 v[2], vn[2];
  chunk_normals256(p, s, 0, kb, ctid, v);
  for (int c = 0; c < n1; ++c) {
    if (c + 1 < n1) chunk_normals256(p, s, c + 1, kb, ctid, vn);
    layer1_chunk256<X3>(p, s, act, c, ctid, v);
    publish256(wg);
    const uint32_t st = ring.acquire();
    chunk256<0, X3>(acc, act_s + (uint32_t)((c & 15) * A256_CHUNK), st);
    retire256(acc, ring, c, freed);
    v[0] = vn[0];
    v[1] = vn[1];
  }
  drain256(acc, ring, freed);
  epi_fwd256<X3>(p, s, acc, 1, ctid, act, u, sx);

  // hidden layers 2..L forward, then backward through L..2 (the saved
  // derivatives each backward epilogue reads, prefetched to L2 as its
  // products start)
  for (int l = 2; l <= L; ++l) {
    layer256<0, X3>(acc, act_s, ring, wg, [](int) {});
    epi_fwd256<X3>(p, s, acc, l, ctid, act, u, sx);
  }
  for (int l = L; l >= 2; --l) {
    const float4* sv = save256(s, l - 2, ctid);
    layer256<1, X3>(acc, act_s, ring, wg, [&](int c) {
      asm volatile("prefetch.global.L2 [%0];" ::"l"(sv + 2 * c * CONSUMERS));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(sv + (2 * c + 1) *
                                                            CONSUMERS));
    });
    epi_bwd256<X3>(p, s, acc, l, ctid, act, sx);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], o);
      sx[r] += __shfl_xor_sync(0xffffffffu, sx[r], o);
    }
  }
  if (t == 0) {
    const float b_out = __ldg(p.vec + (size_t)(L + 3) * N256);
    s.u[r0] = u[0] + b_out;
    s.u[r1] = u[1] + b_out;
    s.sux[r0] = sx[0];
    s.sux[r1] = sx[1];
  }
}

// The point's sums over tile kb's rows, in row order, from the normals
// the pass kept in scratch (s.dw: the integral chain's, mirrored; after
// it the terminal chain's, as drawn): the values (thread 0: the
// terminal's g(X_T) - g0, the integral's Tt (f - f0)) and the columns
// 4 q + 1 .. of this thread's two quads, q = ctid, ctid + CONSUMERS (a: in
// shared memory between tiles), 8 rows' loads in flight
__device__ __forceinline__ void accumulate256(const Params& p, const Tile& s,
                                              int kb, int ctid,
                                              const Sums256& a) {
  const int nx = p.nx, Q = (nx + 3) / 4;
  const int rows = p.M - kb * TILE < TILE ? p.M - kb * TILE : TILE;
  if (ctid == 0) {
    float tv = a.t[0], iv = a.i[0];
    for (int row = 0; row < TILE; ++row) {
      tv += s.cv[row];
      iv += s.c_i[row];
    }
    a.t[0] = tv;
    a.i[0] = iv;
  }
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int q = ctid + CONSUMERS * h;
    if (q >= Q) continue;
    const float4* di = reinterpret_cast<const float4*>(s.dw) + q;
    const float4* dt = di + TILE * s.ld;
    float ts[4], is[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool in = 4 * q + r < nx;
      ts[r] = in ? a.t[1 + 4 * q + r] : 0.0f;
      is[r] = in ? a.i[1 + 4 * q + r] : 0.0f;
    }
    for (int r0 = 0; r0 < rows; r0 += 8) {
      float4 wt[8], wi[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (r0 + e < rows) {
          wt[e] = dt[(r0 + e) * s.ld];
          wi[e] = di[(r0 + e) * s.ld];
        }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (r0 + e >= rows) break;
        const float ct = s.ct[r0 + e], cy = s.c_iy[r0 + e];
        ts[0] = fmaf(ct, wt[e].x, ts[0]);
        ts[1] = fmaf(ct, wt[e].y, ts[1]);
        ts[2] = fmaf(ct, wt[e].z, ts[2]);
        ts[3] = fmaf(ct, wt[e].w, ts[3]);
        is[0] = fmaf(cy, wi[e].x, is[0]);
        is[1] = fmaf(cy, wi[e].y, is[1]);
        is[2] = fmaf(cy, wi[e].z, is[2]);
        is[3] = fmaf(cy, wi[e].w, is[3]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (4 * q + r < nx) {
        a.t[1 + 4 * q + r] = ts[r];
        a.i[1 + 4 * q + r] = is[r];
      }
  }
}

// The producer warp of the width-256 pass: per tile pair, layer 1's
// chunks, each hidden layer's 16 chunks forward, then backward, one copy
// of 8 KB an image each. The images are ops/kernels.py:pack_mlp_tc's with
// chunk_major: W1's pieces and each hidden W's forward pieces in k16
// chunks of all 256 rows (chunk c: input columns 16 c .., 32 core rows of
// 2 cores), each hidden W's backward pieces in the core layout (rows 16 c
// .. of W contiguous), so every stage is contiguous in global memory.
__device__ __forceinline__ void produce256(const Params& p, uint32_t ring,
                                           uint32_t full, uint32_t empty,
                                           int lane, int stages, int copies,
                                           int nimg) {
  const int L = p.L, n1 = chunks1(p.nx);
  const int nf = n1 + 16 * (L - 1), nall = nf + 16 * (L - 1);
  const int ntile = (p.M + TILE - 1) / TILE;
  const size_t w1img = (size_t)N256 * k1_of(p.nx), himg = (size_t)N256 * N256;
  const size_t chunk = (size_t)N256 * 16;  // elements of a chunk's image
  const __nv_bfloat16* hidden = p.img + (size_t)nimg * w1img;
  int it = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; kb += NWG)
      for (int c = 0; c < nall; ++c, ++it) {
        const int st = it % stages, round = it / stages;
        if (round > 0) mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
        const uint32_t bar = full + 8 * st;
        if (lane == 0) mbar_expect_tx(bar, (uint32_t)(copies * N256_IMAGE));
        __syncwarp();
        if (lane >= copies) continue;
        const __nv_bfloat16* src;
        if (c < n1) {
          src = p.img + lane * w1img + c * chunk;
        } else {
          const bool fwd = c < nf;
          const int f = fwd ? c - n1 : c - nf;
          const int l = fwd ? 2 + f / 16 : L - f / 16;
          src = hidden + (size_t)(l - 2) * 2 * nimg * himg +
                (size_t)((fwd ? 0 : nimg) + lane) * himg + (f % 16) * chunk;
        }
        bulk_copy(ring + (uint32_t)(st * STAGE256 + lane * N256_IMAGE), src,
                  (uint32_t)N256_IMAGE, bar);
      }
}

// ---- the wide pass: hidden widths 384 to 1024 -----------------------------
// Each consumer warpgroup keeps its own 64-row tile, as at width 128, and
// takes a layer's hw output columns in nb = ceil(hw / 256) column blocks of
// m64n256 (nb a runtime value: one instance serves every width from 384 to
// 1024 in steps of 128; at 384, 640 and 896 the last block holds 128
// columns, its products m64n128), each over all of the layer's K. A layer's output
// (64 x hw a tile) fits neither in the registers beside the accumulator nor
// in shared memory beside the ring, so it goes to global scratch, and every
// column block of the next layer reads the whole of it. The design before this
// one kept it there in f32 and read it back a K-slab at a time into A
// fragments right before the products that took them (32 loads and 16
// hi/lo splits a thread a slab, in 128-column blocks; layer 1's A likewise
// from the tiles' normals), so each consumer waited on global loads
// between its products: at path W (2x1024, nx = 512, B = M = 4096, bf16x3)
// it took 1144.92 ms, 4.3x its bound, the loads 50-70 % of a tile's time
// at W, V and U (PERF.md §6 has its stamp trace). Here the products take A
// from shared memory, staged by the producer warp beside the weights:
//   - each epilogue writes its column block once, as the bf16 pieces (hi,
//     and lo under bf16x3) that the next layer's products read, in wgmma's
//     core-matrix layout (2 KB a k16 chunk of 64 rows: img_off), into the
//     warpgroup's buffers in global scratch; the draws write layer 1's input
//     [X_s, s] so, beside the normals the sums read (draw_wide);
//   - a ring stage is two k16 chunks: the weights' slab of the block's 256
//     rows of each piece (8 KB a chunk: pack_mlp_tc's chunk_major images
//     forward, the core layout's rows backward) and both tiles' A chunks of
//     each piece (4 KB a tile), 48 KB under bf16x3, 24 KB under "default"
//     (twice as many stages in the same bytes); the producer fills stages
//     ahead of use, so no consumer waits on a global load. A last block of
//     128 columns stages its 128 weight rows in the first half of each
//     slot and runs m64n128 products into the accumulator's first half;
//   - a layer's input is complete once both warpgroups have written their
//     last column block of the layer before (or drawn the tile): each
//     consumer fences its global writes for the async proxy and arrives on
//     a barrier (ready) that the producer waits on before staging the
//     layer's first chunk;
//   - the products run with one group in flight while the next is issued,
//     without turns.
// What binds it then (PERF.md §6): the epilogues, which both warpgroups
// run at once while the tensor pipe idles (taken out, the kernel ran at
// 1.1-1.3x the tensor bound; staging every A or weight chunk twice cost 1-3
// %). 128-column blocks ran slower (their ring at 42 bytes a tensor cycle
// against 31 here ran dry; their products alone 1.6x the bound), and so did
// an epilogue beside the next block's products in a second accumulator
// (ptxas serialised every wgmma, C7515). Each epilogue is one copy of each
// step (bias and ELU, the head, the backward product; then the image or
// the column sums: epilogue_wide), its image stores at a per-thread base
// plus constants. The pieces and the sums' order are the design before's
// (hi = bf16(a), lo = bf16(a - hi), the chunks in order, the head's and the
// column sums' terms in column order), so its output is that design's bit
// for bit. The saved ELU derivatives (f32, TILE x hw a layer) and the
// tiles' normals (f32) stay in scratch; a backward block prefetches its
// derivatives to L2 as its products start. A layer's fixed costs (its last
// epilogue, the ring's refill after ready) weigh most where its products
// are shortest: at width 384, the narrowest this pass takes, bf16x3 runs
// slower than the design before and "default" faster (PERF.md §6 PR 18).

// A piece's byte offset of element (row, col) of a tile image: k16 chunk
// col / 16 at 2 KB each, in it core (row / 8, col / 8 mod 2) at ((col / 8
// mod 2) x 8 + row / 8) x 128 B (LBO 1024 B along K, SBO 128 B along M:
// desc_a256)
__device__ __forceinline__ uint32_t img_off(int row, int col) {
  return (uint32_t)(((col >> 4) << 11) +
                    (((((col >> 3) & 1) << 3) + (row >> 3)) << 7) +
                    ((row & 7) << 4) + ((col & 7) << 1));
}

// columns (col, col + 1) of row into a tile image in global memory: hi at
// img, lo (under bf16x3) a piece later, split_hi_lo's pieces
template <bool X3>
__device__ __forceinline__ void put_pair_g(unsigned char* img, size_t piece,
                                           int row, int col, float a,
                                           float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t o = img_off(row, col);
  *reinterpret_cast<__nv_bfloat162*>(img + o) = h;
  if (X3)
    *reinterpret_cast<__nv_bfloat162*>(img + piece + o) =
        __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
}

// this thread's pair q of column block h in a tile image (img_off(r0 + 8
// (q & 1), 256 h + 8 (q >> 1) + 2 t)): a base of the thread's and the
// block's, and a constant
__device__ __forceinline__ uint32_t pair_base(int h, int ctid) {
  const int warp = ctid >> 5, lane = ctid & 31;
  return (uint32_t)(h * 32768 + warp * 256 + (lane >> 2) * 16 +
                    (lane & 3) * 4);
}
__host__ __device__ constexpr uint32_t pair_off(int q) {
  return ((q >> 2) << 11) + (((q >> 1) & 1) << 10) + ((q & 1) << 7);
}

// this thread's accumulator (column block h of a layer, its first NQ
// pairs) into a tile image: a warp's store of pair q is one 128-byte core
// matrix
template <bool X3, int NQ>
__device__ __forceinline__ void store_image(const float (&acc)[2 * NACC],
                                            unsigned char* img, size_t piece,
                                            int h, int ctid) {
  unsigned char* hi = img + pair_base(h, ctid);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
    *reinterpret_cast<__nv_bfloat162*>(hi + pair_off(q)) = v;
    if (X3)
      *reinterpret_cast<__nv_bfloat162*>(hi + piece + pair_off(q)) =
          __floats2bfloat162_rn(acc[2 * q] - __low2float(v),
                                acc[2 * q + 1] - __high2float(v));
  }
}

// A warpgroup's global scratch in the wide pass (wide_floats_wg): its saved
// elu'(z) ((L - 1) x TILE x hw f32), its tile's normals (TILE x nx f32),
// layer 1's input image (TILE x k1 bf16, hi and lo) and two images of
// layer outputs (TILE x hw bf16, hi and lo)
struct WideScratch {
  float* save;
  float* dw;
  unsigned char* x;
  unsigned char* act[2];
};
__device__ __forceinline__ WideScratch wide_scratch(const Params& p, int wg) {
  const int L = p.L, hw = p.hw;
  float* f = p.scratch + blockIdx.x * scratch_floats_wide(p.nx, L, hw) +
             wg * wide_floats_wg(p.nx, L, hw);
  WideScratch w;
  w.save = f;
  if (L > 1) f += (size_t)(L - 1) * TILE * hw;
  w.dw = f;
  f += (size_t)TILE * p.nx;
  w.x = reinterpret_cast<unsigned char*>(f);
  f += (size_t)TILE * k1_of(p.nx);
  w.act[0] = reinterpret_cast<unsigned char*>(f);
  w.act[1] = reinterpret_cast<unsigned char*>(f + (size_t)TILE * hw);
  return w;
}

// make this thread's global writes visible to the producer's bulk copies,
// and count it in at the barrier the producer waits on
__device__ __forceinline__ void publish_wide(uint32_t ready) {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  mbar_arrive(ready);
}

// The tile's integral normals (the odd sample of an antithetic pair
// mirrored) into its rows of scratch (s.dw), as draw_normals draws them,
// and layer 1's input [X_s, s] (zero to k1) as a tile image: quads 4 m +
// ctid mod 4 of rows ctid / 4 and ctid / 4 + 32 (a warp's writes of a k16
// chunk are two 128-byte core matrices)
template <bool X3>
__device__ __forceinline__ void draw_wide(const Params& p, const Tile& s,
                                          int b, int kb, uint2 key, int ctid,
                                          unsigned char* x) {
  const int nx = p.nx, K1 = k1_of(nx), Md = p.anti ? p.M / 2 : p.M;
  const size_t piece = (size_t)TILE * K1 * 2;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int row = (ctid >> 2) + 32 * h, k = kb * TILE + row;
    const bool live = k < p.M;
    const int kd = p.anti ? k >> 1 : k;
    const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
    const float sig = s.sig[row], sv = s.s_val[row];
#pragma unroll 1
    for (int m = 0; m < K1 / 16; ++m) {
      const int q = 4 * m + (ctid & 3);
      float n[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (live && 4 * q < nx) {
        if (p.noise_i) {
          const float* src = p.noise_i + ((size_t)b * Md + kd) * nx;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * q + r < nx) n[r] = sg * src[4 * q + r];
        } else {
          normals4(kd, q, STREAM_INTEGRAL, p.seed_hi, key, n);
#pragma unroll
          for (int r = 0; r < 4; ++r) n[r] *= sg;
        }
      }
      float xs[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = 4 * q + r;
        if (j < nx) s.dw[row * s.ld + j] = n[r];
        xs[r] = j < nx ? s.xrow[j] + sig * n[r] : (j == nx ? sv : 0.0f);
      }
      put_pair_g<X3>(x, piece, row, 4 * q, xs[0], xs[1]);
      put_pair_g<X3>(x, piece, row, 4 * q + 2, xs[2], xs[3]);
    }
  }
}

// d (64 x 128, f32) += A (64 x 16 bf16, shared memory at da) B (16 x 128
// bf16, shared memory at db; TRANS_B = 1: read MN-major): a last block of
// 128 columns; at 256 columns wgmma256
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[NACC], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[2 * NACC], uint64_t da,
                                         uint64_t db) {
  wgmma256<TRANS_B>(d, da, db);
}

// One column block's products over ns stages: hi*hi (+ lo*hi + hi*lo under
// bf16x3) a chunk, m64nN' (N accumulator floats: 2 N columns; A and B from
// the stage, B's chunk kk at 8 KB kk, a last block of 128 columns in the
// first half of each slot, read by desc_b256's strides), as one wgmma
// group a stage, one group in flight while the next is
// issued; each stage freed by the consumer warps' lane 0
// (EMPTY256_ARRIVALS) once its group has landed.
template <int TRANS_B, bool X3, int N>
__device__ __forceinline__ void block_products(float (&acc)[N], Ring& ring,
                                               int wg, int ns) {
  constexpr int PCS = X3 ? 2 : 1;
  const uint32_t aoff = PCS * WB_IMG + wg * PCS * WA_IMG;
  zero(acc);
  int freed = ring.it;
  for (int s = 0; s < ns; ++s) {
    const uint32_t st = ring.acquire();
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WCPS; ++kk) {
      const uint32_t b = st + kk * 8192, a = st + aoff + kk * 2048;
      const uint64_t bh = desc_b256<TRANS_B>(b), ah = desc_a256(a);
      wgmma_ss<TRANS_B>(acc, ah, bh);
      if (X3) {
        wgmma_ss<TRANS_B>(acc, desc_a256(a + WA_IMG), bh);
        wgmma_ss<TRANS_B>(acc, ah, desc_b256<TRANS_B>(b + WB_IMG));
      }
    }
    wgmma_commit();
    if (s > 0) {
      wgmma_wait<1>();
      fence_acc(acc);
      release256(ring, freed++);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  release256(ring, freed++);
}

// g1 (column block h, its first NQ pairs) contracted with W1's column sums
// over x, _split3's products
template <bool X3, int NQ>
__device__ __forceinline__ void colsum_wide(const Params& p,
                                            const float (&acc)[2 * NACC],
                                            int h, int t, float (&sx)[2]) {
  const float* wc_hi = p.vec + (size_t)(p.L + 1) * p.hw + 256 * h;
  const float* wc_lo = p.vec + (size_t)(p.L + 2) * p.hw + 256 * h;
#pragma unroll
  for (int i = 0; i < 2 * NQ; ++i) {
    const int col = acc_col(i, t);
    const float gh = bf16_round(acc[i]), ch = __ldg(wc_hi + col);
    float term = gh * ch;
    if (X3) term += gh * __ldg(wc_lo + col) + bf16_round(acc[i] - gh) * ch;
    sx[(i >> 1) & 1] += term;
  }
}

// this thread's saved elu'(z) of column block h of layer j (a float2 a
// pair of columns, CONSUMERS apart)
__device__ __forceinline__ float2* saves_wide(const Params& p, const Tile& s,
                                              int j, int h, int ctid) {
  return s.save + (size_t)(j - 1) * (p.hw / 4) * CONSUMERS +
         (size_t)64 * h * CONSUMERS + ctid;
}

// Bias and ELU of column block h (its first NQ pairs) of hidden layer l <
// L, in place, elu'(z) saved
template <int NQ>
__device__ __forceinline__ void elu_wide(const Params& p, const Tile& s,
                                         float (&acc)[2 * NACC], int l, int h,
                                         int ctid) {
  const int t = ctid & 3;
  const float* bias = p.vec + (size_t)(l - 1) * p.hw + 256 * h;
  float2* sv = saves_wide(p, s, l, h, ctid);
#pragma unroll
  for (int q0 = 0; q0 < NQ; q0 += 16) {
    float2 bv[8];  // columns 8 m + 2 t, + 1 of the chunk's 16 pairs
#pragma unroll
    for (int m = 0; m < 8; ++m)
      bv[m] = __ldg(reinterpret_cast<const float2*>(bias + 4 * q0 + 8 * m +
                                                    2 * t));
    float2 dv[16];
#pragma unroll
    for (int q = q0; q < q0 + 16; ++q) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * q + e;
        const float2 bq = bv[(q - q0) >> 1];
        const float z = acc[i] + (e ? bq.y : bq.x);
        const float ez = expf(fminf(z, 0.0f));
        acc[i] = z > 0.0f ? z : ez - 1.0f;
        d[e] = z > 0.0f ? 1.0f : ez;
      }
      dv[q - q0] = make_float2(d[0], d[1]);
    }
#pragma unroll
    for (int q = q0; q < q0 + 16; ++q) sv[(size_t)q * CONSUMERS] = dv[q - q0];
  }
}

// The head at column block h (its first NQ pairs) of the last layer: bias
// and ELU, the head's partial sums to u, and in place the head's gradient
// times elu'(z)
template <bool X3, int NQ>
__device__ __forceinline__ void head_wide(const Params& p,
                                          float (&acc)[2 * NACC], int h, int t,
                                          float (&u)[2]) {
  const int hw = p.hw;
  const float* bias = p.vec + (size_t)(p.L - 1) * hw + 256 * h;
  const float* w_out = p.vec + (size_t)p.L * hw + 256 * h;
  float2 bv[8], wv[8];  // columns 8 m + 2 t, + 1 of a chunk of 32
#pragma unroll
  for (int i = 0; i < 2 * NQ; ++i) {
    if ((i & 31) == 0)
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        bv[m] = __ldg(reinterpret_cast<const float2*>(bias + 2 * i + 8 * m +
                                                      2 * t));
        wv[m] = __ldg(reinterpret_cast<const float2*>(w_out + 2 * i + 8 * m +
                                                      2 * t));
      }
    const int m = (i & 31) >> 2;
    const float z = acc[i] + ((i & 1) ? bv[m].y : bv[m].x);
    const float ez = expf(fminf(z, 0.0f));
    const float a = z > 0.0f ? z : ez - 1.0f;
    const float w = (i & 1) ? wv[m].y : wv[m].x;
    const float wh = bf16_round(w), ah = bf16_round(a);
    float term = ah * wh, gw = wh;
    if (X3) {
      const float wl = bf16_round(w - wh);
      term += bf16_round(a - ah) * wh + ah * wl;
      gw += wl;
    }
    u[(i >> 1) & 1] += term;
    acc[i] = gw * (z > 0.0f ? 1.0f : ez);
  }
}

// The backward product at column block h (its first NQ pairs) of layer l:
// the gradient times the saved elu'(z_{l-1}), loaded 16 pairs at a time,
// each batch before any of it is used
template <int NQ>
__device__ __forceinline__ void bwd_wide(const Params& p, const Tile& s,
                                         float (&acc)[2 * NACC], int l, int h,
                                         int ctid) {
  const float2* sv = saves_wide(p, s, l - 1, h, ctid);
#pragma unroll
  for (int q0 = 0; q0 < NQ; q0 += 16) {
    float2 d[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) d[q] = sv[(size_t)(q0 + q) * CONSUMERS];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      acc[2 * (q0 + q)] *= d[q].x;
      acc[2 * (q0 + q) + 1] *= d[q].y;
    }
  }
}

// The epilogue of column block h (its first NQ pairs: NACC, or NACC / 2
// for a last block of 128 columns) of phase ph (layer l; bwd: a backward
// phase; last: the pass's last phase): one step (bias and ELU, the head,
// or the backward product), then the block to the image out or, at the
// last phase, contracted with W1's column sums
template <bool X3, int NQ>
__device__ __forceinline__ void epilogue_wide(const Params& p, const Tile& s,
                                              float (&acc)[2 * NACC],
                                              bool bwd, bool last, int l,
                                              int h, int ctid, float (&u)[2],
                                              float (&sx)[2],
                                              unsigned char* out,
                                              size_t piece) {
  const int t = ctid & 3;
  if (bwd)
    bwd_wide<NQ>(p, s, acc, l, h, ctid);
  else if (l < p.L)
    elu_wide<NQ>(p, s, acc, l, h, ctid);
  else
    head_wide<X3, NQ>(p, acc, h, t, u);
  if (last)
    colsum_wide<X3, NQ>(p, acc, h, t, sx);
  else
    store_image<X3, NQ>(acc, out, piece, h, ctid);
}

// u and sum_j u_x_j of a net of width p.hw (384 .. 1024) at (s, X_s) for
// the tile's rows (written to s.u, s.sux). Phase 0 is layer 1 (its input
// the draws' image), phases 1 .. L - 1 layers 2 .. L forward, phases L ..
// 2 L - 2 layers L .. 2 backward; phase ph writes its output to buffer ph
// mod 2 and reads the other, the last phase contracts its output with W1's
// column sums instead. After each phase but the last the consumers publish
// its output (ready).
template <bool X3>
__device__ __forceinline__ void net_pass_wide(const Params& p, const Tile& s,
                                              Ring& ring, int ctid, int wg,
                                              const WideScratch& w,
                                              uint32_t ready) {
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int L = p.L, hw = p.hw, nb = (hw + 255) / 256;
  const int nph = L > 1 ? 2 * L - 1 : 1;
  const size_t piece = (size_t)TILE * hw * 2;
  float u[2] = {0.0f, 0.0f}, sx[2] = {0.0f, 0.0f};
  float acc[2 * NACC];
  for (int ph = 0; ph < nph; ++ph) {
    const bool bwd = ph >= L, last = ph + 1 == nph;
    const int l = bwd ? 2 * L - ph : ph + 1;
    const int ns = (ph == 0 ? k1_of(p.nx) : hw) / (16 * WCPS);
    unsigned char* out = w.act[ph & 1];
    for (int h = 0; h < nb; ++h) {
      const int nq = (hw - 256 * h < 256 ? hw - 256 * h : 256) / 4;
      if (bwd) {
        // this block's saved derivatives of layer l - 1 to L2 while the
        // products run (a 128-byte line a half-warp and pair)
        const float2* sv = saves_wide(p, s, l - 1, h, ctid);
        if ((lane & 15) == 0)
#pragma unroll 4
          for (int q = 0; q < nq; ++q)
            asm volatile("prefetch.global.L2 [%0];" ::"l"(sv + q * CONSUMERS));
      }
      if (nq == NACC) {
        if (bwd)
          block_products<1, X3>(acc, ring, wg, ns);
        else
          block_products<0, X3>(acc, ring, wg, ns);
        epilogue_wide<X3, NACC>(p, s, acc, bwd, last, l, h, ctid, u, sx, out,
                                piece);
      } else {  // a last block of 128 columns: the accumulator's first half
        float(&half)[NACC] = reinterpret_cast<float(&)[NACC]>(acc);
        if (bwd)
          block_products<1, X3>(half, ring, wg, ns);
        else
          block_products<0, X3>(half, ring, wg, ns);
        epilogue_wide<X3, NACC / 2>(p, s, acc, bwd, last, l, h, ctid, u, sx,
                                    out, piece);
      }
    }
    if (!last) publish_wide(ready);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      u[r] += __shfl_xor_sync(0xffffffffu, u[r], o);
      sx[r] += __shfl_xor_sync(0xffffffffu, sx[r], o);
    }
  }
  if (t == 0) {
    const float b_out = __ldg(p.vec + (size_t)(L + 3) * hw);
    s.u[r0] = u[0] + b_out;
    s.u[r1] = u[1] + b_out;
    s.sux[r0] = sx[0];
    s.sux[r1] = sx[1];
  }
}

// The producer warp of the wide pass: per tile pair and phase, once the
// phase's input is published (ready), every stage in the consumers' order:
// column block h = 0 .. nb - 1, each over the phase's K in stages of WCPS
// chunks; a stage holds each staged piece's weight chunks (layer 1 and
// forward: pack_mlp_tc's chunk_major images, rows 128 h .. of chunks 2 s,
// 2 s + 1, 4 KB each; backward: core rows 4 s .. 4 s + 3 of W's core
// image, columns 128 h .., 2 KB each), then each warpgroup's A chunks of
// each piece (4 KB).
__device__ __forceinline__ void produce_wide(const Params& p, uint32_t ring,
                                             uint32_t full, uint32_t empty,
                                             uint32_t ready, int lane,
                                             int stages, int pcs, int nimg) {
  const int L = p.L, nx = p.nx, hw = p.hw, K1 = k1_of(nx);
  const int nb = (hw + 255) / 256, nph = L > 1 ? 2 * L - 1 : 1;
  const int ntile = (p.M + TILE - 1) / TILE;
  const uint32_t stage_bytes = (uint32_t)wide_stage_bytes(pcs);
  const __nv_bfloat16* hidden = p.img + (size_t)nimg * hw * K1;
  const WideScratch w0 = wide_scratch(p, 0), w1 = wide_scratch(p, 1);
  int it = 0, nready = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; kb += NWG)
      for (int ph = 0; ph < nph; ++ph, ++nready) {
        mbar_wait(ready, (uint32_t)(nready & 1));
        const bool bwd = ph >= L;
        const int l = bwd ? 2 * L - ph : ph + 1;
        const int K = ph == 0 ? K1 : hw, ns = K / (16 * WCPS);
        const __nv_bfloat16* wimg =
            ph == 0 ? p.img
                    : hidden + (size_t)(l - 2) * 2 * nimg * hw * hw +
                          (bwd ? (size_t)nimg * hw * hw : 0);
        const size_t wpiece = (size_t)hw * K;
        const unsigned char* a0 = ph == 0 ? w0.x : w0.act[(ph - 1) & 1];
        const unsigned char* a1 = ph == 0 ? w1.x : w1.act[(ph - 1) & 1];
        const size_t apiece = (size_t)TILE * K * 2;
        const int nbc = bwd ? 2 * WCPS : WCPS;  // weight copies a piece
        const uint32_t slot = (uint32_t)(WB_IMG / nbc);
        for (int h = 0; h < nb; ++h) {
          // a weight copy's bytes: the block's columns (256, or 128 in a
          // last block), and the stage's
          const int nc = hw - 256 * h < 256 ? hw - 256 * h : 256;
          const uint32_t bbytes = (uint32_t)(nc * 32 * WCPS / nbc);
          const uint32_t tx = (uint32_t)(pcs * (nc * 32 * WCPS + NWG * WA_IMG));
          for (int s = 0; s < ns; ++s, ++it) {
            const int st = it % stages, round = it / stages;
            if (round > 0)
              mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
            const uint32_t bar = full + 8 * st, dst = ring + st * stage_bytes;
            if (lane == 0) mbar_expect_tx(bar, tx);
            __syncwarp();
            for (int c = lane; c < pcs * (nbc + NWG); c += 32) {
              if (c < pcs * nbc) {
                const int pc = c / nbc, j = c - pc * nbc;
                const __nv_bfloat16* src =
                    wimg + pc * wpiece +
                    (bwd ? (size_t)(nbc * s + j) * (hw / 8) * 64 +
                               (size_t)32 * h * 64
                         : (size_t)(WCPS * s + j) * hw * 16 +
                               (size_t)h * 256 * 16);
                bulk_copy(dst + pc * WB_IMG + j * slot, src, bbytes, bar);
              } else {
                const int e = c - pcs * nbc, wg = e / pcs, pc = e - wg * pcs;
                const unsigned char* src =
                    (wg ? a1 : a0) + pc * apiece + (size_t)s * WA_IMG;
                bulk_copy(dst + pcs * WB_IMG + (wg * pcs + pc) * WA_IMG, src,
                          WA_IMG, bar);
              }
            }
          }
        }
      }
}

}  // namespace tc
}  // namespace dpi

namespace {

using namespace dpi;

// the point's integral sums at the columns past a consumer's registers
// (isum_floats), kept in shared memory, over the tile's rows in row order
__device__ __forceinline__ void accumulate_wide(const tc::Tile& s, int nx,
                                                int ctid, float* isum) {
  constexpr int J0 = tc::MAXJ * tc::CONSUMERS;
  for (int j = J0 + ctid; j <= nx; j += tc::CONSUMERS) {
    const float* di = s.dw + (j - 1);
    float a = isum[j - J0];
#pragma unroll 4
    for (int row = 0; row < tc::TILE; ++row)
      a = fmaf(s.c_iy[row], di[row * s.ld], a);
    isum[j - J0] = a;
  }
}

__device__ __forceinline__ float quad_sum(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

// The terminal chain of one point on warp tw of the three terminal warps:
// the warp takes D draws at a time (the warps' turns interleaved over the
// point's draws), a lane QPL quads of each (quads lane, lane + 32, ..:
// QPL = ceil(Q / 32)), so that each normal is drawn once and kept in
// registers while the draw's sum over its dimensions (a warp sum; g needs
// only sum X_T = sum x + cT sum dW) gives its weight (one sigmoid a draw,
// two with antithetic pairing); the weighted normals are then added to the
// sums of the lane's own quads (sums, in shared memory: no lane touches
// another's). D draws a turn keep four to eight quads' draws in flight:
// QPL 1, 2, 4, 8 take D = 4, 2, 2, 1 (term_point_at).
template <int QPL, int D, bool EXT>
__device__ __forceinline__ void term_point(const tc::Params& p, float* sums,
                                           int b, int tw, int lane,
                                           float cT, float sx, float g0,
                                           uint2 key, float& acc_v) {
  const int nx = p.nx, Q = (nx + 3) / 4;
  const int Md = p.anti ? p.M / 2 : p.M;
  float4* s4 = reinterpret_cast<float4*>(sums);
#pragma unroll 1
  for (int kd0 = D * tw; kd0 < Md; kd0 += D * AUX_WARPS) {
    float4 n[D][QPL];
    float part[D];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int kd = kd0 + d;
      part[d] = 0.0f;
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        // every lane draws (a quad past Q is zeroed, a draw past Md has
        // finite normals that its zero weight cancels), so the quads'
        // draws interleave
        const int q = lane + 32 * i;
        float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (EXT) {
          const float* row = p.noise_t + ((size_t)b * Md + kd) * nx;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (kd < Md && 4 * q + r < nx) e[r] = row[4 * q + r];
        } else {
          const float4 v = unit_normals4(philox4x32_10(
              make_uint4((uint32_t)kd, (uint32_t)q, STREAM_TERMINAL,
                         p.seed_hi),
              key));
          e[0] = q < Q ? v.x : 0.0f;
          e[1] = 4 * q + 1 < nx ? v.y : 0.0f;
          e[2] = 4 * q + 2 < nx ? v.z : 0.0f;
          e[3] = 4 * q + 3 < nx ? v.w : 0.0f;
        }
        n[d][i] = make_float4(e[0], e[1], e[2], e[3]);
        part[d] += quad_sum(n[d][i]);
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) part[d] = warp_sum(part[d]);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool live = kd0 + d < Md;
      const float d_p = g_cha(p.T, p.k, fmaf(cT, part[d], sx)) - g0;
      float w = d_p, dv = d_p;
      if (p.anti) {
        const float d_m = g_cha(p.T, p.k, fmaf(-cT, part[d], sx)) - g0;
        dv = d_p + d_m;
        w = d_p - d_m;
      }
      acc_v += live ? dv : 0.0f;
      w = live ? w : 0.0f;
#pragma unroll
      for (int i = 0; i < QPL; ++i) {
        const int q = lane + 32 * i;
        if (q < Q) {
          float4 a = s4[q];
          a.x = fmaf(w, n[d][i].x, a.x);
          a.y = fmaf(w, n[d][i].y, a.y);
          a.z = fmaf(w, n[d][i].z, a.z);
          a.w = fmaf(w, n[d][i].w, a.w);
          s4[q] = a;
        }
      }
    }
  }
}

// term_point at nx's turn (QPL quads a lane of D draws: QPL 1, 2, 4, 8
// with D = 4, 2, 2, 1; at QPL 4 two draws a turn ran 5.6 % faster than one
// under "default" at R's shape, the same under bf16x3)
template <bool EXT>
__device__ __forceinline__ void term_point_at(const tc::Params& p,
                                              float* sums, int b, int tw,
                                              int lane, float cT, float sx,
                                              float g0, uint2 key,
                                              float& acc_v, int qpl) {
  if (qpl <= 1)
    term_point<1, 4, EXT>(p, sums, b, tw, lane, cT, sx, g0, key, acc_v);
  else if (qpl <= 2)
    term_point<2, 2, EXT>(p, sums, b, tw, lane, cT, sx, g0, key, acc_v);
  else if (qpl <= 4)
    term_point<4, 2, EXT>(p, sums, b, tw, lane, cT, sx, g0, key, acc_v);
  else
    term_point<8, 1, EXT>(p, sums, b, tw, lane, cT, sx, g0, key, acc_v);
}

// The terminal chain of this block's points on warp tw of the three
// terminal warps, beside the consumers' products (term_point, a point at
// a time). At a point's end the warp's sums (its lanes' own quads) go to
// tred once the consumers have read the last ones.
__device__ __forceinline__ void terminal_warps(const tc::Params& p,
                                               float* tacc, float* tred,
                                               int tw, int lane) {
  const int nx = p.nx, Q = (nx + 3) / 4, qpl = (Q + 31) / 32;
  float* sums = tacc + (size_t)tw * (tc::align16((size_t)nx * 4) / 4);
  float4* s4 = reinterpret_cast<float4*>(sums);
  bool first = true;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], g0 = p.g0[b];
    const float cT = sqrtf(fmaxf(p.T - t, 1e-6f)) * p.alpha_sqrt;
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    float sx = 0.0f;
    for (int j = lane; j < nx; j += 32) sx += p.x[(size_t)b * nx + j];
    for (int q = lane; q < Q; q += 32)
      s4[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    sx = warp_sum(sx);
    float acc_v = 0.0f;
    if (p.noise_t)
      term_point_at<true>(p, sums, b, tw, lane, cT, sx, g0, key, acc_v, qpl);
    else
      term_point_at<false>(p, sums, b, tw, lane, cT, sx, g0, key, acc_v,
                           qpl);
    if (!first) tc::named_sync(BAR_TERM_FREE, TERM_BAR_THREADS);
    first = false;
    float* out = tred + tw * (1 + nx);
    if (lane == 0) out[0] = acc_v;
    for (int q = lane; q < Q; q += 32) {
      const float4 v = s4[q];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * q + r < nx) out[1 + 4 * q + r] = e[r];
    }
    tc::named_arrive(BAR_TERM_FULL, TERM_BAR_THREADS);
  }
}

// a tile of the width-256 instance: its NROWS256 rows from `rows`, its
// saved derivatives, its normals in scratch (`quads` float4 a row)
__device__ __forceinline__ tc::Tile tile256(float* rows, float* xrow,
                                            float2* save, float* dw,
                                            int quads) {
  tc::Tile s;
  s.s_val = rows;
  s.sig = rows + tc::TILE;
  s.iys = rows + 2 * tc::TILE;
  s.c_i = rows + 3 * tc::TILE;
  s.c_iy = rows + 4 * tc::TILE;
  s.u = rows + 5 * tc::TILE;
  s.sux = rows + 6 * tc::TILE;
  s.ct = rows + 7 * tc::TILE;
  s.cv = rows + 8 * tc::TILE;
  s.xrow = xrow;
  s.dw = dw;
  s.ld = quads;
  s.save = save;
  return s;
}

// the wide pass's tile: its rows and the point's x in shared memory, its
// normals and saved derivatives in the warpgroup's scratch
__device__ __forceinline__ tc::Tile tile_wide(unsigned char* smem,
                                              const tc::GPlan& pl, int nx,
                                              int wg,
                                              const tc::WideScratch& w) {
  using namespace tc;
  float* rows =
      reinterpret_cast<float*>(smem + pl.rows) + (size_t)wg * NROWS * TILE;
  Tile s;
  s.s_val = rows;
  s.sig = rows + TILE;
  s.iys = rows + 2 * TILE;
  s.c_i = rows + 3 * TILE;
  s.c_iy = rows + 4 * TILE;
  s.u = rows + 5 * TILE;
  s.sux = rows + 6 * TILE;
  s.xrow = reinterpret_cast<float*>(smem + pl.xrow);
  s.dw = w.dw;
  s.ld = nx;
  s.save = reinterpret_cast<float2*>(w.save);
  return s;
}

// The consumers of generate_tc_kernel<P, N256>: per point, each warpgroup's
// tiles, both chains on the consumers (the layer chain in the tile image
// act; the terminal chain's two passes beside the integral chain's
// draws), then the point's sums: the second warpgroup's through red, added
// by the first in a fixed order (the value and the columns 4 q + 1 .. of
// this thread's two quads in registers)
template <int P>
__device__ __forceinline__ void consumers256(const tc::Params& p,
                                             unsigned char* smem, int wg,
                                             int wtid) {
  using namespace tc;
  const GPlan& pl = p.plan;
  const int nx = p.nx, L = p.L;
  const uint32_t full = smem_u32(smem + pl.bars);
  // this warpgroup's sums and the other's (sums256_floats apart)
  const size_t nsum = sums256_floats(nx);
  float* sums = reinterpret_cast<float*>(smem + pl.red);
  const Sums256 a{sums + (size_t)wg * 2 * nsum,
                  sums + (size_t)wg * 2 * nsum + nsum};
  const Sums256 o{sums + (size_t)(wg ^ 1) * 2 * nsum,
                  sums + (size_t)(wg ^ 1) * 2 * nsum + nsum};
  float* sxw = reinterpret_cast<float*>(smem + pl.tred);  // sum_j x_j
  unsigned char* act = smem + pl.act + (size_t)wg * A256_BYTES;
  // this warpgroup's tile rows, its saved derivatives and its tile's
  // normals (the integral chain's, then the terminal chain's) in scratch
  const int Q = (nx + 3) / 4;
  float* blk = p.scratch + blockIdx.x * scratch_floats256(nx, L);
  const Tile s = tile256(
      reinterpret_cast<float*>(smem + pl.rows) + (size_t)wg * NROWS256 * TILE,
      reinterpret_cast<float*>(smem + pl.xrow),
      reinterpret_cast<float2*>(blk + (size_t)wg * saves256_floats(L)),
      blk + NWG * saves256_floats(L) + (size_t)wg * 2 * TILE * 4 * Q, Q);
  Ring ring{smem_u32(smem + pl.ring), full, full + 8 * MAX_STAGES,
            pl.stages, STAGE256, 0};
  const int ntile = (p.M + TILE - 1) / TILE;
  const int ntile2 = ntile + (ntile & 1);
  const float inv_m = 1.0f / (float)p.M;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], g0 = p.g0[b], f0 = p.f0[b];
    const float Tt = fmaxf(p.T - t, 1e-6f);
    const float inv_yT = 1.0f / (sqrtf(Tt) * p.alpha_sqrt);
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    for (int j = threadIdx.x; j < nx; j += TC_CONSUMERS)
      s.xrow[j] = p.x[(size_t)b * nx + j];
    if (threadIdx.x < 32) {  // sum_j x_j, as the terminal warps take it
      float v = 0.0f;
      for (int j = threadIdx.x; j < nx; j += 32) v += p.x[(size_t)b * nx + j];
      v = warp_sum(v);
      if (threadIdx.x == 0) *sxw = v;
    }
    for (int j = wtid; j <= nx; j += WG) a.t[j] = a.i[j] = 0.0f;
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
    const PointTerm pt{sqrtf(Tt) * p.alpha_sqrt, *sxw, g0};

    for (int kb = wg; kb < ntile2; kb += NWG) {
      draw_times(p, s, b, kb, t, Tt, key, wtid);
      float sn[2] = {0.0f, 0.0f};
      if (p.noise_i)
        draw_tile256<true>(p, s, b, kb, key, wtid, sn);
      else
        draw_tile256<false>(p, s, b, kb, key, wtid, sn);
      term_weights256(p, s, kb, wtid, sn, pt);
      named_sync(BAR_WG + wg, WG);
      net_pass256<P == 3>(p, s, ring, wtid, wg, act, kb);
      named_sync(BAR_WG + wg, WG);
      sample_weights(p, s, kb, Tt, f0, wtid);
      named_sync(BAR_WG + wg, WG);
      accumulate256(p, s, kb, wtid, a);
      named_sync(BAR_WG + wg, WG);
    }

    // the first warpgroup adds the second's sums to its own in a fixed
    // order and stores
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
    if (wg == 0) {
      float* out = p.out + (size_t)b * (1 + nx);
      for (int j = wtid; j <= nx; j += WG) {
        const float st = a.t[j] + o.t[j], si = a.i[j] + o.i[j];
        out[j] = j == 0 ? (st + si) * inv_m + g0 + f0 * Tt
                        : (st * inv_yT + si) * inv_m;
      }
    }
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
  }
}

// The point's integral sums over tile kb's rows, in row order, from the
// normals layer 1 kept in the tile's rows (s.dw, a float4 a quad): the
// value (thread 0: the rows' Tt (f - f0)) and the columns 4 q + 1 ..
// 4 q + 4 of this thread's quads q = ctid, ctid + CONSUMERS (iq), 8 rows'
// loads in flight
__device__ __forceinline__ void accumulate_quads(const tc::Params& p,
                                                 const tc::Tile& s, int kb,
                                                 int ctid, float4 (&iq)[2],
                                                 float& iv) {
  using namespace tc;
  const int Q = (p.nx + 3) / 4, ld4 = s.ld / 4;
  const int rows = p.M - kb * TILE < TILE ? p.M - kb * TILE : TILE;
  if (ctid == 0)
#pragma unroll 4
    for (int row = 0; row < TILE; ++row) iv += s.c_i[row];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = ctid + CONSUMERS * h;
    if (q >= Q) continue;
    const float4* d = reinterpret_cast<const float4*>(s.dw) + q;
    float4 a = iq[h];
    for (int r0 = 0; r0 < rows; r0 += 8) {
      float4 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (r0 + e < rows) v[e] = d[(r0 + e) * ld4];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (r0 + e >= rows) break;
        const float c = s.c_iy[r0 + e];
        a.x = fmaf(c, v[e].x, a.x);
        a.y = fmaf(c, v[e].y, a.y);
        a.z = fmaf(c, v[e].z, a.z);
        a.w = fmaf(c, v[e].w, a.w);
      }
    }
    iq[h] = a;
  }
}

// The consumers of the narrow instances, generate_tc_kernel<P, H> and
// <P, H64>: per point, each warpgroup's tiles (the time draws; the net
// pass, whose layer 1 draws the tile's integral normals and keeps them in
// the tile's rows; the rows' weights; the sums over the rows, a quad a
// thread, accumulate_quads), then the point's sums: the second
// warpgroup's through red and the terminal warps' through tred, added by
// the first in a fixed order. The zero iterate (no net) draws its normals
// in a phase of their own (draw_normals). The products are issued in
// turns (PingPong).
template <int P, int HW>
__device__ __forceinline__ void consumers_narrow(const tc::Params& p,
                                                 unsigned char* smem, int wg,
                                                 int wtid) {
  using namespace tc;
  const GPlan& pl = p.plan;
  const int nx = p.nx, L = p.has_net ? p.L : 0, Q = (nx + 3) / 4;
  const uint32_t full = smem_u32(smem + pl.bars);
  const Tile s = tile_of(smem, pl, p.lay, p, 0, wg);
  float* red = reinterpret_cast<float*>(smem + pl.red);
  const float* tred = reinterpret_cast<const float*>(smem + pl.tred);
  Ring ring{smem_u32(smem + pl.ring), full, full + 8 * MAX_STAGES, pl.stages,
            p.lay.stage_bytes, 0};
  const PingPong turn{wg};
  if (wg == 1 && L > 0) turn.pass();  // warpgroup 0 first
  const int ntile = (p.M + TILE - 1) / TILE;
  const int ntile2 = ntile + (ntile & 1);
  const float inv_m = 1.0f / (float)p.M;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], g0 = p.g0[b], f0 = p.f0[b];
    const float Tt = fmaxf(p.T - t, 1e-6f);
    const float inv_yT = 1.0f / (sqrtf(Tt) * p.alpha_sqrt);
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    for (int j = threadIdx.x; j < nx; j += TC_CONSUMERS)
      s.xrow[j] = p.x[(size_t)b * nx + j];
    float4 iq[2];
    iq[0] = iq[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float iv = 0.0f;
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);

    for (int kb = wg; kb < ntile2; kb += NWG) {
      draw_times(p, s, b, kb, t, Tt, key, wtid);
      if (L == 0) draw_normals(p, s, b, kb, key, wtid);
      named_sync(BAR_WG + wg, WG);
      if (L > 0) {
        net_pass_narrow<P == 3, HW>(p, s, ring, wtid, turn, b, kb, key);
      } else if (wtid < TILE) {
        s.u[wtid] = 0.0f;
        s.sux[wtid] = 0.0f;
      }
      named_sync(BAR_WG + wg, WG);
      sample_weights(p, s, kb, Tt, f0, wtid);
      named_sync(BAR_WG + wg, WG);
      accumulate_quads(p, s, kb, wtid, iq, iv);
      named_sync(BAR_WG + wg, WG);
    }

    if (wg == 1) {
      if (wtid == 0) red[0] = iv;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = wtid + WG * h;
        const float e[4] = {iq[h].x, iq[h].y, iq[h].z, iq[h].w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (q < Q && 4 * q + r < nx) red[1 + 4 * q + r] = e[r];
      }
    }
    named_sync(BAR_TERM_FULL, TERM_BAR_THREADS);
    if (wg == 0) {
      float* out = p.out + (size_t)b * (1 + nx);
      if (wtid == 0) {
        float sum_t = 0.0f;
#pragma unroll
        for (int w = 0; w < AUX_WARPS; ++w) sum_t += tred[w * (1 + nx)];
        out[0] = (sum_t + (iv + red[0])) * inv_m + g0 + f0 * Tt;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = wtid + WG * h;
        const float e[4] = {iq[h].x, iq[h].y, iq[h].z, iq[h].w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 1 + 4 * q + r;
          if (q < Q && j <= nx) {
            float sum_t = 0.0f;
#pragma unroll
            for (int w = 0; w < AUX_WARPS; ++w)
              sum_t += tred[w * (1 + nx) + j];
            out[j] = (sum_t * inv_yT + (e[r] + red[j])) * inv_m;
          }
        }
      }
    }
    if (b + (int)gridDim.x < p.B) named_arrive(BAR_TERM_FREE, TERM_BAR_THREADS);
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
  }
  // the second warpgroup's last pass
  if (wg == 0 && L > 0) turn.wait();
}

// The consumers of the wide pass, generate_tc_kernel<P, WIDE>: per point,
// each warpgroup's tiles (the draws and layer 1's input image, published
// to the producer; net_pass_wide; the rows' weights; the sums), then the
// point's sums: the second warpgroup's through red and the terminal warps'
// through tred, added by the first in a fixed order (the columns past a
// consumer's MAXJ registers in shared memory, isum)
template <int P>
__device__ __forceinline__ void consumers_wide(const tc::Params& p,
                                               unsigned char* smem, int wg,
                                               int wtid, int stages,
                                               uint32_t empty,
                                               uint32_t ready) {
  using namespace tc;
  const GPlan& pl = p.plan;
  const int nx = p.nx;
  const uint32_t full = smem_u32(smem + pl.bars);
  const float* tred = reinterpret_cast<const float*>(smem + pl.tred);
  // this warpgroup's tile, its rows, normals, saved derivatives and
  // images of layer inputs (in scratch)
  const WideScratch w = wide_scratch(p, wg);
  const Tile s = tile_wide(smem, pl, nx, wg, w);
  float* red = reinterpret_cast<float*>(smem + pl.red);
  const int n_isum = isum_floats(nx);
  const size_t isum_bytes = align16((size_t)n_isum * 4);
  float* isum0 = reinterpret_cast<float*>(smem + pl.isum);
  float* isum = reinterpret_cast<float*>(smem + pl.isum + wg * isum_bytes);
  float* isum1 = reinterpret_cast<float*>(smem + pl.isum + isum_bytes);
  Ring ring{smem_u32(smem + pl.ring), full, empty, stages,
            wide_stage_bytes(pieces(P)), 0};
  const int ntile = (p.M + TILE - 1) / TILE;
  const int ntile2 = ntile + (ntile & 1);
  const float inv_m = 1.0f / (float)p.M;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], g0 = p.g0[b], f0 = p.f0[b];
    const float Tt = fmaxf(p.T - t, 1e-6f);
    const float inv_yT = 1.0f / (sqrtf(Tt) * p.alpha_sqrt);
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    for (int j = threadIdx.x; j < nx; j += TC_CONSUMERS)
      s.xrow[j] = p.x[(size_t)b * nx + j];
    for (int j = wtid; j < n_isum; j += WG) isum[j] = 0.0f;
    float acc[MAXJ] = {0.0f, 0.0f, 0.0f, 0.0f};
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);

    for (int kb = wg; kb < ntile2; kb += NWG) {
      draw_times(p, s, b, kb, t, Tt, key, wtid);
      named_sync(BAR_WG + wg, WG);
      draw_wide<P == 3>(p, s, b, kb, key, wtid, w.x);
      publish_wide(ready);
      net_pass_wide<P == 3>(p, s, ring, wtid, wg, w, ready);
      named_sync(BAR_WG + wg, WG);
      sample_weights(p, s, kb, Tt, f0, wtid);
      named_sync(BAR_WG + wg, WG);
      accumulate(s, nx, wtid, acc);
      accumulate_wide(s, nx, wtid, isum);
      named_sync(BAR_WG + wg, WG);
    }

    // the second warpgroup's integral sums to red, the terminal warps'
    // sums from tred; the first adds them in a fixed order and stores
    if (wg == 1)
#pragma unroll
      for (int r = 0; r < MAXJ; ++r) {
        const int j = wtid + r * WG;
        if (j <= nx) red[j] = acc[r];
      }
    named_sync(BAR_TERM_FULL, TERM_BAR_THREADS);
    if (wg == 0) {
      float* out = p.out + (size_t)b * (1 + nx);
#pragma unroll
      for (int r = 0; r < MAXJ; ++r) {
        const int j = wtid + r * WG;
        if (j <= nx) {
          float sum_t = 0.0f;
#pragma unroll
          for (int w = 0; w < AUX_WARPS; ++w) sum_t += tred[w * (1 + nx) + j];
          const float a = acc[r] + red[j];
          out[j] = j == 0 ? (sum_t + a) * inv_m + g0 + f0 * Tt
                          : (sum_t * inv_yT + a) * inv_m;
        }
      }
      for (int j = MAXJ * WG + wtid; j <= nx; j += WG) {
        float sum_t = 0.0f;
#pragma unroll
        for (int w = 0; w < AUX_WARPS; ++w) sum_t += tred[w * (1 + nx) + j];
        const int i = j - MAXJ * WG;
        out[j] = (sum_t * inv_yT + (isum0[i] + isum1[i])) * inv_m;
      }
    }
    if (b + (int)gridDim.x < p.B) named_arrive(BAR_TERM_FREE, TERM_BAR_THREADS);
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
  }
}

// P: the net's passes (3: bf16x3, 1: one bf16 pass); HW: the instance of the
// hidden width (H64, H: net_pass_narrow; WIDE: widths 384 to 1024,
// net_pass_wide, the width read from p.hw). A block: two consumer
// warpgroups, each on its own 64-row tile (tiles 2 i and 2 i + 1 of a point;
// the second warpgroup takes an empty tile past the last when a point's tiles
// are odd, to keep the ring's pace), both reading every stage; the producer
// warpgroup: one warp streaming the stages, three running the terminal chain.
// The output columns from MAXJ x 128 on (nx >= 512) are summed in shared memory
// (isum), each warpgroup its own row.
template <int P, int HW>
__global__ void __launch_bounds__(TC_THREADS, 1)
generate_tc_kernel(const tc::Params p) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const int L = p.has_net ? p.L : 0;
  const Layout& lay = p.lay;
  const GPlan& pl = p.plan;
  const uint32_t full = smem_u32(smem + pl.bars);
  // the wide pass: its own count of stages and barriers, and the barrier
  // of its published layer outputs
  constexpr int NBARS = HW == WIDE ? WIDE_MAX_STAGES : MAX_STAGES;
  const uint32_t empty = full + 8 * NBARS, ready = empty + 8 * NBARS;
  const int stages =
      HW == WIDE ? wide_stages(pl.stages, pieces(P)) : pl.stages;
  if (HW == WIDE && threadIdx.x == 0) mbar_init(ready, TC_CONSUMERS);
  init_ring(full, empty, stages,
            HW == N256 || HW == WIDE ? EMPTY256_ARRIVALS : TC_CONSUMERS);
  float* tred = reinterpret_cast<float*>(smem + pl.tred);
  // registers after setmaxnreg: the width-256 instance runs no terminal
  // warps, so its producer warpgroup keeps 40 and its consumers take 232
  // (128 (168 - 40) = 256 (232 - 168))
  constexpr int PREGS = HW == N256 ? 40 : PRODUCER_REGS;
  constexpr int CREGS = HW == N256 ? 232 : CONSUMER_REGS;
  if (threadIdx.x >= TC_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS));
    const int pw = (threadIdx.x - TC_CONSUMERS) >> 5, lane = threadIdx.x & 31;
    if (HW == N256 && pw > 0) return;
    if (pw == 0) {
      if (L > 0 && HW == N256)
        produce256(p, smem_u32(smem + pl.ring), full, empty, lane, pl.stages,
                   pieces(P), packed(P));
      else if (L > 0 && HW == WIDE)
        produce_wide(p, smem_u32(smem + pl.ring), full, empty, ready, lane,
                     stages, pieces(P), packed(P));
      else if (L > 0 && HW == H64)
        produce64(p, smem_u32(smem + pl.ring), full, empty, lane, pl.stages,
                  lay.stage_bytes, pieces(P), packed(P));
      else if (L > 0)
        produce(p, smem_u32(smem + pl.ring), full, empty, lane, pl.stages,
                lay.stage_bytes, pieces(P), packed(P));
    } else {
      terminal_warps(p, reinterpret_cast<float*>(smem + pl.tacc), tred,
                     pw - 1, lane);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));

  const int wg = threadIdx.x / WG, wtid = threadIdx.x % WG;
  if constexpr (HW == N256) {
    consumers256<P>(p, smem, wg, wtid);
  } else if constexpr (HW != WIDE) {
    consumers_narrow<P, HW>(p, smem, wg, wtid);
  } else {
    consumers_wide<P>(p, smem, wg, wtid, stages, empty, ready);
  }
}

// the tensor-core kernel for a mode and a hidden width
using TcKernel = void (*)(const tc::Params);
template <int HW>
TcKernel tc_kernel_of(int mode) {
  return mode == tc::MODE_BF16X3 ? generate_tc_kernel<3, HW>
                                 : generate_tc_kernel<1, HW>;
}
TcKernel tc_kernel(int mode, int hw) {
  const int inst = instance_of(hw);
  return inst == WIDE   ? tc_kernel_of<WIDE>(mode)
         : inst == N256 ? tc_kernel_of<N256>(mode)
         : inst == H64  ? tc_kernel_of<H64>(mode)
                        : tc_kernel_of<H>(mode);
}

}  // namespace

extern "C" {

// limits the Python wrapper checks before a launch
int dpi_generate_hidden_width() { return H; }
int dpi_generate_max_nx() { return MAXJ * THREADS - 1; }
long long dpi_generate_smem_bytes(int nx, int L) {
  return (long long)(smem_floats(nx, L) * sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int dpi_generate(const float* t, const float* x, const float* g0,
                 const float* f0, const float* w, const float* u01,
                 const float* noise_t, const float* noise_i, float* out,
                 int B, int M, int nx, int L, int has_net, int anti,
                 unsigned long long seed, float T, float alpha_sqrt, float k,
                 float c0, void* stream) {
  const size_t smem = smem_floats(nx, has_net ? L : 0) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      generate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.t = t; p.x = x; p.g0 = g0; p.f0 = f0; p.w = w;
  p.u01 = u01; p.noise_t = noise_t; p.noise_i = noise_i; p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = L; p.has_net = has_net; p.anti = anti;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  generate_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// the tensor-core kernel's cover: nx, and its hidden widths in increasing
// order into out[16] (their count returned)
int dpi_generate_tc_max_nx() { return GEN_MAX_NX; }
int dpi_generate_tc_widths(int* out) {
  int n = 0;
  for (int hw = H64; hw <= GEN_MAX_WIDTH; hw += H64)
    if (covered_width(hw)) out[n++] = hw;
  return n;
}

// global scratch (bytes) the tensor-core kernel needs at any B and mode
// for a net of hidden width hw: the saved derivatives and tiles' normals
// its plan keeps out of shared memory, and past width 256 the images of
// layer inputs (0: none; -1: no plan)
long long dpi_generate_tc_scratch_bytes_w(int nx, int L, int hw) {
  if (!covered_width(hw) || nx < 1 || nx > GEN_MAX_NX) return -1;
  const tc::GPlan pl = plan_of(nx, L, hw);
  if (pl.stages < 0) return -1;
  const size_t f = scratch_of(pl, nx, L, hw);
  if (f == 0) return 0;
  long long most = 0;
  for (int mode = tc::MODE_BF16X3; mode <= tc::MODE_ONE_PASS; ++mode) {
    const int grid =
        tc::persistent_grid(tc_kernel(mode, hw), pl.total, 1 << 30);
    if (grid < 0) return -1;
    const long long b = (long long)grid * f * 4;
    most = b > most ? b : most;
  }
  return most;
}

// the plan at (nx, L, width hw) into out[11]: stages (-1: none) under
// bf16x3, saved derivatives in shared memory, tiles' normals in shared
// memory, shared memory bytes, global scratch floats per block, 1 where the
// instance keeps the layer chain on chip and draws the normals where it
// uses them (width 256), 1 where the producer stages the products' A
// beside the weights (the wide pass), a ring stage's bytes under bf16x3,
// then the ring's stages and a stage's bytes under "default" (the wide
// pass: wide_stages of half the bytes; the others: as under bf16x3), and 1
// where layer 1 draws the integral normals into its A fragments, W1's
// columns in quad order (the narrow instances, widths 64 and 128:
// pack_mlp_tc's quad_frags) (ops/kernels.py:library_tc_plan)
void dpi_generate_tc_plan_w(int nx, int L, int hw, long long* out) {
  const tc::GPlan pl = plan_of(nx, L, hw);
  const int inst = instance_of(hw);
  out[0] = pl.stages;
  out[1] = pl.save_smem;
  out[2] = pl.dw_smem;
  out[3] = (long long)pl.total;
  out[4] = (long long)scratch_of(pl, nx, L, hw);
  out[5] = inst == N256;
  out[6] = inst == WIDE;
  out[7] = inst == WIDE   ? WIDE_STAGE
           : inst == N256 ? STAGE256
                          : gen_layout(nx, hw).stage_bytes;
  const bool wide = inst == WIDE && pl.stages > 0;
  out[8] = wide ? wide_stages(pl.stages, 1) : out[0];
  out[9] = wide ? wide_stage_bytes(1) : out[7];
  out[10] = inst == H || inst == H64;
}

// The tensor-core kernel (mode 1: bf16x3, 2: one bf16 pass) for a net of
// hidden width hw (covered_width: 64, 128, or 256 to 1024 in steps of
// 128); `img`, `vec` from
// ops/kernels.py:pack_mlp_tc. Launches on `stream`; returns 0, a CUDA
// error or one of dpi::tc::ERR_*.
int dpi_generate_tc_w(const float* t, const float* x, const float* g0,
                      const float* f0, const void* img, const float* vec,
                      const float* u01, const float* noise_t,
                      const float* noise_i, float* scratch, float* out, int B,
                      int M, int nx, int L, int has_net, int anti, int mode,
                      int hw, unsigned long long seed, float T,
                      float alpha_sqrt, float k, float c0, void* stream) {
  using namespace dpi::tc;
  if (mode != MODE_BF16X3 && mode != MODE_ONE_PASS) return ERR_BAD_MODE;
  if ((has_net && L < 1) || nx < 1 || nx > GEN_MAX_NX ||
      (has_net && !covered_width(hw)))
    return ERR_NO_PLAN;
  const int Ln = has_net ? L : 0;
  if (!has_net) hw = H;
  const Layout lay = gen_layout(nx, hw);
  const GPlan pl = plan_of(nx, Ln, hw);
  if (pl.stages < 0) return ERR_NO_PLAN;
  if (scratch_of(pl, nx, Ln, hw) > 0 && !scratch) return ERR_NO_SCRATCH;
  auto* kernel = tc_kernel(mode, hw);
  const int grid = persistent_grid(kernel, pl.total, B);
  if (grid < 1) return ERR_GRID;
  dpi::tc::Params p;
  p.t = t; p.x = x; p.g0 = g0; p.f0 = f0;
  p.img = static_cast<const __nv_bfloat16*>(img); p.vec = vec;
  p.u01 = u01; p.noise_t = noise_t; p.noise_i = noise_i;
  p.scratch = scratch; p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = Ln; p.has_net = has_net;
  p.anti = anti; p.mode = mode; p.hw = hw;
  p.lay = lay; p.plan = pl;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  kernel<<<grid, TC_THREADS, pl.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
