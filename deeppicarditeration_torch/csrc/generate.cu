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
// MLP of ELU hidden layers of width 128 with no output clamp.
//
// Antithetic pairing (anti = 1): samples 2p and 2p + 1 share draw p, the
// second with both increments negated and the same time u; external noise
// then has M / 2 rows. The sum over samples is that of the TPU kernel, which
// mirrors per inner block instead.
//
// Two kernels, by the precision of the net's dots (the TPU kernel's
// mxu_precision, DATA.TPU.PALLAS_PRECISION):
//   * "bf16x3" (the default) and "default": generate_tc_kernel, the net on
//     the tensor cores (value_mlp_tc.cuh's pass). Its bound is the tensor
//     pipe (3 x 111.5 k bf16 multiply-adds per sample under bf16x3). What
//     held the first tensor-core design (one warpgroup of consumers, two
//     blocks an SM) at 5.7x that bound, and what this one does about it:
//       - the terminal chain ran on the consumers between the products, a
//         draw at a time across a warp (a shuffle sum and a sigmoid a draw,
//         25 of 32 lanes busy at nx = 100): it runs on three warps of the
//         producer warpgroup beside the products, lane = draw as in
//         terminal.cu (draws.cuh's counter and Box-Muller, the draw's sum
//         in registers, one sigmoid a draw), in two passes over a draw's
//         quads (its sum, then its weighted normals, summed over the warp's
//         32 draws by a transposing shuffle), so that it needs no shared
//         tile of normals at any nx; its sums join the integral chain's at
//         a point's end, in a fixed order;
//       - each weight byte staged from L2 served one 64-row tile: two
//         consumer warpgroups take tiles 2i and 2i + 1 of a point and read
//         every ring stage, so a byte serves 128 samples;
//       - 2 ring stages (two blocks an SM): one block an SM with a ring of
//         up to 4 stages;
//       - the two warpgroups' products issued in turns (PingPong), so that
//         one's epilogue can run while the other's products do.
//     What binds after it is each warpgroup's own chain of products,
//     waits and epilogues: with the epilogues, draws and terminal chain
//     taken out, the products alone run at ~40 % of the tensor peak
//     (PERF.md); halving the L2 traffic did not move the time.
//     The integral normals stay the library's Box-Muller (philox.cuh,
//     value_mlp_tc.cuh's draw_normals): draws.cuh's guard-free one,
//     inlined in the consumers, made ptxas spill ~1.3 KB a thread across
//     their whole pass, and the kernel took a quarter longer.
//     Each layer is one wgmma m64n128 product per k16 chunk with A split
//     into bf16 hi and lo in registers, the producer warp staging the
//     weights in 32 KB slabs with cp.async.bulk and mbarriers; the saved
//     ELU derivatives and the tiles' normals stay in shared memory where
//     the plan fits them, else in a global scratch of the block's own
//     (at nx = 100 and 4x128: the normals in shared memory, the
//     derivatives in scratch, 4 stages); the integral sums are reduced in
//     row order by the thread that owns each output; a persistent grid.
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

constexpr int WG = tc::CONSUMERS;              // a warpgroup: 128 threads
constexpr int NWG = 2;                         // consumer warpgroups
constexpr int TC_CONSUMERS = NWG * WG;
constexpr int TC_THREADS = TC_CONSUMERS + WG;  // and the producer warpgroup
constexpr int TERM_WARPS = 3;                  // the producer warpgroup's others
constexpr int TERM_THREADS = 32 * TERM_WARPS;
// registers per thread after setmaxnreg (from the 168 a thread launches
// with): what the producer warpgroup frees covers what the consumers take,
// 128 (168 - 88) = 256 (208 - 168)
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
// named barriers besides __syncthreads' 0: the 256 consumers, each
// consumer warpgroup's 128, and the terminal sums of a point handed to the
// consumers (FULL: written; FREE: read)
constexpr int BAR_CONSUMERS = 1, BAR_WG = 2, BAR_TERM_FULL = 4,
              BAR_TERM_FREE = 5, BAR_TURN = 6;
constexpr int TERM_BAR_THREADS = TC_CONSUMERS + TERM_THREADS;
constexpr int TC_MAX_NX = MAXJ * WG - 1;  // a warpgroup's 4 outputs a thread

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The two consumer warpgroups issue their groups of products in turns
// (warpgroup 0 first; named barriers BAR_TURN + wg): while one runs its
// products on the tensor pipe, the other runs its epilogue.
struct PingPong {
  int wg;
  __device__ __forceinline__ void wait() const {
    named_sync(BAR_TURN + wg, TC_CONSUMERS);
  }
  __device__ __forceinline__ void pass() const {
    named_arrive(BAR_TURN + (wg ^ 1), TC_CONSUMERS);
  }
};

__host__ __device__ inline size_t dw_bytes(int nx) {
  return tc::align16((size_t)tc::TILE * nx * 4);
}

// Byte offsets of the tensor-core kernel's dynamic shared memory; where the
// saved ELU derivatives (save_smem) and the tiles' integral normals
// (dw_smem) do not fit, they live in the block's global scratch.
struct GPlan {
  int stages, save_smem, dw_smem;
  size_t ring, save, dw, xrow, rows, tacc, tred, red, bars, total;
};

__host__ __device__ inline GPlan gplan(int nx, int L, int stages,
                                      int save_smem, int dw_smem) {
  GPlan p;
  p.stages = stages;
  p.save_smem = save_smem;
  p.dw_smem = dw_smem;
  size_t o = 0;
  p.ring = o;
  o += (size_t)stages * tc::STAGE_BYTES;
  p.save = o;
  if (save_smem && L > 1)
    o += (size_t)NWG * (L - 1) * tc::SAVE_LAYER_FLOATS * 4;
  p.dw = o;
  if (dw_smem) o += NWG * dw_bytes(nx);
  p.xrow = o;
  o += tc::align16((size_t)nx * 4);
  p.rows = o;
  o += (size_t)NWG * tc::NROWS * tc::TILE * 4;
  p.tacc = o;
  o += (size_t)TERM_WARPS * tc::align16((size_t)nx * 4);
  p.tred = o;
  o += tc::align16((size_t)TERM_WARPS * (1 + nx) * 4);
  p.red = o;
  o += tc::align16((size_t)(1 + nx) * 4);
  p.bars = o;
  o += (size_t)2 * tc::MAX_STAGES * 8;
  p.total = o;
  return p;
}

// The plan at (nx, L): the tiles' normals in shared memory where a ring of
// 2 stages fits beside them, the deepest ring of 2..MAX_STAGES stages, and
// the saved derivatives in shared memory where they fit beside that ring;
// stages = -1 where nothing fits (no ring without a net).
// ops/kernels.py:generate_tc_plan mirrors it.
__host__ __device__ inline GPlan choose_gplan(int nx, int L) {
  for (int dw = 1; dw >= 0; --dw) {
    if (L == 0) {
      const GPlan p = gplan(nx, 0, 0, 0, dw);
      if (p.total <= tc::SMEM_LIMIT) return p;
      continue;
    }
    for (int st = tc::MAX_STAGES; st >= 2; --st) {
      const GPlan p0 = gplan(nx, L, st, 0, dw);
      if (p0.total > tc::SMEM_LIMIT) continue;
      const GPlan p1 = gplan(nx, L, st, 1, dw);
      return L > 1 && p1.total <= tc::SMEM_LIMIT ? p1 : p0;
    }
  }
  GPlan bad = gplan(nx, L, 0, 0, 0);
  bad.stages = -1;
  return bad;
}

// floats of global scratch a block keeps: the consumers' saved derivatives
// (each warpgroup's L - 1 layers), then their tiles' normals, where they
// are not in shared memory
__host__ __device__ inline size_t scratch_floats(const GPlan& pl, int nx,
                                                 int L) {
  size_t f = 0;
  if (!pl.save_smem && L > 1)
    f += (size_t)NWG * (L - 1) * tc::SAVE_LAYER_FLOATS;
  if (!pl.dw_smem) f += (size_t)NWG * tc::TILE * nx;
  return f;
}

__device__ __forceinline__ float quad_sum(float4 v) {
  return (v.x + v.y) + (v.z + v.w);
}

// quad q of a terminal draw, zero past nx: its row of external noise (null
// for a draw past the last), or its own normals
__device__ __forceinline__ float4 term_quad(const float* row, bool ext,
                                            const DrawCounter& dc, int q,
                                            int nx) {
  float e[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (ext) {
    if (row)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * q + r < nx) e[r] = row[4 * q + r];
  } else {
    const float4 v = quad_normals(dc, (uint32_t)q);
    e[0] = v.x;
    e[1] = 4 * q + 1 < nx ? v.y : 0.0f;
    e[2] = 4 * q + 2 < nx ? v.z : 0.0f;
    e[3] = 4 * q + 3 < nx ? v.w : 0.0f;
  }
  return make_float4(e[0], e[1], e[2], e[3]);
}

// v (32 values a lane) summed over the warp's lanes, transposed: lane l is
// left with the sum of every lane's v[l]. Fixed order: deterministic.
__device__ __forceinline__ float transpose_sum32(const float (&v)[32],
                                                 int lane) {
  float s16[16], s8[8], s4[4], s2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2,
             b0 = lane & 1;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    s16[i] = (b4 ? v[16 + i] : v[i]) +
             __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[16 + i], 16);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    s8[i] = (b3 ? s16[8 + i] : s16[i]) +
            __shfl_xor_sync(0xffffffffu, b3 ? s16[i] : s16[8 + i], 8);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    s4[i] = (b2 ? s8[4 + i] : s8[i]) +
            __shfl_xor_sync(0xffffffffu, b2 ? s8[i] : s8[4 + i], 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    s2[i] = (b1 ? s4[2 + i] : s4[i]) +
            __shfl_xor_sync(0xffffffffu, b1 ? s4[i] : s4[2 + i], 2);
  return (b0 ? s2[1] : s2[0]) +
         __shfl_xor_sync(0xffffffffu, b0 ? s2[0] : s2[1], 1);
}

// The terminal chain of this block's points on warp tw of the three
// terminal warps, beside the consumers' products: lane = draw, 32 draws a
// round, the warps' rounds interleaved over the point's draws. A lane
// sums its draw's normals (pass 1: g needs only sum X_T = sum x + cT sum
// dW), takes its draw's one sigmoid (two with antithetic pairing), then
// draws the normals again and times them by the draw's weight (pass 2),
// 8 quads at a time, summed over the warp's 32 draws by a transposing
// shuffle sum: lane l keeps dimension 32 G + l of group G in `sums` (its
// own elements, in shared memory). At a point's end the warp's sums go to
// tred once the consumers have read the last ones.
__device__ __forceinline__ void terminal_warps(const tc::Params& p,
                                               float* tacc, float* tred,
                                               int tw, int lane) {
  const int nx = p.nx, Q = (nx + 3) / 4, Qfull = nx / 4;
  const int Md = p.anti ? p.M / 2 : p.M;
  const bool ext = p.noise_t != nullptr;
  float* sums = tacc + (size_t)tw * (tc::align16((size_t)nx * 4) / 4);
  bool first = true;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], g0 = p.g0[b];
    const float cT = sqrtf(fmaxf(p.T - t, 1e-6f)) * p.alpha_sqrt;
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    float sx = 0.0f;
    for (int j = lane; j < nx; j += 32) {
      sx += p.x[(size_t)b * nx + j];
      sums[j] = 0.0f;
    }
    sx = warp_sum(sx);
    float acc_v = 0.0f;
    for (int kd0 = 32 * tw; kd0 < Md; kd0 += TERM_THREADS) {
      const int kd = kd0 + lane;
      const bool live = kd < Md;
      const float* row =
          ext && live ? p.noise_t + ((size_t)b * Md + kd) * nx : nullptr;
      // a lane past Md draws finite normals that its zero weight cancels
      const DrawCounter dc((uint32_t)kd, p.seed_hi, key);
      float sn = 0.0f;
#pragma unroll 2
      for (int q = 0; q < Qfull; ++q)
        sn += quad_sum(term_quad(row, ext, dc, q, nx));
      if (Qfull < Q) sn += quad_sum(term_quad(row, ext, dc, Qfull, nx));
      const float d_p = g_cha(p.T, p.k, fmaf(cT, sn, sx)) - g0;
      float w = d_p, dv = d_p;
      if (p.anti) {
        const float d_m = g_cha(p.T, p.k, fmaf(-cT, sn, sx)) - g0;
        dv = d_p + d_m;
        w = d_p - d_m;
      }
      acc_v += live ? dv : 0.0f;
      w = live ? w : 0.0f;
      for (int g = 0; g < (Q + 7) / 8; ++g) {
        float v[32];
#pragma unroll
        for (int qq = 0; qq < 8; ++qq) {
          const int q = 8 * g + qq;
          const float4 n = q < Q ? term_quad(row, ext, dc, q, nx)
                                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          v[4 * qq] = w * n.x;
          v[4 * qq + 1] = w * n.y;
          v[4 * qq + 2] = w * n.z;
          v[4 * qq + 3] = w * n.w;
        }
        const float sv = transpose_sum32(v, lane);
        const int j = 32 * g + lane;
        if (j < nx) sums[j] += sv;
      }
    }
    acc_v = warp_sum(acc_v);
    if (!first) named_sync(BAR_TERM_FREE, TERM_BAR_THREADS);
    first = false;
    float* out = tred + tw * (1 + nx);
    if (lane == 0) out[0] = acc_v;
    for (int j = lane; j < nx; j += 32) out[1 + j] = sums[j];
    named_arrive(BAR_TERM_FULL, TERM_BAR_THREADS);
  }
}

// X3: bf16x3, else one bf16 pass. A block: two consumer warpgroups, each
// on its own 64-row tile (tiles 2 i and 2 i + 1 of a point; the second
// warpgroup takes an empty tile past the last when a point's tiles are
// odd, to keep the ring's pace), both reading every weight stage; the
// producer warpgroup: one warp streaming the stages, three running the
// terminal chain.
template <bool X3>
__global__ void __launch_bounds__(TC_THREADS, 1)
generate_tc_kernel(const tc::Params p) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  const GPlan pl = choose_gplan(nx, L);
  const uint32_t full = smem_u32(smem + pl.bars);
  const uint32_t empty = full + 8 * MAX_STAGES;
  init_ring(full, empty, pl.stages, TC_CONSUMERS);
  float* tred = reinterpret_cast<float*>(smem + pl.tred);
  if (threadIdx.x >= TC_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pw = (threadIdx.x - TC_CONSUMERS) >> 5, lane = threadIdx.x & 31;
    if (pw == 0) {
      if (L > 0) produce(p, smem_u32(smem + pl.ring), full, empty, lane, NWG);
    } else {
      terminal_warps(p, reinterpret_cast<float*>(smem + pl.tacc), tred,
                     pw - 1, lane);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x / WG, wtid = threadIdx.x % WG;
  // this warpgroup's tile: its rows, normals and saved derivatives
  Tile s;
  float* rows = reinterpret_cast<float*>(smem + pl.rows) + wg * NROWS * TILE;
  s.s_val = rows;
  s.sig = rows + TILE;
  s.iys = rows + 2 * TILE;
  s.c_i = rows + 3 * TILE;
  s.c_iy = rows + 4 * TILE;
  s.u = rows + 5 * TILE;
  s.sux = rows + 6 * TILE;
  s.xrow = reinterpret_cast<float*>(smem + pl.xrow);
  const size_t n_save = (size_t)(L > 1 ? L - 1 : 0) * SAVE_LAYER_FLOATS;
  float* scr = pl.save_smem && pl.dw_smem
                   ? nullptr
                   : p.scratch + blockIdx.x * scratch_floats(pl, nx, L);
  s.save = reinterpret_cast<float2*>(
      pl.save_smem ? reinterpret_cast<float*>(smem + pl.save) + wg * n_save
                   : scr + wg * n_save);
  s.dw = pl.dw_smem
             ? reinterpret_cast<float*>(smem + pl.dw + wg * dw_bytes(nx))
             : scr + (pl.save_smem ? 0 : NWG * n_save) +
                   (size_t)wg * TILE * nx;
  float* red = reinterpret_cast<float*>(smem + pl.red);
  Ring ring{smem_u32(smem + pl.ring), full, empty, pl.stages, 0};
  const PingPong turn{wg};
  if (wg == 1 && L > 0) turn.pass();  // warpgroup 0 takes the first turn
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
    float acc[MAXJ] = {0.0f, 0.0f, 0.0f, 0.0f};
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);

    for (int kb = wg; kb < ntile2; kb += NWG) {
      draw_times(p, s, b, kb, t, Tt, key, wtid);
      draw_normals(p, s, b, kb, key, wtid);
      named_sync(BAR_WG + wg, WG);
      if (L > 0) {
        net_pass<X3>(p, s, ring, wtid, turn);
      } else if (wtid < TILE) {
        s.u[wtid] = 0.0f;
        s.sux[wtid] = 0.0f;
      }
      named_sync(BAR_WG + wg, WG);
      sample_weights(p, s, kb, Tt, f0, wtid);
      named_sync(BAR_WG + wg, WG);
      accumulate(s, nx, wtid, acc);
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
          for (int w = 0; w < TERM_WARPS; ++w) sum_t += tred[w * (1 + nx) + j];
          const float a = acc[r] + red[j];
          out[j] = j == 0 ? (sum_t + a) * inv_m + g0 + f0 * Tt
                          : (sum_t * inv_yT + a) * inv_m;
        }
      }
    }
    if (b + (int)gridDim.x < p.B) named_arrive(BAR_TERM_FREE, TERM_BAR_THREADS);
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
  }
  if (wg == 0 && L > 0) turn.wait();  // the second warpgroup's last pass
}

// the tensor-core kernel for a mode
using TcKernel = void (*)(const tc::Params);
TcKernel tc_kernel(int mode) {
  return mode == tc::MODE_BF16X3 ? generate_tc_kernel<true>
                                 : generate_tc_kernel<false>;
}

// blocks of the persistent grid (the card's SMs, one block each where the
// plan's shared memory allows), at most B; -1 if none
int tc_grid(TcKernel kernel, size_t smem, int B) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    TC_THREADS, smem) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  return B < sms * per_sm ? B : sms * per_sm;
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

// global scratch (bytes) dpi_generate_tc needs at any B and mode: the
// saved derivatives and tiles' normals its plan keeps out of shared memory
// (0: none; -1: no plan)
long long dpi_generate_tc_scratch_bytes(int nx, int L) {
  const GPlan pl = choose_gplan(nx, L);
  if (pl.stages < 0 || nx < 1 || nx > TC_MAX_NX) return -1;
  const size_t f = scratch_floats(pl, nx, L);
  if (f == 0) return 0;
  long long most = 0;
  for (int mode = tc::MODE_BF16X3; mode <= tc::MODE_ONE_PASS; ++mode) {
    const int grid = tc_grid(tc_kernel(mode), pl.total, 1 << 30);
    if (grid < 0) return -1;
    const long long b = (long long)grid * f * 4;
    most = b > most ? b : most;
  }
  return most;
}

// the plan at (nx, L) into out[5]: stages (-1: none), saved derivatives in
// shared memory, tiles' normals in shared memory, shared memory bytes,
// global scratch floats per block (ops/kernels.py:generate_tc_plan)
void dpi_generate_tc_plan(int nx, int L, long long* out) {
  const GPlan pl = choose_gplan(nx, L);
  out[0] = pl.stages;
  out[1] = pl.save_smem;
  out[2] = pl.dw_smem;
  out[3] = (long long)pl.total;
  out[4] = (long long)scratch_floats(pl, nx, L);
}

// The tensor-core kernel (mode 1: bf16x3, 2: one bf16 pass); `img`, `vec`
// from ops/kernels.py:pack_mlp_tc. Launches on `stream`; returns 0, a CUDA
// error or one of dpi::tc::ERR_*.
int dpi_generate_tc(const float* t, const float* x, const float* g0,
                    const float* f0, const void* img, const float* vec,
                    const float* u01, const float* noise_t,
                    const float* noise_i, float* scratch, float* out, int B,
                    int M, int nx, int L, int has_net, int anti, int mode,
                    unsigned long long seed, float T, float alpha_sqrt,
                    float k, float c0, void* stream) {
  using namespace dpi::tc;
  if (mode != MODE_BF16X3 && mode != MODE_ONE_PASS) return ERR_BAD_MODE;
  if ((has_net && L < 1) || nx < 1 || nx > TC_MAX_NX) return ERR_NO_PLAN;
  const int Ln = has_net ? L : 0;
  const GPlan pl = choose_gplan(nx, Ln);
  if (pl.stages < 0) return ERR_NO_PLAN;
  if (scratch_floats(pl, nx, Ln) > 0 && !scratch) return ERR_NO_SCRATCH;
  auto* kernel = tc_kernel(mode);
  const int grid = tc_grid(kernel, pl.total, B);
  if (grid < 1) return ERR_GRID;
  dpi::tc::Params p;
  p.t = t; p.x = x; p.g0 = g0; p.f0 = f0;
  p.img = static_cast<const __nv_bfloat16*>(img); p.vec = vec;
  p.u01 = u01; p.noise_t = noise_t; p.noise_i = noise_i;
  p.scratch = scratch; p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = Ln; p.has_net = has_net;
  p.anti = anti; p.mode = mode;
  p.stages = pl.stages; p.save_smem = pl.save_smem;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  kernel<<<grid, TC_THREADS, pl.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
