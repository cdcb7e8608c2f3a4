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
//     the tensor cores (value_mlp_tc.cuh). Its bound is the tensor pipe
//     (3 x 111.5 k bf16 multiply-adds per sample under bf16x3), but what
//     holds it back is the work each block does in turn around the
//     products: the ELU epilogues and hi/lo splits of every layer, both
//     chains' Philox draws and the terminal chain's warp sums, all
//     latency-bound at 4-8 warps per SM. The design: one warpgroup walks
//     the point's M samples in tiles of 64 rows, each layer one wgmma
//     m64n128 product per k16 chunk with A split into bf16 hi and lo in
//     registers; a producer warp stages the weights in 32 KB slabs with
//     cp.async.bulk and mbarriers, so each weight byte serves 64 samples;
//     two blocks per SM (where their shared memory fits), so that one
//     block's epilogues and draws overlap the other's products; the
//     terminal chain runs per warp on its 16 rows with each lane's quads of
//     normals in registers, as in terminal.cu (no normal of that chain is
//     stored); the integral sums are reduced in row order by the thread
//     that owns each output, the terminal sums of the 4 warps in a fixed
//     order (deterministic); a persistent grid.
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

constexpr int QPL = 4;  // terminal quads per lane: nx <= 4 * 32 * QPL

// The terminal chain of tile kb on this warp's 16 rows, as in terminal.cu:
// one draw at a time (a row, or a pair of rows with antithetic pairing),
// lane l holding quads l, l + 32, ... of the draw's normals in registers
// (no normal of this chain is stored).
__device__ __forceinline__ void terminal_tile(const tc::Params& p,
                                              const float* xrow, int b,
                                              int kb, int warp, int lane,
                                              uint2 key, float cT, float g0,
                                              float (&acc)[QPL][4],
                                              float& acc_v) {
  const int nx = p.nx, Q = (nx + 3) / 4, Md = p.anti ? p.M / 2 : p.M;
  const int per = p.anti ? 2 : 1;  // rows per draw
  const int k0 = kb * tc::TILE + 16 * warp;
  const int ndraw = max(0, min(16, p.M - k0)) / per;
  for (int d = 0; d < ndraw; ++d) {
    const int kd = k0 / per + d;
    float n[QPL][4], part_p = 0.0f, part_m = 0.0f;
#pragma unroll
    for (int qq = 0; qq < QPL; ++qq) {
      const int q = lane + 32 * qq;
#pragma unroll
      for (int r = 0; r < 4; ++r) n[qq][r] = 0.0f;
      if (q < Q) {
        if (p.noise_t) {
          const float* row = p.noise_t + ((size_t)b * Md + kd) * nx;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * q + r < nx) n[qq][r] = row[4 * q + r];
        } else {
          normals4(kd, q, STREAM_TERMINAL, p.seed_hi, key, n[qq]);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * q + r >= nx) n[qq][r] = 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * q + r < nx) {
            part_p += xrow[4 * q + r] + cT * n[qq][r];
            part_m += xrow[4 * q + r] - cT * n[qq][r];
          }
        }
      }
    }
    const float d_p = g_cha(p.T, p.k, warp_sum(part_p)) - g0;
    float w = d_p;
    if (p.anti) {
      const float d_m = g_cha(p.T, p.k, warp_sum(part_m)) - g0;
      acc_v += d_p + d_m;
      w = d_p - d_m;
    } else {
      acc_v += d_p;
    }
#pragma unroll
    for (int qq = 0; qq < QPL; ++qq)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[qq][r] = fmaf(w, n[qq][r], acc[qq][r]);
  }
}

// X3: bf16x3, else one bf16 pass; MINB: blocks per SM (value_mlp_tc.cuh:
// launch_plan_for)
template <bool X3, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
generate_tc_kernel(const tc::Params p) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  const Plan pl = make_plan(nx, L, p.stages, p.save_smem);
  const Tile s = carve(smem, pl, p);
  const uint32_t full = smem_u32(smem + pl.bars);
  const uint32_t empty = full + 8 * MAX_STAGES;
  init_ring(full, empty, p.stages);
  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    if (L > 0) produce(p, smem_u32(smem + pl.ring), full, empty,
                       threadIdx.x & 31);
    return;
  }
  const int ctid = threadIdx.x, warp = ctid >> 5, lane = ctid & 31;
  Ring ring{smem_u32(smem + pl.ring), full, empty, p.stages, 0};
  const int ntile = (p.M + TILE - 1) / TILE;
  const int Q = (nx + 3) / 4;
  const float inv_m = 1.0f / (float)p.M;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], g0 = p.g0[b], f0 = p.f0[b];
    const float Tt = fmaxf(p.T - t, 1e-6f);
    const float sqrt_Tt = sqrtf(Tt);
    const float cT = sqrt_Tt * p.alpha_sqrt;
    const float inv_yT = 1.0f / (sqrt_Tt * p.alpha_sqrt);
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    for (int j = ctid; j < nx; j += CONSUMERS)
      s.xrow[j] = p.x[(size_t)b * nx + j];
    float acc[MAXJ] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc_t[QPL][4], acc_tv = 0.0f;
#pragma unroll
    for (int qq = 0; qq < QPL; ++qq)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc_t[qq][r] = 0.0f;
    for (int kb = 0; kb < ntile; ++kb) {
      draw_times(p, s, b, kb, t, Tt, key, ctid);
      draw_normals(p, s, b, kb, key, ctid);
      consumers_sync();

      terminal_tile(p, s.xrow, b, kb, warp, lane, key, cT, g0, acc_t,
                    acc_tv);
      if (L > 0) {
        net_pass<X3>(p, s, ring, ctid);
      } else if (ctid < TILE) {
        s.u[ctid] = 0.0f;
        s.sux[ctid] = 0.0f;
      }
      consumers_sync();
      sample_weights(p, s, kb, Tt, f0, ctid);
      consumers_sync();
      accumulate(s, nx, ctid, acc);
      consumers_sync();
    }

    // the 4 warps' terminal sums, added in a fixed order (through s.dw)
    float* red = s.dw;
    if (lane == 0) red[warp * (1 + nx)] = acc_tv;
#pragma unroll
    for (int qq = 0; qq < QPL; ++qq) {
      const int q = lane + 32 * qq;
      if (q < Q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (4 * q + r < nx)
            red[warp * (1 + nx) + 1 + 4 * q + r] = acc_t[qq][r];
    }
    consumers_sync();
    float* out = p.out + (size_t)b * (1 + nx);
#pragma unroll
    for (int r = 0; r < MAXJ; ++r) {
      const int j = ctid + r * CONSUMERS;
      if (j <= nx) {
        float sum_t = 0.0f;
#pragma unroll
        for (int w = 0; w < CONSUMERS / 32; ++w)
          sum_t += red[w * (1 + nx) + j];
        out[j] = j == 0 ? (sum_t + acc[r]) * inv_m + g0 + f0 * Tt
                        : (sum_t * inv_yT + acc[r]) * inv_m;
      }
    }
    consumers_sync();
  }
}

// the tensor-core kernel for a mode and blocks per SM
using TcKernel = void (*)(const tc::Params);
TcKernel tc_kernel(int mode, int two) {
  const bool x3 = mode == tc::MODE_BF16X3;
  if (two)
    return x3 ? generate_tc_kernel<true, 2> : generate_tc_kernel<false, 2>;
  return x3 ? generate_tc_kernel<true, 1> : generate_tc_kernel<false, 1>;
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

// global scratch (bytes) dpi_generate_tc needs for the net's saved
// derivatives (0: they fit in shared memory; -1: no plan)
long long dpi_generate_tc_scratch_bytes(int nx, int L) {
  return dpi::tc::scratch_bytes(tc_kernel, nx, L);
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
  Plan pl;
  int two;
  const int bad = launch_plan(nx, L, has_net, mode, scratch, &pl, &two);
  if (bad) return bad;
  auto* kernel = tc_kernel(mode, two);
  const int grid = persistent_grid(kernel, pl.total, B);
  if (grid < 1) return ERR_GRID;
  dpi::tc::Params p;
  p.t = t; p.x = x; p.g0 = g0; p.f0 = f0;
  p.img = static_cast<const __nv_bfloat16*>(img); p.vec = vec;
  p.u01 = u01; p.noise_t = noise_t; p.noise_i = noise_i;
  p.scratch = scratch; p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = has_net ? L : 0; p.has_net = has_net;
  p.anti = anti; p.mode = mode;
  p.stages = pl.stages; p.save_smem = pl.save_smem;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  kernel<<<grid, dpi::tc::THREADS, pl.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
