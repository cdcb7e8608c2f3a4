// Integral control-variate estimator of the DPI targets, alone, with the
// frozen value network's forward and backward pass in the kernel.
//
// Replaces the TPU kernel deeppicarditeration_tpu/ops/pallas_kernels.py:
// _integral_kernel (launched by integral_with_gradients_pallas). For each
// collocation point (t, x), with Tt = T - t (not floored, as the TPU
// kernel and the chunk estimator):
//   s = t + u Tt, X_s = x + sqrt(s - t) sqrt(a) dW,
//   (u, u_x) of the frozen net at (s, X_s), f = ff(s, X_s, u, u_x),
//   acc += Tt (f - f0) * (1, dW / (sqrt(max(s - t, 1e-6)) sqrt(a))),
//   out = acc / M + (f0 Tt, 0),  shape (B, 1 + nx) f32.
// It is the integral chain of generate.cu without the terminal chain:
// specialised to the Burgers equation "Cha" and a Value MLP of ELU hidden
// layers of width 128, or the zero iterate (has_net = 0).
//
// Antithetic pairing (anti = 1): samples 2p and 2p + 1 share draw p and its
// time u, the second with the increment negated; external noise then has
// M / 2 rows.
//
// Two kernels, by the precision of the net's dots (the TPU kernel's
// mxu_precision, DATA.TPU.PALLAS_PRECISION):
//   * "bf16x3" (the default) and "default": integral_tc_kernel, the net on
//     the tensor cores (value_mlp_tc.cuh). Its bound is the tensor pipe
//     (3 x 111.5 k bf16 multiply-adds per sample under bf16x3), but what
//     holds it back is the work each block does in turn around the
//     products: the ELU epilogues and hi/lo splits of every layer and the
//     Philox draws, latency-bound at 4-8 warps per SM. The design: one
//     warpgroup walks the point's M samples in tiles of 64 rows, each layer
//     one wgmma m64n128 product per k16 chunk with A split into bf16 hi
//     and lo in registers; a producer warp stages the weights in 32 KB
//     slabs with cp.async.bulk and mbarriers, so each weight byte serves 64
//     samples; two blocks per SM (where their shared memory fits), so that
//     one block's epilogues and draws overlap the other's products; the
//     1 + nx sums are reduced in row order by the thread that owns each
//     output (deterministic); a persistent grid.
//   * "highest": integral_kernel, the FP32-FMA design
//     (value_mlp.cuh), one block per point, inner blocks of S = 32
//     samples, 8 per warp through the whole net, weights through L1/L2;
//     bound by the FP32 pipe (~112 k multiply-adds per sample).
// Both draw Philox counted by (sample, quad, stream 1) and (sample,
// stream 2) for the time, so their draws agree value for value.

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
  const float* t;      // (B, 1)
  const float* x;      // (B, nx)
  const float* f0;     // (B, 1)  get_f(t, x)
  const float* w;      // packed net (see pack order in ops/kernels.py)
  const float* u01;    // (B, Md) or null: in-kernel draws
  const float* noise;  // (B, Md, nx) or null
  float* out;          // (B, 1 + nx)
  int B, M, nx, L, has_net, anti;  // Md = anti ? M / 2 : M
  uint32_t seed_lo, seed_hi;
  float T, alpha_sqrt, k, c0;
};

__host__ __device__ constexpr size_t smem_floats(int nx, int L) {
  return (size_t)L * S * H + 2 * (size_t)S * nx + nx + H + 4 * S;
}

__global__ void __launch_bounds__(THREADS)
integral_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  const int Md = p.anti ? p.M / 2 : p.M;
  float* hbuf = smem;                       // L x S x H activations/grads
  float* xs = hbuf + (size_t)L * S * H;     // S x nx  X_s
  float* dwi = xs + S * nx;                 // S x nx  normals
  float* xrow = dwi + S * nx;               // nx      the point's x
  float* wcol = xrow + nx;                  // H       sum_j W1[n, 1 + j]
  float* s_val = wcol + H;                  // S       s
  float* sig = s_val + S;                   // S       sqrt(s - t) sqrt(a)
  float* c_i = sig + S;                     // S       Tt (f - f0)
  float* c_iy = c_i + S;                    // S       1/ys, then c_i / ys

  const int b = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float t = p.t[b], f0 = p.f0[b];
  const float Tt = p.T - t;
  const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
  const ValueMlp net = value_mlp(p.w, nx, L);

  for (int j = tid; j < nx; j += THREADS) xrow[j] = p.x[(size_t)b * nx + j];
  if (p.has_net) column_sums(net, nx, wcol, tid, THREADS);
  float acc_v[MAXJ];
#pragma unroll
  for (int r = 0; r < MAXJ; ++r) acc_v[r] = 0.0f;
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

    // ---- normals and X_s -------------------------------------------------
    if (p.noise) {
      for (int e = lane; e < SPW * nx; e += 32) {
        const int i = e / nx, j = e - i * nx, sl = s0 + i;
        const int k = kb * S + sl;
        float c = 0.0f;
        if (k < p.M) {
          const int kd = p.anti ? k >> 1 : k;
          const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
          c = sg * p.noise[((size_t)b * Md + kd) * nx + j];
        }
        dwi[sl * nx + j] = c;
        xs[sl * nx + j] = xrow[j] + sig[sl] * c;
      }
    } else {
      for (int e = lane; e < SPW * Q; e += 32) {
        const int i = e / Q, q = e - i * Q, sl = s0 + i;
        const int k = kb * S + sl;
        float ni[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (k < p.M) {
          const int kd = p.anti ? k >> 1 : k;
          const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
          normals4(kd, q, STREAM_INTEGRAL, p.seed_hi, key, ni);
#pragma unroll
          for (int r = 0; r < 4; ++r) ni[r] *= sg;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * q + r;
          if (j < nx) {
            dwi[sl * nx + j] = ni[r];
            xs[sl * nx + j] = xrow[j] + sig[sl] * ni[r];
          }
        }
      }
    }
    __syncwarp();

    // ---- (u, sum_j u_x_j) of the frozen net at (s, X_s) -----------------
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
        for (int sl = 0; sl < S; ++sl) acc_v[r] += c_i[sl];
      } else if (j <= nx) {
        const float* di = dwi + (j - 1);
        for (int sl = 0; sl < S; ++sl)
          acc_v[r] = fmaf(c_iy[sl], di[sl * nx], acc_v[r]);
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
      out[0] = acc_v[r] * inv_m + f0 * Tt;
    } else if (j <= nx) {
      out[j] = acc_v[r] * inv_m;
    }
  }
}

// X3: bf16x3, else one bf16 pass; MINB: blocks per SM (value_mlp_tc.cuh:
// launch_plan_for)
template <bool X3, int MINB>
__global__ void __launch_bounds__(tc::THREADS, MINB)
integral_tc_kernel(const tc::Params p) {
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
  const int ctid = threadIdx.x;
  Ring ring{smem_u32(smem + pl.ring), full, empty, p.stages, 0};
  const int ntile = (p.M + TILE - 1) / TILE;
  const float inv_m = 1.0f / (float)p.M;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t = p.t[b], f0 = p.f0[b];
    const float Tt = p.T - t;
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    for (int j = ctid; j < nx; j += CONSUMERS)
      s.xrow[j] = p.x[(size_t)b * nx + j];
    float acc[MAXJ] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kb = 0; kb < ntile; ++kb) {
      draw_times(p, s, b, kb, t, Tt, key, ctid);
      draw_normals(p, s, b, kb, key, ctid);
      consumers_sync();
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
    float* out = p.out + (size_t)b * (1 + nx);
#pragma unroll
    for (int r = 0; r < MAXJ; ++r) {
      const int j = ctid + r * CONSUMERS;
      if (j == 0) {
        out[0] = acc[r] * inv_m + f0 * Tt;
      } else if (j <= nx) {
        out[j] = acc[r] * inv_m;
      }
    }
  }
}

// the tensor-core kernel for a mode and blocks per SM
using TcKernel = void (*)(const tc::Params);
TcKernel tc_kernel(int mode, int two) {
  const bool x3 = mode == tc::MODE_BF16X3;
  if (two)
    return x3 ? integral_tc_kernel<true, 2> : integral_tc_kernel<false, 2>;
  return x3 ? integral_tc_kernel<true, 1> : integral_tc_kernel<false, 1>;
}

}  // namespace

extern "C" {

// limits the Python wrapper checks before a launch
int dpi_integral_hidden_width() { return H; }
int dpi_integral_max_nx() { return MAXJ * THREADS - 1; }
long long dpi_integral_smem_bytes(int nx, int L) {
  return (long long)(smem_floats(nx, L) * sizeof(float));
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int dpi_integral(const float* t, const float* x, const float* f0,
                 const float* w, const float* u01, const float* noise,
                 float* out, int B, int M, int nx, int L, int has_net,
                 int anti, unsigned long long seed, float T,
                 float alpha_sqrt, float k, float c0, void* stream) {
  const size_t smem = smem_floats(nx, has_net ? L : 0) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      integral_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.t = t; p.x = x; p.f0 = f0; p.w = w; p.u01 = u01; p.noise = noise;
  p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = L; p.has_net = has_net; p.anti = anti;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  integral_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// global scratch (bytes) dpi_integral_tc needs for the net's saved
// derivatives (0: they fit in shared memory; -1: no plan)
long long dpi_integral_tc_scratch_bytes(int nx, int L) {
  return dpi::tc::scratch_bytes(tc_kernel, nx, L);
}

// The tensor-core kernel (mode 1: bf16x3, 2: one bf16 pass); `img`, `vec`
// from ops/kernels.py:pack_mlp_tc. Launches on `stream`; returns 0, a CUDA
// error or one of dpi::tc::ERR_*.
int dpi_integral_tc(const float* t, const float* x, const float* f0,
                    const void* img, const float* vec, const float* u01,
                    const float* noise, float* scratch, float* out, int B,
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
  p.t = t; p.x = x; p.g0 = nullptr; p.f0 = f0;
  p.img = static_cast<const __nv_bfloat16*>(img); p.vec = vec;
  p.u01 = u01; p.noise_t = nullptr; p.noise_i = noise;
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
