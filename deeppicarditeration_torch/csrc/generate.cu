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
// What bounds it on an H100: FP32 arithmetic. Per sample the net costs
// ~62.7 k multiply-adds forward and ~49.4 k backward (4x128, nx = 100); the
// inputs and outputs are a few MB, so bytes never matter. The design keeps
// everything but the weights on chip:
//   * one block per collocation point, so the point's 1 + nx sums stay in
//     the registers of one block and are reduced in a fixed order (no
//     atomics: the result is deterministic);
//   * the block walks its M samples in inner blocks of S = 32; each of its
//     4 warps owns 8 samples and runs them through the whole net alone
//     (only __syncwarp inside the net), 8 samples x 4 neurons per lane;
//   * activations of every hidden layer stay in shared memory for the
//     backward pass (L x 32 x 128 f32 = 64 KB at L = 4); the backward pass
//     overwrites them in place with the gradients;
//   * the weights (251 KB, more than a block's shared memory) are read
//     straight from global memory through L1/L2, in layouts that make each
//     warp's loads coalesced: W^T for the forward pass, W for the backward;
//   * normals come from a Philox4x32-10 generator keyed by (seed, point)
//     and counted by (sample, quad of dimensions, chain), so the draws do
//     not depend on the launch shape; Box-Muller uses both outputs.
// Cha's ff reads u_x only through sum_j u_x_j, so the backward pass stops
// at the first layer's pre-activation gradient g1 and contracts it with the
// column sums of W1's x-part: sum_j u_x_j = sum_n g1_n sum_j W1[n, 1 + j].
// Dots are plain FP32 FMA (f32-equivalent, as the reference requires).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int H = 128;              // hidden width
constexpr int NC = H / 32;          // neurons per lane
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int SPW = 8;              // samples per warp
constexpr int S = WARPS * SPW;      // samples per inner block
constexpr int MAXJ = 4;             // accumulator slots per thread
constexpr float ST_FLOOR = 1e-6f;   // estimators._ST_FLOOR
constexpr float TWO_PI = 6.283185307179586f;

struct Params {
  const float* t;        // (B, 1)
  const float* x;        // (B, nx)
  const float* g0;       // (B, 1)  g(x)
  const float* f0;       // (B, 1)  get_f(t, x)
  const float* w;        // packed net (see pack order in ops/kernels.py)
  const float* u01;      // (B, M) or null: in-kernel draws
  const float* noise_t;  // (B, M, nx) or null
  const float* noise_i;  // (B, M, nx) or null
  float* out;            // (B, 1 + nx)
  int B, M, nx, L, has_net;
  uint32_t seed_lo, seed_hi;
  float T, alpha_sqrt, k, c0;
};

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the reference's exp-based ELU, and its derivative read back from the
// activation h: elu'(z) = 1 for z > 0 (then h = z > 0), else exp(z) = h + 1
__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(z) - 1.0f;
}
__device__ __forceinline__ float elu_grad_from_h(float h) {
  return h > 0.0f ? 1.0f : h + 1.0f;
}

__host__ __device__ constexpr size_t smem_floats(int nx, int L) {
  return (size_t)L * S * H + 3 * (size_t)S * nx + nx + H + 5 * S;
}

__global__ void __launch_bounds__(THREADS)
generate_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int nx = p.nx, L = p.has_net ? p.L : 0;
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

  // packed net: W1^T (1+nx, H), b1 (H), then per hidden layer l >= 2:
  // W_l^T (H, H), W_l (H, H), b_l (H); then the head w (H), b (1)
  const float* W1T = p.w;
  const float* b1 = W1T + (size_t)(1 + nx) * H;
  const float* hidden = b1 + H;
  const float* w_out = hidden + (size_t)(L > 0 ? L - 1 : 0) * (2 * H * H + H);
  const float b_out = p.has_net ? w_out[H] : 0.0f;

  for (int j = tid; j < nx; j += THREADS) xrow[j] = p.x[(size_t)b * nx + j];
  if (p.has_net) {
    for (int n = tid; n < H; n += THREADS) {
      float c = 0.0f;
      for (int j = 0; j < nx; ++j) c += W1T[(size_t)(1 + j) * H + n];
      wcol[n] = c;
    }
  }
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
        u = p.u01 ? p.u01[(size_t)b * p.M + k]
                  : uniform_from_bits(
                        philox4x32_10(make_uint4(k, 0u, 2u, p.seed_hi), key).x);
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
          const size_t o = ((size_t)b * p.M + k) * nx + j;
          a = p.noise_t[o];
          c = p.noise_i[o];
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
          normals4(k, q, 0u, p.seed_hi, key, nt);
          normals4(k, q, 1u, p.seed_hi, key, ni);
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
    if (p.has_net) {
      float acc[SPW][NC];
      // layer 1: z = [s, X_s] W1^T + b1
#pragma unroll
      for (int i = 0; i < SPW; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
      for (int j = 0; j < nx; ++j) {
        float w[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          w[c] = __ldg(&W1T[(size_t)(1 + j) * H + lane + 32 * c]);
#pragma unroll
        for (int i = 0; i < SPW; ++i) {
          const float a = xs[(s0 + i) * nx + j];
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(a, w[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = lane + 32 * c;
        const float w0 = __ldg(&W1T[n]), bb = __ldg(&b1[n]);
#pragma unroll
        for (int i = 0; i < SPW; ++i) {
          const float z = fmaf(w0, s_val[s0 + i], acc[i][c]) + bb;
          hbuf[(s0 + i) * H + n] = elu(z);
        }
      }
      __syncwarp();

      // hidden layers 2..L: z = h W^T + b
      for (int l = 1; l < L; ++l) {
        const float* WT = hidden + (size_t)(l - 1) * (2 * H * H + H);
        const float* bl = WT + 2 * H * H;
        const float* hp = hbuf + (size_t)(l - 1) * S * H + s0 * H;
        float* hc = hbuf + (size_t)l * S * H + s0 * H;
#pragma unroll
        for (int i = 0; i < SPW; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
        for (int kk = 0; kk < H; kk += 4) {
          float w[4][NC];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              w[r][c] = __ldg(&WT[(kk + r) * H + lane + 32 * c]);
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(hp + i * H + kk);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[i][c] = fmaf(a.x, w[0][c], acc[i][c]);
              acc[i][c] = fmaf(a.y, w[1][c], acc[i][c]);
              acc[i][c] = fmaf(a.z, w[2][c], acc[i][c]);
              acc[i][c] = fmaf(a.w, w[3][c], acc[i][c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = lane + 32 * c;
          const float bb = __ldg(&bl[n]);
#pragma unroll
          for (int i = 0; i < SPW; ++i) hc[i * H + n] = elu(acc[i][c] + bb);
        }
        __syncwarp();
      }

      // head: u = h_L w + b; then g_L = w * elu'(h_L), in place
      float* hl = hbuf + (size_t)(L - 1) * S * H + s0 * H;
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = lane + 32 * c;
          part = fmaf(__ldg(&w_out[n]), hl[i * H + n], part);
        }
        u[i] = warp_sum(part) + b_out;
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = lane + 32 * c;
        const float wn = __ldg(&w_out[n]);
#pragma unroll
        for (int i = 0; i < SPW; ++i)
          hl[i * H + n] = wn * elu_grad_from_h(hl[i * H + n]);
      }
      __syncwarp();

      // backward through hidden layers L..2: g_{l-1} = (g_l W) * elu'(h_{l-1})
      for (int l = L - 1; l >= 1; --l) {
        const float* W = hidden + (size_t)(l - 1) * (2 * H * H + H) + H * H;
        const float* gl = hbuf + (size_t)l * S * H + s0 * H;
        float* hp = hbuf + (size_t)(l - 1) * S * H + s0 * H;
#pragma unroll
        for (int i = 0; i < SPW; ++i)
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
        for (int nn = 0; nn < H; nn += 4) {
          float w[4][NC];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < NC; ++c)
              w[r][c] = __ldg(&W[(nn + r) * H + lane + 32 * c]);
#pragma unroll
          for (int i = 0; i < SPW; ++i) {
            const float4 g = *reinterpret_cast<const float4*>(gl + i * H + nn);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              acc[i][c] = fmaf(g.x, w[0][c], acc[i][c]);
              acc[i][c] = fmaf(g.y, w[1][c], acc[i][c]);
              acc[i][c] = fmaf(g.z, w[2][c], acc[i][c]);
              acc[i][c] = fmaf(g.w, w[3][c], acc[i][c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int kcol = lane + 32 * c;
#pragma unroll
          for (int i = 0; i < SPW; ++i)
            hp[i * H + kcol] = acc[i][c] * elu_grad_from_h(hp[i * H + kcol]);
        }
        __syncwarp();
      }

      // sum_j u_x_j = g1 . wcol
      const float* g1 = hbuf + s0 * H;
#pragma unroll
      for (int i = 0; i < SPW; ++i) {
        float part = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int n = lane + 32 * c;
          part = fmaf(g1[i * H + n], wcol[n], part);
        }
        sux[i] = warp_sum(part);
      }
    }

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
                 int B, int M, int nx, int L, int has_net,
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
  p.B = B; p.M = M; p.nx = nx; p.L = L; p.has_net = has_net;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  generate_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
