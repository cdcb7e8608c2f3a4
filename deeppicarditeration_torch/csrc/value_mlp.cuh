// The frozen value network inside the merged estimator's "highest" kernel
// (generate.cu): forward pass to u and backward pass to sum_j u_x_j for one
// warp's SPW samples. Counterpart of the frozen-net get_f the TPU kernels
// trace into their bodies (pallas_kernels.py: f_of).
//
// The net is a Value MLP of L ELU hidden layers of width H = 128 and one
// unclamped output. Weights are read from global memory through L1/L2 (the
// 251 KB of the 4x128 net exceed a block's shared memory), in layouts that
// make each warp's loads coalesced: W^T for the forward pass, W for the
// backward. Each lane owns NC = 4 neurons of each of the warp's 8 samples.
// Activations of every hidden layer stay in shared memory (hbuf, L x S x H
// for the S samples of an inner block) for the backward pass, which
// overwrites them in place with the gradients.
//
// The Burgers equation Cha reads u_x only through sum_j u_x_j, so the
// backward pass stops at the first layer's pre-activation gradient g1 and
// contracts it with the column sums of W1's x-part:
// sum_j u_x_j = sum_n g1_n sum_j W1[n, 1 + j]. Dots are plain FP32 FMA.

#pragma once

#include "philox.cuh"

namespace dpi {

constexpr int H = 128;   // hidden width
constexpr int NC = H / 32;  // neurons per lane
constexpr int SPW = 8;   // samples per warp
// the integral chain's floor on s - t under 1/sqrt (estimators._ST_FLOOR)
constexpr float ST_FLOOR = 1e-6f;

// the reference's exp-based ELU, and its derivative read back from the
// activation h: elu'(z) = 1 for z > 0 (then h = z > 0), else exp(z) = h + 1
__device__ __forceinline__ float elu(float z) {
  return z > 0.0f ? z : expf(z) - 1.0f;
}
__device__ __forceinline__ float elu_grad_from_h(float h) {
  return h > 0.0f ? 1.0f : h + 1.0f;
}

// Packed net (ops/kernels.py:pack_mlp): W1^T (1+nx, H), b1 (H), then per
// hidden layer l >= 2: W_l^T (H, H), W_l (H, H), b_l (H); then the head's
// weight row (H) and bias (1).
struct ValueMlp {
  const float* W1T;
  const float* b1;
  const float* hidden;
  const float* w_out;
  float b_out;
  int L;
};

__device__ __forceinline__ ValueMlp value_mlp(const float* w, int nx, int L) {
  ValueMlp net;
  net.W1T = w;
  net.b1 = w + (size_t)(1 + nx) * H;
  net.hidden = net.b1 + H;
  net.w_out = net.hidden + (size_t)(L > 0 ? L - 1 : 0) * (2 * H * H + H);
  net.b_out = L > 0 ? net.w_out[H] : 0.0f;
  net.L = L;
  return net;
}

// wcol[n] = sum_j W1[n, 1 + j], by the block's threads (sync after)
__device__ __forceinline__ void column_sums(const ValueMlp& net, int nx,
                                            float* wcol, int tid,
                                            int nthreads) {
  for (int n = tid; n < H; n += nthreads) {
    float c = 0.0f;
    for (int j = 0; j < nx; ++j) c += net.W1T[(size_t)(1 + j) * H + n];
    wcol[n] = c;
  }
}

// u and sum_j u_x_j of the net at (s, X_s) for this warp's SPW samples,
// slots s0 .. s0 + SPW - 1 of an inner block of S samples. xs: S x nx,
// s_val: S, hbuf: L x S x H (scratch), wcol: H. Warp-synchronous.
__device__ __forceinline__ void value_and_grad_sum(
    const ValueMlp& net, int nx, int S, int s0, int lane, const float* xs,
    const float* s_val, float* hbuf, const float* wcol, float u[SPW],
    float sux[SPW]) {
  const int L = net.L;
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
      w[c] = __ldg(&net.W1T[(size_t)(1 + j) * H + lane + 32 * c]);
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
    const float w0 = __ldg(&net.W1T[n]), bb = __ldg(&net.b1[n]);
#pragma unroll
    for (int i = 0; i < SPW; ++i) {
      const float z = fmaf(w0, s_val[s0 + i], acc[i][c]) + bb;
      hbuf[(s0 + i) * H + n] = elu(z);
    }
  }
  __syncwarp();

  // hidden layers 2..L: z = h W^T + b
  for (int l = 1; l < L; ++l) {
    const float* WT = net.hidden + (size_t)(l - 1) * (2 * H * H + H);
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
      part = fmaf(__ldg(&net.w_out[n]), hl[i * H + n], part);
    }
    u[i] = warp_sum(part) + net.b_out;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int n = lane + 32 * c;
    const float wn = __ldg(&net.w_out[n]);
#pragma unroll
    for (int i = 0; i < SPW; ++i)
      hl[i * H + n] = wn * elu_grad_from_h(hl[i * H + n]);
  }
  __syncwarp();

  // backward through hidden layers L..2: g_{l-1} = (g_l W) * elu'(h_{l-1})
  for (int l = L - 1; l >= 1; --l) {
    const float* W = net.hidden + (size_t)(l - 1) * (2 * H * H + H) + H * H;
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

}  // namespace dpi
