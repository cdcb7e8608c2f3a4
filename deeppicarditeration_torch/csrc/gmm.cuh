// The OU equation's terminal -log of a diagonal Gaussian mixture, for one
// point per 4 lanes: each lane adds a share of the point's dimensions, the
// component sums go through two shuffles. The
// counterpart of deeppicarditeration_torch/distributions.py:
// DiagGaussianMixture (and of the JAX package's), which the plain versions
// run:
//   lp_k = log w_k - 0.5 (sum_j (y_j - m_kj)^2 / v_kj + n_k),
//   n_k  = sum_j log v_kj + nx log 2 pi  (from the wrapper),
//   g(y) = -logsumexp_k lp_k, grad g(y) = sum_k softmax(lp)_k (y - m_k) / v_k,
// the logsumexp with its maximum subtracted, as torch.logsumexp does; the
// divisions by v_kj are products with 1 / v_kj, inverted once per block.

#pragma once

namespace dpi {

constexpr int GMM_MAX_COMPONENTS = 8;

// The mixture in shared memory: means and inverse variances (K x nx), then
// the log-weights and the normalisers n (K each).
struct Gmm {
  const float* means;
  const float* ivars;
  const float* lw;
  const float* norm;
  int K, nx;
};

// Coordinate j of a point at y, into the partial sums of its logits
// (part[k] += (y - m_kj)^2 / v_kj)
__device__ __forceinline__ void gmm_add(const Gmm& g, int j, float y,
                                        float (&part)[GMM_MAX_COMPONENTS]) {
#pragma unroll
  for (int k = 0; k < GMM_MAX_COMPONENTS; ++k) {
    if (k >= g.K) break;
    const float d = y - g.means[k * g.nx + j];
    part[k] = fmaf(d * d, g.ivars[k * g.nx + j], part[k]);
  }
}

// The logits of a point whose coordinates 4 lanes (4 i .. 4 i + 3 of a
// warp) have added to their partial sums: the 4 sums added (the same on
// each lane), then lp_k.
__device__ __forceinline__ void group_logits(
    const Gmm& g, float (&part)[GMM_MAX_COMPONENTS],
    float (&lp)[GMM_MAX_COMPONENTS]) {
#pragma unroll
  for (int k = 0; k < GMM_MAX_COMPONENTS; ++k) {
    if (k >= g.K) break;
    part[k] += __shfl_xor_sync(0xffffffffu, part[k], 1);
    part[k] += __shfl_xor_sync(0xffffffffu, part[k], 2);
    lp[k] = g.lw[k] - 0.5f * (part[k] + g.norm[k]);
  }
}

__device__ __forceinline__ float gmm_max(const Gmm& g,
                                         const float (&lp)[GMM_MAX_COMPONENTS]) {
  float m = lp[0];
#pragma unroll
  for (int k = 1; k < GMM_MAX_COMPONENTS; ++k)
    if (k < g.K) m = fmaxf(m, lp[k]);
  return m;
}

// g(y) = -logsumexp(lp)
__device__ __forceinline__ float gmm_neg_log_prob(
    const Gmm& g, const float (&lp)[GMM_MAX_COMPONENTS]) {
  const float m = gmm_max(g, lp);
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < GMM_MAX_COMPONENTS; ++k)
    if (k < g.K) s += expf(lp[k] - m);
  return -(logf(s) + m);
}

// the responsibilities softmax(lp), written to r[0 .. K)
__device__ __forceinline__ void gmm_resp(const Gmm& g,
                                         const float (&lp)[GMM_MAX_COMPONENTS],
                                         float* r) {
  const float m = gmm_max(g, lp);
  float e[GMM_MAX_COMPONENTS], s = 0.0f;
#pragma unroll
  for (int k = 0; k < GMM_MAX_COMPONENTS; ++k) {
    e[k] = k < g.K ? expf(lp[k] - m) : 0.0f;
    s += e[k];
  }
#pragma unroll
  for (int k = 0; k < GMM_MAX_COMPONENTS; ++k)
    if (k < g.K) r[k] = e[k] / s;
}

// d/dy_j g(y) = sum_k r_k (y_j - m_kj) / v_kj
__device__ __forceinline__ float gmm_grad(const Gmm& g,
                                          const float (&r)[GMM_MAX_COMPONENTS],
                                          float yj, int j) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < GMM_MAX_COMPONENTS; ++k)
    if (k < g.K) s += r[k] * ((yj - g.means[k * g.nx + j]) *
                              g.ivars[k * g.nx + j]);
  return s;
}

}  // namespace dpi
