// Merged terminal + integral control-variate estimator of the DPI targets
// for the HJB family: the OU equation (a diagonal Gaussian mixture
// terminal) and a frozen PISGradNet iterate, the net's forward pass and its
// gradient in x on Hopper's tensor cores.
//
// Replaces the TPU kernel deeppicarditeration_tpu/ops/pallas_kernels.py:
// _generate_kernel (launched by generate_with_gradients_pallas) on the HJB
// recipe, where its closures hold OUProcessEquation and the 4x512
// PISGradNet; generate.cu keeps the Burgers instance. For each collocation
// point (t, x), with Tt = max(T - t, 1e-6):
//   terminal: X_T = x + sqrt(Tt) sqrt(a) dWt,
//             acc += (g(X_T) - g0) (1, dWt / (sqrt(Tt) sqrt(a)))
//   integral: s = t + u Tt, X_s = x + sqrt(s - t) sqrt(a) dWi,
//             w = grad_x u at (s, X_s) of the frozen net,
//             f = -<theta (mu - X_s), w> - a/2 |w|^2 - nx theta,
//             acc += Tt (f - f0) (1, dWi / (sqrt(max(s - t, 1e-6)) sqrt(a)))
//   out = acc / M + (g0 + f0 Tt, 0),  shape (B, 1 + nx) f32,
// g = -log GMM (gmm.cuh). On the zero iterate f = f0 = -nx theta: the
// integral chain adds nothing and only the terminal chain runs.
//
// The net (models/networks.py:PISGradNet), with lambda = T - s:
//   e = [sin(c lambda + phase), cos(c lambda + phase)]       (128)
//   sigma = S(e)[0] - S(e(0))[0]; S: 128 -> 64, L x (64 -> 64), -> col 0,
//           ELU between; S(e(0))[0] a constant of the net (the wrapper's)
//   h0 = [T_enc(e) (64: 128 -> 64, ELU, 64 -> 64), X_s (nx)]
//   N: L Dense + ELU of width 512, then a 512 -> nx head
//   u = sigma <N(h0), X_s> + (1 - sigma) g(e^{-lambda/2} X_s)
//   w = sigma N(h0) + J_N^T (sigma X_s) + (1 - sigma) e^{-lambda/2}
//       grad g(e^{-lambda/2} X_s)
// f does not depend on u, so only w is formed: the forward pass to the
// head, then the backward pass of the cotangent sigma X_s to the x columns
// of h0. Every Dense product runs with wgmma m64n128k16 in the mode of
// DATA.TPU.PALLAS_PRECISION: "default" one bf16 pass, "bf16x3" three
// (hi*hi + lo*hi + hi*lo, as ops/kernels.py:precision_dot and the JAX
// package's _split3); the mode is a template parameter. The embedding,
// ELU, biases, the S head (a 64-dot with the same hi/lo products), the
// mixture and every sum stay in f32. sinf/cosf are the precise functions
// (arguments up to ~100 rad); this file is built without fast math.
//
// Its bound is the tensor pipe: (164 + 3 x 512) x 512 + 512 x 100 MACs
// forward and about as many backward per sample at nx = 100, 4 x 512:
// ~3.6 MFLOP, 61 TFLOP per call at B = M = 4096, ~61 ms under "default"
// at 989 TFLOP/s and three times that under "bf16x3". Design, first and
// simple:
//   * a block is two consumer warpgroups and a producer warpgroup, one
//     block per SM (persistent grid over the points); the consumers take a
//     point's M samples in tiles of 64 rows (wgmma's M). The producer
//     warpgroup hands its registers to the consumers (setmaxnreg), which
//     otherwise spill (ptxas gives each thread 168 registers);
//   * activations live in shared memory as bf16 images (hi, and lo under
//     bf16x3) of 64 x 512, in wgmma's core-matrix layout (K-major, no
//     swizzle), and are the A operand of every product; a layer's output
//     overwrites its input after both warpgroups' products are done (the
//     512-wide accumulators, 2 x m64n128 per warpgroup, stay in registers
//     until then), so one activation buffer serves the whole pass;
//   * the weights come in k16 slabs (512 x 16 bf16, 16 KB an image) through
//     a ring of stages filled by the producer warp with cp.async.bulk and
//     guarded by mbarriers, in the order the consumers take them; each
//     weight byte read from L2 serves the tile's 64 rows (~3.85 MB of
//     weights per tile under "default", twice that under bf16x3). Each
//     k16 slab is one wgmma group, waited for before the next slab's: a
//     deeper ring (8 stages) did not help, which points at that per-slab
//     issue-and-wait latency rather than at L2 (PERF.md). Larger
//     groups, and a slab shared by two tiles (128 rows), are the next
//     steps;
//   * the backward pass needs each hidden layer's ELU'(z): kept in a global
//     scratch of each block's own (64 x 512 f32 a layer, L2-resident where
//     it fits), written and read by the same thread, as is the head's
//     output; nothing of it is recomputed;
//   * the terminal chain runs per warp, one draw at a time, each lane
//     holding a quad of the draw's normals; its sums over draws are reduced
//     across warps in a fixed order, the integral sums per output in row
//     order (deterministic).
// Draws: Philox4x32-10 keyed by (seed, point), counters (sample, quad,
// chain) as in generate.cu (philox.cuh), so the host reference
// ops/philox.py gives the same numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm.cuh"
#include "philox.cuh"

namespace {

using namespace dpi;

constexpr int TILE = 64;                 // samples per tile: wgmma's M
constexpr int WG_THREADS = 128;          // a warpgroup
constexpr int CONSUMERS = 2 * WG_THREADS;
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
// registers per thread after setmaxnreg: the producer warpgroup gives its
// share to the consumers (128 x 40 + 256 x 232 <= 65 536)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CH = 64;                   // the time net's channels
constexpr int HW = 512;                  // the hidden width covered
constexpr int ACT_COLS = 512;            // columns of the activation buffer
constexpr int ACT_IMAGE = TILE * ACT_COLS * 2;  // one bf16 image: 64 KB
constexpr int SLAB_IMAGE = HW * 16 * 2;  // a k16 slab of 512 rows: 16 KB
constexpr int MAX_STAGES = 4;
constexpr int MAX_NX = 128;
constexpr int NACC = 64;                 // m64n128 accumulator floats
constexpr int NROWS = 9;                 // per-row arrays of a tile
constexpr float PIS_ST_FLOOR = 1e-6f;    // estimators._ST_FLOOR
constexpr size_t SMEM_LIMIT = 232448;
constexpr int MODE_BF16X3 = 1, MODE_ONE_PASS = 2;
constexpr int ERR_NO_PLAN = 10001, ERR_BAD_MODE = 10003, ERR_GRID = 10004;

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// The products of a tile in the order the consumers take them (the order
// of ops/kernels.py:pis_layer_shapes): (N, K) of layer i of 3 L + 5, N the
// B operand's rows (output columns, padded to 128 or 512), K its depth
// (padded to 16).
__host__ __device__ inline void layer_nk(int i, int L, int nx, int* N,
                                         int* K) {
  if (i == 0) { *N = 128; *K = 2 * CH; return; }              // S_0
  if (i <= L) { *N = 128; *K = CH; return; }                  // S_1..S_L
  if (i == L + 1) { *N = 128; *K = 2 * CH; return; }          // T_0
  if (i == L + 2) { *N = 128; *K = CH; return; }              // T_1
  if (i == L + 3) { *N = HW; *K = pad16(CH + nx); return; }   // N_0
  if (i <= 2 * L + 2) { *N = HW; *K = HW; return; }           // N_1..
  if (i == 2 * L + 3) { *N = 128; *K = HW; return; }          // head
  if (i == 2 * L + 4) { *N = HW; *K = pad16(nx); return; }    // head^T
  if (i <= 3 * L + 3) { *N = HW; *K = HW; return; }           // N_l^T
  *N = 128; *K = HW;                                          // N_0x^T
}

__host__ __device__ inline int n_layers(int L) { return 3 * L + 5; }

// bf16 elements of the packed weight images (hi and lo of every slab)
__host__ __device__ inline long long image_elems(int L, int nx) {
  long long e = 0;
  for (int i = 0; i < n_layers(L); ++i) {
    int N, K;
    layer_nk(i, L, nx, &N, &K);
    e += 2LL * N * K;
  }
  return e;
}

// offsets into the f32 vector buffer (ops/kernels.py:pack_pis_tc)
struct VecLayout {
  int coeff, phase, s_bias, s_head, s_head_bias, t_bias, n_bias, h_bias,
      total;
};

__host__ __device__ inline VecLayout vec_layout(int L, int nx) {
  VecLayout v;
  v.coeff = 0;
  v.phase = CH;
  v.s_bias = 2 * CH;                  // S_0..S_L: (L + 1) x 64
  v.s_head = v.s_bias + (L + 1) * CH;  // the S head's row 0: 64
  v.s_head_bias = v.s_head + CH;       // its bias 0: 1
  v.t_bias = v.s_head_bias + 1;        // T_0, T_1: 2 x 64
  v.n_bias = v.t_bias + 2 * CH;        // N_0..N_{L-1}: L x 512
  v.h_bias = v.n_bias + L * HW;        // the head's: nx
  v.total = v.h_bias + nx;
  return v;
}

// Byte offsets of the dynamic shared memory.
struct Plan {
  int stages;
  size_t act, ring, dw, xrow, gmm, rows, resp, bars, total;
};

__host__ __device__ inline Plan make_plan(int nx, int ncomp, int has_net,
                                          bool x3, int stages) {
  Plan p;
  p.stages = stages;
  size_t o = 0;
  p.act = o;
  if (has_net) o += (size_t)(x3 ? 2 : 1) * ACT_IMAGE;
  p.ring = o;
  if (has_net) o += (size_t)stages * (x3 ? 2 : 1) * SLAB_IMAGE;
  p.dw = o;
  o += align16((size_t)TILE * nx * 4);
  p.xrow = o;
  o += align16((size_t)nx * 4);
  p.gmm = o;
  o += align16((size_t)(2 * ncomp * nx + 2 * ncomp) * 4);
  p.rows = o;
  o += (size_t)NROWS * TILE * 4;
  p.resp = o;
  o += (size_t)TILE * GMM_MAX_COMPONENTS * 4;
  p.bars = o;
  o += (size_t)2 * MAX_STAGES * 8;
  p.total = o;
  return p;
}

// the largest ring of 2..MAX_STAGES stages that fits; stages = -1 if none
inline Plan choose_plan(int nx, int ncomp, int has_net, bool x3) {
  for (int st = MAX_STAGES; st >= 2; --st) {
    const Plan p = make_plan(nx, ncomp, has_net, x3, st);
    if (p.total <= SMEM_LIMIT) return p;
  }
  Plan bad = make_plan(nx, ncomp, has_net, x3, 0);
  bad.stages = -1;
  return bad;
}

// floats of global scratch a block keeps: L layers' ELU'(z) and the head
__host__ __device__ inline size_t scratch_floats_per_block(int L) {
  return (size_t)L * TILE * HW + (size_t)TILE * 128;
}

struct Params {
  const float* t;        // (B, 1)
  const float* x;        // (B, nx)
  const float* g0;       // (B, 1)  g(x)
  const float* f0;       // (B, 1)  get_f(t, x)
  const __nv_bfloat16* img;  // packed slabs (ops/kernels.py:pack_pis_tc)
  const float* vec;      // embedding, biases, the S head (vec_layout)
  const float* gmm;      // means, vars (K, nx), log-weights, norms (K)
  const float* u01;      // (B, M) or null: in-kernel draws
  const float* noise_t;  // (B, M, nx) or null
  const float* noise_i;  // (B, M, nx) or null
  float* scratch;        // gridDim.x x scratch_floats_per_block(L)
  float* out;            // (B, 1 + nx)
  int B, M, nx, L, has_net, ncomp, stages;
  uint32_t seed_lo, seed_hi;
  float T, alpha_sqrt, theta, mu, half_alpha, nx_theta, sigma0;
};

// ---- PTX: shared-memory addresses, mbarriers, bulk copies, wgmma --------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the 256 consumers (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// shared-memory writes by threads, made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128 f32) += A (64 x 16 bf16, shared memory at desc_a) B^T (B:
// 128 x 16 bf16, shared memory at desc_b), both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[NACC], uint64_t desc_a,
                                         uint64_t desc_b) {
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
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// ---- layouts ------------------------------------------------------------

// Accumulator element i of a warpgroup thread (warp w in the group, lane
// 4 g + t) holds row 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) +
// 2 t + (i & 1) of its m64n128 tile.
__device__ __forceinline__ int acc_row(int i, int w, int g) {
  return 16 * w + g + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

// Byte offset of element (row, col) in an activation image: core matrices
// of 8 rows x 8 columns (128 B), core (row / 8, col / 8) at (row / 8 x 64 +
// col / 8) x 128 B (LBO 128 B along K, SBO 8 KB along M).
__device__ __forceinline__ uint32_t act_off(int row, int col) {
  return (uint32_t)((((row >> 3) * (ACT_COLS / 8) + (col >> 3)) << 7) +
                    ((row & 7) << 4) + ((col & 7) << 1));
}

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// a, b -> their bf16 hi parts and residuals lo, packed (a in the low half)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
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

// columns (col, col + 1) of `row`, f32 values a, b, into the activation
// images (lo only under bf16x3)
template <bool X3>
__device__ __forceinline__ void put_pair(unsigned char* act, int row,
                                         int col, float a, float b) {
  uint32_t hi, lo;
  split_pair(a, b, hi, lo);
  const uint32_t o = act_off(row, col);
  *reinterpret_cast<uint32_t*>(act + o) = hi;
  if (X3) *reinterpret_cast<uint32_t*>(act + ACT_IMAGE + o) = lo;
}

__device__ __forceinline__ float elu(float z, float* d) {
  const float ez = expf(fminf(z, 0.0f));
  *d = z > 0.0f ? 1.0f : ez;
  return z > 0.0f ? z : ez - 1.0f;
}

// ---- the ring of weight slabs -------------------------------------------

struct Ring {
  uint32_t base, full, empty;
  int stages, it, stage_bytes;

  __device__ __forceinline__ uint32_t acquire() {
    const int st = it % stages;
    mbar_wait(full + 8 * st, (uint32_t)((it / stages) & 1));
    ++it;
    return base + (uint32_t)(st * stage_bytes);
  }
  __device__ __forceinline__ void release(int n) {
    mbar_arrive(empty + 8 * (n % stages));
  }
};

// One layer's products: acc_c (c < NCH) += A[:, in_col .. in_col + K)
// times the slabs' rows 256 wg + 128 c .. + 128, for the K / 16 slabs of
// the layer (every consumer takes and frees every slab; warpgroups with
// NCH = 0 only pass them on). One wgmma group per slab, one in flight.
template <bool X3, int NCH>
__device__ __forceinline__ void layer_mma(float (&a0)[NACC],
                                          float (&a1)[NACC], uint32_t act,
                                          int in_col, int K, int wg,
                                          Ring& ring) {
  if (NCH > 0) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) a0[i] = 0.0f;
  }
  if (NCH > 1) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) a1[i] = 0.0f;
  }
  const int nslab = K / 16;
  int freed = ring.it;
  for (int ks = 0; ks < nslab; ++ks) {
    const uint32_t stage = ring.acquire();
    if (NCH > 0) {
      fence_acc(a0);
      if (NCH > 1) fence_acc(a1);
      wgmma_fence();
      const uint32_t a_hi = act + (uint32_t)((in_col / 8 + 2 * ks) * 128);
      const uint64_t dah = gmma_desc(a_hi, 128, 8192);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        // the slab's rows 256 wg + 128 c ..: 16 core rows of 256 B; the
        // lo images SLAB_IMAGE and ACT_IMAGE bytes after the hi ones
        const uint32_t b = stage + (uint32_t)((32 * wg + 16 * c) * 256);
        const uint64_t dbh = gmma_desc(b, 128, 256);
        if (c == 0) {
          wgmma_ss(a0, dah, dbh);
          if (X3) {
            wgmma_ss(a0, gmma_desc(a_hi + ACT_IMAGE, 128, 8192), dbh);
            wgmma_ss(a0, dah, gmma_desc(b + SLAB_IMAGE, 128, 256));
          }
        } else {
          wgmma_ss(a1, dah, dbh);
          if (X3) {
            wgmma_ss(a1, gmma_desc(a_hi + ACT_IMAGE, 128, 8192), dbh);
            wgmma_ss(a1, dah, gmma_desc(b + SLAB_IMAGE, 128, 256));
          }
        }
      }
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        fence_acc(a0);
        if (NCH > 1) fence_acc(a1);
        ring.release(freed++);
      }
    } else if (ks > 0) {
      ring.release(freed++);
    }
  }
  if (NCH > 0) {
    wgmma_wait<0>();
    fence_acc(a0);
    if (NCH > 1) fence_acc(a1);
  }
  ring.release(freed++);
  consumers_sync();  // every product has read the input: it may be written
}

// ---- the producer -------------------------------------------------------

// Every slab of every tile of this block's points, in the consumers' order;
// a stage holds a slab's hi image (N x 16 bf16) and, under bf16x3, its lo
// image SLAB_IMAGE bytes after.
__device__ __forceinline__ void produce(const Params& p, bool x3,
                                        uint32_t ring, int stage_bytes,
                                        uint32_t full, uint32_t empty) {
  const int ntile = (p.M + TILE - 1) / TILE;
  const int nl = n_layers(p.L);
  int it = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; ++kb) {
      const unsigned char* src =
          reinterpret_cast<const unsigned char*>(p.img);
      for (int li = 0; li < nl; ++li) {
        int N, K;
        layer_nk(li, p.L, p.nx, &N, &K);
        const uint32_t bytes = (uint32_t)N * 32;
        for (int ks = 0; ks < K / 16; ++ks, ++it) {
          const int st = it % p.stages, round = it / p.stages;
          if (round > 0)
            mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
          const uint32_t bar = full + 8 * st;
          const uint32_t dst = ring + (uint32_t)(st * stage_bytes);
          mbar_expect_tx(bar, x3 ? 2 * bytes : bytes);
          bulk_copy(dst, src, bytes, bar);
          if (x3) bulk_copy(dst + SLAB_IMAGE, src + bytes, bytes, bar);
          src += 2 * bytes;
        }
      }
    }
}

// ---- the consumers' steps -----------------------------------------------

struct Rows {
  float *s, *sig, *iys, *lam, *decay, *sigma, *f, *c_i, *c_iy;
};

__device__ __forceinline__ Rows carve_rows(unsigned char* smem,
                                           const Plan& pl) {
  float* r = reinterpret_cast<float*>(smem + pl.rows);
  Rows w;
  w.s = r;
  w.sig = r + TILE;
  w.iys = r + 2 * TILE;
  w.lam = r + 3 * TILE;
  w.decay = r + 4 * TILE;
  w.sigma = r + 5 * TILE;
  w.f = r + 6 * TILE;
  w.c_i = r + 7 * TILE;
  w.c_iy = r + 8 * TILE;
  return w;
}

// X_s = x + sqrt(s - t) sqrt(a) dWi, its factors rounded as the plain
// version's
__device__ __forceinline__ float xs_of(const float* xrow, const Rows& r,
                                       const float* dw, int nx, int row,
                                       int j) {
  return __fadd_rn(xrow[j], __fmul_rn(r.sig[row], dw[row * nx + j]));
}

// Bias (and ELU, saving ELU'(z)) of a layer's accumulator, written to the
// activation images at out_col: columns below n_valid of the chunk.
template <bool X3, bool ACT>
__device__ __forceinline__ void epilogue(float (&acc)[NACC],
                                         unsigned char* act, const float* bias,
                                         int out_col, int n_valid, int w,
                                         int g, int t, float2* save,
                                         size_t save_stride) {
#pragma unroll
  for (int q = 0; q < NACC / 2; ++q) {
    const int i = 2 * q;
    const int col = acc_col(i, t);
    float d0 = 1.0f, d1 = 1.0f;
    float v0 = 0.0f, v1 = 0.0f;
    if (col < n_valid) {
      v0 = acc[i] + __ldg(bias + col);
      v1 = acc[i + 1] + __ldg(bias + col + 1);
      if (ACT) {
        v0 = elu(v0, &d0);
        v1 = elu(v1, &d1);
      }
      put_pair<X3>(act, acc_row(i, w, g), out_col + col, v0, v1);
    }
    if (save) save[(size_t)q * save_stride] = make_float2(d0, d1);
  }
}

// Backward epilogue: acc times the saved ELU'(z), written at column 0..
template <bool X3>
__device__ __forceinline__ void epilogue_bwd(float (&acc)[NACC],
                                             unsigned char* act, int col0,
                                             int w, int g, int t,
                                             const float2* save,
                                             size_t save_stride) {
#pragma unroll
  for (int q = 0; q < NACC / 2; ++q) {
    const int i = 2 * q;
    const float2 d = save[(size_t)q * save_stride];
    put_pair<X3>(act, acc_row(i, w, g), col0 + acc_col(i, t), acc[i] * d.x,
                 acc[i + 1] * d.y);
  }
}

template <bool X3>
__global__ void __launch_bounds__(THREADS, 1)
generate_pis_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  const Plan pl = make_plan(nx, p.ncomp, p.has_net, X3, p.stages);
  unsigned char* act = smem + pl.act;
  float* dw = reinterpret_cast<float*>(smem + pl.dw);
  float* xrow = reinterpret_cast<float*>(smem + pl.xrow);
  float* gm = reinterpret_cast<float*>(smem + pl.gmm);
  float* resp = reinterpret_cast<float*>(smem + pl.resp);
  float* red = dw;  // after the last tile: the warps' terminal sums
  const Rows rw = carve_rows(smem, pl);
  const int stage_bytes = (X3 ? 2 : 1) * SLAB_IMAGE;
  const uint32_t full = smem_u32(smem + pl.bars);
  const uint32_t empty = full + 8 * MAX_STAGES;

  // the mixture, once per block
  const int ng = 2 * p.ncomp * nx + 2 * p.ncomp;
  for (int e = threadIdx.x; e < ng; e += THREADS) gm[e] = p.gmm[e];
  if (threadIdx.x == 0 && L > 0) {
    for (int st = 0; st < p.stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(PRODUCER_REGS));
    if (L > 0 && threadIdx.x == CONSUMERS)
      produce(p, X3, smem_u32(smem + pl.ring), stage_bytes, full, empty);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(CONSUMER_REGS));

  const Gmm gmix{gm, gm + p.ncomp * nx, gm + 2 * p.ncomp * nx,
                 gm + 2 * p.ncomp * nx + p.ncomp, p.ncomp, nx};
  const int ctid = threadIdx.x, warp = ctid >> 5, lane = ctid & 31;
  const int wg = ctid >> 7, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int wtid = ctid & (WG_THREADS - 1);
  Ring ring{smem_u32(smem + pl.ring), full, empty, p.stages, 0, stage_bytes};
  const uint32_t act_u = smem_u32(act);
  const VecLayout vl = vec_layout(L, nx);
  const int ntile = (p.M + TILE - 1) / TILE;
  const int Q = (nx + 3) / 4;
  const float inv_m = 1.0f / (float)p.M;
  const int k_h0 = pad16(CH + nx), k_cot = pad16(nx);
  // this block's scratch: L x 2 chunks x 32 pairs x 256 threads, then the
  // head's 32 pairs x 128 threads
  float2* scr = reinterpret_cast<float2*>(
      p.scratch + (size_t)blockIdx.x * scratch_floats_per_block(L));
  float2* scr_head = scr + (size_t)L * 2 * 32 * CONSUMERS;

  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t0 = p.t[b], g0 = p.g0[b], f0 = p.f0[b];
    const float Tt = fmaxf(p.T - t0, 1e-6f);
    const float sqrt_Tt = sqrtf(Tt);
    const float cT = sqrt_Tt * p.alpha_sqrt;
    const float inv_yT = 1.0f / (sqrt_Tt * p.alpha_sqrt);
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    for (int j = ctid; j < nx; j += CONSUMERS)
      xrow[j] = p.x[(size_t)b * nx + j];
    float acc_i = 0.0f, acc_tv = 0.0f, acc_t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    consumers_sync();

    for (int kb = 0; kb < ntile; ++kb) {
      // ---- the terminal chain: warp `warp` takes rows 8 warp .. + 7 ----
      for (int d = 0; d < 8; ++d) {
        const int k = kb * TILE + 8 * warp + d;
        if (k >= p.M) break;
        float n[4] = {0.0f, 0.0f, 0.0f, 0.0f}, y[4];
        if (lane < Q) {
          if (p.noise_t) {
            const float* row = p.noise_t + ((size_t)b * p.M + k) * nx;
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (4 * lane + r < nx) n[r] = row[4 * lane + r];
          } else {
            normals4(k, lane, STREAM_TERMINAL, p.seed_hi, key, n);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (4 * lane + r >= nx) n[r] = 0.0f;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * lane + r;
          y[r] = j < nx ? __fadd_rn(xrow[j], __fmul_rn(cT, n[r])) : 0.0f;
        }
        float lp[GMM_MAX_COMPONENTS];
        gmm_logits(gmix, y, lane, lp);
        const float diff = gmm_neg_log_prob(gmix, lp) - g0;
        acc_tv += diff;
#pragma unroll
        for (int r = 0; r < 4; ++r) acc_t[r] = fmaf(diff, n[r], acc_t[r]);
      }
      if (L == 0) continue;  // the zero iterate: f = f0, no integral term

      // ---- the integral chain's draws: times, normals, X_s -------------
      if (ctid < TILE) {
        const int k = kb * TILE + ctid;
        float u = 0.0f;
        if (k < p.M)
          u = p.u01 ? p.u01[(size_t)b * p.M + k]
                    : time_uniform(k, p.seed_hi, key);
        const float sv = __fadd_rn(t0, __fmul_rn(u, Tt));
        const float st = sv - t0;
        const float lam = p.T - sv;
        rw.s[ctid] = sv;
        rw.sig[ctid] = sqrtf(st) * p.alpha_sqrt;
        rw.iys[ctid] = 1.0f / (sqrtf(fmaxf(st, PIS_ST_FLOOR)) * p.alpha_sqrt);
        rw.lam[ctid] = lam;
        rw.decay[ctid] = expf(-0.5f * lam);
      }
      if (p.noise_i) {
        for (int e = ctid; e < TILE * nx; e += CONSUMERS) {
          const int i = e / nx, j = e - i * nx, k = kb * TILE + i;
          dw[e] = k < p.M ? p.noise_i[((size_t)b * p.M + k) * nx + j] : 0.0f;
        }
      } else {
        for (int e = ctid; e < TILE * Q; e += CONSUMERS) {
          const int i = e / Q, q = e - i * Q, k = kb * TILE + i;
          float nn[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (k < p.M) normals4(k, q, STREAM_INTEGRAL, p.seed_hi, key, nn);
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (4 * q + r < nx) dw[i * nx + 4 * q + r] = nn[r];
        }
      }
      consumers_sync();

      // ---- e(lambda) into columns 0..127; the residual's weights --------
      for (int e = ctid; e < TILE * CH; e += CONSUMERS) {
        const int row = e / CH, c = e - row * CH;
        const float arg = __fadd_rn(__fmul_rn(__ldg(p.vec + vl.coeff + c),
                                              rw.lam[row]),
                                    __ldg(p.vec + vl.phase + c));
        // columns c (sin) and CH + c (cos) are not a pair: write singly
        const float sv = sinf(arg), cv = cosf(arg);
        const __nv_bfloat16 hs = __float2bfloat16_rn(sv);
        const __nv_bfloat16 hc = __float2bfloat16_rn(cv);
        *reinterpret_cast<__nv_bfloat16*>(act + act_off(row, c)) = hs;
        *reinterpret_cast<__nv_bfloat16*>(act + act_off(row, CH + c)) = hc;
        if (X3) {
          *reinterpret_cast<__nv_bfloat16*>(act + ACT_IMAGE +
                                            act_off(row, c)) =
              __float2bfloat16_rn(sv - __bfloat162float(hs));
          *reinterpret_cast<__nv_bfloat16*>(act + ACT_IMAGE +
                                            act_off(row, CH + c)) =
              __float2bfloat16_rn(cv - __bfloat162float(hc));
        }
      }
      // responsibilities of the mixture at e^{-lambda/2} X_s, per row
      for (int row = warp; row < TILE; row += CONSUMERS / 32) {
        float y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 4 * lane + r;
          y[r] = j < nx ? rw.decay[row] * xs_of(xrow, rw, dw, nx, row, j)
                        : 0.0f;
        }
        float lp[GMM_MAX_COMPONENTS];
        gmm_logits(gmix, y, lane, lp);
        if (lane == 0) gmm_resp(gmix, lp, resp + row * GMM_MAX_COMPONENTS);
      }
      fence_async_smem();
      consumers_sync();

      float a0[NACC], a1[NACC];
      // ---- the gate: S_0 (128 -> 64) .. S_L, ELU, at columns 128.. -----
      for (int l = 0; l <= L; ++l) {
        if (wg == 0) {
          layer_mma<X3, 1>(a0, a1, act_u, l == 0 ? 0 : 128, l == 0 ? 2 * CH
                                                                   : CH,
                           wg, ring);
        } else {
          layer_mma<X3, 0>(a0, a1, act_u, 0, l == 0 ? 2 * CH : CH, wg, ring);
        }
        if (wg == 0) {
          if (l < L) {
            epilogue<X3, true>(a0, act, p.vec + vl.s_bias + l * CH, 128, CH,
                               w, g, t, nullptr, 0);
          } else {
            // ELU, then the head's column 0 with _split3's products
            const float* hw = p.vec + vl.s_head;
            const float* bias = p.vec + vl.s_bias + l * CH;
            float sr[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < NACC; ++i) {
              const int col = acc_col(i, t);
              if (col < CH) {
                float dd;
                const float h = elu(a0[i] + __ldg(bias + col), &dd);
                const float wv = __ldg(hw + col);
                const float wh = bf16_round(wv), hh = bf16_round(h);
                float term = hh * wh;
                if (X3) term += bf16_round(h - hh) * wh +
                                hh * bf16_round(wv - wh);
                sr[(i >> 1) & 1] += term;
              }
            }
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              sr[r] += __shfl_xor_sync(0xffffffffu, sr[r], 1);
              sr[r] += __shfl_xor_sync(0xffffffffu, sr[r], 2);
            }
            if (t == 0) {
              const float hb = __ldg(p.vec + vl.s_head_bias);
              rw.sigma[16 * w + g] = (sr[0] + hb) - p.sigma0;
              rw.sigma[16 * w + g + 8] = (sr[1] + hb) - p.sigma0;
            }
          }
        }
        fence_async_smem();
        consumers_sync();
      }

      // ---- T_enc: 128 -> 64 (ELU) at columns 192.., 64 -> 64 at 0.. ----
      for (int l = 0; l < 2; ++l) {
        const int K = l == 0 ? 2 * CH : CH, in_col = l == 0 ? 0 : 192;
        if (wg == 0)
          layer_mma<X3, 1>(a0, a1, act_u, in_col, K, wg, ring);
        else
          layer_mma<X3, 0>(a0, a1, act_u, in_col, K, wg, ring);
        if (wg == 0) {
          if (l == 0)
            epilogue<X3, true>(a0, act, p.vec + vl.t_bias, 192, CH, w, g, t,
                               nullptr, 0);
          else
            epilogue<X3, false>(a0, act, p.vec + vl.t_bias + CH, 0, CH, w, g,
                                t, nullptr, 0);
        }
        if (l == 1) {
          // h0 = [T_enc(e), X_s, 0 ..]: X_s at columns 64 .. 64 + nx
          const int half = (k_h0 - CH) / 2;
          for (int e = ctid; e < TILE * half; e += CONSUMERS) {
            const int row = e / half, j = 2 * (e - row * half);
            const float v0 = j < nx ? xs_of(xrow, rw, dw, nx, row, j) : 0.0f;
            const float v1 =
                j + 1 < nx ? xs_of(xrow, rw, dw, nx, row, j + 1) : 0.0f;
            put_pair<X3>(act, row, CH + j, v0, v1);
          }
        }
        fence_async_smem();
        consumers_sync();
      }

      // ---- N forward: L layers of 512 with ELU (ELU' saved), the head ---
      for (int l = 0; l < L; ++l) {
        layer_mma<X3, 2>(a0, a1, act_u, 0, l == 0 ? k_h0 : HW, wg, ring);
        float2* sv = scr + (size_t)(l * 2) * 32 * CONSUMERS + ctid;
        const float* bias = p.vec + vl.n_bias + l * HW + 256 * wg;
        epilogue<X3, true>(a0, act, bias, 256 * wg, 128, w, g, t, sv,
                           CONSUMERS);
        epilogue<X3, true>(a1, act, bias + 128, 256 * wg + 128, 128, w, g, t,
                           sv + (size_t)32 * CONSUMERS, CONSUMERS);
        fence_async_smem();
        consumers_sync();
      }
      if (wg == 0)
        layer_mma<X3, 1>(a0, a1, act_u, 0, HW, wg, ring);
      else
        layer_mma<X3, 0>(a0, a1, act_u, 0, HW, wg, ring);
      if (wg == 0) {  // the head's output N(h0), kept for w
#pragma unroll
        for (int q = 0; q < NACC / 2; ++q) {
          const int i = 2 * q, col = acc_col(i, t);
          float2 v = make_float2(0.0f, 0.0f);
          if (col < nx) v.x = a0[i] + __ldg(p.vec + vl.h_bias + col);
          if (col + 1 < nx) v.y = a0[i + 1] + __ldg(p.vec + vl.h_bias + col + 1);
          scr_head[(size_t)q * WG_THREADS + wtid] = v;
        }
      }
      // the cotangent sigma X_s at columns 0 .. nx, zero to k_cot
      for (int e = ctid; e < TILE * (k_cot / 2); e += CONSUMERS) {
        const int row = e / (k_cot / 2), j = 2 * (e - row * (k_cot / 2));
        const float sg = rw.sigma[row];
        const float v0 = j < nx ? sg * xs_of(xrow, rw, dw, nx, row, j) : 0.0f;
        const float v1 =
            j + 1 < nx ? sg * xs_of(xrow, rw, dw, nx, row, j + 1) : 0.0f;
        put_pair<X3>(act, row, j, v0, v1);
      }
      fence_async_smem();
      consumers_sync();

      // ---- N backward: the head, then layers L-1 .. 1, times ELU' ------
      for (int l = L - 1; l >= 0; --l) {
        layer_mma<X3, 2>(a0, a1, act_u, 0, l == L - 1 ? k_cot : HW, wg,
                         ring);
        const float2* sv = scr + (size_t)(l * 2) * 32 * CONSUMERS + ctid;
        epilogue_bwd<X3>(a0, act, 256 * wg, w, g, t, sv, CONSUMERS);
        epilogue_bwd<X3>(a1, act, 256 * wg + 128, w, g, t,
                         sv + (size_t)32 * CONSUMERS, CONSUMERS);
        fence_async_smem();
        consumers_sync();
      }
      // the x columns of h0's gradient; w and f per row (warpgroup 0)
      if (wg == 0)
        layer_mma<X3, 1>(a0, a1, act_u, 0, HW, wg, ring);
      else
        layer_mma<X3, 0>(a0, a1, act_u, 0, HW, wg, ring);
      if (wg == 0) {
        float dr[2] = {0.0f, 0.0f}, qr[2] = {0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < NACC / 2; ++q) {
          const float2 no = scr_head[(size_t)q * WG_THREADS + wtid];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * q + e, col = acc_col(i, t);
            if (col < nx) {
              const int row = acc_row(i, w, g), h = (i >> 1) & 1;
              const float sg = rw.sigma[row], dc = rw.decay[row];
              const float xs = xs_of(xrow, rw, dw, nx, row, col);
              const float gres =
                  gmm_grad(gmix, resp + row * GMM_MAX_COMPONENTS, dc * xs,
                           col);
              const float wv = sg * (e ? no.y : no.x) + a0[i] +
                               (1.0f - sg) * (dc * gres);
              dr[h] += (p.theta * (p.mu - xs)) * wv;
              qr[h] += wv * wv;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dr[h] += __shfl_xor_sync(0xffffffffu, dr[h], 1);
          dr[h] += __shfl_xor_sync(0xffffffffu, dr[h], 2);
          qr[h] += __shfl_xor_sync(0xffffffffu, qr[h], 1);
          qr[h] += __shfl_xor_sync(0xffffffffu, qr[h], 2);
        }
        if (t == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            rw.f[16 * w + g + 8 * h] =
                -dr[h] - p.half_alpha * qr[h] - p.nx_theta;
        }
      }
      consumers_sync();

      // ---- the rows' weights and the integral sums, in row order -------
      if (ctid < TILE) {
        const bool valid = kb * TILE + ctid < p.M;
        const float di = valid ? Tt * (rw.f[ctid] - f0) : 0.0f;
        rw.c_i[ctid] = di;
        rw.c_iy[ctid] = di * rw.iys[ctid];
      }
      consumers_sync();
      if (ctid == 0) {
        for (int row = 0; row < TILE; ++row) acc_i += rw.c_i[row];
      } else if (ctid <= nx) {
        for (int row = 0; row < TILE; ++row)
          acc_i = fmaf(rw.c_iy[row], dw[row * nx + ctid - 1], acc_i);
      }
      consumers_sync();
    }

    // the 8 warps' terminal sums, added in a fixed order
    if (lane == 0) red[warp * (1 + nx)] = acc_tv;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (4 * lane + r < nx) red[warp * (1 + nx) + 1 + 4 * lane + r] = acc_t[r];
    consumers_sync();
    if (ctid <= nx) {
      float sum_t = 0.0f;
#pragma unroll
      for (int v = 0; v < CONSUMERS / 32; ++v) sum_t += red[v * (1 + nx) + ctid];
      p.out[(size_t)b * (1 + nx) + ctid] =
          ctid == 0 ? (sum_t + acc_i) * inv_m + g0 + f0 * Tt
                    : (sum_t * inv_yT + acc_i) * inv_m;
    }
    consumers_sync();
  }
}

using Kernel = void (*)(const Params);
Kernel pick(int mode) {
  return mode == MODE_BF16X3 ? generate_pis_kernel<true>
                             : generate_pis_kernel<false>;
}

}  // namespace

extern "C" {

// limits and the layout the Python wrapper checks before a launch
int dpi_generate_pis_hidden_width() { return HW; }
int dpi_generate_pis_channels() { return CH; }
int dpi_generate_pis_max_nx() { return MAX_NX; }
int dpi_generate_pis_max_components() { return GMM_MAX_COMPONENTS; }
long long dpi_generate_pis_image_elems(int nx, int L) {
  return image_elems(L, nx);
}
int dpi_generate_pis_vec_floats(int nx, int L) {
  return vec_layout(L, nx).total;
}
// shared memory of a launch's plan, or -1 (no plan)
long long dpi_generate_pis_smem_bytes(int nx, int ncomp, int has_net,
                                      int mode) {
  const Plan pl = choose_plan(nx, ncomp, has_net, mode == MODE_BF16X3);
  return pl.stages < 0 ? -1 : (long long)pl.total;
}
// blocks of the persistent grid (one per SM), or -1
int dpi_generate_pis_grid(int nx, int ncomp, int has_net, int mode, int B) {
  const Plan pl = choose_plan(nx, ncomp, has_net, mode == MODE_BF16X3);
  if (pl.stages < 0) return -1;
  int dev = 0, sms = 0, per_sm = 0;
  Kernel k = pick(mode);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)pl.total) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, THREADS,
                                                    pl.total) !=
          cudaSuccess ||
      per_sm < 1)
    return -1;
  return B < sms * per_sm ? B : sms * per_sm;
}
// floats of global scratch per block of the grid
long long dpi_generate_pis_scratch_floats(int L) {
  return (long long)scratch_floats_per_block(L);
}

// Launches on `stream` with `grid` blocks (dpi_generate_pis_grid); returns
// 0, a CUDA error or ERR_* (10001 no plan, 10003 bad mode, 10004 grid).
int dpi_generate_pis(const float* t, const float* x, const float* g0,
                     const float* f0, const void* img, const float* vec,
                     const float* gmm, const float* u01, const float* noise_t,
                     const float* noise_i, float* scratch, float* out, int B,
                     int M, int nx, int L, int has_net, int ncomp, int mode,
                     int grid, unsigned long long seed, float T,
                     float alpha_sqrt, float theta, float mu, float half_alpha,
                     float nx_theta, float sigma0, void* stream) {
  if (mode != MODE_BF16X3 && mode != MODE_ONE_PASS) return ERR_BAD_MODE;
  if (nx < 1 || nx > MAX_NX || ncomp < 1 || ncomp > GMM_MAX_COMPONENTS ||
      (has_net && L < 1))
    return ERR_NO_PLAN;
  const Plan pl = choose_plan(nx, ncomp, has_net, mode == MODE_BF16X3);
  if (pl.stages < 0) return ERR_NO_PLAN;
  if (grid < 1) return ERR_GRID;
  Kernel k = pick(mode);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.total);
  if (e != cudaSuccess) return (int)e;
  Params p;
  p.t = t; p.x = x; p.g0 = g0; p.f0 = f0;
  p.img = static_cast<const __nv_bfloat16*>(img); p.vec = vec; p.gmm = gmm;
  p.u01 = u01; p.noise_t = noise_t; p.noise_i = noise_i;
  p.scratch = scratch; p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = has_net ? L : 0; p.has_net = has_net;
  p.ncomp = ncomp; p.stages = pl.stages;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.theta = theta; p.mu = mu;
  p.half_alpha = half_alpha; p.nx_theta = nx_theta; p.sigma0 = sigma0;
  k<<<grid, THREADS, pl.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
