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
// of h0. Every Dense product runs with wgmma in the mode of
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
// at 989 TFLOP/s and three times that under "bf16x3". What binds is the
// schedule around the products (PERF.md): each wgmma group's handshake
// and wait, the L2 latency of the weights' stream (~3.7 MB a 64-sample
// tile under "default", twice that under bf16x3; not its bandwidth), the
// CUDA-core phases between the products, and the kernel's code size
// (tens of thousands of instructions run once a tile). The design:
//   * a block is two consumer warpgroups and a producer warpgroup, one
//     block per SM (persistent grid over the points); the consumers take a
//     point's M samples in tiles of 64 rows (wgmma's M). The producer
//     warpgroup hands most of its registers to the consumers (setmaxnreg);
//     one of its threads streams the weights, its other three warps run
//     the terminal chain beside the products (terminal_warps);
//   * activations live in shared memory as bf16 images (hi, and lo under
//     bf16x3) of 64 x 512, in wgmma's core-matrix layout (K-major, no
//     swizzle), and are the A operand of every product; a layer's output
//     overwrites its input once the products that read it are done (the
//     accumulators stay in registers until then), so one activation buffer
//     serves the whole pass;
//   * the weights stream through a ring (4 stages of 32 KB under
//     "default", 4 of 16 KB under bf16x3: what the activations leave),
//     filled by the producer warp with cp.async.bulk and guarded by
//     mbarriers (the consumers free a stage once per warp), in the order
//     the consumers take them. A stage is one wgmma group whose products
//     are fixed at compile time, so ptxas keeps them asynchronous: two k16
//     slabs of a 512-wide layer ("default"), the hi or the lo image of one
//     (bf16x3), or four k16 slabs of a narrow layer (two of a 128-wide
//     one under bf16x3). One group is in flight while the next is issued;
//   * the 512-wide products split their columns between the warpgroups
//     (m64n256 each, into two 64-float accumulators); the head and the x
//     columns of N_0^T (N = 128) split them as m64n64 halves; the gate S
//     (on warpgroup 0) and the encoder T (on warpgroup 1) run side by
//     side, m64n64, each passing the other's stages on;
//   * the backward pass needs each hidden layer's ELU'(z): kept in a global
//     scratch of each block's own (64 x 512 f32 a layer), written and read
//     by the same thread, as is the head's output;
//   * the terminal chain takes 4 lanes a draw (each lane a quarter of the
//     draw's quads, its mixture terms summed in registers; lane l is left
//     with the warp's sums of quad l): on the three terminal warps in two
//     passes over the draw (its logits, then its gradient terms), or, for
//     the zero iterate, on the 256 consumers in one (the quads shifted into
//     registers, a transposing shuffle sum);
//   * the consumers' CUDA-core phases run as short rolled loops over all
//     256 threads: the responsibilities and the f rows take 4 lanes a row
//     (the head's output and the x columns of h0's gradient staged in
//     shared memory); the mixture's variances are inverted once per block;
//   * sums over draws and rows run in a fixed order (deterministic).
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
// registers per thread after setmaxnreg: the producer warpgroup (the
// weights' producer and the terminal chain's three warps) gives the rest of
// its share to the consumers. What the producer frees must cover what the
// consumers take from the 168 a thread launches with: 128 (168 - 40) =
// 256 (232 - 168); an increase the pool cannot cover never returns
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int TERM_WARPS = 3;              // the producer warpgroup's others
constexpr int TERM_THREADS = 32 * TERM_WARPS;
constexpr int CH = 64;                   // the time net's channels
constexpr int HW = 512;                  // the hidden width covered
constexpr int ACT_COLS = 512;            // columns of the activation buffer
constexpr int ACT_IMAGE = TILE * ACT_COLS * 2;  // one bf16 image: 64 KB
// a ring stage, one wgmma group: 32 KB under "default", 16 KB under bf16x3
__host__ __device__ constexpr int stage_bytes(bool x3) {
  return x3 ? 16384 : 32768;
}
constexpr int MIN_STAGES = 2, MAX_STAGES = 8;
constexpr int MAX_NX = 128;
constexpr int NACC = 64;                 // accumulator floats: m64n128
constexpr int LANE_QUADS = MAX_NX / 16;  // quads a lane of 4 takes
constexpr int NROWS = 7;                 // per-row arrays of a tile
constexpr float PIS_ST_FLOOR = 1e-6f;    // estimators._ST_FLOOR
constexpr size_t SMEM_LIMIT = 232448;
constexpr int MODE_BF16X3 = 1, MODE_ONE_PASS = 2;
constexpr int ERR_NO_PLAN = 10001, ERR_BAD_MODE = 10003, ERR_GRID = 10004;
// how a product's columns go to the warpgroups
constexpr int GATE = 0;  // N = 64: m64n64 on warpgroup 0
constexpr int HALF = 1;  // N = 128: m64n64, warpgroup wg rows 64 wg ..
constexpr int WIDE = 2;  // N = 512: m64n256, rows 256 wg ..

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }
__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// The products of a tile in the order the consumers take them (the order
// of ops/kernels.py:pis_layer_shapes): (N, K) of layer i of 3 L + 5, N the
// B operand's rows in the packed images (output columns, padded to 128 or
// 512), K its depth (padded to 16).
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

// The layer the ring streams o-th in a tile: the gate S and the encoder T
// interleaved (S_0, T_0, S_1, T_1, S_2 .. S_L), as warpgroups 0 and 1 take
// them side by side, then the packed order.
__host__ __device__ inline int ring_layer(int o, int L) {
  if (o >= L + 3) return o;
  if (o < 4) return (o & 1) ? L + 1 + (o >> 1) : o >> 1;
  return o - 2;
}

// byte offset of layer i in the packed images
__host__ __device__ inline size_t layer_offset(int i, int L, int nx) {
  size_t off = 0;
  for (int j = 0; j < i; ++j) {
    int N, K;
    layer_nk(j, L, nx, &N, &K);
    off += (size_t)2 * N * K * 2;
  }
  return off;
}

// the rows of layer i's B images that reach the ring: the gate's and the
// encoder's 64 outputs of their 128 padded rows, every row of the others
__host__ __device__ inline int layer_rows(int i, int L, int N) {
  return i <= L + 2 ? CH : N;
}

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

// How a layer whose B images have R rows (layer_rows) fills the ring: a
// stage holds the hi images of two 512-row k16 slabs ("default"), or the
// hi or the lo image of one (bf16x3: `halves`, two stages a slab), or 4
// slabs of a 64- or 128-row layer (2 of a 128-row layer under bf16x3), hi
// and lo. The narrow layers' K / 16 (4, 8 or 32) are multiples of theirs;
// a 512-row layer of odd K / 16 ("default") ends on a stage whose second
// slab is the next layer's first, against zero columns of A. So a stage's
// products are a fixed set, known when the kernel is compiled.
__host__ __device__ constexpr int stage_slabs(int R, bool x3) {
  return R == HW ? (x3 ? 1 : 2) : (x3 && R == 128) ? 2 : 4;
}
__host__ __device__ constexpr bool stage_halves(int R, bool x3) {
  return x3 && R == HW;
}
__host__ __device__ inline int layer_stages(int R, int K, bool x3) {
  const int spc = stage_slabs(R, x3);
  return stage_halves(R, x3) ? 2 * (K / 16) : (K / 16 + spc - 1) / spc;
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
  size_t act, ring, dw, xrow, gmm, rows, resp, tred, bars, total;
};

__host__ __device__ inline Plan make_plan(int nx, int ncomp, int has_net,
                                          bool x3, int stages) {
  Plan p;
  p.stages = stages;
  size_t o = 0;
  p.act = o;
  if (has_net) o += (size_t)(x3 ? 2 : 1) * ACT_IMAGE;
  p.ring = o;
  if (has_net) o += (size_t)stages * stage_bytes(x3);
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
  p.tred = o;
  o += has_net ? align16((size_t)TERM_WARPS * (1 + nx) * 4) : 0;
  p.bars = o;
  o += (size_t)2 * MAX_STAGES * 8;
  p.total = o;
  return p;
}

// the largest ring of MIN_STAGES..MAX_STAGES stages that fits; stages =
// -1 if none
inline Plan choose_plan(int nx, int ncomp, int has_net, bool x3) {
  for (int st = MAX_STAGES; st >= MIN_STAGES; --st) {
    const Plan p = make_plan(nx, ncomp, has_net, x3, st);
    if (p.total <= SMEM_LIMIT) return p;
  }
  Plan bad = make_plan(nx, ncomp, has_net, x3, 0);
  bad.stages = -1;
  return bad;
}

// floats of global scratch a block keeps: the head and L layers' ELU'(z)
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

// an A image at byte `a` (64 rows, K-major, 8 KB between core rows) and a
// B image at byte `b` (K-major slab rows, 256 B between core rows)
__device__ __forceinline__ uint64_t desc_a(uint32_t a) {
  return gmma_desc(a, 128, ACT_COLS * 16);
}
__device__ __forceinline__ uint64_t desc_b(uint32_t b) {
  return gmma_desc(b, 128, 256);
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
template <int NV>
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// (d0 | d1) (64 x 256 f32: d0 columns 0..127, d1 128..255) += A (64 x 16
// bf16, shared memory at desc_a) B^T (B: 256 x 16 bf16, shared memory at
// desc_b), both K-major
__device__ __forceinline__ void wgmma_n256(float (&d0)[NACC],
                                           float (&d1)[NACC], uint64_t da,
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
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d0[32]), "+f"(d0[33]), "+f"(d0[34]), "+f"(d0[35]),
        "+f"(d0[36]), "+f"(d0[37]), "+f"(d0[38]), "+f"(d0[39]),
        "+f"(d0[40]), "+f"(d0[41]), "+f"(d0[42]), "+f"(d0[43]),
        "+f"(d0[44]), "+f"(d0[45]), "+f"(d0[46]), "+f"(d0[47]),
        "+f"(d0[48]), "+f"(d0[49]), "+f"(d0[50]), "+f"(d0[51]),
        "+f"(d0[52]), "+f"(d0[53]), "+f"(d0[54]), "+f"(d0[55]),
        "+f"(d0[56]), "+f"(d0[57]), "+f"(d0[58]), "+f"(d0[59]),
        "+f"(d0[60]), "+f"(d0[61]), "+f"(d0[62]), "+f"(d0[63]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31]),
        "+f"(d1[32]), "+f"(d1[33]), "+f"(d1[34]), "+f"(d1[35]),
        "+f"(d1[36]), "+f"(d1[37]), "+f"(d1[38]), "+f"(d1[39]),
        "+f"(d1[40]), "+f"(d1[41]), "+f"(d1[42]), "+f"(d1[43]),
        "+f"(d1[44]), "+f"(d1[45]), "+f"(d1[46]), "+f"(d1[47]),
        "+f"(d1[48]), "+f"(d1[49]), "+f"(d1[50]), "+f"(d1[51]),
        "+f"(d1[52]), "+f"(d1[53]), "+f"(d1[54]), "+f"(d1[55]),
        "+f"(d1[56]), "+f"(d1[57]), "+f"(d1[58]), "+f"(d1[59]),
        "+f"(d1[60]), "+f"(d1[61]), "+f"(d1[62]), "+f"(d1[63])
      : "l"(da), "l"(db), "r"(1));
}

// d[0 .. 32) (64 x 64 f32) += A (64 x 16) B^T (B: 64 x 16)
__device__ __forceinline__ void wgmma_n64(float (&d)[NACC], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// ---- layouts ------------------------------------------------------------

// Accumulator element i of a warpgroup thread (warp w in the group, lane
// 4 g + t) holds row 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) +
// 2 t + (i & 1) of its m64nN tile.
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

// ---- the ring of weight stages ------------------------------------------

struct Ring {
  uint32_t base, full, empty;
  int stages, it, stage_bytes;

  __device__ __forceinline__ uint32_t acquire() {
    const int st = it % stages;
    mbar_wait(full + 8 * st, (uint32_t)((it / stages) & 1));
    ++it;
    return base + (uint32_t)(st * stage_bytes);
  }
  // once per warp (lane 0), after the warp's last read of the stage
  __device__ __forceinline__ void release(int n) {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * (n % stages));
  }
};

// acc += A (at desc da) B^T (at desc db): m64n256 into (a0 | a1) for WIDE,
// else m64n64 into a0
template <int KIND>
__device__ __forceinline__ void mma(float (&a0)[NACC], float (&a1)[NACC],
                                    uint64_t da, uint64_t db) {
  if (KIND == WIDE) wgmma_n256(a0, a1, da, db);
  else wgmma_n64(a0, da, db);
}

// The products of one stage: A's SPC k16 slabs from byte a with this
// warpgroup's rows of the stage's B images from byte b: PART 0 hi*hi (and
// lo*hi under bf16x3), PART 1 hi*lo (B's lo image at b), PART 2 all of
// them (B's lo image IMG bytes after its hi image)
template <bool X3, int KIND, int PART, int SPC>
__device__ __forceinline__ void stage_mma(float (&a0)[NACC],
                                          float (&a1)[NACC], uint32_t a,
                                          uint32_t b) {
  constexpr int R = KIND == GATE ? CH : KIND == HALF ? 128 : HW;
  constexpr uint32_t IMG = R * 32, SB = IMG * (X3 ? 2 : 1);
#pragma unroll
  for (int s = 0; s < SPC; ++s) {
    const uint32_t as = a + s * 256, bs = b + s * SB;
    if (PART != 1) {
      mma<KIND>(a0, a1, desc_a(as), desc_b(bs));
      if (X3) mma<KIND>(a0, a1, desc_a(as + ACT_IMAGE), desc_b(bs));
    }
    if (X3 && PART == 1) mma<KIND>(a0, a1, desc_a(as), desc_b(bs));
    if (X3 && PART == 2) mma<KIND>(a0, a1, desc_a(as), desc_b(bs + IMG));
  }
}

// One layer's products: acc (a0, and a1 for WIDE) = A[:, in_col .. +K)
// times this warpgroup's rows of the layer's B (K x N), stage by stage.
// Every consumer takes and frees every stage; a warpgroup with USE false
// (warpgroup 1 on the GATE layers) only passes them on. One wgmma group
// per stage, one in flight while the next is issued; what a group issues
// is fixed at compile time, so ptxas keeps the wgmma asynchronous.
template <bool X3, int KIND, bool USE, bool SYNC = true>
__device__ __forceinline__ void layer_mma(float (&a0)[NACC],
                                          float (&a1)[NACC], uint32_t act,
                                          int in_col, int K, int wg,
                                          Ring& ring) {
  constexpr int NV = KIND == WIDE ? NACC : NACC / 2;
  constexpr int R = KIND == GATE ? CH : KIND == HALF ? 128 : HW;
  constexpr int SPC = stage_slabs(R, X3);
  constexpr bool HALVES = stage_halves(R, X3);
  const int nst = layer_stages(R, K, X3);
  int freed = ring.it;
  if (!USE) {
    for (int c = 0; c < nst; ++c) {
      ring.acquire();
      ring.release(freed++);
    }
    consumers_sync();
    return;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) a0[i] = 0.0f;
  if (KIND == WIDE) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) a1[i] = 0.0f;
  }
  const uint32_t rows =
      (uint32_t)((KIND == WIDE ? 32 * wg : KIND == HALF ? 8 * wg : 0) * 256);
  for (int c = 0; c < nst; c += HALVES ? 2 : 1) {
    const int s0 = HALVES ? c >> 1 : c * SPC;
    const uint32_t a = act + (uint32_t)((in_col / 8 + 2 * s0) * 128);
    {
      const uint32_t stage = ring.acquire();
      fence_acc<NV>(a0);
      if (KIND == WIDE) fence_acc<NACC>(a1);
      wgmma_fence();
      stage_mma<X3, KIND, HALVES ? 0 : 2, SPC>(a0, a1, a, stage + rows);
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();
        fence_acc<NV>(a0);
        if (KIND == WIDE) fence_acc<NACC>(a1);
        ring.release(freed++);
      }
    }
    if (HALVES) {  // the slab's lo image
      const uint32_t stage = ring.acquire();
      fence_acc<NV>(a0);
      if (KIND == WIDE) fence_acc<NACC>(a1);
      wgmma_fence();
      stage_mma<X3, KIND, 1, 1>(a0, a1, a, stage + rows);
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc<NV>(a0);
      if (KIND == WIDE) fence_acc<NACC>(a1);
      ring.release(freed++);
    }
  }
  wgmma_wait<0>();
  fence_acc<NV>(a0);
  if (KIND == WIDE) fence_acc<NACC>(a1);
  ring.release(freed++);
  // every product has read the input: it may be written (within one
  // warpgroup, its own wait suffices)
  if (SYNC) consumers_sync();
}

// A warpgroup's pass over n stages that the other one takes
__device__ __forceinline__ void pass_stages(Ring& ring, int n) {
  for (int c = 0; c < n; ++c) {
    const int it = ring.it;
    ring.acquire();
    ring.release(it);
  }
}

// the 128 threads of warpgroup wg (named barriers 3, 4)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(3 + wg), "n"(WG_THREADS)
               : "memory");
}

// named barrier 2: warpgroup 0 has read the embedding (arrive), warpgroup
// 1 may overwrite it (sync)
__device__ __forceinline__ void embedding_read() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(CONSUMERS) : "memory");
}
__device__ __forceinline__ void embedding_free() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// ---- the producer -------------------------------------------------------

// Every stage of every tile of this block's points, in the consumers'
// order (ring_layer, layer_stages). The packed images hold each slab's hi
// image (N x 16 bf16) then its lo image; a stage gets the first layer_rows
// of each.
__device__ __forceinline__ void produce(const Params& p, bool x3,
                                        uint32_t ring, uint32_t full,
                                        uint32_t empty) {
  const int ntile = (p.M + TILE - 1) / TILE;
  const int nl = n_layers(p.L);
  int it = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; ++kb) {
      for (int o = 0; o < nl; ++o) {
        const int li = ring_layer(o, p.L);
        const unsigned char* layer =
            reinterpret_cast<const unsigned char*>(p.img) +
            layer_offset(li, p.L, p.nx);
        int N, K;
        layer_nk(li, p.L, p.nx, &N, &K);
        const int nslab = K / 16, R = layer_rows(li, p.L, N);
        const uint32_t gimg = (uint32_t)N * 32, img = (uint32_t)R * 32;
        const int spc = stage_slabs(R, x3), nst = layer_stages(R, K, x3);
        for (int c = 0; c < nst; ++c, ++it) {
          const int st = it % p.stages, round = it / p.stages;
          if (round > 0)
            mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
          const uint32_t bar = full + 8 * st;
          const uint32_t dst = ring + (uint32_t)(st * stage_bytes(x3));
          if (stage_halves(R, x3)) {  // slab c / 2's hi image, or its lo
            mbar_expect_tx(bar, img);
            bulk_copy(dst, layer + (c >> 1) * 2 * gimg + (c & 1) * gimg, img,
                      bar);
            continue;
          }
          const uint32_t sb = img * (x3 ? 2 : 1);
          mbar_expect_tx(bar, sb * spc);
          for (int s = 0; s < spc; ++s) {
            const unsigned char* src = layer + (c * spc + s) * 2 * gimg;
            bulk_copy(dst + s * sb, src, img, bar);
            if (x3) bulk_copy(dst + s * sb + img, src + gimg, img, bar);
          }
        }
      }
    }
}

// ---- the consumers' steps -----------------------------------------------

struct Rows {
  float *sig, *iys, *lam, *decay, *sigma, *c_i, *c_iy;
};

__device__ __forceinline__ Rows carve_rows(unsigned char* smem,
                                           const Plan& pl) {
  float* r = reinterpret_cast<float*>(smem + pl.rows);
  Rows w;
  float** f[NROWS] = {&w.sig, &w.iys, &w.lam, &w.decay, &w.sigma, &w.c_i,
                      &w.c_iy};
#pragma unroll
  for (int i = 0; i < NROWS; ++i) *f[i] = r + i * TILE;
  return w;
}

// X_s = x + sqrt(s - t) sqrt(a) dWi, its factors rounded as the plain
// version's
__device__ __forceinline__ float xs_of(const float* xrow, const Rows& r,
                                       const float* dw, int nx, int row,
                                       int j) {
  return __fadd_rn(xrow[j], __fmul_rn(r.sig[row], dw[row * nx + j]));
}

// v (32 values: 8 quads of 4) summed over the 8 lanes of a warp that share
// lane & 3, transposed: lane l is left with the sums of v's quad l >> 2,
// i.e. of the warp's quad l (4 values) where lane 4 i + r holds quads
// r + 4 m in v[4 m ..]. Fixed order: deterministic.
__device__ __forceinline__ void transpose_sum(const float (&v)[4 * LANE_QUADS],
                                              float (&out)[4], int lane) {
  float s16[16], s8[8];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float mine = b4 ? v[16 + i] : v[i];
    const float other = b4 ? v[i] : v[16 + i];
    s16[i] = mine + __shfl_xor_sync(0xffffffffu, other, 16);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float mine = b3 ? s16[8 + i] : s16[i];
    const float other = b3 ? s16[i] : s16[8 + i];
    s8[i] = mine + __shfl_xor_sync(0xffffffffu, other, 8);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float mine = b2 ? s8[4 + i] : s8[i];
    const float other = b2 ? s8[i] : s8[4 + i];
    out[i] = mine + __shfl_xor_sync(0xffffffffu, other, 4);
  }
}

// Bias (and ELU, saving ELU'(z)) of an m64nNV/2 accumulator, written to
// the activation images at out_col. This thread's biases (bias_t = bias +
// 2 t) and saves sit at fixed offsets from one base each.
template <bool X3, bool ACT, int NV>
__device__ __forceinline__ void epilogue(float (&acc)[NACC],
                                         unsigned char* act,
                                         const float* bias_t, int out_col,
                                         int w, int g, int t, float2* save) {
#pragma unroll
  for (int q = 0; q < NV / 2; ++q) {
    const int i = 2 * q;
    const float* b = bias_t + 8 * (q >> 1);
    float d0 = 1.0f, d1 = 1.0f;
    float v0 = acc[i] + __ldg(b), v1 = acc[i + 1] + __ldg(b + 1);
    if (ACT) {
      v0 = elu(v0, &d0);
      v1 = elu(v1, &d1);
    }
    put_pair<X3>(act, acc_row(i, w, g), out_col + acc_col(i, t), v0, v1);
    if (save) save[q * CONSUMERS] = make_float2(d0, d1);
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

// Named barriers 5 and 6 between the terminal warps and the consumers:
// a point's terminal sums are in tred (5), and read (6).
constexpr int BAR_TERM_FULL = 5, BAR_TERM_FREE = 6;
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id),
               "n"(CONSUMERS + TERM_THREADS)
               : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(CONSUMERS + TERM_THREADS)
               : "memory");
}

// The terminal chain of the points of this block, on the producer
// warpgroup's three warps, beside the consumers' products (with a net;
// the zero iterate's consumers run it themselves). 4 lanes a draw, 24
// draws a round, 3 rounds a tile; two passes over a draw's quads: its
// mixture logits, then diff x its normals, summed over the warp's 8
// draws per quad (lane l keeps quad l). At a point's end the three warps'
// sums go to tred for the consumers, in a fixed order.
__device__ __forceinline__ void terminal_warps(const Params& p,
                                               const Gmm& gmix, float* tred,
                                               int wt) {
  const int nx = p.nx, Q = (nx + 3) / 4, r4 = wt & 3, lane = wt & 31;
  const int tw = wt >> 5, ntile = (p.M + TILE - 1) / TILE;
  bool first = true;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
    const float t0 = p.t[b], g0 = p.g0[b];
    const float cT = sqrtf(fmaxf(p.T - t0, 1e-6f)) * p.alpha_sqrt;
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    const float* x = p.x + (size_t)b * nx;
    float acc_t[4] = {0.0f, 0.0f, 0.0f, 0.0f}, acc_tv = 0.0f;
    for (int kb = 0; kb < ntile; ++kb)
      for (int d0 = 0; d0 < TILE; d0 += TERM_THREADS / 4) {
        const int dl = d0 + (wt >> 2), k = kb * TILE + dl;
        const bool live = dl < TILE && k < p.M;
        const float* row = p.noise_t ? p.noise_t + ((size_t)b * p.M + k) * nx
                                     : nullptr;
        // pass 1: the draw's logits
        float part[GMM_MAX_COMPONENTS], lp[GMM_MAX_COMPONENTS];
#pragma unroll
        for (int c = 0; c < GMM_MAX_COMPONENTS; ++c) part[c] = 0.0f;
#pragma unroll 1
        for (int m = 0; m < LANE_QUADS; ++m) {
          const int q = r4 + 4 * m;
          if (!live || q >= Q) continue;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (row) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (4 * q + e < nx) v[e] = row[4 * q + e];
          } else {
            normals4(k, q, STREAM_TERMINAL, p.seed_hi, key, v);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * q + e < nx)
              gmm_add(gmix, 4 * q + e,
                      __fadd_rn(__ldg(x + 4 * q + e), __fmul_rn(cT, v[e])),
                      part);
        }
        group_logits(gmix, part, lp);
        const float diff = live ? gmm_neg_log_prob(gmix, lp) - g0 : 0.0f;
        if (r4 == 0) acc_tv += diff;
        // pass 2: diff x the draw's normals, summed over the warp's draws
#pragma unroll 1
        for (int m = 0; m < LANE_QUADS; ++m) {
          const int q = r4 + 4 * m;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (live && q < Q) {
            if (row) {
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (4 * q + e < nx) v[e] = row[4 * q + e];
            } else {
              normals4(k, q, STREAM_TERMINAL, p.seed_hi, key, v);
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (4 * q + e >= nx) v[e] = 0.0f;
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float w = diff * v[e];
            w += __shfl_xor_sync(0xffffffffu, w, 4);
            w += __shfl_xor_sync(0xffffffffu, w, 8);
            w += __shfl_xor_sync(0xffffffffu, w, 16);
            if ((lane >> 2) == m) acc_t[e] += w;
          }
        }
      }
    // the point's sums to tred once the consumers have read the last ones
    if (!first) bar_sync(BAR_TERM_FREE);
    first = false;
    acc_tv = warp_sum(acc_tv);
    float* out = tred + tw * (1 + nx);
    if (lane == 0) out[0] = acc_tv;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * lane + e < nx) out[1 + 4 * lane + e] = acc_t[e];
    bar_arrive(BAR_TERM_FULL);
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
  const uint32_t full = smem_u32(smem + pl.bars);
  const uint32_t empty = full + 8 * MAX_STAGES;

  // the mixture, once per block, its variances inverted
  const int nkx = p.ncomp * nx, ng = 2 * nkx + 2 * p.ncomp;
  for (int e = threadIdx.x; e < ng; e += THREADS)
    gm[e] = e >= nkx && e < 2 * nkx ? 1.0f / p.gmm[e] : p.gmm[e];
  if (threadIdx.x == 0 && L > 0) {
    for (int st = 0; st < p.stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Gmm gmix{gm, gm + nkx, gm + 2 * nkx, gm + 2 * nkx + p.ncomp,
                 p.ncomp, nx};
  float* tred = reinterpret_cast<float*>(smem + pl.tred);
  if (threadIdx.x >= CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(PRODUCER_REGS));
    if (L > 0 && threadIdx.x == CONSUMERS)
      produce(p, X3, smem_u32(smem + pl.ring), full, empty);
    else if (L > 0 && threadIdx.x >= CONSUMERS + 32)
      terminal_warps(p, gmix, tred, threadIdx.x - CONSUMERS - 32);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               ::"n"(CONSUMER_REGS));

  const int ctid = threadIdx.x, warp = ctid >> 5, lane = ctid & 31;
  const int wg = ctid >> 7, w = warp & 3, g = lane >> 2, t = lane & 3;
  const int quad4 = ctid >> 2, r4 = ctid & 3;  // 4 lanes per draw or row
  Ring ring{smem_u32(smem + pl.ring), full, empty, p.stages, 0,
            stage_bytes(X3)};
  const uint32_t act_u = smem_u32(act);
  const VecLayout vl = vec_layout(L, nx);
  const int ntile = (p.M + TILE - 1) / TILE;
  const int Q = (nx + 3) / 4;
  const float inv_m = 1.0f / (float)p.M;
  // the depths of N_0 and the head^T in the packed images; their inputs'
  // columns are zero to a multiple of 32 (a last two-slab stage)
  const int k_h0 = pad16(CH + nx), k_cot = pad16(nx);
  const int z_h0 = (CH + nx + 31) / 32 * 32, z_cot = (nx + 31) / 32 * 32;
  // this block's scratch: the head's 16 pairs x 256 threads, then L x 2
  // chunks x 32 pairs x 256 threads of ELU'
  float* const scr_block =
      p.scratch + (size_t)blockIdx.x * scratch_floats_per_block(L);
  float2* scr_head = reinterpret_cast<float2*>(scr_block) + ctid;
  float2* scr = reinterpret_cast<float2*>(scr_block + TILE * 128);

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
      // ---- the zero iterate's terminal chain: draw kb TILE + ctid / 4,
      // 4 lanes each (with a net, the producer warpgroup's three warps)
      if (L == 0) {
        const int k = kb * TILE + quad4;
        const bool live = k < p.M;
        // the draw's quads r4 + 4 m, m < LANE_QUADS, shifted in one at a
        // time (a rolled loop, constant register indices): n[4 m + e]
        float n[4 * LANE_QUADS] = {}, part[GMM_MAX_COMPONENTS];
        float lp[GMM_MAX_COMPONENTS];
#pragma unroll
        for (int c = 0; c < GMM_MAX_COMPONENTS; ++c) part[c] = 0.0f;
#pragma unroll 1
        for (int m = 0; m < LANE_QUADS; ++m) {
          const int q = r4 + 4 * m;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (live && q < Q) {
            if (p.noise_t) {
              const float* row = p.noise_t + ((size_t)b * p.M + k) * nx;
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (4 * q + e < nx) v[e] = row[4 * q + e];
            } else {
              normals4(k, q, STREAM_TERMINAL, p.seed_hi, key, v);
            }
          }
#pragma unroll
          for (int i = 0; i < 4 * LANE_QUADS - 4; ++i) n[i] = n[i + 4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * q + e;
            if (j < nx) {
              gmm_add(gmix, j, __fadd_rn(xrow[j], __fmul_rn(cT, v[e])), part);
            } else {
              v[e] = 0.0f;
            }
            n[4 * LANE_QUADS - 4 + e] = v[e];
          }
        }
        group_logits(gmix, part, lp);
        const float diff = live ? gmm_neg_log_prob(gmix, lp) - g0 : 0.0f;
        if (r4 == 0) acc_tv += diff;
#pragma unroll
        for (int i = 0; i < 4 * LANE_QUADS; ++i) n[i] *= diff;
        float s[4];
        transpose_sum(n, s, lane);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc_t[e] += s[e];
      }
      if (L == 0) continue;  // f = f0: no integral term

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
      for (int e = ctid; e < TILE * CH / 2; e += CONSUMERS) {
        const int row = e / (CH / 2), c = 2 * (e - row * (CH / 2));
        float sv[2], cv[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float arg = __fadd_rn(
              __fmul_rn(__ldg(p.vec + vl.coeff + c + h), rw.lam[row]),
              __ldg(p.vec + vl.phase + c + h));
          sincosf(arg, &sv[h], &cv[h]);
        }
        put_pair<X3>(act, row, c, sv[0], sv[1]);
        put_pair<X3>(act, row, CH + c, cv[0], cv[1]);
      }
      // responsibilities of the mixture at e^{-lambda/2} X_s: row ctid / 4
      {
        const int row = quad4;
        const float dc = rw.decay[row];
        float part[GMM_MAX_COMPONENTS], lp[GMM_MAX_COMPONENTS];
#pragma unroll
        for (int k = 0; k < GMM_MAX_COMPONENTS; ++k) part[k] = 0.0f;
#pragma unroll 1
        for (int j = r4; j < nx; j += 4)
          gmm_add(gmix, j, dc * xs_of(xrow, rw, dw, nx, row, j), part);
        group_logits(gmix, part, lp);
        if (r4 == 0) gmm_resp(gmix, lp, resp + row * GMM_MAX_COMPONENTS);
      }
      fence_async_smem();
      consumers_sync();

      float a0[NACC], a1[NACC];
      // ---- the gate S (warpgroup 0) and the encoder T (warpgroup 1) ---
      // S_0: 128 -> 64 at columns 448.., S_1 .. S_L in place, ELU, then
      // sigma; T_0: 128 -> 64 (ELU) at columns 384.., T_1: 64 -> 64 at
      // 0.. once S_0 has read e, and X_s at 64 ..: h0 = [T_enc(e), X_s, 0].
      // Each passes the other's stages on (ring_layer's order).
      const int s_col = 448, t_col = 384;
      if (wg == 0) {
        for (int l = 0; l <= L; ++l) {
          const int K = l == 0 ? 2 * CH : CH;
          layer_mma<X3, GATE, true, false>(a0, a1, act_u,
                                           l == 0 ? 0 : s_col, K, wg, ring);
          if (l == 0) embedding_read();
          if (l < L) {
            epilogue<X3, true, NACC / 2>(a0, act,
                                         p.vec + vl.s_bias + l * CH + 2 * t,
                                         s_col, w, g, t, nullptr);
          } else {
            // ELU, then the head's column 0 with _split3's products
            const float* hw = p.vec + vl.s_head;
            const float* bias = p.vec + vl.s_bias + l * CH;
            float sr[2] = {0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < NACC / 2; ++i) {
              const int col = acc_col(i, t);
              float dd;
              const float h = elu(a0[i] + __ldg(bias + col), &dd);
              const float wv = __ldg(hw + col);
              const float wh = bf16_round(wv), hh = bf16_round(h);
              float term = hh * wh;
              if (X3) term += bf16_round(h - hh) * wh +
                              hh * bf16_round(wv - wh);
              sr[(i >> 1) & 1] += term;
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
          fence_async_smem();
          wg_sync(0);
          if (l < 2) pass_stages(ring, layer_stages(CH, l == 0 ? 2 * CH : CH,
                                                     X3));
        }
      } else {
        for (int l = 0; l < 2; ++l) {
          const int K = l == 0 ? 2 * CH : CH;
          pass_stages(ring, layer_stages(CH, K, X3));  // S_l
          layer_mma<X3, GATE, true, false>(a0, a1, act_u,
                                           l == 0 ? 0 : t_col, K, wg, ring);
          if (l == 0) {
            epilogue<X3, true, NACC / 2>(a0, act, p.vec + vl.t_bias + 2 * t,
                                         t_col, w, g, t, nullptr);
            fence_async_smem();
            wg_sync(1);
          } else {
            embedding_free();
            epilogue<X3, false, NACC / 2>(a0, act,
                                          p.vec + vl.t_bias + CH + 2 * t, 0,
                                          w, g, t, nullptr);
            const int half = (z_h0 - CH) / 2;
            for (int e = ctid - WG_THREADS; e < TILE * half; e += WG_THREADS) {
              const int row = e / half, j = 2 * (e - row * half);
              const float v0 =
                  j < nx ? xs_of(xrow, rw, dw, nx, row, j) : 0.0f;
              const float v1 =
                  j + 1 < nx ? xs_of(xrow, rw, dw, nx, row, j + 1) : 0.0f;
              put_pair<X3>(act, row, CH + j, v0, v1);
            }
          }
        }
        for (int l = 2; l <= L; ++l)
          pass_stages(ring, layer_stages(CH, CH, X3));
      }
      fence_async_smem();
      consumers_sync();

      // ---- N forward: L layers of 512 with ELU (ELU' saved), the head ---
      for (int l = 0; l < L; ++l) {
        layer_mma<X3, WIDE, true>(a0, a1, act_u, 0, l == 0 ? k_h0 : HW, wg,
                                  ring);
        float2* sv = scr + (size_t)(l * 2) * 32 * CONSUMERS + ctid;
        const float* bias = p.vec + vl.n_bias + l * HW + 256 * wg + 2 * t;
        epilogue<X3, true, NACC>(a0, act, bias, 256 * wg, w, g, t, sv);
        epilogue<X3, true, NACC>(a1, act, bias + 128, 256 * wg + 128, w, g, t,
                                 sv + 32 * CONSUMERS);
        fence_async_smem();
        consumers_sync();
      }
      // the head, columns 64 wg .. of each warpgroup: N(h0), kept for w
      layer_mma<X3, HALF, true>(a0, a1, act_u, 0, HW, wg, ring);
#pragma unroll
      for (int q = 0; q < NACC / 4; ++q) {
        const int i = 2 * q, col = 64 * wg + acc_col(i, t);
        float2 v = make_float2(0.0f, 0.0f);
        if (col < nx) v.x = a0[i] + __ldg(p.vec + vl.h_bias + col);
        if (col + 1 < nx) v.y = a0[i + 1] + __ldg(p.vec + vl.h_bias + col + 1);
        scr_head[(size_t)q * CONSUMERS] = v;
      }
      // the cotangent sigma X_s at columns 0 .. nx, zero to z_cot
      for (int e = ctid; e < TILE * (z_cot / 2); e += CONSUMERS) {
        const int row = e / (z_cot / 2), j = 2 * (e - row * (z_cot / 2));
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
        layer_mma<X3, WIDE, true>(a0, a1, act_u, 0, l == L - 1 ? k_cot : HW,
                                  wg, ring);
        const float2* sv = scr + (size_t)(l * 2) * 32 * CONSUMERS + ctid;
        epilogue_bwd<X3>(a0, act, 256 * wg, w, g, t, sv, CONSUMERS);
        epilogue_bwd<X3>(a1, act, 256 * wg + 128, w, g, t,
                         sv + (size_t)32 * CONSUMERS, CONSUMERS);
        fence_async_smem();
        consumers_sync();
      }
      // the x columns of h0's gradient, columns 64 wg .. of each
      // warpgroup; they and the head's output N(h0) into shared memory
      // (the activations are read), [row][col] f32 with stride nx
      layer_mma<X3, HALF, true>(a0, a1, act_u, 0, HW, wg, ring);
      float* sm_grad = reinterpret_cast<float*>(act);
      float* sm_head = sm_grad + TILE * nx;
#pragma unroll
      for (int q = 0; q < NACC / 4; ++q) {
        const float2 no = scr_head[(size_t)q * CONSUMERS];
        const int i = 2 * q, row = acc_row(i, w, g);
        const int col = 64 * wg + acc_col(i, t);
        if (col < nx) {
          sm_grad[row * nx + col] = a0[i];
          sm_head[row * nx + col] = no.x;
        }
        if (col + 1 < nx) {
          sm_grad[row * nx + col + 1] = a0[i + 1];
          sm_head[row * nx + col + 1] = no.y;
        }
      }
      consumers_sync();

      // ---- w and f per row (4 lanes a row); the rows' weights ----------
      {
        const int row = quad4;
        const float sg = rw.sigma[row], dc = rw.decay[row];
        float rk[GMM_MAX_COMPONENTS];
#pragma unroll
        for (int k = 0; k < GMM_MAX_COMPONENTS; ++k)
          rk[k] = k < p.ncomp ? resp[row * GMM_MAX_COMPONENTS + k] : 0.0f;
        float dr = 0.0f, qr = 0.0f;
#pragma unroll 1
        for (int j = r4; j < nx; j += 4) {
          const float xs = xs_of(xrow, rw, dw, nx, row, j);
          const float gres = gmm_grad(gmix, rk, dc * xs, j);
          const float wv = sg * sm_head[row * nx + j] + sm_grad[row * nx + j] +
                           (1.0f - sg) * (dc * gres);
          dr += (p.theta * (p.mu - xs)) * wv;
          qr += wv * wv;
        }
        dr += __shfl_xor_sync(0xffffffffu, dr, 1);
        dr += __shfl_xor_sync(0xffffffffu, dr, 2);
        qr += __shfl_xor_sync(0xffffffffu, qr, 1);
        qr += __shfl_xor_sync(0xffffffffu, qr, 2);
        if (r4 == 0) {
          const bool valid = kb * TILE + row < p.M;
          const float f = -dr - p.half_alpha * qr - p.nx_theta;
          const float di = valid ? Tt * (f - f0) : 0.0f;
          rw.c_i[row] = di;
          rw.c_iy[row] = di * rw.iys[row];
        }
      }
      consumers_sync();
      // the integral sums, in row order
      if (ctid == 0) {
        for (int row = 0; row < TILE; ++row) acc_i += rw.c_i[row];
      } else if (ctid <= nx) {
        for (int row = 0; row < TILE; ++row)
          acc_i = fmaf(rw.c_iy[row], dw[row * nx + ctid - 1], acc_i);
      }
      consumers_sync();
    }

    // the terminal sums of the 8 consumer warps (zero iterate) or of the 3
    // terminal warps, added in a fixed order
    float sum_t = 0.0f;
    if (L == 0) {
      acc_tv = warp_sum(acc_tv);
      if (lane == 0) red[warp * (1 + nx)] = acc_tv;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (4 * lane + r < nx)
          red[warp * (1 + nx) + 1 + 4 * lane + r] = acc_t[r];
      consumers_sync();
      if (ctid <= nx)
        for (int v = 0; v < CONSUMERS / 32; ++v)
          sum_t += red[v * (1 + nx) + ctid];
    } else {
      bar_sync(BAR_TERM_FULL);
      if (ctid <= nx)
        for (int v = 0; v < TERM_WARPS; ++v)
          sum_t += tred[v * (1 + nx) + ctid];
      if (b + (int)gridDim.x < p.B) bar_arrive(BAR_TERM_FREE);
    }
    if (ctid <= nx)
      p.out[(size_t)b * (1 + nx) + ctid] =
          ctid == 0 ? (sum_t + acc_i) * inv_m + g0 + f0 * Tt
                    : (sum_t * inv_yT + acc_i) * inv_m;
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
