// The frozen value network's forward and backward pass on Hopper's tensor
// cores, and the block layout around it, shared by the integral-chain
// kernels: generate.cu (the merged estimator) and integral.cu (the
// integral estimator alone). The counterpart of the TPU kernels' in-kernel
// net dots under pallas_kernels.py's mxu_precision: bf16x3_dot_general
// (_split3, _bf16x3_bwd), the one-pass DEFAULT and the six-pass HIGHEST.
//
// Precision: a pass count P. Each f32 operand a is split into bf16 pieces,
// a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1), as many as P
// needs, and a product is a sum of piece products, each one wgmma into an
// f32 accumulator:
//   P = 1 ("default"):  a0 b0;
//   P = 3 ("bf16x3"):   a0 b0 + a1 b0 + a0 b1 (_split3);
//   P = 6 ("highest"):  a0 b0 + a0 b1 + a1 b0 + a0 b2 + a1 b1 + a2 b0, the
//                       MXU's six-pass f32 product: the terms it leaves out
//                       are below f32's rounding; a0 b0 and the five
//                       smaller products in two accumulators, joined in f32
//                       (the tensor cores cut each wgmma's sum toward zero).
// bf16 products are exact in f32, so a result differs from the plain
// version's in the same mode only in the order of the f32 sums. ELU, its
// derivative, the biases, the head (H -> 1) and the contraction of the
// first layer's gradient with W1's column sums stay in f32, the head and
// that contraction with the same piece products as the dots (P = 6: plain
// f32).
//
// Block: a producer warpgroup and two consumer warpgroups, each consumer
// warpgroup on its own tile of TILE = 64 samples (wgmma's M), both reading
// every weight stage. Warp 0 of the producer warpgroup stages the weights
// (produce); its other three warps carry a chain of their own (generate.cu:
// the terminal chain; integral.cu: the draws of the next tile pair). The
// pass (net_pass: integral.cu's; generate.cu keeps its own, net_pass_narrow)
// issues each K-slab of a layer as one group of m64n128k16 products, with
// A (activations forward, gradients backward) split into bf16 pieces in
// registers and B (the weights) from shared memory; the accumulator is
// kept as its two 64-column halves. The epilogues (bias and ELU, or the
// ELU derivative backward) work in place on each half, so a layer's
// output stays in registers; the next layer splits it into its A
// fragments. (Two m64n64 groups a layer, one per half, with the first
// half's epilogue beside the second half's products, ran 9 % slower in
// bf16x3 and 6 % in highest: PERF.md §6.) ptxas rules that shape the
// code: it serialises every wgmma of a kernel (one WARPGROUP.DEPBAR an
// HGMMA) where an instruction
// between a group's issue and its wait writes an A fragment (the next
// layer's split waits for the wait), or where a runtime branch can reach a
// wgmma (what a ring stage issues is fixed at compile time), or where the
// fragments and accumulators leave it too few registers (P = 6 takes one
// K-slab at a time: 48 registers of fragments instead of 96). The ELU
// derivative of each hidden layer but the last is kept (f32, one float2
// per thread and pair of columns) for the backward pass, in shared memory
// where the plan fits it and else in a global scratch of the block's own.
//
// Weights are staged, not streamed per warp: the producer copies slabs of
// 128 x 64 bf16 (one image per piece of W that the mode reads) with
// cp.async.bulk into a ring of stages guarded by mbarriers (full: bytes
// landed; empty: both consumer warpgroups are done), in the order the
// consumers take them: layer 1 in K-slabs of 64 input columns (so nx does
// not bound shared memory), each hidden layer's two K-slabs forward, then
// its two K-slabs backward (rows of W). Each weight byte read from L2 serves
// two tiles of 64 samples. The packed images (ops/kernels.py:pack_mlp_tc)
// hold each W (out, in) as 8 x 8 core matrices, core (i, j) at (i * in / 8 +
// j) * 128 bytes: the forward pass reads a slab K-major (no swizzle: LBO
// 128 B along K, SBO 1024 B along N), the backward pass reads the same
// bytes of W as B transposed (MN-major: LBO 2048 B along K = out, SBO 128 B
// along N = in), so no W^T is stored; a 64-column half of the output is the
// same descriptor at another start.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"
#include "value_mlp.cuh"

namespace dpi {
namespace tc {

constexpr int TILE = 64;                 // samples per tile: wgmma's M
constexpr int CONSUMERS = 128;           // a warpgroup
constexpr int NWG = 2;                   // consumer warpgroups of a block
constexpr int TC_CONSUMERS = NWG * CONSUMERS;
constexpr int TC_THREADS = TC_CONSUMERS + CONSUMERS;  // and the producer's
constexpr int AUX_WARPS = 3;             // the producer warpgroup's others
constexpr int AUX_THREADS = 32 * AUX_WARPS;
// registers per thread after setmaxnreg (from the 168 a thread launches
// with): what the producer warpgroup frees covers what the consumers take,
// 128 (168 - 88) = 256 (208 - 168)
constexpr int PRODUCER_REGS = 88, CONSUMER_REGS = 208;
constexpr int NACC = H / 2;              // accumulator floats per thread
constexpr int HALF = NACC / 2;           // ... of a 64-column half
constexpr int KC = H / 16;               // k16 chunks of a hidden layer
constexpr int SLAB_K = 64;               // K-extent of a staged slab
constexpr int IMAGE_BYTES = H * SLAB_K * 2;  // one bf16 image of a slab
constexpr int MAX_STAGES = 4;
constexpr int SAVE_LAYER_FLOATS = TILE * H;  // one layer's elu'(z)
constexpr int NROWS = 7;                 // per-row arrays of a tile
constexpr int MAXJ = 4;                  // output slots per consumer
constexpr int TC_MAX_NX = MAXJ * CONSUMERS - 1;
constexpr size_t SMEM_LIMIT = 232448;
constexpr int MODE_BF16X3 = 1, MODE_ONE_PASS = 2, MODE_HIGHEST = 3;
// named barriers besides __syncthreads' 0: the 256 consumers, each
// consumer warpgroup's 128 (BAR_WG + wg), generate.cu's terminal sums
// handed to the consumers (FULL: written; FREE: read), the turns
// (BAR_TURN + wg)
constexpr int BAR_CONSUMERS = 1, BAR_WG = 2, BAR_TERM_FULL = 4,
              BAR_TERM_FREE = 5, BAR_TURN = 6;

// bf16 pieces of an operand under P passes (images of W staged per slab)
__host__ __device__ constexpr int pieces(int P) {
  return P == 6 ? 3 : P == 3 ? 2 : 1;
}
// bf16 pieces of each W packed (ops/kernels.py:pack_mlp_tc): hi and lo for
// the one- and three-pass modes, three for six
__host__ __device__ constexpr int packed(int P) { return P == 6 ? 3 : 2; }
__host__ __device__ constexpr int passes_of(int mode) {
  return mode == MODE_HIGHEST ? 6 : mode == MODE_BF16X3 ? 3 : 1;
}

// layer 1's K: 1 + nx padded to whole slabs (ops/kernels.py:tc_k1), so
// that every slab's products are the same instructions
__host__ __device__ inline int k1_of(int nx) {
  return (1 + nx + SLAB_K - 1) / SLAB_K * SLAB_K;
}

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// ---- the block's shared memory --------------------------------------------

// What a kernel keeps beside the ring: generate.cu (bufs = 1: each
// consumer warpgroup draws its own tile; term = 1: the terminal warps'
// sums), integral.cu (bufs = 2: the draw warps fill one tile pair's buffer
// while the consumers read the other; term = 0). ld: a tile row's floats
// of normals; stage_bytes: a ring stage (one image per piece of W staged);
// save_layer: floats of one layer's saved elu'(z) of a tile (TILE x the
// hidden width).
struct Layout {
  int bufs, term, ld, stage_bytes;
  int save_layer = SAVE_LAYER_FLOATS;
};

__host__ __device__ inline size_t dw_bytes(int ld) {
  return align16((size_t)TILE * ld * 4);
}

// Byte offsets of the dynamic shared memory; where the saved ELU
// derivatives (save_smem) and the tiles' normals (dw_smem) do not fit,
// they live in the block's global scratch.
struct GPlan {
  int stages, save_smem, dw_smem;
  size_t ring, save, dw, xrow, rows, tacc, tred, red, isum, sums, bars,
      total;
  size_t act = 0;  // generate.cu's width-256 instance: its tile images
};

__host__ __device__ inline GPlan gplan(int nx, int L, const Layout& k,
                                      int stages, int save_smem,
                                      int dw_smem) {
  GPlan p;
  p.stages = stages;
  p.save_smem = save_smem;
  p.dw_smem = dw_smem;
  size_t o = 0;
  p.ring = o;
  o += (size_t)stages * k.stage_bytes;
  p.save = o;
  if (save_smem && L > 1) o += (size_t)NWG * (L - 1) * k.save_layer * 4;
  p.dw = o;
  if (dw_smem) o += (size_t)k.bufs * NWG * dw_bytes(k.ld);
  p.xrow = o;
  o += (size_t)k.bufs * align16((size_t)nx * 4);
  p.rows = o;
  o += (size_t)k.bufs * NWG * NROWS * TILE * 4;
  p.tacc = o;
  if (k.term) o += (size_t)AUX_WARPS * align16((size_t)nx * 4);
  p.tred = o;
  if (k.term) o += align16((size_t)AUX_WARPS * (1 + nx) * 4);
  p.red = o;
  o += align16((size_t)(1 + nx) * 4);
  // term = 0: the consumers' integral sums (MAXJ a thread) between tiles
  p.sums = o;
  if (!k.term) o += (size_t)TC_CONSUMERS * MAXJ * 4;
  p.bars = o;
  // the ring's full and empty barriers, then (bufs = 2) the draw buffers'
  o += (size_t)2 * MAX_STAGES * 8 + (k.bufs > 1 ? 2 * 2 * 8 : 0);
  p.total = o;
  return p;
}

// The plan at (nx, L): the tiles' normals in shared memory where a ring of
// 2 stages fits beside them, the deepest ring of 2..MAX_STAGES stages, and
// the saved derivatives in shared memory where they fit beside that ring;
// stages = -1 where nothing fits (no ring without a net).
__host__ __device__ inline GPlan choose_gplan(int nx, int L,
                                             const Layout& k) {
  for (int dw = 1; dw >= 0; --dw) {
    if (L == 0) {
      const GPlan p = gplan(nx, 0, k, 0, 0, dw);
      if (p.total <= SMEM_LIMIT) return p;
      continue;
    }
    for (int st = MAX_STAGES; st >= 2; --st) {
      const GPlan p0 = gplan(nx, L, k, st, 0, dw);
      if (p0.total > SMEM_LIMIT) continue;
      const GPlan p1 = gplan(nx, L, k, st, 1, dw);
      return L > 1 && p1.total <= SMEM_LIMIT ? p1 : p0;
    }
  }
  GPlan bad = gplan(nx, L, k, 0, 0, 0);
  bad.stages = -1;
  return bad;
}

// floats of global scratch a block keeps: the consumers' saved derivatives
// (each warpgroup's L - 1 layers), then their tiles' normals, where they
// are not in shared memory
__host__ __device__ inline size_t scratch_floats(const GPlan& pl,
                                                 const Layout& k, int L) {
  size_t f = 0;
  if (!pl.save_smem && L > 1)
    f += (size_t)NWG * (L - 1) * k.save_layer;
  if (!pl.dw_smem) f += (size_t)k.bufs * NWG * TILE * k.ld;
  return f;
}

// Launch of both tensor-core kernels (g0 and noise_t: generate.cu only).
struct Params {
  const float* t;        // (B, 1)
  const float* x;        // (B, nx)
  const float* g0;       // (B, 1)  g(x), or null
  const float* f0;       // (B, 1)  get_f(t, x)
  const __nv_bfloat16* img;  // packed images (ops/kernels.py:pack_mlp_tc)
  const float* vec;      // biases, head row, W1 column sums, head bias
  const float* u01;      // (B, Md) or null: in-kernel draws
  const float* noise_t;  // (B, Md, nx) or null
  const float* noise_i;  // (B, Md, nx) or null
  float* scratch;        // the plan's global scratch per block, or null
  float* out;            // (B, 1 + nx)
  int B, M, nx, L, has_net, anti, mode;  // Md = anti ? M / 2 : M
  int Md, npair;         // rows of draws; tile pairs a point (integral.cu)
  int hw;                // the net's hidden width (generate.cu)
  Layout lay;            // the kernel's shared memory beside the ring
  GPlan plan;            // its offsets, computed on the host
  uint32_t seed_lo, seed_hi;
  float T, alpha_sqrt, k, c0;
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

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned; completion counted on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

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

// wgmma shared-memory matrix descriptor, no swizzle: start address, the
// byte offsets between core matrices along K (lbo) and along M/N (sbo)
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
template <int N>  // at most N groups still in flight
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accesses to an accumulator or to A
// fragments across wgmma.fence and the asynchronous products
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N, int NA>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][NA][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][j][r])::"memory");
}

// d0 | d1 (64 x 128, f32: columns 0-63 | 64-127) (+)= A (64 x 16 bf16,
// registers) B (16 x 128 bf16, shared memory at desc_b); ACC = 0 writes d
template <int TRANS_B, int ACC>
__device__ __forceinline__ void wgmma128(float (&d0)[HALF], float (&d1)[HALF],
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
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]),
        "+f"(d0[4]), "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]),
        "+f"(d0[8]), "+f"(d0[9]), "+f"(d0[10]), "+f"(d0[11]),
        "+f"(d0[12]), "+f"(d0[13]), "+f"(d0[14]), "+f"(d0[15]),
        "+f"(d0[16]), "+f"(d0[17]), "+f"(d0[18]), "+f"(d0[19]),
        "+f"(d0[20]), "+f"(d0[21]), "+f"(d0[22]), "+f"(d0[23]),
        "+f"(d0[24]), "+f"(d0[25]), "+f"(d0[26]), "+f"(d0[27]),
        "+f"(d0[28]), "+f"(d0[29]), "+f"(d0[30]), "+f"(d0[31]),
        "+f"(d1[0]), "+f"(d1[1]), "+f"(d1[2]), "+f"(d1[3]),
        "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]), "+f"(d1[7]),
        "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]), "+f"(d1[11]),
        "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]), "+f"(d1[15]),
        "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]), "+f"(d1[19]),
        "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]), "+f"(d1[23]),
        "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]), "+f"(d1[27]),
        "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]), "+f"(d1[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(ACC),
        "n"(TRANS_B));
}

// ---- the pass ---------------------------------------------------------

// a, b -> NA bf16 pieces each, packed in pairs (the lower column in the low
// half, as a wgmma A fragment holds them) into register r of f[piece]
template <int NA>
__device__ __forceinline__ void split_pair(float a, float b,
                                           uint32_t (&f)[NA][4], int r) {
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    f[k][r] = *reinterpret_cast<const uint32_t*>(&h);
    if (k + 1 < NA) {
      a -= __low2float(h);
      b -= __high2float(h);
    }
  }
}

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// Accumulator element i of a consumer thread (warp w, lane = 4 g + t) holds
// row 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 t + (i & 1) of
// its half (64 more in the second); A fragment register r of k-chunk kc
// holds the pair of elements 8 kc + 2 r, + 1 of the whole layout, so an
// activated accumulator is the next layer's A.
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// B of k-chunk kk of a staged slab, image img: all 128 output columns
template <int TRANS_B>
__device__ __forceinline__ uint64_t b_desc(uint32_t stage, int img, int kk) {
  const uint32_t b = stage + (uint32_t)(img * IMAGE_BYTES) +
                     (TRANS_B ? kk * 4096 : kk * 256);
  return gmma_desc(b, TRANS_B ? 2048 : 128, TRANS_B ? 128 : 1024);
}

// One k-chunk's piece products into d0 | d1 (ACC = 0: the first writes
// them); P = 6: the five smaller ones into c0 | c1. The tensor cores cut
// each sum a wgmma adds to its accumulator's precision, toward zero: six
// passes into one accumulator kept a third of bf16x3's error, the smaller
// products apart (2^-8 of its size) keep f32's (PERF.md §6). The mode is
// a template parameter: a branch between two wgmma makes ptxas wait for
// the first to finish.
template <int TRANS_B, int P, int ACC>
__device__ __forceinline__ void chunk_products(
    float (&d0)[HALF], float (&d1)[HALF], float (&c0)[HALF],
    float (&c1)[HALF], const uint32_t (&a)[pieces(P)][4], uint32_t stage,
    int kk) {
  const uint64_t b0 = b_desc<TRANS_B>(stage, 0, kk);
  wgmma128<TRANS_B, ACC>(d0, d1, a[0], b0);
  if constexpr (P == 3) {  // _split3's lo*hi, hi*lo
    wgmma128<TRANS_B, 1>(d0, d1, a[1], b0);
    wgmma128<TRANS_B, 1>(d0, d1, a[0], b_desc<TRANS_B>(stage, 1, kk));
  } else if constexpr (P == 6) {
    const uint64_t b1 = b_desc<TRANS_B>(stage, 1, kk);
    const uint64_t b2 = b_desc<TRANS_B>(stage, 2, kk);
    wgmma128<TRANS_B, ACC>(c0, c1, a[0], b1);
    wgmma128<TRANS_B, 1>(c0, c1, a[1], b0);
    wgmma128<TRANS_B, 1>(c0, c1, a[0], b2);
    wgmma128<TRANS_B, 1>(c0, c1, a[1], b1);
    wgmma128<TRANS_B, 1>(c0, c1, a[2], b0);
  }
}

// The consumers' view of the ring: slab `it` sits in stage it % stages.
struct Ring {
  uint32_t base, full, empty;
  int stages, stage_bytes, it;  // it: slabs taken

  // wait for the next slab; its stage's shared address
  __device__ __forceinline__ uint32_t acquire() {
    const int st = it % stages;
    mbar_wait(full + 8 * st, (uint32_t)((it / stages) & 1));
    ++it;
    return base + (uint32_t)(st * stage_bytes);
  }
  // slab n's products are done: its stage may be refilled
  __device__ __forceinline__ void release_slab(int n) {
    mbar_arrive(empty + 8 * (n % stages));
  }
};

// The tile's arrays (rows: TILE floats each).
struct Tile {
  float* dw;     // TILE x ld  integral normals
  float* xrow;   // nx         the point's x
  float* s_val;  // s
  float* sig;    // sqrt(s - t) sqrt(a)
  float* iys;    // 1 / (sqrt(max(s - t, floor)) sqrt(a))
  float* c_i;    // Tt (f - f0)
  float* c_iy;   // c_i * iys
  float* u;      // u at (s, X_s)
  float* sux;    // sum_j u_x_j at (s, X_s)
  float* ct;     // generate.cu's width-256 instance: terminal weights
  float* cv;     // ... and g(X_T) - g0
  float2* save;  // (L - 1) x 32 x CONSUMERS elu'(z) pairs of the warpgroup
  int ld;

  __device__ __forceinline__ float a1(int row, int col, int nx) const {
    // layer 1's input: x_1..x_nx at X_s, then s, then zero padding
    if (col < nx) return xrow[col] + sig[row] * dw[row * ld + col];
    return col == nx ? s_val[row] : 0.0f;
  }
};

// Warpgroup wg's tile in buffer buf of the plan.
__device__ __forceinline__ Tile tile_of(unsigned char* smem, const GPlan& pl,
                                        const Layout& k, const Params& p,
                                        int buf, int wg) {
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  Tile s;
  float* rows = reinterpret_cast<float*>(smem + pl.rows) +
                (size_t)(buf * NWG + wg) * NROWS * TILE;
  s.s_val = rows;
  s.sig = rows + TILE;
  s.iys = rows + 2 * TILE;
  s.c_i = rows + 3 * TILE;
  s.c_iy = rows + 4 * TILE;
  s.u = rows + 5 * TILE;
  s.sux = rows + 6 * TILE;
  s.xrow = reinterpret_cast<float*>(smem + pl.xrow +
                                    buf * align16((size_t)nx * 4));
  const size_t n_save = (size_t)(L > 1 ? L - 1 : 0) * k.save_layer;
  float* scr = pl.save_smem && pl.dw_smem
                   ? nullptr
                   : p.scratch + blockIdx.x * scratch_floats(pl, k, L);
  s.save = reinterpret_cast<float2*>(
      pl.save_smem ? reinterpret_cast<float*>(smem + pl.save) + wg * n_save
                   : scr + wg * n_save);
  const int tile = buf * NWG + wg;
  s.dw = pl.dw_smem
             ? reinterpret_cast<float*>(smem + pl.dw + tile * dw_bytes(k.ld))
             : scr + (pl.save_smem ? 0 : NWG * n_save) +
                   (size_t)tile * TILE * k.ld;
  s.ld = k.ld;
  return s;
}

// Layer 1's A fragments of K-slab sb: [X_s, s] split from the tile.
template <int NA>
__device__ __forceinline__ void layer1_frags(const Tile& s, int sb, int r0,
                                             int r1, int t, int nx,
                                             uint32_t (&a)[4][NA][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? r1 : r0;
      const int col = SLAB_K * sb + 16 * kk + 2 * t + 8 * (r >> 1);
      split_pair<NA>(s.a1(row, col, nx), s.a1(row, col + 1, nx), a[kk], r);
    }
}

// Issue d0 | d1 (P = 6: and c0 | c1) (+)= f's k-chunks K0 .. K0 + 3 times
// the staged slab st, as one wgmma group (ACC0 = 0: its first products
// write them).
template <int TRANS_B, int P, int ACC0, int K0, int N>
__device__ __forceinline__ void slab_group(float (&d0)[HALF],
                                           float (&d1)[HALF],
                                           float (&c0)[HALF],
                                           float (&c1)[HALF],
                                           const uint32_t (&f)[N][pieces(P)][4],
                                           uint32_t st) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk == 0)
      chunk_products<TRANS_B, P, ACC0>(d0, d1, c0, c1, f[K0], st, 0);
    else
      chunk_products<TRANS_B, P, 1>(d0, d1, c0, c1, f[K0 + kk], st, kk);
  }
  wgmma_commit();
}

// fence_acc on the accumulators of a group: d0 | d1, and c0 | c1 under P = 6
template <int P>
__device__ __forceinline__ void fence_accs(float (&d0)[HALF],
                                           float (&d1)[HALF],
                                           float (&c0)[HALF],
                                           float (&c1)[HALF]) {
  fence_acc(d0);
  fence_acc(d1);
  if constexpr (P == 6) {
    fence_acc(c0);
    fence_acc(c1);
  }
}

// A pass's per-thread state beside the accumulators: the head's partial
// sums (u) and those of sum_j u_x_j (sx), rows r0 and r1.
struct Sums {
  float u[2] = {0.0f, 0.0f};
  float sx[2] = {0.0f, 0.0f};
};

// g1_n sum_j W1[n, 1 + j] at column col, with the dots' piece products
// (P = 6: f32)
template <int P>
__device__ __forceinline__ float colsum_term(const Params& p, float g,
                                             int col) {
  const float* c0 = p.vec + (size_t)(p.L + 1) * H + col;
  if constexpr (P == 6) {
    return g * ((__ldg(c0) + __ldg(c0 + H)) + __ldg(c0 + 2 * H));
  } else {
    const float gh = bf16_round(g), ch = __ldg(c0);
    float term = gh * ch;
    if constexpr (P == 3) term += gh * __ldg(c0 + H) + bf16_round(g - gh) * ch;
    return term;
  }
}

// The forward epilogue of half h of layer l, in place: below the last
// layer, bias and ELU (elu'(z) saved); at the last layer the head's partial
// sums and the head's gradient times elu'(z), contracted with W1's column
// sums at once for a net of one layer. exp is MUFU.EX2 (__expf: a few ulp
// of a value below 1, within every mode's gate; the library's expf took 8
// instructions on each element's chain). The half's 16 biases are loaded
// (as 8 float2) before they are used: one at a time, their latency sat on
// the chain.
template <int P>
__device__ __forceinline__ void fwd_epilogue(const Params& p, const Tile& s,
                                             float (&d)[HALF], int h, int l,
                                             int ctid, Sums& acc) {
  const int t = ctid & 3;
  const float* bias = p.vec + (size_t)(l - 1) * H + 64 * h;
  if (l < p.L) {
    float2* sv = s.save + (size_t)(l - 1) * 32 * CONSUMERS + ctid;
    float2 bv[HALF / 4];  // columns 8 j + 2 t, + 1 of the half
#pragma unroll
    for (int j = 0; j < HALF / 4; ++j)
      bv[j] = __ldg(reinterpret_cast<const float2*>(bias + 8 * j + 2 * t));
#pragma unroll
    for (int q = 0; q < HALF / 2; ++q) {
      float e2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * q + e;
        const float z = d[i] + (e ? bv[i >> 2].y : bv[i >> 2].x);
        const float ez = __expf(fminf(z, 0.0f));
        d[i] = z > 0.0f ? z : ez - 1.0f;
        e2[e] = z > 0.0f ? 1.0f : ez;
      }
      sv[(size_t)(16 * h + q) * CONSUMERS] = make_float2(e2[0], e2[1]);
    }
    return;
  }
  const float* w_out = p.vec + (size_t)p.L * H + 64 * h;
  const bool last = p.L == 1;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const int col = acc_col(i, t);
    const float z = d[i] + __ldg(bias + col);
    const float ez = __expf(fminf(z, 0.0f));
    const float a = z > 0.0f ? z : ez - 1.0f;
    const float w = __ldg(w_out + col);
    float term, gw;
    if constexpr (P == 6) {
      term = a * w;
      gw = w;
    } else {
      const float wh = bf16_round(w), ah = bf16_round(a);
      term = ah * wh;
      gw = wh;
      if constexpr (P == 3) {
        const float wl = bf16_round(w - wh);
        term += bf16_round(a - ah) * wh + ah * wl;
        gw += wl;
      }
    }
    acc.u[(i >> 1) & 1] += term;
    d[i] = gw * (z > 0.0f ? 1.0f : ez);
    if (last) acc.sx[(i >> 1) & 1] += colsum_term<P>(p, d[i], 64 * h + col);
  }
}

// The backward epilogue of half h at layer l, in place: the gradient times
// elu'(z_{l - 1}), contracted with W1's column sums at layer 2 (g1). The
// saved derivatives (global scratch: L2) are all loaded before any is
// used.
template <int P>
__device__ __forceinline__ void bwd_epilogue(const Params& p, const Tile& s,
                                             float (&d)[HALF], int h, int l,
                                             int ctid, Sums& acc) {
  const int t = ctid & 3;
  const float2* sv = s.save + (size_t)(l - 2) * 32 * CONSUMERS + ctid;
  float2 ev[HALF / 2];
#pragma unroll
  for (int q = 0; q < HALF / 2; ++q)
    ev[q] = sv[(size_t)(16 * h + q) * CONSUMERS];
#pragma unroll
  for (int q = 0; q < HALF / 2; ++q) {
    const float2 e = ev[q];
    d[2 * q] *= e.x;
    d[2 * q + 1] *= e.y;
    if (l == 2) {
      const int col = 64 * h + acc_col(2 * q, t);
      acc.sx[q & 1] += colsum_term<P>(p, d[2 * q], col);
      acc.sx[q & 1] += colsum_term<P>(p, d[2 * q + 1], col + 1);
    }
  }
}

// A half of the accumulator as A fragments: its 4 k-chunks in pieces, into
// chunks k0 .. k0 + 3 of f.
template <int NA, int N>
__device__ __forceinline__ void split_half(const float (&d)[HALF],
                                           uint32_t (&f)[N][NA][4], int k0) {
#pragma unroll
  for (int q = 0; q < HALF / 2; ++q)
    split_pair<NA>(d[2 * q], d[2 * q + 1], f[k0 + (q >> 2)], q & 3);
}

// One K-slab's products, in one turn: a (4 k-chunks) times the next staged
// slab into d0 | d1 (and c0 | c1), waited for, and the slab freed. Nothing
// between the products and their wait writes an A fragment: ptxas
// serialises every product of the kernel otherwise.
template <int TRANS_B, int P, int ACC0, class Turn>
__device__ __forceinline__ void slab_products(float (&d0)[HALF],
                                              float (&d1)[HALF],
                                              float (&c0)[HALF],
                                              float (&c1)[HALF],
                                              uint32_t (&a)[4][pieces(P)][4],
                                              Ring& ring, const Turn& turn) {
  turn.wait();
  const uint32_t st = ring.acquire();
  fence_accs<P>(d0, d1, c0, c1);
  fence_frags(a);
  wgmma_fence();
  slab_group<TRANS_B, P, ACC0, 0>(d0, d1, c0, c1, a, st);
  turn.pass();
  wgmma_wait<0>();
  fence_accs<P>(d0, d1, c0, c1);
  fence_frags(a);
  ring.release_slab(ring.it - 1);
}

// d += c, half by half (P = 6: the smaller products' sums joined, in f32)
__device__ __forceinline__ void add_to(float (&d)[HALF],
                                       const float (&c)[HALF]) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) d[i] += c[i];
}

// One hidden layer (TRANS_B = 0: forward, 1: backward) from the previous
// layer's output in d0, d1 (f32, 64 columns each), its output left there
// by epi(half) for each half. P <= 3: both halves split into fragments,
// then the layer's two K-slabs in one turn, a group each, the first slab
// freed as soon as its group lands. P = 6, whose fragments take 96
// registers: one K-slab at a time, half 0 of the input split and
// multiplied while half 1 waits in f32, so that at most 48 registers of
// fragments live beside the two accumulators.
template <int TRANS_B, int P, class Turn, class Epi>
__device__ __forceinline__ void hidden_layer(float (&d0)[HALF],
                                             float (&d1)[HALF], Ring& ring,
                                             const Turn& turn, Epi epi) {
  constexpr int NA = pieces(P);
  if constexpr (P != 6) {
    uint32_t f[KC][NA][4];
    split_half(d0, f, 0);
    split_half(d1, f, 4);
    turn.wait();
    const uint32_t s0 = ring.acquire();
    const uint32_t s1 = ring.acquire();
    fence_acc(d0);
    fence_acc(d1);
    fence_frags(f);
    wgmma_fence();  // (P <= 3 reads no second accumulator: d0 | d1 fill in)
    slab_group<TRANS_B, P, 0, 0>(d0, d1, d0, d1, f, s0);
    slab_group<TRANS_B, P, 1, 4>(d0, d1, d0, d1, f, s1);
    turn.pass();
    wgmma_wait<1>();
    ring.release_slab(ring.it - 2);
    wgmma_wait<0>();
    fence_acc(d0);
    fence_acc(d1);
    fence_frags(f);
    ring.release_slab(ring.it - 1);
  } else {
    float e1[HALF], c0[HALF], c1[HALF];
    uint32_t a[4][NA][4];
    split_half(d0, a, 0);
    slab_products<TRANS_B, P, 0>(d0, e1, c0, c1, a, ring, turn);
    split_half(d1, a, 0);
    slab_products<TRANS_B, P, 1>(d0, e1, c0, c1, a, ring, turn);
    add_to(d0, c0);
#pragma unroll
    for (int i = 0; i < HALF; ++i) d1[i] = e1[i] + c1[i];
  }
  epi(d0, 0);
  epi(d1, 1);
}

// u and sum_j u_x_j of the frozen net at (s, X_s) for the tile's rows
// (written to s.u, s.sux), in P passes. All consumers of the warpgroup,
// warp-uniformly; each group of products issued in its turn.
template <int P, class Turn>
__device__ __forceinline__ void net_pass(const Params& p, const Tile& s,
                                         Ring& ring, int ctid,
                                         const Turn& turn) {
  constexpr int NA = pieces(P);
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int L = p.L, nx = p.nx, n1 = k1_of(nx) / SLAB_K;
  float d0[HALF], d1[HALF];
  Sums acc;

  // layer 1: [X_s, s] W1p^T in K-slabs, A split from the tile
  zero(d0);
  zero(d1);
  {
    float c0[HALF], c1[HALF];  // P = 6: the smaller products' sums
    if constexpr (P == 6) {
      zero(c0);
      zero(c1);
    }
    uint32_t a[4][NA][4];
    for (int sb = 0; sb < n1; ++sb) {
      layer1_frags<NA>(s, sb, r0, r1, t, nx, a);
      slab_products<0, P, 1>(d0, d1, c0, c1, a, ring, turn);
    }
    if constexpr (P == 6) {
      add_to(d0, c0);
      add_to(d1, c1);
    }
  }
  fwd_epilogue<P>(p, s, d0, 0, 1, ctid, acc);
  fwd_epilogue<P>(p, s, d1, 1, 1, ctid, acc);

  // hidden layers 2..L forward
  for (int l = 2; l <= L; ++l)
    hidden_layer<0, P>(d0, d1, ring, turn, [&](float (&d)[HALF], int h) {
      fwd_epilogue<P>(p, s, d, h, l, ctid, acc);
    });

  // backward through hidden layers L..2: g_{l-1} = (g_l W_l) elu'(z_{l-1})
  for (int l = L; l >= 2; --l)
    hidden_layer<1, P>(d0, d1, ring, turn, [&](float (&d)[HALF], int h) {
      bwd_epilogue<P>(p, s, d, h, l, ctid, acc);
    });

#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      acc.u[r] += __shfl_xor_sync(0xffffffffu, acc.u[r], o);
      acc.sx[r] += __shfl_xor_sync(0xffffffffu, acc.sx[r], o);
    }
  }
  if (t == 0) {
    const float b_out = __ldg(p.vec + (size_t)(L + packed(P) + 1) * H);
    s.u[r0] = acc.u[0] + b_out;
    s.u[r1] = acc.u[1] + b_out;
    s.sux[r0] = acc.sx[0];
    s.sux[r1] = acc.sx[1];
  }
}

// The producer warp: every slab the consumers will take, in their order,
// for each of this block's points and ring passes (a pass serves the NWG
// warpgroups' tiles). copies: images staged per slab, of nimg packed per
// layer.
__device__ __forceinline__ void produce(const Params& p, uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        int lane, int stages,
                                        int stage_bytes, int copies,
                                        int nimg) {
  const int L = p.L, K1 = k1_of(p.nx);
  const int n1 = K1 / SLAB_K, nf = n1 + 2 * (L - 1);
  const int nslab = nf + 2 * (L - 1);
  const int ntile = (p.M + TILE - 1) / TILE;
  const __nv_bfloat16* hidden = p.img + (size_t)nimg * H * K1;
  int it = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; kb += NWG)
      for (int sl = 0; sl < nslab; ++sl, ++it) {
        const int st = it % stages, round = it / stages;
        if (round > 0) mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
        const __nv_bfloat16* src;
        size_t img_off, row_stride;
        int rows = 16, row_bytes = 1024;
        if (sl < n1) {  // W1, input columns 64 sl ..
          src = p.img + (size_t)8 * sl * 64;
          img_off = (size_t)H * K1;
          row_stride = (size_t)K1 * 8;
        } else {
          const bool fwd = sl < nf;
          const int f = fwd ? sl - n1 : sl - nf;
          const int l = fwd ? 2 + f / 2 : L - f / 2, half = f & 1;
          const __nv_bfloat16* w = hidden + (size_t)(l - 2) * nimg * H * H;
          img_off = (size_t)H * H;
          row_stride = (size_t)H * 8;
          if (fwd) {  // columns 64 half .. : 16 rows of 8 cores
            src = w + (size_t)8 * half * 64;
          } else {  // rows 64 half .. : 8 core rows of 16, contiguous
            src = w + (size_t)half * 8 * H * 8;
            rows = 1;
            row_bytes = IMAGE_BYTES;
          }
        }
        const uint32_t bar = full + 8 * st;
        if (lane == 0)
          mbar_expect_tx(bar, (uint32_t)(rows * row_bytes * copies));
        __syncwarp();
        for (int c = lane; c < rows * copies; c += 32) {
          const int im = c / rows, r = c - im * rows;
          bulk_copy(ring + (uint32_t)(st * stage_bytes + im * IMAGE_BYTES +
                                      r * 1024),
                    src + im * img_off + r * row_stride, (uint32_t)row_bytes,
                    bar);
        }
      }
}

// ---- the integral chain's per-tile steps (a warpgroup's consumers) -------

// the time draws of tile kb: s, the X_s scale and the likelihood weight
__device__ __forceinline__ void draw_times(const Params& p, const Tile& s,
                                           int b, int kb, float t, float Tt,
                                           uint2 key, int ctid) {
  if (ctid >= TILE) return;
  const int k = kb * TILE + ctid;
  const int Md = p.anti ? p.M / 2 : p.M;
  float u = 0.0f;
  if (k < p.M) {
    const int kd = p.anti ? k >> 1 : k;
    u = p.u01 ? p.u01[(size_t)b * Md + kd]
              : time_uniform(kd, p.seed_hi, key);
  }
  const float sv = t + u * Tt;
  const float st = sv - t;
  s.s_val[ctid] = sv;
  s.sig[ctid] = sqrtf(st) * p.alpha_sqrt;
  s.iys[ctid] = 1.0f / (sqrtf(fmaxf(st, ST_FLOOR)) * p.alpha_sqrt);
}

// the integral chain's normals of tile kb (antithetic: 2p + 1 mirrors 2p)
__device__ __forceinline__ void draw_normals(const Params& p, const Tile& s,
                                             int b, int kb, uint2 key,
                                             int ctid) {
  const int nx = p.nx, Md = p.anti ? p.M / 2 : p.M;
  if (p.noise_i) {
    for (int e = ctid; e < TILE * nx; e += CONSUMERS) {
      const int i = e / nx, j = e - i * nx, k = kb * TILE + i;
      float c = 0.0f;
      if (k < p.M) {
        const int kd = p.anti ? k >> 1 : k;
        const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
        c = sg * p.noise_i[((size_t)b * Md + kd) * nx + j];
      }
      s.dw[i * s.ld + j] = c;
    }
    return;
  }
  const int Q = (nx + 3) / 4;
  for (int e = ctid; e < TILE * Q; e += CONSUMERS) {
    const int i = e / Q, q = e - i * Q, k = kb * TILE + i;
    float n[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (k < p.M) {
      const int kd = p.anti ? k >> 1 : k;
      const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
      normals4(kd, q, STREAM_INTEGRAL, p.seed_hi, key, n);
#pragma unroll
      for (int r = 0; r < 4; ++r) n[r] *= sg;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (4 * q + r < nx) s.dw[i * s.ld + 4 * q + r] = n[r];
  }
}

// f = ff(s, X_s, u, u_x) for Cha, and each row's weights
__device__ __forceinline__ void sample_weights(const Params& p,
                                               const Tile& s, int kb,
                                               float Tt, float f0,
                                               int ctid) {
  if (ctid >= TILE) return;
  const bool valid = kb * TILE + ctid < p.M;
  const float coef = p.k * s.u[ctid] - p.c0;
  const float f = p.alpha_sqrt * coef * (p.alpha_sqrt * s.sux[ctid]);
  const float di = valid ? Tt * (f - f0) : 0.0f;
  s.c_i[ctid] = di;
  s.c_iy[ctid] = di * s.iys[ctid];
}

// the point's 1 + nx integral sums over the tile's rows, in row order
// (slot j = ctid + CONSUMERS r; slot 0: value); the row loops unrolled by
// 4 at most: unrolled whole, their loads took registers the net pass needs
__device__ __forceinline__ void accumulate(const Tile& s, int nx, int ctid,
                                           float (&acc)[MAXJ]) {
#pragma unroll
  for (int r = 0; r < MAXJ; ++r) {
    const int j = ctid + r * CONSUMERS;
    if (j == 0) {
#pragma unroll 4
      for (int row = 0; row < TILE; ++row) acc[r] += s.c_i[row];
    } else if (j <= nx) {
      const float* di = s.dw + (j - 1);
#pragma unroll 4
      for (int row = 0; row < TILE; ++row)
        acc[r] = fmaf(s.c_iy[row], di[row * s.ld], acc[r]);
    }
  }
}

// ---- host side ---------------------------------------------------------

// blocks of `kernel` that the card runs at once with `smem` bytes each
// (the persistent grid: one block an SM), at most B; -1 if none
template <class Kernel>
inline int persistent_grid(Kernel kernel, size_t smem, int B) {
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

// error codes of the entry points beside CUDA's own
constexpr int ERR_NO_PLAN = 10001, ERR_NO_SCRATCH = 10002,
              ERR_BAD_MODE = 10003, ERR_GRID = 10004;

// set up the ring's barriers (a stage is free once `consumers` threads
// released it) and, where dfull is not 0, the two draw buffers' (full:
// AUX_THREADS arrivals; empty: `consumers`), by thread 0; then the block
// syncs
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty,
                                          int stages, int consumers,
                                          uint32_t dfull = 0) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, consumers);
    }
    if (dfull)
      for (int k = 0; k < 2; ++k) {
        mbar_init(dfull + 8 * k, AUX_THREADS);
        mbar_init(dfull + 16 + 8 * k, consumers);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace dpi
