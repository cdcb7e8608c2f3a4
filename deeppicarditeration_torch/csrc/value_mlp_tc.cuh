// The frozen value network's forward and backward pass on Hopper's tensor
// cores, for the integral-chain kernels (integral.cu; generate.cu runs the
// same pass on two warpgroups, with its own plan and draws) under
// DATA.TPU.PALLAS_PRECISION "bf16x3" (the default) and "default". The
// counterpart of the TPU kernels' in-kernel net dots under
// pallas_kernels.py: bf16x3_dot_general (_split3, _bf16x3_bwd); the FP32-FMA
// pass of value_mlp.cuh stays the "highest" mode.
//
// Precision. Each f32 operand a is split into hi = bf16(a) and lo =
// bf16(a - hi); a product is hi*hi + lo*hi + hi*lo (bf16x3) or hi*hi
// (default), three or one wgmma into one f32 accumulator, as _split3 does
// with three MXU passes. bf16 products are exact in f32, so the result
// differs from the JAX kernel's only in the order of the f32 sums. ELU, its
// derivative, the biases, the head (H -> 1) and the contraction of the
// first layer's gradient with W1's column sums stay in f32, each with the
// same hi/lo products as _split3 would take.
//
// Layout. A block is one warpgroup of consumers (128 threads) and one
// producer warp. The consumers take a point's samples in tiles of TILE = 64
// rows (wgmma's M): each layer is one m64n128 product per k16 chunk, with A
// (activations forward, gradients backward) split in registers and fed
// from registers, B (the weights) from shared memory. The accumulator's
// register layout is that of the next layer's A fragments, so activations
// never leave the registers between layers. The mode is a template
// parameter and every slab issues the same wgmma: a branch between two
// wgmma made ptxas wait for the first to finish (a WARPGROUP.DEPBAR after
// every HGMMA in the SASS). A read from shared memory instead doubled the
// shared-memory bytes per wgmma and ran slower. The ELU derivative of each
// hidden layer but the last is kept (f32, one float2 per thread and pair
// of columns) for the backward pass, in shared memory where it fits and
// else in a global scratch of this block's own.
//
// Weights are staged, not streamed per warp: the producer copies slabs of
// 128 x 64 bf16 (hi and lo, 32 KB) with cp.async.bulk into a ring of
// `stages` buffers guarded by mbarriers (full: bytes landed; empty: the
// 128 consumers are done), in the order the consumers take them: layer 1 in
// K-slabs of 64 input columns (so nx does not bound shared memory), each
// hidden layer's two column slabs forward, then its two row slabs backward.
// Each weight byte read from L2 serves a tile of 64 samples. The packed
// images (ops/kernels.py:pack_mlp_tc) hold each W (out, in) as 8 x 8 core
// matrices, core (i, j) at (i * in / 8 + j) * 128 bytes: the forward pass
// reads a slab K-major (no swizzle: LBO 128 B along K, SBO 1024 B along N),
// the backward pass reads the same bytes of W as B transposed (MN-major:
// LBO 2048 B along K = out, SBO 128 B along N = in), so no W^T is stored.
//
// Shared memory (bytes, at TILE = 64): the ring stages x 32 768, the saved
// derivatives (L - 1) x 32 768 when in shared memory, the tile's integral
// normals 256 nx, x 4 nx, 7 per-row arrays and the barriers. Registers and
// shared memory decide the occupancy (launch_plan_for): two blocks per SM
// where a block fits in half the shared memory, with the derivatives in
// global scratch (L2-resident: 2 x 132 blocks x 96 KB at 4x128) and 2
// stages, 93 392 bytes at nx = 100 and 4x128, registers capped by
// __launch_bounds__(THREADS, 2);
// else one block with the largest ring of 2-4 stages that fits 227 KB,
// the derivatives in shared memory where they fit.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"
#include "value_mlp.cuh"

namespace dpi {
namespace tc {

constexpr int TILE = 64;                 // samples per tile: wgmma's M
constexpr int CONSUMERS = 128;           // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int NACC = H / 2;              // accumulator floats per thread
constexpr int SLAB_K = 64;               // K-extent of a staged slab
constexpr int IMAGE_BYTES = H * SLAB_K * 2;   // one bf16 image of a slab
constexpr int STAGE_BYTES = 2 * IMAGE_BYTES;  // hi and lo
constexpr int MAX_STAGES = 4;
constexpr int SAVE_LAYER_FLOATS = TILE * H;   // one layer's elu'(z)
constexpr int NROWS = 7;                 // per-row arrays of a tile
constexpr int MAXJ = 4;                  // output slots per consumer
constexpr size_t SMEM_LIMIT = 232448;
// a block's share when two run on an SM: (228 KB - 1 KB each) / 2
constexpr size_t TWO_BLOCK_SMEM = 115712;
constexpr int MODE_BF16X3 = 1, MODE_ONE_PASS = 2;

// layer 1's K: 1 + nx padded to whole slabs (ops/kernels.py:tc_k1), so
// that every slab's products are the same instructions
__host__ __device__ inline int k1_of(int nx) {
  return (1 + nx + SLAB_K - 1) / SLAB_K * SLAB_K;
}

__host__ __device__ inline size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

// Byte offsets of the dynamic shared memory.
struct Plan {
  int stages, save_smem;
  size_t ring, save, dw, xrow, rows, bars, total;
};

__host__ __device__ inline Plan make_plan(int nx, int L, int stages,
                                          int save_smem) {
  Plan p;
  p.stages = stages;
  p.save_smem = save_smem;
  size_t o = 0;
  p.ring = o;
  o += (size_t)stages * STAGE_BYTES;
  p.save = o;
  if (save_smem && L > 1) o += (size_t)(L - 1) * SAVE_LAYER_FLOATS * 4;
  p.dw = o;
  o += align16((size_t)TILE * nx * 4);
  p.xrow = o;
  o += align16((size_t)nx * 4);
  p.rows = o;
  o += (size_t)NROWS * TILE * 4;
  p.bars = o;
  o += (size_t)2 * MAX_STAGES * 8;
  p.total = o;
  return p;
}

// The largest ring of 2..MAX_STAGES stages (a hidden layer holds two)
// with the saved derivatives in shared memory, else with them in global
// scratch, within `limit` bytes; no ring without a net. stages = -1 when
// nothing fits.
inline Plan choose_plan(int nx, int L, size_t limit = SMEM_LIMIT) {
  if (L == 0) {
    Plan p = make_plan(nx, 0, 0, 0);
    if (p.total > limit) p.stages = -1;
    return p;
  }
  for (int save = 1; save >= 0; --save)
    for (int st = MAX_STAGES; st >= 2; --st) {
      const Plan p = make_plan(nx, L, st, save);
      if (p.total <= limit) return p;
    }
  Plan bad = make_plan(nx, L, 0, 0);
  bad.stages = -1;
  return bad;
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
  float* scratch;        // gridDim.x x (L - 1) x TILE x H, or null
  float* out;            // (B, 1 + nx)
  int B, M, nx, L, has_net, anti, mode;  // Md = anti ? M / 2 : M
  int stages, save_smem;
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

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
// keep the compiler from moving accesses to the accumulator or to the A
// fragments across wgmma.fence and the asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int k = 0; k < N; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[k][r])::"memory");
}

// d (64 x 128, f32) += A (64 x 16 bf16, registers) B (16 x 128 bf16,
// shared memory at desc_b; TRANS_B = 1: read MN-major)
template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[NACC],
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

// ---- the pass ---------------------------------------------------------

// a, b -> their bf16 hi parts and bf16-rounded residuals, packed in pairs
// (the lower column in the low half, as a wgmma A fragment holds them)
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

__device__ __forceinline__ float bf16_round(float a) {
  return __bfloat162float(__float2bfloat16_rn(a));
}

// Accumulator element i of a consumer thread (warp w, lane = 4 g + t) holds
// row 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 t + (i & 1); A
// fragment register r of k-chunk kc holds the pair of elements 8 kc + 2 r,
// + 1 of that layout, so an activated accumulator is the next layer's A.
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}

constexpr int KC = H / 16;  // k16 chunks of a hidden layer

__device__ __forceinline__ void to_frags(const float (&acc)[NACC],
                                         uint32_t (&ah)[KC][4],
                                         uint32_t (&al)[KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(acc[8 * kc + 2 * r], acc[8 * kc + 2 * r + 1], ah[kc][r],
                 al[kc][r]);
}

__device__ __forceinline__ void zero(float (&acc)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
}

// One k-chunk of a staged slab: hi*hi (+ lo*hi + hi*lo under bf16x3).
// Forward slabs are K-major (column slab of W: 16 core rows of 8 cores),
// backward slabs MN-major (row slab of W: 8 core rows of 16 cores). The
// mode is a template parameter: a branch between two wgmma makes ptxas
// wait for the first to finish.
template <int TRANS_B, bool X3>
__device__ __forceinline__ void mma_chunk(float (&acc)[NACC],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          uint32_t stage, int kk) {
  const uint32_t b = stage + (TRANS_B ? kk * 4096 : kk * 256);
  const uint32_t lbo = TRANS_B ? 2048 : 128, sbo = TRANS_B ? 128 : 1024;
  const uint64_t bh = gmma_desc(b, lbo, sbo);
  wgmma_bf16<TRANS_B>(acc, ah, bh);
  if (X3) {
    wgmma_bf16<TRANS_B>(acc, al, bh);
    wgmma_bf16<TRANS_B>(acc, ah, gmma_desc(b + IMAGE_BYTES, lbo, sbo));
  }
}

// The consumers' view of the ring: slab `it` sits in stage it % stages.
struct Ring {
  uint32_t base, full, empty;
  int stages, it;  // it: slabs taken

  // wait for the next slab; its stage's shared address
  __device__ __forceinline__ uint32_t acquire() {
    const int st = it % stages;
    mbar_wait(full + 8 * st, (uint32_t)((it / stages) & 1));
    ++it;
    return base + (uint32_t)(st * STAGE_BYTES);
  }
  // slab n's products are done: its stage may be refilled
  __device__ __forceinline__ void release_slab(int n) {
    mbar_arrive(empty + 8 * (n % stages));
  }
};

// Issue acc += A's k-chunks K0 .. K0 + 3 (ah, al: N chunks) times the
// next staged slab, as one wgmma group.
template <int TRANS_B, bool X3, int K0, int N>
__device__ __forceinline__ void slab_issue(float (&acc)[NACC],
                                           uint32_t (&ah)[N][4],
                                           uint32_t (&al)[N][4],
                                           Ring& ring) {
  const uint32_t stage = ring.acquire();
  fence_acc(acc);
  fence_frags(ah);
  fence_frags(al);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < SLAB_K / 16; ++kk)
    mma_chunk<TRANS_B, X3>(acc, ah[K0 + kk], al[K0 + kk], stage, kk);
  wgmma_commit();
}

// Wait until at most PENDING groups are in flight, then free the oldest
// slab taken and not yet freed.
template <int PENDING>
__device__ __forceinline__ void slab_retire(float (&acc)[NACC], Ring& ring,
                                            int& freed) {
  wgmma_wait<PENDING>();
  fence_acc(acc);
  ring.release_slab(freed++);
}

// Turn-taking of warpgroups that share the tensor pipe: wait() before a
// group of products is issued, pass() once it is. A lone warpgroup takes
// every turn (NoTurn).
struct NoTurn {
  __device__ __forceinline__ void wait() const {}
  __device__ __forceinline__ void pass() const {}
};

// A hidden layer: both slabs in flight together, then freed in order.
template <int TRANS_B, bool X3, class Turn>
__device__ __forceinline__ void hidden_layer(float (&acc)[NACC],
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

// The tile's shared arrays (rows: TILE floats each).
struct Tile {
  float* dw;     // TILE x nx  integral normals
  float* xrow;   // nx         the point's x
  float* s_val;  // s
  float* sig;    // sqrt(s - t) sqrt(a)
  float* iys;    // 1 / (sqrt(max(s - t, floor)) sqrt(a))
  float* c_i;    // Tt (f - f0)
  float* c_iy;   // c_i * iys
  float* u;      // u at (s, X_s)
  float* sux;    // sum_j u_x_j at (s, X_s)
  float2* save;  // (L - 1) x 32 x CONSUMERS elu'(z) pairs of this block

  __device__ __forceinline__ float a1(int row, int col, int nx) const {
    // layer 1's input: x_1..x_nx at X_s, then s, then zero padding
    if (col < nx) return xrow[col] + sig[row] * dw[row * nx + col];
    return col == nx ? s_val[row] : 0.0f;
  }
};

__device__ __forceinline__ Tile carve(unsigned char* smem, const Plan& pl,
                                      const Params& p) {
  Tile s;
  s.dw = reinterpret_cast<float*>(smem + pl.dw);
  s.xrow = reinterpret_cast<float*>(smem + pl.xrow);
  float* rows = reinterpret_cast<float*>(smem + pl.rows);
  s.s_val = rows;
  s.sig = rows + TILE;
  s.iys = rows + 2 * TILE;
  s.c_i = rows + 3 * TILE;
  s.c_iy = rows + 4 * TILE;
  s.u = rows + 5 * TILE;
  s.sux = rows + 6 * TILE;
  const int L = p.has_net ? p.L : 0;
  s.save = pl.save_smem || L < 2
               ? reinterpret_cast<float2*>(smem + pl.save)
               : reinterpret_cast<float2*>(
                     p.scratch +
                     (size_t)blockIdx.x * (L - 1) * SAVE_LAYER_FLOATS);
  return s;
}

// Bias and ELU of layer l's accumulator. Below the last layer the
// activation stays in acc and elu'(z) is saved; at the last layer the head
// gives u (rows written by lanes t = 0) and acc becomes the head's gradient
// times elu'(z).
template <bool X3>
__device__ __forceinline__ void layer_out(const Params& p, const Tile& s,
                                          float (&acc)[NACC], int l,
                                          int ctid) {
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const float* bias = p.vec + (size_t)(l - 1) * H;
  if (l < p.L) {
    float2* sv = s.save + (size_t)(l - 1) * 32 * CONSUMERS + ctid;
#pragma unroll
    for (int q = 0; q < NACC / 2; ++q) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * q + e;
        const float z = acc[i] + __ldg(bias + acc_col(i, t));
        const float ez = expf(fminf(z, 0.0f));
        acc[i] = z > 0.0f ? z : ez - 1.0f;
        d[e] = z > 0.0f ? 1.0f : ez;
      }
      sv[(size_t)q * CONSUMERS] = make_float2(d[0], d[1]);
    }
    return;
  }
  const float* w_out = p.vec + (size_t)p.L * H;
  float u[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int col = acc_col(i, t);
    const float z = acc[i] + __ldg(bias + col);
    const float ez = expf(fminf(z, 0.0f));
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
  const float b_out = __ldg(p.vec + (size_t)(p.L + 3) * H);
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

// u and sum_j u_x_j of the frozen net at (s, X_s) for the tile's rows
// (written to s.u, s.sux). All consumers, warp-uniformly; each group of
// products issued in its turn.
template <bool X3, class Turn = NoTurn>
__device__ __forceinline__ void net_pass(const Params& p, const Tile& s,
                                         Ring& ring, int ctid,
                                         const Turn& turn = Turn()) {
  const int warp = ctid >> 5, lane = ctid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const int L = p.L, nx = p.nx, n1 = k1_of(nx) / SLAB_K;
  float acc[NACC];

  // layer 1: [X_s, s] W1p^T in K-slabs, A split from the tile's normals
  zero(acc);
  for (int sb = 0; sb < n1; ++sb) {
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = (r & 1) ? r1 : r0;
        const int col = SLAB_K * sb + 16 * kk + 2 * t + 8 * (r >> 1);
        split_pair(s.a1(row, col, nx), s.a1(row, col + 1, nx), ah[kk][r],
                   al[kk][r]);
      }
    int freed = ring.it;
    turn.wait();
    slab_issue<0, X3, 0>(acc, ah, al, ring);
    turn.pass();
    slab_retire<0>(acc, ring, freed);
  }
  layer_out<X3>(p, s, acc, 1, ctid);

  // hidden layers 2..L forward
  for (int l = 2; l <= L; ++l) {
    uint32_t ah[KC][4], al[KC][4];
    to_frags(acc, ah, al);
    zero(acc);
    hidden_layer<0, X3>(acc, ah, al, ring, turn);
    layer_out<X3>(p, s, acc, l, ctid);
  }

  // backward through hidden layers L..2: g_{l-1} = (g_l W_l) elu'(z_{l-1})
  for (int l = L; l >= 2; --l) {
    uint32_t ah[KC][4], al[KC][4];
    to_frags(acc, ah, al);
    zero(acc);
    hidden_layer<1, X3>(acc, ah, al, ring, turn);
    const float2* sv = s.save + (size_t)(l - 2) * 32 * CONSUMERS + ctid;
#pragma unroll
    for (int q = 0; q < NACC / 2; ++q) {
      const float2 d = sv[(size_t)q * CONSUMERS];
      acc[2 * q] *= d.x;
      acc[2 * q + 1] *= d.y;
    }
  }

  // sum_j u_x_j = sum_n g1_n sum_j W1[n, 1 + j], with _split3's products
  const float* wc_hi = p.vec + (size_t)(L + 1) * H;
  const float* wc_lo = p.vec + (size_t)(L + 2) * H;
  float sx[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
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

// The producer warp: every slab the consumers will take, in their order,
// for each of this block's points and tiles (each ring pass serving
// `tiles_per_pass` tiles at once).
__device__ __forceinline__ void produce(const Params& p, uint32_t ring,
                                        uint32_t full, uint32_t empty,
                                        int lane, int tiles_per_pass = 1) {
  const int L = p.L, K1 = k1_of(p.nx);
  const int n1 = K1 / SLAB_K, nf = n1 + 2 * (L - 1);
  const int nslab = nf + 2 * (L - 1);
  const int ntile = (p.M + TILE - 1) / TILE;
  const bool x3 = p.mode == MODE_BF16X3;
  const __nv_bfloat16* hidden = p.img + (size_t)2 * H * K1;
  const int r = lane & 15;
  const bool lo = lane >= 16;
  int it = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x)
    for (int kb = 0; kb < ntile; kb += tiles_per_pass)
      for (int sl = 0; sl < nslab; ++sl, ++it) {
        const int st = it % p.stages, round = it / p.stages;
        if (round > 0) mbar_wait(empty + 8 * st, (uint32_t)((round - 1) & 1));
        const __nv_bfloat16* src;
        size_t lo_off, row_stride;
        int rows = 16, row_bytes = 1024;
        if (sl < n1) {  // W1, input columns 64 sl ..
          src = p.img + (size_t)8 * sl * 64;
          lo_off = (size_t)H * K1;
          row_stride = (size_t)K1 * 8;
        } else {
          const bool fwd = sl < nf;
          const int f = fwd ? sl - n1 : sl - nf;
          const int l = fwd ? 2 + f / 2 : L - f / 2, half = f & 1;
          const __nv_bfloat16* w = hidden + (size_t)(l - 2) * 2 * H * H;
          lo_off = (size_t)H * H;
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
          mbar_expect_tx(bar, (uint32_t)(rows * row_bytes * (x3 ? 2 : 1)));
        __syncwarp();
        if (r < rows && (x3 || !lo))
          bulk_copy(ring + (uint32_t)(st * STAGE_BYTES +
                                      (lo ? IMAGE_BYTES : 0) + r * 1024),
                    src + (lo ? lo_off : 0) + r * row_stride,
                    (uint32_t)row_bytes, bar);
      }
}

// ---- the integral chain's per-tile steps (all consumers) -----------------

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
      s.dw[e] = c;
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
      if (4 * q + r < nx) s.dw[i * nx + 4 * q + r] = n[r];
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
// (slot j = ctid + CONSUMERS r; slot 0: value)
__device__ __forceinline__ void accumulate(const Tile& s, int nx, int ctid,
                                           float (&acc)[MAXJ]) {
#pragma unroll
  for (int r = 0; r < MAXJ; ++r) {
    const int j = ctid + r * CONSUMERS;
    if (j == 0) {
      for (int row = 0; row < TILE; ++row) acc[r] += s.c_i[row];
    } else if (j <= nx) {
      const float* di = s.dw + (j - 1);
      for (int row = 0; row < TILE; ++row)
        acc[r] = fmaf(s.c_iy[row], di[row * nx], acc[r]);
    }
  }
}

// ---- host side ---------------------------------------------------------

// blocks of `kernel` that the card runs at once with `smem` bytes each
// (the persistent grid), at most B
template <class Kernel>
inline int persistent_grid(Kernel kernel, size_t smem, int B) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem) != cudaSuccess ||
      per_sm < 1)
    return -1;
  return B < sms * per_sm ? B : sms * per_sm;
}

// Two blocks per SM where a block's plan fits in half the shared memory
// (the saved derivatives then in global scratch; at nx = 100 and 4x128:
// 2 stages, 93 392 bytes), so that one block's epilogues and draws overlap
// the other's products; else one block per SM (`two` says which).
inline Plan launch_plan_for(int nx, int L, int* two) {
  const Plan p2 = choose_plan(nx, L, TWO_BLOCK_SMEM);
  *two = p2.stages >= 0;
  return *two ? p2 : choose_plan(nx, L);
}

// bytes of global scratch a launch needs at any B and mode (0: the saved
// derivatives fit in shared memory; -1: no plan); pick(mode, two) is the
// kernel instantiation
template <class Pick>
inline long long scratch_bytes(Pick pick, int nx, int L) {
  int two;
  const Plan pl = launch_plan_for(nx, L, &two);
  if (pl.stages < 0) return -1;
  if (pl.save_smem || L < 2) return 0;
  long long most = 0;
  for (int mode = MODE_BF16X3; mode <= MODE_ONE_PASS; ++mode) {
    const int grid = persistent_grid(pick(mode, two), pl.total, 1 << 30);
    if (grid < 0) return -1;
    const long long b = (long long)grid * (L - 1) * SAVE_LAYER_FLOATS * 4;
    most = b > most ? b : most;
  }
  return most;
}

// error codes of the entry points beside CUDA's own
constexpr int ERR_NO_PLAN = 10001, ERR_NO_SCRATCH = 10002,
              ERR_BAD_MODE = 10003, ERR_GRID = 10004;

// the checks and the plan of a launch: 0, or an error code
inline int launch_plan(int nx, int L, int has_net, int mode,
                       const float* scratch, Plan* pl, int* two) {
  if (mode != MODE_BF16X3 && mode != MODE_ONE_PASS) return ERR_BAD_MODE;
  if (has_net && L < 1) return ERR_NO_PLAN;
  *pl = launch_plan_for(nx, has_net ? L : 0, two);
  if (pl->stages < 0) return ERR_NO_PLAN;
  if (!pl->save_smem && L > 1 && !scratch) return ERR_NO_SCRATCH;
  return 0;
}

// set up the ring's barriers (thread 0; a stage is free once `consumers`
// threads released it), then the whole block syncs
__device__ __forceinline__ void init_ring(uint32_t full, uint32_t empty,
                                          int stages,
                                          int consumers = CONSUMERS) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, 1);
      mbar_init(empty + 8 * st, consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

}  // namespace tc
}  // namespace dpi
