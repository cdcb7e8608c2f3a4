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
// One kernel, integral_tc_kernel<P>, for the three precisions of the net's
// dots (the TPU kernel's mxu_precision, DATA.TPU.PALLAS_PRECISION): P = 3
// passes of bf16 products ("bf16x3", the default), 1 ("default") and 6
// ("highest", the MXU's f32 product), on the tensor cores
// (value_mlp_tc.cuh: net_pass). Its bound is the tensor pipe (P x 111.5 k
// bf16 multiply-adds per sample at nx = 100). The one-warpgroup design
// before it ran each 64-sample tile's draws, net pass, weights and sums
// one after another, and "highest" on the FP32 pipe (FMA, 4x the tensor
// bound of bf16x3). This one:
//   - three warps of the producer warpgroup draw the next tile pair's
//     times and normals (draws.cuh's guard-free Box-Muller, lane = draw,
//     the quads dealt over the warps, a lean counter that fits the 56
//     registers those warps keep) into one of two buffers, handed over by
//     mbarriers (full: drawn; empty: both consumer warpgroups read it);
//   - two consumer warpgroups on tiles 2 i and 2 i + 1 read every weight
//     stage (a staged byte serves 128 samples), issue their products in
//     turns, one m64n128 group a K-slab;
//   - "highest" is the same pass with P = 6, three images of each W, one
//     K-slab at a time, the five smaller products of each in an
//     accumulator of their own (the tensor cores cut each wgmma's sum
//     toward zero).
// What binds after it (PERF.md §6): the epilogues (bias, ELU, the
// saved derivatives), latency-bound on two consumer warps a scheduler.
// The draws take Philox counted by (sample, quad, stream 1) and (sample,
// stream 2) for the time (philox.cuh), so they do not depend on the launch
// shape; the integral sums are reduced in row order by the thread that
// owns each output (deterministic); a persistent grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "draws.cuh"
#include "philox.cuh"
#include "value_mlp_tc.cuh"

namespace {

using namespace dpi;
using tc::AUX_THREADS;
using tc::AUX_WARPS;
using tc::NWG;
using tc::TILE;

constexpr int PAIR = NWG * TILE;  // rows of a tile pair: a buffer
// registers a thread after setmaxnreg: the draw warps' lean counter leaves
// the producer warpgroup 56, the consumers take what that frees, 128 (168
// - 56) = 256 (224 - 168); at 208, bf16x3's pass spilled
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;

// The integral kernel's shared memory beside the ring: two buffers of a
// tile pair's normals (rows padded to whole quads), times and x; a stage
// holds the images the mode reads.
__host__ __device__ inline tc::Layout integral_layout(int nx, int P) {
  return tc::Layout{2, 0, (nx + 3) / 4 * 4, tc::pieces(P) * tc::IMAGE_BYTES};
}

// The draws of this block's tile pairs on the producer warpgroup's other
// warps (dt: 0 .. AUX_THREADS - 1), pair n into buffer n % 2 once both
// consumer warpgroups have read pair n - 2 from it: the point's x, each
// row's time (s, the X_s scale, the likelihood weight) and normals. Own
// draws: lane = draw, each warp drawing every AUX_WARPS-th quad of it from
// the draw's counter, one 16-byte store a quad (rows of ld floats, ld a
// multiple of 4: the quad past nx writes padding nothing reads).
__device__ __forceinline__ void draw_warps(const tc::Params& p,
                                           unsigned char* smem,
                                           const tc::GPlan& pl,
                                           uint32_t dfull, uint32_t dempty,
                                           int dt) {
  const int nx = p.nx, Q = (nx + 3) / 4;
  const tc::Layout& lay = p.lay;
  const int ld = lay.ld, Md = p.Md;
  const int w = dt >> 5, lane = dt & 31;
  const int ndraw = p.anti ? PAIR / 2 : PAIR;
  // one counter over this block's tile pairs, the point and the pair worked
  // out from it and the launch's constants: little state lives across a
  // pair, in the 56 registers these warps keep
  for (int n = 0;; ++n) {
    const int i = n % p.npair, b = blockIdx.x + (n / p.npair) * gridDim.x;
    if (b >= p.B) break;
    const uint2 key = make_uint2(p.seed_lo, (uint32_t)b);
    const int buf = n & 1;
    if (n >= 2)
      tc::mbar_wait(dempty + 8 * buf, (uint32_t)(((n >> 1) - 1) & 1));
    const tc::Tile s = tc::tile_of(smem, pl, lay, p, buf, 0);
    for (int j = dt; j < nx; j += AUX_THREADS)
      s.xrow[j] = p.x[(size_t)b * nx + j];
    for (int r = dt; r < PAIR; r += AUX_THREADS) {
      const int k = i * PAIR + r;
      const float t = p.t[b], Tt = p.T - t;
      float u = 0.0f;
      if (k < p.M) {
        const int kd = p.anti ? k >> 1 : k;
        u = p.u01 ? p.u01[(size_t)b * Md + kd]
                  : time_uniform(kd, p.seed_hi, key);
      }
      const float sv = t + u * Tt;
      const float st = sv - t;
      // warpgroup r / TILE's rows (tile_of: NROWS arrays of TILE)
      float* rows = s.s_val + (r / TILE) * tc::NROWS * TILE + r % TILE;
      rows[0] = sv;
      rows[TILE] = sqrtf(st) * p.alpha_sqrt;
      rows[2 * TILE] = 1.0f / (sqrtf(fmaxf(st, ST_FLOOR)) * p.alpha_sqrt);
    }
    // the pair's rows are the two tiles' (contiguous: dw_bytes is TILE ld
    // floats)
    float* dw = s.dw;
    if (p.noise_i) {
      for (int e = dt; e < PAIR * nx; e += AUX_THREADS) {
        const int row = e / nx, j = e - row * nx, k = i * PAIR + row;
        float c = 0.0f;
        if (k < p.M) {
          const int kd = p.anti ? k >> 1 : k;
          const float sg = (p.anti && (k & 1)) ? -1.0f : 1.0f;
          c = sg * p.noise_i[((size_t)b * Md + kd) * nx + j];
        }
        dw[row * ld + j] = c;
      }
    } else {
      for (int d0 = 0; d0 < ndraw; d0 += 32) {
        const int d = d0 + lane;
        const int row = p.anti ? 2 * d : d, k = i * PAIR + row;
        const bool live = k < p.M;
        const LeanDrawCounter dc((uint32_t)(p.anti ? k >> 1 : k),
                                 p.seed_hi, key, STREAM_INTEGRAL);
        float* o = dw + (size_t)row * ld;
        for (int q = w; q < Q; q += AUX_WARPS) {
          float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (live) v = quad_normals(dc, (uint32_t)q);
          *reinterpret_cast<float4*>(o + 4 * q) = v;
          if (p.anti)
            *reinterpret_cast<float4*>(o + ld + 4 * q) =
                make_float4(-v.x, -v.y, -v.z, -v.w);
        }
      }
    }
    tc::mbar_arrive(dfull + 8 * buf);
  }
}

// P: the net's passes (1, 3 or 6). A block: two consumer warpgroups, each
// on its own 64-row tile (tiles 2 i and 2 i + 1 of a point; the second
// takes an empty tile past the last when a point's tiles are odd, to keep
// the ring's pace), both reading every weight stage and the pair's buffer;
// the producer warpgroup: one warp streaming the stages, three drawing.
template <int P>
__global__ void __launch_bounds__(tc::TC_THREADS, 1)
integral_tc_kernel(const tc::Params p) {
  using namespace tc;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  unsigned char* smem = smem_tc;
  const int nx = p.nx, L = p.has_net ? p.L : 0;
  const Layout& lay = p.lay;
  const GPlan& pl = p.plan;
  const uint32_t full = smem_u32(smem + pl.bars);
  const uint32_t empty = full + 8 * MAX_STAGES;
  const uint32_t dfull = empty + 8 * MAX_STAGES, dempty = dfull + 16;
  init_ring(full, empty, pl.stages, TC_CONSUMERS, dfull);
  if (threadIdx.x >= TC_CONSUMERS) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int dt = threadIdx.x - TC_CONSUMERS - 32;
    if (dt < 0) {
      if (L > 0)
        produce(p, smem_u32(smem + pl.ring), full, empty, threadIdx.x & 31,
                pl.stages, lay.stage_bytes, pieces(P), packed(P));
    } else {
      draw_warps(p, smem, pl, dfull, dempty, dt);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = threadIdx.x / CONSUMERS, wtid = threadIdx.x % CONSUMERS;
  float* red = reinterpret_cast<float*>(smem + pl.red);
  Ring ring{smem_u32(smem + pl.ring), full, empty, pl.stages,
            lay.stage_bytes, 0};
  const PingPong turn{wg};
  if (wg == 1 && L > 0) turn.pass();  // warpgroup 0 takes the first turn
  // a thread's integral sums wait in shared memory while the pass runs, and
  // the tile's pointers are computed again after it: nothing of the point
  // lives in registers across the pass (ptxas spilled it there)
  float* sums = reinterpret_cast<float*>(smem + pl.sums) + threadIdx.x;
  int n = 0;
  for (int b = blockIdx.x; b < p.B; b += gridDim.x) {
#pragma unroll
    for (int r = 0; r < MAXJ; ++r) sums[r * TC_CONSUMERS] = 0.0f;
    for (int i = 0; i < p.npair; ++i, ++n) {
      int buf = n & 1;
      mbar_wait(dfull + 8 * buf, (uint32_t)((n >> 1) & 1));
      if (L > 0) {
        net_pass<P>(p, tile_of(smem, pl, lay, p, buf, wg), ring, wtid, turn);
      } else if (wtid < TILE) {
        const Tile s = tile_of(smem, pl, lay, p, buf, wg);
        s.u[wtid] = 0.0f;
        s.sux[wtid] = 0.0f;
      }
      asm volatile("" : "+r"(buf));
      const Tile s = tile_of(smem, pl, lay, p, buf, wg);
      named_sync(BAR_WG + wg, CONSUMERS);
      sample_weights(p, s, NWG * i + wg, p.T - p.t[b], p.f0[b], wtid);
      named_sync(BAR_WG + wg, CONSUMERS);
      float acc[MAXJ];
#pragma unroll
      for (int r = 0; r < MAXJ; ++r) acc[r] = sums[r * TC_CONSUMERS];
      accumulate(s, nx, wtid, acc);
#pragma unroll
      for (int r = 0; r < MAXJ; ++r) sums[r * TC_CONSUMERS] = acc[r];
      mbar_arrive(dempty + 8 * buf);
    }

    // the second warpgroup's sums to red; the first adds them and stores
    if (wg == 1)
#pragma unroll
      for (int r = 0; r < MAXJ; ++r) {
        const int j = wtid + r * CONSUMERS;
        if (j <= nx) red[j] = sums[r * TC_CONSUMERS];
      }
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
    if (wg == 0) {
      const float inv_m = 1.0f / (float)p.M;
      const float f0Tt = p.f0[b] * (p.T - p.t[b]);
      float* out = p.out + (size_t)b * (1 + nx);
#pragma unroll
      for (int r = 0; r < MAXJ; ++r) {
        const int j = wtid + r * CONSUMERS;
        if (j <= nx) {
          const float a = (sums[r * TC_CONSUMERS] + red[j]) * inv_m;
          out[j] = j == 0 ? a + f0Tt : a;
        }
      }
    }
    named_sync(BAR_CONSUMERS, TC_CONSUMERS);
  }
  if (wg == 0 && L > 0) turn.wait();  // the second warpgroup's last pass
}

using TcKernel = void (*)(const tc::Params);

// the kernel of a mode (1: bf16x3, 2: one bf16 pass, 3: highest), or null
TcKernel tc_kernel(int mode) {
  return mode == tc::MODE_BF16X3    ? integral_tc_kernel<3>
         : mode == tc::MODE_ONE_PASS ? integral_tc_kernel<1>
         : mode == tc::MODE_HIGHEST  ? integral_tc_kernel<6>
                                     : nullptr;
}

}  // namespace

extern "C" {

// limits the Python wrapper checks before a launch
int dpi_integral_hidden_width() { return H; }
int dpi_integral_max_nx() { return tc::TC_MAX_NX; }

// the plan of mode `mode` at (nx, L) into out[5]: stages (-1: none), saved
// derivatives in shared memory, normals in shared memory, shared memory
// bytes, global scratch floats per block
void dpi_integral_tc_plan(int nx, int L, int mode, long long* out) {
  const tc::Layout lay = integral_layout(nx, tc::passes_of(mode));
  const tc::GPlan pl = tc::choose_gplan(nx, L, lay);
  out[0] = pl.stages;
  out[1] = pl.save_smem;
  out[2] = pl.dw_smem;
  out[3] = (long long)pl.total;
  out[4] = (long long)tc::scratch_floats(pl, lay, L);
}

// global scratch (bytes) dpi_integral_tc needs at any B and mode: the saved
// derivatives and normals its plans keep out of shared memory (0: none;
// -1: no plan)
long long dpi_integral_tc_scratch_bytes(int nx, int L) {
  if (nx < 1 || nx > tc::TC_MAX_NX) return -1;
  long long most = 0;
  for (int mode = tc::MODE_BF16X3; mode <= tc::MODE_HIGHEST; ++mode) {
    const tc::Layout lay = integral_layout(nx, tc::passes_of(mode));
    const tc::GPlan pl = tc::choose_gplan(nx, L, lay);
    if (pl.stages < 0) return -1;
    const size_t f = tc::scratch_floats(pl, lay, L);
    if (f == 0) continue;
    const int grid = tc::persistent_grid(tc_kernel(mode), pl.total, 1 << 30);
    if (grid < 0) return -1;
    const long long b = (long long)grid * f * 4;
    most = b > most ? b : most;
  }
  return most;
}

// The kernel (mode 1: bf16x3, 2: one bf16 pass, 3: highest); `img`, `vec`
// from ops/kernels.py:pack_mlp_tc (three pieces under highest). Launches on
// `stream`; returns 0, a CUDA error or one of dpi::tc::ERR_*.
int dpi_integral_tc(const float* t, const float* x, const float* f0,
                    const void* img, const float* vec, const float* u01,
                    const float* noise, float* scratch, float* out, int B,
                    int M, int nx, int L, int has_net, int anti, int mode,
                    unsigned long long seed, float T, float alpha_sqrt,
                    float k, float c0, void* stream) {
  using namespace dpi::tc;
  auto* kernel = tc_kernel(mode);
  if (!kernel) return ERR_BAD_MODE;
  if ((has_net && L < 1) || nx < 1 || nx > TC_MAX_NX) return ERR_NO_PLAN;
  const int Ln = has_net ? L : 0;
  const Layout lay = integral_layout(nx, passes_of(mode));
  const GPlan pl = choose_gplan(nx, Ln, lay);
  if (pl.stages < 0) return ERR_NO_PLAN;
  if (scratch_floats(pl, lay, Ln) > 0 && !scratch) return ERR_NO_SCRATCH;
  const int grid = persistent_grid(kernel, pl.total, B);
  if (grid < 1) return ERR_GRID;
  dpi::tc::Params p;
  p.t = t; p.x = x; p.g0 = nullptr; p.f0 = f0;
  p.img = static_cast<const __nv_bfloat16*>(img); p.vec = vec;
  p.u01 = u01; p.noise_t = nullptr; p.noise_i = noise;
  p.scratch = scratch; p.out = out;
  p.B = B; p.M = M; p.nx = nx; p.L = Ln; p.has_net = has_net;
  p.anti = anti; p.mode = mode;
  p.Md = anti ? M / 2 : M;
  p.npair = ((M + TILE - 1) / TILE + 1) / 2;
  p.hw = H;
  p.lay = lay; p.plan = pl;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  p.T = T; p.alpha_sqrt = alpha_sqrt; p.k = k; p.c0 = c0;
  kernel<<<grid, TC_THREADS, pl.total, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
