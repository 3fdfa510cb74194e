// Grouped GEMM over rows sorted by expert (Hopper, sm_90a).
//
// Replaces `lax.ragged_dot` with `group_sizes`, the two expert products of
// the MoE block (src/repro/models/moe.py:116 and :120), and with the
// `swiglu` flag the first product together with the silu x up that follows
// it (:116-119).  `ragged_dot` is an XLA op, not a Pallas kernel; it gets a
// kernel written by hand all the same, because its plain version cannot sit
// on the card's main path: slicing per expert needs the row counts on the
// host (a sync that a CUDA graph capture refuses), and one fixed-shape
// product against every expert computes and buffers E / k times the work.
//
// It computes h (M, N) = for each expert e, rows offsets[e] ..
// offsets[e + 1] of x (M, K) times w[e] (K, N), with an fp32 accumulator
// rounded once to x's dtype (where ragged_dot rounds).  With `swiglu` the
// output is (M, F), F = N / 2: silu(h[:, :F]) * h[:, F:], rounded where the
// JAX block rounds: h to bf16, silu in fp32 as x / (1 + expf(-x)) (PyTorch's
// CUDA formula; built without --use_fast_math) rounded to bf16, then the
// product of the two bf16 values rounded to bf16 (fp32: no roundings).
// Rows outside [offsets[0], offsets[E]) belong to no expert and are written
// as zeros (the MoE block parks dropped pairs there).  The offsets are read
// on the card, so the grid is fixed by the shapes alone and the launch can
// be captured.  No atomics, no split over K: a replay gives the same bits.
//
// What bounds it on an H100.  2 M K N operations on (active experts x K x N
// + M x K) input and M x N output elements.  At decode (M = 64 rows over
// about 52 of qwen3-moe's 128 experts) the weights of the active experts,
// 1.95 GB a layer, are the whole cost: bound by bytes at 3.35 TB/s.  At a
// batch-8 len256 prefill (M = 16384, every expert active, about 128 rows
// each) the weights are still most of the bytes (w1: 3.2 GB, 0.96 ms,
// against 0.42 ms of tensor-core work), so the design goal there is to read
// each weight strip once a call.
//
// Three variants; kernel.py::plan picks one from dtype and shape.
//   * wgmma_tma (bf16, many rows an expert: the prefill chunks).  One
//     block of three warpgroups per (N tile of 128 columns of w, expert),
//     launched with the N tiles of one expert next to each other so that
//     their shared x rows come from L2; one fits an SM, and the hardware
//     starts the next where one ends, which balances experts of unequal
//     rows better than a persistent block walking a fixed share of them
//     (the engine's routing of random weights puts several hundred rows on
//     some experts and none on others).  A block holds all its expert's
//     rows, up to 256, as four m64 row tiles, and streams the weight strip
//     w[e][:, n0:n0+128] once: each K stage of the strip is multiplied
//     against every live row tile before the next stage comes in.  An
//     expert with more rows loops over groups of 256 and reads its strip
//     once per group.  One producer thread issues TMA loads (3-D tensor
//     maps: x as (K, M, 1), w as (N, K, E), 128-byte swizzle) of 64 x 64
//     boxes, one per live row tile and two for the strip, into a ring of 4
//     stages with a full and an empty mbarrier each, and runs on into the
//     next row group while the last one is stored.  Two consumer
//     warpgroups (setmaxnreg 232; the producer 40) each own row tiles
//     {wg, wg + 2} and run wgmma m64n128k16 (A K-major, B N-major through
//     the transpose bit) on the stage that has arrived, one stage of
//     products in flight.  A row tile past the
//     expert's last row is neither loaded nor multiplied; rows of a live
//     tile past it belong to the next expert and are multiplied but never
//     stored.  With `swiglu` the strip's second box is columns F + n0 (the
//     up half) instead of n0 + 64, so one product yields a gate tile in
//     accumulator registers 0-31 and its up tile in 32-63 of the same
//     thread, and the epilogue writes only silu(gate) * up.  Building
//     blocks: ../../csrc/hopper.cuh.
//   * mma (bf16, few rows an expert: decode and verify, where the weights
//     of the active experts are read once anyway).  One block per (N tile
//     of 128 columns, expert); 4 warps as 2 x 2, each a 32 x 64 piece of a
//     64-row tile; mma.sync m16n8k16 with fp32 accumulators
//     (../../csrc/mma_tile.cuh); K tiles of 32 staged by 16-byte cp.async
//     in a 3-stage ring (x rows zero-filled past the expert's last row and
//     past K); rows padded by 16 bytes so ldmatrix reads A and (transposed)
//     B without bank conflicts.  A warp whose 32 rows are all past the
//     expert's last row skips its products.  With `swiglu` the tile's 128
//     columns are 64 gate and 64 up columns, and each warp takes 32 of each.
//   * simt (fp32, the fp32 reference configs): CUDA-core FMAs, 64 x 64
//     tiles of 256 threads, 4 x 4 outputs a thread (with `swiglu` 2 gate and
//     2 up columns), K tiles of 16 staged through registers into shared
//     memory; any K and N.
// bf16 needs K and N multiples of 8 (with `swiglu` N a multiple of 16) and
// 16-byte aligned operands (the wrapper checks).
//
// The backward (training) has two variants for each of its two products,
// dgrad (dx = dy w[e]^T) and wgrad (dw[e] = x_e^T dy_e), below the
// forward: `gmm_{dgrad,wgrad}_wgmma_tma_kernel` (bf16, any rows an expert:
// warp-specialised TMA ring and wgmma m64n256k16; dgrad over
// row-tile slots found on the card, wgrad persistent with the ragged last
// stage zeroed in shared memory) and `_simt_kernel` (fp32).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes; the driver's
//             cuTensorMapEncodeTiled is fetched at run time).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/hopper.cuh"
#include "../../csrc/launch_status.cuh"
#include "../../csrc/mma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

// variant codes, as kernel.py::VARIANTS numbers them
enum Variant { kSimt = 0, kMma = 1, kWgmmaTma = 2 };

// The row range of expert e, clamped into [0, M].
__device__ __forceinline__ void expert_rows(const int* offsets, int e, int M,
                                            int& lo, int& hi) {
  lo = min(max(offsets[e], 0), M);
  hi = min(max(offsets[e + 1], lo), M);
}

// Zero rows [0, offsets[0]) and [offsets[E], M) of output columns
// c0 .. c0 + width - 1 (of `cols`), with threads tid of n.
template <typename T>
__device__ void zero_tail(T* out, const int* offsets, int M, int cols, int E,
                          int c0, int width, int tid, int n) {
  const int lo = min(max(offsets[0], 0), M);
  const int hi = min(max(offsets[E], lo), M);
  const int w = min(width, cols - c0);
  const int rows = lo + (M - hi);
  for (int i = tid; i < rows * w; i += n) {
    const int r = i / w, c = i % w;
    const int row = r < lo ? r : hi + (r - lo);
    out[(long long)row * cols + c0 + c] = T(0.f);
  }
}

// silu(g) * u, rounded where the JAX block rounds (see the top): bf16
__device__ __forceinline__ float silu_mul(bf16 g, bf16 u) {
  const float gf = __bfloat162float(g);
  const bf16 s = __float2bfloat16_rn(gf / (1.f + expf(-gf)));
  return __bfloat162float(s) * __bfloat162float(u);
}

// a pair of bf16 outputs from two (gate, up) pairs of fp32 sums
__device__ __forceinline__ __nv_bfloat162 swiglu_pair(float g0, float g1,
                                                      float u0, float u1) {
  return __floats2bfloat162_rn(
      silu_mul(__float2bfloat16_rn(g0), __float2bfloat16_rn(u0)),
      silu_mul(__float2bfloat16_rn(g1), __float2bfloat16_rn(u1)));
}

// ---------------------------------------------------------------------------
// bf16, few rows an expert: mma.sync.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 128, BK = 32, STAGES = 3, THREADS = 128;
constexpr int A_PITCH = BK + 8;    // bf16 per staged x row (80 bytes)
constexpr int B_PITCH = BN + 8;    // bf16 per staged w row (272 bytes)

struct Stage {
  bf16 a[BM * A_PITCH];
  bf16 b[BK * B_PITCH];
};

// w's column for staged column nc of a tile at n0 (the tile's output
// columns), and whether it lies in w: with SWIGLU columns 0-63 are gate
// columns n0 .., 64-127 up columns F + n0 ..
template <bool SWIGLU>
__device__ __forceinline__ bool w_col(int n0, int nc, int N, int& col) {
  if (!SWIGLU) {
    col = n0 + nc;
    return col < N;
  }
  const int F = N / 2, c = n0 + (nc & 63);
  col = nc < 64 ? c : F + c;
  return c < F;
}

template <bool SWIGLU>
__device__ __forceinline__ void load_stage(Stage& st, const bf16* x,
                                           const bf16* we, int m0, int hi,
                                           int k0, int n0, int K, int N) {
  const int t = threadIdx.x;
  // x: 64 rows x 4 chunks of 8
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int c = t + i * THREADS;
    const int r = c >> 2, kc = (c & 3) * 8;
    const bool ok = m0 + r < hi && k0 + kc < K;
    const bf16* src = ok ? x + (long long)(m0 + r) * K + k0 + kc : x;
    tile::cp_async16(st.a + r * A_PITCH + kc, src, ok ? 16 : 0);
  }
  // w[e]: 32 rows x 16 chunks of 8
#pragma unroll
  for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
    const int c = t + i * THREADS;
    const int r = c >> 4, nc = (c & 15) * 8;
    int col;
    const bool ok = w_col<SWIGLU>(n0, nc, N, col) && k0 + r < K;
    const bf16* src = ok ? we + (long long)(k0 + r) * N + col : we;
    tile::cp_async16(st.b + r * B_PITCH + nc, src, ok ? 16 : 0);
  }
}

// out (M, cols): cols = N, or F with SWIGLU, whose tiles are 64 wide
template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
    gmm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const int* __restrict__ offsets, bf16* __restrict__ out,
                   int M, int K, int N, int E) {
  constexpr int TN = SWIGLU ? BN / 2 : BN;   // output columns a tile
  const int cols = SWIGLU ? N / 2 : N;
  const int n0 = blockIdx.x * TN;
  const int e = blockIdx.y;
  if (e == E) {
    zero_tail(out, offsets, M, cols, E, n0, TN, threadIdx.x, blockDim.x);
    return;
  }
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  if (lo >= hi) return;

  __shared__ __align__(16) Stage stages[STAGES];
  const bf16* we = w + (long long)e * K * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int nk = (K + BK - 1) / BK;
  // ldmatrix lanes: A rows (lane & 15), k half (lane >> 4); B (transposed)
  // as mma_tile.cuh's fold reads V
  const int a_row = lane & 15, a_col = (lane >> 4) << 3;
  const int b_key = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = (lane >> 4) << 3;
  // the staged columns of the warp's four 16-column pairs: 64 in a row,
  // or with SWIGLU 32 gate then the 32 up columns that pair with them
  auto pair_col = [&](int np) {
    return SWIGLU ? (np >> 1) * 64 + wn * 32 + (np & 1) * 16
                  : wn * 64 + np * 16;
  };

  for (int m0 = lo; m0 < hi; m0 += BM) {
    const bool live = m0 + wm * 32 < hi;
    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        acc[mi][nt][0] = acc[mi][nt][1] = acc[mi][nt][2] = acc[mi][nt][3] =
            0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_stage<SWIGLU>(stages[s], x, we, m0, hi, s * BK, n0, K, N);
      tile::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tile::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int pre = kt + STAGES - 1;
      if (pre < nk)
        load_stage<SWIGLU>(stages[pre % STAGES], x, we, m0, hi, pre * BK,
                           n0, K, N);
      tile::cp_async_commit();
      if (!live) continue;
      const Stage& st = stages[kt % STAGES];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          tile::ldmatrix_x4(
              a[mi], st.a + (wm * 32 + mi * 16 + a_row) * A_PITCH + kk * 16 +
                         a_col);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          tile::ldmatrix_x4_trans(
              b, st.b + (kk * 16 + b_key) * B_PITCH + pair_col(np) + b_col);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            tile::mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
            tile::mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    tile::cp_async_wait<0>();
    __syncthreads();   // the next M tile's prologue refills the ring
    if (!live) continue;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mi * 16 + gid + 8 * half;
        if (row >= hi) continue;
        bf16* orow = out + (long long)row * cols;
#pragma unroll
        for (int nt = 0; nt < (SWIGLU ? 4 : 8); ++nt) {
          const float* g = acc[mi][nt] + 2 * half;
          if constexpr (SWIGLU) {
            const int col = n0 + wn * 32 + nt * 8 + 2 * tig;
            const float* u = acc[mi][nt + 4] + 2 * half;
            if (col < cols)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  swiglu_pair(g[0], g[1], u[0], u[1]);
          } else {
            const int col = n0 + wn * 64 + nt * 8 + 2 * tig;
            if (col < cols)
              *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                  __floats2bfloat162_rn(g[0], g[1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, many rows an expert: wgmma fed by TMA.
// ---------------------------------------------------------------------------

constexpr int WG_BM = 64;                  // rows of one wgmma row tile
constexpr int WG_TILES = 4;                // row tiles a group: 256 rows
constexpr int WG_ROWS = WG_BM * WG_TILES;
constexpr int WG_BN = 128;                 // w columns a block
constexpr int WG_BK = 64;
constexpr int WG_STAGES = 4;
constexpr int WG_THREADS = 384;   // warpgroups 0, 1: consumers; 2: producer
constexpr int WG_BOX = 64 * 64 * 2;        // one 64 x 64 TMA box, 8 KB
constexpr int WG_A_BYTES = WG_TILES * WG_BOX;
constexpr int WG_STAGE_BYTES = WG_A_BYTES + 2 * WG_BOX;   // 48 KB
constexpr int WG_SMEM = WG_STAGES * WG_STAGE_BYTES + 1024;  // + alignment
static_assert(WG_SMEM + 2 * WG_STAGES * 8 <= 232448,
              "wgmma_tma: shared memory over Hopper's 227 KB");

// One block per (N tile, expert): blockIdx.x the tile of TN output columns
// (w columns n0 .. n0 + 127, or with SWIGLU gate columns n0 .. n0 + 63 and
// up columns F + n0 ..), blockIdx.y the expert, E: the rows of no expert.
template <bool SWIGLU>
__global__ void __launch_bounds__(WG_THREADS, 1) gmm_wgmma_tma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const int* __restrict__ offsets, bf16* __restrict__ out, int M, int K,
    int N, int E) {
  using namespace hopper;
  constexpr int TN = SWIGLU ? WG_BN / 2 : WG_BN;
  const int cols = SWIGLU ? N / 2 : N;
  const int n0 = blockIdx.x * TN;
  const int b1 = SWIGLU ? cols + n0 : n0 + 64;   // the strip's second box
  const int e = blockIdx.y;
  if (e == E) {
    zero_tail(out, offsets, M, cols, E, n0, TN, threadIdx.x, blockDim.x);
    return;
  }
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  if (lo >= hi) return;

  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[WG_STAGES], empty[WG_STAGES];
  // each stage: four x boxes of 64 rows x 64 k (K-major, 128-byte rows),
  // then the strip as two 64 (k) x 64 (n) boxes (N-major); every box
  // starts 1024-byte aligned
  const uint32_t ring = (smem_addr(dyn_smem) + 1023u) & ~1023u;
  const int n_k = (K + WG_BK - 1) / WG_BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(smem_addr(&full[s]), 1);    // the producer's expect_tx
      mbar_init(smem_addr(&empty[s]), 8);   // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    regs_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;   // stages filled so far, over all row groups
      for (int g0 = lo; g0 < hi; g0 += WG_ROWS) {
        const int live = min(WG_TILES, (hi - g0 + WG_BM - 1) / WG_BM);
        for (int t = 0; t < n_k; ++t, ++it) {
          const int s = it % WG_STAGES;
          if (it >= WG_STAGES)    // wait until the consumers released it
            mbar_wait(smem_addr(&empty[s]), ((it / WG_STAGES) - 1) & 1);
          const uint32_t bar = smem_addr(&full[s]);
          const uint32_t st = ring + s * WG_STAGE_BYTES;
          mbar_expect_tx(bar, (live + 2) * WG_BOX);
          for (int j = 0; j < live; ++j)
            tma_load_3d(st + j * WG_BOX, &map_x, bar, t * WG_BK,
                        g0 + j * WG_BM, 0);
          tma_load_3d(st + WG_A_BYTES, &map_w, bar, n0, t * WG_BK, e);
          tma_load_3d(st + WG_A_BYTES + WG_BOX, &map_w, bar, b1, t * WG_BK,
                      e);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: row tiles wg and wg + 2 of each group ----
    regs_inc<232>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int w = (threadIdx.x % 128) / 32;
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[stage]));
    };
    float acc[2][64];
    int it = 0;     // stages consumed so far, over all row groups
    for (int g0 = lo; g0 < hi; g0 += WG_ROWS) {
      const int n_live = min(WG_TILES, (hi - g0 + WG_BM - 1) / WG_BM);
      const bool live[2] = {wg < n_live, wg + 2 < n_live};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
        fence_regs(acc[j]);
      }
      for (int t = 0; t < n_k; ++t, ++it) {
        const int s = it % WG_STAGES;
        mbar_wait(smem_addr(&full[s]), (it / WG_STAGES) & 1);
        const uint32_t st = ring + s * WG_STAGE_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < WG_BK / 16; ++kk) {
          const uint64_t db = sw128_desc(st + WG_A_BYTES + kk * 16 * 128,
                                         WG_BOX, 1024);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (live[j])
              wgmma_m64n128k16<0, 1>(
                  acc[j],
                  sw128_desc(st + (wg + 2 * j) * WG_BOX + kk * 32, 16, 1024),
                  db);
        }
        wgmma_commit();
        // the products of the previous stage are done: hand it back
        wgmma_wait<1>();
        if (t > 0) release((it - 1) % WG_STAGES);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < 2; ++j) fence_regs(acc[j]);
      release((it - 1) % WG_STAGES);

      // epilogue: straight from the registers, two adjacent columns a
      // store; rows past hi (the next expert's) are never stored
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (!live[j]) continue;
        const int r0 = g0 + (wg + 2 * j) * WG_BM + w * 16 + lane / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          if (row >= hi) continue;
          bf16* orow = out + (long long)row * cols;
#pragma unroll
          for (int q = 0; q < TN / 8; ++q) {
            const int col = n0 + 8 * q + (lane % 4) * 2;
            if (col >= cols) continue;
            const float* g = acc[j] + 4 * q + 2 * h;
            __nv_bfloat162* dst =
                reinterpret_cast<__nv_bfloat162*>(orow + col);
            if constexpr (SWIGLU)
              *dst = swiglu_pair(g[0], g[1], g[32], g[33]);
            else
              *dst = __floats2bfloat162_rn(g[0], g[1]);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16, FTHREADS = 256;

template <bool SWIGLU>
__global__ void __launch_bounds__(FTHREADS)
    gmm_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int M, int K, int N, int E) {
  constexpr int TN = SWIGLU ? FN / 2 : FN;   // output columns a tile
  const int cols = SWIGLU ? N / 2 : N;
  const int n0 = blockIdx.x * TN;
  const int e = blockIdx.y;
  if (e == E) {
    zero_tail(out, offsets, M, cols, E, n0, TN, threadIdx.x, blockDim.x);
    return;
  }
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  if (lo >= hi) return;

  __shared__ __align__(16) float as[FK][FM];   // x tile, transposed
  __shared__ __align__(16) float bs[FK][FN];   // with SWIGLU: gate | up
  const float* we = w + (long long)e * K * N;
  const int t = threadIdx.x;
  const int ty = t >> 4, tx = t & 15;
  for (int m0 = lo; m0 < hi; m0 += FM) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += FK) {
      // x: 64 rows x 16 depth, 4 a thread; w: 16 rows x 64 columns
#pragma unroll
      for (int i = 0; i < FM * FK / FTHREADS; ++i) {
        const int c = t + i * FTHREADS;
        const int r = c / FK, k = c % FK;
        as[k][r] = (m0 + r < hi && k0 + k < K)
                       ? x[(long long)(m0 + r) * K + k0 + k]
                       : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FK * FN / FTHREADS; ++i) {
        const int c = t + i * FTHREADS;
        const int r = c / FN, n = c % FN;
        int col = n0 + n;
        bool ok = col < N;
        if constexpr (SWIGLU) {
          const int g = n0 + (n & 31);
          col = n < 32 ? g : cols + g;
          ok = g < cols;
        }
        bs[r][n] = (k0 + r < K && ok) ? we[(long long)(k0 + r) * N + col]
                                      : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float bv[4];
        if constexpr (SWIGLU) {
          const float2 g = *reinterpret_cast<const float2*>(&bs[k][tx * 2]);
          const float2 u =
              *reinterpret_cast<const float2*>(&bs[k][32 + tx * 2]);
          bv[0] = g.x, bv[1] = g.y, bv[2] = u.x, bv[3] = u.y;
        } else {
          const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
          bv[0] = b.x, bv[1] = b.y, bv[2] = b.z, bv[3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= hi) continue;
      float* orow = out + (long long)row * cols;
      if constexpr (SWIGLU) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + tx * 2 + j;
          const float g = acc[i][j];
          if (col < cols) orow[col] = g / (1.f + expf(-g)) * acc[i][j + 2];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx * 4 + j;
          if (col < cols) orow[col] = acc[i][j];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers.
// ---------------------------------------------------------------------------

template <bool SWIGLU>
int launch_wgmma(int dev, const void* x, const void* w, const void* offsets,
                 void* out, int M, int K, int N, int E,
                 const unsigned long long* tma, cudaStream_t s) {
  using namespace launch_status;
  // the boxes the kernel's ring is laid out for: 64 x 64 for x and w
  if (tma == nullptr || tma[5] != WG_BK || tma[6] != WG_BM || tma[7] != 1 ||
      tma[13] != 64 || tma[14] != WG_BK || tma[15] != 1)
    return fail(kArgs);
  if (hopper::tensor_map_encoder() == nullptr) return fail(kEncoder);
  CUtensorMap map_x, map_w;
  int res = hopper::encode_map(&map_x, x, tma);
  if (res == 0) res = hopper::encode_map(&map_w, w, tma + 8);
  if (res != 0) return fail(kEncode, (cudaError_t)res);
  auto kernel = gmm_wgmma_tma_kernel<SWIGLU>;
  // once per device: the attribute call is not one a graph capture records
  static bool smem_set[kMaxDevices] = {};
  if (!smem_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
    if (err != cudaSuccess) return fail(kSmem, err);
    smem_set[dev] = true;
  }
  const int tn = SWIGLU ? WG_BN / 2 : WG_BN;
  // blocks in launch order: the N tiles of one expert next to each other,
  // so their shared x rows come from L2; one block an SM (its shared
  // memory allows no second), and the next one starts where one ends
  dim3 grid(((SWIGLU ? N / 2 : N) + tn - 1) / tn, E + 1);
  kernel<<<grid, WG_THREADS, WG_SMEM, s>>>(
      map_x, map_w, static_cast<const int*>(offsets), static_cast<bf16*>(out),
      M, K, N, E);
  return after_launch();
}

template <bool SWIGLU>
int launch(int dev, int variant, const void* x, const void* w, const int* off,
           void* out, int M, int K, int N, int E,
           const unsigned long long* tma, cudaStream_t s) {
  const int cols = SWIGLU ? N / 2 : N;
  switch (variant) {
    case kSimt: {
      const int tn = SWIGLU ? FN / 2 : FN;
      dim3 grid((cols + tn - 1) / tn, E + 1);
      gmm_simt_kernel<SWIGLU><<<grid, FTHREADS, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), off,
          static_cast<float*>(out), M, K, N, E);
      return launch_status::after_launch();
    }
    case kMma: {
      const int tn = SWIGLU ? BN / 2 : BN;
      dim3 grid((cols + tn - 1) / tn, E + 1);
      gmm_mma_kernel<SWIGLU><<<grid, THREADS, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w), off,
          static_cast<bf16*>(out), M, K, N, E);
      return launch_status::after_launch();
    }
    case kWgmmaTma:
      return launch_wgmma<SWIGLU>(dev, x, w, off, out, M, K, N, E, tma, s);
  }
  return launch_status::fail(launch_status::kArgs);
}

// ---------------------------------------------------------------------------
// Backward: dgrad and wgrad (training; bf16 on wgmma fed by TMA, fp32 simt).
// ---------------------------------------------------------------------------
//
// The MoE block's training step differentiates both expert products, as
// JAX's autodiff of ragged_dot does (src/repro/models/moe.py:116,120; the
// JAX package has no kernel for them, XLA transposes the op):
//   * dgrad: dx (M, K) = for each expert e, rows offsets[e] .. offsets[e+1]
//     of dy (M, N) times w[e]^T, w[e] (K, N) read in place; rows of no
//     expert are zero, as in the forward.
//   * wgrad: dw (E, K, N) = for each expert e, x[rows]^T (K, rows) times
//     dy[rows] (rows, N): a reduction over the expert's rows.  An expert
//     with no rows gets exact zeros.
// Both keep an fp32 accumulator rounded once to the operands' dtype.  One
// block owns each output tile and walks its reduction in one fixed order:
// no atomics and no split over blocks, so a replayed or resumed step gives
// the same bits.
//
// What bounds them on an H100: each is 2 M K N operations (the forward's),
// on the tensor cores at 989 TFLOP/s in bf16; the bytes are the forward's
// too (the weights once, x or dy once per output tile column), so at a
// training batch (M = 65536 rows over 128 experts at qwen3-moe's width)
// the operations bound them.  Two variants each, picked by
// kernel.py::grad_route from the dtype: `wgmma_tma` (bf16, any rows an
// expert; below) and `simt` (fp32, after it).

// ---------------------------------------------------------------------------
// Backward, bf16 (training): wgmma fed by TMA.
// ---------------------------------------------------------------------------
//
// Both kernels are warp-specialised as the forward's wgmma_tma: one producer
// thread issues TMA loads of 64 x 64 boxes (128-byte swizzle) into a ring of
// 4 stages with a full and an empty mbarrier each; two consumer warpgroups
// (setmaxnreg 232; the producer 40) each own 64 output rows and run wgmma
// m64n256k16 on the stage that has arrived, one stage of products in
// flight.  A stage is depth 64: two A boxes (one per consumer warpgroup)
// and four B boxes (256 output columns), 48 KB.
//   * dgrad, dx = dy w[e]^T.  A is dy (M, N), contiguous along the
//     reduction n: K-major.  B is w[e] read in place; its output index is
//     k and it is contiguous along n, so it is K-major too (no transpose
//     bit): the four boxes of 64 rows of w[e] lie one after the other as
//     256 rows of 128 bytes.  Maps: dy as (N, M, 1), w as (N, K, E), read
//     at (n, k, e).  A block owns 128 rows of one expert x 256 columns of
//     K.  Blocks are laid out over (K tile, row-tile slot), K tiles
//     fastest, with ceil(M / 128) + E slots: each block finds its expert
//     and first row from the offsets on the card (a block-wide scan of
//     ceil(rows_e / 128) over the experts) and exits past the last tile.
//     So a hot expert's rows spread over every SM, the grid is fixed by
//     the shapes alone (a graph can capture the launch), the K tiles of a
//     row tile share its dy rows through L2 and an expert's row tiles find
//     w[e] there.  Rows of a live tile past the expert's last row are
//     multiplied but never stored; one more slot zeroes the rows outside
//     [offsets[0], offsets[E]).
//   * wgrad, dw[e] = x_e^T dy_e.  A is x_e^T, contiguous along its output
//     index k: MN-major (transpose bit on A).  B is dy_e, contiguous along
//     its output index n: MN-major, as the forward's w.  Maps: x as (K, M,
//     1), dy as (N, M, 1).  Output tiles of 128 rows of K x 256 columns of
//     N, the expert slowest, so the tiles in flight share an expert's x
//     and dy rows through L2; persistent: one block an SM takes tile after
//     tile from a counter on the card, and its producer loads the next
//     tile's first stages while the consumers store the last one (an
//     expert's tiles are short: 8 stages at 512 rows).  Each tile sums its expert's
//     rows 64 at a time in one fixed order: no split over rows, no
//     atomics, so a replay or a resumed run gives the same bits.  TMA
//     zero-fills only past the tensor's edge, so the last stage of an
//     expert holds the next expert's rows: before its products the
//     consumers zero those rows in all six boxes (in an MN-major box one
//     128-byte line is one row, whatever the swizzle), then fence the
//     generic writes for the async proxy and meet at a named barrier.  An
//     expert with no rows gets exact zeros and reads nothing.
// What bounds them: the forward's 2 M K N operations (1.67 ms at w1, 0.83
// at w2 for qwen3-moe's training step at 989 TFLOP/s); the bytes are below
// that (wgrad writes every expert's dw, 3.2 GB at w1: 0.96 ms).

constexpr int BW_BM = 128;                  // output rows a block
constexpr int BW_BN = 256;                  // output columns a block
constexpr int BW_BK = 64;                   // depth a stage
constexpr int BW_THREADS = 384;   // warpgroups 0, 1: consumers; 2: producer
constexpr int BW_BOX = 64 * 64 * 2;         // one 64 x 64 TMA box, 8 KB
constexpr int BW_A_BYTES = 2 * BW_BOX;
constexpr int BW_STAGE_BYTES = BW_A_BYTES + 4 * BW_BOX;   // 48 KB
constexpr int DG_STAGES = 4, WR_STAGES = 3;
// dgrad: the ring; wgrad: the ring and each consumer warpgroup's 64 x 256
// output staging (four boxes); + 1024 for alignment
constexpr int DG_SMEM = DG_STAGES * BW_STAGE_BYTES + 1024;
constexpr int WR_OUT_BYTES = 4 * BW_BOX;
constexpr int WR_SMEM = WR_STAGES * BW_STAGE_BYTES + 2 * WR_OUT_BYTES + 1024;
static_assert(DG_SMEM + 2 * DG_STAGES * 8 + 160 <= 232448 &&
                  WR_SMEM + 2 * WR_STAGES * 8 <= 232448,
              "backward wgmma_tma: shared memory over Hopper's 227 KB");

// The expert e, first row r0 and the expert's end hi of row tile `slot`,
// when each expert's rows are cut into tiles of BW_BM in expert order;
// false past the last tile.  Every thread of the block calls it: a
// block-wide scan of the tile counts, read from the offsets on the card.
__device__ bool slot_tile(const int* offsets, int M, int E, int slot, int& e,
                          int& r0, int& hi) {
  __shared__ int warp_sum[32], found[3];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) found[0] = -1;
  int base = 0;   // tiles of the experts before this chunk
  for (int c0 = 0; c0 < E && base <= slot; c0 += blockDim.x) {
    int lo = 0, end = 0;
    if (c0 + tid < E) expert_rows(offsets, c0 + tid, M, lo, end);
    const int n = (end - lo + BW_BM - 1) / BW_BM;
    int incl = n;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int before = base, total = 0;
    for (int w = 0; w < (int)blockDim.x / 32; ++w) {
      before += w < warp ? warp_sum[w] : 0;
      total += warp_sum[w];
    }
    const int start = before + incl - n;
    if (n > 0 && slot >= start && slot < start + n) {
      found[0] = c0 + tid;
      found[1] = lo + (slot - start) * BW_BM;
      found[2] = end;
    }
    base += total;
    __syncthreads();
  }
  e = found[0], r0 = found[1], hi = found[2];
  return e >= 0;
}

// The ring's mbarriers, set up by thread 0 before the block's barrier:
// full[s] takes the producer's expect_tx, empty[s] one arrival from each
// of `consumers` warps.
template <int S>
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty,
                                          int consumers) {
  using namespace hopper;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), consumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer's side of stage number `it`: wait until the consumers
// released it, announce `bytes`; returns its full barrier.
template <int S>
__device__ __forceinline__ uint32_t ring_fill(uint64_t* full, uint64_t* empty,
                                             int it, uint32_t bytes) {
  using namespace hopper;
  const int s = it % S;
  if (it >= S) mbar_wait(smem_addr(&empty[s]), ((it / S) - 1) & 1);
  const uint32_t bar = smem_addr(&full[s]);
  mbar_expect_tx(bar, bytes);
  return bar;
}

// a consumer warp hands stage number `it` back to the producer
template <int S>
__device__ __forceinline__ void ring_release(uint64_t* empty, int it) {
  __syncwarp();
  if (threadIdx.x % 32 == 0)
    hopper::mbar_arrive(hopper::smem_addr(&empty[it % S]));
}

// blockIdx.x = slot * K tiles + K tile; slot ceil(M / 128) + E: the rows of
// no expert
__global__ void __launch_bounds__(BW_THREADS, 1) gmm_dgrad_wgmma_tma_kernel(
    const __grid_constant__ CUtensorMap map_dy,
    const __grid_constant__ CUtensorMap map_w,
    const int* __restrict__ offsets, bf16* __restrict__ dx, int M, int K,
    int N, int E) {
  using namespace hopper;
  const int k_tiles = (K + BW_BN - 1) / BW_BN;
  const int c0 = (blockIdx.x % k_tiles) * BW_BN;
  const int slot = blockIdx.x / k_tiles;
  if (slot == (M + BW_BM - 1) / BW_BM + E) {
    zero_tail(dx, offsets, M, K, E, c0, BW_BN, threadIdx.x, blockDim.x);
    return;
  }
  int e, r0, hi;
  if (!slot_tile(offsets, M, E, slot, e, r0, hi)) return;
  // 64-row tiles with a row of the expert: a warpgroup with none sits out
  // (no branch around its products, which would serialise them)
  const int n_live = min(2, (hi - r0 + 63) / 64);

  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[DG_STAGES], empty[DG_STAGES];
  const uint32_t ring = (smem_addr(dyn_smem) + 1023u) & ~1023u;
  const int n_k = (N + BW_BK - 1) / BW_BK;
  ring_init<DG_STAGES>(full, empty, 4 * n_live);

  if (threadIdx.x >= 256) {
    // ---- producer: dy's live 64-row boxes, w[e]'s four 64-row boxes ----
    regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int t = 0; t < n_k; ++t) {
        const uint32_t bar =
            ring_fill<DG_STAGES>(full, empty, t, (n_live + 4) * BW_BOX);
        const uint32_t st = ring + (t % DG_STAGES) * BW_STAGE_BYTES;
        for (int j = 0; j < n_live; ++j)
          tma_load_3d(st + j * BW_BOX, &map_dy, bar, t * BW_BK, r0 + 64 * j,
                      0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_3d(st + BW_A_BYTES + j * BW_BOX, &map_w, bar, t * BW_BK,
                      c0 + 64 * j, e);
      }
    }
  } else if (threadIdx.x / 128 < n_live) {
    // ---- consumers: rows r0 + 64 wg .. of the tile ----
    regs_inc<232>();
    const int wg = threadIdx.x / 128;
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int t = 0; t < n_k; ++t) {
      const int s = t % DG_STAGES;
      mbar_wait(smem_addr(&full[s]), (t / DG_STAGES) & 1);
      const uint32_t st = ring + s * BW_STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BW_BK / 16; ++kk)
        wgmma_m64n256k16<0, 0>(
            acc, sw128_desc(st + wg * BW_BOX + kk * 32, 16, 1024),
            sw128_desc(st + BW_A_BYTES + kk * 32, 16, 1024));
      wgmma_commit();
      // the products of the previous stage are done: hand it back
      wgmma_wait<1>();
      if (t > 0) ring_release<DG_STAGES>(empty, t - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (n_k > 0) ring_release<DG_STAGES>(empty, n_k - 1);

    // epilogue: straight from the registers, two adjacent columns a store;
    // rows past hi (the next expert's) are never stored
    const int lane = threadIdx.x % 32, w = (threadIdx.x % 128) / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 64 * wg + w * 16 + lane / 4 + 8 * h;
      if (row >= hi) continue;
      bf16* orow = dx + (long long)row * K;
#pragma unroll
      for (int j = 0; j < BW_BN / 8; ++j) {
        const int col = c0 + 8 * j + (lane % 4) * 2;
        if (col < K)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

// Persistent over tiles (expert, K tile of 128 rows, N tile of 256
// columns), N tiles fastest, handed out in that order by a counter on the
// card (next_tile, zeroed before the launch): the producer takes the next
// tile when it starts one and passes it to the consumers through a
// two-slot queue in shared memory.  So the tiles in flight are always a
// window of consecutive tiles, as with one block a tile: the tiles of a
// popular expert, whose rows may not fit L2, run in step and share them,
// and no block waits on a fixed share of long tiles.  Stage and phase run
// on across tiles.  Each consumer warpgroup writes its 64 x 256 part of a
// tile as bf16 into its staging boxes (128-byte swizzle, as the map of dw
// reads them) and one of its threads stores them with TMA (clipped past K
// and N), asynchronously: the next tile's products run while the card
// writes dw, and the staging is reused only once that store has read it.
__global__ void __launch_bounds__(BW_THREADS, 1) gmm_wgrad_wgmma_tma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_dy,
    const __grid_constant__ CUtensorMap map_dw,
    const int* __restrict__ offsets, int* __restrict__ next_tile, int M,
    int K, int N, int E) {
  using namespace hopper;
  const int n_tiles = (N + BW_BN - 1) / BW_BN;
  const int per_e = n_tiles * ((K + BW_BM - 1) / BW_BM);
  const int tiles = per_e * E;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[WR_STAGES], empty[WR_STAGES];
  // the tile queue: the producer's tile numbers, each read by all 8
  // consumer warps before its slot is reused
  __shared__ __align__(8) uint64_t q_full[2], q_empty[2];
  __shared__ int q_tile[2];
  const uint32_t ring = (smem_addr(dyn_smem) + 1023u) & ~1023u;
  uint8_t* const ring_ptr = dyn_smem + (ring - smem_addr(dyn_smem));
  const uint32_t staging = ring + WR_STAGES * BW_STAGE_BYTES;
  if (threadIdx.x == 0)
    for (int q = 0; q < 2; ++q) {
      mbar_init(smem_addr(&q_full[q]), 1);
      mbar_init(smem_addr(&q_empty[q]), 8);
    }
  ring_init<WR_STAGES>(full, empty, 8);   // fences the inits, syncs

  if (threadIdx.x >= 256) {
    // ---- producer: x's two 64-column boxes, dy's four, 64 rows each ----
    regs_dec<40>();
    if (threadIdx.x == 256) {
      int it = 0;   // stages filled so far, over all tiles
      for (int i = 0;; ++i) {
        const int tile = atomicAdd(next_tile, 1), q = i & 1;
        if (i >= 2) mbar_wait(smem_addr(&q_empty[q]), ((i >> 1) - 1) & 1);
        q_tile[q] = tile;
        mbar_arrive(smem_addr(&q_full[q]));   // releases the write
        if (tile >= tiles) break;
        const int e = tile / per_e, r = tile % per_e;
        const int k0 = (r / n_tiles) * BW_BM, n0 = (r % n_tiles) * BW_BN;
        int lo, hi;
        expert_rows(offsets, e, M, lo, hi);
        for (int m = lo; m < hi; m += BW_BK, ++it) {
          const uint32_t bar =
              ring_fill<WR_STAGES>(full, empty, it, 6 * BW_BOX);
          const uint32_t st = ring + (it % WR_STAGES) * BW_STAGE_BYTES;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load_3d(st + j * BW_BOX, &map_x, bar, k0 + 64 * j, m, 0);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_3d(st + BW_A_BYTES + j * BW_BOX, &map_dy, bar,
                        n0 + 64 * j, m, 0);
        }
      }
    }
  } else {
    // ---- consumers: rows k0 + 64 wg .. of each tile ----
    regs_inc<232>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int w = (threadIdx.x % 128) / 32;
    const bool leader = threadIdx.x % 128 == 0;   // issues wg's stores
    const uint32_t out = staging + wg * WR_OUT_BYTES;
    uint8_t* const out_ptr = ring_ptr + (out - ring);
    float acc[128];
    int it = 0;     // stages consumed so far, over all tiles
    for (int i = 0;; ++i) {
      const int q = i & 1;
      mbar_wait(smem_addr(&q_full[q]), (i >> 1) & 1);
      const int tile = q_tile[q];
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&q_empty[q]));
      if (tile >= tiles) break;
      const int e = tile / per_e, r = tile % per_e;
      const int k0 = (r / n_tiles) * BW_BM, n0 = (r % n_tiles) * BW_BN;
      int lo, hi;
      expert_rows(offsets, e, M, lo, hi);
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      fence_regs(acc);
      const int it0 = it;
      for (int m = lo; m < hi; m += BW_BK, ++it) {
        const int s = it % WR_STAGES;
        mbar_wait(smem_addr(&full[s]), (it / WR_STAGES) & 1);
        const uint32_t st = ring + s * BW_STAGE_BYTES;
        if (hi - m < BW_BK) {
          // the next expert's rows (or TMA's zeros past M) in the last
          // stage: zero rows hi - m .. 63 of its six boxes, 16 bytes a store
          const int keep = hi - m, lines = (BW_BK - keep) * 8;
          uint8_t* base = ring_ptr + s * BW_STAGE_BYTES;
          for (int i = threadIdx.x; i < 6 * lines; i += 256) {
            const int box = i / lines, rem = i % lines;
            reinterpret_cast<uint4*>(base + box * BW_BOX +
                                     (keep + rem / 8) * 128)[rem % 8] =
                make_uint4(0u, 0u, 0u, 0u);
          }
          // the generic writes before the async proxy's reads, and every
          // consumer's before any product
          fence_async_smem();
          asm volatile("bar.sync 1, 256;" ::: "memory");
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BW_BK / 16; ++kk)
          wgmma_m64n256k16<1, 1>(
              acc, sw128_desc(st + wg * BW_BOX + kk * 2048, BW_BOX, 1024),
              sw128_desc(st + BW_A_BYTES + kk * 2048, BW_BOX, 1024));
        wgmma_commit();
        // the products of the previous stage are done: hand it back
        wgmma_wait<1>();
        if (it > it0) ring_release<WR_STAGES>(empty, it - 1);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (it > it0) ring_release<WR_STAGES>(empty, it - 1);

      // epilogue: the staging is free once the last tile's store read it
      if (leader) tma_store_wait<true>();
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      // register pair (4 j + 2 h, + 1): row 16 w + lane / 4 + 8 h, columns
      // 8 j + 2 (lane % 4) + {0, 1}, in box j / 8 at 16-byte chunk j % 8,
      // swizzled by the row: conflict-free, one 4-byte store a pair
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = w * 16 + lane / 4 + 8 * h;
#pragma unroll
        for (int j = 0; j < BW_BN / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              out_ptr + (j / 8) * BW_BOX + row * 128 +
              (((j % 8) ^ (row % 8)) * 16) + (lane % 4) * 4) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
      fence_async_smem();
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      if (leader) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_store_3d(&map_dw, out + j * BW_BOX, n0 + 64 * j, k0 + 64 * wg,
                       e);
        tma_store_commit();
      }
    }
    if (leader) tma_store_wait<false>();
  }
}

// fp32 on the CUDA cores: 64 x 64 output tiles, 4 x 4 a thread, depth 16
// staged through registers; any K and N.
__global__ void __launch_bounds__(FTHREADS)
    gmm_dgrad_simt_kernel(const float* __restrict__ dy,
                          const float* __restrict__ w,
                          const int* __restrict__ offsets,
                          float* __restrict__ dx, int M, int K, int N,
                          int E) {
  const int c0 = blockIdx.x * FN;
  const int e = blockIdx.y;
  if (e == E) {
    zero_tail(dx, offsets, M, K, E, c0, FN, threadIdx.x, blockDim.x);
    return;
  }
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  if (lo >= hi) return;
  __shared__ __align__(16) float as[FK][FM];   // dy tile, transposed
  __shared__ __align__(16) float bs[FK][FN];   // w[e] tile, transposed
  const float* we = w + (long long)e * K * N;
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  for (int m0 = lo; m0 < hi; m0 += FM) {
    float acc[4][4] = {};
    for (int n0 = 0; n0 < N; n0 += FK) {
#pragma unroll
      for (int i = 0; i < FM * FK / FTHREADS; ++i) {
        const int c = t + i * FTHREADS;
        const int r = c / FK, k = c % FK;
        as[k][r] = (m0 + r < hi && n0 + k < N)
                       ? dy[(long long)(m0 + r) * N + n0 + k]
                       : 0.f;
      }
#pragma unroll
      for (int i = 0; i < FK * FN / FTHREADS; ++i) {
        const int c = t + i * FTHREADS;
        const int r = c / FK, k = c % FK;     // r: output column (w's row)
        bs[k][r] = (c0 + r < K && n0 + k < N)
                       ? we[(long long)(c0 + r) * N + n0 + k]
                       : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&as[k][ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&bs[k][tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row >= hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx * 4 + j;
        if (col < K) dx[(long long)row * K + col] = acc[i][j];
      }
    }
  }
}

__global__ void __launch_bounds__(FTHREADS)
    gmm_wgrad_simt_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          const int* __restrict__ offsets,
                          float* __restrict__ dw, int M, int K, int N,
                          int E) {
  const int n0 = blockIdx.x * FN, k0 = blockIdx.y * FM;
  const int e = blockIdx.z;
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  __shared__ __align__(16) float as[FK][FM];   // x rows: [m][k]
  __shared__ __align__(16) float bs[FK][FN];   // dy rows: [m][n]
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  float acc[4][4] = {};
  for (int m0 = lo; m0 < hi; m0 += FK) {
#pragma unroll
    for (int i = 0; i < FK * FM / FTHREADS; ++i) {
      const int c = t + i * FTHREADS;
      const int r = c / FM, k = c % FM;
      as[r][k] = (m0 + r < hi && k0 + k < K)
                     ? x[(long long)(m0 + r) * K + k0 + k]
                     : 0.f;
      bs[r][k] = (m0 + r < hi && n0 + k < N)
                     ? dy[(long long)(m0 + r) * N + n0 + k]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FK; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&as[r][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&bs[r][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* dwe = dw + (long long)e * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) dwe[(long long)row * N + col] = acc[i][j];
    }
  }
}

// the backward's wgmma_tma launches.  tma: the tensor-map arguments
// (kernel.py::grad_tma_args), 64 x 64 boxes: dgrad dy and w; wgrad x, dy
// and dw (out).  counter: wgrad's tile counter, one int on the card.
int launch_grad_wgmma(int dev, int kind, const void* a, const void* b,
                      const int* off, void* out, int M, int K, int N, int E,
                      const unsigned long long* tma, void* counter,
                      cudaStream_t s) {
  using namespace launch_status;
  const int n_maps = kind == 0 ? 2 : 3;
  CUtensorMap maps[3];
  if (tma == nullptr) return fail(kArgs);
  const void* bases[3] = {a, b, out};
  for (int i = 0; i < n_maps; ++i) {
    const unsigned long long* arg = tma + 8 * i;
    if (arg[5] != 64 || arg[6] != 64 || arg[7] != 1) return fail(kArgs);
  }
  if (hopper::tensor_map_encoder() == nullptr) return fail(kEncoder);
  for (int i = 0; i < n_maps; ++i)
    if (const int res = hopper::encode_map(&maps[i], bases[i], tma + 8 * i))
      return fail(kEncode, (cudaError_t)res);
  // once per device and kernel: neither call is one a graph capture records
  static bool smem_set[2][kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  cudaError_t err;
  if (!smem_set[kind][dev]) {
    const cudaFuncAttribute smem = cudaFuncAttributeMaxDynamicSharedMemorySize;
    err = kind == 0
              ? cudaFuncSetAttribute(gmm_dgrad_wgmma_tma_kernel, smem, DG_SMEM)
              : cudaFuncSetAttribute(gmm_wgrad_wgmma_tma_kernel, smem, WR_SMEM);
    if (err != cudaSuccess) return fail(kSmem, err);
    smem_set[kind][dev] = true;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return fail(kQuery, err);
  }
  if (kind == 0) {
    // (K tile, slot), K tiles fastest; the last slot: the rows of no expert
    const long long blocks = (long long)((K + BW_BN - 1) / BW_BN) *
                             ((M + BW_BM - 1) / BW_BM + E + 1);
    if (blocks > 0x7fffffff) return fail(kArgs);
    gmm_dgrad_wgmma_tma_kernel<<<(unsigned)blocks, BW_THREADS, DG_SMEM, s>>>(
        maps[0], maps[1], off, static_cast<bf16*>(out), M, K, N, E);
  } else {
    const long long tiles = (long long)((N + BW_BN - 1) / BW_BN) *
                            ((K + BW_BM - 1) / BW_BM) * E;
    if (tiles > 0x7fffffff - sms[dev] || counter == nullptr)
      return fail(kArgs);
    err = cudaMemsetAsync(counter, 0, sizeof(int), s);
    if (err != cudaSuccess) return fail(kMemset, err);
    // one block an SM (its shared memory allows no second), or fewer
    gmm_wgrad_wgmma_tma_kernel<<<(unsigned)(tiles < sms[dev] ? tiles
                                                              : sms[dev]),
                                 BW_THREADS, WR_SMEM, s>>>(
        maps[0], maps[1], maps[2], off, static_cast<int*>(counter), M, K, N,
        E);
  }
  return after_launch();
}

}  // namespace

// x (M, K), w (E, K, N), offsets (E + 1,) int32 on card `device`, out
// (M, N), or (M, N / 2) with swiglu.  variant: the Variant codes above
// (kernel.py::plan chooses it; simt takes fp32, the others bf16 with K and
// N multiples of 8, N of 16 with swiglu, 16-byte aligned); tma: wgmma_tma's
// 16 tensor-map arguments (kernel.py::tma_args for x, then for w), else
// null.  Returns 0 once launched, else the launch_status code of the check
// that refused it (csrc/launch_status.cuh).
extern "C" int grouped_mm_launch(int device, const void* x, const void* w,
                                 const void* offsets, void* out, int M, int K,
                                 int N, int E, int variant, int swiglu,
                                 const unsigned long long* tma,
                                 void* stream) {
  using namespace launch_status;
  if (M < 1 || K < 1 || N < 1 || E < 1 || E > 65534) return fail(kArgs);
  if (variant != kSimt && (K % 8 || N % (swiglu ? 16 : 8))) return fail(kArgs);
  if (swiglu && N % 2) return fail(kArgs);
  if (const int st = bind_device(device)) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  return swiglu
             ? launch<true>(device, variant, x, w, off, out, M, K, N, E, tma, s)
             : launch<false>(device, variant, x, w, off, out, M, K, N, E, tma,
                             s);
}

// The backward products on card `device`.  kind 0, dgrad: a = dy (M, N),
// b = w (E, K, N), out = dx (M, K).  kind 1, wgrad: a = x (M, K), b = dy
// (M, N), out = dw (E, K, N).  variant: kSimt (fp32) or kWgmmaTma (bf16,
// K and N multiples of 8, 16-byte aligned operands); tma: wgmma_tma's
// tensor-map arguments (kernel.py::grad_tma_args: 16 for dgrad, 24 for
// wgrad), else null; scratch: one int on the card for wgrad's wgmma_tma
// (its tile counter, zeroed here before the launch), else null.  Returns 0
// once launched, else the launch_status code of the check that refused it.
extern "C" int grouped_mm_grad_launch(int device, int kind, const void* a,
                                      const void* b, const void* offsets,
                                      void* out, int M, int K, int N, int E,
                                      int variant,
                                      const unsigned long long* tma,
                                      void* scratch, void* stream) {
  using namespace launch_status;
  if (M < 1 || K < 1 || N < 1 || E < 1 || E > 65534 || (kind != 0 && kind != 1))
    return fail(kArgs);
  if (variant != kSimt && (K % 8 || N % 8)) return fail(kArgs);
  if (variant != kSimt && variant != kWgmmaTma) return fail(kArgs);
  if (const int st = bind_device(device)) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (variant == kWgmmaTma)
    return launch_grad_wgmma(device, kind, a, b, off, out, M, K, N, E, tma,
                             scratch, s);
  if (kind == 0) {
    dim3 grid((K + FN - 1) / FN, E + 1);
    gmm_dgrad_simt_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), off,
        static_cast<float*>(out), M, K, N, E);
  } else {
    dim3 grid((N + FN - 1) / FN, (K + FM - 1) / FM, E);
    gmm_wgrad_simt_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), off,
        static_cast<float*>(out), M, K, N, E);
  }
  return after_launch();
}
