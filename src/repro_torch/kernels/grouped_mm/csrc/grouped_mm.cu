// Grouped GEMM over rows sorted by expert (Hopper, sm_90a).
//
// Replaces `lax.ragged_dot` with `group_sizes`, the two expert products of
// the MoE block (src/repro/models/moe.py:116 and :120).  That is an XLA op,
// not a Pallas kernel; it gets a kernel written by hand all the same,
// because its plain version cannot sit on the card's main path: slicing
// per expert needs the row counts on the host (a sync that a CUDA graph
// capture refuses), and one fixed-shape product against every expert
// computes and buffers E / k times the work.
//
// It computes out (M, N) = for each expert e, rows offsets[e] ..
// offsets[e + 1] of x (M, K) times w[e] (K, N), with an fp32 accumulator
// rounded once to x's dtype (where ragged_dot rounds).  Rows outside
// [offsets[0], offsets[E]) belong to no expert and are written as zeros
// (the MoE block parks dropped pairs there).  The offsets are read on the
// card, so the grid is fixed by the shapes alone and the launch can be
// captured.
//
// What bounds it on an H100.  2 M K N operations on (active experts x K x N
// + M x K) input and M x N output elements.  At decode (M = 64 rows over
// about 52 of qwen3-moe's 128 experts) the weights of the active experts,
// 1.95 GB a layer, are the whole cost: bound by bytes at 3.35 TB/s.  At a
// batch-8 len256 prefill (M = 16384, every expert active, about 128 rows
// each) the two bounds meet: 4.83 GB a layer against 618 GFLOP.
//
// Design.  One block per (N tile of 128 columns, expert), plus one block
// per N tile for the rows of no expert.  A block reads its expert's row
// range from `offsets`, returns at once when it is empty, and otherwise
// walks its rows in M tiles of 64; each weight tile of the expert is read
// once per M tile (once in all at decode, where an expert has 1-2 rows).
//   * bf16 ("mma"): 4 warps as 2 x 2, each a 32 x 64 piece of the tile;
//     mma.sync m16n8k16 with fp32 accumulators (../../csrc/mma_tile.cuh).
//     K tiles of 32 staged by 16-byte cp.async in a 3-stage ring (x rows
//     zero-filled past the expert's last row and past K); rows padded by
//     16 bytes so ldmatrix reads A and (transposed) B without bank
//     conflicts.  A warp whose 32 rows are all past the expert's last row
//     skips its products.  Needs K and N multiples of 8 and 16-byte
//     aligned operands (the wrapper checks).
//   * fp32 ("simt", the fp32 reference configs): CUDA-core FMAs, 64 x 64
//     tiles of 256 threads, 4 x 4 outputs a thread, K tiles of 16 staged
//     through registers into shared memory; any K and N.
// Simple and right first: wgmma fed by TMA, the silu x up epilogue fused
// into the first product and a block that serves several experts at
// decode are later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/mma_tile.cuh"

namespace {

// The row range of expert e, clamped into [0, M].
__device__ __forceinline__ void expert_rows(const int* offsets, int e, int M,
                                            int& lo, int& hi) {
  lo = min(max(offsets[e], 0), M);
  hi = min(max(offsets[e + 1], lo), M);
}

// The last blockIdx.y: zero rows [0, offsets[0]) and [offsets[E], M) of
// this block's N tile.
template <typename T>
__device__ void zero_tail(T* out, const int* offsets, int M, int N, int E,
                          int n0, int bn) {
  const int lo = min(max(offsets[0], 0), M);
  const int hi = min(max(offsets[E], lo), M);
  const int cols = min(bn, N - n0);
  const int rows = lo + (M - hi);
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    const int row = r < lo ? r : hi + (r - lo);
    out[(long long)row * N + n0 + c] = T(0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores.
// ---------------------------------------------------------------------------

constexpr int BM = 64, BN = 128, BK = 32, STAGES = 3, THREADS = 128;
constexpr int A_PITCH = BK + 8;    // bf16 per staged x row (80 bytes)
constexpr int B_PITCH = BN + 8;    // bf16 per staged w row (272 bytes)

struct Stage {
  __nv_bfloat16 a[BM * A_PITCH];
  __nv_bfloat16 b[BK * B_PITCH];
};

__device__ __forceinline__ void load_stage(Stage& st,
                                           const __nv_bfloat16* x,
                                           const __nv_bfloat16* we, int m0,
                                           int hi, int k0, int n0, int K,
                                           int N) {
  const int t = threadIdx.x;
  // x: 64 rows x 4 chunks of 8
#pragma unroll
  for (int i = 0; i < BM * BK / 8 / THREADS; ++i) {
    const int c = t + i * THREADS;
    const int r = c >> 2, kc = (c & 3) * 8;
    const bool ok = m0 + r < hi && k0 + kc < K;
    const __nv_bfloat16* src = ok ? x + (long long)(m0 + r) * K + k0 + kc : x;
    tile::cp_async16(st.a + r * A_PITCH + kc, src, ok ? 16 : 0);
  }
  // w[e]: 32 rows x 16 chunks of 8
#pragma unroll
  for (int i = 0; i < BK * BN / 8 / THREADS; ++i) {
    const int c = t + i * THREADS;
    const int r = c >> 4, nc = (c & 15) * 8;
    const bool ok = k0 + r < K && n0 + nc < N;
    const __nv_bfloat16* src =
        ok ? we + (long long)(k0 + r) * N + n0 + nc : we;
    tile::cp_async16(st.b + r * B_PITCH + nc, src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS)
    gmm_mma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const int* __restrict__ offsets,
                   __nv_bfloat16* __restrict__ out, int M, int K, int N,
                   int E) {
  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.y;
  if (e == E) {
    zero_tail(out, offsets, M, N, E, n0, BN);
    return;
  }
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  if (lo >= hi) return;

  __shared__ __align__(16) Stage stages[STAGES];
  const __nv_bfloat16* we = w + (long long)e * K * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int gid = lane >> 2, tig = lane & 3;
  const int nk = (K + BK - 1) / BK;
  // ldmatrix lanes: A rows (lane & 15), k half (lane >> 4); B (transposed)
  // as mma_tile.cuh's fold reads V
  const int a_row = lane & 15, a_col = (lane >> 4) << 3;
  const int b_key = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_col = (lane >> 4) << 3;

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
      if (s < nk) load_stage(stages[s], x, we, m0, hi, s * BK, n0, K, N);
      tile::cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      tile::cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int pre = kt + STAGES - 1;
      if (pre < nk)
        load_stage(stages[pre % STAGES], x, we, m0, hi, pre * BK, n0, K, N);
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
              b, st.b + (kk * 16 + b_key) * B_PITCH + wn * 64 + np * 16 +
                     b_col);
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
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = n0 + wn * 64 + nt * 8 + 2 * tig;
          if (col >= N) continue;
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
              __floats2bfloat162_rn(acc[mi][nt][2 * half],
                                    acc[mi][nt][2 * half + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores.
// ---------------------------------------------------------------------------

constexpr int FM = 64, FN = 64, FK = 16, FTHREADS = 256;

__global__ void __launch_bounds__(FTHREADS)
    gmm_simt_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const int* __restrict__ offsets, float* __restrict__ out,
                    int M, int K, int N, int E) {
  const int n0 = blockIdx.x * FN;
  const int e = blockIdx.y;
  if (e == E) {
    zero_tail(out, offsets, M, N, E, n0, FN);
    return;
  }
  int lo, hi;
  expert_rows(offsets, e, M, lo, hi);
  if (lo >= hi) return;

  __shared__ __align__(16) float as[FK][FM];   // x tile, transposed
  __shared__ __align__(16) float bs[FK][FN];
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
        bs[r][n] = (k0 + r < K && n0 + n < N)
                       ? we[(long long)(k0 + r) * N + n0 + n]
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
        const int col = n0 + tx * 4 + j;
        if (col < N) out[(long long)row * N + col] = acc[i][j];
      }
    }
  }
}

}  // namespace

// x (M, K), w (E, K, N), offsets (E + 1,) int32 on the card, out (M, N);
// dtype 1: bf16 (K, N multiples of 8, 16-byte aligned), 0: fp32.  Returns
// the launch's cudaGetLastError().
extern "C" int grouped_mm_launch(const void* x, const void* w,
                                 const void* offsets, void* out, int M, int K,
                                 int N, int E, int dtype, void* stream) {
  if (M < 1 || K < 1 || N < 1 || E < 1 || E > 65534)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* off = static_cast<const int*>(offsets);
  if (dtype == 1) {
    if (K % 8 || N % 8) return (int)cudaErrorInvalidValue;
    dim3 grid((N + BN - 1) / BN, E + 1);
    gmm_mma_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), off,
        static_cast<__nv_bfloat16*>(out), M, K, N, E);
  } else {
    dim3 grid((N + FN - 1) / FN, E + 1);
    gmm_simt_kernel<<<grid, FTHREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), off,
        static_cast<float*>(out), M, K, N, E);
  }
  return (int)cudaGetLastError();
}
