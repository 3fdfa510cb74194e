// Batched, strided matrix product C[p] = A[p] @ B[p] with an fp32
// accumulator (Hopper), in four variants of one family.
//
// Replaces the TPU kernel `_matmul_kernel` (src/repro/kernels/cannon_mm/
// kernel.py:33), reached through `matmul_pallas` (:51).  It computes the
// same function: (M, K) @ (K, N) accumulated in fp32 and cast once to the
// output type.  Beyond it, one launch covers a leading batch P, and every
// operand is described by three strides (batch, row, column) in
// elements.  So one family serves the 2-D op, one Cannon round for all PEs
// of the emulated grid, the transposed operands of the backward pass (a
// transpose is a swap of strides) and the all-gathered panels, without
// copies.  Edge tiles are zero-filled or masked: every variant computes the
// same function on every shape, so the TPU op's fallback to its reference
// on ragged shapes has no counterpart here.
//
// The caller (kernel.py::plan, from dtypes, shapes, strides and base
// alignment alone) names the variant; the launcher checks that the layout
// allows it and refuses the launch otherwise.  What bounds each on an H100
// (2 M N K operations on (M K + K N) input and M N output elements; every
// shape the port runs is bound by operations, 67 TFLOP/s fp32 on the CUDA
// cores, 989 TFLOP/s bf16 on the tensor cores, except the bf16 Cannon
// round with K = 224 and an fp32 output, bound by its output bytes):
//
//   * wgmma_tma (bf16 in; A with unit column stride, B with unit column
//     stride, rows, batches and bases 16-byte aligned: every block stack of
//     the Cannon path).  Bound: tensor-core issue, which only `wgmma`
//     reaches (the bf16 Cannon round with K = 224 and an fp32 output: its
//     output bytes).  A 128 x 256 output tile per step of a persistent
//     block of three warpgroups, one block per SM walking the tiles: one
//     producer thread issues TMA loads (3-D tensor maps over (columns,
//     rows, P), 128-byte swizzle) of 128 x 64 A and 64 x 256 B tiles into a
//     ring of 4 stages in dynamic shared memory, with a full and an empty
//     mbarrier per stage, and runs on into the next tile while the last one
//     is stored; two consumer warpgroups (setmaxnreg: 232 registers each,
//     the producer 40) each run wgmma m64n256k16 over the stage that has
//     arrived (A K-major, B N-major through the transpose bit) and keep one
//     stage of products in flight while the next is waited for.  TMA
//     zero-fills past every edge, so ragged M, N and K need no masking in
//     the main loop; the epilogue stores straight from the accumulator
//     registers, two adjacent columns at a time, masked.
//   * mma_general (bf16, any other layout: transposed views, unaligned
//     rows): the warp-level WMMA interface (mma.sync 16 x 16 x 16), a
//     128 x 128 tile, depth 32, staged element by element through
//     registers into two shared buffers.
//   * f32_vec (fp32 in; each operand with a unit stride in one of its two
//     dimensions, the other strides and the base 16-byte aligned: the
//     Cannon path and the transposed views of the backward).  Bound: fp32
//     FMA issue on the CUDA cores (never TF32, which keeps ten mantissa
//     bits and would break parity with the fp32 reference), and behind it
//     the shared-memory reads that feed the FMAs.  A 128 x 256 tile per
//     block of 8 warps, each warp 32 x 128, each thread 8 x 16 outputs as
//     2 x 4 sub-blocks of 4 x 4: per k, six conflict-free float4 shared
//     reads feed 128 FMAs (a 128 x 128 tile with 8 x 8 per thread needs
//     eight, and ran slower); depth 16 in two stages of dynamic shared
//     memory.  Both tiles are k-major in shared memory: an
//     operand whose unit stride runs along M or N arrives by cp.async, 16
//     bytes a copy (zero-filled past the edge); one whose unit stride runs
//     along K is loaded as float4 into registers and transposed into place
//     after the current stage is multiplied.  Per-thread fragments are
//     double-buffered across k; the epilogue stores float4.
//   * f32_general (fp32, any other layout: unaligned rows or bases): a
//     128 x 128 tile, 8 x 8 outputs a thread, depth 8, staged element by
//     element through registers into two shared buffers.
//
// Each output element's sum runs over K in tile order; the reference's sums
// run in another order, hence tolerances rather than equality.  No variant
// uses atomics, so repeated calls give equal bits.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes; the driver's
//             cuTensorMapEncodeTiled is fetched at run time through
//             cudaGetDriverEntryPoint, so nothing links libcuda).

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

#include "../../csrc/hopper.cuh"
#include "../../csrc/launch_status.cuh"

namespace {

using bf16 = __nv_bfloat16;

// variant codes, as kernel.py::VARIANTS numbers them
enum Variant { kF32General = 0, kF32Vec = 1, kMmaGeneral = 2, kWgmmaTma = 3 };

struct Operand {            // strides in elements
  long long batch, row, col;
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// two adjacent outputs in one store (the caller guarantees the alignment)
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// four adjacent outputs in one store (likewise)
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(bf16* p, float4 v) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } o;
  o.h[0] = __floats2bfloat162_rn(v.x, v.y);
  o.h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = o.u;
}

// Staging of an R x C tile of a strided operand (rows r0.., cols c0..) in
// two halves, so the next tile's global loads are in flight while the
// current one is multiplied: `fetch` loads each thread's share into
// registers (zero past the edge), `put` stores it to shared memory, element
// (r, c) at dst[r * r_pitch + c * c_pitch].  Consecutive threads walk the
// operand's unit-stride dimension when it has one, so global reads coalesce
// whatever the layout.
template <int R, int C, int NT>
__device__ __forceinline__ void tile_rc(int it, bool col_fast, int& r,
                                        int& c) {
  const int e = it * NT + threadIdx.x;
  r = col_fast ? e / C : e % R;
  c = col_fast ? e % C : e / R;
}

template <int R, int C, int NT, typename T>
__device__ __forceinline__ void fetch(const T* __restrict__ src, Operand o,
                                      int rows, int cols, int r0, int c0,
                                      bool col_fast, T (&reg)[R * C / NT]) {
#pragma unroll
  for (int it = 0; it < R * C / NT; ++it) {
    int r, c;
    tile_rc<R, C, NT>(it, col_fast, r, c);
    const int gr = r0 + r, gc = c0 + c;
    reg[it] = gr < rows && gc < cols ? src[gr * o.row + gc * o.col]
                                     : from_f32<T>(0.f);
  }
}

template <int R, int C, int NT, typename T>
__device__ __forceinline__ void put(const T (&reg)[R * C / NT], T* dst,
                                    int r_pitch, int c_pitch, bool col_fast) {
#pragma unroll
  for (int it = 0; it < R * C / NT; ++it) {
    int r, c;
    tile_rc<R, C, NT>(it, col_fast, r, c);
    dst[r * r_pitch + c * c_pitch] = reg[it];
  }
}

// --------------------------------------------------------- f32_general ----
constexpr int kF32Tile = 128, kF32Depth = 8, kF32Threads = 256;

template <typename TO>
__global__ void __launch_bounds__(kF32Threads) mm_f32_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    TO* __restrict__ c, int M, int N, int K, Operand oa, Operand ob,
    Operand oc) {
  // both tiles k-major: as_[k][m], bs_[k][n]; +4 keeps float4 alignment;
  // two of each, the next tile staged while the current one is multiplied
  __shared__ __align__(16) float as_[2][kF32Depth][kF32Tile + 4];
  __shared__ __align__(16) float bs_[2][kF32Depth][kF32Tile + 4];
  const int p = blockIdx.z;
  a += p * oa.batch;
  b += p * ob.batch;
  c += p * oc.batch;
  const int m0 = blockIdx.y * kF32Tile, n0 = blockIdx.x * kF32Tile;
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;   // 16 x 16 threads
  const bool a_kfast = oa.col == 1 || oa.row != 1;
  const bool b_nfast = ob.col == 1 || ob.row != 1;
  constexpr int kA = kF32Tile * kF32Depth / kF32Threads;
  float ra[kA], rb[kA];

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // A tile (128 x 8) -> as_[.][k][m]; B tile (8 x 128) -> bs_[.][k][n]
  auto load = [&](int k0) {
    fetch<kF32Tile, kF32Depth, kF32Threads>(a, oa, M, K, m0, k0, a_kfast, ra);
    fetch<kF32Depth, kF32Tile, kF32Threads>(b, ob, K, N, k0, n0, b_nfast, rb);
  };
  auto store = [&](int buf) {
    put<kF32Tile, kF32Depth, kF32Threads>(ra, &as_[buf][0][0], 1,
                                          kF32Tile + 4, a_kfast);
    put<kF32Depth, kF32Tile, kF32Threads>(rb, &bs_[buf][0][0], kF32Tile + 4,
                                          1, b_nfast);
  };
  load(0);
  store(0);
  __syncthreads();
  const int n_tiles = (K + kF32Depth - 1) / kF32Depth;
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) load((t + 1) * kF32Depth);
#pragma unroll
    for (int k = 0; k < kF32Depth; ++k) {
      // rows tm*4 + {0..3} and 64 + tm*4 + {0..3}; cols likewise: two
      // float4 reads each, spread so a warp's reads hit distinct banks
      const float* ak = as_[cur][k];
      const float* bk = bs_[cur][k];
      float ra8[8], rb8[8];
      const float4 a0 = *reinterpret_cast<const float4*>(ak + tm * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 64 + tm * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bk + tn * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + tn * 4);
      ra8[0] = a0.x; ra8[1] = a0.y; ra8[2] = a0.z; ra8[3] = a0.w;
      ra8[4] = a1.x; ra8[5] = a1.y; ra8[6] = a1.z; ra8[7] = a1.w;
      rb8[0] = b0.x; rb8[1] = b0.y; rb8[2] = b0.z; rb8[3] = b0.w;
      rb8[4] = b1.x; rb8[5] = b1.y; rb8[6] = b1.z; rb8[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = fmaf(ra8[i], rb8[j], acc[i][j]);
    }
    if (t + 1 < n_tiles) store(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? tm * 4 + i : 64 + tm * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tn * 4 + j : 64 + tn * 4 + j - 4);
      if (gn < N) c[gm * oc.row + gn * oc.col] = from_f32<TO>(acc[i][j]);
    }
  }
}

// --------------------------------------------------------- mma_general ----
constexpr int kBfTile = 128, kBfDepth = 32, kBfThreads = 256;
constexpr int kBfPitchA = kBfDepth + 8;   // wmma ldm: a multiple of 8 bf16
constexpr int kBfPitchB = kBfTile + 8;

template <typename TO>
__global__ void __launch_bounds__(kBfThreads) mm_bf16_kernel(
    const bf16* __restrict__ a, const bf16* __restrict__ b,
    TO* __restrict__ c, int M, int N, int K, Operand oa, Operand ob,
    Operand oc) {
  using namespace nvcuda;
  constexpr int kTileA = kBfTile * kBfPitchA, kTileB = kBfDepth * kBfPitchB;
  // two of each, the next tile staged while the current one is multiplied
  __shared__ __align__(32) bf16 as_[2 * kTileA];             // [m][k]
  __shared__ __align__(32) bf16 bs_[2 * kTileB];             // [k][n]
  __shared__ __align__(32) float out_[8][16 * 16];           // per warp
  const int p = blockIdx.z;
  a += p * oa.batch;
  b += p * ob.batch;
  c += p * oc.batch;
  const int m0 = blockIdx.y * kBfTile, n0 = blockIdx.x * kBfTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;      // 2 x 4 warps
  const bool a_kfast = oa.col == 1 || oa.row != 1;
  const bool b_nfast = ob.col == 1 || ob.row != 1;
  // per thread: 16 + 16 elements
  constexpr int kE = kBfTile * kBfDepth / kBfThreads;
  bf16 ea[kE], eb[kE];

  auto load = [&](int k0) {
    fetch<kBfTile, kBfDepth, kBfThreads>(a, oa, M, K, m0, k0, a_kfast, ea);
    fetch<kBfDepth, kBfTile, kBfThreads>(b, ob, K, N, k0, n0, b_nfast, eb);
  };
  auto store = [&](int buf) {
    put<kBfTile, kBfDepth, kBfThreads>(ea, as_ + buf * kTileA, kBfPitchA, 1,
                                       a_kfast);
    put<kBfDepth, kBfTile, kBfThreads>(eb, bs_ + buf * kTileB, kBfPitchB, 1,
                                       b_nfast);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  store(0);
  __syncthreads();
  const int n_tiles = (K + kBfDepth - 1) / kBfDepth;
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) load((t + 1) * kBfDepth);
    const bf16* sa = as_ + cur * kTileA;
    const bf16* sb = bs_ + cur * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBfDepth; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], sa + (wm + 16 * i) * kBfPitchA + kk,
                               kBfPitchA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], sb + kk * kBfPitchB + wn + 16 * j,
                               kBfPitchB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    if (t + 1 < n_tiles) store(cur ^ 1);
    __syncthreads();
  }

  // each fragment through the warp's 16 x 16 patch, masked and cast
  float* patch = out_[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(patch, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gm = m0 + wm + 16 * i + e / 16;
        const int gn = n0 + wn + 16 * j + e % 16;
        if (gm < M && gn < N)
          c[gm * oc.row + gn * oc.col] = from_f32<TO>(patch[e]);
      }
      __syncwarp();
    }
}

// ------------------------------------------------------------- f32_vec ----
constexpr int kVecBM = 128, kVecBN = 256, kVecDepth = 16, kVecThreads = 256;
constexpr int kVecGroups = kVecBN / 64;   // float4 column groups a thread
constexpr int kVecSmem = 2 * kVecDepth * (kVecBM + 4 + kVecBN + 4) * 4;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// One operand's depth tile, k-major in shared memory: dst[k][x] for k in
// [0, 16) and x in [0, XT), element (k0 + k, x0 + x) of an operand whose
// element (k, x) lies at src[k * sk + x * sx], zero past K and X; rows of
// XT + 4 floats (16-byte aligned, and a transposed store's banks spread).
//   X_FAST (sx == 1): 16-byte cp.async along x, issued by `issue`.
//   otherwise (sk == 1): float4 along k into registers by `issue`, then
//   transposed into dst by `commit` (so the global loads of the next stage
//   are in flight while the current one is multiplied).
template <bool X_FAST, int XT>
struct VecStage {
  static constexpr int kPitch = XT + 4;
  static constexpr int kChunks = XT * kVecDepth / 4 / kVecThreads;
  float4 reg[X_FAST ? 1 : kChunks];

  __device__ __forceinline__ void issue(const float* __restrict__ src,
                                        long long sk, long long sx, int K,
                                        int X, int k0, int x0, float* dst) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int e = i * kVecThreads + threadIdx.x;
      if constexpr (X_FAST) {
        const int k = e / (XT / 4), x = (e % (XT / 4)) * 4;
        const int gk = k0 + k, gx = x0 + x;
        const int n = gk < K && gx < X ? min(X - gx, 4) : 0;
        cp_async16(dst + k * kPitch + x, n ? src + gk * sk + gx : src,
                   4 * n);
      } else {
        const int x = e / (kVecDepth / 4), k = (e % (kVecDepth / 4)) * 4;
        const int gk = k0 + k, gx = x0 + x;
        if (gx < X && gk + 4 <= K) {
          reg[i] = *reinterpret_cast<const float4*>(src + gx * sx + gk);
        } else {
          const float* q = src + gx * sx;
          const bool in = gx < X;
          reg[i] = make_float4(in && gk < K ? q[gk] : 0.f,
                               in && gk + 1 < K ? q[gk + 1] : 0.f,
                               in && gk + 2 < K ? q[gk + 2] : 0.f,
                               in && gk + 3 < K ? q[gk + 3] : 0.f);
        }
      }
    }
  }

  __device__ __forceinline__ void commit(float* dst) const {
    if constexpr (!X_FAST) {
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int e = i * kVecThreads + threadIdx.x;
        const int x = e / (kVecDepth / 4), k = (e % (kVecDepth / 4)) * 4;
        dst[(k + 0) * kPitch + x] = reg[i].x;
        dst[(k + 1) * kPitch + x] = reg[i].y;
        dst[(k + 2) * kPitch + x] = reg[i].z;
        dst[(k + 3) * kPitch + x] = reg[i].w;
      }
    }
  }
};

// A_XFAST: A's unit stride runs along M (a transposed view), else along K.
// B_XFAST: B's unit stride runs along N, else along K (a transposed view).
template <typename TO, bool A_XFAST, bool B_XFAST>
__global__ void __launch_bounds__(kVecThreads) mm_f32_vec_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    TO* __restrict__ c, int M, int N, int K, Operand oa, Operand ob,
    Operand oc) {
  using SA = VecStage<A_XFAST, kVecBM>;
  using SB = VecStage<B_XFAST, kVecBN>;
  constexpr int kA = kVecDepth * SA::kPitch, kB = kVecDepth * SB::kPitch;
  extern __shared__ float4 vec_smem[];
  float* const as_ = reinterpret_cast<float*>(vec_smem);   // 2 x [k][m]
  float* const bs_ = as_ + 2 * kA;                         // 2 x [k][n]
  const int p = blockIdx.z;
  a += p * oa.batch;
  b += p * ob.batch;
  c += p * oc.batch;
  const int m0 = blockIdx.y * kVecBM, n0 = blockIdx.x * kVecBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp 32 x BN/2 of the tile; thread rows am + {0..3, 16..19}, columns
  // bn + 32 g + {0..3}: per k, two float4 of A (four distinct addresses in
  // the warp, broadcast) and one float4 of B per group g (eight
  // consecutive addresses in the warp)
  const int am = (warp / 2) * 32 + (lane / 8) * 4;
  const int bn = (warp % 2) * (kVecBN / 2) + (lane % 8) * 4;
  SA sa;
  SB sb;
  auto issue = [&](int k0, int buf) {
    sa.issue(a, oa.col, oa.row, K, M, k0, m0, as_ + buf * kA);
    sb.issue(b, ob.row, ob.col, K, N, k0, n0, bs_ + buf * kB);
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  auto commit = [&](int buf) {
    sa.commit(as_ + buf * kA);
    sb.commit(bs_ + buf * kB);
  };

  float acc[8][4 * kVecGroups];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4 * kVecGroups; ++j) acc[i][j] = 0.f;

  issue(0, 0);
  commit(0);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  const int n_tiles = (K + kVecDepth - 1) / kVecDepth;
  for (int t = 0; t < n_tiles; ++t) {
    const int cur = t & 1;
    if (t + 1 < n_tiles) issue((t + 1) * kVecDepth, cur ^ 1);
    const float* ak = as_ + cur * kA + am;
    const float* bk = bs_ + cur * kB + bn;
    float4 fa[2][2], fb[2][kVecGroups];   // [k parity][...], double-buffered
    auto frag = [&](int k, int f) {
      fa[f][0] = *reinterpret_cast<const float4*>(ak + k * SA::kPitch);
      fa[f][1] = *reinterpret_cast<const float4*>(ak + k * SA::kPitch + 16);
#pragma unroll
      for (int g = 0; g < kVecGroups; ++g)
        fb[f][g] =
            *reinterpret_cast<const float4*>(bk + k * SB::kPitch + 32 * g);
    };
    frag(0, 0);
#pragma unroll
    for (int k = 0; k < kVecDepth; ++k) {
      const int f = k & 1;
      if (k + 1 < kVecDepth) frag(k + 1, f ^ 1);
      const float ra[8] = {fa[f][0].x, fa[f][0].y, fa[f][0].z, fa[f][0].w,
                           fa[f][1].x, fa[f][1].y, fa[f][1].z, fa[f][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int g = 0; g < kVecGroups; ++g) {
          acc[i][4 * g + 0] = fmaf(ra[i], fb[f][g].x, acc[i][4 * g + 0]);
          acc[i][4 * g + 1] = fmaf(ra[i], fb[f][g].y, acc[i][4 * g + 1]);
          acc[i][4 * g + 2] = fmaf(ra[i], fb[f][g].z, acc[i][4 * g + 2]);
          acc[i][4 * g + 3] = fmaf(ra[i], fb[f][g].w, acc[i][4 * g + 3]);
        }
    }
    if (t + 1 < n_tiles) commit(cur ^ 1);
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncthreads();
  }

  // float4 stores where C's rows allow (the wrapper's contiguous C with N a
  // multiple of 4), else element by element
  const bool vec_c = oc.col == 1 && oc.row % 4 == 0 && oc.batch % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(c) % 16 == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + am + (i < 4 ? i : 12 + i);
    if (gm >= M) continue;
    TO* row = c + gm * oc.row;
#pragma unroll
    for (int g = 0; g < kVecGroups; ++g) {
      const int gn = n0 + bn + 32 * g;
      const float4 v = make_float4(acc[i][4 * g], acc[i][4 * g + 1],
                                   acc[i][4 * g + 2], acc[i][4 * g + 3]);
      if (vec_c && gn + 4 <= N) {
        store4(row + gn, v);
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gn + j < N) row[(gn + j) * oc.col] = from_f32<TO>(w[j]);
      }
    }
  }
}

// ----------------------------------------------------------- wgmma_tma ----
constexpr int kWgBM = 128, kWgBN = 256, kWgBK = 64, kWgStages = 4;
constexpr int kWgThreads = 384;   // warpgroups 0, 1: consumers; 2: producer
constexpr int kWgABytes = kWgBM * kWgBK * 2;               // 16 KB
constexpr int kWgBBox = 64;                                 // B box: 64 x 64
constexpr int kWgBBoxBytes = kWgBK * kWgBBox * 2;          // 8 KB
constexpr int kWgStageBytes = kWgABytes + kWgBN / kWgBBox * kWgBBoxBytes;
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024;  // + alignment
static_assert(kWgSmem + 2 * kWgStages * 8 <= 232448,
              "wgmma_tma: shared memory over Hopper's 227 KB");
static_assert(kVecSmem <= 232448, "f32_vec: shared memory over 227 KB");

// Persistent: one block per SM walks the output tiles (n fastest, then m,
// then p), so the producer loads the next tile's first stages while the
// consumers store the last one.  Stage and phase run on across tiles.
template <typename TO>
__global__ void __launch_bounds__(kWgThreads, 1) mm_wgmma_tma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_b, TO* __restrict__ c, int P,
    int M, int N, int K, long long c_batch, long long c_row) {
  using namespace hopper;
  extern __shared__ uint8_t dyn_smem[];
  __shared__ __align__(8) uint64_t full[kWgStages], empty[kWgStages];
  // each stage: A 128 x 64 (K-major, 128-byte rows), then B as four
  // 64 (k) x 64 (n) boxes (N-major); every box starts 1024-byte aligned
  const uint32_t ring = (smem_addr(dyn_smem) + 1023u) & ~1023u;
  const int tiles_n = (N + kWgBN - 1) / kWgBN;
  const int tiles_mn = tiles_n * ((M + kWgBM - 1) / kWgBM);
  const int n_tiles = tiles_mn * P;
  const int n_k = (K + kWgBK - 1) / kWgBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
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
      int it = 0;   // stages filled so far, over all tiles
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int p = tile / tiles_mn, r = tile % tiles_mn;
        const int m0 = (r / tiles_n) * kWgBM, n0 = (r % tiles_n) * kWgBN;
        for (int t = 0; t < n_k; ++t, ++it) {
          const int s = it % kWgStages;
          if (it >= kWgStages)    // wait until the consumers released it
            mbar_wait(smem_addr(&empty[s]), ((it / kWgStages) - 1) & 1);
          const uint32_t bar = smem_addr(&full[s]);
          const uint32_t st = ring + s * kWgStageBytes;
          mbar_expect_tx(bar, kWgStageBytes);
          tma_load_3d(st, &map_a, bar, t * kWgBK, m0, p);
#pragma unroll
          for (int j = 0; j < kWgBN / kWgBBox; ++j)
            tma_load_3d(st + kWgABytes + j * kWgBBoxBytes, &map_b, bar,
                        n0 + j * kWgBBox, t * kWgBK, p);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: rows 64 wg .. 64 wg + 63 of each tile ----
    regs_inc<232>();
    const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
    const int w = (threadIdx.x % 128) / 32;
    const bool pair = c_row % 2 == 0 && c_batch % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(c) % (2 * sizeof(TO)) == 0;
    auto release = [&](int stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty[stage]));
    };
    float acc[128];
    int it = 0;     // stages consumed so far, over all tiles
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int p = tile / tiles_mn, r = tile % tiles_mn;
      const int m0 = (r / tiles_n) * kWgBM, n0 = (r % tiles_n) * kWgBN;
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int t = 0; t < n_k; ++t, ++it) {
        const int s = it % kWgStages;
        mbar_wait(smem_addr(&full[s]), (it / kWgStages) & 1);
        const uint32_t st = ring + s * kWgStageBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          const uint64_t da =
              sw128_desc(st + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db = sw128_desc(st + kWgABytes + kk * 16 * 128,
                                         kWgBBoxBytes, 1024);
          wgmma_m64n256k16<0, 1>(acc, da, db);
        }
        wgmma_commit();
        // the products of the previous stage are done: hand it back
        wgmma_wait<1>();
        if (t > 0) release((it - 1) % kWgStages);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release((it - 1) % kWgStages);

      // epilogue: straight from the registers, two adjacent columns a store
      const int r0 = m0 + wg * 64 + w * 16 + lane / 4;
      const int cb = n0 + (lane % 4) * 2;
      TO* cp = c + p * c_batch;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row_i = r0 + 8 * h;
        if (row_i >= M) continue;
        TO* row = cp + row_i * c_row;
#pragma unroll
        for (int j = 0; j < kWgBN / 8; ++j) {
          const int col = cb + 8 * j;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (pair && col + 1 < N) {
            store2(row + col, v0, v1);
          } else {
            if (col < N) row[col] = from_f32<TO>(v0);
            if (col + 1 < N) row[col + 1] = from_f32<TO>(v1);
          }
        }
      }
    }
  }
}

template <typename TO>
int launch_f32(const void* a, const void* b, void* c, int P, int M, int N,
               int K, Operand oa, Operand ob, Operand oc, cudaStream_t s) {
  const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile,
                  P);
  mm_f32_kernel<TO><<<grid, kF32Threads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TO*>(c), M, N, K, oa, ob, oc);
  return launch_status::after_launch();
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename TO>
int launch_bf16(const void* a, const void* b, void* c, int P, int M, int N,
                int K, Operand oa, Operand ob, Operand oc, cudaStream_t s) {
  const dim3 grid((N + kBfTile - 1) / kBfTile, (M + kBfTile - 1) / kBfTile, P);
  mm_bf16_kernel<TO><<<grid, kBfThreads, 0, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<TO*>(c), M, N, K, oa, ob, oc);
  return launch_status::after_launch();
}

// f32_vec's precondition on one operand: a unit stride along x (x_fast) or
// along k, the other stride and the batch stride multiples of 4 floats
bool vec_operand_ok(const void* ptr, long long sk, long long sx, long long sb,
                    bool x_fast) {
  return (x_fast ? sx == 1 && sk % 4 == 0 : sk == 1 && sx % 4 == 0) &&
         sb % 4 == 0 && aligned16(ptr);
}

// layout bit 0: A's unit stride runs along M; bit 1: B's along N
template <typename TO>
int launch_f32_vec(const void* a, const void* b, void* c, int P, int M,
                   int N, int K, Operand oa, Operand ob, Operand oc,
                   int layout, cudaStream_t s) {
  using namespace launch_status;
  const bool ax = layout & 1, bx = layout & 2;
  if (!vec_operand_ok(a, oa.col, oa.row, oa.batch, ax) ||
      !vec_operand_ok(b, ob.row, ob.col, ob.batch, bx))
    return fail(kArgs);
  const dim3 grid((N + kVecBN - 1) / kVecBN, (M + kVecBM - 1) / kVecBM, P);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  TO* pc = static_cast<TO*>(c);
  auto kernel = ax ? (bx ? mm_f32_vec_kernel<TO, true, true>
                         : mm_f32_vec_kernel<TO, true, false>)
                   : (bx ? mm_f32_vec_kernel<TO, false, true>
                         : mm_f32_vec_kernel<TO, false, false>);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kVecSmem);
  if (err != cudaSuccess) return fail(kSmem, err);
  kernel<<<grid, kVecThreads, kVecSmem, s>>>(pa, pb, pc, M, N, K, oa, ob, oc);
  return after_launch();
}

template <typename TO>
int launch_wgmma(int dev, const void* a, const void* b, void* c, int P, int M,
                 int N, int K, Operand oc, const unsigned long long* tma,
                 cudaStream_t s) {
  using namespace launch_status;
  // the boxes the kernel's ring is laid out for
  if (tma == nullptr || oc.col != 1 || tma[5] != kWgBK ||
      tma[6] != kWgBM || tma[7] != 1 || tma[13] != kWgBBox ||
      tma[14] != kWgBK || tma[15] != 1)
    return fail(kArgs);
  const long long tiles = (long long)((M + kWgBM - 1) / kWgBM) *
                          ((N + kWgBN - 1) / kWgBN) * P;
  if (tiles > 0x7fffffff) return fail(kArgs);
  if (hopper::tensor_map_encoder() == nullptr) return fail(kEncoder);
  CUtensorMap map_a, map_b;
  int res = hopper::encode_map(&map_a, a, tma);
  if (res == 0) res = hopper::encode_map(&map_b, b, tma + 8);
  if (res != 0) return fail(kEncode, (cudaError_t)res);
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return fail(kQuery, err);
  err = cudaFuncSetAttribute(mm_wgmma_tma_kernel<TO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kWgSmem);
  if (err != cudaSuccess) return fail(kSmem, err);
  // one block per SM (its shared memory allows no second), or fewer
  const int grid = (int)(tiles < sms ? tiles : sms);
  mm_wgmma_tma_kernel<TO><<<grid, kWgThreads, kWgSmem, s>>>(
      map_a, map_b, static_cast<TO*>(c), P, M, N, K, oc.batch, oc.row);
  return after_launch();
}

template <typename TO>
int launch(int dev, int variant, const void* a, const void* b, void* c, int P,
           int M, int N, int K, Operand oa, Operand ob, Operand oc,
           int layout, const unsigned long long* tma, cudaStream_t s) {
  switch (variant) {
    case kF32General:
      return launch_f32<TO>(a, b, c, P, M, N, K, oa, ob, oc, s);
    case kF32Vec:
      return launch_f32_vec<TO>(a, b, c, P, M, N, K, oa, ob, oc, layout, s);
    case kMmaGeneral:
      return launch_bf16<TO>(a, b, c, P, M, N, K, oa, ob, oc, s);
    case kWgmmaTma:
      return launch_wgmma<TO>(dev, a, b, c, P, M, N, K, oc, tma, s);
  }
  return launch_status::fail(launch_status::kArgs);
}

}  // namespace

// C entry point for ctypes, on card `device`.  in_dtype / out_dtype: 0 =
// float32, 1 = bfloat16.  Strides in elements: (batch, row, col) for A
// (P, M, K), B (P, K, N) and C (P, M, N).  variant: the Variant codes above
// (kernel.py::plan chooses it); layout: f32_vec's operand layout bits; tma:
// wgmma_tma's 16 tensor-map arguments (kernel.py::tma_args for A, then for
// B), else null.  Returns 0 once launched, else the launch_status code of
// the check that refused it (csrc/launch_status.cuh): kArgs for a variant
// that the dtypes or the layout do not allow.
extern "C" int cannon_mm_launch(int device, const void* a, const void* b,
                                void* c, int P, int M, int N, int K,
                                long long a_batch, long long a_row,
                                long long a_col, long long b_batch,
                                long long b_row, long long b_col,
                                long long c_batch, long long c_row,
                                long long c_col, int in_dtype, int out_dtype,
                                int variant, int layout,
                                const unsigned long long* tma, void* stream) {
  using namespace launch_status;
  if (P < 1 || P > 65535 || M < 1 || N < 1 || K < 1 ||
      (M + 127) / 128 > 65535)
    return fail(kArgs);
  const bool bf16_in = variant == kMmaGeneral || variant == kWgmmaTma;
  if (in_dtype != (bf16_in ? 1 : 0) || (out_dtype != 0 && out_dtype != 1))
    return fail(kArgs);
  if (const int st = bind_device(device)) return st;
  const Operand oa{a_batch, a_row, a_col}, ob{b_batch, b_row, b_col},
      oc{c_batch, c_row, c_col};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_dtype == 0
             ? launch<float>(device, variant, a, b, c, P, M, N, K, oa, ob, oc,
                             layout, tma, s)
             : launch<bf16>(device, variant, a, b, c, P, M, N, K, oa, ob, oc,
                            layout, tma, s);
}
