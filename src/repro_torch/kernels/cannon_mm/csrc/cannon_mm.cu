// Batched, strided matrix product C[p] = A[p] @ B[p] with an fp32
// accumulator (Hopper).
//
// Replaces the TPU kernel `_matmul_kernel`, reached through `matmul_pallas`
// in src/repro/kernels/cannon_mm/kernel.py.  It computes the same function:
// (M, K) @ (K, N) accumulated in fp32 and cast once to the output type.
// Beyond it, one launch covers a leading batch P (grid z), and every operand
// is described by three strides (batch, row, column) in elements.  That one
// kernel therefore serves the 2-D op, one Cannon round for all PEs of the
// emulated grid, the transposed operands of the backward pass (a transpose
// is a swap of strides) and the all-gathered panels, without copies.  Edge
// tiles are masked: the kernel computes the same function on every shape,
// so the TPU op's fallback to its reference on ragged shapes has no
// counterpart here.
//
// Two kernels, by input type:
//   * fp32 inputs: fp32 FMAs on the CUDA cores, never TF32 (TF32 keeps ten
//     mantissa bits and would break parity with the fp32 reference).  A
//     128 x 128 output tile per block of 256 threads, 8 x 8 outputs per
//     thread held in registers, depth tiles of 8 staged in shared memory.
//   * bf16 inputs: tensor cores through the warp-level WMMA interface
//     (mma.sync, bf16 in, fp32 accumulate: the products are exact and the
//     sums are fp32, as the reference's).  A 128 x 128 tile per block of
//     8 warps, each warp 64 x 32 as 4 x 2 fragments of 16 x 16, depth tiles
//     of 32.  Row-major operands with rows aligned to 16 bytes (every
//     contiguous block of the port) are staged 8 elements a load; any
//     other layout element by element.
// Both stage the next depth tile into a second shared-memory buffer, through
// registers, while the current one is multiplied.
// Each output element's sum runs over K in tile order; the reference's sums
// run in another order, hence tolerances rather than equality.
//
// What bounds it on an H100.  2*M*N*K operations on (M*K + K*N) input and
// M*N output elements: every shape the port runs (blocks of 32..2048 on a
// side) is bound by operations: 67 TFLOP/s fp32, 989 TFLOP/s bf16.  This
// first version is simple: staging through registers, two tiles in shared
// memory.  wgmma tiles fed by TMA with a deeper ring of stages are a later
// change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

struct Operand {            // strides in elements
  long long batch, row, col;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
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

// ---------------------------------------------------------------- fp32 ----
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

// ---------------------------------------------------------------- bf16 ----
constexpr int kBfTile = 128, kBfDepth = 32, kBfThreads = 256;
constexpr int kBfPitchA = kBfDepth + 8;   // wmma ldm: a multiple of 8 bf16
constexpr int kBfPitchB = kBfTile + 8;

// Eight consecutive elements of row r from column c, zero past the edge:
// one 16-byte load when all eight are inside (the caller guarantees the
// alignment), else element by element.
__device__ __forceinline__ uint4 load8(const bf16* __restrict__ src,
                                       long long row_stride, int rows,
                                       int cols, int r, int c) {
  if (r < rows && c + 8 <= cols)
    return *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  union {
    uint4 v;
    bf16 h[8];
  } u;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    u.h[i] = r < rows && c + i < cols ? src[r * row_stride + c + i]
                                      : __float2bfloat16_rn(0.f);
  return u.v;
}

// VEC: both operands have a unit column stride and row and batch strides
// (and base addresses) that are multiples of 8 elements, so a thread moves
// 8 elements with one 16-byte load; otherwise element by element.
template <typename TO, bool VEC>
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
  // per thread: 2 + 2 chunks of 8 (VEC), or 16 + 16 elements
  constexpr int kV = kBfTile * kBfDepth / 8 / kBfThreads;
  constexpr int kE = kBfTile * kBfDepth / kBfThreads;
  uint4 va[kV], vb[kV];
  bf16 ea[VEC ? 1 : kE], eb[VEC ? 1 : kE];

  auto load = [&](int k0) {
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int e = i * kBfThreads + threadIdx.x;
        va[i] = load8(a, oa.row, M, K, m0 + e / (kBfDepth / 8),
                      k0 + (e % (kBfDepth / 8)) * 8);
        vb[i] = load8(b, ob.row, K, N, k0 + e / (kBfTile / 8),
                      n0 + (e % (kBfTile / 8)) * 8);
      }
    } else {
      fetch<kBfTile, kBfDepth, kBfThreads>(a, oa, M, K, m0, k0, a_kfast, ea);
      fetch<kBfDepth, kBfTile, kBfThreads>(b, ob, K, N, k0, n0, b_nfast, eb);
    }
  };
  auto store = [&](int buf) {
    bf16* sa = as_ + buf * kTileA;
    bf16* sb = bs_ + buf * kTileB;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < kV; ++i) {
        const int e = i * kBfThreads + threadIdx.x;
        *reinterpret_cast<uint4*>(sa + (e / (kBfDepth / 8)) * kBfPitchA +
                                  (e % (kBfDepth / 8)) * 8) = va[i];
        *reinterpret_cast<uint4*>(sb + (e / (kBfTile / 8)) * kBfPitchB +
                                  (e % (kBfTile / 8)) * 8) = vb[i];
      }
    } else {
      put<kBfTile, kBfDepth, kBfThreads>(ea, sa, kBfPitchA, 1, a_kfast);
      put<kBfDepth, kBfTile, kBfThreads>(eb, sb, kBfPitchB, 1, b_nfast);
    }
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

template <typename TO>
int launch_f32(const void* a, const void* b, void* c, int P, int M, int N,
               int K, Operand oa, Operand ob, Operand oc, cudaStream_t s) {
  const dim3 grid((N + kF32Tile - 1) / kF32Tile, (M + kF32Tile - 1) / kF32Tile,
                  P);
  mm_f32_kernel<TO><<<grid, kF32Threads, 0, s>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<TO*>(c), M, N, K, oa, ob, oc);
  return (int)cudaGetLastError();
}

bool vec_ok(const void* ptr, Operand o) {
  return o.col == 1 && o.row % 8 == 0 && o.batch % 8 == 0 &&
         reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename TO>
int launch_bf16(const void* a, const void* b, void* c, int P, int M, int N,
                int K, Operand oa, Operand ob, Operand oc, cudaStream_t s) {
  const dim3 grid((N + kBfTile - 1) / kBfTile, (M + kBfTile - 1) / kBfTile, P);
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  if (vec_ok(a, oa) && vec_ok(b, ob))
    mm_bf16_kernel<TO, true><<<grid, kBfThreads, 0, s>>>(
        pa, pb, static_cast<TO*>(c), M, N, K, oa, ob, oc);
  else
    mm_bf16_kernel<TO, false><<<grid, kBfThreads, 0, s>>>(
        pa, pb, static_cast<TO*>(c), M, N, K, oa, ob, oc);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point for ctypes.  in_dtype / out_dtype: 0 = float32, 1 = bfloat16.
// Strides in elements: (batch, row, col) for A (P, M, K), B (P, K, N) and
// C (P, M, N).  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int cannon_mm_launch(const void* a, const void* b, void* c, int P,
                                int M, int N, int K, long long a_batch,
                                long long a_row, long long a_col,
                                long long b_batch, long long b_row,
                                long long b_col, long long c_batch,
                                long long c_row, long long c_col,
                                int in_dtype, int out_dtype, void* stream) {
  if (P < 1 || P > 65535 || M < 1 || N < 1 || K < 1 ||
      (M + 127) / 128 > 65535)
    return (int)cudaErrorInvalidValue;
  const Operand oa{a_batch, a_row, a_col}, ob{b_batch, b_row, b_col},
      oc{c_batch, c_row, c_col};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_f32<float>(a, b, c, P, M, N, K, oa, ob, oc, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_f32<bf16>(a, b, c, P, M, N, K, oa, ob, oc, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_bf16<float>(a, b, c, P, M, N, K, oa, ob, oc, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_bf16<bf16>(a, b, c, P, M, N, K, oa, ob, oc, s);
  return (int)cudaErrorInvalidValue;
}
