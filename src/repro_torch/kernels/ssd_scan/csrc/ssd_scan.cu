// Mamba2 SSD chunked scan, the two passes (Hopper).
//
// Replaces the TPU kernels of src/repro/kernels/ssd_scan/kernel.py:
//   * `ssd_chunk_pallas` (body `_chunk_kernel`) -> ssd_chunk_launch: per
//     (batch b, chunk c), with cum = cumsum_t(dt * A) over the chunk,
//       y_intra[t, h, p] = sum_{s<=t} (C_t . B_s) * exp(cum_t - cum_s) * dt_s
//                          * x[s, h, p]                  (rounded to x's type)
//       states[h, n, p]  = sum_s exp(cum_last - cum_s) * dt_s * B[s, n]
//                          * x[s, h, p]                  (fp32)
//       cumexp[t, h]     = exp(cum_t)                    (fp32)
//     with head h reading B/C group h / (H / G).
//   * `ssd_apply_pallas` (body `_apply_kernel`) -> ssd_apply_launch:
//       y[t, h, p] = y_intra[t, h, p] + (C_t . state_in[h, :, p]) * cumexp[t, h]
//     in fp32, rounded to y_intra's type.
// Layouts are the JAX package's: x (B, nc, L, H, P), dt (B, nc, L, H) fp32,
// A (H,) fp32, B/C (B, nc, L, G, N), states (B, nc, H, N, P) fp32.  x, B and
// C are read through a row stride (elements between positions), so the
// column slices of the packed [x | B | C] conv output are read in place.
//
// Design.  The Pallas grid cell holds a whole (L, H, P) chunk and an
// (H, L, L) decay tensor in VMEM; a Hopper block cannot (at L = 256 one
// head's decay tile alone is 256 KB).  So everything is tiled, and every
// product is one shared building block, `TileMac`: a block of 256 threads
// accumulates a 64-row x COLS-column output tile, out[r][c] += M[r][k] *
// X[k][c], over depth tiles of 32 staged in shared memory as fp32.  Each
// thread owns one column and a run of contiguous rows, so it reads its rows
// of M as float4 broadcasts and one X value per depth step.
//   1. `scores_kernel`: the scores C_t . B_s belong to a group, not a head.
//      With G = 1 all 48 heads of mamba2-780m share one (L, L) matrix, so it
//      is computed once per (b, c, g), lower-triangular 64 x 64 tiles only,
//      into a scratch buffer the wrapper allocates (fp32, B*nc*G*L*L).
//   2. `intra_kernel`, one block per (64 rows of t, head h, b*c): builds the
//      decayed weights W[t][s] = scores * exp(cum_t - cum_s) * dt_s for
//      s <= t in shared memory, one 32-wide tile of s at a time, and
//      multiplies them into x.  Tiles above the diagonal are skipped, and
//      inside the diagonal tile s > t selects 0 (never exp of a positive
//      argument), which is exactly the Pallas result, whose masked terms are
//      where(mask, exp(clamped), 0) = 0.  It also writes cumexp for its rows.
//   3. `state_kernel`, one block per (64 states n, head h, b*c): the chunk
//      state as (B * sdecay)^T x over s.
//   4. `apply_kernel`, one block per (64 rows of t, head h, b*c): C . state_in
//      over n, scaled by cumexp, added to y_intra.
// Every block that needs cum computes the chunk's whole cumsum of dt * A
// for its head with the same block scan, so all blocks agree bit for bit;
// it sums in another order than torch.cumsum (warp shuffles, then warps).
// Padding positions carry dt = 0: their W column and their sdecay are 0,
// and cum stays flat across them, so they are state-neutral as the engine
// requires.
//
// Rounding points follow the JAX code: dt * A, (scores * decay) * dt,
// exp(cum_last - cum) * dt and y_intra + y_inter * cumexp are each rounded
// as written (the _rn intrinsics keep nvcc from fusing them into FMAs);
// y_intra is rounded to x's type before the apply pass reads it back.
//
// What bounds it on an H100.  At the main path's largest shape (batch 8,
// L = 256, H = 48, P = 64, N = 128, G = 1) pass 1 moves about 25 MB (its
// fp32 states are 12.6 MB) and does about 3.4 GFLOP (the causal half of
// y_intra and the state product, 1.6 GFLOP each): fp32 arithmetic on the
// CUDA cores bounds it (about 50 us at 67 TFLOP/s) and bytes do not.  The
// apply pass moves about 25 MB and does 1.6 GFLOP: about even.  This first
// version is simple and right: scalar fp32 FMAs fed from shared memory with
// synchronous staging.  wgmma tiles fed by TMA come in a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;     // output rows of a block tile
constexpr int kDepth = 32;    // depth staged per step
constexpr int kPitch = kRows + 4;   // row pitch of the k-major M tile
constexpr int kMaxL = 1024;   // longest chunk a block keeps cum for

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// out[row0 + i][col] += sum_k Mt[k][row0 + i] * X[k][col], i < R.  X has
// row pitch COLS + 1, so stores along k do not collide in one bank.
template <int COLS>
struct TileMac {
  static constexpr int kXPitch = COLS + 1;
  static constexpr int kGroups = kThreads / COLS;
  static constexpr int R = kRows / kGroups;
  static_assert(kThreads % COLS == 0 && kRows % kGroups == 0, "tile");
  float acc[R];
  int col, row0;

  __device__ __forceinline__ void init() {
    col = threadIdx.x % COLS;
    row0 = (threadIdx.x / COLS) * R;
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = 0.f;
  }

  // Mt: the k-major M tile, row pitch kPitch (16-byte aligned rows).
  __device__ __forceinline__ void mac(const float* Mt, const float* X) {
#pragma unroll 4
    for (int k = 0; k < kDepth; ++k) {
      const float xv = X[k * kXPitch + col];
      const float* m = Mt + k * kPitch + row0;
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int i = 0; i < R; i += 4) {
          const float4 mv = *reinterpret_cast<const float4*>(m + i);
          acc[i] += mv.x * xv;
          acc[i + 1] += mv.y * xv;
          acc[i + 2] += mv.z * xv;
          acc[i + 3] += mv.w * xv;
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] += m[i] * xv;
      }
    }
  }
};

// cum[t] = inclusive sum over t' <= t of dt[t'] * a, t < L, into shared
// memory.  The same code runs in every block that needs the chunk's cum.
__device__ void block_cumsum(const float* dt, size_t dt_stride, float a,
                             int L, float* cum, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float carry = 0.f;
  for (int base = 0; base < L; base += kThreads) {
    const int t = base + threadIdx.x;
    float v = t < L ? __fmul_rn(dt[(size_t)t * dt_stride], a) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = __fadd_rn(u, v);
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float before = carry, total = carry;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (w < warp) before = __fadd_rn(before, warp_tot[w]);
      total = __fadd_rn(total, warp_tot[w]);
    }
    if (t < L) cum[t] = __fadd_rn(before, v);
    carry = total;
    __syncthreads();
  }
}

// Stage X[k][c] = src[(s0 + k) * row_stride + c] for k < kDepth, c < COLS,
// as fp32 (0 past `rows`).
template <int COLS, typename T>
__device__ __forceinline__ void stage_x(float* X, const T* src,
                                        size_t row_stride, int s0, int rows) {
  for (int i = threadIdx.x; i < kDepth * COLS; i += kThreads) {
    const int k = i / COLS, c = i % COLS;
    X[k * (COLS + 1) + c] =
        s0 + k < rows ? to_f32(src[(size_t)(s0 + k) * row_stride + c]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// Pass 1a: scores[bcg][t][s] = C[t] . B[s] for the lower-triangular tiles.
// grid (L/64 t tiles, L/64 s tiles, B*nc*G).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
              float* __restrict__ scores, int L, int G, int N, size_t b_row,
              size_t c_row) {
  const int tt = blockIdx.x, st = blockIdx.y;
  if (st > tt) return;
  const int bcg = blockIdx.z, bc = bcg / G, g = bcg % G;
  const int t0 = tt * kRows, s0 = st * kRows;
  __shared__ __align__(16) float Mt[kDepth][kPitch];
  __shared__ float X[kDepth * (kRows + 1)];
  const T* C = Cm + (size_t)bc * L * c_row + (size_t)g * N;
  const T* Bp = Bm + (size_t)bc * L * b_row + (size_t)g * N;
  TileMac<kRows> tm;
  tm.init();
  for (int n0 = 0; n0 < N; n0 += kDepth) {
    for (int i = threadIdx.x; i < kDepth * kRows; i += kThreads) {
      const int k = i % kDepth, r = i / kDepth;
      const bool kin = n0 + k < N;
      Mt[k][r] =
          kin && t0 + r < L ? to_f32(C[(t0 + r) * c_row + n0 + k]) : 0.f;
      X[k * (kRows + 1) + r] =
          kin && s0 + r < L ? to_f32(Bp[(s0 + r) * b_row + n0 + k]) : 0.f;
    }
    __syncthreads();
    tm.mac(&Mt[0][0], X);
    __syncthreads();
  }
  float* out = scores + (size_t)bcg * L * L;
#pragma unroll
  for (int i = 0; i < TileMac<kRows>::R; ++i) {
    const int t = t0 + tm.row0 + i, s = s0 + tm.col;
    if (t < L && s < L) out[(size_t)t * L + s] = tm.acc[i];
  }
}

// ---------------------------------------------------------------------------
// Pass 1b: y_intra and cumexp.  grid (L/64 t tiles, H, B*nc).
// ---------------------------------------------------------------------------
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
intra_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const float* __restrict__ scores,
             T* __restrict__ y, float* __restrict__ cumexp, int L, int H,
             int G, size_t x_row) {
  const int t0 = blockIdx.x * kRows, h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  __shared__ float cum[kMaxL];
  __shared__ float warp_tot[kThreads / 32];
  __shared__ float dts[kDepth];
  __shared__ __align__(16) float Mt[kDepth][kPitch];
  __shared__ float X[kDepth * (P + 1)];
  const float* dtp = dt + (size_t)bc * L * H + h;
  block_cumsum(dtp, H, A[h], L, cum, warp_tot);
  if (threadIdx.x < kRows && t0 + threadIdx.x < L) {
    const int t = t0 + threadIdx.x;
    cumexp[((size_t)bc * L + t) * H + h] = expf(cum[t]);
  }
  const float* sc = scores + ((size_t)bc * G + g) * L * L;
  const T* xh = x + (size_t)bc * L * x_row + (size_t)h * P;
  TileMac<P> tm;
  tm.init();
  const int s_end = min(t0 + kRows, L);
  for (int s0 = 0; s0 < s_end; s0 += kDepth) {
    if (threadIdx.x < kDepth)
      dts[threadIdx.x] =
          s0 + threadIdx.x < L ? dtp[(size_t)(s0 + threadIdx.x) * H] : 0.f;
    __syncthreads();
    for (int i = threadIdx.x; i < kDepth * kRows; i += kThreads) {
      const int k = i % kDepth, r = i / kDepth;
      const int s = s0 + k, t = t0 + r;
      float w = 0.f;
      if (s <= t && t < L) {
        const float decay = expf(__fsub_rn(cum[t], cum[s]));
        w = __fmul_rn(__fmul_rn(sc[(size_t)t * L + s], decay), dts[k]);
      }
      Mt[k][r] = w;
    }
    stage_x<P>(X, xh, x_row, s0, L);
    __syncthreads();
    tm.mac(&Mt[0][0], X);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TileMac<P>::R; ++i) {
    const int t = t0 + tm.row0 + i;
    if (t < L) store(&y[((size_t)bc * L + t) * H * P + (size_t)h * P + tm.col],
                     tm.acc[i]);
  }
}

// ---------------------------------------------------------------------------
// Pass 1c: chunk states.  grid (N/64 state tiles, H, B*nc).
// ---------------------------------------------------------------------------
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const T* __restrict__ Bm,
             float* __restrict__ states, int L, int H, int G, int N,
             size_t x_row, size_t b_row) {
  const int n0 = blockIdx.x * kRows, h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  __shared__ float cum[kMaxL];
  __shared__ float warp_tot[kThreads / 32];
  __shared__ float sdec[kDepth];
  __shared__ __align__(16) float Mt[kDepth][kPitch];
  __shared__ float X[kDepth * (P + 1)];
  const float* dtp = dt + (size_t)bc * L * H + h;
  block_cumsum(dtp, H, A[h], L, cum, warp_tot);
  const float last = cum[L - 1];
  const T* Bp = Bm + (size_t)bc * L * b_row + (size_t)g * N;
  const T* xh = x + (size_t)bc * L * x_row + (size_t)h * P;
  TileMac<P> tm;
  tm.init();
  for (int s0 = 0; s0 < L; s0 += kDepth) {
    if (threadIdx.x < kDepth) {
      const int s = s0 + threadIdx.x;
      sdec[threadIdx.x] =
          s < L ? __fmul_rn(expf(__fsub_rn(last, cum[s])), dtp[(size_t)s * H])
                : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kDepth * kRows; i += kThreads) {
      const int r = i % kRows, k = i / kRows;
      const int s = s0 + k, n = n0 + r;
      Mt[k][r] = s < L && n < N
                     ? __fmul_rn(sdec[k], to_f32(Bp[(size_t)s * b_row + n]))
                     : 0.f;
    }
    stage_x<P>(X, xh, x_row, s0, L);
    __syncthreads();
    tm.mac(&Mt[0][0], X);
    __syncthreads();
  }
  float* out = states + ((size_t)bc * H + h) * N * P;
#pragma unroll
  for (int i = 0; i < TileMac<P>::R; ++i) {
    const int n = n0 + tm.row0 + i;
    if (n < N) out[(size_t)n * P + tm.col] = tm.acc[i];
  }
}

// ---------------------------------------------------------------------------
// Pass 2: y = y_intra + (C . state_in) * cumexp.  grid (L/64, H, B*nc).
// ---------------------------------------------------------------------------
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ yi, const T* __restrict__ Cm,
             const float* __restrict__ cumexp,
             const float* __restrict__ s_in, T* __restrict__ out, int L,
             int H, int G, int N, size_t c_row) {
  const int t0 = blockIdx.x * kRows, h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / G);
  __shared__ __align__(16) float Mt[kDepth][kPitch];
  __shared__ float X[kDepth * (P + 1)];
  const T* C = Cm + (size_t)bc * L * c_row + (size_t)g * N;
  const float* S = s_in + ((size_t)bc * H + h) * N * P;
  TileMac<P> tm;
  tm.init();
  for (int n0 = 0; n0 < N; n0 += kDepth) {
    for (int i = threadIdx.x; i < kDepth * kRows; i += kThreads) {
      const int k = i % kDepth, r = i / kDepth;
      Mt[k][r] = n0 + k < N && t0 + r < L
                     ? to_f32(C[(size_t)(t0 + r) * c_row + n0 + k])
                     : 0.f;
    }
    stage_x<P>(X, S, P, n0, N);
    __syncthreads();
    tm.mac(&Mt[0][0], X);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TileMac<P>::R; ++i) {
    const int t = t0 + tm.row0 + i;
    if (t < L) {
      const size_t o = ((size_t)bc * L + t) * H * P + (size_t)h * P + tm.col;
      const float ce = cumexp[((size_t)bc * L + t) * H + h];
      store(&out[o], __fadd_rn(to_f32(yi[o]), __fmul_rn(tm.acc[i], ce)));
    }
  }
}

template <int P, typename T>
int chunk_launch(const void* x, const float* dt, const float* A,
                 const void* Bm, const void* Cm, void* y, float* states,
                 float* cumexp, float* scores, int Bsz, int nc, int L, int H,
                 int G, int N, size_t x_row, size_t b_row, size_t c_row,
                 cudaStream_t st) {
  const int bc = Bsz * nc, tl = (L + kRows - 1) / kRows;
  scores_kernel<T><<<dim3(tl, tl, bc * G), kThreads, 0, st>>>(
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), scores, L, G, N,
      b_row, c_row);
  intra_kernel<P, T><<<dim3(tl, H, bc), kThreads, 0, st>>>(
      static_cast<const T*>(x), dt, A, scores, static_cast<T*>(y), cumexp, L,
      H, G, x_row);
  state_kernel<P, T><<<dim3((N + kRows - 1) / kRows, H, bc), kThreads, 0,
                       st>>>(static_cast<const T*>(x), dt, A,
                             static_cast<const T*>(Bm), states, L, H, G, N,
                             x_row, b_row);
  return static_cast<int>(cudaGetLastError());
}

template <int P, typename T>
int apply_launch(const void* yi, const void* Cm, const float* cumexp,
                 const float* s_in, void* out, int Bsz, int nc, int L, int H,
                 int G, int N, size_t c_row, cudaStream_t st) {
  apply_kernel<P, T><<<dim3((L + kRows - 1) / kRows, H, Bsz * nc), kThreads,
                       0, st>>>(static_cast<const T*>(yi),
                                static_cast<const T*>(Cm), cumexp, s_in,
                                static_cast<T*>(out), L, H, G, N, c_row);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int chunk_dispatch(int P, const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, void* y, float* states,
                   float* cumexp, float* scores, int Bsz, int nc, int L,
                   int H, int G, int N, size_t x_row, size_t b_row,
                   size_t c_row, cudaStream_t st) {
  switch (P) {
#define SSD_CASE(PV)                                                        \
  case PV:                                                                  \
    return chunk_launch<PV, T>(x, dt, A, Bm, Cm, y, states, cumexp, scores, \
                               Bsz, nc, L, H, G, N, x_row, b_row, c_row, st);
    SSD_CASE(8) SSD_CASE(16) SSD_CASE(32) SSD_CASE(64) SSD_CASE(128)
#undef SSD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int apply_dispatch(int P, const void* yi, const void* Cm, const float* cumexp,
                   const float* s_in, void* out, int Bsz, int nc, int L,
                   int H, int G, int N, size_t c_row, cudaStream_t st) {
  switch (P) {
#define SSD_CASE(PV)                                                      \
  case PV:                                                                \
    return apply_launch<PV, T>(yi, Cm, cumexp, s_in, out, Bsz, nc, L, H, G, \
                               N, c_row, st);
    SSD_CASE(8) SSD_CASE(16) SSD_CASE(32) SSD_CASE(64) SSD_CASE(128)
#undef SSD_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Longest chunk the kernels take (the wrapper refuses longer ones).
int ssd_max_chunk() { return kMaxL; }

// Pass 1.  x/Bm/Cm/y are float (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// x_row, b_row and c_row are the elements between consecutive positions of
// x, Bm and Cm (H*P and G*N when contiguous); y is contiguous.  scores is
// fp32 scratch of B*nc*G*L*L.  Returns the CUDA error of the launches
// (0 = launched).
int ssd_chunk_launch(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, void* y, float* states,
                     float* cumexp, float* scores, int Bsz, int nc, int L,
                     int H, int P, int G, int N, int x_row, int b_row,
                     int c_row, int is_bf16, void* stream) {
  if (L < 1 || L > kMaxL || G < 1 || H % G || x_row < 0 || b_row < 0 ||
      c_row < 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? chunk_dispatch<__nv_bfloat16>(P, x, dt, A, Bm, Cm, y,
                                                 states, cumexp, scores, Bsz,
                                                 nc, L, H, G, N, x_row, b_row,
                                                 c_row, st)
                 : chunk_dispatch<float>(P, x, dt, A, Bm, Cm, y, states,
                                         cumexp, scores, Bsz, nc, L, H, G, N,
                                         x_row, b_row, c_row, st);
}

// Pass 2.  y_intra/Cm/out share float or bfloat16; cumexp and states_in
// are fp32.  c_row is the elements between consecutive positions of Cm;
// the other operands are contiguous.
int ssd_apply_launch(const void* yi, const void* Cm, const float* cumexp,
                     const float* states_in, void* out, int Bsz, int nc,
                     int L, int H, int P, int G, int N, int c_row,
                     int is_bf16, void* stream) {
  if (L < 1 || G < 1 || H % G || c_row < 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? apply_dispatch<__nv_bfloat16>(P, yi, Cm, cumexp, states_in,
                                                 out, Bsz, nc, L, H, G, N,
                                                 c_row, st)
                 : apply_dispatch<float>(P, yi, Cm, cumexp, states_in, out,
                                         Bsz, nc, L, H, G, N, c_row, st);
}

}  // extern "C"
