// Mamba2 SSD chunked scan (Hopper): the chunk pass, the apply pass, and the
// two fused into one launch for a sequence of one chunk.
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
//   * both, for one chunk (the engine's every call) -> ssd_fused_launch: the
//     state entering the chunk is `init` and the one leaving it is
//     exp(cum_last) * init + states, so one launch computes
//       y     = bf16(bf16(y_intra) + (C_t . init) * exp(cum_t))
//       final = exp(cum_last) * init + states
//     with the JAX package's rounding points, and writes neither y_intra nor
//     states nor cumexp to device memory.
// Layouts are the JAX package's: x (B, nc, L, H, P), dt (B, nc, L, H) fp32,
// A (H,) fp32, B/C (B, nc, L, G, N), states (B, nc, H, N, P) fp32.  x, B and
// C are read through a row stride (elements between positions), so the
// column slices of the packed [x | B | C] conv output are read in place.
//
// Two variants; kernel.py::plan picks one from the dtype and N:
//
// mma (bf16 x, N <= 128; every call of the served model).  One block of 8
// warps per (tile of 128 rows t, head h, b * nc); warp w owns rows
// 16 w .. 16 w + 15 of the tile, and every product is mma.sync m16n8k16 with
// bf16 operands and fp32 accumulators (../../csrc/mma_tile.cuh, shared with
// the attention kernels).  The block walks s in tiles of 64 rows staged by
// 16-byte cp.async in two stages (scalar loads when a layout is not 16-byte
// aligned; plan decides), x and B of one tile side by side, and per slice
// of 16 s:
//   * S = C_t B_s^T for the warp's 16 rows: C rows sit in shared memory for
//     the whole block and feed A fragments, B_s feeds B fragments; S never
//     leaves registers and no scores scratch exists;
//   * W = (S * exp(cum_t - cum_s)) * dt_s for s <= t (the JAX order, each
//     product rounded: the _rn intrinsics keep nvcc from fusing them); s > t
//     selects 0 and never takes exp of a positive argument, exactly the
//     Pallas result where(mask, exp(clamped), 0) = 0;
//   * W is fp32: it goes in as bf16 hi + lo parts (residual about 2^-17),
//     and the S accumulator of an m16n8 pair is, pair by pair, the A
//     fragment of W x, with x read through ldmatrix.trans;
//   * the chunk state (sdecay o B)^T x over the same staged tile: warp w
//     owns state rows 16 w .. 16 w + 15, its A fragments are B_s through
//     ldmatrix.trans scaled by sdecay_s = exp(cum_last - cum_s) * dt_s and
//     split into hi + lo.  So each tile is read once for both products.
// Only the block that holds the chunk's last row needs the state, and it
// walks every s tile anyway; tiles of rows before it stop at their last
// row.  Blocks are launched last tile first (the longest).  The apply
// term C_t . state_in multiplies C's A fragments by state_in split into hi
// + lo (state_in is fp32) from shared memory, then * cumexp and + y_intra
// as written.  x, B, C arrive in bf16 and the JAX kernel widens them to
// fp32 (kernel.py:33-37), so every product here is that fp32 product: the
// bf16 factors are exact and each fp32 factor is carried to about 2^-17.
//
// simt (fp32 x, where the fp32 gates of 1e-4 would not hold for x split
// into bf16 parts; and bf16 with N > 128).  Scalar fp32 FMAs on the CUDA
// cores, `TileMac` below: 64-row tiles of t, depth 32; one launch whose
// first blocks build S, W and y_intra per tile of t (scores in shared
// memory, never in device memory) and whose last blocks build the state
// per tile of 64 rows n.  Its apply pass is `apply_simt_kernel`.
//
// Every block that needs cum computes the chunk's cumsum of dt * A up to its
// last row with the same block scan, so all blocks agree bit for bit; it
// sums in another order than torch.cumsum (warp shuffles, then warps).
// Padding positions carry dt = 0: their W column and their sdecay are 0,
// and cum stays flat across them, so they are state-neutral as the engine
// requires.
//
// What bounds it on an H100.  At the main path's largest shape (batch 8,
// L = 256, H = 48, P = 64, N = 128, G = 1, bf16) the fused launch must move
// about 52 MB (x, y, init and final at 12.6 MB each) and do about 4.9
// GFLOP of products: bytes bound it, 15.5 us at 3.35 TB/s, against 5 us of
// bf16 tensor work.  mma.sync with the hi + lo split doubles the tensor
// work of the three fp32-factor products, and the exp and split of every
// W element run on the CUDA cores beside it.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "../../csrc/launch_status.cuh"
#include "../../csrc/mma_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxL = 1024;     // longest chunk a block keeps cum for
constexpr int kMaxDevices = 64;  // shared-memory grants kept per device

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

// The shared-memory limit is a per-device attribute: grant it once on each
// device a kernel launches on.
// Returns 0 or the launch_status code of the failed step.
template <typename Kernel>
int grant_smem(Kernel kernel, size_t smem, bool (&granted)[kMaxDevices]) {
  namespace ls = launch_status;
  int dev = 0;   // the launcher bound the thread to its tensors' device
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return ls::fail(ls::kDevice, e);
  if (dev >= kMaxDevices)
    return ls::fail(ls::kDevice, cudaErrorInvalidDevice);
  if (!granted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return ls::fail(ls::kSmem, e);
    granted[dev] = true;
  }
  return 0;
}

// ===========================================================================
// mma: bf16 operands on the tensor cores.
// ===========================================================================

namespace mma {

constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;     // t rows per block, 16 per warp
constexpr int kS = 64;                 // s rows per staged tile
constexpr int kMaxN = 16 * kWarps;     // N the kernels take, 16 per warp

using bf16 = __nv_bfloat16;

template <int P>
struct Geo {
  static constexpr int PP = P < 16 ? 16 : P;   // head dim padded to k16
  static constexpr int XP = PP + 8;            // bf16 pitch of x rows
  static constexpr int IP = PP + 4;            // fp32 pitch of state rows
  static constexpr int NT = PP / 8;            // n8 tiles over the head dim
};

// Byte offsets into the dynamic shared memory.  Rows of bf16 tiles are
// padded by 16 bytes so ldmatrix reads them without bank conflicts.
struct Layout {
  int NP, BP;            // N padded to 16; bf16 pitch of B and C rows
  size_t cum, dtv, sdec, c, work, x_bytes, stage_bytes, bytes;
};

template <int P>
__host__ __device__ inline Layout scan_layout(int L, int N) {
  Layout o;
  o.NP = (N + 15) / 16 * 16;
  o.BP = o.NP + 8;
  const size_t lr = (size_t)(L + 3) / 4 * 4 * sizeof(float);
  o.cum = 0;
  o.dtv = o.cum + lr;
  o.sdec = o.dtv + lr;
  o.c = o.sdec + lr;
  o.work = o.c + (size_t)kRows * o.BP * sizeof(bf16);
  o.x_bytes = (size_t)kS * Geo<P>::XP * sizeof(bf16);
  o.stage_bytes = o.x_bytes + (size_t)kS * o.BP * sizeof(bf16);
  size_t work = 2 * o.stage_bytes;     // two stages of (x tile, B tile)
  const size_t init = (size_t)kMaxN * Geo<P>::IP * sizeof(float);
  if (init > work) work = init;        // the state rows reuse the stages
  o.bytes = o.work + work;
  return o;
}

template <int P>
__host__ __device__ inline Layout apply_layout(int N) {
  Layout o = {};
  o.NP = (N + 15) / 16 * 16;
  o.BP = o.NP + 8;
  o.c = 0;
  o.work = (size_t)kRows * o.BP * sizeof(bf16);
  o.bytes = o.work + (size_t)kMaxN * Geo<P>::IP * sizeof(float);
  return o;
}

// Rows r0 .. r0 + n_rows - 1 of a bf16 matrix with `row_stride` elements
// between rows, columns 0 .. width - 1 (width a multiple of 8), into shared
// rows of `pitch` elements; zero past `rows` and past `cols`.  async: 16-byte
// cp.async (src, row_stride and cols 16-byte multiples; plan checks), else
// scalar loads.
__device__ __forceinline__ void stage_rows(bf16* dst, int pitch, int width,
                                           const bf16* src,
                                           size_t row_stride, int r0,
                                           int n_rows, int rows, int cols,
                                           bool async) {
  const int chunks = width / 8;
  for (int i = threadIdx.x; i < n_rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i - r * chunks) * 8, row = r0 + r;
    bf16* d = dst + r * pitch + c;
    if (async) {
      const bool ok = row < rows && c < cols;
      tile::cp_async16(d, src + (ok ? (size_t)row * row_stride + c : 0),
                       ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = row < rows && c + e < cols
                   ? src[(size_t)row * row_stride + c + e]
                   : __float2bfloat16_rn(0.f);
    }
  }
}

// One head's fp32 (N, P) state into kMaxN shared rows of IP floats, zero
// past N and past P (rows past N meet C's zero
// columns, and 0 * garbage could be NaN); 16-byte cp.async when `src` is
// 16-byte aligned (rows of P floats are), else scalar loads.
template <int P>
__device__ __forceinline__ void stage_state_rows(float* dst, const float* src,
                                                 int N, bool async) {
  constexpr int PP = Geo<P>::PP, IP = Geo<P>::IP, CH = PP / 4;
  for (int i = threadIdx.x; i < kMaxN * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * 4, n = r;
    const bool ok = n < N && c < P;
    float* d = dst + r * IP + c;
    if (async) {
      tile::cp_async16(d, src + (ok ? (size_t)n * P + c : 0), ok ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = ok ? src[(size_t)n * P + c + e] : 0.f;
    }
  }
}

// Rows of a tile that a block reads: those up to `live` rounded up to a
// whole 16-row slice, at most `cap`.
__device__ __forceinline__ int slice_rows(int live, int cap) {
  return min(cap, (live + 15) / 16 * 16);
}

// acc += C_rows . state[0 .. 16 nk) for one warp's 16 rows: C as A
// fragments from shared rows c_w (pitch BP), the fp32 state rows st_s
// (pitch IP) as B fragments split into bf16 hi + lo.
template <int P>
__device__ __forceinline__ void apply_rows(float (&acc)[Geo<P>::NT][4],
                                           const bf16* c_w, int BP,
                                           const float* st_s, int nk,
                                           int lane) {
  constexpr int IP = Geo<P>::IP;
  const int gid = lane >> 2, tig = lane & 3;
  const int arow = lane & 15, acol = (lane >> 4) << 3;
  for (int kc = 0; kc < nk; ++kc) {
    uint32_t af[4];
    tile::ldmatrix_x4(af, c_w + arow * BP + kc * 16 + acol);
    const float* col = st_s + (kc * 16 + 2 * tig) * IP + gid;
#pragma unroll
    for (int nt = 0; nt < Geo<P>::NT; ++nt) {
      const float* q = col + nt * 8;
      uint32_t h0, l0, h1, l1;
      tile::split_pair(q[0], q[IP], h0, l0);
      tile::split_pair(q[8 * IP], q[9 * IP], h1, l1);
      tile::mma_bf16(acc[nt], af, h0, h1);
      tile::mma_bf16(acc[nt], af, l0, l1);
    }
  }
}

struct ScanArgs {
  const bf16* x;
  const float* dt;
  const float* A;
  const bf16* Bm;
  const bf16* Cm;
  const float* init;    // fused: (B, H, N, P) fp32
  bf16* y;              // chunk: y_intra (B, nc, L, H, P); fused: y
  float* states;        // chunk: (B, nc, H, N, P); fused: final (B, H, N, P)
  float* cumexp;        // chunk: (B, nc, L, H); fused: unused
  int L, H, G, N;
  long long x_row, b_row, c_row;
  int async;
  int state_async;      // init 16-byte aligned
};

// One block: rows t0 .. t0 + 127 of chunk blockIdx.y, head blockIdx.x;
// blockIdx.z counts the row tiles from the last (the longest) down, so the
// longest blocks of the whole grid go first.
template <int P, bool kFused>
__device__ __forceinline__ void scan_block(const ScanArgs& a) {
  using Gm = Geo<P>;
  constexpr int PP = Gm::PP, XP = Gm::XP, IP = Gm::IP, NT = Gm::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_tot[kWarps];
  const int L = a.L, H = a.H, N = a.N;
  const Layout lo = scan_layout<P>(L, N);
  float* cum = reinterpret_cast<float*>(smem + lo.cum);
  float* dtv = reinterpret_cast<float*>(smem + lo.dtv);
  float* sdec = reinterpret_cast<float*>(smem + lo.sdec);
  bf16* c_s = reinterpret_cast<bf16*>(smem + lo.c);
  unsigned char* work = smem + lo.work;

  const int pass = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, bc = blockIdx.y, g = h / (H / a.G);
  const int t0 = pass * kRows, t_end = min(t0 + kRows, L);
  const bool has_state = t_end == L;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = t0 + 16 * warp;                // this warp's first row
  const bool rows_live = r0 < L;
  const bool async = a.async != 0;

  const float* dtp = a.dt + (size_t)bc * L * H + h;
  const bf16* xh = a.x + (size_t)bc * L * a.x_row + (size_t)h * P;
  const bf16* bg = a.Bm + (size_t)bc * L * a.b_row + (size_t)g * N;
  const bf16* cg = a.Cm + (size_t)bc * L * a.c_row + (size_t)g * N;

  // this block's C rows, in flight during the cumsum
  stage_rows(c_s, lo.BP, lo.NP, cg, a.c_row, t0,
             slice_rows(t_end - t0, kRows), L, N, async);
  tile::cp_async_commit();
  block_cumsum(dtp, H, a.A[h], t_end, cum, warp_tot);
  for (int t = tid; t < t_end; t += kThreads) dtv[t] = dtp[(size_t)t * H];
  if (has_state)
    for (int s = tid; s < L; s += kThreads)
      sdec[s] = __fmul_rn(expf(__fsub_rn(cum[L - 1], cum[s])),
                          dtp[(size_t)s * H]);
  if (!kFused)
    for (int t = t0 + tid; t < t_end; t += kThreads)
      a.cumexp[((size_t)bc * L + t) * H + h] = expf(cum[t]);
  // (the first barrier of the s walk publishes dtv and sdec)

  float cum_t[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + gid + 8 * i;
    cum_t[i] = t < t_end ? cum[t] : 0.f;
  }

  float yacc[NT][4], aacc[NT][4], sacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[n][e] = 0.f;

  const int n_st = (t_end + kS - 1) / kS;
  const bf16* c_w = c_s + 16 * warp * lo.BP;
  // ldmatrix lane offsets: A fragments (rows lane % 16, column 8 (lane /
  // 16)); B fragments of B_s (keys); x through .trans; B_s through .trans
  const int arow = lane & 15, acol = (lane >> 4) << 3;
  const int bkey = (lane & 7) + ((lane >> 4) << 3);
  const int bcol = ((lane >> 3) & 1) << 3;
  const int xkey = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int xcol = (lane >> 4) << 3;
  // warp w builds state rows 16 w .. 16 w + 15
  const bool s_work = has_state && warp * 16 < lo.NP;

#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
  auto stage = [&](int j) {
    bf16* xs = reinterpret_cast<bf16*>(work + (j & 1) * lo.stage_bytes);
    bf16* bs = reinterpret_cast<bf16*>(work + (j & 1) * lo.stage_bytes +
                                       lo.x_bytes);
    const int n = slice_rows(t_end - j * kS, kS);
    stage_rows(xs, XP, PP, xh, a.x_row, j * kS, n, L, P, async);
    stage_rows(bs, lo.BP, lo.NP, bg, a.b_row, j * kS, n, L, N, async);
  };
  stage(0);
  tile::cp_async_commit();
  for (int j = 0; j < n_st; ++j) {
    tile::cp_async_wait<0>();
    __syncthreads();              // tile j landed; every warp is past j - 1
    if (j + 1 < n_st) stage(j + 1);
    tile::cp_async_commit();
    const bf16* xs =
        reinterpret_cast<const bf16*>(work + (j & 1) * lo.stage_bytes);
    const bf16* bs = reinterpret_cast<const bf16*>(
        work + (j & 1) * lo.stage_bytes + lo.x_bytes);
#pragma unroll 1
    for (int kk = 0; kk < kS / 16; ++kk) {
      const int sb = j * kS + kk * 16;
      if (sb >= t_end) break;
      const bool yk = rows_live && sb <= r0 + 15;
      if (!yk && !s_work) continue;
      uint32_t whi[4], wlo[4], shi[4], slo[4];
      if (yk) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 4
        for (int kc = 0; kc < lo.NP / 16; ++kc) {
          uint32_t af[4], bf[4];
          tile::ldmatrix_x4(af, c_w + arow * lo.BP + kc * 16 + acol);
          tile::ldmatrix_x4(bf, bs + (kk * 16 + bkey) * lo.BP + kc * 16 +
                                    bcol);
          tile::mma_bf16(sc[0], af, bf[0], bf[1]);
          tile::mma_bf16(sc[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int jn = 0; jn < 2; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = r0 + gid + 8 * (e >> 1);
            const int s = sb + 8 * jn + 2 * tig + (e & 1);
            float w = 0.f;
            if (s <= t && t < L)
              w = __fmul_rn(
                  __fmul_rn(sc[jn][e], expf(__fsub_rn(cum_t[e >> 1], cum[s]))),
                  dtv[s]);
            sc[jn][e] = w;
          }
        tile::split_pair(sc[0][0], sc[0][1], whi[0], wlo[0]);
        tile::split_pair(sc[0][2], sc[0][3], whi[1], wlo[1]);
        tile::split_pair(sc[1][0], sc[1][1], whi[2], wlo[2]);
        tile::split_pair(sc[1][2], sc[1][3], whi[3], wlo[3]);
      }
      if (s_work) {
        uint32_t ab[4];
        tile::ldmatrix_x4_trans(
            ab, bs + (kk * 16 + xcol + (lane & 7)) * lo.BP + warp * 16 + bcol);
        const int s_a = sb + 2 * tig, s_b = s_a + 8;
        const float d[4] = {s_a < L ? sdec[s_a] : 0.f,
                            s_a + 1 < L ? sdec[s_a + 1] : 0.f,
                            s_b < L ? sdec[s_b] : 0.f,
                            s_b + 1 < L ? sdec[s_b + 1] : 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&ab[i]));
          const int k = (i >> 1) * 2;     // a0, a1: s_a; a2, a3: s_b
          tile::split_pair(__fmul_rn(d[k], v.x), __fmul_rn(d[k + 1], v.y),
                           shi[i], slo[i]);
        }
      }
#pragma unroll
      for (int dp = 0; dp < PP / 16; ++dp) {
        uint32_t b[4];
        tile::ldmatrix_x4_trans(b, xs + (kk * 16 + xkey) * XP + dp * 16 +
                                       xcol);
        if (yk) {
          tile::mma_bf16(yacc[2 * dp], whi, b[0], b[1]);
          tile::mma_bf16(yacc[2 * dp + 1], whi, b[2], b[3]);
          tile::mma_bf16(yacc[2 * dp], wlo, b[0], b[1]);
          tile::mma_bf16(yacc[2 * dp + 1], wlo, b[2], b[3]);
        }
        if (s_work) {
          tile::mma_bf16(sacc[2 * dp], shi, b[0], b[1]);
          tile::mma_bf16(sacc[2 * dp + 1], shi, b[2], b[3]);
          tile::mma_bf16(sacc[2 * dp], slo, b[0], b[1]);
          tile::mma_bf16(sacc[2 * dp + 1], slo, b[2], b[3]);
        }
      }
    }
  }

  if (kFused) {
    // init rows once, for the final state and for the apply term
    __syncthreads();              // every warp is done with the stages
    float* init_s = reinterpret_cast<float*>(work);
    stage_state_rows<P>(init_s, a.init + ((size_t)bc * H + h) * N * P, N,
                        a.state_async != 0);
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    __syncthreads();
    if (s_work) {
      const float dl = expf(cum[L - 1]);
      float* fh = a.states + ((size_t)bc * H + h) * N * P;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int n = warp * 16 + gid + 8 * i, p = nt * 8 + 2 * tig;
          if (n >= N || p >= P) continue;
          const float* is = init_s + n * IP + p;
          *reinterpret_cast<float2*>(fh + (size_t)n * P + p) = make_float2(
              __fadd_rn(__fmul_rn(dl, is[0]), sacc[nt][2 * i]),
              __fadd_rn(__fmul_rn(dl, is[1]), sacc[nt][2 * i + 1]));
        }
    }
    if (rows_live) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) aacc[n][e] = 0.f;
      apply_rows<P>(aacc, c_w, lo.BP, init_s, lo.NP / 16, lane);
    }
  } else if (s_work) {
    float* sh = a.states + ((size_t)bc * H + h) * N * P;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = warp * 16 + gid + 8 * i, p = nt * 8 + 2 * tig;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(sh + (size_t)n * P + p) =
              make_float2(sacc[nt][2 * i], sacc[nt][2 * i + 1]);
      }
  }

  if (!rows_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + gid + 8 * i;
    if (t >= L) continue;
    bf16* yr = a.y + ((size_t)bc * L + t) * H * P + (size_t)h * P;
    const float ce = kFused ? expf(cum_t[i]) : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = nt * 8 + 2 * tig;
      if (p >= P) continue;
      // y_intra rounded to x's type first, as the JAX code stores it
      const float2 yi = __bfloat1622float2(__floats2bfloat162_rn(
          yacc[nt][2 * i], yacc[nt][2 * i + 1]));
      *reinterpret_cast<__nv_bfloat162*>(yr + p) =
          kFused ? __floats2bfloat162_rn(
                       __fadd_rn(yi.x, __fmul_rn(aacc[nt][2 * i], ce)),
                       __fadd_rn(yi.y, __fmul_rn(aacc[nt][2 * i + 1], ce)))
                 : __floats2bfloat162_rn(yi.x, yi.y);
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads, P < 128 ? 2 : 1)
    chunk_mma_kernel(const ScanArgs a) {
  scan_block<P, false>(a);
}

template <int P>
__global__ void __launch_bounds__(kThreads, P < 128 ? 2 : 1)
    fused_mma_kernel(const ScanArgs a) {
  scan_block<P, true>(a);
}

struct ApplyArgs {
  const bf16* yi;
  const bf16* Cm;
  const float* cumexp;
  const float* s_in;
  bf16* out;
  int L, H, G, N;
  long long c_row;
  int async;
  int state_async;      // s_in 16-byte aligned
};

// y = y_intra + (C . state_in) * cumexp for rows t0 .. t0 + 127 of chunk
// blockIdx.z, head blockIdx.y: the fused kernel's apply term.
template <int P>
__global__ void __launch_bounds__(kThreads, P < 128 ? 2 : 1)
    apply_mma_kernel(const ApplyArgs a) {
  constexpr int NT = Geo<P>::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = a.L, H = a.H, N = a.N;
  const Layout lo = apply_layout<P>(N);
  bf16* c_s = reinterpret_cast<bf16*>(smem + lo.c);
  float* st_s = reinterpret_cast<float*>(smem + lo.work);
  const int t0 = blockIdx.x * kRows, h = blockIdx.y, bc = blockIdx.z;
  const int g = h / (H / a.G);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = t0 + 16 * warp;
  stage_rows(c_s, lo.BP, lo.NP, a.Cm + (size_t)bc * L * a.c_row +
                                    (size_t)g * N,
             a.c_row, t0, slice_rows(L - t0, kRows), L, N, a.async != 0);
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  stage_state_rows<P>(st_s, a.s_in + ((size_t)bc * H + h) * N * P, N,
                      a.state_async != 0);
  tile::cp_async_commit();
  tile::cp_async_wait<0>();
  __syncthreads();
  if (r0 < L)
    apply_rows<P>(acc, c_s + 16 * warp * lo.BP, lo.BP, st_s, lo.NP / 16,
                  lane);
  if (r0 >= L) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = r0 + gid + 8 * i;
    if (t >= L) continue;
    const size_t row = ((size_t)bc * L + t) * H * P + (size_t)h * P;
    const float ce = a.cumexp[((size_t)bc * L + t) * H + h];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int p = nt * 8 + 2 * tig;
      if (p >= P) continue;
      const float2 yi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(a.yi + row + p));
      *reinterpret_cast<__nv_bfloat162*>(a.out + row + p) =
          __floats2bfloat162_rn(
              __fadd_rn(yi.x, __fmul_rn(acc[nt][2 * i], ce)),
              __fadd_rn(yi.y, __fmul_rn(acc[nt][2 * i + 1], ce)));
    }
  }
}

template <int P>
int launch_scan(const ScanArgs& a, int n_bc, bool fused, cudaStream_t st) {
  const size_t smem = scan_layout<P>(a.L, a.N).bytes;
  static bool granted[2][kMaxDevices] = {};
  const size_t most = scan_layout<P>(kMaxL, kMaxN).bytes;
  const dim3 grid(a.H, n_bc, (a.L + kRows - 1) / kRows);
  if (fused) {
    if (const int e = grant_smem(fused_mma_kernel<P>, most, granted[1]))
      return e;
    fused_mma_kernel<P><<<grid, kThreads, smem, st>>>(a);
  } else {
    if (const int e = grant_smem(chunk_mma_kernel<P>, most, granted[0]))
      return e;
    chunk_mma_kernel<P><<<grid, kThreads, smem, st>>>(a);
  }
  return launch_status::after_launch();
}

template <int P>
int launch_apply(const ApplyArgs& a, int n_bc, cudaStream_t st) {
  const size_t smem = apply_layout<P>(a.N).bytes;
  static bool granted[kMaxDevices] = {};
  if (const int e = grant_smem(apply_mma_kernel<P>,
                               apply_layout<P>(kMaxN).bytes, granted))
    return e;
  apply_mma_kernel<P><<<dim3((a.L + kRows - 1) / kRows, a.H, n_bc), kThreads,
                        smem, st>>>(a);
  return launch_status::after_launch();
}

}  // namespace mma

// ===========================================================================
// simt: scalar fp32 FMAs on the CUDA cores.
// ===========================================================================

namespace simt {

constexpr int kRows = 64;     // output rows of a block tile
constexpr int kDepth = 32;    // depth staged per step
constexpr int kPitch = kRows + 4;   // row pitch of the k-major M tile

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

// Pass 1.  grid (L/64 t tiles + N/64 state tiles, H, B*nc): blocks below
// L/64 build y_intra and cumexp for 64 rows t, the rest the chunk state for
// 64 rows n.
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
chunk_simt_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, T* __restrict__ y,
                  float* __restrict__ states, float* __restrict__ cumexp,
                  int L, int H, int G, int N, size_t x_row, size_t b_row,
                  size_t c_row) {
  const int n_tt = (L + kRows - 1) / kRows;
  const int h = blockIdx.y, bc = blockIdx.z, g = h / (H / G);
  __shared__ float cum[kMaxL];
  __shared__ float warp_tot[kThreads / 32];
  __shared__ float dsc[kDepth];
  __shared__ __align__(16) float Mt[kDepth][kPitch];
  __shared__ __align__(16) float Mw[kDepth][kPitch];
  __shared__ float Xs[kDepth * (kDepth + 1)];
  __shared__ float X[kDepth * (P + 1)];
  const float* dtp = dt + (size_t)bc * L * H + h;
  const T* xh = x + (size_t)bc * L * x_row + (size_t)h * P;
  const T* Bp = Bm + (size_t)bc * L * b_row + (size_t)g * N;
  TileMac<P> tm;
  tm.init();

  if ((int)blockIdx.x < n_tt) {
    // y_intra and cumexp for rows t0 .. t0 + 63
    const int t0 = blockIdx.x * kRows, t_end = min(t0 + kRows, L);
    const T* C = Cm + (size_t)bc * L * c_row + (size_t)g * N;
    block_cumsum(dtp, H, A[h], t_end, cum, warp_tot);
    if (threadIdx.x < kRows && t0 + threadIdx.x < L) {
      const int t = t0 + threadIdx.x;
      cumexp[((size_t)bc * L + t) * H + h] = expf(cum[t]);
    }
    for (int s0 = 0; s0 < t_end; s0 += kDepth) {
      // scores S[t][s] = C_t . B_s for 64 t x 32 s, in registers
      TileMac<kDepth> sc;
      sc.init();
      for (int n0 = 0; n0 < N; n0 += kDepth) {
        for (int i = threadIdx.x; i < kDepth * kRows; i += kThreads) {
          const int k = i % kDepth, r = i / kDepth;
          Mt[k][r] = n0 + k < N && t0 + r < L
                         ? to_f32(C[(size_t)(t0 + r) * c_row + n0 + k])
                         : 0.f;
        }
        for (int i = threadIdx.x; i < kDepth * kDepth; i += kThreads) {
          const int k = i % kDepth, c = i / kDepth;
          Xs[k * (kDepth + 1) + c] =
              n0 + k < N && s0 + c < L
                  ? to_f32(Bp[(size_t)(s0 + c) * b_row + n0 + k])
                  : 0.f;
        }
        __syncthreads();
        sc.mac(&Mt[0][0], Xs);
        __syncthreads();
      }
      if (threadIdx.x < kDepth)
        dsc[threadIdx.x] =
            s0 + threadIdx.x < L ? dtp[(size_t)(s0 + threadIdx.x) * H] : 0.f;
      __syncthreads();
      // W[t][s] = (S * decay) * dt_s for s <= t, k-major (k = s)
#pragma unroll
      for (int i = 0; i < TileMac<kDepth>::R; ++i) {
        const int r = sc.row0 + i, t = t0 + r, s = s0 + sc.col;
        float w = 0.f;
        if (s <= t && t < L)
          w = __fmul_rn(
              __fmul_rn(sc.acc[i], expf(__fsub_rn(cum[t], cum[s]))),
              dsc[sc.col]);
        Mw[sc.col][r] = w;
      }
      stage_x<P>(X, xh, x_row, s0, L);
      __syncthreads();
      tm.mac(&Mw[0][0], X);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TileMac<P>::R; ++i) {
      const int t = t0 + tm.row0 + i;
      if (t < L)
        store(&y[((size_t)bc * L + t) * H * P + (size_t)h * P + tm.col],
              tm.acc[i]);
    }
    return;
  }

  // the chunk state for rows n0 .. n0 + 63
  const int n0 = (blockIdx.x - n_tt) * kRows;
  block_cumsum(dtp, H, A[h], L, cum, warp_tot);
  const float last = cum[L - 1];
  for (int s0 = 0; s0 < L; s0 += kDepth) {
    if (threadIdx.x < kDepth) {
      const int s = s0 + threadIdx.x;
      dsc[threadIdx.x] =
          s < L ? __fmul_rn(expf(__fsub_rn(last, cum[s])), dtp[(size_t)s * H])
                : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kDepth * kRows; i += kThreads) {
      const int r = i % kRows, k = i / kRows;
      const int s = s0 + k, n = n0 + r;
      Mt[k][r] = s < L && n < N
                     ? __fmul_rn(dsc[k], to_f32(Bp[(size_t)s * b_row + n]))
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

// Pass 2: y = y_intra + (C . state_in) * cumexp.  grid (L/64, H, B*nc).
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
apply_simt_kernel(const T* __restrict__ yi, const T* __restrict__ Cm,
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
                 float* cumexp, int n_bc, int L, int H, int G, int N,
                 size_t x_row, size_t b_row, size_t c_row, cudaStream_t st) {
  const int blocks = (L + kRows - 1) / kRows + (N + kRows - 1) / kRows;
  chunk_simt_kernel<P, T><<<dim3(blocks, H, n_bc), kThreads, 0, st>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), states, cumexp, L, H, G,
      N, x_row, b_row, c_row);
  return launch_status::after_launch();
}

template <int P, typename T>
int apply_launch(const void* yi, const void* Cm, const float* cumexp,
                 const float* s_in, void* out, int n_bc, int L, int H, int G,
                 int N, size_t c_row, cudaStream_t st) {
  apply_simt_kernel<P, T><<<dim3((L + kRows - 1) / kRows, H, n_bc), kThreads,
                            0, st>>>(static_cast<const T*>(yi),
                                     static_cast<const T*>(Cm), cumexp, s_in,
                                     static_cast<T*>(out), L, H, G, N, c_row);
  return launch_status::after_launch();
}

}  // namespace simt

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The async staging reads rows of 16-byte chunks.
bool async_ok(const void* x, const void* Bm, const void* Cm, int N,
              int x_row, int b_row, int c_row) {
  return aligned16(x) && aligned16(Bm) && aligned16(Cm) && N % 8 == 0 &&
         x_row % 8 == 0 && b_row % 8 == 0 && c_row % 8 == 0;
}

#define SSD_SWITCH_P(P, CALL)                                   \
  switch (P) {                                                  \
    case 8: { constexpr int PV = 8; return CALL; }              \
    case 16: { constexpr int PV = 16; return CALL; }            \
    case 32: { constexpr int PV = 32; return CALL; }            \
    case 64: { constexpr int PV = 64; return CALL; }            \
    case 128: { constexpr int PV = 128; return CALL; }          \
  }                                                             \
  return launch_status::fail(launch_status::kArgs);

}  // namespace

namespace ls = launch_status;

extern "C" {

// Longest chunk the kernels take; largest N of the tensor-core kernels
// (the two passes' mma variant and the fused scan).
int ssd_max_chunk() { return kMaxL; }
int ssd_max_state_fused() { return mma::kMaxN; }

// Pass 1.  x/Bm/Cm/y are float (is_bf16 = 0) or bfloat16 (is_bf16 = 1);
// x_row, b_row and c_row are the elements between consecutive positions of
// x, Bm and Cm (H*P and G*N when contiguous); y is contiguous.  variant 1 is
// mma (bf16, N <= ssd_max_state_fused()), 0 simt; async (mma only) stages
// through 16-byte cp.async, which needs 16-byte aligned rows.  Every entry
// point runs on card `device` and returns 0 once launched, else the
// launch_status code of the check that refused it (csrc/launch_status.cuh).
int ssd_chunk_launch(int device, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, void* y, float* states,
                     float* cumexp, int Bsz, int nc, int L, int H, int P, int G,
                     int N, int x_row, int b_row, int c_row, int is_bf16,
                     int variant, int async, void* stream) {
  if (L < 1 || L > kMaxL || G < 1 || H % G || N < 1 || x_row < 0 ||
      b_row < 0 || c_row < 0)
    return ls::fail(ls::kArgs);
  if (const int e = ls::bind_device(device)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bc = Bsz * nc;
  if (variant == 1) {
    if (!is_bf16 || N > mma::kMaxN) return ls::fail(ls::kArgs);
    if (async && !async_ok(x, Bm, Cm, N, x_row, b_row, c_row))
      return ls::fail(ls::kArgs, cudaErrorMisalignedAddress);
    mma::ScanArgs a = {
        static_cast<const __nv_bfloat16*>(x), dt, A,
        static_cast<const __nv_bfloat16*>(Bm),
        static_cast<const __nv_bfloat16*>(Cm), nullptr,
        static_cast<__nv_bfloat16*>(y), states, cumexp, L, H, G, N, x_row,
        b_row, c_row, async, 0};
    SSD_SWITCH_P(P, mma::launch_scan<PV>(a, n_bc, false, st))
  }
  if (is_bf16) {
    SSD_SWITCH_P(P, (simt::chunk_launch<PV, __nv_bfloat16>(
                        x, dt, A, Bm, Cm, y, states, cumexp, n_bc, L, H, G, N,
                        x_row, b_row, c_row, st)))
  }
  SSD_SWITCH_P(P, (simt::chunk_launch<PV, float>(x, dt, A, Bm, Cm, y, states,
                                                 cumexp, n_bc, L, H, G, N,
                                                 x_row, b_row, c_row, st)))
}

// Pass 2.  y_intra/Cm/out share float or bfloat16; cumexp and states_in
// are fp32.  c_row is the elements between consecutive positions of Cm;
// the other operands are contiguous.  variant and async as for pass 1.
int ssd_apply_launch(int device, const void* yi, const void* Cm,
                     const float* cumexp, const float* states_in, void* out,
                     int Bsz, int nc, int L, int H, int P, int G, int N,
                     int c_row, int is_bf16, int variant, int async,
                     void* stream) {
  if (L < 1 || G < 1 || H % G || N < 1 || c_row < 0)
    return ls::fail(ls::kArgs);
  if (const int e = ls::bind_device(device)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_bc = Bsz * nc;
  if (variant == 1) {
    if (!is_bf16 || N > mma::kMaxN) return ls::fail(ls::kArgs);
    if (async && !(aligned16(Cm) && N % 8 == 0 && c_row % 8 == 0))
      return ls::fail(ls::kArgs, cudaErrorMisalignedAddress);
    mma::ApplyArgs a = {static_cast<const __nv_bfloat16*>(yi),
                        static_cast<const __nv_bfloat16*>(Cm), cumexp,
                        states_in, static_cast<__nv_bfloat16*>(out), L, H, G,
                        N, c_row, async, aligned16(states_in)};
    SSD_SWITCH_P(P, mma::launch_apply<PV>(a, n_bc, st))
  }
  if (is_bf16) {
    SSD_SWITCH_P(P, (simt::apply_launch<PV, __nv_bfloat16>(
                        yi, Cm, cumexp, states_in, out, n_bc, L, H, G, N,
                        c_row, st)))
  }
  SSD_SWITCH_P(P, (simt::apply_launch<PV, float>(yi, Cm, cumexp, states_in,
                                                 out, n_bc, L, H, G, N, c_row,
                                                 st)))
}

// Both passes for one chunk (S = L), bf16 x/Bm/Cm/y, N <=
// ssd_max_state_fused(), on the tensor cores: init (B, H, N, P) fp32
// contiguous in, y (B, L, H, P) and final (B, H, N, P) fp32 out.  Strides
// and async as for pass 1.
int ssd_fused_launch(int device, const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, const float* init, void* y,
                     float* final_state, int Bsz, int L, int H, int P, int G,
                     int N, int x_row, int b_row, int c_row, int async,
                     void* stream) {
  if (L < 1 || L > kMaxL || G < 1 || H % G || N < 1 ||
      N > mma::kMaxN || x_row < 0 || b_row < 0 || c_row < 0)
    return ls::fail(ls::kArgs);
  if (async && !async_ok(x, Bm, Cm, N, x_row, b_row, c_row))
    return ls::fail(ls::kArgs, cudaErrorMisalignedAddress);
  if (const int e = ls::bind_device(device)) return e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  mma::ScanArgs a = {static_cast<const __nv_bfloat16*>(x), dt, A,
                     static_cast<const __nv_bfloat16*>(Bm),
                     static_cast<const __nv_bfloat16*>(Cm), init,
                     static_cast<__nv_bfloat16*>(y), final_state, nullptr, L,
                     H, G, N, x_row, b_row, c_row, async, aligned16(init)};
  SSD_SWITCH_P(P, mma::launch_scan<PV>(a, Bsz, true, st))
}

}  // extern "C"
