// One warp's bf16 tensor-core attention tile (Hopper, sm_90a), shared by the
// flash-attention and paged-attention kernels.
//
// A warp owns 16 query rows.  Per key tile it computes S = Q K^T with
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators), and folds S into a
// running fp32 online softmax (m, l, O) that lives in registers:
//   * Q is held as A fragments for the whole kernel (loaded once).
//   * K and V tiles sit in shared memory as bf16, rows of `pitch` elements
//     (depth + 8: rows 16 bytes apart in bank space, so ldmatrix is
//     conflict-free).  ldmatrix feeds K (as B, non-transposed) and V (as B,
//     transposed).
//   * The S accumulator fragment of an m16n8 tile is, pair by pair, the A
//     fragment of P for the next product, so P never leaves registers.
//   * P stays exact to about 2^-17: each probability is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi), and both products run
//     against the same V fragment into one fp32 accumulator (1.5x the
//     tensor work of a plain bf16 P).  l sums the fp32 p.
//   * The row statistics reduce over the four threads that share a row
//     (two shuffles); l stays a per-thread partial until the end.
//
// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 * gid + tig; a thread
// holds rows gid and gid + 8; accumulator element e of an n8 tile is row
// gid + 8 * (e >> 1), column 2 * tig + (e & 1).
//
// Also here: 16-byte cp.async with zero fill (the staging copies of both
// kernels) and the group waits that complete them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr float kNegInf = -1e30f;   // finite: a masked row stays finite

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes global -> shared without registers; src_bytes = 0 writes
// 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a * b for one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error about 2^-22; denormal
// results flush to zero, weights that add nothing to an fp32 sum).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) -> hi = bf16 pair, lo = bf16 pair of the residuals; x in the low
// half (the lower column of an A fragment register).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments of 16 query rows of depth DP (a multiple of 16): element
// (row, col) comes from at(row, col), which returns two bf16 (col, col + 1)
// as one 32-bit word, or 0 for a row or column past the data.
template <int DP, typename At>
__device__ __forceinline__ void load_q(uint32_t (&qf)[DP / 16][4], int lane,
                                       At at) {
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const int c = kc * 16 + 2 * tig;
    qf[kc][0] = at(gid, c);
    qf[kc][1] = at(gid + 8, c);
    qf[kc][2] = at(gid, c + 8);
    qf[kc][3] = at(gid + 8, c + 8);
  }
}

// S (16 x NK) = Q K^T over depth DP; k_s points at key 0 of the tile,
// `pitch` bf16 elements per key row.
template <int DP, int NK>
__device__ __forceinline__ void scores(float (&s)[NK / 8][4],
                                       const uint32_t (&qf)[DP / 16][4],
                                       const __nv_bfloat16* k_s, int pitch,
                                       int lane) {
#pragma unroll
  for (int n = 0; n < NK / 8; ++n)
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
  // x4 matrices: keys 0-7 | d 0-7, keys 0-7 | d 8-15, keys 8-15 | d 0-7,
  // keys 8-15 | d 8-15 -> (b0, b1) of key tiles 2np and 2np + 1
  const int key = (lane & 7) + ((lane >> 4) << 3);
  const int col = ((lane >> 3) & 1) << 3;
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < NK / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, k_s + (np * 16 + key) * pitch + kc * 16 + col);
      mma_bf16(s[2 * np], qf[kc], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);
    }
  }
}

// Running softmax state of one warp's 16 rows (a thread: rows gid, gid + 8).
template <int DP>
struct Rows {
  float o[DP / 8][4];
  float m[2];
  float l[2];   // this thread's share; reduce() adds the row's four

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
      o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = kNegInf;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void reduce() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
  }
};

// Fold one tile of NK scores (already scaled and masked: NEG_INF where the
// causal mask hides a key, -inf where there is no key) into `st`, then
// O += P V with V's tile at v_s.  kLog2: the scores are in log2 units
// (ex2), else natural (expf, within an ulp of the reference's exp).
template <int DP, int NK, bool kLog2>
__device__ __forceinline__ void fold(Rows<DP>& st, float (&s)[NK / 8][4],
                                     const __nv_bfloat16* v_s, int pitch,
                                     int lane) {
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
    mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    alpha[i] = kLog2 ? ex2(st.m[i] - mx[i]) : expf(st.m[i] - mx[i]);
    st.m[i] = mx[i];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[n][e] - mx[e >> 1];
      const float p = kLog2 ? ex2(x) : expf(x);
      s[n][e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) st.l[i] = st.l[i] * alpha[i] + sum[i];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }
  // x4.trans matrices: keys 0-7 | d 0-7, keys 8-15 | d 0-7, keys 0-7 |
  // d 8-15, keys 8-15 | d 8-15 -> (b0, b1) of depth tiles 2dp and 2dp + 1
  const int key = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = (lane >> 4) << 3;
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_pair(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    split_pair(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < DP / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_s + (kk * 16 + key) * pitch + dp * 16 + col);
      mma_bf16(st.o[2 * dp], hi, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(st.o[2 * dp], lo, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

}  // namespace tile
