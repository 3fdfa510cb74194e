// Blocked streaming-softmax (flash) attention with GQA, causal masking in
// global positions and ragged tails (Hopper).
//
// Replaces the TPU kernel `_flash_kernel`, reached through
// `flash_attention_pallas` in src/repro/kernels/flash_attention/kernel.py.
// It computes the same function: for query head h of batch b, softmax
// attention over kv head h / group, with
//   * s = (q . k) * scale in fp32, masked to NEG_INF = -1e30 (finite) where
//     the query's global position q_offset + row is below the key's;
//   * running fp32 (m, l, acc) over key tiles, kept out of device memory;
//   * tiles wholly above the causal diagonal skipped;
//   * l clamped at 1e-30 and the normalized output written in q's dtype.
// The Pallas grid needs Sq and Skv to be multiples of its blocks (its op
// falls back to the reference otherwise); here ragged tails are masked: a
// query row past Sq is not stored and a key past Skv weighs exactly 0.
//
// What bounds it on an H100.  4 * Sq * Skv * D operations per head (half of
// it under the causal mask) on (Sq + 2 * Skv) * D elements: prefill-sized
// calls are bound by operations, the bf16 tensor cores' 989 TFLOP/s.  This
// design stays well below that: mma.sync runs at a fraction of wgmma's
// rate, and the softmax, the hi/lo split of P and the 1.5x P V work share
// the SM's instruction slots with it.
//
// Design, bf16 (the path calls take).  One block per (b, q head, tile of
// query rows): 8 warps and 128 rows at D 64 and 32, 4 warps and 64 rows at
// D 128, two blocks to an SM.  Each warp owns 16 rows, and every product
// is mma.sync m16n8k16 in bf16 with fp32 accumulators (the tile of
// ../../csrc/mma_tile.cuh, shared with paged attention):
//   * Q is loaded once as A fragments; S = Q K^T stays in registers and is
//     scaled after the product (q * scale is not a bf16 value), in log2
//     units so every exponential is one ex2.approx.
//   * P V runs on P split into bf16 hi + lo parts (residual about 2^-17),
//     so the output keeps fp32 P's precision; l sums the fp32 p.
//   * K and V stay bf16 in shared memory, copied by 16-byte cp.async in two
//     stages: the next key tile of 64 loads while this one is multiplied,
//     behind one block barrier per tile.  Rows are padded by 16 bytes so
//     ldmatrix reads them without bank conflicts.
//   * A warp whose 16 rows all lie above a key tile skips its products
//     (its p would be exactly 0 and its alpha exactly 1); a block stops at
//     the last tile any of its rows can see.
//   * Blocks are launched longest first (q tiles in reverse order when
//     causal), so the last wave holds the shortest rows.
// mma.sync rather than wgmma: a warp owns its rows, so the softmax needs no
// cross-warp exchange and the accumulator of S is already P's A fragment.
//
// fp32 (kept as it was, for the fp32 gate of 2e-5: TF32 keeps about three
// digits, so fp32 does not go through the tensor cores).  One block of 128
// threads per (b, q head, tile of 64 query rows), key tiles of 64 staged as
// fp32 (K transposed so the score loop reads both operands as float4);
// each thread owns 4 rows x 8 keys of the score tile and 4 rows x D/8
// columns of the accumulator in registers; the 8 threads that share a row
// sit in one warp (row max and sum are three shuffles each), and the
// probabilities go through shared memory to that warp only.  Scalar fp32
// FMAs on the CUDA cores (67 TFLOP/s).
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

using tile::kNegInf;
constexpr int kMaxDevices = 64;   // shared-memory grants kept per device

// ---------------------------------------------------------------------------
// fp32: scalar FMAs.
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kPitch = 68;     // row pitch of the [.][64] tiles (float4-aligned)

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)D * kPitch          // q_s[d][row], k_s[d][key]
         + (size_t)kBK * (D + 4)         // v_s[key][d]
         + (size_t)kBK * kPitch;         // p_s[key][row]
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_f32_kernel(
    const float* __restrict__ q,     // (B, Hq, Sq, D)
    const float* __restrict__ k,     // (B, Hkv, Skv, D)
    const float* __restrict__ v,     // (B, Hkv, Skv, D)
    float* __restrict__ out,         // (B, Hq, Sq, D)
    int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal,
    float scale) {
  constexpr int DC = D / 8;      // accumulator columns per thread
  constexpr int VP = D + 4;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_s = q_s + D * kPitch;
  float* v_s = k_s + D * kPitch;
  float* p_s = v_s + kBK * VP;

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int g = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;          // rows rg*4.., keys cg*8..
  const float* qh = q + ((size_t)b * Hq + h) * Sq * D;
  const float* kh = k + ((size_t)b * Hkv + g) * Skv * D;
  const float* vh = v + ((size_t)b * Hkv + g) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    q_s[d * kPitch + r] = q0 + r < Sq ? qh[(size_t)(q0 + r) * D + d]
                                      : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (Skv + kBK - 1) / kBK;
  if (causal) {   // last tile with a key at or below the block's last query
    const int last_q = q_offset + min(q0 + kBQ, Sq) - 1;
    n_tiles = min(n_tiles, last_q / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                 // the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int s = e / D, d = e % D;
      float kv = 0.f, vv = 0.f;
      if (k0 + s < Skv) {
        kv = kh[(size_t)(k0 + s) * D + d];
        vv = vh[(size_t)(k0 + s) * D + d];
      }
      k_s[d * kPitch + s] = kv;
      v_s[s * VP + d] = vv;
    }
    __syncthreads();

    // scores for rows rg*4 + i, keys cg*8 + j
    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + d * kPitch +
                                                         rg * 4);
      const float4 k0v = *reinterpret_cast<const float4*>(k_s + d * kPitch +
                                                          cg * 8);
      const float4 k1v = *reinterpret_cast<const float4*>(k_s + d * kPitch +
                                                          cg * 8 + 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[8] = {k0v.x, k0v.y, k0v.z, k0v.w,
                           k1v.x, k1v.y, k1v.z, k1v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qr[i], kr[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + cg * 8 + j;
        float s = sc[i][j] * scale;
        if (causal && qpos < key) s = kNegInf;
        if (key >= Skv) s = -INFINITY;          // past the tail: weight 0
        sc[i][j] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(sc[i][j] - m_new);
        sc[i][j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    // probabilities to p_s[key][row]: only this warp reads its rows back
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(p_s + (cg * 8 + j) * kPitch + rg * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncwarp();

    const int nk = min(kBK, Skv - k0);
    for (int s = 0; s < nk; ++s) {
      const float4 pv = *reinterpret_cast<const float4*>(p_s + s * kPitch +
                                                         rg * 4);
      const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
      float vr[DC];
#pragma unroll
      for (int j = 0; j < DC; j += 4) {
        const float4 x = *reinterpret_cast<const float4*>(v_s + s * VP +
                                                          cg * DC + j);
        vr[j] = x.x; vr[j + 1] = x.y; vr[j + 2] = x.z; vr[j + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
    }
  }

  float* oh = out + ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      oh[(size_t)row * D + cg * DC + j] = acc[i][j] * inv_l;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles.
// ---------------------------------------------------------------------------

// 64 keys a tile: S is 32 fp32 registers a thread.  At D 64 and 32 the
// kernel then fits 128 registers, so two blocks of 8 warps share an SM and
// hide each other's staging and barrier waits; on an H100 that ran faster
// than 128-key tiles at about 180 registers and one block.  At D 128 a
// thread needs about 200 registers (Q alone is 32; 32-key tiles to cut
// that spilled and ran no faster), so a block is 4 warps (64 rows) and
// two of them share an SM: on an H100 that ran faster than one block of
// 8 warps, whose barriers stall all 8 while the last one finishes.
template <int D>
struct Bf16Tile {
  static constexpr int kWarps = D == 128 ? 4 : 8;     // 16 query rows each
  static constexpr int kRows = 16 * kWarps;           // query rows per block
  static constexpr int kKeys = 64;                    // keys per tile
  static constexpr int kPitch = D + 8;                // bf16 per smem row
  static constexpr int kBlocksPerSm = 2;
  static constexpr size_t kSmem = 2 * 2 * (size_t)kKeys * kPitch * 2;
};

template <int D>
__global__ void __launch_bounds__(32 * Bf16Tile<D>::kWarps,
                                  Bf16Tile<D>::kBlocksPerSm)
    flash_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,     // (B, Hq, Sq, D)
    const __nv_bfloat16* __restrict__ k,     // (B, Hkv, Skv, D)
    const __nv_bfloat16* __restrict__ v,     // (B, Hkv, Skv, D)
    __nv_bfloat16* __restrict__ out,         // (B, Hq, Sq, D)
    int B, int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal,
    float scale_log2) {
  using T = Bf16Tile<D>;
  constexpr int BK = T::kKeys, P = T::kPitch, CH = D / 8;
  constexpr int ROWS = T::kRows, THREADS = 32 * T::kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + 2 * BK * P;

  // longest first: with a causal mask the last q tile sees the most keys
  const int n_qt = (Sq + ROWS - 1) / ROWS;
  const int bh = blockIdx.x % (B * Hq);
  const int qt = causal ? n_qt - 1 - (int)(blockIdx.x / (B * Hq))
                        : (int)(blockIdx.x / (B * Hq));
  const int b = bh / Hq, h = bh % Hq, g = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qt * ROWS, r0 = q0 + warp * 16;
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + h) * Sq * D;
  const __nv_bfloat16* kh = k + ((size_t)b * Hkv + g) * Skv * D;
  const __nv_bfloat16* vh = v + ((size_t)b * Hkv + g) * Skv * D;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {   // last tile with a key at or below the block's last query
    const int last_q = q_offset + min(q0 + ROWS, Sq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }

  auto stage = [&](int t) {
    const int k0 = t * BK, st = t & 1;
    for (int i = tid; i < BK * CH; i += THREADS) {
      const int r = i / CH, c = i - (i / CH) * CH;
      const bool ok = k0 + r < Skv;
      const size_t src = (size_t)(ok ? k0 + r : 0) * D + c * 8;
      const int dst = (st * BK + r) * P + c * 8;
      tile::cp_async16(k_s + dst, kh + src, ok ? 16 : 0);
      tile::cp_async16(v_s + dst, vh + src, ok ? 16 : 0);
    }
  };
  stage(0);
  tile::cp_async_commit();

  uint32_t qf[D / 16][4];
  tile::load_q<D>(qf, lane, [&](int r, int c) -> uint32_t {
    return r0 + r < Sq ? *reinterpret_cast<const uint32_t*>(
                             qh + (size_t)(r0 + r) * D + c)
                       : 0u;
  });
  tile::Rows<D> st;
  st.init();

  for (int t = 0; t < n_tiles; ++t) {
    tile::cp_async_wait<0>();
    __syncthreads();   // tile t has landed; every warp is done with t - 1
    if (t + 1 < n_tiles) stage(t + 1);   // into the stage t - 1 used
    tile::cp_async_commit();
    const int k0 = t * BK;
    if (!causal || q_offset + r0 + 15 >= k0) {
      float s[BK / 8][4];
      const int off = (t & 1) * BK * P;
      tile::scores<D, BK>(s, qf, k_s + off, P, lane);
      const bool edge = (causal && q_offset + r0 < k0 + BK - 1) ||
                        k0 + BK > Skv;
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (edge) {
            const int key = k0 + n * 8 + 2 * tig + (e & 1);
            const int qpos = q_offset + r0 + gid + 8 * (e >> 1);
            if (causal && qpos < key) x = kNegInf;
            if (key >= Skv) x = -INFINITY;           // past the tail: weight 0
          }
          s[n][e] = x;
        }
      }
      tile::fold<D, BK, true>(st, s, v_s + off, P, lane);
    }
  }

  st.reduce();
  __nv_bfloat16* oh = out + ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + gid + 8 * i;
    if (row >= Sq) continue;
    const float inv_l = 1.f / fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)row * D + n * 8 +
                                         2 * tig) =
          __floats2bfloat162_rn(st.o[n][2 * i] * inv_l,
                                st.o[n][2 * i + 1] * inv_l);
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

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal,
               float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool granted[kMaxDevices] = {};
  if (const int st = grant_smem(flash_f32_kernel<D>, smem, granted))
    return st;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, Sq,
      Skv, q_offset, causal, scale);
  return launch_status::after_launch();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Hq, int Hkv, int Sq, int Skv, int q_offset,
                int causal, float scale, cudaStream_t stream) {
  const size_t smem = Bf16Tile<D>::kSmem;
  static bool granted[kMaxDevices] = {};
  if (const int st = grant_smem(flash_bf16_kernel<D>, smem, granted))
    return st;
  constexpr int rows = Bf16Tile<D>::kRows;
  const long long blocks = (long long)((Sq + rows - 1) / rows) * Hq * B;
  if (blocks > 0x7fffffffLL) return launch_status::fail(launch_status::kArgs);
  flash_bf16_kernel<D><<<(unsigned)blocks, 32 * Bf16Tile<D>::kWarps, smem,
                         stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), B, Hq, Hkv, Sq, Skv, q_offset,
      causal, scale * 1.4426950408889634f);
  return launch_status::after_launch();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal,
           float scale, int dtype, cudaStream_t s) {
  if (dtype == 0)
    return launch_f32<D>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                         scale, s);
  if (dtype == 1)
    return launch_bf16<D>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                          causal, scale, s);
  return launch_status::fail(launch_status::kArgs);
}

}  // namespace

// C entry point for ctypes, on card `device`.  dtype: 0 = float32, 1 =
// bfloat16 (q, k, v and the output).  All four tensors contiguous; bf16 ones
// 16-byte aligned.  Returns 0 once launched, else the launch_status code of
// the check that refused it (csrc/launch_status.cuh).
extern "C" int flash_attention_launch(int device, const void* q,
                                      const void* k, const void* v, void* out,
                                      int B, int Hq, int Hkv, int Sq, int Skv,
                                      int D, int q_offset, int causal,
                                      float scale, int dtype, void* stream) {
  using namespace launch_status;
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 ||
      Hq % Hkv != 0 || Sq < 1 || Skv < 1 || q_offset < 0 ||
      (D != 32 && D != 64 && D != 128))
    return fail(kArgs);
  if (const int st = bind_device(device)) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return launch<32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                        scale, dtype, s);
    case 64:
      return launch<64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                        scale, dtype, s);
    case 128:
      return launch<128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset, causal,
                         scale, dtype, s);
  }
  return fail(kArgs);
}
