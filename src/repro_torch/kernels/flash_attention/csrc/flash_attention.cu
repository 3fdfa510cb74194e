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
// Design.  One block of 128 threads per (b, q head, tile of 64 query rows).
// The TPU's sequential kv grid dimension becomes a loop inside the block
// over tiles of 64 keys, staged in shared memory as fp32 (K transposed so
// the score loop reads both operands as float4).  Each thread owns 4 rows x
// 8 keys of the score tile and 4 rows x D/8 columns of the accumulator, in
// registers.  The 8 threads that share a row sit in one warp, so the row
// max and sum are three shuffles each, and the probabilities go through
// shared memory to the same warp only (a __syncwarp, not a block barrier).
//
// What bounds it on an H100.  4 * Sq * Skv * D operations per head (half of
// it under the causal mask) on (Sq + 2 * Skv) * D elements: prefill-sized
// calls are bound by operations.  This first version does them as fp32
// FMAs on the CUDA cores (67 TFLOP/s), with synchronous staging; wgmma
// tiles in bf16 with fp32 accumulators, fed by TMA, are a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;   // shared-memory grants kept per device
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kPitch = 68;     // row pitch of the [.][64] tiles (float4-aligned)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  return 2 * (size_t)D * kPitch          // q_s[d][row], k_s[d][key]
         + (size_t)kBK * (D + 4)         // v_s[key][d]
         + (size_t)kBK * kPitch;         // p_s[key][row]
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const T* __restrict__ q,     // (B, Hq, Sq, D)
    const T* __restrict__ k,     // (B, Hkv, Skv, D)
    const T* __restrict__ v,     // (B, Hkv, Skv, D)
    T* __restrict__ out,         // (B, Hq, Sq, D)
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
  const T* qh = q + ((size_t)b * Hq + h) * Sq * D;
  const T* kh = k + ((size_t)b * Hkv + g) * Skv * D;
  const T* vh = v + ((size_t)b * Hkv + g) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    q_s[d * kPitch + r] = q0 + r < Sq ? to_f32(qh[(size_t)(q0 + r) * D + d])
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
        kv = to_f32(kh[(size_t)(k0 + s) * D + d]);
        vv = to_f32(vh[(size_t)(k0 + s) * D + d]);
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

  T* oh = out + ((size_t)b * Hq + h) * Sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j)
      oh[(size_t)row * D + cg * DC + j] = from_f32<T>(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Skv, int q_offset, int causal,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  // The shared-memory limit is a per-device attribute: grant it once on
  // each device this instantiation launches on.
  static bool granted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!granted[dev]) {
    e = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted[dev] = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Hq, Hkv, Sq, Skv,
      q_offset, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int q_offset,
             int causal, float scale, cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                           causal, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                           causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, Hq, Hkv, Sq, Skv, q_offset,
                            causal, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, k, v and
// the output).  All four tensors contiguous.  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Hq,
                                      int Hkv, int Sq, int Skv, int D,
                                      int q_offset, int causal, float scale,
                                      int dtype, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hq > 65535 || Hkv < 1 ||
      Hq % Hkv != 0 || Sq < 1 || Skv < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D, q_offset,
                           causal, scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, Hq, Hkv, Sq, Skv, D,
                                   q_offset, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
