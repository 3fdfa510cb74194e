// Fused paged-attention flash decode over per-slot block tables (Hopper).
//
// Replaces the TPU kernel `_paged_flash_kernel`, reached through
// `paged_attention_pallas` in src/repro/kernels/paged_attention/kernel.py.
// It computes the same thing: per (slot b, query head h, query row l) the
// unnormalised fp32 softmax partials (m, l, acc) of q against every KV page
// the slot's block table names, where
//   * table entry t labels cache positions [t*stride, (t+1)*stride) whatever
//     physical page backs it, and the causal mask is q_pos >= label;
//   * an entry the grid row does not own (page id -1, or p % qrows != row)
//     does no work at all;
//   * query head h reads kv head h / group (GQA);
//   * NEG_INF is the finite -1e30: a row that has seen only masked keys keeps
//     m = -1e30 and exp(s - m) = 1, and is wiped (alpha = 0) once a visible
//     key arrives, or weighed to zero by the row merge.  -inf would give NaN.
//   * no causal page skipping: it would change what such rows carry.
//
// Design.  One block per (slot b, kv head g, tile of query positions).  The
// block holds the `group` query heads that share kv head g for its tile of
// positions, so every K/V page is read once per GQA group, not once per
// query head.  The TPU's sequential table grid dimension becomes a loop
// inside the block: each iteration thread 0 walks the block's own table row
// (this replaces scalar prefetch), collecting up to kKeyTile/stride owned
// pages; the block stages their K and V rows for kv head g in shared memory
// as fp32, scores every (query row, key) pair, and folds the tile into the
// running online softmax in fp32.  Partials are written once at the end.
//
// What bounds it on an H100.  Decode (L = 1) reads
// B * T_used * stride * kvh * hd * 2 * bytes of K/V per layer and does a
// few FLOPs per byte: it is bound by memory bandwidth (3.35 TB/s).  L = 256
// prefill does 4 * B * Hq * L * ctx * hd FLOPs on the same bytes and is
// bound by arithmetic.  This first version is simple and right: scalar fp32
// FMAs from shared memory and synchronous staging, nothing more.  wgmma
// tiles fed by TMA, and a split over the table for small decode batches,
// come in a later change.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kRowTarget = 32;   // query rows per block: group heads x positions
constexpr int kKeyTile = 64;     // key positions staged per iteration

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Geometry {
  int group;    // q heads per kv head
  int tile_l;   // query positions per block
  int rows;     // group * tile_l
  int ppt;      // pages per key tile
  int keys;     // ppt * stride
  int hdp;      // padded row pitch of q_s / k_s (avoids bank conflicts)
};

Geometry make_geometry(int Hq, int L, int hd, int kvh, int stride) {
  Geometry g;
  g.group = Hq / kvh;
  int t = kRowTarget / g.group;
  g.tile_l = t < 1 ? 1 : (t > L ? L : t);
  g.rows = g.group * g.tile_l;
  g.ppt = kKeyTile / stride < 1 ? 1 : kKeyTile / stride;
  g.keys = g.ppt * stride;
  g.hdp = hd + 1;
  return g;
}

size_t smem_bytes(const Geometry& g, int hd) {
  size_t floats = (size_t)g.rows * g.hdp      // q_s
                  + (size_t)g.rows * hd       // acc_s
                  + (size_t)g.keys * g.hdp    // k_s
                  + (size_t)g.keys * hd       // v_s
                  + (size_t)g.rows * g.keys   // p_s
                  + 3 * (size_t)g.rows;       // m_s, l_s, a_s
  size_t ints = (size_t)g.rows                // qp_s
                + (size_t)g.keys              // kpos_s
                + 2 * (size_t)g.ppt           // page_s, base_s
                + 2;                          // n_pages, cursor
  return floats * sizeof(float) + ints * sizeof(int);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_flash_kernel(
    const T* __restrict__ q,           // (B, Hq, L, hd)
    const T* __restrict__ kc,          // (n_loc, stride, kvh, hd)
    const T* __restrict__ vc,          // (n_loc, stride, kvh, hd)
    const int* __restrict__ table,     // (B, T) physical page ids, -1 = none
    const int* __restrict__ q_pos,     // (B, L) global query positions
    float* __restrict__ m_out,         // (B, Hq, L)
    float* __restrict__ l_out,         // (B, Hq, L)
    float* __restrict__ acc_out,       // (B, Hq, L, hd)
    int Hq, int L, int hd, int kvh, int n_entries, int stride, int n_loc,
    int row, int qrows, float scale, Geometry geo) {
  extern __shared__ float smem[];
  const int rows = geo.rows, keys = geo.keys, hdp = geo.hdp;
  float* q_s = smem;
  float* acc_s = q_s + rows * hdp;
  float* k_s = acc_s + rows * hd;
  float* v_s = k_s + keys * hdp;
  float* p_s = v_s + keys * hd;
  float* m_s = p_s + rows * keys;
  float* l_s = m_s + rows;
  float* a_s = l_s + rows;
  int* qp_s = reinterpret_cast<int*>(a_s + rows);
  int* kpos_s = qp_s + rows;
  int* page_s = kpos_s + keys;
  int* base_s = page_s + geo.ppt;
  int* ctl_s = base_s + geo.ppt;     // [0] pages this tile, [1] table cursor

  const int b = blockIdx.z, g = blockIdx.y;
  const int l0 = blockIdx.x * geo.tile_l;
  const int tid = threadIdx.x;

  // row r of the block is (local head r / tile_l, position l0 + r % tile_l)
  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - (i / hd) * hd;
    const int h = g * geo.group + r / geo.tile_l;
    const int l = l0 + r % geo.tile_l;
    float x = 0.f;
    if (l < L) x = to_f32(q[(((size_t)b * Hq + h) * L + l) * hd + d]) * scale;
    q_s[r * hdp + d] = x;
    acc_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    const int l = l0 + r % geo.tile_l;
    qp_s[r] = l < L ? q_pos[(size_t)b * L + l] : -1;   // -1: all masked
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  if (tid == 0) ctl_s[1] = 0;
  __syncthreads();

  const int* trow = table + (size_t)b * n_entries;
  for (;;) {
    // the block reads its own table entries: the next ppt owned pages
    if (tid == 0) {
      int n = 0, t = ctl_s[1];
      for (; t < n_entries && n < geo.ppt; ++t) {
        const int p = trow[t];
        if (p < 0 || p % qrows != row) continue;     // unowned: no work
        const int li = p / qrows;
        if (li >= n_loc) continue;                   // past the arena
        page_s[n] = li;
        base_s[n] = t * stride;
        ++n;
      }
      ctl_s[0] = n;
      ctl_s[1] = t;
    }
    __syncthreads();
    const int n_pages = ctl_s[0];
    if (n_pages == 0) break;
    const int nk = n_pages * stride;

    // stage this tile's K/V rows of kv head g, converted to fp32
    for (int i = tid; i < nk * hd; i += kThreads) {
      const int key = i / hd, d = i - (i / hd) * hd;
      const int pg = key / stride, s = key - (key / stride) * stride;
      const size_t src =
          (((size_t)page_s[pg] * stride + s) * kvh + g) * hd + d;
      k_s[key * hdp + d] = to_f32(kc[src]);
      v_s[key * hd + d] = to_f32(vc[src]);
    }
    for (int key = tid; key < nk; key += kThreads)
      kpos_s[key] = base_s[key / stride] + key % stride;
    __syncthreads();

    // scores, causally masked on the table-position labels
    for (int i = tid; i < rows * nk; i += kThreads) {
      const int r = i / nk, s = i - (i / nk) * nk;
      const float* qr = q_s + r * hdp;
      const float* kr = k_s + s * hdp;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
      p_s[r * keys + s] = qp_s[r] >= kpos_s[s] ? dot : kNegInf;
    }
    __syncthreads();

    // online softmax statistics, one thread per row
    for (int r = tid; r < rows; r += kThreads) {
      float* pr = p_s + r * keys;
      float mx = kNegInf;
      for (int s = 0; s < nk; ++s) mx = fmaxf(mx, pr[s]);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = 0; s < nk; ++s) {
        const float e = expf(pr[s] - m_new);
        pr[s] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
    __syncthreads();

    // acc = acc * alpha + p @ v
    for (int i = tid; i < rows * hd; i += kThreads) {
      const int r = i / hd, d = i - (i / hd) * hd;
      const float* pr = p_s + r * keys;
      float o = 0.f;
      for (int s = 0; s < nk; ++s) o = fmaf(pr[s], v_s[s * hd + d], o);
      acc_s[i] = acc_s[i] * a_s[r] + o;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * hd; i += kThreads) {
    const int r = i / hd, d = i - (i / hd) * hd;
    const int h = g * geo.group + r / geo.tile_l;
    const int l = l0 + r % geo.tile_l;
    if (l < L) acc_out[(((size_t)b * Hq + h) * L + l) * hd + d] = acc_s[i];
  }
  for (int r = tid; r < rows; r += kThreads) {
    const int h = g * geo.group + r / geo.tile_l;
    const int l = l0 + r % geo.tile_l;
    if (l < L) {
      m_out[((size_t)b * Hq + h) * L + l] = m_s[r];
      l_out[((size_t)b * Hq + h) * L + l] = l_s[r];
    }
  }
}

template <typename T>
int launch(const void* q, const void* kc, const void* vc, const void* table,
           const void* q_pos, void* m_out, void* l_out, void* acc_out, int B,
           int Hq, int L, int hd, int kvh, int n_entries, int stride,
           int n_loc, int row, int qrows, float scale, cudaStream_t stream) {
  const Geometry geo = make_geometry(Hq, L, hd, kvh, stride);
  const size_t smem = smem_bytes(geo, hd);
  static size_t smem_granted = 48 * 1024;   // per instantiation
  if (smem > smem_granted) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_granted = smem;
  }
  const dim3 grid((L + geo.tile_l - 1) / geo.tile_l, kvh, B);
  paged_flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(table),
      static_cast<const int*>(q_pos), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), Hq, L, hd,
      kvh, n_entries, stride, n_loc, row, qrows, scale, geo);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, kc, vc).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int paged_attention_launch(
    const void* q, const void* kc, const void* vc, const void* table,
    const void* q_pos, void* m_out, void* l_out, void* acc_out, int B,
    int Hq, int L, int hd, int kvh, int n_entries, int stride, int n_loc,
    int row, int qrows, float scale, int dtype, void* stream) {
  if (B < 1 || L < 1 || hd < 1 || kvh < 1 || Hq % kvh != 0 || stride < 1 ||
      qrows < 1 || n_entries < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, kc, vc, table, q_pos, m_out, l_out, acc_out, B,
                         Hq, L, hd, kvh, n_entries, stride, n_loc, row,
                         qrows, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, kc, vc, table, q_pos, m_out, l_out,
                                 acc_out, B, Hq, L, hd, kvh, n_entries,
                                 stride, n_loc, row, qrows, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one launch of this geometry asks for (bytes), so the
// caller can refuse shapes past the card's 227 KB per block.
extern "C" long long paged_attention_smem_bytes(int Hq, int L, int hd, int kvh,
                                                int stride) {
  if (L < 1 || hd < 1 || kvh < 1 || Hq % kvh != 0 || stride < 1) return -1;
  return (long long)smem_bytes(make_geometry(Hq, L, hd, kvh, stride), hd);
}
