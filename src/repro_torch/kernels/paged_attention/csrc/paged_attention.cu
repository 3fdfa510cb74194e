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
//   * causal page skipping only where it is exact: when every row a block
//     stores sees the first key of the block's first owned page (so each
//     row has m > NEG_INF from that page on), the block reads no entry
//     whose labels all lie above every row's q_pos.  Such a key would get
//     p = exp(NEG_INF - m) = 0 exactly and alpha = 1, so the partials are
//     unchanged.  Any other block reads its whole range, masked keys
//     included (their count is what an all-masked row's l carries).
//
// What bounds it on an H100.  Decode (L = 1) reads
// B * T_used * stride * kvh * hd * 2 * bytes of K/V per layer and does a
// few FLOPs per byte: at the serving batch that is a few hundred KB, well
// under a microsecond at 3.35 TB/s, so decode is bound by latency: launch,
// the table walk, one staging round trip and the merge.  L = 256 prefill
// does 4 * B * Hq * L * ctx * hd FLOPs on the same bytes and is bound by
// the tensor cores.
//
// Design, bf16 (the serving path).  Grid (split, q tile, slot x kv head).
//   * Split over the block table: each (b, kv head g, q tile) is cut into
//     n_split ranges of table entries, n_split chosen by the wrapper from
//     shapes alone so that about one block per SM runs at small batch.
//     Each split writes its (m, l, acc) to fp32 scratch; the last split of
//     a tile to finish (a per-tile atomic counter after __threadfence(),
//     reset by that block) merges all of them with the LSE rule in split
//     order, so the result does not depend on which block finished last.
//     One launch either way.  The merge is exact for an all-masked row:
//     every split has m = NEG_INF, each weight is exp(0) = 1, and l adds up
//     the masked-key counts as the unsplit walk does.
//   * The block's rows are the `group` query heads that share kv head g
//     times a tile of positions, padded to a multiple of 16: one warp per
//     16 rows (qwen2 decode: 7 rows, one warp; a prefill chunk: 16
//     positions, 112 rows, 7 warps).  So every K/V page is read once per
//     GQA group.
//   * Table walk: all threads load the range's entries at once and keep
//     the owned ones (p >= 0, p % qrows == row, p / qrows < n_loc) in table
//     order with a warp ballot and a prefix count.
//   * Staging: one page row of kv head g is hd * 2 contiguous bytes of the
//     (n_loc, stride, kvh, hd) arena; rows are copied with 16-byte cp.async
//     in two stages (the next key tile loads while this one is
//     multiplied), bf16 stays bf16.  hd 8 pads the depth to 16 with zeros
//     in shared memory (zeros add exactly 0).
//   * Head sizes 8, 16, 32, 64, 128 and 160 (stablelm-12b).  Nothing
//     assumes a power of two: hd 160 is ten 16-wide k-steps of Q K^T and
//     twenty n8 tiles of O (80 fp32 accumulators a thread), a staged row
//     is twenty 16-byte cp.async chunks (320 bytes), and its pitch of 168
//     bf16 (336 bytes, 84 words: rows 20 banks apart) keeps ldmatrix free
//     of bank conflicts; the split merge reads float4s (hd / 4 of them).
//     Its products take 32 keys at a time instead of 64, which keeps the
//     score tile in 16 registers beside the 120 of O and Q.
//   * Products: the warp tile of ../../csrc/mma_tile.cuh (mma.sync
//     m16n8k16, bf16 in, fp32 accumulators; Q K^T scaled after the product;
//     P split into bf16 hi + lo against V; S and P in registers; row
//     statistics by warp shuffles), in sub-tiles of 64 keys.
//
// fp32 (kept as it was, for the 1e-5 fp32 gate: TF32 keeps about three
// digits).  One block per (slot b, kv head g, tile of query positions),
// no split; thread 0 walks the table, K/V staged as fp32, scalar fp32 FMAs
// from shared memory, softmax one thread per row.  It takes any head size
// whose staging fits a block's shared memory (the smem query says).
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//             -shared -Xcompiler -fPIC  (bound through ctypes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
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
constexpr int kRowTarget = 32;   // query rows per block: group heads x positions
constexpr int kKeyTile = 64;     // key positions staged per iteration

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

__global__ void __launch_bounds__(kThreads) paged_f32_kernel(
    const float* __restrict__ q,           // (B, Hq, L, hd)
    const float* __restrict__ kc,          // (n_loc, stride, kvh, hd)
    const float* __restrict__ vc,          // (n_loc, stride, kvh, hd)
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
    if (l < L) x = q[(((size_t)b * Hq + h) * L + l) * hd + d] * scale;
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
      k_s[key * hdp + d] = kc[src];
      v_s[key * hd + d] = vc[src];
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

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles, split over the block table.
// ---------------------------------------------------------------------------

constexpr int kMaxWarps = 8;       // 16 query rows each
constexpr int kSubKeys = 64;       // keys per product sub-tile
constexpr int kListCap = 256;      // table entries compacted at a time
constexpr int kNoKey = INT_MAX;    // label of a staged row past the tile's keys

struct TcGeometry {
  int group;    // q heads per kv head
  int tile_l;   // query positions per block
  int rows;     // group * tile_l
  int warps;    // rows / 16, rounded up
  int ppt;      // table entries per key tile
  int ktp;      // staged key rows per tile: ppt * stride rounded up to 64
  int pitch;    // bf16 per staged row: the padded depth + 8
};

// tile_l is mirrored by kernel.py's _tc_tile_l, which plans the split.
TcGeometry make_tc_geometry(int Hq, int L, int hd, int kvh, int stride) {
  TcGeometry g;
  g.group = Hq / kvh;
  const int t = 16 * kMaxWarps / g.group;
  g.tile_l = t < 1 ? 1 : (t > 16 ? 16 : t);
  if (g.tile_l > L) g.tile_l = L;
  g.rows = g.group * g.tile_l;
  g.warps = (g.rows + 15) / 16;
  g.ppt = kSubKeys / stride < 1 ? 1 : kSubKeys / stride;
  g.ktp = (g.ppt * stride + kSubKeys - 1) / kSubKeys * kSubKeys;
  g.pitch = (hd < 16 ? 16 : hd) + 8;
  return g;
}

bool tc_supported(const TcGeometry& g, int hd) {
  return g.warps <= kMaxWarps && (hd == 8 || hd == 16 || hd == 32 ||
                                  hd == 64 || hd == 128 || hd == 160);
}

size_t tc_smem_bytes(const TcGeometry& g) {
  return 2 * 2 * (size_t)g.ktp * g.pitch * sizeof(__nv_bfloat16)  // K, V
         + 2 * (size_t)g.ktp * sizeof(int)       // key labels, two stages
         + 2 * (size_t)kListCap * sizeof(int);   // owned entries: page, t
}

// floats of one split's partials in the scratch: acc (rows, hd), then m and
// l (rows each), rounded up to whole float4s
__host__ __device__ inline long long tc_span(const TcGeometry& g,
                                             int hd) {
  return (long long)g.rows * hd + (2LL * g.rows + 3) / 4 * 4;
}

template <int DP>
__global__ void __launch_bounds__(32 * kMaxWarps, 1) paged_bf16_kernel(
    const __nv_bfloat16* __restrict__ q,    // (B, Hq, L, hd)
    const __nv_bfloat16* __restrict__ kc,   // (n_loc, stride, kvh, hd)
    const __nv_bfloat16* __restrict__ vc,   // (n_loc, stride, kvh, hd)
    const int* __restrict__ table,          // (B, T) physical page ids
    const int* __restrict__ q_pos,          // (B, L) global query positions
    float* __restrict__ m_out,              // (B, Hq, L)
    float* __restrict__ l_out,              // (B, Hq, L)
    float* __restrict__ acc_out,            // (B, Hq, L, hd)
    float* __restrict__ part,               // split partials (n_split > 1)
    int* __restrict__ counters,             // one per tile, zero between calls
    int Hq, int L, int hd, int kvh, int n_entries, int stride, int n_loc,
    int row, int qrows, float scale, TcGeometry geo) {
  // keys per product: hd 160's 80 accumulators and 40 Q registers leave
  // room for 16 score registers, not 32 (at 64 keys ptxas spilled)
  constexpr int kSub = DP > 128 ? kSubKeys / 2 : kSubKeys;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int pitch = geo.pitch, ktp = geo.ktp, ppt = geo.ppt;
  const int rows = geo.rows, tile_l = geo.tile_l;
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + 2 * ktp * pitch;
  int* lab_s = reinterpret_cast<int*>(v_s + 2 * ktp * pitch);
  int* lpage = lab_s + 2 * ktp;
  int* lt = lpage + kListCap;
  __shared__ int warp_n[kMaxWarps], qp_lo[kMaxWarps], qp_hi[kMaxWarps];
  __shared__ int is_last;

  const int n_split = gridDim.x, split = blockIdx.x, qt = blockIdx.y;
  const int b = blockIdx.z / kvh, g = blockIdx.z % kvh;
  const int l0 = qt * tile_l;
  const int tid = threadIdx.x, nthr = blockDim.x, n_warps = nthr >> 5;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  // this split's entries; range sizes differ by at most one
  const int t_begin = (int)((long long)split * n_entries / n_split);
  const int t_end = (int)((long long)(split + 1) * n_entries / n_split);

  // rows gid and gid + 8 of this warp's 16: block row r is (head
  // g * group + r / tile_l, position l0 + r % tile_l); rows past `rows` or
  // past L are computed on zeros and never stored
  int qp[2], hrow[2], lrow[2];
  bool valid[2];
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    hrow[i] = g * geo.group + r / tile_l;
    lrow[i] = l0 + r % tile_l;
    valid[i] = r < rows && lrow[i] < L;
    qp[i] = valid[i] ? q_pos[(size_t)b * L + lrow[i]] : -1;
    if (valid[i]) {
      lo = min(lo, qp[i]);
      hi = max(hi, qp[i]);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    qp_lo[warp] = lo;
    qp_hi[warp] = hi;
  }
  if (hd < DP) {   // depth padding: zero once, cp.async never writes it
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = (int)(2 * 2 * (size_t)ktp * pitch * 2 / 16);
    for (int i = tid; i < n16; i += nthr) z[i] = make_uint4(0, 0, 0, 0);
  }

  uint32_t qf[DP / 16][4];
  tile::load_q<DP>(qf, lane, [&](int rr, int c) -> uint32_t {
    const int i = rr >> 3;
    if (!valid[i] || c >= hd) return 0u;
    return *reinterpret_cast<const uint32_t*>(
        q + (((size_t)b * Hq + hrow[i]) * L + lrow[i]) * hd + c);
  });
  tile::Rows<DP> st;
  st.init();
  __syncthreads();
  int qp_min = INT_MAX, qp_max = INT_MIN;
  for (int w = 0; w < n_warps; ++w) {
    qp_min = min(qp_min, qp_lo[w]);
    qp_max = max(qp_max, qp_hi[w]);
  }

  const int* trow = table + (size_t)b * n_entries;
  int t_stop = t_end;
  bool decided = false;
  for (int c0 = t_begin; c0 < t_stop; c0 += kListCap) {
    // the owned entries of [c0, c0 + cnt), in table order
    const int cnt = min(kListCap, t_stop - c0);
    int n = 0;
    for (int j0 = 0; j0 < cnt; j0 += nthr) {
      const int j = j0 + tid;
      bool own = false;
      int li = 0;
      if (j < cnt) {
        const int p = trow[c0 + j];
        if (p >= 0 && p % qrows == row) {
          li = p / qrows;
          own = li < n_loc;
        }
      }
      const unsigned bal = __ballot_sync(0xffffffffu, own);
      if (lane == 0) warp_n[warp] = __popc(bal);
      __syncthreads();
      int at = n;
      for (int w = 0; w < warp; ++w) at += warp_n[w];
      if (own) {
        at += __popc(bal & ((1u << lane) - 1));
        lpage[at] = li;
        lt[at] = c0 + j;
      }
      for (int w = 0; w < n_warps; ++w) n += warp_n[w];
      __syncthreads();
    }
    if (!decided && n > 0) {
      decided = true;
      // every row sees the first key of the first owned page: entries past
      // every row's q_pos then add p = 0 and alpha = 1 exactly, skip them
      if (lt[0] * stride <= qp_min) {
        const int last = qp_max / stride;   // last entry any row can see
        t_stop = min(t_stop, last + 1);
        int kept = 0;
        for (int j0 = 0; j0 < n; j0 += nthr)
          kept += __syncthreads_count(j0 + tid < n && lt[j0 + tid] <= last);
        n = kept;
      }
    }

    const int n_tiles = (n + ppt - 1) / ppt;
    auto stage = [&](int it) {
      const int s0 = (it & 1) * ktp, pg0 = it * ppt;
      const int nk = min(ppt, n - pg0) * stride, ch = hd >> 3;
      for (int i = tid; i < ktp * ch; i += nthr) {
        const int key = i / ch, c = i - key * ch;
        size_t src = 0;
        int bytes = 0;
        if (key < nk) {
          const int pg = key / stride, s = key - pg * stride;
          src = (((size_t)lpage[pg0 + pg] * stride + s) * kvh + g) * hd +
                c * 8;
          bytes = 16;
        }
        const int dst = (s0 + key) * pitch + c * 8;
        tile::cp_async16(k_s + dst, kc + src, bytes);
        tile::cp_async16(v_s + dst, vc + src, bytes);
      }
      for (int key = tid; key < ktp; key += nthr)
        lab_s[s0 + key] = key < nk ? lt[pg0 + key / stride] * stride +
                                         key % stride
                                   : kNoKey;
    };
    if (n_tiles > 0) {
      stage(0);
      tile::cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      tile::cp_async_wait<0>();
      __syncthreads();   // tile it has landed; every warp is done with it - 1
      if (it + 1 < n_tiles) stage(it + 1);   // into the stage it - 1 used
      tile::cp_async_commit();
      const int s0 = (it & 1) * ktp;
      const int nk = min(ppt, n - it * ppt) * stride;
      for (int sub = 0; sub * kSub < nk; ++sub) {
        const int base = s0 + sub * kSub;
        float s[kSub / 8][4];
        tile::scores<DP, kSub>(s, qf, k_s + base * pitch, pitch, lane);
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int lab = lab_s[base + j * 8 + 2 * tig + (e & 1)];
            float x = s[j][e] * scale;
            if (lab == kNoKey) x = -INFINITY;           // weight exactly 0
            else if (qp[e >> 1] < lab) x = kNegInf;     // causal mask
            s[j][e] = x;
          }
        }
        tile::fold<DP, kSub, false>(st, s, v_s + base * pitch, pitch, lane);
      }
    }
    // the next chunk's compaction barriers before it rewrites the list
  }
  st.reduce();

  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!valid[i]) continue;
      const size_t o = ((size_t)b * Hq + hrow[i]) * L + lrow[i];
      if (tig == 0) {
        m_out[o] = st.m[i];
        l_out[o] = st.l[i];
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = j * 8 + 2 * tig;
        if (c < hd)
          *reinterpret_cast<float2*>(acc_out + o * hd + c) =
              make_float2(st.o[j][2 * i], st.o[j][2 * i + 1]);
      }
    }
    return;
  }

  // this split's partials to the scratch
  const int tile_id = blockIdx.z * gridDim.y + qt;
  const long long span = tc_span(geo, hd);
  float* mine = part + ((long long)tile_id * n_split + split) * span;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + gid + 8 * i;
    if (r >= rows) continue;
    if (tig == 0) {
      mine[rows * hd + r] = st.m[i];
      mine[rows * hd + rows + r] = st.l[i];
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = j * 8 + 2 * tig;
      if (c < hd)
        *reinterpret_cast<float2*>(mine + r * hd + c) =
            make_float2(st.o[j][2 * i], st.o[j][2 * i + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + tile_id, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last split merges all of them, in split order (LSE rule)
  const float* all = part + (long long)tile_id * n_split * span;
  float* mg_s = reinterpret_cast<float*>(smem_raw);   // staging is done
  for (int r = tid; r < rows; r += nthr) {
    float mg = kNegInf;
    for (int s = 0; s < n_split; ++s)
      mg = fmaxf(mg, __ldcg(all + s * span + rows * hd + r));
    float l = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float* ps = all + s * span + rows * hd;
      l += __ldcg(ps + rows + r) * expf(__ldcg(ps + r) - mg);
    }
    mg_s[r] = mg;
    const int lr = l0 + r % tile_l;
    if (lr < L) {
      const size_t o = ((size_t)b * Hq + g * geo.group + r / tile_l) * L + lr;
      m_out[o] = mg;
      l_out[o] = l;
    }
  }
  __syncthreads();
  const int q4 = hd >> 2;
  for (int e = tid; e < rows * q4; e += nthr) {
    const int r = e / q4, c = (e - r * q4) * 4;
    const int lr = l0 + r % tile_l;
    if (lr >= L) continue;
    const float mg = mg_s[r];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < n_split; ++s) {
      const float* ps = all + s * span;
      const float w = expf(__ldcg(ps + rows * hd + r) - mg);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(ps + r * hd + c));
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    const size_t o = ((size_t)b * Hq + g * geo.group + r / tile_l) * L + lr;
    *reinterpret_cast<float4*>(acc_out + o * hd + c) = a;
  }
  if (tid == 0) counters[tile_id] = 0;   // ready for the next call
}

// The shared-memory limit is a per-device attribute: raise it on each device
// a kernel launches on, to the most any of its launches asked for.
// Returns 0 or the launch_status code of the failed step.
template <typename Kernel>
int grant_smem(Kernel kernel, size_t smem, size_t (&granted)[kMaxDevices]) {
  namespace ls = launch_status;
  int dev = 0;   // the launcher bound the thread to its tensors' device
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return ls::fail(ls::kDevice, e);
  if (dev >= kMaxDevices)
    return ls::fail(ls::kDevice, cudaErrorInvalidDevice);
  if (smem > 48 * 1024 && smem > granted[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return ls::fail(ls::kSmem, e);
    granted[dev] = smem;
  }
  return 0;
}

int launch_f32(const void* q, const void* kc, const void* vc,
               const void* table, const void* q_pos, void* m_out, void* l_out,
               void* acc_out, int B, int Hq, int L, int hd, int kvh,
               int n_entries, int stride, int n_loc, int row, int qrows,
               float scale, cudaStream_t stream) {
  const Geometry geo = make_geometry(Hq, L, hd, kvh, stride);
  const size_t smem = smem_bytes(geo, hd);
  static size_t granted[kMaxDevices] = {};
  if (const int st = grant_smem(paged_f32_kernel, smem, granted)) return st;
  const dim3 grid((L + geo.tile_l - 1) / geo.tile_l, kvh, B);
  paged_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<const int*>(table),
      static_cast<const int*>(q_pos), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out), Hq, L, hd,
      kvh, n_entries, stride, n_loc, row, qrows, scale, geo);
  return launch_status::after_launch();
}

template <int DP>
int launch_tc(const void* q, const void* kc, const void* vc,
              const void* table, const void* q_pos, void* m_out, void* l_out,
              void* acc_out, void* part, void* counters, int B, int Hq,
              int L, int hd, int kvh, int n_entries, int stride, int n_loc,
              int row, int qrows, int n_split, float scale,
              const TcGeometry& geo, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(geo);
  static size_t granted[kMaxDevices] = {};
  if (const int st = grant_smem(paged_bf16_kernel<DP>, smem, granted))
    return st;
  const dim3 grid(n_split, (L + geo.tile_l - 1) / geo.tile_l, B * kvh);
  paged_bf16_kernel<DP><<<grid, 32 * geo.warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), static_cast<const int*>(table),
      static_cast<const int*>(q_pos), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(acc_out),
      static_cast<float*>(part), static_cast<int*>(counters), Hq, L, hd, kvh,
      n_entries, stride, n_loc, row, qrows, scale, geo);
  return launch_status::after_launch();
}

}  // namespace

// C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16 (q, kc, vc).
// bf16 splits the table over n_split blocks per tile; it then needs `part`
// (at least part_floats >= B * kvh * n_qtiles * n_split * span floats) and
// `counters` (B * kvh * n_qtiles ints, zero; the kernel leaves them zero).
// fp32 takes n_split = 1.  kc and vc 16-byte aligned in bf16.  Runs on card
// `device`.  Returns 0 once launched, else the launch_status code of the
// check that refused it (csrc/launch_status.cuh).
extern "C" int paged_attention_launch(
    int device, const void* q, const void* kc, const void* vc,
    const void* table, const void* q_pos, void* m_out, void* l_out,
    void* acc_out, void* part, void* counters, int B, int Hq, int L, int hd, int kvh, int n_entries,
    int stride, int n_loc, int row, int qrows, int n_split,
    long long part_floats, float scale, int dtype, void* stream) {
  if (B < 1 || L < 1 || hd < 1 || kvh < 1 || Hq % kvh != 0 || stride < 1 ||
      qrows < 1 || n_entries < 0 || n_split < 1 ||
      n_split > (n_entries > 1 ? n_entries : 1))
    return launch_status::fail(launch_status::kArgs);
  if (const int st = launch_status::bind_device(device)) return st;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (n_split != 1) return launch_status::fail(launch_status::kArgs);
    return launch_f32(q, kc, vc, table, q_pos, m_out, l_out, acc_out, B, Hq,
                      L, hd, kvh, n_entries, stride, n_loc, row, qrows, scale,
                      s);
  }
  if (dtype != 1) return launch_status::fail(launch_status::kArgs);
  const TcGeometry geo = make_tc_geometry(Hq, L, hd, kvh, stride);
  const long long n_qt = (L + geo.tile_l - 1) / geo.tile_l;
  if (!tc_supported(geo, hd) || n_qt > 65535 || (long long)B * kvh > 65535 ||
      n_split > 65535)
    return launch_status::fail(launch_status::kArgs);
  if (n_split > 1 &&
      (part == nullptr || counters == nullptr ||
       part_floats < (long long)B * kvh * n_qt * n_split * tc_span(geo, hd)))
    return launch_status::fail(launch_status::kArgs);
#define PAGED_TC(DP)                                                        \
  return launch_tc<DP>(q, kc, vc, table, q_pos, m_out, l_out, acc_out, part, \
                       counters, B, Hq, L, hd, kvh, n_entries, stride, n_loc, \
                       row, qrows, n_split, scale, geo, s)
  switch (hd) {
    case 8:
    case 16: PAGED_TC(16);
    case 32: PAGED_TC(32);
    case 64: PAGED_TC(64);
    case 128: PAGED_TC(128);
    case 160: PAGED_TC(160);
  }
#undef PAGED_TC
  return launch_status::fail(launch_status::kArgs);
}

// Dynamic shared memory one launch of this geometry asks for (bytes), so the
// caller can refuse shapes past the card's 227 KB per block; -1 for a
// geometry the kernel does not take (bf16: more than 128 q heads per kv
// head, or hd outside 8, 16, 32, 64, 128, 160).
extern "C" long long paged_attention_smem_bytes(int Hq, int L, int hd, int kvh,
                                                int stride, int dtype) {
  if (L < 1 || hd < 1 || kvh < 1 || Hq % kvh != 0 || stride < 1) return -1;
  if (dtype == 0)
    return (long long)smem_bytes(make_geometry(Hq, L, hd, kvh, stride), hd);
  const TcGeometry geo = make_tc_geometry(Hq, L, hd, kvh, stride);
  if (dtype != 1 || !tc_supported(geo, hd)) return -1;
  return (long long)tc_smem_bytes(geo);
}
