// A symmetric heap for a grid of PE processes, and its two kernels (Hopper).
//
// Replaces no Pallas kernel.  The JAX package's PEs are devices of one
// mesh running one program under `shard_map`: a `put` lowers to XLA's
// collective-permute (`lax.ppermute`, src/repro/core/shmem.py:137) and a
// row or column reduction to an all-reduce (`lax.psum`/`lax.pmax` with
// axis_index_groups, src/repro/core/shmem.py:154-163).  The port's PEs are
// processes, several of them on one card (four contexts time-slicing it)
// or one on each NVLink peer, and no library collective runs several ranks
// on one card (NCCL refuses two ranks on one GPU; gloo stages through the
// host).  So the port carries the paper's own argument onto the card: one
// OpenSHMEM layer of one-sided puts, and every collective built from them.
//
//   * The heap: each PE allocates ONE region of a size fixed before its
//     first collective (`shmem_heap_alloc`, zeroed), exports its
//     cudaIpcMemHandle, and opens every peer's handle (`shmem_heap_open`;
//     a process never opens its own).  The Python side keeps a device table
//     of every PE's base address in this process's address space (its own
//     heap's base for itself), which the put kernel reads.
//   * `shmem_put`: copy a local contiguous block to `bases[dst] + offset`,
//     16 bytes a thread where the addresses and the size allow it, else a
//     byte a thread.  Bound by bytes: the block is read once and written
//     once (2 * bytes at 3.35 TB/s); between processes on one card the
//     write is a plain store through the peer's mapping, between NVLink
//     peers it crosses the link.
//   * `shmem_reduce_slots`: sum or max, elementwise, over the n slots of one
//     collective in this PE's own heap (slot k at offset + k * slot_stride,
//     written by group member k), in the fixed order k = 0 .. n-1, with an
//     fp32 accumulator and one cast to the output dtype.  So every member
//     of a group gets the same bits, and the plain version (ref.py), which
//     adds in the same order, gets them too.  Bound by bytes: n slots read
//     once, the output written once.
//
// Ordering is the caller's: a sender synchronises its stream after its
// puts and before the host barrier, and a receiver launches its reduction
// after the barrier, so it sees every put of the collective.  Alternate
// halves of the heap by collective parity keep a fast PE's next puts off
// the slots a slow PE still reads.
//
// Every entry takes the device index first and returns 0 or
// stage * 100000 + the CUDA error (launch_status.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#include "../../csrc/launch_status.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;   // a few waves over the SMs

long long blocks_for(long long units) {
  long long b = (units + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  return b < kMaxBlocks ? b : kMaxBlocks;
}

__global__ void put_kernel(const uint8_t* __restrict__ src,
                           const unsigned long long* __restrict__ bases,
                           int dst, long long offset, long long bytes) {
  uint8_t* out = reinterpret_cast<uint8_t*>(bases[dst]) + offset;
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(src) |
                        reinterpret_cast<uintptr_t>(out) |
                        static_cast<uintptr_t>(bytes);
  if ((mis & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(out);
    for (long long k = first; k < (bytes >> 4); k += step) d[k] = s[k];
  } else {
    for (long long k = first; k < bytes; k += step) out[k] = src[k];
  }
}

__device__ __forceinline__ float load(const float* p, long long e) {
  return p[e];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long e) {
  return __bfloat162float(p[e]);
}
__device__ __forceinline__ void store(float* p, long long e, float v) {
  p[e] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long e, float v) {
  p[e] = __float2bfloat16_rn(v);
}

// torch.maximum's rule: NaN if either operand is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

template <typename TIn, typename TOut, bool kMax>
__global__ void reduce_kernel(const uint8_t* __restrict__ base,
                              long long offset, long long slot_stride, int n,
                              long long numel, TOut* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < numel; e += step) {
    float acc = load(reinterpret_cast<const TIn*>(base + offset), e);
    for (int k = 1; k < n; ++k) {
      const float v =
          load(reinterpret_cast<const TIn*>(base + offset + k * slot_stride), e);
      acc = kMax ? max_nan(acc, v) : acc + v;
    }
    store(out, e, acc);
  }
}

template <typename TIn, typename TOut>
int launch_reduce(const uint8_t* base, long long offset, long long stride,
                  int n, long long numel, void* out, int op, cudaStream_t s) {
  const dim3 grid((unsigned)blocks_for(numel)), block(kThreads);
  TOut* o = static_cast<TOut*>(out);
  if (op == 0)
    reduce_kernel<TIn, TOut, false><<<grid, block, 0, s>>>(base, offset,
                                                           stride, n, numel, o);
  else
    reduce_kernel<TIn, TOut, true><<<grid, block, 0, s>>>(base, offset, stride,
                                                          n, numel, o);
  return launch_status::after_launch();
}

}  // namespace

// sizeof(cudaIpcMemHandle_t): the bytes a PE publishes to its peers
extern "C" int shmem_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

// Allocate and zero `bytes` of device memory on `device`; write its base to
// *base and its IPC handle to `handle` (shmem_handle_bytes() bytes).
extern "C" int shmem_heap_alloc(int device, long long bytes, void** base,
                                void* handle) {
  if (bytes < 1 || base == nullptr || handle == nullptr)
    return launch_status::fail(launch_status::kArgs);
  if (const int st = launch_status::bind_device(device)) return st;
  void* p = nullptr;
  cudaError_t err = cudaMalloc(&p, (size_t)bytes);
  if (err != cudaSuccess) return launch_status::fail(launch_status::kHeap, err);
  err = cudaMemset(p, 0, (size_t)bytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    cudaFree(p);
    return launch_status::fail(launch_status::kHeap, err);
  }
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, p);
  if (err != cudaSuccess) {
    cudaFree(p);
    return launch_status::fail(launch_status::kIpc, err);
  }
  std::memcpy(handle, &h, sizeof(h));
  *base = p;
  return 0;
}

// Map a peer's heap from its published handle; *base is its address here.
extern "C" int shmem_heap_open(int device, const void* handle, void** base) {
  if (handle == nullptr || base == nullptr)
    return launch_status::fail(launch_status::kArgs);
  if (const int st = launch_status::bind_device(device)) return st;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  const cudaError_t err =
      cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  if (err != cudaSuccess) return launch_status::fail(launch_status::kIpc, err);
  *base = p;
  return 0;
}

// Unmap a peer's heap (after the last collective that writes it).
extern "C" int shmem_heap_close(int device, void* base) {
  if (const int st = launch_status::bind_device(device)) return st;
  const cudaError_t err = cudaIpcCloseMemHandle(base);
  return err == cudaSuccess ? 0 : launch_status::fail(launch_status::kIpc, err);
}

// Free this PE's own heap (after every peer has closed it).
extern "C" int shmem_heap_free(int device, void* base) {
  if (const int st = launch_status::bind_device(device)) return st;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaFree(base);
  return err == cudaSuccess ? 0 : launch_status::fail(launch_status::kHeap, err);
}

// shmem_put: `bytes` from `src` (device) to bases[dst] + offset, where
// `bases` is the device table of the n_pes heap bases in this process.
extern "C" int shmem_put_launch(int device, const void* src, const void* bases,
                                int n_pes, int dst, long long offset,
                                long long bytes, void* stream) {
  if (src == nullptr || bases == nullptr || dst < 0 || dst >= n_pes ||
      offset < 0 || bytes < 1)
    return launch_status::fail(launch_status::kArgs);
  if (const int st = launch_status::bind_device(device)) return st;
  const long long units = (bytes & 15) == 0 ? bytes >> 4 : bytes;
  put_kernel<<<(unsigned)blocks_for(units), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src),
      static_cast<const unsigned long long*>(bases), dst, offset, bytes);
  return launch_status::after_launch();
}

// shmem_reduce_slots: out[e] = op over k < n of slot k's element e (fp32
// accumulator, k in order), slot k at base + offset + k * slot_stride.
// in_dtype / out_dtype: 0 fp32, 1 bf16; op: 0 sum, 1 max.
extern "C" int shmem_reduce_slots_launch(int device, const void* base,
                                         long long offset,
                                         long long slot_stride, int n,
                                         long long numel, int in_dtype,
                                         void* out, int out_dtype, int op,
                                         void* stream) {
  if (base == nullptr || out == nullptr || n < 1 || numel < 1 || offset < 0 ||
      slot_stride < 0 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || op < 0 || op > 1)
    return launch_status::fail(launch_status::kArgs);
  if (const int st = launch_status::bind_device(device)) return st;
  const uint8_t* b = static_cast<const uint8_t*>(base);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_reduce<float, float>(b, offset, slot_stride, n, numel, out,
                                       op, s);
  if (in_dtype == 0)
    return launch_reduce<float, __nv_bfloat16>(b, offset, slot_stride, n,
                                               numel, out, op, s);
  if (out_dtype == 0)
    return launch_reduce<__nv_bfloat16, float>(b, offset, slot_stride, n,
                                               numel, out, op, s);
  return launch_reduce<__nv_bfloat16, __nv_bfloat16>(b, offset, slot_stride, n,
                                                     numel, out, op, s);
}
