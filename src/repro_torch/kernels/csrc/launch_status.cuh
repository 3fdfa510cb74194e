// What the C entry points of the port's kernel libraries return, and the
// device binding every launch starts with.
//
// A launcher returns 0 when its kernel was launched, else
// `stage * kStageBase + error`: the check that refused the launch (one of
// `Stage`) and the error it met there (cudaErrorInvalidValue for a refused
// argument, the CUresult of cuTensorMapEncodeTiled for the tensor-map
// stages).  kernels/build.py::launch_error turns it into the message the
// Python wrapper raises, so a failure names its cause.
//
// Each library links its own static copy of the CUDA runtime, whose state
// is per thread.  On a thread where neither that copy nor PyTorch's runtime
// has made a context current (PyTorch's caching allocator can serve a
// thread's first tensors without a runtime call), cuTensorMapEncodeTiled,
// which runs on the calling thread's current context, returns
// CUDA_ERROR_INVALID_VALUE: a wgmma_tma launch failed as the first call of
// its library on a new thread.  So every launcher first binds the calling
// thread to the device of its tensors (`bind_device`, the index the wrapper
// passes), which makes that device's primary context current there, before
// it asks CUDA anything; the per-device shared-memory grants then go to
// that device too.
#pragma once

#include <cuda_runtime.h>

namespace launch_status {

constexpr int kStageBase = 100000;   // above every cudaError_t value
constexpr int kMaxDevices = 64;      // per-device state a library keeps

enum Stage : int {
  kArgs = 1,      // sizes, dtypes or layouts the kernel does not take
  kDevice = 2,    // binding the calling thread to the tensors' device
  kEncoder = 3,   // fetching cuTensorMapEncodeTiled's entry point
  kEncode = 4,    // encoding a tensor map
  kSmem = 5,      // granting the kernel its dynamic shared memory
  kQuery = 6,     // a device attribute query (SM count)
  kMemset = 7,    // zeroing a counter before the launch
  kLaunch = 8,    // the launch itself: cudaGetLastError() after it
  kHeap = 9,      // allocating, zeroing or freeing a symmetric heap
  kIpc = 10,      // exporting, opening or closing a CUDA IPC handle
};

inline int fail(Stage stage, cudaError_t err = cudaErrorInvalidValue) {
  return (int)stage * kStageBase + (int)err;
}

// The status after a kernel launch: 0, or the launch stage with its error.
inline int after_launch() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : fail(kLaunch, err);
}

// Make `dev` the current device of the calling thread in this library's
// runtime (cudaSetDevice also makes its primary context current there).
// Cheap once bound: the runtime is asked only when the thread's current
// device differs.  Returns 0 or the kDevice status.
inline int bind_device(int dev) {
  if (dev < 0 || dev >= kMaxDevices) return fail(kDevice, cudaErrorInvalidDevice);
  thread_local int bound = -1;
  if (bound == dev) return 0;
  const cudaError_t err = cudaSetDevice(dev);
  if (err != cudaSuccess) return fail(kDevice, err);
  bound = dev;
  return 0;
}

}  // namespace launch_status
