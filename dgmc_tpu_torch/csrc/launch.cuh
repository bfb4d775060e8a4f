// Shared launch helper for the plain-C entry points of dgmc_tpu_torch's
// CUDA sources (called through ctypes, so no PyTorch device guard).
#pragma once

#include <cuda_runtime.h>

namespace dgmc {

// Runs `launch` (which returns a cudaError_t as int) with `device` current
// and restores the calling thread's current device afterwards. Returns the
// first error met.
template <typename F>
int on_device(int device, F&& launch) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int rc = launch();
  if (prev != device && (err = cudaSetDevice(prev)) != cudaSuccess &&
      rc == cudaSuccess)
    return (int)err;
  return rc;
}

}  // namespace dgmc
