// Shared helpers for the irn_tpu_torch kernels. Every entry point has a
// plain C interface: device pointers and the stream arrive as integers from
// ctypes, and each function returns cudaGetLastError() after its launches
// (0 on success), so a refused launch surfaces in the Python wrapper. Each
// also counts the kernels it launched into its last argument, ``launched``,
// which the wrapper adds to its launch counter.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

#define IRN_API extern "C" __attribute__((visibility("default")))

// After a launch: return its error, or count it in *launched.
#define IRN_CHECK_LAUNCH(launched)                 \
  do {                                             \
    cudaError_t e_ = cudaGetLastError();           \
    if (e_ != cudaSuccess) return (int)e_;         \
    ++*(launched);                                 \
  } while (0)
