// Shared helpers for the irn_tpu_torch kernels. Every entry point has a
// plain C interface: device pointers and the stream arrive as integers from
// ctypes, and each function returns cudaGetLastError() after its launches
// (0 on success), so a refused launch surfaces in the Python wrapper. Each
// also counts the kernels it launched into its last argument, ``launched``,
// which the wrapper adds to its launch counter.
//
// thin_apply below is K4 apply_banded's block. The bodies that several
// kernels share live in their own headers: the tensor-core split product of
// K2, K5 and K6 in split_product.cuh, the chain over the tiles' nonzero
// entries of K3, K7 and K8 in packed_chain.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <atomic>
#include <cstddef>

#define IRN_API extern "C" __attribute__((visibility("default")))

// After a launch: return its error, or count it in *launched.
#define IRN_CHECK_LAUNCH(launched)                 \
  do {                                             \
    cudaError_t e_ = cudaGetLastError();           \
    if (e_ != cudaSuccess) return (int)e_;         \
    ++*(launched);                                 \
  } while (0)

namespace irn {

// Lets `kernel` take up to `bytes` of dynamic shared memory on the current
// device: set once per kernel and device (a bit of `set` per device), as
// each launch's own size is at most that.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<unsigned long long>& set,
                       int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (set.load() & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) set.fetch_or(bit);
  return e;
}

// x**e by binary exponentiation (e >= 1): the multiplication order of JAX's
// integer_pow and of matpow_kernels.pow_int. With a compile-time e the loop
// unrolls to its multiplies.
__device__ __forceinline__ float pow_int(float x, int e) {
  float acc = 1.f;
  bool have = false;
  float base = x;
  while (e) {
    if (e & 1) {
      acc = have ? __fmul_rn(acc, base) : base;
      have = true;
    }
    e >>= 1;
    if (e) base = __fmul_rn(base, base);
  }
  return acc;
}

// -- thin_apply ------------------------------------------------------------
//
// out[c0 + r, col] = sum_{row in [r_begin, r_end)} x[c0 + r, row] * T[row, col]
// for the 8 seed rows c0 .. c0+7 and the 32 columns col0 .. col0+31 of one
// block (256 threads = 32 columns x 8 row groups). Reads T only at rows
// [r_begin, r_end). The seed rows' window is staged through shared memory
// in chunks of 256 rows; row group g sums the rows g, g+8, g+16, ... of
// each chunk in order, and the groups reduce in a fixed order: the result
// is deterministic. kRound is the bf16 operand mode: every x and T value
// is rounded to bf16 (nearest even) as it is read, so each product is
// exact in f32 and the sums stay f32.

// v rounded to bf16, nearest even, as an f32 value.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kApplyCols = 32;
constexpr int kApplyGroups = 8;
constexpr int kApplyRows = 8;
constexpr int kApplyChunk = 256;
constexpr int kApplyThreads = kApplyCols * kApplyGroups;

template <bool kRound>
__device__ __forceinline__ void thin_apply(const float* __restrict__ x,
                                           const float* __restrict__ t,
                                           float* __restrict__ out, int C,
                                           int n, int c0, int col0,
                                           int r_begin, int r_end) {
  __shared__ float xs[kApplyRows][kApplyChunk];
  __shared__ float red[kApplyGroups][kApplyRows][kApplyCols];
  const int tx = threadIdx.x % kApplyCols;
  const int g = threadIdx.x / kApplyCols;
  const int col = col0 + tx;
  float acc[kApplyRows];
#pragma unroll
  for (int r = 0; r < kApplyRows; ++r) acc[r] = 0.f;

  for (int r0 = r_begin; r0 < r_end; r0 += kApplyChunk) {
    const int len = min(kApplyChunk, r_end - r0);
    __syncthreads();  // the previous chunk's reads are done
    for (int e = threadIdx.x; e < kApplyRows * kApplyChunk;
         e += kApplyThreads) {
      const int r = e / kApplyChunk;
      const int s = e % kApplyChunk;
      const float v = (c0 + r < C && s < len)
                          ? x[(size_t)(c0 + r) * n + r0 + s] : 0.f;
      xs[r][s] = kRound ? round_bf16(v) : v;
    }
    __syncthreads();
    const float* tcol = t + (size_t)r0 * n + col;
#pragma unroll 4
    for (int s = g; s < len; s += kApplyGroups) {
      const float tl = __ldg(tcol + (size_t)s * n);
      const float tv = kRound ? round_bf16(tl) : tl;
#pragma unroll
      for (int r = 0; r < kApplyRows; ++r) acc[r] = fmaf(xs[r][s], tv, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kApplyRows; ++r) red[g][r][tx] = acc[r];
  __syncthreads();
  if (g == 0) {
    for (int r = 0; r < kApplyRows; ++r) {
      if (c0 + r < C) {
        float v = red[0][r][tx];
#pragma unroll
        for (int u = 1; u < kApplyGroups; ++u) v += red[u][r][tx];
        out[(size_t)(c0 + r) * n + col] = v;
      }
    }
  }
}

}  // namespace irn
