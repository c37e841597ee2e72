// Shared helpers for the irn_tpu_torch kernels. Every entry point has a
// plain C interface: device pointers and the stream arrive as integers from
// ctypes, and each function returns cudaGetLastError() after its launches
// (0 on success), so a refused launch surfaces in the Python wrapper. Each
// also counts the kernels it launched into its last argument, ``launched``,
// which the wrapper adds to its launch counter.
//
// Two tile routines are shared by several kernels (the tensor-core split
// product of K5 and K6 lives in split_product.cuh):
// - thin_apply: one block of a thin product x @ T over a row range (K4
//   apply_banded, K7 banded_chain), optionally masked to a band.
// - packed_partial_block / slot_sum: one block of a packed-tile application
//   and its fixed-order slot sum (K8 packed_chain_batched). K3
//   packed_chain keeps their order of sums over the tiles' nonzero entries,
//   so that K8's result on each image is bit-equal to K3's.
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

namespace irn {

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
// out[c0 + r, col] = sum_{row in [r_begin, r_end)} x[c0 + r, row] * T'[row, col]
// for the 8 seed rows c0 .. c0+7 and the 32 columns col0 .. col0+31 of one
// block (256 threads = 32 columns x 8 row groups), with T' = T, or with kMask
// T' = (|row - col| <= h ? T : 0) as a select, so that a NaN outside the
// band never reaches a sum. Reads T only at rows [r_begin, r_end). The seed
// rows' window is staged through shared memory in chunks of 256 rows; row
// group g sums the rows g, g+8, g+16, ... of each chunk in order, and the
// groups reduce in a fixed order: the result is deterministic.

constexpr int kApplyCols = 32;
constexpr int kApplyGroups = 8;
constexpr int kApplyRows = 8;
constexpr int kApplyChunk = 256;
constexpr int kApplyThreads = kApplyCols * kApplyGroups;

template <bool kMask>
__device__ __forceinline__ void thin_apply(const float* __restrict__ x,
                                           const float* __restrict__ t,
                                           float* __restrict__ out, int C,
                                           int n, int c0, int col0,
                                           int r_begin, int r_end, int h) {
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
      xs[r][s] = (c0 + r < C && s < len) ? x[(size_t)(c0 + r) * n + r0 + s]
                                         : 0.f;
    }
    __syncthreads();
    const float* tcol = t + (size_t)r0 * n + col;
#pragma unroll 4
    for (int s = g; s < len; s += kApplyGroups) {
      float tv = __ldg(tcol + (size_t)s * n);
      if (kMask) tv = (abs(r0 + s - col) <= h) ? tv : 0.f;
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

// -- packed_partial_block / slot_sum ---------------------------------------
//
// One application of x @ T over K1's packed tiles tp [n/bs, (2kh+1)*bs, bs]:
// part[m, c0 + r, col] = sum_{s < bs} x[c0 + r, (j+m-kh)*bs + s]
//                                     * tp[j, m*bs + s, col - j*bs]
// for slot m of tile j, the 8 seed rows c0 .. c0+7 and the 64 columns
// col = j*bs + cb*64 + tx of one block (256 threads = 64 columns x 4 row
// quarters). A slot past the matrix edge writes zeros. The slot's x window
// is staged in dynamic shared memory (8 * bs floats); quarter u sums
// s in [u*bs/4, (u+1)*bs/4) in order with fmaf, and the quarters reduce in
// a fixed order. slot_sum then adds the 2kh+1 slots in order, so the result
// is deterministic; K3 (packed_chain.cu) sums in the same order.

constexpr int kPackedCols = 64;
constexpr int kPackedRows = 8;
constexpr int kPackedQuarters = 4;
constexpr int kPackedThreads = kPackedCols * kPackedQuarters;

__device__ __forceinline__ void packed_partial_block(
    const float* __restrict__ x, const float* __restrict__ tp,
    float* __restrict__ part, int C, int n, int bs, int kh, int cb, int c0,
    int j, int m) {
  extern __shared__ float xs[];  // [kPackedRows][bs] window of the seed rows
  __shared__ float red[kPackedQuarters][kPackedRows][kPackedCols];
  const int nb = n / bs;
  const int span = (2 * kh + 1) * bs;
  const int tx = threadIdx.x % kPackedCols;
  const int ty = threadIdx.x / kPackedCols;
  const int src_blk = j + m - kh;  // x column block this slot contracts
  const int col = j * bs + cb * kPackedCols + tx;

  if (src_blk < 0 || src_blk >= nb) {  // slot past the matrix edge: zero
    if (ty == 0)
      for (int r = 0; r < kPackedRows; ++r)
        if (c0 + r < C) part[((size_t)m * C + c0 + r) * n + col] = 0.f;
    return;
  }
  const size_t base = (size_t)src_blk * bs;
  for (int e = threadIdx.x; e < kPackedRows * bs; e += kPackedThreads) {
    const int r = e / bs;
    const int s = e % bs;
    xs[e] = (c0 + r < C) ? x[(size_t)(c0 + r) * n + base + s] : 0.f;
  }
  __syncthreads();

  float acc[kPackedRows];
#pragma unroll
  for (int r = 0; r < kPackedRows; ++r) acc[r] = 0.f;
  const int q = bs / kPackedQuarters;
  const float* tcol =
      tp + ((size_t)j * span + (size_t)m * bs) * bs + cb * kPackedCols + tx;
#pragma unroll 4
  for (int s = ty * q; s < (ty + 1) * q; ++s) {
    const float tv = __ldg(tcol + (size_t)s * bs);
#pragma unroll
    for (int r = 0; r < kPackedRows; ++r)
      acc[r] = fmaf(xs[r * bs + s], tv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kPackedRows; ++r) red[ty][r][tx] = acc[r];
  __syncthreads();
  if (ty == 0) {
    for (int r = 0; r < kPackedRows; ++r) {
      if (c0 + r < C) {
        float v = red[0][r][tx];
#pragma unroll
        for (int u = 1; u < kPackedQuarters; ++u) v += red[u][r][tx];
        part[((size_t)m * C + c0 + r) * n + col] = v;
      }
    }
  }
}

// sum_m part[m * cn + e] over the nslot slots, in slot order.
__device__ __forceinline__ float slot_sum(const float* __restrict__ part,
                                          size_t cn, int nslot, size_t e) {
  float v = part[e];
  for (int m = 1; m < nslot; ++m) v += part[(size_t)m * cn + e];
  return v;
}

}  // namespace irn
