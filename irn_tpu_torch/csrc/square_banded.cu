// K2 square_banded: T @ T for a banded T (T[r, q] == 0 when |q - r| > h).
//
// Replaces: irn_tpu/ops/matpow_pallas.py square_banded
// (_banded_square_kernel, a Pallas MXU grid over in-band blocks).
//
// Only output blocks (i, j) with |i - j| <= jb = ceil(2h/bs) are computed,
// and each contracts only the blocks k in [max(i,j) - kb, min(i,j) + kb],
// kb = ceil(h/bs), where both operands are in band. Out-of-band output
// blocks are never written: as in the TPU kernel's contract their content
// is unspecified, and every consumer reads in-band tiles only (K1).
//
// Bound on this card: f32 FLOPs. At n = 14336, bs = 512, h = 556 the band
// holds about 640 block products of 2 * 512^3 FLOPs each (0.17 TFLOP), far
// above the bytes it reads, and f32 runs outside the tensor cores
// (67 TFLOP/s peak): TF32 would not be an f32 result.
//
// Design: a classic shared-memory SGEMM. Each CUDA block owns one 64 x 64
// sub-tile of an in-band 512 x 512 output block, stages 64 x 16 and 16 x 64
// operand slabs through shared memory, and accumulates a 4 x 4 register tile
// per thread with FMA over the valid contraction blocks only. wgmma, TMA and
// persistent scheduling are left for later work.

#include "common.cuh"

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
banded_square_kernel(const float* __restrict__ t, float* __restrict__ out,
                     int n, int bs, int kb, int jb) {
  const int nb = n / bs;
  const int i = blockIdx.z;
  const int j = i + (int)blockIdx.y - jb;
  if (j < 0 || j >= nb) return;
  const int nsub = bs / TN;
  const int row0 = i * bs + (int)(blockIdx.x / nsub) * TM;
  const int col0 = j * bs + (int)(blockIdx.x % nsub) * TN;
  const int klo = max(max(i, j) - kb, 0);
  const int khi = min(min(i, j) + kb, nb - 1);

  __shared__ float As[TK][TM + 4];  // A slab, transposed: As[k][m]
  __shared__ float Bs[TK][TN + 4];
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = klo * bs; k0 < (khi + 1) * bs; k0 += TK) {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const int idx = tid + l * kThreads;  // 0 .. 1023
      const int ar = idx / TK, ac = idx % TK;
      As[ac][ar] = t[(size_t)(row0 + ar) * n + k0 + ac];
      const int br = idx / TN, bc = idx % TN;
      Bs[br][bc] = t[(size_t)(k0 + br) * n + col0 + bc];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = As[kk][ty * 4 + q];
        b[q] = Bs[kk][tx * 4 + q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(size_t)(row0 + ty * 4 + p) * n + col0 + tx * 4 + q] = acc[p][q];
}

}  // namespace

// t, out: [n, n] (out distinct from t). kb/jb: block-level input/output band
// halfwidths. Requires n % bs == 0 and bs % 64 == 0.
IRN_API int irn_square_banded(const float* t, float* out, int n, int bs,
                              int kb, int jb, void* stream, int* launched) {
  if (n < 1 || bs < TM || bs % TM || n % bs || kb < 0 || jb < 0 ||
      n / bs > 65535 || 2 * jb + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsub = bs / TM;
  const dim3 grid(nsub * nsub, 2 * jb + 1, n / bs);
  banded_square_kernel<<<grid, kThreads, 0, s>>>(t, out, n, bs, kb, jb);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
