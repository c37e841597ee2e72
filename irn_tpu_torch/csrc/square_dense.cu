// K5 square_dense: T @ T for a dense n x n f32 matrix (every squaring of the
// pure-squaring walk after the first).
//
// Replaces: irn_tpu/ops/matpow_pallas.py square_pallas (_square_kernel, a
// Pallas MXU grid over (i, j, k) blocks with an f32 VMEM accumulator).
//
// Bound on this card: f32 FLOPs. At n = 14336 one squaring is 2 n^3 =
// 5.9 TFLOP against 2.5 GB of operand and output bytes; f32 runs outside the
// tensor cores (67 TFLOP/s peak), and TF32 would not be the f32 result.
//
// Design: a classic register-blocked SGEMM (irn::sgemm_tile in common.cuh):
// one 128 x 128 output tile per block, 8 x 8 outputs per thread, 8-deep
// operand slabs double-buffered through shared memory. Each output sums
// k = 0 .. n-1 in order, so the result is deterministic. The TPU's
// 1024-block divisibility is a TPU limit; this kernel takes any n that is a
// multiple of 128 (the walk pads n to 512). wgmma, TMA and a persistent
// schedule are left for later work.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(irn::kGemmThreads, 2)
square_dense_kernel(const float* __restrict__ t, float* __restrict__ out,
                    int n) {
  irn::sgemm_tile(t, t, out, n);
}

}  // namespace

// t, out: [n, n] (out distinct from t), n % 128 == 0.
IRN_API int irn_square_dense(const float* t, float* out, int n, void* stream,
                             int* launched) {
  if (n < irn::kGemmBM || n % irn::kGemmBM || n / irn::kGemmBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / irn::kGemmBN, n / irn::kGemmBM);
  square_dense_kernel<<<grid, irn::kGemmThreads, 0, s>>>(t, out, n);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
