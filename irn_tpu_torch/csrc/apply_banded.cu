// K4 apply_banded: one thin application x @ T for a banded T (the single
// application of the walk when square_times == exp_times).
//
// Replaces: irn_tpu/ops/matpow_pallas.py apply_banded (_banded_apply_kernel,
// a Pallas (nb, 2kb+1) grid over in-band bs x bs blocks).
//
// Output column block j (bs wide) contracts the row blocks
// k in [j - kb, j + kb] and [0, nb), kb = ceil(h / bs), reading those whole
// blocks and never a block outside them: those hold K2's unspecified fill.
// No element mask is applied, as the TPU kernel applies none.
//
// Bound on this card: HBM bandwidth. At n = 14336, h = 4448 (kb = 9) the
// in-band blocks are about 19 x 28 blocks of 1 MB, 0.5 GB read once, against
// 2 * C FLOPs per element read.
//
// Design: the 28 column blocks are far too few for 132 SMs, so the columns
// split by 32 and the seed rows by 8: one block of 256 threads (32 columns
// x 8 row groups) per (32 columns, 8 seed rows), streaming its column's
// in-band rows with coalesced 128-byte warp loads, the seed rows' window
// staged in shared memory (irn::thin_apply in common.cuh). Row groups reduce
// in a fixed order; one launch per call.
//
// The bf16 operand mode (bf16 1, the JAX kernel's matmul_dtype bfloat16:
// x and T rounded to bf16, f32 accumulation and output) rounds each value
// as it is read (thin_apply<true>): the same bytes move, so it stays bound
// by HBM as the f32 mode is.

#include "common.cuh"

namespace {

template <bool kRound>
__global__ void __launch_bounds__(irn::kApplyThreads)
apply_banded_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    float* __restrict__ out, int C, int n, int bs, int kb) {
  const int nb = n / bs;
  const int col0 = blockIdx.x * irn::kApplyCols;
  const int c0 = blockIdx.y * irn::kApplyRows;
  const int j = col0 / bs;
  const int klo = max(j - kb, 0);
  const int khi = min(j + kb, nb - 1);
  irn::thin_apply<kRound>(x, t, out, C, n, c0, col0, klo * bs,
                          (khi + 1) * bs);
}

}  // namespace

// x, out: [C, n]; t: [n, n]; n % bs == 0, bs % 32 == 0, kb >= 0; bf16 1
// rounds x and T to bf16 operands, 0 keeps them f32.
IRN_API int irn_apply_banded(const float* x, const float* t, float* out,
                             int C, int n, int bs, int kb, int bf16,
                             void* stream, int* launched) {
  if (C < 1 || n < 1 || bs < irn::kApplyCols || bs % irn::kApplyCols ||
      n % bs || kb < 0 || (C + irn::kApplyRows - 1) / irn::kApplyRows > 65535
      || (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / irn::kApplyCols,
                  (C + irn::kApplyRows - 1) / irn::kApplyRows);
  if (bf16)
    apply_banded_kernel<true><<<grid, irn::kApplyThreads, 0, s>>>(
        x, t, out, C, n, bs, kb);
  else
    apply_banded_kernel<false><<<grid, irn::kApplyThreads, 0, s>>>(
        x, t, out, C, n, bs, kb);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
