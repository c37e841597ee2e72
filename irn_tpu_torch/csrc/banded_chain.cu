// K7 banded_chain: x @ T^n_apply over rectangular (bs x bj) tiles of a
// banded T, T masked to its band.
//
// Replaces: irn_tpu/ops/matpow_pallas.py apply_banded_chain's general path
// (_banded_apply_chain_kernel, a Pallas (n_apply, n/bj, bj/bs + 2kh) grid
// with the seed rows resident in VMEM).
//
// One application: output column tile j (bj wide) contracts the rows
// [j*bj - kh*bs, j*bj + bj + kh*bs) and [0, n), kh = ceil(h / bs), with every
// T element of |row - col| > h replaced by 0 through a select (the jnp.where
// of the TPU path), so K2's unspecified fill, NaN included, never reaches a
// sum: wide tiles straddle the written band.
//
// Bound on this card: HBM bandwidth. Each application streams the tiles'
// row ranges, (bj + 2kh*bs) * n * 4 bytes (235 MB at n = 14336, bj = 1024,
// h = 1112), which does not fit the 50 MB L2; the seed rows (C <= 24) live
// in L2 and shared memory.
//
// Design: irn::thin_apply (common.cuh) with the band mask: one block of 256
// threads per (32 columns, 8 seed rows), streaming the tile's row range with
// coalesced loads, sums in a fixed order. The TPU ran the application grid
// in order; Hopper blocks run in no order, so the chain launches once per
// application on ping-pong device buffers, all from one C call.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(irn::kApplyThreads)
banded_chain_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    float* __restrict__ out, int C, int n, int bs, int bj,
                    int kh, int h) {
  const int col0 = blockIdx.x * irn::kApplyCols;
  const int c0 = blockIdx.y * irn::kApplyRows;
  const int j = col0 / bj;
  const int r_begin = max(j * bj - kh * bs, 0);
  const int r_end = min(j * bj + bj + kh * bs, n);
  irn::thin_apply<true>(x, t, out, C, n, c0, col0, r_begin, r_end, h);
}

}  // namespace

// x, out, scratch: [C, n]; t: [n, n]. n % bj == 0, bj % bs == 0,
// bs % 32 == 0. The last application writes ``out``; ``scratch`` carries
// the others.
IRN_API int irn_banded_chain(const float* x, const float* t, float* out,
                             float* scratch, int C, int n, int bs, int bj,
                             int kh, int h, int n_apply, void* stream,
                             int* launched) {
  if (C < 1 || n < 1 || bs < irn::kApplyCols || bs % irn::kApplyCols ||
      bj < bs || bj % bs || n % bj || kh < 0 || h < 0 || n_apply < 1 ||
      (C + irn::kApplyRows - 1) / irn::kApplyRows > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / irn::kApplyCols,
                  (C + irn::kApplyRows - 1) / irn::kApplyRows);
  const float* src = x;
  for (int a = 0; a < n_apply; ++a) {
    float* dst = ((n_apply - 1 - a) % 2 == 0) ? out : scratch;
    banded_chain_kernel<<<grid, irn::kApplyThreads, 0, s>>>(src, t, dst, C, n,
                                                            bs, bj, kh, h);
    IRN_CHECK_LAUNCH(launched);
    src = dst;
  }
  return 0;
}
