// K7 banded_chain: x @ (T masked to |r - c| <= h)^n_apply for a banded T
// whose out-of-band elements may hold anything (K2's unspecified fill, NaN
// included), the whole chain in one cooperative launch.
//
// Replaces: irn_tpu/ops/matpow_pallas.py apply_banded_chain's general path
// (_banded_apply_chain_kernel, a Pallas (n_apply, n/bj, bj/bs + 2kh) grid
// over rectangular bs x bj tiles with the seed rows resident in VMEM, T
// masked by a jnp.where).
//
// The TPU tiled the output by bj, and output tile j contracted the rows
// [j*bj - kh*bs, j*bj + bj + kh*bs), kh = ceil(h / bs): every row within h
// of each of its columns. The masked sum is therefore the same for any bj,
// so this kernel does not tile by bj (the wrapper keeps bj's checks, as the
// JAX function does): it runs K3's plan and items, n/bs tiles x bs/32
// strips, where strip (j, s) contracts the rows [(j - kh)*bs,
// (j + kh + 1)*bs) of its 32 columns.
//
// Bound on this card: streaming T's band rows every application would move
// n * (2kh+1) * bs * 4 bytes per application (205 MB at n 14336, h 1112),
// over the 50 MB L2; only T's nonzero band entries add to a sum.
//
// Design: packed_chain.cuh's chain body (K3's) over the dense T masked to
// its band (MaskedBand): the prologue reads each strip's rows straight from
// T, so no packing pass (K1) is needed, and applies the band mask as a
// select, (|r - c| <= h ? T : 0), before the nonzero test, so an element
// beyond h (NaN included) is dropped before it is counted. Where T is zero
// between h and the tile edge (K2's output; banded products add
// halfwidths), the entries are K1 + K3's, and so are the bits.

#include "packed_chain.cuh"

namespace {

namespace ch = irn::chain;

template <int kPre>
__global__ void __launch_bounds__(ch::kMaxThreads, 1)
banded_chain_kernel(const float* __restrict__ x, const float* __restrict__ t,
                    float* out, float* scratch, unsigned* counter,
                    int* __restrict__ stats, long long* __restrict__ timing,
                    float* __restrict__ ell_val,
                    uint16_t* __restrict__ ell_row, const ch::Geometry g,
                    int h, int n_apply) {
  const ch::MaskedBand src{t, g.n, g.bs, g.kh, h, g.strips};
  ch::run<kPre, false>(x, src, out, scratch, counter, stats, timing,
                       ell_val, ell_row, g, blockIdx.x, n_apply);
}

}  // namespace

// x, out, scratch: [C, n]; t: [n, n]; kh = ceil(h / bs); otherwise as
// irn_packed_chain (stats [items, 3], timing [ctas, 5], ell_val / ell_row
// [items, (2kh+1)*bs, 32], the plan packed_chain_plan's). One cooperative
// launch for all n_apply >= 1 applications.
IRN_API int irn_banded_chain(const float* x, const float* t, float* out,
                             float* scratch, void* counter, int* stats,
                             long long* timing, void* ell_val, void* ell_row,
                             int C, int n, int bs, int kh, int h, int n_apply,
                             int ctas, int ipc, int threads, int x_blocks,
                             int slots, int smem, void* stream,
                             int* launched) {
  ch::Geometry g;
  if (n_apply < 1 || h < 0 || (long long)kh * bs < h ||
      !ch::geometry(C, n, bs, kh, 1, ctas, ipc, threads, x_blocks, slots,
                    &g) ||
      ch::layout(g).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  const auto kernel = ch::prefetch_of(g, threads) == 2
                          ? banded_chain_kernel<2>
                          : banded_chain_kernel<4>;
  const int err = ch::launch_cooperative(
      kernel, ctas, threads, smem, static_cast<cudaStream_t>(stream), x, t,
      out, scratch, static_cast<unsigned*>(counter), stats, timing,
      static_cast<float*>(ell_val), static_cast<uint16_t*>(ell_row), g, h,
      n_apply);
  if (err) return err;
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
