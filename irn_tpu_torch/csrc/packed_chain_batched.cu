// K8 packed_chain_batched: B images' x_b @ T_b^n_apply over each image's
// packed band tiles (K1), the whole batch's chain in one cooperative launch.
//
// Replaces: irn_tpu/ops/matpow_pallas.py apply_banded_chain_batched
// (_packed_chain_batch_kernel, a Pallas (n_apply, nb) grid whose steps DMA
// one [B, span, bs] stack of tiles and run B small dots against it).
//
// Bound on this card: each image has its own T, so the images share no
// bytes, and a design that streams the tiles every application moves
// B * nb * span * bs * 4 bytes per application (822 MB for 4 images at
// n 14336, h 1112), far over the 50 MB L2. But only the tiles' nonzero
// entries add to a sum (5.6% of the entries of T^2's tiles at the 96x128
// bucket).
//
// Design: packed_chain.cuh's chain body (K3's) over each image's tiles:
// image b has its own group of cpi = ctas / B consecutive CTAs, so each CTA
// packs, holds and stages one image's entries and x, and reads nothing of
// the next image's. One grid barrier per application serves all B images,
// where K3 one image at a time pays B. The body and its order of sums are
// K3's, so each image's result is bit-equal to K3's on that image. The plan
// (matpow_kernels.packed_chain_plan at B images) shares the card's SMs out
// among the images; a batch that does not fit one wave runs as consecutive
// launches of image groups (the wrapper's loop), and a group of one image
// is K3's launch, body and tuning. A launch of several images holds fewer
// entries per image in shared memory (about 18% at 4 images, n 14336,
// against K3's 95%) and streams the rest from the ELL scratch in L2 or
// device memory, bound by that stream's latency: it runs the body's kBatch
// tuning, 8 entries per warp in flight instead of 4.

#include "packed_chain.cuh"

namespace {

namespace ch = irn::chain;

template <int kPre, bool kBatch>
__global__ void __launch_bounds__(ch::kMaxThreads, 1)
packed_chain_batched_kernel(const float* __restrict__ xs,
                            const float* __restrict__ tps, float* out,
                            float* scratch, unsigned* counter,
                            int* __restrict__ stats,
                            long long* __restrict__ timing,
                            float* __restrict__ ell_val,
                            uint16_t* __restrict__ ell_row,
                            const ch::Geometry g, int n_apply) {
  const int b = blockIdx.x / g.cpi;  // this CTA's image
  const size_t cn = (size_t)g.C * g.n;
  const size_t tiles = (size_t)g.items * g.span * ch::kStrip;  // one image's
  const ch::PackedTiles src{tps + b * tiles, g.bs, g.span, g.strips};
  ch::run<kPre, kBatch>(
      xs + b * cn, src, out + b * cn, scratch + b * cn, counter,
      stats + (size_t)b * g.items * 3, timing, ell_val + b * tiles,
      ell_row + b * tiles, g, blockIdx.x % g.cpi, n_apply);
}

}  // namespace

// xs, out, scratch: [B, C, n]; tps: [B, n/bs, (2kh+1)*bs, bs]; counter: one
// unsigned, 0 at the call; stats: [B, items, 3] int; timing: [ctas, 5]
// int64; ell_val / ell_row: [B, items, span, 32] f32 / uint16 scratch for
// the entries not held (items = n/bs * bs/32). The plan is
// packed_chain_plan's for ``group`` images per launch (``ctas`` / B CTAs
// per image), B <= group of them in this launch; otherwise as
// irn_packed_chain. One cooperative launch for all n_apply >= 1
// applications of the B images.
IRN_API int irn_packed_chain_batched(
    const float* xs, const float* tps, float* out, float* scratch,
    void* counter, int* stats, long long* timing, void* ell_val,
    void* ell_row, int B, int group, int C, int n, int bs, int kh,
    int n_apply, int ctas, int ipc, int threads, int x_blocks, int slots,
    int smem, void* stream, int* launched) {
  ch::Geometry g;
  if (n_apply < 1 || B > group ||
      !ch::geometry(C, n, bs, kh, B, ctas, ipc, threads, x_blocks, slots,
                    &g) ||
      ch::layout(g).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  const bool pre2 = ch::prefetch_of(g, threads) == 2;
  const auto kernel =
      group > 1 ? (pre2 ? packed_chain_batched_kernel<2, true>
                        : packed_chain_batched_kernel<4, true>)
                : (pre2 ? packed_chain_batched_kernel<2, false>
                        : packed_chain_batched_kernel<4, false>);
  const int err = ch::launch_cooperative(
      kernel, ctas, threads, smem, static_cast<cudaStream_t>(stream), xs, tps,
      out, scratch, static_cast<unsigned*>(counter), stats, timing,
      static_cast<float*>(ell_val), static_cast<uint16_t*>(ell_row), g,
      n_apply);
  if (err) return err;
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
