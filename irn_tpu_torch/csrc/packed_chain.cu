// K3 packed_chain: x @ T^n_apply over the packed band tiles of K1, the
// whole chain in one cooperative launch.
//
// Replaces: irn_tpu/ops/matpow_pallas.py _apply_chain_packed
// (_packed_chain_kernel, a Pallas (n_apply, nb) grid with the seed rows
// resident in VMEM); its plain twin is _apply_chain_xla's windowed einsum.
//
// One application: out[c, j*bs + b] = sum_s xpad[c, j*bs + s] * tp[j, s, b]
// with xpad = x zero-padded by kh*bs columns on both sides and
// s < span = (2kh+1)*bs.
//
// Bound on this card: the tiles, nb * span * bs * 4 bytes (205.5 MB at
// n 14336, h 1112), do not fit on chip (the TPU kept ~103 MB of bf16 tiles
// in VMEM), so a design that streams them every application is bound by
// HBM at 61 us per application. But T^2 has at most 249 nonzero diagonals:
// 5.6% of the tile entries are nonzero at the 96x128 bucket (11.4 MB), and
// an entry that is zero adds nothing to a sum (fmaf(x, 0, acc) == acc for
// finite x).
//
// Design: packed_chain.cuh's chain body over K1's tiles (PackedTiles),
// one image per launch: one cooperative launch per chain, one CTA per SM,
// the tiles' nonzero entries packed per quarter-slot in ELL form in the
// prologue (as many held in shared memory as fit, the rest in a global
// scratch read from L2), then each application's in-order fmaf chains over
// those entries and fixed-order quarter and slot sums, a grid barrier
// between applications. K8 (packed_chain_batched.cu) runs the same body
// per image, so the two are bit-equal on each image.

#include "packed_chain.cuh"

namespace {

namespace ch = irn::chain;

template <int kPre>
__global__ void __launch_bounds__(ch::kMaxThreads, 1)
packed_chain_kernel(const float* __restrict__ x, const float* __restrict__ tp,
                    float* out, float* scratch, unsigned* counter,
                    int* __restrict__ stats, long long* __restrict__ timing,
                    float* __restrict__ ell_val,
                    uint16_t* __restrict__ ell_row, const ch::Geometry g,
                    int n_apply) {
  const ch::PackedTiles src{tp, g.bs, g.span, g.strips};
  ch::run<kPre, false>(x, src, out, scratch, counter, stats, timing,
                       ell_val, ell_row, g, blockIdx.x, n_apply);
}

}  // namespace

// x, out, scratch: [C, n]; tp: [n/bs, (2kh+1)*bs, bs]; counter: one
// unsigned, 0 at the call; timing: [ctas, 5] int64, the clock cycles thread
// 0 of each CTA spent in the prologue, the grid barriers, the x waits, the
// products and the sums; stats: [items, 3] int (per item: occupied
// 32-column row segments, ELL entries, held entries; items = n/bs *
// bs/32); ell_val / ell_row: [items, span, 32] f32 / uint16 scratch for the
// entries not held. The plan (from matpow_kernels.packed_chain_plan):
// ``ctas`` CTAs of ``threads`` threads, ``ipc`` items each, ``x_blocks``
// staged x blocks, ``slots`` held entries per CTA; ``smem`` its
// shared-memory bytes.
// One cooperative launch for all n_apply >= 1 applications.
IRN_API int irn_packed_chain(const float* x, const float* tp, float* out,
                             float* scratch, void* counter, int* stats,
                             long long* timing, void* ell_val, void* ell_row,
                             int C, int n, int bs, int kh, int n_apply,
                             int ctas, int ipc, int threads, int x_blocks,
                             int slots, int smem, void* stream,
                             int* launched) {
  ch::Geometry g;
  if (n_apply < 1 ||
      !ch::geometry(C, n, bs, kh, 1, ctas, ipc, threads, x_blocks, slots,
                    &g) ||
      ch::layout(g).total != (size_t)smem)
    return (int)cudaErrorInvalidValue;
  const auto kernel = ch::prefetch_of(g, threads) == 2
                          ? packed_chain_kernel<2>
                          : packed_chain_kernel<4>;
  const int err = ch::launch_cooperative(
      kernel, ctas, threads, smem, static_cast<cudaStream_t>(stream), x, tp,
      out, scratch, static_cast<unsigned*>(counter), stats, timing,
      static_cast<float*>(ell_val), static_cast<uint16_t*>(ell_row), g,
      n_apply);
  if (err) return err;
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// How many CTAs of ``threads`` threads and ``smem`` bytes of shared memory
// one SM of the current device holds, and its SM count; launches nothing.
// K7 and K8 run the same body under the same __launch_bounds__, so their
// plans take this answer too.
IRN_API int irn_packed_chain_occupancy(int threads, int smem,
                                       int* blocks_per_sm, int* sms) {
  auto kernel = packed_chain_kernel<4>;  // the larger of the two
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                        threads, smem);
  int dev = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}
