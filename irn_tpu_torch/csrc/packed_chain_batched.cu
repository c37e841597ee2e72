// K8 packed_chain_batched: B images' x_b @ T_b^n_apply over each image's
// packed band tiles (K1), all images in the same launches.
//
// Replaces: irn_tpu/ops/matpow_pallas.py apply_banded_chain_batched
// (_packed_chain_batch_kernel, a Pallas (n_apply, nb) grid whose steps DMA
// one [B, span, bs] stack of tiles and run B small dots against it).
//
// Bound on this card: HBM bandwidth. Each image has its own T, so the
// images share no bytes: per application every image streams its own
// nb * span * bs * 4 bytes (205.5 MB at n = 14336, h = 1112), B times that
// in all, far over the 50 MB L2. K3 (packed_chain.cu) has since packed the
// tiles' nonzeros on chip once per chain; this kernel still streams them.
//
// Design: one block per (64 columns, 8 seed rows, tile j, image b x slot
// m), the block body common.cuh's packed_partial_block on image b's
// pointers, a partial buffer [B, 2kh+1, C, n], then the fixed-order slot
// sum per image (slot_sum); a slot past the matrix edge writes zeros. K3
// sums in the same order, so each image's result is bit-equal to K3's on
// that image. Two launches per application on ping-pong buffers, from one
// host loop.

#include "common.cuh"

namespace {

using irn::kPackedCols;
using irn::kPackedRows;
using irn::kPackedThreads;

__global__ void __launch_bounds__(kPackedThreads)
batched_partial_kernel(const float* __restrict__ xs,
                       const float* __restrict__ tps, float* __restrict__ part,
                       int C, int n, int bs, int kh) {
  const int nslot = 2 * kh + 1;
  const int ncb = bs / kPackedCols;
  const int b = blockIdx.z / nslot;
  const size_t cn = (size_t)C * n;
  const size_t tiles = (size_t)(n / bs) * nslot * bs * bs;  // one image's
  irn::packed_partial_block(xs + b * cn, tps + b * tiles,
                            part + (size_t)b * nslot * cn, C, n, bs, kh,
                            blockIdx.x % ncb, (blockIdx.x / ncb) * kPackedRows,
                            blockIdx.y, blockIdx.z % nslot);
}

__global__ void batched_slot_sum_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, size_t cn,
                                        int nslot, size_t total) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const size_t b = e / cn;
  out[e] = irn::slot_sum(part + b * nslot * cn, cn, nslot, e - b * cn);
}

}  // namespace

// xs, out, scratch: [B, C, n]; tps: [B, n/bs, (2kh+1)*bs, bs];
// part: [B, 2kh+1, C, n]. The last application writes ``out``; ``scratch``
// carries the others.
IRN_API int irn_packed_chain_batched(const float* xs, const float* tps,
                                     float* out, float* scratch, float* part,
                                     int B, int C, int n, int bs, int kh,
                                     int n_apply, void* stream,
                                     int* launched) {
  if (B < 1 || C < 1 || n < 1 || bs < kPackedCols || bs % kPackedCols ||
      n % bs || kh < 0 || n_apply < 1 || n / bs > 65535 ||
      (long long)B * (2 * kh + 1) > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kPackedRows * bs * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nslot = 2 * kh + 1;
  const dim3 grid((bs / kPackedCols) * ((C + kPackedRows - 1) / kPackedRows),
                  n / bs, B * nslot);
  const size_t cn = (size_t)C * n;
  const size_t total = (size_t)B * cn;
  const unsigned sum_blocks = (unsigned)((total + 255) / 256);
  const float* src = xs;
  for (int a = 0; a < n_apply; ++a) {
    float* dst = ((n_apply - 1 - a) % 2 == 0) ? out : scratch;
    batched_partial_kernel<<<grid, kPackedThreads, smem, s>>>(src, tps, part,
                                                              C, n, bs, kh);
    IRN_CHECK_LAUNCH(launched);
    batched_slot_sum_kernel<<<sum_blocks, 256, 0, s>>>(part, dst, cn, nslot,
                                                       total);
    IRN_CHECK_LAUNCH(launched);
    src = dst;
  }
  return 0;
}
