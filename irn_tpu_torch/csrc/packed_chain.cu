// K3 packed_chain: x @ T^n_apply over the packed band tiles of K1.
//
// Replaces: irn_tpu/ops/matpow_pallas.py _apply_chain_packed
// (_packed_chain_kernel, a Pallas (n_apply, nb) grid with the seed rows
// resident in VMEM); its plain twin is _apply_chain_xla's windowed einsum.
//
// One application: out[c, j*bs + b] = sum_s xpad[c, j*bs + s] * tp[j, s, b]
// with xpad = x zero-padded by kh*bs columns on both sides and
// s < span = (2kh+1)*bs.
//
// Bound on this card: HBM bandwidth. Every application streams all tiles,
// nb * span * bs * 4 bytes (205 MB at n = 14336, h = 1112), which does not
// fit the 50 MB L2 (the TPU kept it in 128 MB of VMEM); the seed rows are
// small (C <= 24) and live in L2 and shared memory.
//
// Design: nb = 28 tiles are too few blocks for 132 SMs, so the contraction
// splits by the 2kh+1 bs-row slots of a tile and the output columns by 64:
// one block per (64 columns, 8 seed rows, tile j, slot m), 256 threads as 64
// columns x 4 row quarters, the slot's x window staged in shared memory, and
// each thread streaming its tile column with coalesced loads. The quarters
// reduce through shared memory in a fixed order; a second kernel sums the
// slots in a fixed order, so results are deterministic. The block body and
// the slot sum are common.cuh's packed_partial_block / slot_sum, shared with
// K8 (packed_chain_batched.cu). The TPU ran the application grid in order;
// Hopper blocks run in no order, so this first version launches once per
// application (two kernels), ping-ponging device buffers from one host loop.

#include "common.cuh"

namespace {

using irn::kPackedCols;
using irn::kPackedRows;
using irn::kPackedThreads;

__global__ void __launch_bounds__(kPackedThreads)
packed_partial_kernel(const float* __restrict__ x, const float* __restrict__ tp,
                      float* __restrict__ part, int C, int n, int bs, int kh) {
  const int ncb = bs / kPackedCols;
  irn::packed_partial_block(x, tp, part, C, n, bs, kh, blockIdx.x % ncb,
                            (blockIdx.x / ncb) * kPackedRows, blockIdx.y,
                            blockIdx.z);
}

__global__ void slot_sum_kernel(const float* __restrict__ part,
                                float* __restrict__ out, size_t cn,
                                int nslot) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cn) return;
  out[e] = irn::slot_sum(part, cn, nslot, e);
}

}  // namespace

// x, out, scratch: [C, n]; tp: [n/bs, (2kh+1)*bs, bs]; part: [2kh+1, C, n].
// The last application writes ``out``; ``scratch`` carries the others.
IRN_API int irn_packed_chain(const float* x, const float* tp, float* out,
                             float* scratch, float* part, int C, int n,
                             int bs, int kh, int n_apply, void* stream,
                             int* launched) {
  if (C < 1 || n < 1 || bs < kPackedCols || bs % kPackedCols || n % bs ||
      kh < 0 || n_apply < 1 || n / bs > 65535 || 2 * kh + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kPackedRows * bs * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nslot = 2 * kh + 1;
  const dim3 grid((bs / kPackedCols) * ((C + kPackedRows - 1) / kPackedRows),
                  n / bs, nslot);
  const size_t cn = (size_t)C * n;
  const unsigned sum_blocks = (unsigned)((cn + 255) / 256);
  const float* src = x;
  for (int a = 0; a < n_apply; ++a) {
    float* dst = ((n_apply - 1 - a) % 2 == 0) ? out : scratch;
    packed_partial_kernel<<<grid, kPackedThreads, smem, s>>>(src, tp, part, C,
                                                             n, bs, kh);
    IRN_CHECK_LAUNCH(launched);
    slot_sum_kernel<<<sum_blocks, 256, 0, s>>>(part, dst, cn, nslot);
    IRN_CHECK_LAUNCH(launched);
    src = dst;
  }
  return 0;
}
