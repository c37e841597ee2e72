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
// slots in a fixed order, so results are deterministic. The TPU ran the
// application grid in order; Hopper blocks run in no order, so this first
// version launches once per application (two kernels), ping-ponging device
// buffers from one host loop.

#include "common.cuh"

namespace {

constexpr int kCols = 64;   // output columns per block
constexpr int kRows = 8;    // seed rows per block
constexpr int kQuarters = 4;
constexpr int kThreads = kCols * kQuarters;

__global__ void __launch_bounds__(kThreads)
packed_partial_kernel(const float* __restrict__ x, const float* __restrict__ tp,
                      float* __restrict__ part, int C, int n, int bs, int kh) {
  extern __shared__ float xs[];  // [kRows][bs] window of the seed rows
  __shared__ float red[kQuarters][kRows][kCols];
  const int nb = n / bs;
  const int ncb = bs / kCols;
  const int cb = blockIdx.x % ncb;
  const int c0 = (blockIdx.x / ncb) * kRows;
  const int j = blockIdx.y;
  const int m = blockIdx.z;
  const int span = (2 * kh + 1) * bs;
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int src_blk = j + m - kh;  // x column block this slot contracts
  const int col = j * bs + cb * kCols + tx;

  if (src_blk < 0 || src_blk >= nb) {  // slot past the matrix edge: zero
    if (ty == 0)
      for (int r = 0; r < kRows; ++r)
        if (c0 + r < C) part[((size_t)m * C + c0 + r) * n + col] = 0.f;
    return;
  }
  const size_t base = (size_t)src_blk * bs;
  for (int e = threadIdx.x; e < kRows * bs; e += kThreads) {
    const int r = e / bs;
    const int s = e % bs;
    xs[e] = (c0 + r < C) ? x[(size_t)(c0 + r) * n + base + s] : 0.f;
  }
  __syncthreads();

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  const int q = bs / kQuarters;
  const float* tcol =
      tp + ((size_t)j * span + (size_t)m * bs) * bs + cb * kCols + tx;
#pragma unroll 4
  for (int s = ty * q; s < (ty + 1) * q; ++s) {
    const float tv = __ldg(tcol + (size_t)s * bs);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(xs[r * bs + s], tv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) red[ty][r][tx] = acc[r];
  __syncthreads();
  if (ty == 0) {
    for (int r = 0; r < kRows; ++r) {
      if (c0 + r < C) {
        float v = red[0][r][tx];
#pragma unroll
        for (int u = 1; u < kQuarters; ++u) v += red[u][r][tx];
        part[((size_t)m * C + c0 + r) * n + col] = v;
      }
    }
  }
}

__global__ void slot_sum_kernel(const float* __restrict__ part,
                                float* __restrict__ out, size_t cn,
                                int nslot) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= cn) return;
  float v = part[e];
  for (int m = 1; m < nslot; ++m) v += part[(size_t)m * cn + e];
  out[e] = v;
}

}  // namespace

// x, out, scratch: [C, n]; tp: [n/bs, (2kh+1)*bs, bs]; part: [2kh+1, C, n].
// The last application writes ``out``; ``scratch`` carries the others.
IRN_API int irn_packed_chain(const float* x, const float* tp, float* out,
                             float* scratch, float* part, int C, int n,
                             int bs, int kh, int n_apply, void* stream,
                             int* launched) {
  if (C < 1 || n < 1 || bs < kCols || bs % kCols || n % bs || kh < 0 ||
      n_apply < 1 || n / bs > 65535 || 2 * kh + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRows * bs * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nslot = 2 * kh + 1;
  const dim3 grid((bs / kCols) * ((C + kRows - 1) / kRows), n / bs, nslot);
  const size_t cn = (size_t)C * n;
  const unsigned sum_blocks = (unsigned)((cn + 255) / 256);
  const float* src = x;
  for (int a = 0; a < n_apply; ++a) {
    float* dst = ((n_apply - 1 - a) % 2 == 0) ? out : scratch;
    packed_partial_kernel<<<grid, kThreads, smem, s>>>(src, tp, part, C, n,
                                                       bs, kh);
    IRN_CHECK_LAUNCH(launched);
    slot_sum_kernel<<<sum_blocks, 256, 0, s>>>(part, dst, cn, nslot);
    IRN_CHECK_LAUNCH(launched);
    src = dst;
  }
  return 0;
}
