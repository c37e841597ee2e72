// K1 pack_banded: copy the in-band bs x bs blocks of a banded T [n, n] into
// packed tiles [nb, (2kh+1)*bs, bs]. Tile j holds T's rows
// [(j-kh)*bs, (j+kh+1)*bs) of column block j, zero where those rows fall
// outside the matrix.
//
// Replaces: irn_tpu/ops/matpow_pallas.py pack_banded (_pack_kernel, a
// Pallas block-copy grid).
//
// Bound on this card: pure data movement, 2 * nb * (2kh+1) * bs^2 * 4 bytes
// (about 0.4 GB at n = 14336, h = 1112), so HBM bandwidth.
//
// Design: one block per 256 float4s of one (tile, slot) pair; every thread
// moves 16 bytes with coalesced loads and stores, and writes zeros for the
// slots past the matrix edge. A straight copy, bit-equal to the plain twin.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_kernel(const float4* __restrict__ t, float4* __restrict__ out, int n,
            int bs, int kh) {
  const int nb = n / bs;
  const int j = blockIdx.z;
  const int m = blockIdx.y;
  const int src = j + m - kh;
  const int q = bs / 4;  // float4s per tile row
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= bs * q) return;
  const int r = idx / q;
  const int c4 = idx % q;
  const size_t span = (size_t)(2 * kh + 1) * bs;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (src >= 0 && src < nb)
    v = t[((size_t)src * bs + r) * (size_t)(n / 4) + (size_t)j * q + c4];
  out[((size_t)j * span + (size_t)m * bs + r) * q + c4] = v;
}

}  // namespace

// t: [n, n]; out: [n/bs, (2kh+1)*bs, bs]; both 16-byte aligned.
IRN_API int irn_pack_banded(const float* t, float* out, int n, int bs, int kh,
                            void* stream, int* launched) {
  if (n < 1 || bs < 4 || bs % 4 || n % bs || kh < 0 || n / bs > 65535 ||
      2 * kh + 1 > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_tile = bs * (bs / 4);
  const dim3 grid((per_tile + kThreads - 1) / kThreads, 2 * kh + 1, n / bs);
  pack_kernel<<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(t), reinterpret_cast<float4*>(out), n,
      bs, kh);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
