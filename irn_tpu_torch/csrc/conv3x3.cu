// K9 conv3x3: SAME 3x3 stride-1 convolution, NHWC bf16 in and out, f32
// accumulation, one round to bf16 (nearest even) at the store.
//
// Replaces: tools/bench_conv_pallas.py conv3x3_pallas (a Pallas (B, H/bh)
// grid with the whole zero-padded image resident in VMEM, an im2col slab
// along lanes and three [bh*W, 3C] x [3C, F] MXU dots per step).
//
// out[b, y, x, f] = sum_{dy, dx, c} xpad[b, y + dy, x + dx, c] * k[dy, dx, c, f]
// with xpad the input zero-padded by one pixel on each side; k is HWIO.
//
// Bound on this card: the tensor cores. At the probe's c3 shape
// ([64, 125, 94, 128] -> 128) the conv is 221.8 GFLOP against 0.38 GB of
// activations in and out: about 580 operations per byte, over the H100's
// ~295 bf16 ridge, so time goes to the product, not to HBM.
//
// Design: an implicit GEMM (M = B*H*W pixels, N = F, K = 9*C) on
// nvcuda::wmma 16x16x16 bf16 tiles with f32 accumulators. One block of 8
// warps computes an 8-row x 16-column pixel tile of one image for 64 output
// channels; warp r owns output row r (one 16-pixel M tile) and four 16-wide
// N tiles. For each 16-channel chunk the block stages, once, the (8+2) x
// (16+2) x 16 input halo (zeros beyond the image: the SAME padding, and the
// edge masks for H and W that are not multiples of the tile) and the
// matching 3 x 3 x 16 x 64 weight slice in shared memory; each warp then
// runs the 9 taps as shifted A tiles of the halo (a tap is an offset into
// it: no im2col copy). The f32 accumulators go through shared memory to
// 16-byte bf16 stores with the ragged edge masked. This first version does
// not pipeline the chunk loads against the products (no cp.async, no
// wgmma): making it fast is later work.

#include "common.cuh"

#include <cuda_bf16.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kTileH = 8;   // output rows per block, one warp each
constexpr int kTileW = 16;  // output columns per block: one wmma M tile
constexpr int kTileF = 64;  // output channels per block: four wmma N tiles
constexpr int kChunk = 16;  // input channels per stage: one wmma K step
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kThreads = 32 * kTileH;
constexpr int kNTiles = kTileF / 16;
constexpr int kOutLd = kTileF + 4;  // f32 staging row stride
constexpr int kVec = 8;             // bf16 per 16-byte load or store

constexpr int kHaloBytes = kHaloH * kHaloW * kChunk * 2;
constexpr int kWeightBytes = 9 * kChunk * kTileF * 2;
constexpr int kStageBytes = kTileH * kTileW * kOutLd * 4;
constexpr int kSmemBytes = (kHaloBytes + kWeightBytes > kStageBytes)
                               ? kHaloBytes + kWeightBytes
                               : kStageBytes;
static_assert(kHaloBytes % 32 == 0, "wmma pointers need 32-byte alignment");

// Two f32 values rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__global__ void __launch_bounds__(kThreads)
conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ k,
               bf16* __restrict__ out, int H, int W, int C, int F,
               int tiles_w) {
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  bf16* halo = reinterpret_cast<bf16*>(smem);  // [kHaloH][kHaloW][kChunk]
  bf16* wt = reinterpret_cast<bf16*>(smem + kHaloBytes);  // [9][kChunk][kTileF]
  float* stage = reinterpret_cast<float*>(smem);  // [kTileH*kTileW][kOutLd]

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = (blockIdx.x % tiles_w) * kTileW;
  const int f0 = (blockIdx.x / tiles_w) * kTileF;
  const int warp = threadIdx.x / 32;
  const int n_valid = min(kNTiles, (F - f0) / 16);  // F % 16 == 0
  const uint4 zero = make_uint4(0, 0, 0, 0);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kNTiles];
#pragma unroll
  for (int t = 0; t < kNTiles; ++t) wmma::fill_fragment(acc[t], 0.f);

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    __syncthreads();  // the previous chunk's fragment loads are done
    for (int e = threadIdx.x; e < kHaloH * kHaloW * (kChunk / kVec);
         e += kThreads) {
      const int p = e / (kChunk / kVec);
      const int v = e % (kChunk / kVec);
      const int gy = y0 - 1 + p / kHaloW;
      const int gx = x0 - 1 + p % kHaloW;
      uint4 val = zero;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = *reinterpret_cast<const uint4*>(
            x + (((size_t)b * H + gy) * W + gx) * C + c0 + v * kVec);
      *reinterpret_cast<uint4*>(halo + p * kChunk + v * kVec) = val;
    }
    for (int e = threadIdx.x; e < 9 * kChunk * (kTileF / kVec);
         e += kThreads) {
      const int row = e / (kTileF / kVec);  // tap * kChunk + channel
      const int v = e % (kTileF / kVec);
      const int f = f0 + v * kVec;
      uint4 val = zero;
      if (f < F)
        val = *reinterpret_cast<const uint4*>(
            k + ((size_t)(row / kChunk) * C + c0 + row % kChunk) * F + f);
      *reinterpret_cast<uint4*>(wt + row * kTileF + v * kVec) = val;
    }
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      // A[m, c] = halo[warp + dy][m + dx][c]: the tap is an offset
      wmma::load_matrix_sync(a, halo + ((warp + dy) * kHaloW + dx) * kChunk,
                             kChunk);
#pragma unroll
      for (int t = 0; t < kNTiles; ++t) {
        if (t < n_valid) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> w;
          wmma::load_matrix_sync(w, wt + tap * kChunk * kTileF + t * 16,
                                 kTileF);
          wmma::mma_sync(acc[t], a, w, acc[t]);
        }
      }
    }
  }

  __syncthreads();  // the staging buffer overlays the halo and weights
#pragma unroll
  for (int t = 0; t < kNTiles; ++t)
    if (t < n_valid)
      wmma::store_matrix_sync(stage + warp * 16 * kOutLd + t * 16, acc[t],
                              kOutLd, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kTileH * kTileW * (kTileF / kVec);
       e += kThreads) {
    const int p = e / (kTileF / kVec);
    const int v = e % (kTileF / kVec);
    const int gy = y0 + p / kTileW;
    const int gx = x0 + p % kTileW;
    const int f = f0 + v * kVec;
    if (gy >= H || gx >= W || f >= F) continue;
    const float* s = stage + p * kOutLd + v * kVec;
    *reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) * F + f) =
        make_uint4(pack_bf16x2(s[0], s[1]), pack_bf16x2(s[2], s[3]),
                   pack_bf16x2(s[4], s[5]), pack_bf16x2(s[6], s[7]));
  }
}

}  // namespace

// x: [B, H, W, C] bf16; k: [3, 3, C, F] bf16 (HWIO); out: [B, H, W, F] bf16;
// all contiguous and 16-byte aligned, C and F multiples of 16.
IRN_API int irn_conv3x3(const void* x, const void* k, void* out, int B, int H,
                        int W, int C, int F, void* stream, int* launched) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || F < 16 || C % 16 || F % 16 ||
      B > 65535 || (H + kTileH - 1) / kTileH > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + kTileW - 1) / kTileW;
  const dim3 grid(tiles_w * ((F + kTileF - 1) / kTileF),
                  (H + kTileH - 1) / kTileH, B);
  conv3x3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(k),
      static_cast<bf16*>(out), H, W, C, F, tiles_w);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
