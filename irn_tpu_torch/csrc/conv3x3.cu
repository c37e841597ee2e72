// K9 conv3x3: SAME 3x3 stride-1 convolution, NHWC bf16 in and out, f32
// accumulation, one round to bf16 (nearest even) at the store.
//
// Replaces: tools/bench_conv_pallas.py conv3x3_pallas (a Pallas (B, H/bh)
// grid with the whole zero-padded image resident in VMEM, an im2col slab
// along lanes and three [bh*W, 3C] x [3C, F] MXU dots per step).
//
// out[b, y, x, f] = sum_{dy, dx, c} xpad[b, y + dy, x + dx, c] * k[dy, dx, c, f]
// with xpad the input zero-padded by one pixel on each side. The wrapper
// re-lays k (HWIO) once as wt [F, 9, C], so that every weight slice is
// K-major.
//
// Bound on this card: the tensor cores. At the probe's c3 shape
// ([64, 125, 94, 128] -> 128) the conv is 221.8 GFLOP against 0.38 GB of
// activations in and out: 0.224 ms at the 989 TFLOP/s bf16 peak, 0.115 ms
// at 3.35 TB/s.
//
// Design: an implicit GEMM (M = pixels, N = F, K = 9 C) on wgmma, persistent
// over output tiles of 8 rows x 16 pixels (128 M rows) x 128 channels.
// - One producer warp keeps TMA loads in flight: per 64-channel chunk the
//   (8+2) x (16+2) x 64 input halo (a 4-D box at (c0, x0-1, y0-1, b); TMA
//   fills zeros outside the tensor, which is the SAME padding, the ragged
//   edge in H and W and the channels past C), and per tap the 128 x 64
//   weight slice, into two rings of mbarrier-guarded stages, both in TMA's
//   128-byte swizzle.
// - Two consumer warpgroups (warp w owns output row w of the tile) run
//   wgmma m64n128k16 with A from registers: each lane's ldmatrix row
//   address is a halo pixel, so a tap is an address offset and no im2col
//   copy is made (a shared-memory A descriptor cannot say this: an 8 x 16
//   pixel tile's rows sit at a halo stride of 18, not 16). B is the weight
//   slice through a wgmma descriptor. Two register sets of A let the next
//   tap's ldmatrix run under the current tap's products; each weight stage
//   is released once its products have retired.
// - Epilogue: f32 -> bf16 (nearest even) through a per-warp staging tile,
//   then 16-byte stores, masked at the ragged edge in H, W and F.
// Every tile re-reads its weight slices from L2 (295 KB per 128 pixels at
// c3): at the bf16 peak that asks more of L2 than it delivers, so this
// first pipeline stays under the peak; a larger pixel tile or cluster
// multicast of the weights is the next step.

#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
namespace hp = irn::hopper;

constexpr int kTileH = 8;    // output rows per tile: one per consumer warp
constexpr int kTileW = 16;   // pixels per row: a warp's 16 M rows
constexpr int kTileF = 128;  // output channels per tile: the wgmma N
constexpr int kChunk = 64;   // input channels per stage: a 128-byte row
constexpr int kHaloH = kTileH + 2;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloBytes = kHaloH * kHaloW * kChunk * 2;        // 23040
constexpr int kHaloStride = (kHaloBytes + 1023) / 1024 * 1024;  // 23552
constexpr int kHaloStages = 2;
constexpr int kWBytes = kTileF * kChunk * 2;  // one tap's weight slice
constexpr int kWStages = 8;
constexpr int kOutLd = kTileF * 2 + 16;  // staged output row, bytes (padded)
constexpr int kOutWarpBytes = kTileW * kOutLd;
constexpr int kConsumerWarps = 8;  // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 32;  // + one producer warp
constexpr int kWOffset = kHaloStages * kHaloStride;
constexpr int kOutOffset = kWOffset + kWStages * kWBytes;
constexpr int kBarOffset = kOutOffset + kConsumerWarps * kOutWarpBytes;
constexpr int kSmemBytes =
    1024 + kBarOffset + 2 * (kHaloStages + kWStages) * 8;
static_assert(kSmemBytes <= 232448, "over the per-block shared memory");

struct Tiles {
  int f, x, y, total;
};

__device__ __forceinline__ void tile_origin(const Tiles& t, int i, int& b,
                                            int& y0, int& x0, int& f0) {
  f0 = (i % t.f) * kTileF;
  i /= t.f;
  x0 = (i % t.x) * kTileW;
  i /= t.x;
  y0 = (i % t.y) * kTileH;
  b = i / t.y;
}

__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __grid_constant__ CUtensorMap xmap,
               const __grid_constant__ CUtensorMap wmap,
               bf16* __restrict__ out, int H, int W, int C, int F,
               Tiles tiles) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* halo_full = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  uint64_t* halo_empty = halo_full + kHaloStages;
  uint64_t* w_full = halo_empty + kHaloStages;
  uint64_t* w_empty = w_full + kWStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHaloStages; ++s) {
      hp::mbar_init(&halo_full[s], 1);
      hp::mbar_init(&halo_empty[s], kConsumerWarps);
    }
    for (int s = 0; s < kWStages; ++s) {
      hp::mbar_init(&w_full[s], 1);
      hp::mbar_init(&w_empty[s], kConsumerWarps);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // producer warp: lane 0 issues the loads
    if (lane == 0) {
      int h_it = 0, w_it = 0;
      for (int t = blockIdx.x; t < tiles.total; t += gridDim.x) {
        int b, y0, x0, f0;
        tile_origin(tiles, t, b, y0, x0, f0);
        for (int c0 = 0; c0 < C; c0 += kChunk, ++h_it) {
          const int hs = h_it % kHaloStages;
          hp::mbar_wait(&halo_empty[hs], ((h_it / kHaloStages) & 1) ^ 1);
          hp::mbar_expect_tx(&halo_full[hs], kHaloBytes);
          hp::tma_load_4d(smem + hs * kHaloStride, &xmap, &halo_full[hs], c0,
                          x0 - 1, y0 - 1, b);
          for (int tap = 0; tap < 9; ++tap, ++w_it) {
            const int ws = w_it % kWStages;
            hp::mbar_wait(&w_empty[ws], ((w_it / kWStages) & 1) ^ 1);
            hp::mbar_expect_tx(&w_full[ws], kWBytes);
            hp::tma_load_3d(smem + kWOffset + ws * kWBytes, &wmap, &w_full[ws],
                            c0, tap, f0);
          }
        }
      }
    }
    return;
  }

  // consumers: warp w computes output row w of the tile, 16 pixels x 128
  // channels; lane l addresses halo pixel l % 16 for ldmatrix, channels
  // 8 (l / 16) .. +7 of each 16-channel step
  const uint32_t halo0 = hp::smem_u32(smem);
  const uint32_t wbuf0 = hp::smem_u32(smem + kWOffset);
  uint8_t* stage = smem + kOutOffset + warp * kOutWarpBytes;
  const int lane_row = warp * kHaloW + (lane & 15);
  const int lane_half = lane >> 4;
  float acc[64];
  uint32_t a[2][4][4];
  int h_it = 0, w_it = 0;
  int pending = -1;  // weight stage whose products may still be in flight

  for (int t = blockIdx.x; t < tiles.total; t += gridDim.x) {
    int b, y0, x0, f0;
    tile_origin(tiles, t, b, y0, x0, f0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    // a chunk past C holds TMA's zeros in both operands, so every chunk
    // runs all four k16 steps: no wgmma sits on a divergent path
    for (int c0 = 0; c0 < C; c0 += kChunk, ++h_it) {
      const int hs = h_it % kHaloStages;
      const uint32_t halo = halo0 + hs * kHaloStride;
      hp::mbar_wait(&halo_full[hs], (h_it / kHaloStages) & 1);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap, ++w_it) {
        const int buf = tap & 1;
        if (tap == 0) {
          // the previous chunk's last tap used this register set
          hp::wgmma_wait<0>();
          if (pending >= 0) {
            __syncwarp();
            if (lane == 0) hp::mbar_arrive(&w_empty[pending]);
          }
          pending = -1;
        }
        const int row = lane_row + (tap / 3) * kHaloW + tap % 3;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int chunk16 = (2 * kk + lane_half) ^ (row & 7);
          hp::ldmatrix_x4(a[buf][kk], halo + row * 128 + chunk16 * 16);
        }
        if (tap == 8) {  // the halo stage is read for the last time
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(&halo_empty[hs]);
        }
        const int ws = w_it % kWStages;
        hp::mbar_wait(&w_full[ws], (w_it / kWStages) & 1);
        const uint64_t desc = hp::desc_k128(wbuf0 + ws * kWBytes);
        hp::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hp::wgmma_m64n128k16_rs(acc, a[buf][kk], desc + 2 * kk, 1);
        hp::wgmma_commit();
        hp::wgmma_wait<1>();  // the previous tap's products have retired
        if (pending >= 0) {
          __syncwarp();
          if (lane == 0) hp::mbar_arrive(&w_empty[pending]);
        }
        pending = ws;
      }
    }
    hp::wgmma_wait<0>();
    hp::fence_acc(acc);
    __syncwarp();
    if (lane == 0) hp::mbar_arrive(&w_empty[pending]);
    pending = -1;

    // accumulator layout: per 8-column block j, pixels lane/4 and lane/4 + 8
    // of the warp's 16, channels 8j + 2 (lane % 4) + {0, 1}
    const int p = lane / 4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = (8 * j + 2 * (lane % 4)) * 2;
      *reinterpret_cast<__nv_bfloat162*>(stage + p * kOutLd + col) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(stage + (p + 8) * kOutLd + col) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncwarp();
    const int gy = y0 + warp;
    if (gy < H) {
#pragma unroll
      for (int it = 0; it < kTileW * kTileF / 8 / 32; ++it) {
        const int idx = it * 32 + lane;
        const int px = idx / (kTileF / 8);
        const int q = idx % (kTileF / 8);
        const int gx = x0 + px;
        const int f = f0 + q * 8;
        if (gx < W && f < F)
          *reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) * F +
                                    f) =
              *reinterpret_cast<const uint4*>(stage + px * kOutLd + q * 16);
      }
    }
    __syncwarp();  // the staging tile is read before the next tile writes it
  }
}

// The SM count of the first card that asks, kept for every later call: the
// same answer on a host of identical cards (one H100 model), which is the
// only kind the port runs on; cards of mixed models would need it per
// device.
int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

// x: [B, H, W, C] bf16 (NHWC); wt: [F, 9, C] bf16 (the HWIO weights re-laid
// by the wrapper, tap = 3 dy + dx); out: [B, H, W, F] bf16; all contiguous
// and 16-byte aligned, C and F multiples of 16. One launch.
IRN_API int irn_conv3x3(const void* x, const void* wt, void* out, int B, int H,
                        int W, int C, int F, void* stream, int* launched) {
  if (B < 1 || H < 1 || W < 1 || C < 16 || F < 16 || C % 16 || F % 16)
    return (int)cudaErrorInvalidValue;
  const Tiles tiles{(F + kTileF - 1) / kTileF, (W + kTileW - 1) / kTileW,
                    (H + kTileH - 1) / kTileH, 0};
  const long long total = (long long)tiles.f * tiles.x * tiles.y * B;
  if (total > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Tiles t = tiles;
  t.total = (int)total;

  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint64_t xstrides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                  (cuuint64_t)H * W * C * 2};
  const cuuint32_t xbox[4] = {kChunk, kHaloW, kHaloH, 1};
  const cuuint64_t wdims[3] = {(cuuint64_t)C, 9, (cuuint64_t)F};
  const cuuint64_t wstrides[2] = {(cuuint64_t)C * 2, (cuuint64_t)9 * C * 2};
  const cuuint32_t wbox[3] = {kChunk, 1, kTileF};
  if (!irn::hopper::bf16_map(&xmap, x, 4, xdims, xstrides, xbox) ||
      !irn::hopper::bf16_map(&wmap, wt, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = t.total < sm_count() ? t.total : sm_count();
  conv3x3_kernel<<<grid, kThreads, kSmemBytes,
                   static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<bf16*>(out), H, W, C, F, t);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
