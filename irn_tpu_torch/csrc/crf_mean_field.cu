// K17 crf_mean_field: the device CRF's mean-field iterations outside the
// [N, S] @ [S, M] landmark product, two launches per iteration (quantize
// before the product, combine after it), one at the start (the first
// softmax) and one per kernel build (the Gaussian's row norms).
//
// Replaces: irn_tpu/ops/crf_tpu.py crf_pair_program's unrolled mean field
// (:258-299: the first softmax, the loop :259-295, the argmax :299), with
// the separable blur _sep_gauss (:53) over the Toeplitz factors of
// _toeplitz (:42): one XLA program on the TPU. Eager PyTorch ran each
// iteration as two f32 batched GEMMs against [H, H] / [W, W] Toeplitz
// factors (25 nonzero taps per row) and ~23 elementwise launches over
// [2, 21, H, W] f32 planes (a pad and a column-major copy of the operand,
// the transposed dequantize, the softmax).
//
// The planes: q [2, cap, H, W] f32 (two label maps' cap channels over the
// [H, W] bucket, N = H W), the row norms nr_g, nr_b [H, W] f32 (zero
// outside the true extent), the label maps [2, H, W] uint8, the landmark
// j = the pixel (off + s (j / lw), off + s (j % lw)), off = s / 2. The
// product's operand and output put map m's channel c in column m cp + c,
// cp = cap rounded up to a multiple of 4 (M = 2 cp columns, a multiple of
// 8 as torch._int_mm wants; the padding columns stay zero), so each map's
// columns start on 16 bytes.
//
// All in f32 with round to nearest, every product and sum written with
// __fmul_rn / __fadd_rn / __fmaf_rn / __fdiv_rn in the order of the twins
// in ops/crf_device.py (nothing is left to contraction):
//
//   blur(x)[i, j]: the row pass y[i, j] = sum_t taps[t] x[i, j + t - r],
//         then the column pass sum_t taps[t] y[i + t - r, j], each sum from
//         +0 over t = 0 .. 24 in order, acc = fma(tap, x, acc) rounded once,
//         zero outside the bucket (taps: 2r + 1 <= 25, zero-padded to 25 at
//         both ends: fma(0, x, acc) = acc, the same bits)
//   start: l_c = u_c, the unary: -1e30 for c >= n_labels, else lg where
//         the label is c, lo elsewhere (lg = log gt, lo = log p_other)
//   quantize, per column (m, c): a_j = RN(nr_b q) at landmark j;
//         int8: qscale = max(max_j a_j, 1e-20), q8_j = rint(RN(a_j
//         RN(127 / qscale))) into a [M, S'] int8 buffer (the product's
//         [S', M] column-major operand; rows S .. S' stay zero), qscale to
//         qscale[col]; bf16 / f32: RN(a_j) into an [S, M] row-major operand
//   combine: mg = RN(RN(compat_g nr_g) blur(RN(nr_g q))), mb =
//         RN(RN(compat_b nr_b) RN(float(acc) RN(qscale (1/127^2)))) (int8)
//         or RN(RN(compat_b nr_b) acc) (f32 product), l_c = RN(RN(u_c +
//         mg) + mb)
//   softmax: m = max_c l_c, e_c = expf(RN(l_c - m)), s = e_0 + e_1 + ...
//         in order, q_c = RN(e_c / s); on the last iteration the first c
//         of the largest q_c as uint8 in place of q
//
// Design. Combine: one block of 256 threads per 32 x 32 tile of one map,
// two blocks per SM. Each thread stages one column of the tile's 12-pixel
// halo (56 x 56), every fourth row, and keeps nr_g there in registers; per
// channel (a loop that is not unrolled, so its code stays in the
// instruction cache) it stores RN(nr_g q) in shared memory from values it
// loaded one channel ahead (the loads of channel c + 1 are in flight
// during channel c's passes), a row pass writes the 56 x 32 row sums (8
// outputs per item from 32 values read as 16-byte words; row pitches
// padded so that a quarter-warp's two rows fall on distinct banks), and a
// column pass gives each thread the blurred value of its 4 pixels (one
// column, 4 rows; 28 values): the [H, W] factors never exist and each q
// plane is read from device memory about once (the halo rereads hit L2).
// u + mg of every channel waits in shared memory (cap x 4 KB); then per
// pixel the thread adds the bilateral term from the product's row, read
// in place by 16-byte loads issued together, takes the softmax over cap
// <= 32 logits in registers and writes q_{i+1} (consecutive lanes on
// consecutive pixels) into a second buffer. The taps ride in the kernel's
// parameters (constant bank). Quantize: one block of 1024 threads per real
// column, two passes over its S landmarks (the max, then the quantized
// operand), the gathers from L2. Start: one thread per pixel and map.
//
// Measured at 512 x 512 (H100 80GB HBM3, 700 W; chip_smoke.py): combine
// ~0.16 ms, quantize ~0.013 ms of device time, against the product's 1.50
// ms. The first design, which unrolled the channel loop to keep every
// logit in registers, took 0.62 ms for the combine; the combine is still
// ~4x its byte bound, latency-bound (two barriers per channel, 16 warps
// per SM), not issue-bound (~0.05 ms of issue).
//
// Bound on this card: bytes. Per iteration at the 512 x 512 bucket (cap
// 21): q read and written (44.0 MB each), the product's [N, 48] output
// (50.3 MB), the labels and row norms (2.6 MB), the operand (0.8 MB): ~141
// MB, 0.042 ms at 3.35 TB/s; the blur's 25 + 25 taps are ~1.2e9 f32
// operations (0.018 ms at 67 TFLOP/s).

#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kRadius = 12;  // ceil(4 sxy) at the Gaussian's sxy 3
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileH = 32;
constexpr int kTileW = 32;
constexpr int kHaloH = kTileH + 2 * kRadius;  // 56
constexpr int kHaloW = kTileW + 2 * kRadius;  // 56
// shared row pitches (floats): a quarter-warp's 16-byte accesses to two
// consecutive rows fall on distinct banks
constexpr int kXPitch = kHaloW + 4;
constexpr int kYPitch = kTileW + 4;
constexpr int kThreads = 256;
constexpr int kPixRows = kTileH * kTileW / kThreads;  // 4 pixels per thread
constexpr int kSpan = 8;  // row-pass outputs per item
// the combine's staging: a thread per halo column c < kHaloW (of 64), its
// rows r0, r0 + 4, ...
constexpr int kStageCols = 64;
constexpr int kStageStep = kThreads / kStageCols;  // 4
constexpr int kStage = kHaloH / kStageStep;        // 14 rows per thread
constexpr int kMaxCap = 32;
constexpr int kCombineBlocks = 2;  // per SM: at most 128 registers
constexpr int kQuantThreads = 1024;
constexpr int kStartThreads = 256;
constexpr float kInv127Sq = 0x1.040c2p-14f;  // f32(1 / 127^2)
constexpr float kMinScale = 0x1.79ca1p-67f;  // f32(1e-20)
constexpr float kNeverLogit = -0x1.93e594p+99f;  // f32(-1e30)

struct Taps {
  float t[kTaps];
};

struct Planes {
  int h, w, cap, cp, n_labels;
  float lg, lo;
};

dim3 tiles(int h, int w, int z) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, z);
}

__device__ __forceinline__ float unary(int c, int lab, const Planes& g) {
  return c >= g.n_labels ? kNeverLogit : (c == lab ? g.lg : g.lo);
}

// softmax of l[0 .. cap) in place: max, expf of the differences, their
// sum in channel order, divisions; returns the first c of the largest
// q_c
__device__ __forceinline__ int softmax(float (&l)[kMaxCap], int cap) {
  float m = l[0];
#pragma unroll
  for (int c = 1; c < kMaxCap; ++c)
    if (c < cap) m = fmaxf(m, l[c]);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCap; ++c)
    if (c < cap) {
      l[c] = expf(__fsub_rn(l[c], m));
      s = c == 0 ? l[0] : __fadd_rn(s, l[c]);
    }
  int best = 0;
  float top = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxCap; ++c)
    if (c < cap) {
      l[c] = __fdiv_rn(l[c], s);
      if (c == 0 || l[c] > top) {
        top = l[c];
        best = c;
      }
    }
  return best;
}

// x over the halo tile at (y0, x0), zero outside the bucket
__device__ __forceinline__ void stage(float (*dst)[kXPitch],
                                      const float* __restrict__ x, int y0,
                                      int x0, int h, int w) {
  for (int i = threadIdx.x; i < kHaloH * kHaloW; i += kThreads) {
    const int r = i / kHaloW;
    const int c = i - r * kHaloW;
    const int y = y0 - kRadius + r;
    const int xx = x0 - kRadius + c;
    dst[r][c] = y >= 0 && y < h && xx >= 0 && xx < w
                    ? __ldg(x + (size_t)y * w + xx)
                    : 0.f;
  }
}

// the row pass over the halo tile: y[r][j] = sum_t taps[t] x[r][j + t],
// kSpan outputs per item from kSpan + 24 values read as 16-byte words
__device__ __forceinline__ void row_pass(const float (*x)[kXPitch],
                                         float (*y)[kYPitch],
                                         const Taps& taps) {
  constexpr int kItems = kHaloH * (kTileW / kSpan);
  for (int item = threadIdx.x; item < kItems; item += kThreads) {
    const int r = item / (kTileW / kSpan);
    const int j0 = (item - r * (kTileW / kSpan)) * kSpan;
    float v[kSpan + 2 * kRadius];
    const float4* src = reinterpret_cast<const float4*>(&x[r][j0]);
#pragma unroll
    for (int i = 0; i < (kSpan + 2 * kRadius) / 4; ++i) {
      const float4 f = src[i];
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
    float acc[kSpan];
#pragma unroll
    for (int k = 0; k < kSpan; ++k) acc[k] = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
#pragma unroll
      for (int k = 0; k < kSpan; ++k)
        acc[k] = __fmaf_rn(taps.t[t], v[k + t], acc[k]);
    float4* dst = reinterpret_cast<float4*>(&y[r][j0]);
#pragma unroll
    for (int i = 0; i < kSpan / 4; ++i)
      dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                           acc[4 * i + 3]);
  }
}

// the column pass for this thread's kPixRows pixels (column tx, tile rows
// ty0 ..): z[k] = sum_t taps[t] y[ty0 + k + t][tx]
__device__ __forceinline__ void col_pass(const float (*y)[kYPitch], int tx,
                                         int ty0, const Taps& taps,
                                         float (&z)[kPixRows]) {
  float v[kPixRows + 2 * kRadius];
#pragma unroll
  for (int i = 0; i < kPixRows + 2 * kRadius; ++i) v[i] = y[ty0 + i][tx];
#pragma unroll
  for (int k = 0; k < kPixRows; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t)
      acc = __fmaf_rn(taps.t[t], v[k + t], acc);
    z[k] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
    blur_kernel(const float* __restrict__ x, float* __restrict__ out, int h,
                int w, Taps taps) {
  __shared__ __align__(16) float s_x[kHaloH][kXPitch];
  __shared__ __align__(16) float s_y[kHaloH][kYPitch];
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t n = (size_t)h * w;
  stage(s_x, x + blockIdx.z * n, y0, x0, h, w);
  __syncthreads();
  row_pass(s_x, s_y, taps);
  __syncthreads();
  const int tx = threadIdx.x % kTileW;
  const int ty0 = threadIdx.x / kTileW * kPixRows;
  float z[kPixRows];
  col_pass(s_y, tx, ty0, taps, z);
#pragma unroll
  for (int k = 0; k < kPixRows; ++k) {
    const int y = y0 + ty0 + k;
    const int xx = x0 + tx;
    if (y < h && xx < w) out[blockIdx.z * n + (size_t)y * w + xx] = z[k];
  }
}

__global__ void __launch_bounds__(kStartThreads)
    start_kernel(const uint8_t* __restrict__ labels, float* __restrict__ q,
                 uint8_t* __restrict__ lab_out, Planes g) {
  const size_t n = (size_t)g.h * g.w;
  const size_t i = (size_t)blockIdx.x * kStartThreads + threadIdx.x;
  if (i >= 2 * n) return;
  const int lab = labels[i];
  float l[kMaxCap];
#pragma unroll
  for (int c = 0; c < kMaxCap; ++c) l[c] = unary(c, lab, g);
  const int best = softmax(l, g.cap);
  if (lab_out != nullptr) {
    lab_out[i] = (uint8_t)best;
    return;
  }
  const size_t m = i / n;
  float* dst = q + m * g.cap * n + (i - m * n);
#pragma unroll
  for (int c = 0; c < kMaxCap; ++c)
    if (c < g.cap) dst[c * n] = l[c];
}

// kStore: 1 int8 (the [M, s_rows] buffer of the column-major operand), 2
// bf16, 4 f32 ([S, M] row-major)
template <int kStore>
__global__ void __launch_bounds__(kQuantThreads)
    quantize_kernel(const float* __restrict__ q, const float* __restrict__ nr_b,
                    void* __restrict__ opnd, float* __restrict__ qscale,
                    Planes g, int stride, int lw, int n_land, int s_rows) {
  __shared__ float s_max[kQuantThreads / 32];
  const size_t n = (size_t)g.h * g.w;
  const int b = blockIdx.x;  // (m, c) = (b / cap, b % cap)
  const int m = b / g.cap;
  const int col = m * g.cp + (b - m * g.cap);
  const float* qc = q + (size_t)b * n;
  const int off = stride / 2;
  auto act = [&](int j) {
    const int jy = j / lw;
    const size_t p =
        (size_t)(off + stride * jy) * g.w + off + stride * (j - jy * lw);
    return __fmul_rn(__ldg(nr_b + p), __ldg(qc + p));
  };
  if constexpr (kStore == 1) {
    float v = 0.f;  // every activation is >= +0
#pragma unroll 4
    for (int j = threadIdx.x; j < n_land; j += kQuantThreads)
      v = fmaxf(v, act(j));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = v;
    __syncthreads();
    v = s_max[0];
#pragma unroll
    for (int i = 1; i < kQuantThreads / 32; ++i) v = fmaxf(v, s_max[i]);
    const float scale = fmaxf(v, kMinScale);
    if (threadIdx.x == 0) qscale[col] = scale;
    const float r = __fdiv_rn(127.f, scale);
    int8_t* dst = static_cast<int8_t*>(opnd) + (size_t)col * s_rows;
#pragma unroll 4
    for (int j = threadIdx.x; j < n_land; j += kQuantThreads)
      dst[j] = (int8_t)__float2int_rn(__fmul_rn(act(j), r));
  } else {
    const int ld = 2 * g.cp;
#pragma unroll 4
    for (int j = threadIdx.x; j < n_land; j += kQuantThreads) {
      const float a = act(j);
      if constexpr (kStore == 2)
        static_cast<__nv_bfloat16*>(opnd)[(size_t)j * ld + col] =
            __float2bfloat16_rn(a);
      else
        static_cast<float*>(opnd)[(size_t)j * ld + col] = a;
    }
  }
}

// kInt8: the product is int32 with per-column qscale, else f32. Dynamic
// shared memory: the tile's logits, cap x kTileH x kTileW f32.
template <bool kInt8>
__global__ void __launch_bounds__(kThreads, kCombineBlocks)
    combine_kernel(const float* __restrict__ q, const float* __restrict__ nr_g,
                   const float* __restrict__ nr_b,
                   const uint8_t* __restrict__ labels,
                   const void* __restrict__ prod, int ld,
                   const float* __restrict__ qscale, float* __restrict__ q_out,
                   uint8_t* __restrict__ lab_out, Planes g, float compat_g,
                   float compat_b, Taps taps) {
  extern __shared__ float s_l[];  // [cap][kTileH * kTileW]
  __shared__ __align__(16) float s_x[kHaloH][kXPitch];
  __shared__ __align__(16) float s_y[kHaloH][kYPitch];
  __shared__ float s_sc[kMaxCap];
  const int m = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t n = (size_t)g.h * g.w;
  const int tx = threadIdx.x % kTileW;
  const int ty0 = threadIdx.x / kTileW * kPixRows;
  if (kInt8 && threadIdx.x < g.cap)
    s_sc[threadIdx.x] =
        __fmul_rn(qscale[m * g.cp + threadIdx.x], kInv127Sq);

  // this thread's halo elements: column sc, rows sr0 + kStageStep i; the
  // pixel of the first, and nr_g at each (0 outside the bucket)
  const int sc = threadIdx.x % kStageCols;
  const int sr0 = threadIdx.x / kStageCols;
  const int sx = x0 - kRadius + sc;
  const bool scol = sc < kHaloW && sx >= 0 && sx < g.w;
  const int src0 = (y0 - kRadius + sr0) * g.w + sx;
  unsigned in_rows = 0;
  float nrg[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i) {
    const int y = y0 - kRadius + sr0 + kStageStep * i;
    const bool in = scol && y >= 0 && y < g.h;
    in_rows |= (unsigned)in << i;
    nrg[i] = in ? __ldg(nr_g + src0 + kStageStep * i * g.w) : 0.f;
  }
  size_t pix[kPixRows];
  bool inside[kPixRows];
  int lab[kPixRows];
  float cg[kPixRows];
#pragma unroll
  for (int k = 0; k < kPixRows; ++k) {
    const int y = y0 + ty0 + k;
    const int xx = x0 + tx;
    inside[k] = y < g.h && xx < g.w;
    pix[k] = inside[k] ? (size_t)y * g.w + xx : 0;
    lab[k] = inside[k] ? labels[m * n + pix[k]] : 0;
    cg[k] = __fmul_rn(compat_g, inside[k] ? __ldg(nr_g + pix[k]) : 0.f);
  }

  // per channel: stage RN(nr_g q) from the values loaded one channel
  // ahead, blur, keep u + mg in shared memory
  const float* qm = q + (size_t)m * g.cap * n;
  float pre[kStage];
#pragma unroll
  for (int i = 0; i < kStage; ++i)
    pre[i] = in_rows >> i & 1 ? __ldg(qm + src0 + kStageStep * i * g.w)
                              : 0.f;
#pragma unroll 1
  for (int c = 0; c < g.cap; ++c) {
    if (sc < kHaloW) {
#pragma unroll
      for (int i = 0; i < kStage; ++i)
        s_x[sr0 + kStageStep * i][sc] = __fmul_rn(nrg[i], pre[i]);
    }
    __syncthreads();
    if (c + 1 < g.cap) {
      const float* qc = qm + (size_t)(c + 1) * n;
#pragma unroll
      for (int i = 0; i < kStage; ++i)
        pre[i] = in_rows >> i & 1 ? __ldg(qc + src0 + kStageStep * i * g.w)
                                  : 0.f;
    }
    row_pass(s_x, s_y, taps);
    __syncthreads();
    float z[kPixRows];
    col_pass(s_y, tx, ty0, taps, z);
#pragma unroll
    for (int k = 0; k < kPixRows; ++k)
      s_l[c * (kTileH * kTileW) + (ty0 + k) * kTileW + tx] =
          __fadd_rn(unary(c, lab[k], g), __fmul_rn(cg[k], z[k]));
  }

  // per pixel: the bilateral message from the product's row (16 bytes at
  // a time, the row's loads in flight together), the softmax, the output
#pragma unroll
  for (int k = 0; k < kPixRows; ++k) {
    if (!inside[k]) continue;
    float l[kMaxCap];
#pragma unroll
    for (int c = 0; c < kMaxCap; ++c)
      if (c < g.cap)
        l[c] = s_l[c * (kTileH * kTileW) + (ty0 + k) * kTileW + tx];
    const float cb = __fmul_rn(compat_b, __ldg(nr_b + pix[k]));
    const size_t row = pix[k] * ld + m * g.cp;
#pragma unroll
    for (int c4 = 0; c4 < kMaxCap / 4; ++c4) {
      if (4 * c4 >= g.cap) continue;
      float acc[4];
      if constexpr (kInt8) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(
            static_cast<const int32_t*>(prod) + row) + c4);
        acc[0] = __fmul_rn(__int2float_rn(a.x), s_sc[4 * c4]);
        acc[1] = __fmul_rn(__int2float_rn(a.y), s_sc[4 * c4 + 1]);
        acc[2] = __fmul_rn(__int2float_rn(a.z), s_sc[4 * c4 + 2]);
        acc[3] = __fmul_rn(__int2float_rn(a.w), s_sc[4 * c4 + 3]);
      } else {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(prod) + row) + c4);
        acc[0] = a.x;
        acc[1] = a.y;
        acc[2] = a.z;
        acc[3] = a.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (4 * c4 + i < g.cap)
          l[4 * c4 + i] = __fadd_rn(l[4 * c4 + i], __fmul_rn(cb, acc[i]));
    }
    const int best = softmax(l, g.cap);
    if (lab_out != nullptr) {
      lab_out[m * n + pix[k]] = (uint8_t)best;
      continue;
    }
    float* dst = q_out + (size_t)m * g.cap * n + pix[k];
#pragma unroll
    for (int c = 0; c < kMaxCap; ++c)
      if (c < g.cap) dst[c * n] = l[c];
  }
}

template <bool kInt8>
int launch_combine(const float* q, const float* nr_g, const float* nr_b,
                   const uint8_t* labels, const void* prod, int ld,
                   const float* qscale, float* q_out, uint8_t* lab_out,
                   const Planes& g, float compat_g, float compat_b,
                   const Taps& taps, cudaStream_t stream) {
  const int smem = g.cap * kTileH * kTileW * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      combine_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  combine_kernel<kInt8><<<tiles(g.h, g.w, 2), kThreads, smem, stream>>>(
      q, nr_g, nr_b, labels, prod, ld, qscale, q_out, lab_out, g, compat_g,
      compat_b, taps);
  return 0;
}

Taps load_taps(const float* host) {
  Taps t;
  for (int i = 0; i < kTaps; ++i) t.t[i] = host[i];
  return t;
}

}  // namespace

// blur of c planes x [c, h, w] into out (1 launch); taps_host: kTaps f32
// in host memory
IRN_API int irn_crf_blur(const float* x, float* out, int c, int h, int w,
                         const float* taps_host, cudaStream_t stream,
                         int* launched) {
  blur_kernel<<<tiles(h, w, c), kThreads, 0, stream>>>(x, out, h, w,
                                                       load_taps(taps_host));
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// the first softmax of the unary into q [2, cap, h, w], or its argmax
// into lab_out [2, h, w] when lab_out is not null (1 launch)
IRN_API int irn_crf_start(const uint8_t* labels, float* q, uint8_t* lab_out,
                          int h, int w, int cap, int n_labels, float lg,
                          float lo, cudaStream_t stream, int* launched) {
  const Planes g{h, w, cap, 0, n_labels, lg, lo};
  const size_t pixels = 2 * (size_t)h * w;
  start_kernel<<<(unsigned)((pixels + kStartThreads - 1) / kStartThreads),
                 kStartThreads, 0, stream>>>(labels, q, lab_out, g);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// the product's operand from q (1 launch): store 1 int8 (the [2 cp,
// s_rows] buffer, and qscale [2 cp]), 2 bf16 or 4 f32 ([n_land, 2 cp])
IRN_API int irn_crf_quantize(const float* q, const float* nr_b, void* opnd,
                             float* qscale, int h, int w, int cap, int cp,
                             int stride, int lw, int n_land, int s_rows,
                             int store, cudaStream_t stream, int* launched) {
  const Planes g{h, w, cap, cp, 0, 0.f, 0.f};
  const dim3 grid(2 * cap);
  if (store == 1)
    quantize_kernel<1><<<grid, kQuantThreads, 0, stream>>>(
        q, nr_b, opnd, qscale, g, stride, lw, n_land, s_rows);
  else if (store == 2)
    quantize_kernel<2><<<grid, kQuantThreads, 0, stream>>>(
        q, nr_b, opnd, qscale, g, stride, lw, n_land, s_rows);
  else
    quantize_kernel<4><<<grid, kQuantThreads, 0, stream>>>(
        q, nr_b, opnd, qscale, g, stride, lw, n_land, s_rows);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// one combine (1 launch): q_{i+1} into q_out, or the labels into lab_out
// when it is not null; prod [N, ld] int32 (int8 != 0, with qscale) or f32
IRN_API int irn_crf_mean_field(const float* q, const float* nr_g,
                               const float* nr_b, const uint8_t* labels,
                               const void* prod, int ld, const float* qscale,
                               float* q_out, uint8_t* lab_out,
                               const float* taps_host, int h, int w, int cap,
                               int cp, int n_labels, int int8, float lg,
                               float lo, float compat_g, float compat_b,
                               cudaStream_t stream, int* launched) {
  const Planes g{h, w, cap, cp, n_labels, lg, lo};
  const Taps taps = load_taps(taps_host);
  const int e =
      int8 ? launch_combine<true>(q, nr_g, nr_b, labels, prod, ld, qscale,
                                  q_out, lab_out, g, compat_g, compat_b, taps,
                                  stream)
           : launch_combine<false>(q, nr_g, nr_b, labels, prod, ld, qscale,
                                   q_out, lab_out, g, compat_g, compat_b,
                                   taps, stream);
  if (e != 0) return e;
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
