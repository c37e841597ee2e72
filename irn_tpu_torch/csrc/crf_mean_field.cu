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
// Design. Combine: persistent blocks of 384 threads, one per SM, each
// walking 32 x 32 tiles (the two maps of a tile on neighbouring blocks, so
// they share the product's rows in L2) in three roles. One producer
// thread issues, per channel, a TMA load of the tile's 12-pixel q halo as
// a 60 x 56 f32 box of the [2 cap, H, W] tensor map (its zero fill is the
// zero outside the bucket; 240-byte rows keep the row pass's 16-byte
// reads conflict-free) into a ring of 4 stages paced by mbarriers (full:
// the load's bytes; empty: the row threads' arrivals); it runs ahead into
// the next tile's channels while a tile's softmax runs. Seven row warps
// each own one 8-output item of the 56 x 32 row sums: they keep their 32
// values of nr_g's halo in registers for the whole tile, form RN(nr_g q)
// as they read q from the ring (the bits of a staged product) and write
// the row sums into one of two buffers. Four column warps each give 8
// pixels (one column, 8 rows) their blurred value and keep u + mg of
// every channel in shared memory (cap x 4 KB). Row and column warps hand
// the row sums over through named barriers (full / empty per buffer), so
// each channel costs one barrier wait on each side and the row pass of
// channel c + 1 runs beside the column pass of channel c. After a tile's
// channels the row and column threads (about 3 pixels each) add the
// bilateral term from the product's row (16-byte loads issued together),
// take the softmax over the logits where they lie in shared memory (loops
// over groups of 4 channels, small code) and write q_{i+1} (consecutive
// lanes on consecutive pixels). A zero e_c (every channel past n_labels)
// would send __fdiv_rn to its slow path; quotient() gives it the signed
// zero of IEEE division instead. Shared memory: the ring 52.5 KB, the row
// sums 15.75 KB, the logits 84 KB at cap 21 (128 KB at cap 32); 150
// registers: one block of 12 warps per SM. The taps ride in the kernel's
// parameters (constant bank). Quantize: one block of 1024 threads per
// real column, two passes over its S landmarks (the max, then the
// quantized operand), the gathers from L2. Start: one thread per pixel
// and map.
//
// Measured at 512 x 512 (NVIDIA H100 80GB HBM3, 700 W): quantize +
// combine 0.1578 ms of device time per iteration against 0.1813 for the
// design before this one in the same call (tools/probe_crf_iteration.py,
// the two trees in turns); the combine alone 0.1293 ms, 150 registers, no
// spill (chip_smoke.py). The design before (two blocks of 256 threads per
// SM, the halo staged by hand from registers loaded one channel ahead, two
// barriers per channel, the softmax per pixel in registers) spent much of
// its time in the softmax, which never overlapped its channels; in this
// one the softmax, latency-bound on three pixels per thread, still runs
// after each tile's channels. Tried and dropped, slower in an experiment
// harness that is not kept: two blocks per SM over 16 x 32 tiles (the
// taller halo's row sums and TMA bytes), the softmax on separate warps
// during the next tile's channels (too few such warps fit the
// registers), two pixels' softmax side by side (more registers), L2
// prefetches of the product rows.
//
// Bound on this card: bytes. Per iteration at the 512 x 512 bucket (cap
// 21): q read and written (44.0 MB each), the product's [N, 48] output
// (50.3 MB), the labels and row norms (2.6 MB), the operand (0.8 MB): ~141
// MB, 0.042 ms at 3.35 TB/s; the blur's 25 + 25 taps are ~1.2e9 f32
// operations (0.018 ms at 67 TFLOP/s).

#include <cuda_bf16.h>

#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = irn::hopper;

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
constexpr int kMaxCap = 32;
// the combine: 32 x 32 tiles, one block of 384 threads per SM walking
// them, in three roles: a row thread per 8-output item of the 56 x 32 row
// sums, a column thread per 8 pixels (one column, 8 rows), one producer
// warp (its lane 0); the row and column threads then share the tile's
// softmax
constexpr int kCPix = kTileH * kTileW;                     // 1024
constexpr int kRowThreads = kHaloH * (kTileW / kSpan);     // 224
constexpr int kColRows = 8;
constexpr int kColThreads = kCPix / kColRows;              // 128
constexpr int kPipeThreads = kRowThreads + kColThreads;    // 352
constexpr int kCombineThreads = kPipeThreads + 32;         // 384
// the ring of q halo boxes: 60 x 56 f32 each, 128-byte aligned
constexpr int kStages = 4;
constexpr int kStageFloats = kHaloH * kXPitch;
constexpr uint32_t kStageBytes = kStageFloats * sizeof(float);  // 13,440
constexpr int kYFloats = kHaloH * kYPitch;  // one buffer of row sums
// named barriers over the row and column threads: buffer b of the row
// sums is full (kBarFull + b) or free again (kBarEmpty + b); the tile's
// logits are all written (kBarLogits); its softmax has read them
// (kBarTail)
constexpr int kBarFull = 1;
constexpr int kBarEmpty = 3;
constexpr int kBarLogits = 5;
constexpr int kBarTail = 6;
// a thread's pixels of a tile's softmax: threadIdx.x + kPipeThreads j,
// j < kTailPixels
constexpr int kTailPixels = (kCPix + kPipeThreads - 1) / kPipeThreads;  // 3
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

// the column pass for this thread's kRows pixels (column tx, tile rows
// ty0 ..): z[k] = sum_t taps[t] y[ty0 + k + t][tx]
template <int kRows>
__device__ __forceinline__ void col_pass(const float (*y)[kYPitch], int tx,
                                         int ty0, const Taps& taps,
                                         float (&z)[kRows]) {
  float v[kRows + 2 * kRadius];
#pragma unroll
  for (int i = 0; i < kRows + 2 * kRadius; ++i) v[i] = y[ty0 + i][tx];
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
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

// RN(a / b) as __fdiv_rn gives it. A zero dividend over a finite nonzero
// divisor is the signed zero of IEEE division; such lanes divide 1 instead
// and take that zero, so the never-winning channels (e = +0) skip the
// division's slow path, which a zero dividend takes, without a branch.
__device__ __forceinline__ float quotient(float a, float b) {
  const bool zero = a == 0.f && b == b && b != 0.f;
  const float q = __fdiv_rn(zero ? 1.f : a, b);
  return zero ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                               0x80000000)
              : q;
}

// One pixel's product row (map m's cp columns, 16-byte loads, as floats)
// and its RN(compat_b nr_b): loaded ahead of the softmax that needs them.
struct Bilateral {
  float4 a[kMaxCap / 4];
  float cb;
};

template <bool kInt8>
__device__ __forceinline__ void load_bilateral(
    Bilateral& r, int pix, int m, const void* __restrict__ prod, int ld,
    const float* __restrict__ nr_b, const Planes& g, float compat_b) {
  r.cb = __fmul_rn(compat_b, __ldg(nr_b + pix));
  const size_t row = (size_t)pix * ld + m * g.cp;
#pragma unroll
  for (int q = 0; q < kMaxCap / 4; ++q)
    if (4 * q < g.cap) {
      if constexpr (kInt8) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(
            static_cast<const int32_t*>(prod) + row) + q);
        r.a[q] = make_float4(__int2float_rn(v.x), __int2float_rn(v.y),
                             __int2float_rn(v.z), __int2float_rn(v.w));
      } else {
        r.a[q] = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(prod) + row) + q);
      }
    }
}

// One pixel's end of the combine: l_c = RN(l_c + mb_c) over its logits
// l_c (stride kCPix floats in shared memory) with the bilateral message
// mb_c = RN(cb RN(x_c sc_c)) (int8: sc_c = RN(qscale_c / 127^2) from s_sc)
// or RN(cb x_c), then the softmax in place -- the max, expf of the
// differences and their sum in channel order, the divisions -- q_{i+1}
// into q_out when store. Returns the first c of the largest q_c. The exp
// and division loops walk groups of 4 channels without unrolling (small
// code, nothing per channel in registers); a group's 4 exps and 4
// divisions are independent of each other.
template <bool kInt8>
__device__ __forceinline__ int finish_pixel(float* l, const Bilateral& r,
                                            const float* s_sc, int pix, int m,
                                            float* __restrict__ q_out,
                                            bool store, const Planes& g,
                                            int n) {
  float mx = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxCap / 4; ++q) {
    if (4 * q >= g.cap) break;
    const float x[4] = {r.a[q].x, r.a[q].y, r.a[q].z, r.a[q].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 4 * q + e;
      if (c < g.cap) {
        const float mb =
            __fmul_rn(r.cb, kInt8 ? __fmul_rn(x[e], s_sc[c]) : x[e]);
        const float v = __fadd_rn(l[c * kCPix], mb);
        l[c * kCPix] = v;
        mx = c == 0 ? v : fmaxf(mx, v);
      }
    }
  }
  float s = 0.f;
#pragma unroll 1
  for (int c0 = 0; c0 < g.cap; c0 += 4) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < g.cap) x[e] = expf(__fsub_rn(l[(c0 + e) * kCPix], mx));
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      if (c < g.cap) {
        l[c * kCPix] = x[e];
        s = c == 0 ? x[e] : __fadd_rn(s, x[e]);
      }
    }
  }
  int best = 0;
  float top = 0.f;
  float* dst = q_out + (size_t)m * g.cap * n + pix;
#pragma unroll 1
  for (int c0 = 0; c0 < g.cap; c0 += 4) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < g.cap) x[e] = quotient(l[(c0 + e) * kCPix], s);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      if (c < g.cap) {
        if (c == 0 || x[e] > top) {
          top = x[e];
          best = c;
        }
        if (store) dst[(size_t)c * n] = x[e];
      }
    }
  }
  return best;
}

// The combine's dynamic shared memory at cap channels: 128 bytes of
// alignment slack, the ring, two buffers of row sums, the logits, the
// ring's full and empty mbarriers, the scale table (152 KB at cap 21, 197
// KB at cap 32).
constexpr int combine_smem(int cap) {
  return 128 + kStages * (int)kStageBytes + 2 * kYFloats * (int)sizeof(float) +
         cap * kCPix * (int)sizeof(float) +
         2 * kStages * (int)sizeof(uint64_t) + kMaxCap * (int)sizeof(float);
}

// kInt8: the product is int32 with per-column qscale, else f32. q arrives
// as qmap, a tensor map over [2 cap, H, W] with 60 x 40 x 1 boxes. Tile t
// of the 2 x tiles_y x tiles_x tiles is map t % 2's tile t / 2 (row-major);
// block i walks the tiles i, i + gridDim.x, ...
template <bool kInt8>
__global__ void __launch_bounds__(kCombineThreads, 1)
    combine_kernel(const __grid_constant__ CUtensorMap qmap,
                   const float* __restrict__ nr_g,
                   const float* __restrict__ nr_b,
                   const uint8_t* __restrict__ labels,
                   const void* __restrict__ prod, int ld,
                   const float* __restrict__ qscale, float* __restrict__ q_out,
                   uint8_t* __restrict__ lab_out, Planes g, float compat_g,
                   float compat_b, Taps taps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  float* s_y = ring + kStages * kStageFloats;
  float* s_l = s_y + 2 * kYFloats;  // [cap][kCPix]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_l + g.cap * kCPix);
  uint64_t* empty = full + kStages;
  float* s_sc = reinterpret_cast<float*>(empty + kStages);  // [kMaxCap]
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kRowThreads);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  const int tiles_x = (g.w + kTileW - 1) / kTileW;
  const int n_tiles = 2 * tiles_x * ((g.h + kTileH - 1) / kTileH);
  const int n = g.h * g.w;
  // the channels this block walks over all its tiles: the row sums' k-th
  // buffer use is channel k's, k counted across tiles
  const int n_ch = ((n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1) *
                   g.cap;

  // a row thread's channels of one tile: nr_g's halo values of its item
  // (r, j0) in registers, per channel RN(nr_g q) formed as q is read from
  // the ring, the 8 row sums into the k-th buffer
  auto row_tile = [&](int x0, int y0, int& k) {
    const int r = threadIdx.x / (kTileW / kSpan);
    const int j0 = (threadIdx.x - r * (kTileW / kSpan)) * kSpan;
    const int gy = y0 - kRadius + r;
    const bool row_in = gy >= 0 && gy < g.h;
    float nrg[kSpan + 2 * kRadius];
#pragma unroll
    for (int i = 0; i < kSpan + 2 * kRadius; ++i) {
      const int gx = x0 - kRadius + j0 + i;
      nrg[i] = row_in && gx >= 0 && gx < g.w
                   ? __ldg(nr_g + (size_t)gy * g.w + gx)
                   : 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < g.cap; ++c, ++k) {
      const int s = k % kStages;
      const int b = k & 1;
      hp::mbar_wait(&full[s], (uint32_t)(k / kStages) & 1);
      if (k >= 2) hp::named_sync(kBarEmpty + b, kPipeThreads);
      float v[kSpan + 2 * kRadius];
      const float4* src = reinterpret_cast<const float4*>(
          ring + s * kStageFloats + r * kXPitch + j0);
#pragma unroll
      for (int i = 0; i < (kSpan + 2 * kRadius) / 4; ++i) {
        const float4 f = src[i];
        v[4 * i] = __fmul_rn(nrg[4 * i], f.x);
        v[4 * i + 1] = __fmul_rn(nrg[4 * i + 1], f.y);
        v[4 * i + 2] = __fmul_rn(nrg[4 * i + 2], f.z);
        v[4 * i + 3] = __fmul_rn(nrg[4 * i + 3], f.w);
      }
      // the stage's reads are done: release it to the producer
      hp::fence_proxy_async();
      hp::mbar_arrive(&empty[s]);
      float acc[kSpan];
#pragma unroll
      for (int i = 0; i < kSpan; ++i) acc[i] = 0.f;
#pragma unroll
      for (int tap = 0; tap < kTaps; ++tap)
#pragma unroll
        for (int i = 0; i < kSpan; ++i)
          acc[i] = __fmaf_rn(taps.t[tap], v[i + tap], acc[i]);
      float4* dst =
          reinterpret_cast<float4*>(s_y + b * kYFloats + r * kYPitch + j0);
#pragma unroll
      for (int i = 0; i < kSpan / 4; ++i)
        dst[i] = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2],
                             acc[4 * i + 3]);
      hp::named_arrive(kBarFull + b, kPipeThreads);
    }
  };

  // a column thread's channels of one tile: pixels (ty0 + i, tx), i <
  // kColRows; per channel u + mg into the logits
  auto col_tile = [&](int m, int x0, int y0, int& k) {
    const int tc = threadIdx.x - kRowThreads;
    const int tx = tc % kTileW;
    const int ty0 = tc / kTileW * kColRows;
    const int xx = x0 + tx;
    int lab[kColRows];
    float cg[kColRows];
#pragma unroll
    for (int i = 0; i < kColRows; ++i) {
      const int y = y0 + ty0 + i;
      const bool inside = y < g.h && xx < g.w;
      const int pix = inside ? y * g.w + xx : 0;
      lab[i] = inside ? labels[(size_t)m * n + pix] : 0;
      cg[i] = __fmul_rn(compat_g, inside ? __ldg(nr_g + pix) : 0.f);
    }
#pragma unroll 1
    for (int c = 0; c < g.cap; ++c, ++k) {
      const int b = k & 1;
      hp::named_sync(kBarFull + b, kPipeThreads);
      float z[kColRows];
      col_pass(reinterpret_cast<const float(*)[kYPitch]>(s_y + b * kYFloats),
               tx, ty0, taps, z);
      if (k + 2 < n_ch) hp::named_arrive(kBarEmpty + b, kPipeThreads);
#pragma unroll
      for (int i = 0; i < kColRows; ++i)
        s_l[c * kCPix + (ty0 + i) * kTileW + tx] =
            __fadd_rn(unary(c, lab[i], g), __fmul_rn(cg[i], z[i]));
    }
  };

  if (threadIdx.x < kPipeThreads) {
    const bool row_thread = threadIdx.x < kRowThreads;
    int k = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m = t & 1;
      const int sp = t >> 1;
      const int y0 = sp / tiles_x * kTileH;
      const int x0 = (sp - sp / tiles_x * tiles_x) * kTileW;
      // the int8 product's column scales RN(qscale / 127^2) of map m,
      // read by the softmax after the logits barrier
      if (kInt8 && threadIdx.x < g.cap)
        s_sc[threadIdx.x] =
            __fmul_rn(qscale[m * g.cp + threadIdx.x], kInv127Sq);
      if (row_thread)
        row_tile(x0, y0, k);
      else
        col_tile(m, x0, y0, k);
      hp::named_sync(kBarLogits, kPipeThreads);
      // per pixel, spread over the row and column threads (the producer
      // meanwhile loads the next tile's first channels): the bilateral
      // message and the softmax over the logits where they lie
#pragma unroll 1
      for (int j = 0; j < kTailPixels; ++j) {
        const int pi = threadIdx.x + kPipeThreads * j;
        const int y = y0 + pi / kTileW;
        const int xx = x0 + pi % kTileW;
        if (pi >= kCPix || y >= g.h || xx >= g.w) continue;
        const int pix = y * g.w + xx;
        Bilateral r;
        load_bilateral<kInt8>(r, pix, m, prod, ld, nr_b, g, compat_b);
        const int best = finish_pixel<kInt8>(s_l + pi, r, s_sc, pix, m,
                                             q_out, lab_out == nullptr, g, n);
        if (lab_out != nullptr) lab_out[(size_t)m * n + pix] = (uint8_t)best;
      }
      // the logits and scales are read: the next tile may write them
      hp::named_sync(kBarTail, kPipeThreads);
    }
  } else if (threadIdx.x == kPipeThreads) {
    // producer: per channel the q halo box into the next free stage
    int k = 0;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
      const int m = t & 1;
      const int sp = t >> 1;
      const int y0 = sp / tiles_x * kTileH;
      const int x0 = (sp - sp / tiles_x * tiles_x) * kTileW;
#pragma unroll 1
      for (int c = 0; c < g.cap; ++c, ++k) {
        const int s = k % kStages;
        if (k >= kStages)
          hp::mbar_wait(&empty[s], (uint32_t)(k / kStages - 1) & 1);
        hp::mbar_expect_tx(&full[s], kStageBytes);
        hp::tma_load_3d(ring + s * kStageFloats, &qmap, &full[s],
                        x0 - kRadius, y0 - kRadius, m * g.cap + c);
      }
    }
  }
}

// per device, whether combine_kernel<false / true> may take combine_smem(
// kMaxCap) bytes of shared memory
std::atomic<unsigned long long> combine_smem_set[2];

template <bool kInt8>
int launch_combine(const float* q, const float* nr_g, const float* nr_b,
                   const uint8_t* labels, const void* prod, int ld,
                   const float* qscale, float* q_out, uint8_t* lab_out,
                   const Planes& g, float compat_g, float compat_b,
                   const Taps& taps, cudaStream_t stream) {
  CUtensorMap qmap;
  const cuuint64_t dims[3] = {(cuuint64_t)g.w, (cuuint64_t)g.h,
                              (cuuint64_t)(2 * g.cap)};
  const cuuint64_t strides[2] = {(cuuint64_t)g.w * sizeof(float),
                                 (cuuint64_t)g.h * g.w * sizeof(float)};
  const cuuint32_t box[3] = {kXPitch, kHaloH, 1};
  if (!hp::f32_map(&qmap, q, 3, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = irn::allow_smem(combine_kernel<kInt8>,
                                  combine_smem_set[kInt8],
                                  combine_smem(kMaxCap));
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = 2 * ((g.w + kTileW - 1) / kTileW) *
                      ((g.h + kTileH - 1) / kTileH);
  combine_kernel<kInt8>
      <<<min(n_tiles, sms), kCombineThreads,
         combine_smem(g.cap), stream>>>(qmap, nr_g, nr_b, labels, prod, ld,
                                        qscale, q_out, lab_out, g, compat_g,
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
// when it is not null; q 16-byte aligned and w a multiple of 4 (its TMA
// tensor map); prod [N, ld] int32 (int8 != 0, with qscale) or f32
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
