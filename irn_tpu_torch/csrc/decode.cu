// K15 decode: the walk's x4 upsample of the propagated scores, their global
// max, and the background-threshold argmax, in one cooperative launch and
// no other device operation.
//
// Replaces: irn_tpu/ops/random_walk.py upsample_scores and
// upsample_and_decode (an XLA program on the TPU: two bilinear resizes, the
// mask-normalized quotient, the max, the threshold plane and the argmax),
// which eager PyTorch runs as some 20 launches over [C, 4ch, 4cw] tensors.
//
// The values: each output pixel (oy, ox) of the [4ch, 4cw] grid takes, per
// score row, the half-pixel x4 bilinear (align_corners=False: source (o +
// 0.5) * 0.25 - 0.5 clamped at 0, the upper neighbour clamped to size - 1)
// of rw * m4 over the same bilinear of m4 (m4: 1 inside the (h4, w4) cells)
// where the latter exceeds 1e-6, else 0, times the pixel mask (h0, w0): the
// values of random_walk.upsample_scores_plain. The decode divides them by
// max(global max, 1e-12) and takes the argmax over [bg_thres, s_0 .. s_{C-1}]
// with torch.argmax's rule (the first maximum wins, NaN counts as the
// largest): the background plane wins a tie at bg_thres. Labels are 0
// outside (h0, w0), written as int64 or int32 (the caller's dtype).
// Optional outputs: the normalized scores [C, 4ch, 4cw] and ``best``, the
// max over rows of the normalized scores (the instance walk's winning
// score).
//
// Design: one cooperative launch of persistent CTAs (at most what the card
// holds at once, the occupancy API's count, cached per device), each thread
// owning the pixels gid, gid + T, ... (T threads in all; coalesced rows).
//  Phase 1: each pixel's C values; the thread's max through an
// order-preserving unsigned key (negatives included), a warp and CTA
// reduction, one atomicMax per CTA into a global key. A max is the same in
// any order.
//  Grid barrier (hopper.cuh); then every CTA reads the key.
//  Phase 2: normalize, take the argmax and write the outputs.
//  At C <= 16 the values stay in registers across the barrier: the kernel
// is instantiated for up to 8 rows and 1 or 2 pixels per thread and up to
// 16 rows and 2, fewer values per thread allowing more resident threads
// (8 values: 1536 per SM, 42 registers; make_sem_seg's 96 x 128 bucket at
// C 8 then takes one pixel per thread), in CTAs of 512 threads (half the
// arrivals at the barrier of 256-thread CTAs), and the launch takes the
// first whose resident CTAs give every pixel a slot. At C 8 on the card
// (tools/probe_walk_variants.py): 11.5 us, 12.5 with 256-thread CTAs,
// 17.2 with the values recomputed. Above 16 rows (the
// instance walk's C up to 128: 128 values per pixel fit neither a
// thread's registers nor, for a CTA's pixels, its shared memory), or when
// the grid is too large for those slots, phase 2 recomputes the values
// from the same inputs with the same code, the same bits: 6 CTAs per SM,
// the rows' loop unrolled by 4 so that 16 taps are in flight.
//  A pixel whose four taps lie inside the (h4, w4) cells has a mask
// bilinear of exactly 1 (the weights are multiples of 1/8 that sum to 1),
// and num / 1 is num in IEEE arithmetic: the division is skipped there.
//  The barrier counter, an exit counter and the key live in a scratch
// buffer that the caller zeroes once: the last CTA out sets all three back
// to 0, so the next launch on the stream finds them zeroed and no memset
// is needed.
//
// Bit-equality: every product, sum and quotient is written with __fmul_rn /
// __fadd_rn / __fdiv_rn in the plain twin's order, h0l (w0l x00 + w1l x01)
// + h1l (w0l x10 + w1l x11), so nvcc contracts nothing: bit-equal to
// random_walk.decode_plain on the card.
//
// Bound on this card: bytes. At the 96 x 128 bucket and C 8 it reads 393
// KB of scores and writes 1.57 MB of int64 labels (0.79 MB as int32; and,
// when asked, 6.3 MB of scores): ~2 MB / 3.35 TB/s = 0.6 us without the
// scores. Each value takes 8 taps and ~15 operations, far below the f32
// peak; the launch is bound by its latency.

#include <algorithm>
#include <atomic>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // upsample_scores' CTAs

struct Dims {
  int C, ch, cw, h4, w4, h0, w0;
};

// One axis of the x4 half-pixel bilinear: taps i0, i1 and weights l0, l1.
struct Taps {
  int i0, i1;
  float l0, l1;
};

__device__ __forceinline__ Taps taps(int o, int n) {
  float src = __fsub_rn(__fmul_rn(__fadd_rn((float)o, 0.5f), 0.25f), 0.5f);
  if (src < 0.f) src = 0.f;
  const int i0 = (int)floorf(src);
  const float lam = __fsub_rn(src, (float)i0);
  return Taps{i0, min(i0 + 1, n - 1), __fsub_rn(1.f, lam), lam};
}

__device__ __forceinline__ float bilinear(float x00, float x01, float x10,
                                          float x11, const Taps& ty,
                                          const Taps& tx) {
  return __fadd_rn(
      __fmul_rn(ty.l0, __fadd_rn(__fmul_rn(tx.l0, x00),
                                 __fmul_rn(tx.l1, x01))),
      __fmul_rn(ty.l1, __fadd_rn(__fmul_rn(tx.l0, x10),
                                 __fmul_rn(tx.l1, x11))));
}

// The per-pixel part shared by every row: the taps, the mask at the four
// taps (1 or 0), the mask's own bilinear and the pixel mask.
struct Pixel {
  Taps ty, tx;
  float m00, m01, m10, m11, den, pix;
};

__device__ __forceinline__ Pixel pixel(const Dims& d, int oy, int ox) {
  Pixel p;
  p.ty = taps(oy, d.ch);
  p.tx = taps(ox, d.cw);
  const bool r0 = p.ty.i0 < d.h4, r1 = p.ty.i1 < d.h4;
  const bool c0 = p.tx.i0 < d.w4, c1 = p.tx.i1 < d.w4;
  p.m00 = (r0 && c0) ? 1.f : 0.f;
  p.m01 = (r0 && c1) ? 1.f : 0.f;
  p.m10 = (r1 && c0) ? 1.f : 0.f;
  p.m11 = (r1 && c1) ? 1.f : 0.f;
  p.den = bilinear(p.m00, p.m01, p.m10, p.m11, p.ty, p.tx);
  p.pix = (oy < d.h0 && ox < d.w0) ? 1.f : 0.f;
  return p;
}

// Row c's upsampled score at the pixel: upsample_scores_plain's value.
__device__ __forceinline__ float score(const float* __restrict__ rw,
                                       const Dims& d, const Pixel& p, int c) {
  const float* plane = rw + (size_t)c * d.ch * d.cw;
  const float* row0 = plane + (size_t)p.ty.i0 * d.cw;
  const float* row1 = plane + (size_t)p.ty.i1 * d.cw;
  const float num = bilinear(__fmul_rn(__ldg(row0 + p.tx.i0), p.m00),
                             __fmul_rn(__ldg(row0 + p.tx.i1), p.m01),
                             __fmul_rn(__ldg(row1 + p.tx.i0), p.m10),
                             __fmul_rn(__ldg(row1 + p.tx.i1), p.m11), p.ty,
                             p.tx);
  const float q =
      p.den == 1.f ? num : p.den > 1e-6f ? __fdiv_rn(num, p.den) : 0.f;
  return __fmul_rn(q, p.pix);
}

// An unsigned key that orders as the floats do (negatives below positives).
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

struct Args {
  const float* rw;
  Dims d;
  unsigned* sync;  // [0] the barrier counter, [1] the exit counter, [2] the
                   // max key
  float* max_score;
  void* labels;
  int labels64;
  float* best;
  float* scores;
  float bg_thres;
};

// Phase 2 for one pixel: normalize the C values v(c), argmax, outputs.
// kC > 0: C <= kC, the loop unrolled so that v(c) reads a register.
template <int kC, typename Value>
__device__ __forceinline__ void finish(const Args& a, int i, float den,
                                       Value v) {
  const Dims& d = a.d;
  const int W = 4 * d.cw;
  const int HW = 4 * d.ch * W;
  float top = a.bg_thres;
  int arg = 0;
  float row_max = 0.f;
  auto row = [&](int c) {
    const float s = __fdiv_rn(v(c), den);
    if (a.scores) a.scores[(size_t)c * HW + i] = s;
    if (isnan(s) ? !isnan(top) : s > top) {
      top = s;
      arg = c + 1;
    }
    if (c == 0 || isnan(s) || s > row_max) row_max = s;
  };
  if constexpr (kC > 0) {
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (c < d.C) row(c);
  } else {
#pragma unroll 4
    for (int c = 0; c < d.C; ++c) row(c);
  }
  const int lab = (i / W < d.h0 && i % W < d.w0) ? arg : 0;
  if (a.labels64)
    static_cast<int64_t*>(a.labels)[i] = lab;
  else
    static_cast<int*>(a.labels)[i] = lab;
  if (a.best) a.best[i] = row_max;
}

// Threads per CTA of an instantiation: 512 where the values stay in
// registers (fewer CTAs at the grid barrier), 256 where they are
// recomputed; and the CTAs per SM it asks registers for: 1536 threads (42
// registers) for 8 values or the recomputing kernel, else 1024 (64).
template <int kC>
__host__ __device__ constexpr int cta_threads() {
  return kC > 0 ? 512 : 256;
}
template <int kC, int kPix>
__host__ __device__ constexpr int min_ctas() {
  return kC == 0 ? 6 : kC * kPix <= 8 ? 3 : 2;
}

// kC > 0: up to kC rows and kPix pixels per thread, the values kept in
// registers across the barrier; kC == 0: any C, any pixel count, phase 2
// recomputes the values.
template <int kC, int kPix>
__global__ void __launch_bounds__(cta_threads<kC>(), (min_ctas<kC, kPix>()))
decode_kernel(const __grid_constant__ Args a) {
  constexpr int kT = cta_threads<kC>();
  __shared__ unsigned red[kT / 32];
  const Dims& d = a.d;
  const int W = 4 * d.cw;
  const int HW = 4 * d.ch * W;
  const int T = gridDim.x * kT;
  const int gid = blockIdx.x * kT + threadIdx.x;
  unsigned key = 0;
  float v[kC > 0 ? kPix : 1][kC > 0 ? kC : 1];
  if constexpr (kC > 0) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int i = gid + k * T;
      if (i < HW) {
        const Pixel p = pixel(d, i / W, i % W);
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          if (c < d.C) {
            v[k][c] = score(a.rw, d, p, c);
            key = max(key, order_key(v[k][c]));
          }
        }
      }
    }
  } else {
    for (int i = gid; i < HW; i += T) {
      const Pixel p = pixel(d, i / W, i % W);
#pragma unroll 4
      for (int c = 0; c < d.C; ++c)
        key = max(key, order_key(score(a.rw, d, p, c)));
    }
  }
  key = __reduce_max_sync(0xffffffffu, key);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = key;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kT / 32; ++w) key = max(key, red[w]);
    atomicMax(a.sync + 2, key);
  }
  irn::hopper::grid_barrier(a.sync, 1);
  const float mx = key_value(__ldcg(a.sync + 2));  // L2: written this launch
  if (gid == 0) *a.max_score = mx;
  const float den = mx < 1e-12f ? 1e-12f : mx;  // clamp, NaN kept

  if constexpr (kC > 0) {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int i = gid + k * T;
      if (i < HW) {
        finish<kC>(a, i, den, [&](int c) { return v[k][c]; });
      }
    }
  } else {
    for (int i = gid; i < HW; i += T) {
      const Pixel p = pixel(d, i / W, i % W);
      finish<0>(a, i, den, [&](int c) { return score(a.rw, d, p, c); });
    }
  }

  // the last CTA out zeroes the counters and the key for the next launch
  if (threadIdx.x == 0 && atomicAdd(a.sync + 1, 1u) == gridDim.x - 1) {
    atomicExch(a.sync, 0u);
    atomicExch(a.sync + 1, 0u);
    atomicExch(a.sync + 2, 0u);
  }
}

// The pass-1 values alone, one thread per pixel (upsample_scores).
__global__ void __launch_bounds__(kThreads)
upsample_kernel(const float* __restrict__ rw, Dims d,
                float* __restrict__ scores) {
  const int W = 4 * d.cw;
  const int HW = 4 * d.ch * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  const Pixel p = pixel(d, i / W, i % W);
  for (int c = 0; c < d.C; ++c)
    scores[(size_t)c * HW + i] = score(rw, d, p, c);
}

bool bad_dims(const Dims& d) {
  return d.C < 1 || d.ch < 1 || d.cw < 1 ||
         (long long)16 * d.ch * d.cw > 0x7fffffffLL;
}

// CTAs of decode_kernel<kC, kPix> that the current device holds at once;
// cached per device.
template <int kC, int kPix>
cudaError_t resident_ctas(int* resident) {
  static std::atomic<int> cache[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev].load() > 0) {
    *resident = cache[dev].load();
    return cudaSuccess;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, decode_kernel<kC, kPix>, cta_threads<kC>(), 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *resident = per_sm * sms;
  if (*resident < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cache[dev].store(*resident);
  return cudaSuccess;
}

// Launches decode_kernel<kC, kPix> when its registers take every pixel
// (always for kC == 0); *done tells whether it did.
template <int kC, int kPix>
int try_launch(const Args& a, cudaStream_t s, int* launched, bool* done) {
  *done = false;
  if (kC > 0 && a.d.C > kC) return 0;
  int resident = 0;
  const cudaError_t e = resident_ctas<kC, kPix>(&resident);
  if (e != cudaSuccess) return (int)e;
  const int HW = 16 * a.d.ch * a.d.cw;
  constexpr int kT = cta_threads<kC>();
  const int grid = std::min(resident, (HW + kT - 1) / kT);
  if (kC > 0 && (long long)grid * kT * kPix < HW) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(kT, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t le = cudaLaunchKernelEx(&cfg, decode_kernel<kC, kPix>, a);
  if (le != cudaSuccess) {
    cudaGetLastError();  // cleared, so that the next launch does not read it
    return (int)le;
  }
  IRN_CHECK_LAUNCH(launched);
  *done = true;
  return 0;
}

}  // namespace

// rw [C, ch, cw] f32 -> scores [C, 4ch, 4cw] f32, the un-normalized
// upsample (pass 1 alone); all on the device. One launch.
IRN_API int irn_upsample_scores(const float* rw, float* scores, int C, int ch,
                                int cw, int h4, int w4, int h0, int w0,
                                cudaStream_t stream, int* launched) {
  const Dims d{C, ch, cw, h4, w4, h0, w0};
  if (bad_dims(d) || !scores) return (int)cudaErrorInvalidValue;
  const int blocks = (16 * ch * cw + kThreads - 1) / kThreads;
  upsample_kernel<<<blocks, kThreads, 0, stream>>>(rw, d, scores);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// rw [C, ch, cw] f32 -> labels [4ch, 4cw] (int64 if labels64, else int32)
// and max_score [1] f32; best [4ch, 4cw] and the normalized scores [C, 4ch,
// 4cw] f32 when not null. scratch: 3 uint32 (2 counters and the max key),
// zero before the first launch on the stream and left zero by each. All on
// the device. One cooperative launch.
IRN_API int irn_decode(const float* rw, unsigned* scratch,
                       float* max_score, void* labels, int labels64,
                       float* best, float* scores, int C, int ch, int cw,
                       int h4, int w4, int h0, int w0, float bg_thres,
                       cudaStream_t stream, int* launched) {
  const Dims d{C, ch, cw, h4, w4, h0, w0};
  if (bad_dims(d) || !scratch || !max_score || !labels)
    return (int)cudaErrorInvalidValue;
  const Args a{rw,     d,    scratch, max_score, labels, labels64 != 0,
               best,   scores, bg_thres};
  bool done = false;
  int e = try_launch<8, 1>(a, stream, launched, &done);
  if (!e && !done) e = try_launch<8, 2>(a, stream, launched, &done);
  if (!e && !done) e = try_launch<16, 2>(a, stream, launched, &done);
  if (!e && !done) e = try_launch<0, 0>(a, stream, launched, &done);
  return e;
}
