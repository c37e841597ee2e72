// K15 decode: the walk's x4 upsample of the propagated scores, their global
// max, and the background-threshold argmax, in two launches.
//
// Replaces: irn_tpu/ops/random_walk.py upsample_scores and
// upsample_and_decode (an XLA program on the TPU: two bilinear resizes, the
// mask-normalized quotient, the max, the threshold plane and the argmax),
// which eager PyTorch runs as some 20 launches over [C, 4ch, 4cw] tensors.
//
// Pass 1 (upsample + max): one thread per output pixel (oy, ox) of the
// [4ch, 4cw] grid, looping over the C score rows. Each value is the
// half-pixel x4 bilinear (align_corners=False: source (o + 0.5) * 0.25 -
// 0.5 clamped at 0, the upper neighbour clamped to size - 1) of rw * m4 over
// the same bilinear of m4 (m4: 1 inside the (h4, w4) cells) where the
// latter exceeds 1e-6, else 0, times the pixel mask (h0, w0): the values of
// random_walk.upsample_scores_plain. Written to ``scores`` when asked
// (upsample_scores). The global max goes through an order-preserving
// unsigned key (negatives included): a warp reduction, then one atomicMax
// per block. A max is the same in any order.
//
// Pass 2 (normalize + argmax): one thread per pixel recomputes its C values
// (the same code on the same inputs: the same bits as pass 1), divides each
// by max(max, 1e-12), and takes the argmax over [bg_thres, s_0 .. s_{C-1}]
// with torch.argmax's rule (the first maximum wins, NaN counts as the
// largest): the background plane wins a tie at bg_thres. Labels are 0
// outside (h0, w0). Optional outputs: the normalized scores [C, 4ch, 4cw]
// and ``best``, the max over rows of the normalized scores (the instance
// walk's winning score), so a caller that needs only labels (and best)
// never writes the [C, 4ch, 4cw] tensor.
//
// Bit-equality: every product, sum and quotient is written with __fmul_rn /
// __fadd_rn / __fdiv_rn in the plain twin's order, h0l (w0l x00 + w1l x01)
// + h1l (w0l x10 + w1l x11), so nvcc contracts nothing: bit-equal to
// random_walk.decode_plain on the card.
//
// Bound on this card: bytes. At the 96 x 128 bucket and C 8 it reads 393
// KB of scores and writes 1.57 MB of int64 labels (and, when asked, 6.3 MB
// of scores): ~2 MB / 3.35 TB/s = 0.6 us without the scores. Each value
// takes 8 taps and ~15 operations, far below the f32 peak; the two
// launches are bound by their latency.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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
  const float q = p.den > 1e-6f ? __fdiv_rn(num, p.den) : 0.f;
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

__global__ void __launch_bounds__(kThreads)
upsample_max_kernel(const float* __restrict__ rw, Dims d,
                    unsigned* __restrict__ key, float* __restrict__ scores) {
  __shared__ unsigned warp_max[kThreads / 32];
  const int W = 4 * d.cw;
  const int HW = 4 * d.ch * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  unsigned best = 0;
  if (i < HW) {
    const Pixel p = pixel(d, i / W, i % W);
    for (int c = 0; c < d.C; ++c) {
      const float v = score(rw, d, p, c);
      if (scores) scores[(size_t)c * HW + i] = v;
      best = max(best, order_key(v));
    }
  }
  if (!key) return;
  best = __reduce_max_sync(0xffffffffu, best);
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w_ = 1; w_ < kThreads / 32; ++w_) best = max(best, warp_max[w_]);
    atomicMax(key, best);
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_kernel(const float* __restrict__ rw, Dims d,
              const unsigned* __restrict__ key, float bg_thres,
              float* __restrict__ max_score, int64_t* __restrict__ labels,
              float* __restrict__ best, float* __restrict__ scores) {
  const int W = 4 * d.cw;
  const int HW = 4 * d.ch * W;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= HW) return;
  const float mx = key_value(*key);
  if (i == 0) *max_score = mx;
  const float den = mx < 1e-12f ? 1e-12f : mx;  // clamp, NaN kept
  const int oy = i / W;
  const int ox = i % W;
  const Pixel p = pixel(d, oy, ox);
  float top = bg_thres;
  int arg = 0;
  float row_max = 0.f;
  for (int c = 0; c < d.C; ++c) {
    const float s = __fdiv_rn(score(rw, d, p, c), den);
    if (scores) scores[(size_t)c * HW + i] = s;
    if (isnan(s) ? !isnan(top) : s > top) {
      top = s;
      arg = c + 1;
    }
    if (c == 0 || isnan(s) || s > row_max) row_max = s;
  }
  labels[i] = (oy < d.h0 && ox < d.w0) ? arg : 0;
  if (best) best[i] = row_max;
}

bool bad_dims(const Dims& d) {
  return d.C < 1 || d.ch < 1 || d.cw < 1 ||
         (long long)16 * d.ch * d.cw > 0x7fffffffLL;
}

int blocks(const Dims& d) {
  return (16 * d.ch * d.cw + kThreads - 1) / kThreads;
}

}  // namespace

// rw [C, ch, cw] f32 -> scores [C, 4ch, 4cw] f32, the un-normalized
// upsample (pass 1 alone); all on the device. One launch.
IRN_API int irn_upsample_scores(const float* rw, float* scores, int C, int ch,
                                int cw, int h4, int w4, int h0, int w0,
                                cudaStream_t stream, int* launched) {
  const Dims d{C, ch, cw, h4, w4, h0, w0};
  if (bad_dims(d) || !scores) return (int)cudaErrorInvalidValue;
  upsample_max_kernel<<<blocks(d), kThreads, 0, stream>>>(rw, d, nullptr,
                                                          scores);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// rw [C, ch, cw] f32 -> labels [4ch, 4cw] int64 and max_score [1] f32; best
// [4ch, 4cw] and the normalized scores [C, 4ch, 4cw] f32 when not null;
// key: one uint32 of scratch. All on the device. Two launches.
IRN_API int irn_decode(const float* rw, unsigned* key, float* max_score,
                       int64_t* labels, float* best, float* scores, int C,
                       int ch, int cw, int h4, int w4, int h0, int w0,
                       float bg_thres, cudaStream_t stream, int* launched) {
  const Dims d{C, ch, cw, h4, w4, h0, w0};
  if (bad_dims(d) || !key || !max_score || !labels)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(key, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  upsample_max_kernel<<<blocks(d), kThreads, 0, stream>>>(rw, d, key,
                                                          nullptr);
  IRN_CHECK_LAUNCH(launched);
  argmax_kernel<<<blocks(d), kThreads, 0, stream>>>(
      rw, d, key, bg_thres, max_score, labels, best, scores);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
