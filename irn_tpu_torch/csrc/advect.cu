// K11 advect: the instance stage's 300-step centroid advection and the
// basin predicate, for one image.
//
// Replaces: irn_tpu/ops/centroids.py _find_centroids_matmul (an XLA
// fori_loop; the two-tap separable bilinear sample) and the fused
// |dp| < thres predicate of irn_tpu/pipeline/stages_irn.py
// _advect_pack_core / _cluster_pack_core.
//
// Each pixel's particle starts at (min(row, h4 - 1), min(col, w4 - 1)) and
// moves, `iterations` times, by the bilinear sample of dp at its position,
// clipped to [0, h4 - 1] x [0, w4 - 1]; the end point rounds half to even
// (rintf, as jnp.rint and torch.round). With ly = floor(y), fy = y - ly:
// r(c) = fma(fy, f[ly + 1, c], (1 - fy) f[ly, c]) at c = lx, lx + 1 (the
// JAX form's row interpolation is a matmul, which XLA's CPU dot accumulates
// by fused multiply-adds), then s = (1 - fx) r(lx) + fx r(lx + 1), a product
// and a sum, both channels at the old (y, x). A tap past the grid has
// weight exactly 0; its index is clamped, as the plain twin clamps it, so
// its product is 0 there too. Every operation is written out (__fmaf_rn,
// __fmul_rn, __fadd_rn) in the twin's order, so nvcc contracts nothing else
// and the kernel is bit-equal to ops/centroids.advect_plain. A NaN sum
// clips to 0 (fmaxf), where the twin's torch.maximum would carry it on.
//
// Bound on this card: neither bytes nor operations. At the 128 x 128 cap it
// reads 128 KB of dp and writes 144 KB, and does ~20 operations per pixel
// and step (98 MFLOP over 300 steps, ~1.5 us at the f32 peak); but every
// step depends on the one before, so a particle's steps are one chain of
// dependent loads and arithmetic: latency, and the slowest lane of each
// warp sets the warp's time.
//
// Design (the particle in registers, the basin predicate fused, one launch
// per image):
// - dp in shared memory. Each CTA stages the rows its particles can reach,
//   [0, h4] x [0, W], as one float2 (dy, dx) per pixel with a pitch of W +
//   1 (the rows of one column fall on different banks); column W repeats
//   column W - 1 and, when h4 = H, row H repeats row H - 1, so a step's
//   four taps are four 8-byte shared loads at (ly, lx), (ly, lx + 1),
//   (ly + 1, lx), (ly + 1, lx + 1) with no clamp. All kStageThreads
//   threads stage (16-byte loads of both planes, kStageRows rows in flight
//   per warp, four float2 stores each); the first kThreads then step, one
//   particle each. A grid whose rows do not fit the 227 KB a CTA may take,
//   or whose width is no multiple of 4, runs the same steps with the taps
//   read through L1 (__ldg, indices clamped); the choice depends on the
//   size alone (irn_advect_staged_bytes, which centroids.advect_staged
//   asks).
// - A shorter step: floor by one add, ty = y + 2^23 rounded down, whose
//   bits are 0x4B000000 + floor(y) (exact for 0 <= y < 2^23), in place of
//   floorf and a float-to-int conversion in series; each tap row's byte
//   offset from its own two multiply-adds of those bits.
// - An exact early stop. A step is a function F of the position's bits
//   (dp, h4, w4 are fixed). The steps run in chunks of kChunk; when the
//   bits after a chunk equal those before it, the orbit from there has a
//   period dividing kChunk, so the end point after the `left` steps still
//   due is F^(left mod kChunk) of the current one: those run, and the lane
//   stops. A lane whose orbit never repeats with such a period (a cycle of
//   3 steps, say) runs all its steps, at one compare per chunk. Fewer than
//   kChunk steps left run one by one. The compare is of the bits
//   (__float_as_uint), so -0 and +0 never merge. A lane that stops idles;
//   a warp costs its slowest lane.
//
// On the card (NVIDIA H100 80GB HBM3, 700 W; tools/probe_advect.py, PERF.md
// K11's row): 100-130 cycles a step in the chunk loop (the chain: the
// floor's add, a multiply-add pair, the shared loads, a multiply, an fma,
// a multiply, two adds, two clips; ~75 at textbook latencies), the
// staging ~3.5k cycles of a basin field's ~12k at the cap. The constants
// below were picked by the probe's variants, which it builds from edited
// copies of this source.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // particles per CTA
// threads per CTA of the staged instance: all stage, kThreads step
constexpr int kStageThreads = 1024;
// rows a warp loads before it stores them
constexpr int kStageRows = 4;
static_assert(kStageThreads >= kThreads && kStageThreads % 32 == 0,
              "the staging threads include the stepping ones");
constexpr int kChunk = 8;  // steps between two compares of the position
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may take
constexpr int kMaxSide = 1 << 23;  // positions below 2^23: kMagic floors

// floor(v) for 0 <= v < 2^23, exactly: v + 2^23 rounded down is 2^23 +
// floor(v) (its ulp is 1), whose bits are 0x4B000000 + floor(v). One add,
// where floorf and a float-to-int conversion took two slower ops.
constexpr float kMagic = 8388608.f;  // 2^23
constexpr unsigned kMagicBits = 0x4B000000u;

// A step's taps, both channels each: a00 = f[ly, lx], a01 = f[ly, lx + 1],
// a10 = f[ly + 1, lx], a11 = f[ly + 1, lx + 1], each index clamped to the
// grid as the twin clamps it. ty, tx: the positions plus 2^23, rounded
// down (kMagic).
template <bool kStaged>
struct Taps;

// The staged rows: [h4 + 1, W + 1] float2 (dy, dx); column W repeats
// column W - 1 and, when h4 = H, row H repeats row H - 1, so the clamped
// neighbours are the next column and row without a clamp. The pitch of W
// + 1 float2 also puts one column's rows on different banks.
template <>
struct Taps<true> {
  const float2* base;  // the staged rows
  unsigned pitch8;     // bytes per staged row
  unsigned bias0;      // -(kMagicBits (pitch8 + 8)) mod 2^32
  unsigned bias1;      // bias0 + pitch8: the lower row's
  __device__ __forceinline__ void operator()(float ty, float tx, float2& a00,
                                             float2& a01, float2& a10,
                                             float2& a11) const {
    // (bits(ty) pitch8 + bits(tx) 8 + bias0) mod 2^32 = ly pitch8 + lx 8:
    // each row's offset by its own two multiply-adds, side by side
    const unsigned by = __float_as_uint(ty);
    const unsigned bx = __float_as_uint(tx);
    const unsigned o0 = mad(by, pitch8, mad(bx, 8u, bias0));
    const unsigned o1 = mad(by, pitch8, mad(bx, 8u, bias1));
    const char* b = reinterpret_cast<const char*>(base);
    a00 = *reinterpret_cast<const float2*>(b + o0);
    a01 = *reinterpret_cast<const float2*>(b + o0 + 8);
    a10 = *reinterpret_cast<const float2*>(b + o1);
    a11 = *reinterpret_cast<const float2*>(b + o1 + 8);
  }
  // a * b + c mod 2^32 as one instruction (the compiler would share the
  // rows' product and chain the lower row's offset after the upper's)
  static __device__ __forceinline__ unsigned mad(unsigned a, unsigned b,
                                                 unsigned c) {
    unsigned d;
    asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
    return d;
  }
};

// The two planes through the read-only L1 path, indices clamped.
template <>
struct Taps<false> {
  const float* dy;
  const float* dx;
  int H, W;
  __device__ __forceinline__ void operator()(float ty, float tx, float2& a00,
                                             float2& a01, float2& a10,
                                             float2& a11) const {
    const int iy = (int)(__float_as_uint(ty) - kMagicBits);
    const int ix = (int)(__float_as_uint(tx) - kMagicBits);
    const int i00 = iy * W + ix;
    const int i10 = min(iy + 1, H - 1) * W + ix;
    const int dx1 = min(ix + 1, W - 1) - ix;
    a00 = make_float2(__ldg(dy + i00), __ldg(dx + i00));
    a01 = make_float2(__ldg(dy + i00 + dx1), __ldg(dx + i00 + dx1));
    a10 = make_float2(__ldg(dy + i10), __ldg(dx + i10));
    a11 = make_float2(__ldg(dy + i10 + dx1), __ldg(dx + i10 + dx1));
  }
};

__device__ __forceinline__ float interp(float a00, float a01, float a10,
                                        float a11, float gy, float fy,
                                        float gx, float fx) {
  const float r0 = __fmaf_rn(fy, a10, __fmul_rn(gy, a00));
  const float r1 = __fmaf_rn(fy, a11, __fmul_rn(gy, a01));
  return __fadd_rn(__fmul_rn(gx, r0), __fmul_rn(fx, r1));
}

// One step of the particle at (y, x): F in the note above.
template <bool kStaged>
__device__ __forceinline__ void step(const Taps<kStaged>& taps, float& y,
                                     float& x, float ymax, float xmax) {
  const float ty = __fadd_rd(y, kMagic);
  const float tx = __fadd_rd(x, kMagic);
  float2 a00, a01, a10, a11;
  taps(ty, tx, a00, a01, a10, a11);
  const float fy = __fsub_rn(y, __fsub_rn(ty, kMagic));
  const float fx = __fsub_rn(x, __fsub_rn(tx, kMagic));
  const float gy = __fsub_rn(1.f, fy);
  const float gx = __fsub_rn(1.f, fx);
  const float sy = interp(a00.x, a01.x, a10.x, a11.x, gy, fy, gx, fx);
  const float sx = interp(a00.y, a01.y, a10.y, a11.y, gy, fy, gx, fx);
  y = fminf(fmaxf(__fadd_rn(y, sy), 0.f), ymax);
  x = fminf(fmaxf(__fadd_rn(x, sx), 0.f), xmax);
}

// Stage rows [0, h4] x columns [0, W] of dp into `staged` ([h4 + 1][W + 1]
// float2), row and column indices clamped to the grid, with every thread
// of the CTA: 16-byte loads of both planes (W a multiple of 4, dp 16-byte
// aligned: irn_advect checks), kStageRows rows of them in flight per warp,
// then four float2 stores per load pair; the lane holding column W - 1
// also writes column W.
__device__ __forceinline__ void stage_rows(float2* staged,
                                           const float* __restrict__ fdy,
                                           const float* __restrict__ fdx,
                                           int H, int W, int h4) {
  constexpr int kWarps = kStageThreads / 32;
  const int lane = threadIdx.x % 32;
  const int w4s = W / 4;
  const int pitch = W + 1;
  const float4* gy = reinterpret_cast<const float4*>(fdy);
  const float4* gx = reinterpret_cast<const float4*>(fdx);
  for (int r0 = threadIdx.x / 32 * kStageRows; r0 <= h4;
       r0 += kWarps * kStageRows) {
    for (int c4 = lane; c4 < w4s; c4 += 32) {
      float4 vy[kStageRows], vx[kStageRows];
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        const int sr = min(min(r0 + k, h4), H - 1);
        vy[k] = __ldg(gy + sr * w4s + c4);
        vx[k] = __ldg(gx + sr * w4s + c4);
      }
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        if (r0 + k > h4) break;
        float2* d = staged + (r0 + k) * pitch + 4 * c4;
        d[0] = make_float2(vy[k].x, vx[k].x);
        d[1] = make_float2(vy[k].y, vx[k].y);
        d[2] = make_float2(vy[k].z, vx[k].z);
        d[3] = make_float2(vy[k].w, vx[k].w);
        if (c4 == w4s - 1) d[4] = d[3];
      }
    }
  }
  __syncthreads();
}

template <bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStageThreads : kThreads)
advect_kernel(const float* __restrict__ dp, int* __restrict__ cent,
              uint8_t* __restrict__ basin, int H, int W, int h4, int w4,
              int iterations, float thres) {
  extern __shared__ float2 staged[];
  const int HW = H * W;
  const float* fdy = dp;
  const float* fdx = dp + HW;
  if (kStaged) stage_rows(staged, fdy, fdx, H, W, h4);
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (threadIdx.x >= kThreads || p >= HW) return;
  Taps<kStaged> taps;
  if constexpr (kStaged) {
    const unsigned pitch8 = 8u * (unsigned)(W + 1);
    const unsigned bias0 = 0u - kMagicBits * (pitch8 + 8u);
    taps = {staged, pitch8, bias0, bias0 + pitch8};
  } else {
    taps = {fdy, fdx, H, W};
  }
  const int row = p / W;
  const int col = p % W;
  const float ymax = (float)(h4 - 1);
  const float xmax = (float)(w4 - 1);
  float y = fminf((float)row, ymax);
  float x = fminf((float)col, xmax);
  int left = iterations;
  while (left >= kChunk) {
    const unsigned by = __float_as_uint(y), bx = __float_as_uint(x);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) step(taps, y, x, ymax, xmax);
    left -= kChunk;
    if (__float_as_uint(y) == by && __float_as_uint(x) == bx) {
      left %= kChunk;  // a period dividing kChunk: F^(left mod kChunk)
      break;
    }
  }
  for (; left > 0; --left) step(taps, y, x, ymax, xmax);
  cent[p] = (int)rintf(y);
  cent[HW + p] = (int)rintf(x);
  const float dy = __ldg(fdy + p);
  const float dx = __ldg(fdx + p);
  basin[p] = __fsqrt_rn(__fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx))) <
             thres;
}

std::atomic<unsigned long long> smem_set{0};

}  // namespace

// Bytes of shared memory the staged instance takes for a grid of width W
// at extent height h4 ([h4 + 1, W + 1] float2), or 0 when the grid takes
// the __ldg instance (the rows do not fit, or W is not a multiple of 4):
// irn_advect's choice, the one statement of the rule.
IRN_API int irn_advect_staged_bytes(int W, int h4) {
  const long long bytes = (long long)(h4 + 1) * (W + 1) * sizeof(float2);
  return W % 4 == 0 && bytes <= kSmemMax ? (int)bytes : 0;
}

// dp: [2, H, W] f32; cent: [2, H, W] int32; basin: [H, W] bool (uint8).
IRN_API int irn_advect(const float* dp, int* cent, uint8_t* basin, int H,
                       int W, int h4, int w4, int iterations, float thres,
                       void* stream, int* launched) {
  if (H < 1 || W < 1 || h4 < 1 || h4 > H || w4 < 1 || w4 > W ||
      iterations < 0 || (long long)H * W >= (1LL << 30) || H > kMaxSide ||
      W > kMaxSide)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (H * W + kThreads - 1) / kThreads;
  const int bytes = irn_advect_staged_bytes(W, h4);
  if (bytes && reinterpret_cast<uintptr_t>(dp) % 16)
    return (int)cudaErrorInvalidValue;  // the staging's 16-byte loads
  if (bytes) {
    cudaError_t e = irn::allow_smem(advect_kernel<true>, smem_set, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    advect_kernel<true><<<blocks, kStageThreads, bytes, s>>>(
        dp, cent, basin, H, W, h4, w4, iterations, thres);
  } else {
    advect_kernel<false><<<blocks, kThreads, 0, s>>>(
        dp, cent, basin, H, W, h4, w4, iterations, thres);
  }
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
