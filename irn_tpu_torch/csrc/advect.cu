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
// and the kernel is bit-equal to ops/centroids.advect_plain.
//
// A non-finite dp. The JAX form multiplies every cell of a plane by a
// weight that is 0 off the particle's taps, so one NaN or infinity
// anywhere in the plane (padding included) makes the sample NaN (0 * inf,
// 0 * NaN), unless every non-finite cell of the plane is an infinity of one
// sign on a tap of positive weight: then the sample is that infinity. A NaN
// position has no tap of positive weight (a finite plane samples 0 there);
// the clip carries NaN on, and a NaN end point converts to 0. Which case
// holds depends on what the whole plane holds, so the CTAs pool it: each
// checks its staged rows itself (a multiply-add by 0 per value, summed: NaN
// once one is not finite) and one warp per CTA, the helper, checks a share
// of the rest, adds its CTA's arrival (and whether it found a non-finite
// cell) to a counter, and waits until every CTA has arrived; the steppers
// meet the helper on a named barrier after their first block's steps.
// On a finite dp they write what they stepped; else each particle steps
// again from its start by the rule above, one step at a time, until its
// position stops changing (ops/centroids.advect_schedule models both).
// The grid is cooperative (every CTA resident, so the wait ends; a CTA
// steps several particle blocks when the card holds fewer CTAs than there
// are blocks). The counter and the pooled cells live in a scratch of two
// sets, used in turns: the launch reads which set from the scratch's first
// word, and CTA 0's helper, once every CTA has arrived, zeroes the other
// set and flips the word for the next launch on the stream, so no memset.
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
//   asks). One warp past the steppers is the helper (the pooled check of
//   a non-finite dp above); it stages the last row group, which a grid
//   below 124 rows does not have, so its own check delays no staging.
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

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // particles per CTA
// the helper warp's index, just past the steppers'; the __ldg instance's
// CTA is the steppers and the helper
constexpr int kHelper = kThreads / 32;
constexpr int kL1Threads = kThreads + 32;
// threads per CTA of the staged instance: all stage, kThreads step
constexpr int kStageThreads = 1024;
// rows a warp loads before it stores them
constexpr int kStageRows = 4;
static_assert(kStageThreads >= kThreads + 32 && kStageThreads % 32 == 0,
              "the staging threads include the steppers and the helper");
constexpr int kChunk = 8;  // steps between two compares of the position
// dynamic shared memory a CTA may take: the card's 227 KB less room for
// the static s_poison
constexpr int kSmemMax = 232448 - 64;
constexpr int kMaxSide = 1 << 23;  // positions below 2^23: kMagic floors
constexpr int kBarrier = 1;        // named barrier: the steppers and helper

// The poison words of one plane, in a CTA's shared memory and in the
// scratch alike (every field is a max or an OR, so sets merge): [0] the
// kinds found (kNan | kPosInf | kNegInf), then over the infinities [1] H -
// the first row, [2] the last row + 1, [3] W - the first column, [4] the
// last column + 1 (0: none).
constexpr unsigned kNan = 1, kPosInf = 2, kNegInf = 4;
constexpr int kPoisonWords = 10;  // both planes
// The scratch, uint32: [0] the set in use (0 or 1), [1] unused, then two
// sets of kSetWords: [0, 1] the arrival word (u64: CTAs arrived, plus 2^32
// for each that found a non-finite cell), [2, 12) the poison words.
constexpr int kSetWords = 2 + kPoisonWords;
constexpr int kScratchWords = 2 + 2 * kSetWords;

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

// -- a non-finite dp ---------------------------------------------------------

__device__ __forceinline__ bool finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) != 0x7f800000u;
}

// Adds the non-finite v at (r, c) of plane `plane` to the poison words q
// (shared or global).
__device__ __forceinline__ void note(unsigned* q, float v, int plane, int r,
                                     int c, int H, int W) {
  q += 5 * plane;
  atomicOr(q, isnan(v) ? kNan : v > 0.f ? kPosInf : kNegInf);
  if (isnan(v)) return;
  atomicMax(q + 1, (unsigned)(H - r));
  atomicMax(q + 2, (unsigned)(r + 1));
  atomicMax(q + 3, (unsigned)(W - c));
  atomicMax(q + 4, (unsigned)(c + 1));
}

// One plane's poison, decoded from its words.
struct Poison {
  unsigned kinds;
  int r0, r1, c0, c1;  // the rows and columns the infinities span
  __device__ Poison(const unsigned* q, int H, int W)
      : kinds(q[0]), r0(H - (int)q[1]), r1((int)q[2] - 1),
        c0(W - (int)q[3]), c1((int)q[4] - 1) {}
  // The JAX form's sample of this (non-finite) plane at a particle whose
  // taps of positive weight are rows {ly, ly + 1 if fy > 0} x columns {lx,
  // lx + 1 if fx > 0} (fin: its position is not NaN).
  __device__ float sample(bool fin, int ly, bool fy, int lx, bool fx) const {
    const float nan = __uint_as_float(0x7fffffffu);
    if ((kinds & kNan) || kinds == (kPosInf | kNegInf)) return nan;
    const bool inside = fin && r0 >= ly && r1 <= ly + fy && c0 >= lx &&
                        c1 <= lx + fx;
    if (!inside) return nan;
    return __uint_as_float(kinds == kPosInf ? 0x7f800000u : 0xff800000u);
  }
};

__device__ __forceinline__ float clip_nan(float v, float m) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.f), m);
}

// One step of JAX's form on a dp with a non-finite value: a finite plane
// samples as step() does (0 at a NaN position), the other by
// Poison::sample; the clip keeps a NaN.
template <bool kStaged>
__device__ __forceinline__ void step_poisoned(const Taps<kStaged>& taps,
                                              const Poison& py,
                                              const Poison& px, float& y,
                                              float& x, float ymax,
                                              float xmax) {
  const bool fin = !isnan(y) && !isnan(x);
  const float ys = fin ? y : 0.f;
  const float xs = fin ? x : 0.f;
  const float ty = __fadd_rd(ys, kMagic);
  const float tx = __fadd_rd(xs, kMagic);
  float2 a00, a01, a10, a11;
  taps(ty, tx, a00, a01, a10, a11);
  const float fy = __fsub_rn(ys, __fsub_rn(ty, kMagic));
  const float fx = __fsub_rn(xs, __fsub_rn(tx, kMagic));
  const float gy = __fsub_rn(1.f, fy);
  const float gx = __fsub_rn(1.f, fx);
  const int ly = (int)(__float_as_uint(ty) - kMagicBits);
  const int lx = (int)(__float_as_uint(tx) - kMagicBits);
  const float sy =
      py.kinds ? py.sample(fin, ly, fy > 0.f, lx, fx > 0.f)
      : fin    ? interp(a00.x, a01.x, a10.x, a11.x, gy, fy, gx, fx)
               : 0.f;
  const float sx =
      px.kinds ? px.sample(fin, ly, fy > 0.f, lx, fx > 0.f)
      : fin    ? interp(a00.y, a01.y, a10.y, a11.y, gy, fy, gx, fx)
               : 0.f;
  y = clip_nan(__fadd_rn(y, sy), ymax);
  x = clip_nan(__fadd_rn(x, sx), xmax);
}

// The particle from (y, x) by step_poisoned, `iterations` steps or until
// a step leaves its bits as they were (a fixed point: every later step
// does too).
template <bool kStaged>
__device__ __noinline__ void advect_poisoned(const Taps<kStaged>& taps,
                                             const unsigned* s_poison,
                                             int H, int W, float& y,
                                             float& x, float ymax,
                                             float xmax, int iterations) {
  const Poison py(s_poison, H, W), px(s_poison + 5, H, W);
  for (int k = 0; k < iterations; ++k) {
    const unsigned oy = __float_as_uint(y), ox = __float_as_uint(x);
    step_poisoned(taps, py, px, y, x, ymax, xmax);
    if (oy == __float_as_uint(y) && ox == __float_as_uint(x)) break;
  }
}

// Loads of the helper's share in flight per lane.
constexpr int kScanLoads = 4;

// The helper warp, first: its CTA's share of the cells that no CTA stages
// (rows past h4 of both planes; every cell in the __ldg instance), each
// non-finite one noted in the scratch set `par`, then the CTA's arrival.
// The set's index, the share and the arrival are one round trip: no
// fence unless a cell was noted (relaxed loads and add; the wait's fence
// orders what it reads after them).
template <bool kStaged>
__device__ __forceinline__ unsigned helper_scan(const float* __restrict__ dp,
                                                int H, int W, int h4,
                                                unsigned* scratch) {
  const int lane = threadIdx.x % 32;
  unsigned par;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(par)
               : "l"(scratch)
               : "memory");
  const int first = kStaged ? min(h4 + 1, H) : 0;
  const int plane = (H - first) * W;
  const int n = 2 * plane;
  const int share = (n + gridDim.x - 1) / gridDim.x;
  const int begin = blockIdx.x * share;
  const int end = min(n, begin + share);
  bool found = false;
  for (int i0 = begin + lane; i0 < end; i0 += 32 * kScanLoads) {
    float v[kScanLoads];
#pragma unroll
    for (int k = 0; k < kScanLoads; ++k) {
      const int i = i0 + 32 * k;
      const int c = i >= plane;
      v[k] = i < end ? __ldg(dp + c * H * W + first * W + (i - c * plane))
                     : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kScanLoads; ++k) {
      if (finite(v[k])) continue;
      const int i = i0 + 32 * k;
      const int c = i >= plane;
      const int j = i - c * plane;
      note(scratch + 4 + (par & 1u) * kSetWords, v[k], c, first + j / W,
           j % W, H, W);
      found = true;
    }
  }
  found = __any_sync(0xffffffffu, found);
  if (lane == 0) {
    if (found) __threadfence();  // the notes before the arrival
    const unsigned long long add = 1ull + ((unsigned long long)found << 32);
    asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(
                     scratch + 2 + (par & 1u) * kSetWords),
                 "l"(add)
                 : "memory");
  }
  return par & 1u;
}

// The helper warp, then: the CTA's poison words (its staged rows' when
// `bad`, else zero) merged with what every CTA found, once every CTA has
// arrived; CTA 0 readies the other set for the next launch. Then it meets
// the steppers.
__device__ __forceinline__ void helper_wait(unsigned* scratch, unsigned par,
                                            bool bad, unsigned* s_poison) {
  const int lane = threadIdx.x % 32;
  unsigned* set = scratch + 2 + par * kSetWords;
  if (!bad && lane < kPoisonWords) s_poison[lane] = 0;
  __syncwarp();
  if (lane == 0) {
    unsigned long long seen;
    long long start = 0;
    for (;;) {
      asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
                   : "=l"(seen)
                   : "l"(set)
                   : "memory");
      if ((unsigned)seen >= gridDim.x) break;
      if (!start) {
        start = clock64();
      } else if (clock64() - start > (1ll << 36)) {
        __trap();
      }
    }
    if (seen >> 32) {
      __threadfence();  // the notes that came before the arrivals seen
      for (int k = 0; k < kPoisonWords; ++k) {
        unsigned g;
        asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                     : "=r"(g)
                     : "l"(set + 2 + k)
                     : "memory");
        s_poison[k] = k % 5 ? max(s_poison[k], g) : s_poison[k] | g;
      }
    }
    if (blockIdx.x == 0) {
      unsigned* other = scratch + 2 + (par ^ 1u) * kSetWords;
      for (int k = 0; k < kSetWords; ++k) other[k] = 0;
      asm volatile("st.relaxed.gpu.global.u32 [%0], %1;" ::"l"(scratch),
                   "r"(par ^ 1u)
                   : "memory");
    }
  }
  __syncwarp();
  irn::hopper::named_arrive(kBarrier, kThreads + 32);
}

// Stage rows [0, h4] x columns [0, W] of dp into `staged` ([h4 + 1][W + 1]
// float2), row and column indices clamped to the grid, with every thread
// of the CTA: 16-byte loads of both planes (W a multiple of 4, dp 16-byte
// aligned: irn_advect checks), kStageRows rows of them in flight per warp,
// then four float2 stores per load pair; the lane holding column W - 1
// also writes column W. The helper warp takes the last row group (it
// checks its cells first). Returns whether a staged value is not finite
// (every value times 0, summed per thread); then s_poison holds the
// staged rows' poison words.
__device__ __forceinline__ bool stage_rows(float2* staged,
                                           const float* __restrict__ fdy,
                                           const float* __restrict__ fdx,
                                           int H, int W, int h4,
                                           unsigned* s_poison) {
  constexpr int kWarps = kStageThreads / 32;
  const int lane = threadIdx.x % 32;
  const int group = (threadIdx.x / 32 + kWarps - 1 - kHelper) % kWarps;
  const int w4s = W / 4;
  const int pitch = W + 1;
  const float4* gy = reinterpret_cast<const float4*>(fdy);
  const float4* gx = reinterpret_cast<const float4*>(fdx);
  float zero[kStageRows] = {};  // sums of 0 * value: NaN past a non-finite
  for (int r0 = group * kStageRows; r0 <= h4; r0 += kWarps * kStageRows) {
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
        float z = zero[k];
        z = __fmaf_rn(vy[k].x, 0.f, z);
        z = __fmaf_rn(vy[k].y, 0.f, z);
        z = __fmaf_rn(vy[k].z, 0.f, z);
        z = __fmaf_rn(vy[k].w, 0.f, z);
        z = __fmaf_rn(vx[k].x, 0.f, z);
        z = __fmaf_rn(vx[k].y, 0.f, z);
        z = __fmaf_rn(vx[k].z, 0.f, z);
        zero[k] = __fmaf_rn(vx[k].w, 0.f, z);
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
  float z = 0.f;
#pragma unroll
  for (int k = 0; k < kStageRows; ++k) z = __fadd_rn(z, zero[k]);
  if (!__syncthreads_or(isnan(z))) return false;
  // a non-finite value: the staged rows' poison words, by every thread
  if (threadIdx.x < kPoisonWords) s_poison[threadIdx.x] = 0;
  __syncthreads();
  const int rows = min(h4, H - 1) + 1;
  for (int i = threadIdx.x; i < rows * W; i += blockDim.x) {
    const float2 v = staged[i / W * pitch + i % W];
    if (!finite(v.x)) note(s_poison, v.x, 0, i / W, i % W, H, W);
    if (!finite(v.y)) note(s_poison, v.y, 1, i / W, i % W, H, W);
  }
  __syncthreads();
  return true;
}

template <bool kStaged>
__global__ void __launch_bounds__(kStaged ? kStageThreads : kL1Threads)
advect_kernel(const float* __restrict__ dp, int* __restrict__ cent,
              uint8_t* __restrict__ basin, unsigned* scratch, int H, int W,
              int h4, int w4, int iterations, float thres) {
  extern __shared__ float2 staged[];
  __shared__ unsigned s_poison[kPoisonWords];
  const int HW = H * W;
  const float* fdy = dp;
  const float* fdx = dp + HW;
  const bool helper = threadIdx.x / 32 == kHelper;
  unsigned par = 0;
  if (helper) par = helper_scan<kStaged>(dp, H, W, h4, scratch);
  bool bad = false;
  if (kStaged) bad = stage_rows(staged, fdy, fdx, H, W, h4, s_poison);
  if (helper) {
    helper_wait(scratch, par, bad, s_poison);
    return;
  }
  if (threadIdx.x >= kThreads) return;
  Taps<kStaged> taps;
  if constexpr (kStaged) {
    const unsigned pitch8 = 8u * (unsigned)(W + 1);
    const unsigned bias0 = 0u - kMagicBits * (pitch8 + 8u);
    taps = {staged, pitch8, bias0, bias0 + pitch8};
  } else {
    taps = {fdy, fdx, H, W};
  }
  const float ymax = (float)(h4 - 1);
  const float xmax = (float)(w4 - 1);
  const int blocks = (HW + kThreads - 1) / kThreads;
  bool poisoned = false;
  for (int b = blockIdx.x; b < blocks; b += gridDim.x) {
    const int p = b * kThreads + threadIdx.x;
    const int row = p / W;
    const int col = p % W;
    float y = fminf((float)row, ymax);
    float x = fminf((float)col, xmax);
    int left = p < HW ? iterations : 0;
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
    if (b == blockIdx.x) {  // the first block: what every CTA found
      irn::hopper::named_sync(kBarrier, kThreads + 32);
      poisoned = (s_poison[0] | s_poison[5]) != 0;
    }
    if (p >= HW) break;
    if (poisoned) {
      y = fminf((float)row, ymax);
      x = fminf((float)col, xmax);
      advect_poisoned(taps, s_poison, H, W, y, x, ymax, xmax, iterations);
    }
    cent[p] = isnan(y) ? 0 : (int)rintf(y);
    cent[HW + p] = isnan(x) ? 0 : (int)rintf(x);
    const float dy = __ldg(fdy + p);
    const float dx = __ldg(fdx + p);
    basin[p] = __fsqrt_rn(__fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx))) <
               thres;
  }
}

std::atomic<unsigned long long> smem_set{0};

// CTAs of advect_kernel<kStaged> that the current device holds at once (the
// staged instance at its largest shared memory); cached per device.
template <bool kStaged>
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
      &per_sm, advect_kernel<kStaged>, kStaged ? kStageThreads : kL1Threads,
      kStaged ? kSmemMax : 0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *resident = per_sm * sms;
  if (*resident < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) cache[dev].store(*resident);
  return cudaSuccess;
}

template <bool kStaged>
int launch(const float* dp, int* cent, uint8_t* basin, unsigned* scratch,
           int H, int W, int h4, int w4, int iterations, float thres,
           int bytes, cudaStream_t s, int* launched) {
  if (kStaged) {
    cudaError_t e = irn::allow_smem(advect_kernel<true>, smem_set, kSmemMax);
    if (e != cudaSuccess) return (int)e;
  }
  int resident = 0;
  cudaError_t e = resident_ctas<kStaged>(&resident);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(std::min(resident, (H * W + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kStaged ? kStageThreads : kL1Threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, advect_kernel<kStaged>, dp, cent, basin,
                         scratch, H, W, h4, w4, iterations, thres);
  if (e != cudaSuccess) {
    cudaGetLastError();  // cleared, so that the next launch does not read it
    return (int)e;
  }
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

}  // namespace

// Bytes of shared memory the staged instance takes for a grid of width W
// at extent height h4 ([h4 + 1, W + 1] float2), or 0 when the grid takes
// the __ldg instance (the rows do not fit, or W is not a multiple of 4):
// irn_advect's choice, the one statement of the rule.
IRN_API int irn_advect_staged_bytes(int W, int h4) {
  const long long bytes = (long long)(h4 + 1) * (W + 1) * sizeof(float2);
  return W % 4 == 0 && bytes <= kSmemMax ? (int)bytes : 0;
}

// uint32 words of irn_advect's scratch (zero before the first launch on a
// stream; each launch leaves it ready for the next).
IRN_API int irn_advect_scratch_words() { return kScratchWords; }

// dp: [2, H, W] f32; cent: [2, H, W] int32; basin: [H, W] bool (uint8);
// scratch: irn_advect_scratch_words() uint32, 8-byte aligned. One
// cooperative launch.
IRN_API int irn_advect(const float* dp, int* cent, uint8_t* basin,
                       unsigned* scratch, int H, int W, int h4, int w4,
                       int iterations, float thres, void* stream,
                       int* launched) {
  if (H < 1 || W < 1 || h4 < 1 || h4 > H || w4 < 1 || w4 > W ||
      iterations < 0 || (long long)H * W >= (1LL << 29) || H > kMaxSide ||
      W > kMaxSide || !scratch || reinterpret_cast<uintptr_t>(scratch) % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = irn_advect_staged_bytes(W, h4);
  if (bytes && reinterpret_cast<uintptr_t>(dp) % 16)
    return (int)cudaErrorInvalidValue;  // the staging's 16-byte loads
  if (bytes)
    return launch<true>(dp, cent, basin, scratch, H, W, h4, w4, iterations,
                        thres, bytes, s, launched);
  return launch<false>(dp, cent, basin, scratch, H, W, h4, w4, iterations,
                       thres, 0, s, launched);
}
