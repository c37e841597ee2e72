// K16 irn_loss: train_irn's loss side after the path max, forward (the
// five masked sums, the three label counts and the weighted terms, two
// launches) and backward (the cotangents of the path max's output and of
// the displacement field, one launch).
//
// Replaces: irn_tpu/ops/affinity.py affinity_labels_2d (:171, over
// label_pair_views :156), pair_displacement (:241), everything of
// affinity_displacement_loss_maps (:274) after path_affinity, and
// irn_total_loss (:297), with XLA's autodiff of them: one fused XLA program
// inside the jitted train step on the TPU. Eager PyTorch builds three f32
// label masks and the two log maps [B, n_pairs, P], a stack of the
// n_pairs shifted displacement views and four [B, 2, n_pairs, P] maps
// (3 GB at batch 32, crop 512, radius 10, P = 119 x 110) and keeps most of
// them for its backward.
//
// Geometry (as path_max.cu): labels [B, H, W] int32 (0 background, 1..20
// classes, >= n_classes ignored), dp [B, 2, H, W] f32 (dy, dx); the window
// is ch = H - rf rows by cw = W - 2 rf columns; window pixel (y, x) is grid
// pixel (y, rf + x), the source of every pair; pair p's destination is
// grid pixel (y + dy_p, rf + x + dx_p), 0 <= dy_p <= rf, |dx_p| <= rf.
// maxed [B, n_pairs, ch, cw] f32 is K13a's output. The pairs' (dy, dx)
// live in constant memory, filled on the stream before each launch.
//
// Per element (pair p, window pixel e), all f32 with round to nearest,
// every operation written with __f*_rn in the order of the twins in
// ops/affinity.py (nothing left to contraction):
//   valid = ls < n_classes & ld < n_classes, pos = ls == ld & valid,
//   bg = pos & ls == 0, fg = pos & ls > 0, neg = ls != ld & valid, each a
//   0 / 1 float that multiplies (never a branch: a NaN in maxed or dp
//   reaches the sums as JAX's products carry it);
//   a = 1 - m, pa = -logf(a + 1e-5), na = -logf(1.00001 - a) (each constant
//   the f32 rounding of the double, as torch and JAX take a Python float);
//   pair_c = dp_src,c - dp_dst,c.
// Forward, per window pixel over the pairs in order, from +0:
//   s0 += bg pa, s1 += fg pa, s2 += neg na,
//   s3 += fg |pair_0 - dy|, s3 += fg |pair_1 - dx|,
//   s4 += bg |pair_0|, s4 += bg |pair_1|,
// and the label counts n_bg, n_fg, n_neg (f32 sums of the masks, exact
// integers). Then in f64 with no atomics: each block sums its threads'
// eight values (the counts exact) by a shuffle-down tree in each warp
// (offsets 16, 8, 4, 2, 1) and its warps in order; a second launch of one block sums the block partials, thread t
// taking blocks t, t + 256, ... from +0, then the same tree. Its thread 0
// rounds each total to f32 once (the counts are exact integers below 2^53;
// an f32 sum of the masks would not be above 2^24) and forms
// irn_total_loss's terms with eps = 1e-5: bg_pos = s0 / (n_bg + eps),
// fg_pos = s1 / (n_fg + eps), pos = bg_pos / 2 + fg_pos / 2, neg = s2 /
// (n_neg + eps), dp_fg = s3 / (2 n_fg + eps), dp_bg = s4 / (2 n_bg + eps),
// total = (pos + neg) / 2 + (dp_fg + dp_bg) / 2. Out: loss f32 [total,
// pos, neg, dp_fg, dp_bg] and stats f64 [s0..s4, n_bg, n_fg, n_neg], on the
// device: the step makes no host sync.
// Backward: the cotangents g of loss and the saved stats give, per thread,
// G_pos = g_total / 2 + g_pos (and so for neg, dp_fg, dp_bg), k_bg =
// (G_pos / 2) / (n_bg + eps), k_fg = (G_pos / 2) / (n_fg + eps), k_neg =
// G_neg / (n_neg + eps), k_dfg = G_dp_fg / (2 n_fg + eps), k_dbg = G_dp_bg /
// (2 n_bg + eps); per element
//   d_maxed = (bg k_bg + fg k_fg) / (a + 1e-5) - neg k_neg / (1.00001 - a),
//   t_c = (fg k_dfg) sgn(pair_c - off_c) + (bg k_dbg) sgn(pair_c),
// with sgn(x) = x >= 0 ? 1 : -1, JAX's abs JVP select(x >= 0, g, -g)
// (jax/_src/lax/lax.py _abs_jvp_rule: +1 at 0, -1 at NaN); d_dp at grid
// pixel q gathers, pairs ascending, + t of (p, q) where q is the source,
// then - t of (p, q - off_p) where q is the destination, from +0.
//
// Design. Forward: a block of 256 threads owns 512 consecutive pixels of
// one image's flattened window (the last block of an image fewer), two
// adjacent pixels per thread, so no lane idles at any window width. The
// block stages the grid rows its pixels and their destinations reach as
// one float4 per pixel (dp_0, dp_1, the label's bits, 0), so a
// destination is one 16-byte shared load (a window so narrow that the
// rows do not fit reads them through L1 instead). A thread keeps its two
// sources' dp and label flags in registers; per pair it reads the table
// entry once for both pixels and maxed of both as one 8-byte load (when
// the plane is even: every pixel pair then starts on 8 bytes; else two
// 4-byte loads). The masks come from one label comparison and selects of
// the source's precomputed 0 / 1 flags, the label counts as exact f32
// sums of the masks (at most n_pairs per pixel). Each pixel's five sums
// stay its own, in pair order. The f64 tree follows the threads: per
// thread f64(pixel 0) + f64(pixel 1), then the warp's shuffle-down tree and
// the warps in order; the second launch as before.
// Backward: one thread per grid pixel, blocks of 32 x 8, the labels and
// both dp channels of the block's tile and its halo (rf rows and columns
// on every side: a pixel is a destination of the pixels above it) staged
// in shared memory once; per pair the thread writes d_maxed where it is
// the source and gathers d_dp, + t as source then - t as destination. An
// element with a set positive mask has dneg = 0 and one with the negative
// mask dpos = 0: a zero dividend, which sends __fdiv_rn to its slow path;
// quotient() gives such lanes the signed zero of IEEE division without
// that path (the other dividend is divided as before).
// Bound on this card: bytes. At the default (B 32, 128 x 128 grid, radius
// 10: 152 pairs, P = 13,090) the forward reads maxed (254.7 MB), dp (4.2
// MB) and the labels (2.1 MB): ~0.078 ms at 3.35 TB/s; the backward reads
// the same and writes d_maxed and d_dp: ~0.155 ms. Both are issue-bound:
// the forward's pair loop is 91.5 SASS instructions per element, ~48 of
// them its two logf (libdevice's polynomial and special-input checks).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/probe_train_step.py, the
// design before this one in the same call, in turns): the forward's two
// launches 0.2837 -> 0.2479 ms of device time, the backward 0.5990 ->
// 0.4619 ms; chip_smoke.py: 64-80 registers in the forward's variants, 47
// in the backward, no spill. Tried and dropped, slower in an experiment
// harness that is not kept: a backward that computes each term once per
// block into shared memory and gathers (152 block barriers per launch,
// the terms' loads through L1), two pixels per backward thread, and a
// logf without libdevice's special-input checks for normal inputs behind
// a warp branch (bit-equal to logf on all 2^31 - 2^24 normal floats,
// checked on the card, yet slower).

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxPairs = 1024;
constexpr int kValues = 8;  // five sums, three counts
constexpr int kSmemMax = 232448;
// forward: 256 threads, two adjacent window pixels each
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdPixels = 2 * kFwdThreads;
// the second launch: one block sums the block partials
constexpr int kTotalThreads = 256;
// backward: 32 x 8 threads, one grid pixel each
constexpr int kBwdLanes = 32;
constexpr int kBwdRows = 8;
constexpr int kBwdThreads = kBwdLanes * kBwdRows;
__constant__ int2 c_off[kMaxPairs];

constexpr float kEps = static_cast<float>(1e-5);
constexpr float kOnePlus = static_cast<float>(1.0 + 1e-5);

__device__ __forceinline__ float sgn(float x) { return x >= 0.f ? 1.f : -1.f; }

// A source pixel's label and its 0 / 1 flags: the masks of a pair with
// destination label ld are bg = (ld == ls) * bgv, fg = (ld == ls) * fgv,
// neg = (ld != ls and ld < n_classes) * vsv -- affinity_labels_2d's
// valid = ls < n_classes & ld < n_classes with ls == ld, ls == 0, ls > 0.
struct Source {
  int ls;
  float bgv, fgv, vsv;
};

__device__ __forceinline__ Source source(int ls, int n_classes) {
  const bool vs = ls < n_classes;
  return Source{ls, vs && ls == 0 ? 1.f : 0.f, vs && ls > 0 ? 1.f : 0.f,
                vs ? 1.f : 0.f};
}

struct Masks {
  float bg, fg, neg;
};

__device__ __forceinline__ Masks masks(const Source& s, int ld,
                                       int n_classes) {
  const bool eq = ld == s.ls;
  return Masks{eq ? s.bgv : 0.f, eq ? s.fgv : 0.f,
               !eq && ld < n_classes ? s.vsv : 0.f};
}

// Sums v[0..7] over the block in f64: a shuffle-down tree in each warp,
// then the warps in order; thread 0 returns with the totals in v.
template <int kWarps>
__device__ __forceinline__ void block_sum(double* v, double* red) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < kValues; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v[k] = __dadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kValues; ++k) red[warp * kValues + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kValues; ++k) {
      double acc = red[k];
      for (int w = 1; w < kWarps; ++w)
        acc = __dadd_rn(acc, red[w * kValues + k]);
      v[k] = acc;
    }
  }
}

// The grid rows a forward block reads: its window rows (window row y is
// grid row y) and rf below them.
__host__ __device__ __forceinline__ int fwd_first_row(int blk, int cw) {
  return blk * kFwdPixels / cw;
}

__host__ __device__ __forceinline__ int fwd_rows(int blk, int cw, int plane,
                                                 int rf) {
  const int last = (min((blk + 1) * kFwdPixels, plane) - 1) / cw;
  return last - fwd_first_row(blk, cw) + 1 + rf;
}

// Per grid pixel of a staged row: (dp_0, dp_1, the label's bits, 0).
__device__ __forceinline__ float4 pixel_value(const int* lab, const float* d0,
                                              const float* d1, int at) {
  return make_float4(__ldg(d0 + at), __ldg(d1 + at),
                     __int_as_float(__ldg(lab + at)), 0.f);
}

// kVec: the window plane is even, so each thread's pixel pair starts on 8
// bytes of maxed. kStaged: the block's grid rows (labels and dp) are staged
// in shared memory as float4 per pixel (dynamic, fwd_rows x W x 16 bytes),
// else read through L1 (windows too narrow for that to fit).
template <bool kVec, bool kStaged>
__global__ void __launch_bounds__(kFwdThreads)
irn_loss_sums_kernel(const float* __restrict__ maxed,
                     const float* __restrict__ dp,
                     const int* __restrict__ labels,
                     double* __restrict__ partials, int H, int W, int rf,
                     int n_pairs, int n_classes) {
  __shared__ double red[kFwdWarps * kValues];
  extern __shared__ float4 staged[];
  const int cw = W - 2 * rf;
  const int plane = (H - rf) * cw;
  const int b = blockIdx.y;
  const int e0 = blockIdx.x * kFwdPixels + 2 * threadIdx.x;
  const size_t gp = (size_t)H * W;
  const int* lab = labels + b * gp;
  const float* d0 = dp + 2 * b * gp;
  const float* d1 = d0 + gp;
  // grid pixel at (relative to row0's start when staged) -> its value
  const int row0 = fwd_first_row(blockIdx.x, cw);
  if constexpr (kStaged) {
    const int n_st = fwd_rows(blockIdx.x, cw, plane, rf) * W;
    const int base = row0 * W;
    for (int i = threadIdx.x; i < n_st; i += kFwdThreads)
      staged[i] = pixel_value(lab, d0, d1, base + i);
    __syncthreads();
  }
  auto value = [&](int at) {
    if constexpr (kStaged)
      return staged[at];
    else
      return pixel_value(lab, d0, d1, at);
  };
  const int off0 = kStaged ? row0 * W : 0;
  float s[2][5] = {};
  float cnt[2][3] = {};
  if (e0 < plane) {
    const bool two = e0 + 1 < plane;
    int at[2];
    Source src[2];
    float sd0[2], sd1[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = j == 0 || two ? e0 + j : e0;
      const int y = e / cw;
      at[j] = y * W + rf + (e - y * cw) - off0;
      const float4 v = value(at[j]);
      src[j] = source(__float_as_int(v.z), n_classes);
      sd0[j] = v.x;
      sd1[j] = v.y;
    }
    const float* mp = maxed + (size_t)b * n_pairs * plane + e0;
#pragma unroll 4
    for (int p = 0; p < n_pairs; ++p, mp += plane) {
      const int2 o = c_off[p];
      const int shift = o.x * W + o.y;
      const float fdy = (float)o.x;
      const float fdx = (float)o.y;
      float m[2];
      if constexpr (kVec) {
        const float2 v = __ldg(reinterpret_cast<const float2*>(mp));
        m[0] = v.x;
        m[1] = v.y;
      } else {
        m[0] = __ldg(mp);
        m[1] = two ? __ldg(mp + 1) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j == 1 && !two) break;
        const float4 dv = value(at[j] + shift);
        const Masks k = masks(src[j], __float_as_int(dv.z), n_classes);
        const float a = __fsub_rn(1.f, m[j]);
        const float pa = -logf(__fadd_rn(a, kEps));
        const float na = -logf(__fsub_rn(kOnePlus, a));
        s[j][0] = __fadd_rn(s[j][0], __fmul_rn(k.bg, pa));
        s[j][1] = __fadd_rn(s[j][1], __fmul_rn(k.fg, pa));
        s[j][2] = __fadd_rn(s[j][2], __fmul_rn(k.neg, na));
        const float q0 = __fsub_rn(sd0[j], dv.x);
        const float q1 = __fsub_rn(sd1[j], dv.y);
        s[j][3] = __fadd_rn(s[j][3], __fmul_rn(k.fg, fabsf(__fsub_rn(q0, fdy))));
        s[j][3] = __fadd_rn(s[j][3], __fmul_rn(k.fg, fabsf(__fsub_rn(q1, fdx))));
        s[j][4] = __fadd_rn(s[j][4], __fmul_rn(k.bg, fabsf(q0)));
        s[j][4] = __fadd_rn(s[j][4], __fmul_rn(k.bg, fabsf(q1)));
        cnt[j][0] = __fadd_rn(cnt[j][0], k.bg);
        cnt[j][1] = __fadd_rn(cnt[j][1], k.fg);
        cnt[j][2] = __fadd_rn(cnt[j][2], k.neg);
      }
    }
  }
  double v[kValues];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    v[k] = __dadd_rn((double)s[0][k], (double)s[1][k]);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    v[5 + k] = __dadd_rn((double)cnt[0][k], (double)cnt[1][k]);
  block_sum<kFwdWarps>(v, red);
  if (threadIdx.x == 0) {
    const size_t blk = blockIdx.x + (size_t)gridDim.x * b;
#pragma unroll
    for (int k = 0; k < kValues; ++k) partials[blk * kValues + k] = v[k];
  }
}

// the five loss values from the eight f64 totals
__device__ __forceinline__ void terms(const double* tot, float* loss) {
  const float n_bg = __double2float_rn(tot[5]);
  const float n_fg = __double2float_rn(tot[6]);
  const float n_neg = __double2float_rn(tot[7]);
  const float bg_pos =
      __fdiv_rn(__double2float_rn(tot[0]), __fadd_rn(n_bg, kEps));
  const float fg_pos =
      __fdiv_rn(__double2float_rn(tot[1]), __fadd_rn(n_fg, kEps));
  const float pos = __fadd_rn(__fmul_rn(bg_pos, 0.5f), __fmul_rn(fg_pos, 0.5f));
  const float neg =
      __fdiv_rn(__double2float_rn(tot[2]), __fadd_rn(n_neg, kEps));
  const float dp_fg = __fdiv_rn(__double2float_rn(tot[3]),
                                __fadd_rn(__fmul_rn(2.f, n_fg), kEps));
  const float dp_bg = __fdiv_rn(__double2float_rn(tot[4]),
                                __fadd_rn(__fmul_rn(2.f, n_bg), kEps));
  loss[0] = __fadd_rn(__fmul_rn(__fadd_rn(pos, neg), 0.5f),
                      __fmul_rn(__fadd_rn(dp_fg, dp_bg), 0.5f));
  loss[1] = pos;
  loss[2] = neg;
  loss[3] = dp_fg;
  loss[4] = dp_bg;
}

__global__ void __launch_bounds__(kTotalThreads)
irn_loss_total_kernel(const double* __restrict__ partials, int n_blocks,
                      float* __restrict__ loss, double* __restrict__ stats) {
  __shared__ double red[kTotalThreads / 32 * kValues];
  double v[kValues];
#pragma unroll
  for (int k = 0; k < kValues; ++k) v[k] = 0.0;
  for (int i = threadIdx.x; i < n_blocks; i += kTotalThreads) {
#pragma unroll
    for (int k = 0; k < kValues; ++k)
      v[k] = __dadd_rn(v[k], partials[(size_t)i * kValues + k]);
  }
  block_sum<kTotalThreads / 32>(v, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kValues; ++k) stats[k] = v[k];
    terms(v, loss);
  }
}

// RN(a / b) as __fdiv_rn gives it. A zero dividend over a finite nonzero
// divisor is the signed zero of IEEE division; such lanes divide 1 instead
// and take that zero, so the division of each element's zero mask term
// (dpos or dneg is 0 wherever the other mask is set) skips the division's
// slow path, which a zero dividend takes, without a branch.
__device__ __forceinline__ float quotient(float a, float b) {
  const bool zero = a == 0.f && b == b && b != 0.f;
  const float q = __fdiv_rn(zero ? 1.f : a, b);
  return zero ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                               0x80000000)
              : q;
}

// Stages labels and dp rows [gy0, gy0 + th) x columns [gx0, gx0 + tw) of
// image b (zero outside the grid: read only by pixels that are no pair's
// source or destination).
__device__ __forceinline__ void stage_tile(const int* __restrict__ labels,
                                           const float* __restrict__ dp,
                                           int* lab, float* d0, float* d1,
                                           int b, int H, int W, int gy0,
                                           int gx0, int th, int tw) {
  const size_t plane = (size_t)H * W;
  const int* l = labels + (size_t)b * plane;
  const float* p0 = dp + (size_t)b * 2 * plane;
  const float* p1 = p0 + plane;
  for (int i = threadIdx.x; i < th * tw; i += kBwdThreads) {
    const int gy = gy0 + i / tw;
    const int gx = gx0 + i % tw;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t at = in ? (size_t)gy * W + gx : 0;
    lab[i] = in ? __ldg(l + at) : 0;
    d0[i] = in ? __ldg(p0 + at) : 0.f;
    d1[i] = in ? __ldg(p1 + at) : 0.f;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
irn_loss_bwd_kernel(const float* __restrict__ maxed,
                    const float* __restrict__ dp,
                    const int* __restrict__ labels,
                    const float* __restrict__ g,
                    const double* __restrict__ stats,
                    float* __restrict__ d_maxed, float* __restrict__ d_dp,
                    int H, int W, int rf, int n_pairs, int n_classes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const int th = kBwdRows + 2 * rf;
  const int tw = kBwdLanes + 2 * rf;
  int* lab = reinterpret_cast<int*>(smem_raw);
  float* d0 = reinterpret_cast<float*>(lab + th * tw);
  float* d1 = d0 + th * tw;
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * kBwdLanes;  // grid columns
  const int Y0 = blockIdx.y * kBwdRows;
  const int tx = threadIdx.x % kBwdLanes;
  const int ty = threadIdx.x / kBwdLanes;
  stage_tile(labels, dp, lab, d0, d1, b, H, W, Y0 - rf, X0 - rf, th, tw);
  // the coefficients, the same in every thread
  const float half_g = __fmul_rn(__ldg(g), 0.5f);
  const float n_bg = __double2float_rn(__ldg(stats + 5));
  const float n_fg = __double2float_rn(__ldg(stats + 6));
  const float n_neg = __double2float_rn(__ldg(stats + 7));
  const float g_pos = __fmul_rn(__fadd_rn(half_g, __ldg(g + 1)), 0.5f);
  const float k_bg = __fdiv_rn(g_pos, __fadd_rn(n_bg, kEps));
  const float k_fg = __fdiv_rn(g_pos, __fadd_rn(n_fg, kEps));
  const float k_neg =
      __fdiv_rn(__fadd_rn(half_g, __ldg(g + 2)), __fadd_rn(n_neg, kEps));
  const float k_dfg = __fdiv_rn(__fadd_rn(half_g, __ldg(g + 3)),
                                __fadd_rn(__fmul_rn(2.f, n_fg), kEps));
  const float k_dbg = __fdiv_rn(__fadd_rn(half_g, __ldg(g + 4)),
                                __fadd_rn(__fmul_rn(2.f, n_bg), kEps));
  __syncthreads();
  const int X = X0 + tx;
  const int Y = Y0 + ty;
  if (X >= W || Y >= H) return;
  const int me = (ty + rf) * tw + tx + rf;
  const Source sq = source(lab[me], n_classes);
  const float q0 = d0[me];
  const float q1 = d1[me];
  const bool src = Y < ch && X >= rf && X < rf + cw;
  const size_t plane = (size_t)ch * cw;
  const float* mp = maxed + (size_t)b * n_pairs * plane + (size_t)Y * cw +
                    (X - rf);
  float* dmp = d_maxed + (mp - maxed);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 2
  for (int p = 0; p < n_pairs; ++p, mp += plane, dmp += plane) {
    const int2 o = c_off[p];
    const float dy = (float)o.x;
    const float dx = (float)o.y;
    const int shift = o.x * tw + o.y;
    if (src) {
      // q is pair p's source: its d_maxed and + t
      const int at = me + shift;
      const Masks k = masks(sq, lab[at], n_classes);
      const float a = __fsub_rn(1.f, __ldg(mp));
      const float dpos =
          __fadd_rn(__fmul_rn(k.bg, k_bg), __fmul_rn(k.fg, k_fg));
      const float dneg = __fmul_rn(k.neg, k_neg);
      *dmp = __fsub_rn(quotient(dpos, __fadd_rn(a, kEps)),
                       quotient(dneg, __fsub_rn(kOnePlus, a)));
      const float uf = __fmul_rn(k.fg, k_dfg);
      const float ub = __fmul_rn(k.bg, k_dbg);
      const float p0 = __fsub_rn(q0, d0[at]);
      const float p1 = __fsub_rn(q1, d1[at]);
      acc0 = __fadd_rn(acc0, __fadd_rn(__fmul_rn(uf, sgn(__fsub_rn(p0, dy))),
                                       __fmul_rn(ub, sgn(p0))));
      acc1 = __fadd_rn(acc1, __fadd_rn(__fmul_rn(uf, sgn(__fsub_rn(p1, dx))),
                                       __fmul_rn(ub, sgn(p1))));
    }
    const int sy = Y - o.x;
    const int sx = X - o.y;
    if (sy >= 0 && sy < ch && sx >= rf && sx < rf + cw) {
      // q is pair p's destination: - t of its source's element
      const int at = me - shift;
      const Masks k = masks(source(lab[at], n_classes), sq.ls, n_classes);
      const float uf = __fmul_rn(k.fg, k_dfg);
      const float ub = __fmul_rn(k.bg, k_dbg);
      const float p0 = __fsub_rn(d0[at], q0);
      const float p1 = __fsub_rn(d1[at], q1);
      acc0 = __fsub_rn(acc0, __fadd_rn(__fmul_rn(uf, sgn(__fsub_rn(p0, dy))),
                                       __fmul_rn(ub, sgn(p0))));
      acc1 = __fsub_rn(acc1, __fadd_rn(__fmul_rn(uf, sgn(__fsub_rn(p1, dx))),
                                       __fmul_rn(ub, sgn(p1))));
    }
  }
  const size_t gp = (size_t)H * W;
  float* out = d_dp + (size_t)b * 2 * gp + (size_t)Y * W + X;
  out[0] = acc0;
  out[gp] = acc1;
}

bool bad_geometry(int B, int H, int W, int rf, int n_pairs) {
  return B < 1 || rf < 0 || rf > 31 || H - rf < 1 || W - 2 * rf < 1 ||
         n_pairs < 1 || n_pairs > kMaxPairs || B > 65535;
}

// per device, whether a kernel's shared-memory limit is raised
std::atomic<unsigned long long> fwd_smem_set[4];
std::atomic<unsigned long long> bwd_smem_set{0};

}  // namespace

// maxed [B, n_pairs, H - rf, W - 2 rf] f32, dp [B, 2, H, W] f32, labels
// [B, H, W] int32, offsets int32 [n_pairs, 2] (dy, dx) on the device ->
// loss f32 [5] and stats f64 [8]; partials f64 [n_partials, 8] scratch,
// n_partials >= the blocks of the first launch (ceil(P / 512) per image,
// P = (H - rf) (W - 2 rf)). Two launches.
IRN_API int irn_loss_fwd(const float* maxed, const float* dp,
                         const int* labels, const int* offsets,
                         double* partials, float* loss, double* stats, int B,
                         int H, int W, int rf, int n_pairs, int n_classes,
                         int n_partials, cudaStream_t stream, int* launched) {
  if (bad_geometry(B, H, W, rf, n_pairs)) return (int)cudaErrorInvalidValue;
  const int plane = (H - rf) * (W - 2 * rf);
  const dim3 grid((plane + kFwdPixels - 1) / kFwdPixels, B);
  const long long n_blocks = (long long)grid.x * grid.y;
  if (n_blocks > n_partials) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_off, offsets, 8 * n_pairs, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  int rows = 0;
  for (int blk = 0; blk < (int)grid.x; ++blk)
    rows = max(rows, fwd_rows(blk, W - 2 * rf, plane, rf));
  const int staged = rows * W * (int)sizeof(float4);
  const bool vec =
      plane % 2 == 0 && reinterpret_cast<uintptr_t>(maxed) % 8 == 0;
  const bool st = staged <= kSmemMax - 1024;
  auto kernel = vec ? (st ? irn_loss_sums_kernel<true, true>
                          : irn_loss_sums_kernel<true, false>)
                    : (st ? irn_loss_sums_kernel<false, true>
                          : irn_loss_sums_kernel<false, false>);
  e = irn::allow_smem(kernel, fwd_smem_set[2 * vec + st], kSmemMax - 1024);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kFwdThreads, st ? staged : 0, stream>>>(
      maxed, dp, labels, partials, H, W, rf, n_pairs, n_classes);
  IRN_CHECK_LAUNCH(launched);
  irn_loss_total_kernel<<<1, kTotalThreads, 0, stream>>>(
      partials, (int)n_blocks, loss, stats);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// g f32 [5] (the cotangents of loss), stats f64 [8] of the forward, and
// the forward's inputs -> d_maxed [B, n_pairs, H - rf, W - 2 rf] and d_dp
// [B, 2, H, W] f32, every element written. One launch.
IRN_API int irn_loss_bwd(const float* maxed, const float* dp,
                         const int* labels, const int* offsets,
                         const float* g, const double* stats, float* d_maxed,
                         float* d_dp, int B, int H, int W, int rf,
                         int n_pairs, int n_classes, cudaStream_t stream,
                         int* launched) {
  if (bad_geometry(B, H, W, rf, n_pairs)) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kBwdLanes - 1) / kBwdLanes,
                  (H + kBwdRows - 1) / kBwdRows, B);
  const int smem = 12 * (kBwdRows + 2 * rf) * (kBwdLanes + 2 * rf);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_off, offsets, 8 * n_pairs, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = irn::allow_smem(irn_loss_bwd_kernel, bwd_smem_set, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  irn_loss_bwd_kernel<<<grid, kBwdThreads, smem, stream>>>(
      maxed, dp, labels, g, stats, d_maxed, d_dp, H, W, rf, n_pairs,
      n_classes);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
