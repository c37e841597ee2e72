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
// Forward, per thread (one window pixel) over the pairs in order, from +0:
//   s0 += bg pa, s1 += fg pa, s2 += neg na,
//   s3 += fg |pair_0 - dy|, s3 += fg |pair_1 - dx|,
//   s4 += bg |pair_0|, s4 += bg |pair_1|,
// and the label counts n_bg, n_fg, n_neg as integers. Then in f64 with no
// atomics: each block sums its threads' eight values (the counts exact) by
// a shuffle-down tree in each warp (offsets 16, 8, 4, 2, 1) and its warps
// in order; a second launch of one block sums the block partials, thread t
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
// Design: one thread per pixel, blocks of 32 x 8, the labels and both dp
// channels of the block's tile and its halo staged in shared memory once
// (forward: rf rows below, rf columns each side; backward: rf rows and
// columns on every side, since a pixel is a destination of the pixels
// above it). Each warp reads and writes the pair's 32 consecutive maxed /
// d_maxed values (the forward's tile starts at window column 0, so its
// reads are aligned; the backward's at grid column 0, so its window rows
// start rf columns in). Bound on this card: bytes. At the default (B 32,
// 128 x 128 grid, radius 10: 152 pairs, P = 13,090) the forward reads
// maxed (254.7 MB), dp (4.2 MB) and the labels (2.1 MB): ~0.078 ms at 3.35
// TB/s; the backward reads the same and writes d_maxed and d_dp: ~0.155 ms.
// Two logf per element in the forward and two divisions in the backward
// bring the instruction time close to the byte time.

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxPairs = 1024;
constexpr int kLanes = 32;
constexpr int kRows = 8;
constexpr int kThreads = kLanes * kRows;
constexpr int kWarps = kThreads / 32;
constexpr int kValues = 8;  // five sums, three counts
constexpr int kSmemMax = 232448;
__constant__ int2 c_off[kMaxPairs];

constexpr float kEps = static_cast<float>(1e-5);
constexpr float kOnePlus = static_cast<float>(1.0 + 1e-5);

__device__ __forceinline__ float sgn(float x) { return x >= 0.f ? 1.f : -1.f; }

// the three label masks of one (source, destination) label pair, as 0 / 1
struct Masks {
  float bg, fg, neg;
};

__device__ __forceinline__ Masks masks(int ls, int ld, int n_classes) {
  const bool valid = ls < n_classes && ld < n_classes;
  const bool equal = ls == ld;
  Masks m;
  m.bg = (equal && valid && ls == 0) ? 1.f : 0.f;
  m.fg = (equal && valid && ls > 0) ? 1.f : 0.f;
  m.neg = (!equal && valid) ? 1.f : 0.f;
  return m;
}

// Sums v[0..7] over the block in f64: a shuffle-down tree in each warp,
// then the warps in order; thread 0 returns with the totals in v.
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

// Stages labels and dp rows [gy0, gy0 + th) x columns [gx0, gx0 + tw) of
// image b (zero outside the grid: read only by pixels that are no pair's
// source or destination).
__device__ __forceinline__ void stage_tile(const int* __restrict__ labels,
                                           const float* __restrict__ dp,
                                           int* lab, float* d0, float* d1,
                                           int b, int H, int W, int gy0,
                                           int gx0, int th, int tw, int t) {
  const size_t plane = (size_t)H * W;
  const int* l = labels + (size_t)b * plane;
  const float* p0 = dp + (size_t)b * 2 * plane;
  const float* p1 = p0 + plane;
  for (int i = t; i < th * tw; i += kThreads) {
    const int gy = gy0 + i / tw;
    const int gx = gx0 + i % tw;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const size_t at = in ? (size_t)gy * W + gx : 0;
    lab[i] = in ? __ldg(l + at) : 0;
    d0[i] = in ? __ldg(p0 + at) : 0.f;
    d1[i] = in ? __ldg(p1 + at) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
irn_loss_sums_kernel(const float* __restrict__ maxed,
                     const float* __restrict__ dp,
                     const int* __restrict__ labels,
                     double* __restrict__ partials, int H, int W, int rf,
                     int n_pairs, int n_classes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const int th = kRows + rf;
  const int tw = kLanes + 2 * rf;
  double* red = reinterpret_cast<double*>(smem_raw);
  int* lab = reinterpret_cast<int*>(red + kWarps * kValues);
  float* d0 = reinterpret_cast<float*>(lab + th * tw);
  float* d1 = d0 + th * tw;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kLanes;  // window columns
  const int y0 = blockIdx.y * kRows;
  const int t = threadIdx.x;
  const int tx = t % kLanes;
  const int ty = t / kLanes;
  // window column x is grid column rf + x; the halo starts rf further left
  stage_tile(labels, dp, lab, d0, d1, b, H, W, y0, x0, th, tw, t);
  __syncthreads();
  const int x = x0 + tx;
  const int y = y0 + ty;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f, s4 = 0.f;
  int n0 = 0, n1 = 0, n2 = 0;
  if (x < cw && y < ch) {
    const int me = ty * tw + tx + rf;
    const int ls = lab[me];
    const float sd0 = d0[me];
    const float sd1 = d1[me];
    const size_t plane = (size_t)ch * cw;
    const float* mp = maxed + (size_t)b * n_pairs * plane + (size_t)y * cw + x;
#pragma unroll 4
    for (int p = 0; p < n_pairs; ++p) {
      const int2 o = c_off[p];
      const float m = __ldg(mp + p * plane);
      const int at = me + o.x * tw + o.y;
      const Masks k = masks(ls, lab[at], n_classes);
      const float a = __fsub_rn(1.f, m);
      const float pa = -logf(__fadd_rn(a, kEps));
      const float na = -logf(__fsub_rn(kOnePlus, a));
      s0 = __fadd_rn(s0, __fmul_rn(k.bg, pa));
      s1 = __fadd_rn(s1, __fmul_rn(k.fg, pa));
      s2 = __fadd_rn(s2, __fmul_rn(k.neg, na));
      const float q0 = __fsub_rn(sd0, d0[at]);
      const float q1 = __fsub_rn(sd1, d1[at]);
      s3 = __fadd_rn(s3, __fmul_rn(k.fg, fabsf(__fsub_rn(q0, (float)o.x))));
      s3 = __fadd_rn(s3, __fmul_rn(k.fg, fabsf(__fsub_rn(q1, (float)o.y))));
      s4 = __fadd_rn(s4, __fmul_rn(k.bg, fabsf(q0)));
      s4 = __fadd_rn(s4, __fmul_rn(k.bg, fabsf(q1)));
      n0 += k.bg != 0.f;
      n1 += k.fg != 0.f;
      n2 += k.neg != 0.f;
    }
  }
  double v[kValues] = {s0, s1, s2, s3, s4, (double)n0, (double)n1,
                       (double)n2};
  block_sum(v, red);
  if (t == 0) {
    const size_t blk =
        blockIdx.x + (size_t)gridDim.x * (blockIdx.y + (size_t)gridDim.y * b);
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

__global__ void __launch_bounds__(kThreads)
irn_loss_total_kernel(const double* __restrict__ partials, int n_blocks,
                      float* __restrict__ loss, double* __restrict__ stats) {
  __shared__ double red[kWarps * kValues];
  double v[kValues];
#pragma unroll
  for (int k = 0; k < kValues; ++k) v[k] = 0.0;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) {
#pragma unroll
    for (int k = 0; k < kValues; ++k)
      v[k] = __dadd_rn(v[k], partials[(size_t)i * kValues + k]);
  }
  block_sum(v, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kValues; ++k) stats[k] = v[k];
    terms(v, loss);
  }
}

__global__ void __launch_bounds__(kThreads)
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
  const int th = kRows + 2 * rf;
  const int tw = kLanes + 2 * rf;
  int* lab = reinterpret_cast<int*>(smem_raw);
  float* d0 = reinterpret_cast<float*>(lab + th * tw);
  float* d1 = d0 + th * tw;
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * kLanes;  // grid columns
  const int Y0 = blockIdx.y * kRows;
  const int t = threadIdx.x;
  const int tx = t % kLanes;
  const int ty = t / kLanes;
  stage_tile(labels, dp, lab, d0, d1, b, H, W, Y0 - rf, X0 - rf, th, tw, t);
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
  const int lq = lab[me];
  const float q0 = d0[me];
  const float q1 = d1[me];
  const bool src = Y < ch && X >= rf && X < rf + cw;
  const size_t plane = (size_t)ch * cw;
  const size_t e = (size_t)b * n_pairs * plane + (size_t)Y * cw + (X - rf);
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 2
  for (int p = 0; p < n_pairs; ++p) {
    const int2 o = c_off[p];
    const float dy = (float)o.x;
    const float dx = (float)o.y;
    if (src) {
      // q is pair p's source: its d_maxed and + t
      const int at = me + o.x * tw + o.y;
      const Masks k = masks(lq, lab[at], n_classes);
      const float m = __ldg(maxed + e + p * plane);
      const float a = __fsub_rn(1.f, m);
      const float dpos = __fadd_rn(__fmul_rn(k.bg, k_bg), __fmul_rn(k.fg, k_fg));
      const float dneg = __fmul_rn(k.neg, k_neg);
      d_maxed[e + p * plane] =
          __fsub_rn(__fdiv_rn(dpos, __fadd_rn(a, kEps)),
                    __fdiv_rn(dneg, __fsub_rn(kOnePlus, a)));
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
      const int at = me - o.x * tw - o.y;
      const Masks k = masks(lab[at], lq, n_classes);
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
         n_pairs < 1 || n_pairs > kMaxPairs;
}

// per device, whether a kernel's shared-memory limit is raised
std::atomic<unsigned long long> fwd_smem_set{0};
std::atomic<unsigned long long> bwd_smem_set{0};

}  // namespace

// maxed [B, n_pairs, H - rf, W - 2 rf] f32, dp [B, 2, H, W] f32, labels
// [B, H, W] int32, offsets int32 [n_pairs, 2] (dy, dx) on the device ->
// loss f32 [5] and stats f64 [8]; partials f64 [n_partials, 8] scratch,
// n_partials >= the blocks of the first launch. Two launches.
IRN_API int irn_loss_fwd(const float* maxed, const float* dp,
                         const int* labels, const int* offsets,
                         double* partials, float* loss, double* stats, int B,
                         int H, int W, int rf, int n_pairs, int n_classes,
                         int n_partials, cudaStream_t stream, int* launched) {
  if (bad_geometry(B, H, W, rf, n_pairs)) return (int)cudaErrorInvalidValue;
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const dim3 grid((cw + kLanes - 1) / kLanes, (ch + kRows - 1) / kRows, B);
  const long long n_blocks = (long long)grid.x * grid.y * grid.z;
  if (n_blocks > n_partials) return (int)cudaErrorInvalidValue;
  const int smem = 8 * kWarps * kValues +
                   12 * (kRows + rf) * (kLanes + 2 * rf);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_off, offsets, 8 * n_pairs, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = irn::allow_smem(irn_loss_sums_kernel, fwd_smem_set, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  irn_loss_sums_kernel<<<grid, kThreads, smem, stream>>>(
      maxed, dp, labels, partials, H, W, rf, n_pairs, n_classes);
  IRN_CHECK_LAUNCH(launched);
  irn_loss_total_kernel<<<1, kThreads, 0, stream>>>(partials, (int)n_blocks,
                                                    loss, stats);
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
  const int smem = 12 * (kRows + 2 * rf) * (kLanes + 2 * rf);
  cudaError_t e = cudaMemcpyToSymbolAsync(c_off, offsets, 8 * n_pairs, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = irn::allow_smem(irn_loss_bwd_kernel, bwd_smem_set, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kLanes - 1) / kLanes, (H + kRows - 1) / kRows, B);
  irn_loss_bwd_kernel<<<grid, kThreads, smem, stream>>>(
      maxed, dp, labels, g, stats, d_maxed, d_dp, H, W, rf, n_pairs,
      n_classes);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
