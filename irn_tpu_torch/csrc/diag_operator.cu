// K10 diag_operator: the default walk's transition operator T in diagonal
// form, built from the edge map in one launch and no other device
// operation.
//
// Replaces: irn_tpu/ops/random_walk.py band_values and build_diag_operator
// over irn_tpu/ops/affinity.py path_affinity (_path_max_unrolled): an XLA
// program on the TPU (the unrolled strict-> max chain over shifted window
// slices, ^beta, the column sums). Eager PyTorch runs it as some 400
// launches per image at radius 5 (one torch.where per path cell, 242 cells
// over 34 pairs, then the powers and 34 shift-add pairs).
//
// Geometry: the capped edge map [cap_h, cap_w] sits in the padded grid
// [ph, pw] = [cap_h + r, cap_w + 2r] at rows [0, cap_h), columns [r, r +
// cap_w); every other padded cell is 1.0. The window is rows [0, ph - rf),
// columns [rf, pw - rf); path cell (dy, dx) of window cell (Y, X) is the
// padded cell (Y + dy, X + dx), 0 <= dy <= rf, |dx| <= rf. Flat index j =
// Y * pw + X, padded with zeros to n_pad: the outputs cover the grid of
// ceil(n_pad / pw) rows of pw columns, its last row cut at n_pad.
//
//   w[k, j]  = pow_int(1 - max over pair k's cells, beta) at window cell
//              (Y, X), 0 at every other j of [0, n_pad)
//   inv[c]   = 1 / (1 + total), total = sum over k in pair order of
//              (w[k, c - d_k] + w[k, c]), w[k, c - d_k] = 0 for c < d_k
//
// with d_k = dy * pw + dx of pair k's destination (its first cell). Where
// X - dx leaves [0, pw), flat c - d_k wraps to the row above or below, at a
// column within rf of the grid's edge, outside the window: 0. So the
// neighbour term is the value at (Y - dy, X - dx) of a grid that is 0
// outside the window, with no wrap.
//
// Design (the staged schedule, radius 5 and every path set whose values
// fit a CTA's shared memory): a CTA owns a tile of kTileH x kTileW output
// cells and stages
//  - the padded edge over the tile's region and its cells' reach, (kTileH
//    + 2 rf) x (kTileW + 4 rf) floats, loaded once;
//  - w[k, .] of every pair over the region R = (kTileH + rf) x (kTileW +
//    2 rf): the tile and the halo that the neighbour terms c - d_k reach
//    (dy in [0, rf], dx in [-rf, rf]). Each value is computed once per CTA.
// Phase 1: a thread owns one position of R and one group of pairs. The
// pairs run depth first over shared path suffixes (affinity.PathTable
// .order, as K13a): a pair's max is its head cells' strict-> chain, then
// one strict-> compare against its suffix pair's chain, kept on a stack in
// shared memory. Every path ends with another's whole path at the same
// offsets, so radius 5 reads 110 head cells per position instead of 242.
// The depth-first order is cut into groups of about equal cost; a group
// that starts inside a tree first runs its ancestors' chains without
// storing them. Warps hold one group each (R padded to 32 positions), so
// the table words a warp reads are the same for all its lanes: a broadcast
// from the parameter bank. Values of the tile's own cells go to w as well.
// Phase 2: one thread per tile cell sums its 2 n_pairs terms in pair order
// from shared memory and writes inv.
// At the 96 x 128 bucket: 8 x 16 tiles, 117 CTAs of three groups of 288
// positions (864 threads), one per SM. Phase 1 is most of a launch and
// bound by its instruction count, so the powers are compiled for beta 10
// (the walk's default: four multiplies, not the run-time loop); other
// betas take the run-time loop. tools/probe_walk_variants.py times this
// on the card with globaltimer stamps per CTA: phase 1 ends ~7 us into
// a ~10 us launch; beta at run time took 12.4 us, two pair groups 11.5,
// one 16.8, and 4 x 32 tiles (130 CTAs) the same as 8 x 16.
// Chains start at max(destination, -inf), so a NaN never wins a strict >,
// and a pair whose destination is NaN takes that NaN: the plain chain's
// value (a NaN destination sticks; a later NaN never wins).
//
// The schedule (random_walk.diag_operator_schedule: groups, nodes, head
// cells as offsets into the staged edge, each pair's neighbour offset in R)
// arrives in a __grid_constant__ parameter struct built once per path set
// on the host: no table copy, one device operation per call.
//
// The direct schedule (path sets too large to stage, radius 9 and up): one
// thread per flat column computes its own w[k, c] and recomputes w[k, c -
// d_k] from the cell lists in global memory (affinity.PathTable.tables,
// read through the read-only cache, every lane the same word).
//
// Bit-equality: 1 - m, the powers (irn::pow_int: binary exponentiation,
// JAX's integer_pow order, beta a run-time integer >= 1), the sums and the
// division are written with __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn
// in the plain twin's order, so nvcc contracts nothing and the result is
// bit-equal to random_walk.build_diag_operator_plain on the card.
//
// Bound on this card: bytes. At the 96 x 128 bucket it reads the 48 KB edge
// map and writes w [34, 14336] f32 (1.95 MB) and inv (57 KB): ~2.07 MB /
// 3.35 TB/s = 0.6 us.

#include <atomic>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

// the staged schedule's tile and limits; random_walk.K10_* mirror them
constexpr int kTileH = 8;
constexpr int kTileW = 16;
constexpr int kThreadsMax = 1024;
constexpr int kWords = 960;  // with the other parameters under 4 KB
constexpr int kSmemMax = 232448;
constexpr int kHasSuffix = 1;
constexpr int kHasExtensions = 2;
constexpr int kStore = 4;

// the direct schedule
constexpr int kDirectThreads = 128;
constexpr int kMaxCells = 6144;
constexpr int kMaxPairs = 1024;

struct Grid {
  int cap_h, cap_w, r, rf, pw, wh, n_pad, n_pairs, beta;
};

// The staged schedule's table (random_walk.diag_operator_schedule):
// t[0] groups G, t[1] stack levels, t[2] nodes N, t[3] head cells,
// t[4 .. 4 + G] each group's first node, then N nodes of two words
// (pair | depth << 12 | flags << 20; head begin | head end << 16), the head
// cells (dy * (kTileW + 4 rf) + dx, offsets in the staged edge), and per
// pair dy * (kTileW + 2 rf) + dx (the neighbour's offset in R).
struct Schedule {
  int t[kWords];
};

// kBeta: the walk's beta at compile time (its default, 10: the powers
// unroll to four multiplies), or 0 for g.beta at run time.
template <int kBeta>
__global__ void __launch_bounds__(kThreadsMax)
diag_operator_staged(const float* __restrict__ edge, float* __restrict__ w,
                     float* __restrict__ inv, const Grid g,
                     const __grid_constant__ Schedule s, int nq_pad) {
  extern __shared__ float smem[];
  const int rf = g.rf;
  const int rw = kTileW + 2 * rf;  // R's width
  const int nq = (kTileH + rf) * rw;
  const int ew = kTileW + 4 * rf;  // the staged edge's width
  const int eh = kTileH + 2 * rf;
  const int groups = s.t[0];
  const int nt = groups * nq_pad;
  float* wv = smem;                       // [n_pairs][nq]
  float* et = wv + g.n_pairs * nq;        // [eh][ew]
  float* stk = et + eh * ew;              // [levels][nt]
  const int X0 = blockIdx.x * kTileW;
  const int Y0 = blockIdx.y * kTileH;
  const int t = threadIdx.x;

  // the padded edge: rows from Y0 - rf, columns from X0 - 2 rf
  for (int i = t; i < eh * ew; i += blockDim.x) {
    const int y = Y0 - rf + i / ew;
    const int x = X0 - 2 * rf + i % ew - g.r;
    et[i] = (y >= 0 && y < g.cap_h && x >= 0 && x < g.cap_w)
                ? __ldg(edge + (size_t)y * g.cap_w + x)
                : 1.f;
  }
  __syncthreads();

  const int grp = t / nq_pad;
  const int q = t % nq_pad;
  if (grp < groups && q < nq) {
    const int ry = q / rw;
    const int rx = q % rw;
    const int Y = Y0 - rf + ry;
    const int X = X0 - rf + rx;
    const bool inside = Y >= 0 && Y < g.wh && X >= rf && X < g.pw - rf;
    const int flat = Y * g.pw + X;
    const bool own = ry >= rf && rx >= rf && rx < rf + kTileW && X < g.pw &&
                     flat < g.n_pad;
    const float* e = et + ry * ew + rx + rf;
    const int* nodes = s.t + 5 + groups;
    const int* heads = nodes + 2 * s.t[2];
    const float neg_inf = __int_as_float(0xff800000);
    for (int i = s.t[4 + grp]; i < s.t[5 + grp]; ++i) {
      const int w0 = nodes[2 * i];
      const int w1 = nodes[2 * i + 1];
      const int pair = w0 & 0xfff;
      const int depth = (w0 >> 12) & 0xff;
      const int flags = w0 >> 20;
      float val = 0.f;
      if (inside) {
        const int b = w1 & 0xffff;
        const int end = w1 >> 16;
        const float v0 = e[heads[b]];
        float m = fmaxf(v0, neg_inf);
        for (int j = b + 1; j < end; ++j) {
          const float v = e[heads[j]];
          if (v > m) m = v;
        }
        if (flags & kHasSuffix) {
          const float a = stk[(depth - 1) * nt + t];
          if (a > m) m = a;
        }
        if (flags & kHasExtensions) stk[depth * nt + t] = m;
        if (!(flags & kStore)) continue;
        val = irn::pow_int(__fsub_rn(1.f, isnan(v0) ? v0 : m),
                           kBeta ? kBeta : g.beta);
      } else if (!(flags & kStore)) {
        continue;
      }
      wv[pair * nq + q] = val;
      if (own) w[(size_t)pair * g.n_pad + flat] = val;
    }
  }
  __syncthreads();

  if (t < kTileH * kTileW) {
    const int ty = t / kTileW;
    const int tx = t % kTileW;
    const int X = X0 + tx;
    const int flat = (Y0 + ty) * g.pw + X;
    if (X < g.pw && flat < g.n_pad) {
      const int* nb = s.t + 5 + groups + 2 * s.t[2] + s.t[3];
      const int qo = (ty + rf) * rw + tx + rf;
      float total = 0.f;
#pragma unroll 4
      for (int k = 0; k < g.n_pairs; ++k) {
        const float own = wv[k * nq + qo];
        total = __fadd_rn(total, __fadd_rn(wv[k * nq + qo - nb[k]], own));
      }
      inv[flat] = __fdiv_rn(1.f, __fadd_rn(1.f, total));
    }
  }
}

__device__ __forceinline__ float padded_edge(const float* __restrict__ edge,
                                             const Grid& g, int Y, int X) {
  const int x = X - g.r;
  return (Y < g.cap_h && x >= 0 && x < g.cap_w)
             ? __ldg(edge + (size_t)Y * g.cap_w + x)
             : 1.f;
}

// w[k, j]: pair k's band value at flat index j >= 0 (0 beyond the window).
__device__ __forceinline__ float band_value(const float* __restrict__ edge,
                                            const char2* __restrict__ cells,
                                            const int* __restrict__ starts,
                                            const Grid& g, int k, int j) {
  const int Y = j / g.pw;
  const int X = j - Y * g.pw;
  if (Y >= g.wh || X < g.rf || X >= g.pw - g.rf) return 0.f;
  const int begin = __ldg(starts + k);
  const int end = __ldg(starts + k + 1);
  char2 c = __ldg(cells + begin);
  float m = padded_edge(edge, g, Y + c.x, X + c.y);
  for (int i = begin + 1; i < end; ++i) {
    c = __ldg(cells + i);
    const float v = padded_edge(edge, g, Y + c.x, X + c.y);
    if (v > m) m = v;
  }
  return irn::pow_int(__fsub_rn(1.f, m), g.beta);
}

__global__ void __launch_bounds__(kDirectThreads)
diag_operator_direct(const float* __restrict__ edge, float* __restrict__ w,
                     float* __restrict__ inv, const char2* __restrict__ cells,
                     const int* __restrict__ starts, const Grid g) {
  const int c = blockIdx.x * kDirectThreads + threadIdx.x;
  if (c >= g.n_pad) return;
  float total = 0.f;
  for (int k = 0; k < g.n_pairs; ++k) {
    const char2 dst = __ldg(cells + __ldg(starts + k));
    const int d = dst.x * g.pw + dst.y;
    const float own = band_value(edge, cells, starts, g, k, c);
    const float nb = c >= d ? band_value(edge, cells, starts, g, k, c - d)
                            : 0.f;
    w[(size_t)k * g.n_pad + c] = own;
    total = __fadd_rn(total, __fadd_rn(nb, own));
  }
  inv[c] = __fdiv_rn(1.f, __fadd_rn(1.f, total));
}

std::atomic<unsigned long long> staged_smem_set[2];

}  // namespace

// edge [cap_h, cap_w] f32 (device) -> w [n_pairs, n_pad], inv [n_pad].
// r: the walk radius, rf its radius floor; n_pad >= (cap_h + r) * (cap_w +
// 2r); beta >= 1. schedule: the staged schedule's n_words int32 words in
// host memory (random_walk.diag_operator_schedule), copied into the
// launch's parameters; or null for the direct schedule over cells int8
// [n_cells, 2] (dy, dx) and starts int32 [n_pairs + 1] on the device. One
// launch, no other device operation.
IRN_API int irn_diag_operator(const float* edge, float* w, float* inv,
                              const int* schedule, int n_words,
                              const void* cells, const int* starts, int cap_h,
                              int cap_w, int r, int rf, int n_pad, int n_pairs,
                              int n_cells, int beta, cudaStream_t stream,
                              int* launched) {
  const int ph = cap_h + r;
  const Grid g{cap_h, cap_w, r, rf, cap_w + 2 * r, ph - rf, n_pad, n_pairs,
               beta};
  if (cap_h < 1 || cap_w < 1 || rf < 0 || r < rf || g.wh < 1 ||
      g.pw - 2 * rf < 1 || n_pad < ph * g.pw || beta < 1 || n_pairs < 1 ||
      n_pairs > kMaxPairs)
    return (int)cudaErrorInvalidValue;
  if (!schedule) {
    if (!cells || !starts || n_cells < n_pairs || n_cells > kMaxCells)
      return (int)cudaErrorInvalidValue;
    const int blocks = (n_pad + kDirectThreads - 1) / kDirectThreads;
    diag_operator_direct<<<blocks, kDirectThreads, 0, stream>>>(
        edge, w, inv, static_cast<const char2*>(cells), starts, g);
    IRN_CHECK_LAUNCH(launched);
    return 0;
  }
  if (n_words < 5 || n_words > kWords) return (int)cudaErrorInvalidValue;
  Schedule s;
  std::memset(&s, 0, sizeof(s));
  std::memcpy(s.t, schedule, sizeof(int) * n_words);
  const int groups = s.t[0];
  const int levels = s.t[1];
  const int nq = (kTileH + rf) * (kTileW + 2 * rf);
  const int nq_pad = (nq + 31) / 32 * 32;
  const int threads = groups * nq_pad;
  const size_t smem =
      sizeof(float) * ((size_t)n_pairs * nq +
                       (size_t)(kTileH + 2 * rf) * (kTileW + 4 * rf) +
                       (size_t)levels * threads);
  if (groups < 1 || threads > kThreadsMax || levels < 0 ||
      n_words != 5 + groups + 2 * s.t[2] + s.t[3] + n_pairs ||
      smem > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  auto kernel = beta == 10 ? diag_operator_staged<10>
                           : diag_operator_staged<0>;
  const cudaError_t e =
      irn::allow_smem(kernel, staged_smem_set[beta == 10], kSmemMax);
  if (e != cudaSuccess) return (int)e;
  const int rows = (n_pad + g.pw - 1) / g.pw;
  const dim3 grid((g.pw + kTileW - 1) / kTileW,
                  (rows + kTileH - 1) / kTileH);
  kernel<<<grid, threads, smem, stream>>>(edge, w, inv, g, s, nq_pad);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
