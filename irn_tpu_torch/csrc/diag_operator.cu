// K10 diag_operator: the default walk's transition operator T in diagonal
// form, built from the edge map in one launch.
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
// cap_w); every other padded cell is 1.0. The valid window is ph - rf rows
// by pw - 2 rf columns; path cell (dy, dx) of window cell (y, x) is the
// padded cell (y + dy, rf + x + dx). Flat index j = Y * pw + X of the
// padded grid, padded with zeros to n_pad.
//
//   w[k, j]  = pow_int(1 - max over pair k's cells, beta) at window cell
//              (Y, X - rf), 0 at every other j of [0, n_pad)
//   inv[c]   = 1 / (1 + total), total = sum over k in pair order of
//              (w[k, c - d_k] + w[k, c]), w[k, c - d_k] = 0 for c < d_k
//
// with d_k = dy * pw + dx of pair k's destination (its first cell).
//
// Design: one thread per column c of [0, n_pad). For each pair k it computes
// w[k, c] (and writes it) and w[k, c - d_k], which another thread owns: the
// thread recomputes that value rather than reading it, so the column sums
// need no second launch and no grid-wide barrier. The recomputation runs the
// same code on the same inputs, so both copies agree to the bit. The path
// max walks the cell lists destination first with a strict >, so a tie
// keeps the first cell, as affinity.path_affinity and K13a do; the cell
// lists live in constant memory (the tables affinity.PathTable builds for
// K13a, copied on the stream before the launch): every thread of a warp
// reads the same cell at once. The edge map (at most 64 KB at the 128 x 128
// cap) is read through the read-only cache.
//
// Bit-equality: 1 - m, the powers (irn::pow_int: binary exponentiation,
// JAX's integer_pow order, beta a run-time integer >= 1), the sums and the
// division are written with __fsub_rn / __fmul_rn / __fadd_rn / __fdiv_rn
// in the plain twin's order, so nvcc contracts nothing and the result is
// bit-equal to random_walk.build_diag_operator_plain on the card.
//
// Bound on this card: bytes. At the 96 x 128 bucket it reads the 48 KB edge
// map and writes w [34, 14336] f32 (1.95 MB) and inv (57 KB): ~2.07 MB /
// 3.35 TB/s = 0.6 us. The arithmetic (~2 x 242 compares and ~10 multiplies
// per column and pair group) is far below the f32 peak, so one launch of
// ~14k threads is bound by its latency.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxCells = 6144;
constexpr int kMaxPairs = 1024;
constexpr int kThreads = 128;

// (dy, dx) of every pair's cells, concatenated, destination first, and
// where each pair's cells begin
__constant__ char2 c_cell[kMaxCells];
__constant__ int c_pair_start[kMaxPairs + 1];

struct Grid {
  int cap_h, cap_w, r, rf, ph, pw;
};

__device__ __forceinline__ float padded_edge(const float* __restrict__ edge,
                                             const Grid& g, int Y, int X) {
  const int x = X - g.r;
  return (Y < g.cap_h && x >= 0 && x < g.cap_w)
             ? __ldg(edge + (size_t)Y * g.cap_w + x)
             : 1.f;
}

// w[k, j]: pair k's band value at flat index j >= 0 (0 beyond the window,
// the padded grid included).
__device__ __forceinline__ float band_value(const float* __restrict__ edge,
                                            const Grid& g, int k, int j,
                                            int beta) {
  const int Y = j / g.pw;
  const int X = j - Y * g.pw;
  if (Y >= g.ph - g.rf || X < g.rf || X >= g.pw - g.rf) return 0.f;
  const int begin = c_pair_start[k];
  const int end = c_pair_start[k + 1];
  char2 c = c_cell[begin];
  float m = padded_edge(edge, g, Y + c.x, X + c.y);
  for (int i = begin + 1; i < end; ++i) {
    c = c_cell[i];
    const float v = padded_edge(edge, g, Y + c.x, X + c.y);
    if (v > m) m = v;
  }
  return irn::pow_int(__fsub_rn(1.f, m), beta);
}

__global__ void __launch_bounds__(kThreads)
diag_operator_kernel(const float* __restrict__ edge, float* __restrict__ w,
                     float* __restrict__ inv, Grid g, int n_pad, int n_pairs,
                     int beta) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= n_pad) return;
  float total = 0.f;
  for (int k = 0; k < n_pairs; ++k) {
    const char2 dst = c_cell[c_pair_start[k]];
    const int d = dst.x * g.pw + dst.y;
    const float own = band_value(edge, g, k, c, beta);
    const float nb = c >= d ? band_value(edge, g, k, c - d, beta) : 0.f;
    w[(size_t)k * n_pad + c] = own;
    total = __fadd_rn(total, __fadd_rn(nb, own));
  }
  inv[c] = __fdiv_rn(1.f, __fadd_rn(1.f, total));
}

}  // namespace

// edge [cap_h, cap_w] f32 (device) -> w [n_pairs, n_pad], inv [n_pad];
// cells int8 [n_cells, 2] (dy, dx), pair_start int32 [n_pairs + 1], both on
// the device (affinity.PathTable.tables). r: the walk radius, rf its
// radius floor; n_pad >= (cap_h + r) * (cap_w + 2r); beta >= 1. One launch.
IRN_API int irn_diag_operator(const float* edge, float* w, float* inv,
                              const void* cells, const int* pair_start,
                              int cap_h, int cap_w, int r, int rf, int n_pad,
                              int n_pairs, int n_cells, int beta,
                              cudaStream_t stream, int* launched) {
  const Grid g{cap_h, cap_w, r, rf, cap_h + r, cap_w + 2 * r};
  if (cap_h < 1 || cap_w < 1 || rf < 0 || r < rf || g.ph - rf < 1 ||
      g.pw - 2 * rf < 1 || n_pad < g.ph * g.pw || beta < 1 || n_pairs < 1 ||
      n_pairs > kMaxPairs || n_cells < n_pairs || n_cells > kMaxCells)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_cell, cells, 2 * n_cells, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbolAsync(c_pair_start, pair_start, 4 * (n_pairs + 1), 0,
                              cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_pad + kThreads - 1) / kThreads;
  diag_operator_kernel<<<blocks, kThreads, 0, stream>>>(edge, w, inv, g,
                                                        n_pad, n_pairs, beta);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
