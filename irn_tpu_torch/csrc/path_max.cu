// K13a / K13b path_max: train_irn's per-pair path max of the edge map
// (forward) and its winner-take-all cotangent routing (backward).
//
// Replaces: irn_tpu/ops/affinity.py _path_max / _path_max_fwd (the unrolled
// strict-> max chain over statically shifted window slices, which XLA fuses
// into a few elementwise passes) and _path_max_bwd (the cotangent of each
// (pair, pixel) routed to its winning cell, grouped per unique cell). Eager
// PyTorch would run the forward as ~6,000 launches and the backward as
// ~4,000 at radius 10 (2,134 path cells over 152 pairs).
//
// Geometry: edge [B, H, W]; the valid source window is ch = H - rf rows by
// cw = W - 2 rf columns; path cell (dy, dx) of output (y, x) reads
// edge[y + dy, rf + x + dx], with 0 <= dy <= rf and |dx| <= rf. The per-pair
// cell lists (destination first, true lengths) live in constant memory:
// every thread of a warp walks the same (pair, cell), so each read is a
// broadcast.
//
// K13a, forward: maxed [B, n_pairs, ch, cw] f32 and winner [B, n_pairs, ch,
// cw] int8 (the index of the winning cell in its path). One thread per
// output pixel; a block of 32 x 8 outputs stages its edge tile plus the halo
// (rf rows below, rf columns on each side) in shared memory, then loops over
// pairs and cells with a strict > from the destination cell on, so a tie
// keeps the first cell: the reference's max_pool2d semantics, bit-equal to
// the plain twin and to JAX in values and winners. Bound on this card:
// bytes. At the default (B 32, 128 x 128 grid, radius 10) it writes 32 x 152
// x 13,090 values, 254.7 MB f32 and 63.7 MB int8, and reads a 2.1 MB edge
// map: ~320 MB / 3.35 TB/s = 0.096 ms. The compares (68 per output value at
// radius 10, from shared memory) are far below the f32 peak.
//
// K13b, backward: g [B, n_pairs, ch, cw] f32 and the winners in, d_edge
// [B, H, W] f32 out. One thread per edge pixel and no atomics: the thread
// loops over the unique cells in the order JAX's by_cell dict first meets
// them (pairs ascending, then positions), sums g over the cell's (p, l)
// list where the winner equals l, in list order (a loser adds 0.0, as the
// JAX where does), then adds that sum to its running total, in cell order.
// That is _path_max_bwd's sum order, written with __fadd_rn so nvcc
// contracts nothing: the result is bit-equal to the plain twin and
// deterministic. Each (p, pixel) cotangent is read once, by its winner's
// thread; each winner byte once per cell of its path (~14x on 63.7 MB,
// mostly from L1/L2). Bound: bytes, ~320 MB / 3.35 TB/s = 0.096 ms.
//
// Both entry points copy the tables (device int32 / int8 arrays the wrapper
// caches per device) into constant memory on the stream before the launch,
// so a launch always sees its own tables. One launch each.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxCells = 6144;
constexpr int kMaxPairs = 1024;
constexpr int kMaxUnique = 1024;

// forward: (dy, dx) of every pair's cells, concatenated, and where each
// pair's cells begin
__constant__ char2 c_cell[kMaxCells];
__constant__ int c_pair_start[kMaxPairs + 1];
// backward: the unique cells in first-meet order, where each cell's (p, l)
// list begins, and the lists, packed p << 8 | l
__constant__ char2 c_ucell[kMaxUnique];
__constant__ int c_ucell_start[kMaxUnique + 1];
__constant__ int c_entry[kMaxCells];

constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kBwdThreads = 256;

__global__ void __launch_bounds__(kTx * kTy)
path_max_fwd_kernel(const float* __restrict__ edge, float* __restrict__ maxed,
                    int8_t* __restrict__ winner, int H, int W, int rf,
                    int n_pairs) {
  extern __shared__ float tile[];
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const int tw = kTx + 2 * rf;
  const int th = kTy + rf;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTx;
  const int y0 = blockIdx.y * kTy;
  const float* e = edge + (size_t)b * H * W;
  for (int i = threadIdx.y * kTx + threadIdx.x; i < th * tw;
       i += kTx * kTy) {
    const int gy = y0 + i / tw;
    const int gx = x0 + i % tw;
    tile[i] = (gy < H && gx < W) ? e[(size_t)gy * W + gx] : 0.f;
  }
  __syncthreads();
  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= cw || y >= ch) return;
  const size_t plane = (size_t)ch * cw;
  const size_t out0 = (size_t)b * n_pairs * plane + (size_t)y * cw + x;
  // cell (dy, dx) of this output at s[dy * tw + dx]
  const float* s = tile + threadIdx.y * tw + threadIdx.x + rf;
  for (int p = 0; p < n_pairs; ++p) {
    const int begin = c_pair_start[p];
    const int end = c_pair_start[p + 1];
    char2 c = c_cell[begin];
    float m = s[c.x * tw + c.y];
    int a = 0;
    for (int i = begin + 1; i < end; ++i) {
      c = c_cell[i];
      const float v = s[c.x * tw + c.y];
      if (v > m) {
        m = v;
        a = i - begin;
      }
    }
    maxed[out0 + p * plane] = m;
    winner[out0 + p * plane] = (int8_t)a;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
path_max_bwd_kernel(const float* __restrict__ g,
                    const int8_t* __restrict__ winner,
                    float* __restrict__ d_edge, int B, int H, int W, int rf,
                    int n_pairs, int n_unique) {
  const long long i = (long long)blockIdx.x * kBwdThreads + threadIdx.x;
  if (i >= (long long)B * H * W) return;
  const int X = (int)(i % W);
  const int Y = (int)((i / W) % H);
  const int b = (int)(i / ((long long)H * W));
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const size_t plane = (size_t)ch * cw;
  const float* gb = g + (size_t)b * n_pairs * plane;
  const int8_t* wb = winner + (size_t)b * n_pairs * plane;
  float acc = 0.f;
  for (int u = 0; u < n_unique; ++u) {
    const char2 c = c_ucell[u];
    const int y = Y - c.x;
    const int x = X - rf - c.y;
    if (y < 0 || y >= ch || x < 0 || x >= cw) continue;
    const size_t off = (size_t)y * cw + x;
    const int begin = c_ucell_start[u];
    const int end = c_ucell_start[u + 1];
    float s = 0.f;
    for (int k = begin; k < end; ++k) {
      const int ent = c_entry[k];
      const size_t at = (size_t)(ent >> 8) * plane + off;
      const float v = (wb[at] == (int8_t)(ent & 0xff)) ? gb[at] : 0.f;
      s = (k == begin) ? v : __fadd_rn(s, v);
    }
    acc = __fadd_rn(acc, s);
  }
  d_edge[i] = acc;
}

bool bad_geometry(int B, int H, int W, int rf) {
  return B < 1 || rf < 0 || H - rf < 1 || W - 2 * rf < 1;
}

}  // namespace

// edge [B, H, W] -> maxed, winner [B, n_pairs, H - rf, W - 2 rf]; cells
// int8 [n_cells, 2] (dy, dx), pair_start int32 [n_pairs + 1], both on the
// device.
IRN_API int irn_path_max_fwd(const float* edge, float* maxed, int8_t* winner,
                             const void* cells, const int* pair_start, int B,
                             int H, int W, int rf, int n_pairs, int n_cells,
                             cudaStream_t stream, int* launched) {
  if (bad_geometry(B, H, W, rf) || n_pairs < 1 || n_pairs > kMaxPairs ||
      n_cells < n_pairs || n_cells > kMaxCells)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_cell, cells, 2 * n_cells, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbolAsync(c_pair_start, pair_start, 4 * (n_pairs + 1), 0,
                              cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const dim3 grid((cw + kTx - 1) / kTx, (ch + kTy - 1) / kTy, B);
  const size_t smem = sizeof(float) * (kTy + rf) * (kTx + 2 * rf);
  path_max_fwd_kernel<<<grid, dim3(kTx, kTy), smem, stream>>>(
      edge, maxed, winner, H, W, rf, n_pairs);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// g [B, n_pairs, H - rf, W - 2 rf] f32 and its winners -> d_edge [B, H, W];
// ucells int8 [n_unique, 2], ucell_start int32 [n_unique + 1], entries
// int32 [n_cells] (p << 8 | l), on the device.
IRN_API int irn_path_max_bwd(const float* g, const int8_t* winner,
                             float* d_edge, const void* ucells,
                             const int* ucell_start, const int* entries,
                             int B, int H, int W, int rf, int n_pairs,
                             int n_unique, int n_cells, cudaStream_t stream,
                             int* launched) {
  if (bad_geometry(B, H, W, rf) || n_pairs < 1 || n_pairs > kMaxPairs ||
      n_unique < 1 || n_unique > kMaxUnique || n_cells < n_unique ||
      n_cells > kMaxCells)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_ucell, ucells, 2 * n_unique, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbolAsync(c_ucell_start, ucell_start, 4 * (n_unique + 1),
                              0, cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyToSymbolAsync(c_entry, entries, 4 * n_cells, 0,
                              cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * H * W;
  const int blocks = (int)((n + kBwdThreads - 1) / kBwdThreads);
  path_max_bwd_kernel<<<blocks, kBwdThreads, 0, stream>>>(
      g, winner, d_edge, B, H, W, rf, n_pairs, n_unique);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
