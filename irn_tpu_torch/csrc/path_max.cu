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
// edge[y + dy, rf + x + dx], with 0 <= dy <= rf and |dx| <= rf. Both
// kernels take their schedule (affinity.PathTable) through one constant
// buffer that each entry point fills on the stream before its launch, so a
// launch always sees its own tables; every thread of a warp reads the same
// word, a broadcast. One launch each.
//
// K13a, forward: maxed [B, n_pairs, ch, cw] f32 and winner [B, n_pairs, ch,
// cw] int8 (the index of the winning cell in its path). Bound on this card:
// bytes. At the default (B 32, 128 x 128 grid, radius 10) it writes 32 x 152
// x 12,744 values, 249 MB f32 and 62 MB int8, and reads a 2.1 MB edge map:
// ~0.096 ms at 3.35 TB/s.
//   Shared suffixes. Cells are listed destination first and every path
// ends at the source (0, 0); at radius 10, 150 of the 152 paths end with
// another pair's whole path at the same offsets (PathTable.suffix). The
// strict-> chain from the destination keeps the first maximal cell, and max
// is exact, so a path's (max, winner) is its head's chain followed by one
// strict-> compare against its suffix pair's (m, a): the suffix wins only
// if its max exceeds the head's, and then at head length + a. The pairs run
// depth first over those links (PathTable.order); each thread keeps the
// (m, a) of the current pair's ancestors on a stack in shared memory, so
// radius 10 reads 1,110 cells and combines instead of 2,134 cells.
//   NaN. The plain chain starts at the destination's value; a NaN there
// sticks (nothing compares greater) and a later NaN never wins. A suffix
// pair's own result would stick at its NaN destination where the longer
// path goes on past it, so the stack holds each chain started at
// max(destination, -inf) instead (a NaN compares as -inf, which never wins
// a strict >), and a pair whose destination is NaN writes that NaN and
// winner 0. Both are the plain chain's values and winners, bit for bit.
//   Layout. A block of 32 x 8 threads owns 8 output rows of 128 columns
// (56.0 KB of shared memory at radius 10: four blocks per SM);
// each thread four outputs 32 columns apart, so one cell's decode serves
// four shared-memory reads at immediate offsets, the warp's reads fall on
// 32 consecutive words (no bank conflict), and each store instruction of
// the warp writes 128 contiguous bytes of maxed and 32 of winners. The
// block stages its edge tile with the halo (rf rows below, rf columns each
// side) once.
//
// K13b, backward: g [B, n_pairs, ch, cw] f32 and the winners in, d_edge
// [B, H, W] f32 out; no atomics. JAX's order is acc = ((0 + s_u1) + s_u2)
// + ... over the unique cells u in first-meet order (pairs ascending, then
// positions), each s_u the sum over u's (p, l) list in list order of g
// where the winner is l, else +0.0 (irn_tpu/ops/affinity.py:96-102).
//   Only hits need adding, in the same grouping. A miss adds +0.0, and
// x + 0.0 == x for every x but -0.0 (NaN and +-inf included). So a sum
// over the hits alone, started at +0.0, equals the sum with the misses in
// value and differs at most in the sign of a zero; so does each s_u, and
// acc + s_u is then the same bits (acc starts at +0.0 and a sum of two
// values is -0.0 only when both are, so acc is never -0.0, and +0.0 + -0.0
// is +0.0). What must not change is the grouping: each s_u is formed on its
// own, then added to acc in u order; a cell with no hit adds +0.0, which
// leaves acc as it is. The result is bit-equal to the plain twin.
//   Pair-major sums. Pixel P's s_u collects g at output P - u of the pairs
// in u's list, so every cotangent of output position o goes to exactly one
// (u, P): u the cell its winner names, P = o + u. A block owns 32 x
// tile_rows edge pixels and keeps s_u for each of them, S[u][P] in shared
// memory (165.9 KB at radius 10, tile_rows 8), zero at the start. One
// thread owns one output position o of the block's window (the tile_rows +
// rf rows and 32 + 2 rf columns whose cells can reach the tile) and walks
// the pairs in ascending order: it reads o's winner once per pair, looks
// up the cell, and on a hit (P in the tile) reads g once and adds it to
// S[u][P]. (u, P) is reached only from o = P - u, so one thread adds all of
// its terms, in pair order, which is u's list order: no atomics, no
// barrier. A last pass sums S[u][P] over u in order for each pixel. The
// winners and g are read once per block, in coalesced rows (g only on a
// hit); each thread has the next kBwdGroup pairs' winner bytes and this
// group's cotangents in flight while the last group's sums land. (Skipping
// the positions a pair's cell box keeps out of the tile saved loads but
// cost more in compares than it saved.) One block of 1,024 threads per SM:
// its sums and cells take 174.4 KB at radius 10.
//   The per-pixel schedule that JAX's loop suggests (each pixel testing
// every (u, p, l) entry against winners staged in shared memory, 2,134
// tests per pixel at radius 10) spends its time on those tests and on
// scattered 32-byte gathers of g; this one does one test per (pair,
// position) of the window.
// Bound: bytes, ~320 MB read (g, winners) over 3.35 TB/s = 0.096 ms.

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxPairs = 1024;
// the schedule of one launch: K13a's 4 words per pair and one per head
// cell (at most 6,144 cells), or K13b's first cell of each pair
constexpr int kTabWords = 10240;
constexpr int kSmemMax = 232448;
__constant__ int c_tab[kTabWords];

constexpr int kFwdLanes = 32;
constexpr int kFwdRows = 8;
constexpr int kFwdPx = 4;
constexpr int kFwdThreads = kFwdLanes * kFwdRows;
constexpr int kFwdTileX = kFwdLanes * kFwdPx;
constexpr int kHasSuffix = 1 << 8;
constexpr int kHasExtensions = 1 << 9;

constexpr int kBwdLanes = 32;
constexpr int kBwdThreads = 1024;
constexpr int kBwdGroup = 5;

__global__ void __launch_bounds__(kFwdThreads)
path_max_fwd_kernel(const float* __restrict__ edge, float* __restrict__ maxed,
                    int8_t* __restrict__ winner, int H, int W, int rf,
                    int n_pairs, int levels) {
  extern __shared__ float smem[];
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const int tw = kFwdTileX + 2 * rf;
  const int th = kFwdRows + rf;
  float* tile = smem;
  // the stack: (m, a) per level, output and thread
  float* stk_m = smem + th * tw;
  int8_t* stk_a =
      reinterpret_cast<int8_t*>(stk_m + levels * kFwdPx * kFwdThreads);
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kFwdTileX;
  const int y0 = blockIdx.y * kFwdRows;
  const int t = threadIdx.y * kFwdLanes + threadIdx.x;
  const float* e = edge + (size_t)b * H * W;
  for (int i = t; i < th * tw; i += kFwdThreads) {
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
  // cell (dy, dx) of output k at s[dy * tw + dx + rf + k * kFwdLanes]
  const float* s = tile + threadIdx.y * tw + threadIdx.x;
  const int heads = 4 * n_pairs;  // c_tab: 4 words per pair, then cells
  const float neg_inf = __int_as_float(0xff800000);
  for (int i = 0; i < n_pairs; ++i) {
    // pair, head begin, head end, flags
    const int4 nd = make_int4(c_tab[4 * i], c_tab[4 * i + 1],
                              c_tab[4 * i + 2], c_tab[4 * i + 3]);
    int c = c_tab[heads + nd.y];
    int at = (c >> 16) * tw + (c & 0xffff);
    float v0[kFwdPx], m[kFwdPx];
    int a[kFwdPx];
#pragma unroll
    for (int k = 0; k < kFwdPx; ++k) {
      v0[k] = s[at + k * kFwdLanes];
      m[k] = fmaxf(v0[k], neg_inf);
      a[k] = 0;
    }
    for (int j = nd.y + 1; j < nd.z; ++j) {
      c = c_tab[heads + j];
      at = (c >> 16) * tw + (c & 0xffff);
      const int l = j - nd.y;
#pragma unroll
      for (int k = 0; k < kFwdPx; ++k) {
        const float v = s[at + k * kFwdLanes];
        if (v > m[k]) {
          m[k] = v;
          a[k] = l;
        }
      }
    }
    const int depth = nd.w & 0xff;
    if (nd.w & kHasSuffix) {
      const int head = nd.z - nd.y;
      const int slot = (depth - 1) * kFwdPx * kFwdThreads + t;
#pragma unroll
      for (int k = 0; k < kFwdPx; ++k) {
        const float q = stk_m[slot + k * kFwdThreads];
        if (q > m[k]) {
          m[k] = q;
          a[k] = head + stk_a[slot + k * kFwdThreads];
        }
      }
    }
    if (nd.w & kHasExtensions) {
      const int slot = depth * kFwdPx * kFwdThreads + t;
#pragma unroll
      for (int k = 0; k < kFwdPx; ++k) {
        stk_m[slot + k * kFwdThreads] = m[k];
        stk_a[slot + k * kFwdThreads] = (int8_t)a[k];
      }
    }
    float* mo = maxed + out0 + nd.x * plane;
    int8_t* wo = winner + out0 + nd.x * plane;
#pragma unroll
    for (int k = 0; k < kFwdPx; ++k) {
      if (x + k * kFwdLanes < cw) {
        const bool nan0 = isnan(v0[k]);
        mo[k * kFwdLanes] = nan0 ? v0[k] : m[k];
        wo[k * kFwdLanes] = nan0 ? (int8_t)0 : (int8_t)a[k];
      }
    }
  }
}

// a predicated load: v stays as it is where pred is false
__device__ __forceinline__ void ld_if(float& v, const float* p, bool pred) {
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}"
      : "+f"(v)
      : "l"(p), "r"((unsigned)pred));
}

__device__ __forceinline__ void ld_if(int& v, const int8_t* p, bool pred) {
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.nc.s8 %0, [%1];\n}"
      : "+r"(v)
      : "l"(p), "r"((unsigned)pred));
}

__global__ void __launch_bounds__(kBwdThreads)
path_max_bwd_kernel(const float* __restrict__ g,
                    const int8_t* __restrict__ winner,
                    float* __restrict__ d_edge, const int* __restrict__ cells,
                    int H, int W, int rf, int n_pairs, int n_cells,
                    int n_unique, int tile_rows) {
  extern __shared__ __align__(16) float sums[];
  const int tp = tile_rows * kBwdLanes;
  // S[u][tile row][tile column], then the cells
  int* cell = reinterpret_cast<int*>(sums + n_unique * tp);
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const int plane = ch * cw;  // n_pairs * plane < 2^31 (the host checks)
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * kBwdLanes;
  const int Y0 = blockIdx.y * tile_rows;
  const int t = threadIdx.x;
  for (int i = t; i < n_unique * tp; i += kBwdThreads) sums[i] = 0.f;
  for (int i = t; i < n_cells; i += kBwdThreads) {
    // u << 16 | dy << 8 | (dx + rf) -> the cell's sum offset for tile pixel
    // (0, 0), S[u][dy][dx + rf] (< 2^20: the sums fit shared memory), | dy
    // << 20 | (dx + rf) << 25
    const int c = __ldg(cells + i);
    const int dy = c >> 8 & 0xff;
    const int dxr = c & 0xff;
    cell[i] = ((c >> 16) * tile_rows + dy) * kBwdLanes + dxr | dy << 20 |
              dxr << 25;
  }
  __syncthreads();
  // this thread's output position (Y0 + sy, X0 + sx): cell (dy, dx) takes
  // it to tile pixel (sy + dy, sx + rf + dx)
  const int ww = kBwdLanes + 2 * rf;
  const int sy = t / ww - rf;
  const int sx = t % ww - 2 * rf;
  const bool inside = t < (tile_rows + rf) * ww && Y0 + sy >= 0 &&
                      Y0 + sy < ch && X0 + sx >= 0 && X0 + sx < cw;
  const long long at =
      (long long)b * n_pairs * plane + (long long)(Y0 + sy) * cw + X0 + sx;
  const int8_t* wp = winner + at;
  const float* gp = g + at;
  const int soff = sy * kBwdLanes + sx;
  int w[kBwdGroup];
#pragma unroll
  for (int q = 0; q < kBwdGroup; ++q) {
    w[q] = 0;
    ld_if(w[q], wp + (long long)q * plane, inside && q < n_pairs);
  }
  bool hit_prev[kBwdGroup];
  int at_prev[kBwdGroup];
  float v_prev[kBwdGroup];
#pragma unroll
  for (int q = 0; q < kBwdGroup; ++q) {
    hit_prev[q] = false;
    at_prev[q] = 0;
    v_prev[q] = 0.f;
  }
  for (int p0 = 0; p0 < n_pairs; p0 += kBwdGroup) {
    bool hit[kBwdGroup];
    int at_s[kBwdGroup];
    float v[kBwdGroup];
#pragma unroll
    for (int q = 0; q < kBwdGroup; ++q) {
      // the winner's cell
      const int p = p0 + q;
      const int c = cell[(p < n_pairs ? c_tab[p] : 0) + w[q]];
      const int dy = c >> 20 & 0x1f;
      const int dxr = c >> 25;
      hit[q] = inside && p < n_pairs &&
               (unsigned)(sy + dy) < (unsigned)tile_rows &&
               (unsigned)(sx + dxr) < (unsigned)kBwdLanes;
      at_s[q] = (c & 0xfffff) + soff;
      v[q] = 0.f;
      ld_if(v[q], gp + (long long)p * plane, hit[q]);
    }
#pragma unroll
    for (int q = 0; q < kBwdGroup; ++q) {
      const int p = p0 + kBwdGroup + q;
      w[q] = 0;
      ld_if(w[q], wp + (long long)p * plane, inside && p < n_pairs);
    }
#pragma unroll
    for (int q = 0; q < kBwdGroup; ++q) {
      if (hit_prev[q])
        sums[at_prev[q]] = __fadd_rn(sums[at_prev[q]], v_prev[q]);
      hit_prev[q] = hit[q];
      at_prev[q] = at_s[q];
      v_prev[q] = v[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kBwdGroup; ++q)
    if (hit_prev[q]) sums[at_prev[q]] = __fadd_rn(sums[at_prev[q]], v_prev[q]);
  __syncthreads();
  for (int i = t; i < tp; i += kBwdThreads) {
    const int Y = Y0 + i / kBwdLanes;
    const int X = X0 + i % kBwdLanes;
    float acc = 0.f;
    for (int u = 0; u < n_unique; ++u) acc = __fadd_rn(acc, sums[u * tp + i]);
    if (Y < H && X < W) d_edge[((size_t)b * H + Y) * W + X] = acc;
  }
}

bool bad_geometry(int B, int H, int W, int rf) {
  return B < 1 || rf < 0 || H - rf < 1 || W - 2 * rf < 1;
}

// per device, whether a kernel's shared-memory limit is raised
std::atomic<unsigned long long> fwd_smem_set{0};
std::atomic<unsigned long long> bwd_smem_set{0};

}  // namespace

// edge [B, H, W] -> maxed, winner [B, n_pairs, H - rf, W - 2 rf]; tab int32
// [n_words] on the device (PathTable.tables' fwd), levels its stack depth.
IRN_API int irn_path_max_fwd(const float* edge, float* maxed, int8_t* winner,
                             const int* tab, int B, int H, int W, int rf,
                             int n_pairs, int n_words, int levels,
                             cudaStream_t stream, int* launched) {
  if (bad_geometry(B, H, W, rf) || n_pairs < 1 || n_pairs > kMaxPairs ||
      n_words < 5 * n_pairs || n_words > kTabWords || levels < 0 ||
      levels > 127)
    return (int)cudaErrorInvalidValue;
  const int stack = levels * kFwdPx * kFwdThreads;
  const int smem = 4 * (kFwdRows + rf) * (kFwdTileX + 2 * rf) + 5 * stack;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_tab, tab, 4 * n_words, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = irn::allow_smem(path_max_fwd_kernel, fwd_smem_set, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const dim3 grid((cw + kFwdTileX - 1) / kFwdTileX,
                  (ch + kFwdRows - 1) / kFwdRows, B);
  path_max_fwd_kernel<<<grid, dim3(kFwdLanes, kFwdRows), smem, stream>>>(
      edge, maxed, winner, H, W, rf, n_pairs, levels);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// g [B, n_pairs, H - rf, W - 2 rf] f32 and its winners -> d_edge [B, H, W];
// starts int32 [n_pairs] (PathTable.tables' pair starts) and cells int32
// [n_cells] (PathTable.tables' bwd) on the device. A block owns 32 x
// tile_rows pixels, tile_rows the first of 8, 4, 2, 1 whose window
// positions fit the block and whose sums and cells fit shared memory.
IRN_API int irn_path_max_bwd(const float* g, const int8_t* winner,
                             float* d_edge, const int* starts,
                             const int* cells, int B, int H, int W, int rf,
                             int n_pairs, int n_cells, int n_unique,
                             cudaStream_t stream, int* launched) {
  if (bad_geometry(B, H, W, rf) || n_pairs < 1 || n_pairs > kMaxPairs ||
      n_cells < n_pairs || n_unique < 1 || n_unique > (1 << 15) ||
      rf > 31 || (long long)n_pairs * (H - rf) * (W - 2 * rf) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  int tile_rows = 8;
  auto smem = [&](int t) {
    return 4LL * ((long long)n_unique * t * kBwdLanes + n_cells);
  };
  while (tile_rows > 0 &&
         ((tile_rows + rf) * (kBwdLanes + 2 * rf) > kBwdThreads ||
          smem(tile_rows) > kSmemMax))
    tile_rows /= 2;
  if (tile_rows == 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_tab, starts, 4 * n_pairs, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = irn::allow_smem(path_max_bwd_kernel, bwd_smem_set, kSmemMax);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + kBwdLanes - 1) / kBwdLanes,
                  (H + tile_rows - 1) / tile_rows, B);
  path_max_bwd_kernel<<<grid, kBwdThreads, (int)smem(tile_rows), stream>>>(
      g, winner, d_edge, cells, H, W, rf, n_pairs, n_cells, n_unique,
      tile_rows);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
