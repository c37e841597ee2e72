// K12 ccl: the instance stage's connected components (K12a) and rank tables
// (K12b), one cooperative launch per call.
//
// Replaces: irn_tpu/ops/ccl_tpu.py min_label_plane / min_label_plane_multi
// (XLA segmented min-scans under a while_loop to the fixpoint; in eager
// PyTorch one host sync per sweep) and cluster_masks / component_tables
// (XLA scans of k_cap + 1 and comp_cap + 1 sequential masked minimums).
//
// K12a: every pixel with a nonzero value gets the smallest flat index of its
// 4-connected same-value component, every other pixel H*W. The fixpoint is
// unique, so a union-find gives it as long as every link points a larger
// root at a smaller one: each component's root is then its minimum. The
// input is a uint8 mask cut to an extent (the basin) or an int32 label map
// (0 or below background).
//
// K12b ranks distinct keys ascending: the cluster masks' landing slots (the
// escape bucket, -1, first, then the basin roots some centroid lands on),
// or the tables' components by key = label * HW + root. It writes the
// [k_cap, H, W] masks and n_found, or the id map, seed rows, sizes and max
// scores (atomicMax on the f32 bits: the scores are floored at 0, where
// integer order is float order) and n_comp. A count of cap + 1 flags
// overflow; only the cap + 1 smallest keys are ever ranked.
//
// Bound on this card: bytes, under a microsecond at the stage's shapes (a
// few hundred KB). What costs is latency: launches, the unions' dependent
// pointer chases and the passes' barriers.
//
// Design: one cooperative launch of persistent CTAs of 256 threads: as many
// as the plane has 32 x 32 tiles, and at least one per 256 pixels up to one
// per SM, but no more than the card holds at once (the occupancy API); a
// CTA loops over tiles when there are more. Its phases are divided by
// hopper.cuh's grid barrier; which run is chosen by argument (K12a alone,
// K12b alone on a given labelling, or both):
//  1. Each CTA labels its tiles in shared memory. A warp's row finds its
//     runs of equal values by ballot (each pixel's parent is its run's
//     first pixel); the rows' runs unite by shared-memory atomicMin, one
//     union per run overlap, finds halving their paths. Inside a tile,
//     row-major order is global flat order, so a tile root is its tile
//     component's minimum. Each pixel's entry in the plane is its tile
//     root; a tile root's own entry is tagged (bit 30). K12b's counters are
//     zeroed.
//  2. Only the tiles' top rows and left columns unite across tiles, in
//     global memory (atomicMin links on the tagged entries, larger root
//     under smaller), one union per run crossing: about 2/32 of the pixels.
//  3. Only the tile roots chase to their component's root and keep it, so
//     a pixel's root is then two loads (its tile root's entry): a
//     component's root entry is read once per tile root, not by every
//     pixel (thousands of same-address reads queue at one L2 slice). The
//     roots with a label are K12b's table candidates; the cluster
//     candidates are the landing slots, each once (the landing pixel's
//     parents chased and kept per pixel; first claim by atomicCAS on a
//     flag, after a warp's lanes with the same slot elect one); both
//     compacted with one atomic per warp. K12a alone writes every pixel's
//     root, untagged, after one more barrier.
//  4. More candidates than cap + 1: a radix select (11-bit digits, the
//     histograms in shared memory, summed in global memory, each CTA
//     reading the same sums) keeps the cap + 1 smallest keys.
//     O(candidates) per pass, at most three passes.
//  5. Every CTA sorts the (at most) cap + 1 kept keys in shared memory,
//     no barrier: up to 256 keys by counting the smaller ones, more by a
//     bitonic sort (O(cap log^2 cap)); and scatters: each pixel's key is
//     found in the sorted keys by binary search (a key not kept has no
//     rank); the masks, or the id map with sizes and scores summed per CTA
//     in shared memory first.
// Three grid barriers in all on the common path (two for K12b alone). The
// grid barrier's counter is the only word that must be zero at launch: one
// 4-byte memset per call.

#include <algorithm>
#include <atomic>
#include <climits>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;  // tile side; a warp's lanes are its columns
constexpr int kTilePix = kTile * kTile;
constexpr int kRadixBits = 11;
constexpr int kBins = 1 << kRadixBits;
constexpr int kPasses = 3;  // 33 bits cover every key (< 2^31)
constexpr int kCapMax = 4096;
// K12a's plane in the launch: a tile root's own entry carries this tag
// beside its parent (itself, or the root it was linked under), every other
// pixel its tile root, untagged; flat indices are below 2^30
constexpr int kRootTag = 1 << 30;
constexpr int kIndex = kRootTag - 1;
// scratch words: barrier counter, candidates, kept keys, pad; the select's
// histograms; then (cluster masks) the slot flags and each pixel's slot,
// the candidates and the kept keys
constexpr int kHeader = 4;
constexpr int kHeaderWords = kHeader + kPasses * kBins;
// dynamic shared memory: tile values + parents, or a histogram (8 KB);
// the kept keys (sort_words), and the tables' per-CTA sizes and scores
constexpr int kSmemBase = 2 * kTilePix * 4;
constexpr int kSmemMax = 4 * (2 * kCapMax + 2 * kCapMax);

enum Rank { kNone = 0, kClusters = 1, kTables = 2 };

struct Args {
  const void* vals;  // K12a's input (uint8 mask or int32 map); null: K12b alone
  int* plane;        // K12a's labelling: written, or given to K12b alone
  const int* cent;   // cluster masks
  uint8_t* masks;
  int* n_found;
  const int* labels;  // component tables
  const float* best;
  int* comp_map;
  int* rows;
  int* sizes;
  float* scores;
  int* n_comp;
  unsigned* header;
  int* flags;    // cluster masks: slot taken
  int* slot_of;  // cluster masks: each pixel's landing slot
  int* cand;
  int* sel;
  int H, W;
  int h_ext, w_ext;  // the mask's extent, and the cluster masks'
  int rank;          // Rank
  int cap;
};

// -- values ------------------------------------------------------------------

// The value a pixel carries for the labeling, 0 off the foreground and off
// the grid: a mask inside its extent is 1, a label map keeps its positive
// values.
__device__ __forceinline__ int value_at(const uint8_t* v, int r, int c,
                                        const Args& a) {
  return (r < a.h_ext && c < a.w_ext && r < a.H && c < a.W &&
          __ldg(v + (size_t)r * a.W + c) != 0)
             ? 1
             : 0;
}

__device__ __forceinline__ int value_at(const int* v, int r, int c,
                                        const Args& a) {
  if (r >= a.H || c >= a.W) return 0;
  const int x = __ldg(v + (size_t)r * a.W + c);
  return x > 0 ? x : 0;
}

// -- union-find --------------------------------------------------------------

// The root of tile-local x, halving the path on the way (each node passed
// is pointed at its grandparent, an ancestor whatever the other threads
// link meanwhile).
__device__ __forceinline__ int find_local(volatile int* par, int x) {
  int p = par[x];
  while (p != x) {
    const int g = par[p];
    if (g != p) par[x] = g;
    x = p;
    p = g;
  }
  return x;
}

// Link the components of a and b (tile-local indices): the larger root
// under the smaller. A root that another thread relinked meanwhile is
// followed and retried.
__device__ void unite_local(int* par, int a, int b) {
  while (true) {
    a = find_local(par, a);
    b = find_local(par, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + a, b);
    if (old == a) return;
    a = old;
  }
}

// The same in global memory, through L2 where the atomics land; the
// entries' tags are masked off (every root is a tagged tile root).
__device__ __forceinline__ int find_root(const int* L, int x) {
  int p = __ldcg(L + x) & kIndex;
  while (p != x) {
    x = p;
    p = __ldcg(L + x) & kIndex;
  }
  return x;
}

__device__ void unite(int* L, int a, int b) {
  while (true) {
    a = find_root(L, a);
    b = find_root(L, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(L + a, b | kRootTag);
    if (old == (a | kRootTag)) return;
    a = old & kIndex;
  }
}

// -- phase 1: the tiles ------------------------------------------------------

template <typename T>
__device__ void label_tiles(const Args& a, int* s_val, int* s_par) {
  const T* v = static_cast<const T*>(a.vals);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tx = (a.W + kTile - 1) / kTile;
  const int tiles = tx * ((a.H + kTile - 1) / kTile);
  const int HW = a.H * a.W;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int r0 = (t / tx) * kTile;
    const int c0 = (t % tx) * kTile;
    const int c = c0 + lane;
    int val[kTile / kWarps];
    bool left[kTile / kWarps];
#pragma unroll
    for (int j = 0; j < kTile / kWarps; ++j)  // the loads first, together
      val[j] = value_at(v, r0 + warp + kWarps * j, c, a);
#pragma unroll
    for (int j = 0; j < kTile / kWarps; ++j) {
      const int lr = warp + kWarps * j;
      const int x = val[j];
      const int xl = __shfl_up_sync(~0u, x, 1);
      left[j] = x != 0 && lane > 0 && xl == x;
      // each pixel's parent: the first pixel of its run in the row
      const unsigned starts = __ballot_sync(~0u, !left[j]);
      const int start = 31 - __clz(starts & (~0u >> (31 - lane)));
      s_val[lr * kTile + lane] = x;
      s_par[lr * kTile + lane] = lr * kTile + start;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile / kWarps; ++j) {
      const int lr = warp + kWarps * j;
      const bool up =
          lr > 0 && val[j] != 0 && s_val[(lr - 1) * kTile + lane] == val[j];
      // where the left neighbour is of the run and joins upward too, its
      // union covers this one
      const bool up_left = __shfl_up_sync(~0u, up, 1);
      if (up && !(left[j] && up_left))
        unite_local(s_par, lr * kTile + lane, (lr - 1) * kTile + lane);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kTile / kWarps; ++j) {
      const int lr = warp + kWarps * j;
      const int r = r0 + lr;
      if (r < a.H && c < a.W) {
        int root = HW;
        if (val[j]) {
          const int l = find_local(s_par, lr * kTile + lane);
          root = (r0 + l / kTile) * a.W + c0 + l % kTile;
          if (l == lr * kTile + lane) root |= kRootTag;
        }
        a.plane[r * a.W + c] = root;
      }
    }
    __syncthreads();  // before the next tile overwrites the arrays
  }
}

// -- phase 2: the tile borders ------------------------------------------------

// One warp per tile edge: the top row against the row above, the left
// column against the column to the left. A lane skips the union its
// neighbour before it along the edge already makes (both sides continue
// that neighbour's pair, inside their tiles).
template <typename T>
__device__ void unite_borders(const Args& a) {
  const T* v = static_cast<const T*>(a.vals);
  const int lane = threadIdx.x & 31;
  const int tx = (a.W + kTile - 1) / kTile;
  const int edges = 2 * tx * ((a.H + kTile - 1) / kTile);
  for (int e = blockIdx.x * kWarps + (threadIdx.x >> 5); e < edges;
       e += gridDim.x * kWarps) {
    const int t = e >> 1;
    const int r0 = (t / tx) * kTile;
    const int c0 = (t % tx) * kTile;
    const bool column = e & 1;
    if (column ? c0 == 0 : r0 == 0) continue;  // whole warp
    const int r = column ? r0 + lane : r0;
    const int c = column ? c0 : c0 + lane;
    const int dr = column ? 0 : 1;  // the other side: (r - dr, c - dc)
    const int dc = column ? 1 : 0;
    const int x = value_at(v, r, c, a);
    const int y = value_at(v, r - dr, c - dc, a);
    const int x_prev = __shfl_up_sync(~0u, x, 1);
    const int y_prev = __shfl_up_sync(~0u, y, 1);
    if (x != 0 && y == x && !(lane > 0 && x_prev == x && y_prev == x))
      unite(a.plane, r * a.W + c, (r - dr) * a.W + c - dc);
  }
}

// -- phase 3: compress, candidates ------------------------------------------

// Points tile root ``p`` (its entry ``x``, tagged) at its component's
// root and returns that root. Only tile roots chase, so a component's root
// entry is read once per tile root, not once per pixel.
__device__ __forceinline__ int compress_tile_root(const Args& a, int p,
                                                  int x) {
  const int up = x & kIndex;
  if (up == p) return p;
  const int root = find_root(a.plane, up);
  if (root != up) a.plane[p] = root | kRootTag;
  return root;
}

// A pixel's root once the tile roots are compressed: its tile root's
// entry (a K12a plane given to K12b alone is its own such table).
__device__ __forceinline__ int root_of(const Args& a, int p) {
  return __ldcg(a.plane + (__ldcg(a.plane + p) & kIndex)) & kIndex;
}

// K12a alone: the tile roots (phase 3), then every pixel (phase 4, after a
// barrier), untagged.
__device__ void compress_tile_roots(const Args& a) {
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < a.H * a.W;
       p += gridDim.x * kThreads) {
    const int x = __ldcg(a.plane + p);
    if (x & kRootTag) compress_tile_root(a, p, x);
  }
}

__device__ void compress_pixels(const Args& a) {
  const int HW = a.H * a.W;
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < HW;
       p += gridDim.x * kThreads) {
    if (__ldcg(a.plane + p) != HW) a.plane[p] = root_of(a, p);
  }
}

// Each lane with ``want`` appends ``value`` to ``list``: one atomic per warp.
__device__ __forceinline__ void append(bool want, int value, unsigned* count,
                                       int* list) {
  const unsigned m = __ballot_sync(~0u, want);
  if (!m) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(~0u, base, leader);
  if (want) list[base + __popc(m & ((1u << lane) - 1))] = value;
}

// The cluster a pixel's centroid lands on: its basin's root, or slot HW
// (escape) off every basin. The end points lie inside the extent; an index
// past the grid is clamped so that no read leaves the plane. ``chase``: the
// plane is K12a's own, not compressed.
__device__ __forceinline__ int landing_slot(const Args& a, int p,
                                            bool chase) {
  const int HW = a.H * a.W;
  const int cy = min(max(__ldg(a.cent + p), 0), a.H - 1);
  const int cx = min(max(__ldg(a.cent + HW + p), 0), a.W - 1);
  const int v = __ldcg(a.plane + cy * a.W + cx);
  if (chase) return v == HW ? HW : find_root(a.plane, v & kIndex);
  return v >= HW || v < 0 ? HW : v;
}

__device__ __forceinline__ bool inside(const Args& a, int p) {
  return p / a.W < a.h_ext && p % a.W < a.w_ext;
}

// The key a candidate ranks by: the escape bucket first, then the slots.
__device__ __forceinline__ unsigned slot_key(int slot, int HW) {
  return slot == HW ? 0u : (unsigned)slot + 1u;
}

__device__ void candidates(const Args& a, bool label) {
  const int HW = a.H * a.W;
  const int lane = threadIdx.x & 31;
  unsigned* count = a.header + 1;
  for (int base = blockIdx.x * kThreads; base < HW;
       base += gridDim.x * kThreads) {
    const int p = base + threadIdx.x;
    const bool in = p < HW;
    if (a.rank == kTables) {
      const int l = in ? __ldg(a.labels + p) : 0;
      const int x = l > 0 ? __ldcg(a.plane + p) : HW;
      // the roots: K12a's tile roots that chase to themselves, or the
      // given plane's own entries
      const bool want =
          l > 0 && (x & kRootTag ? compress_tile_root(a, p, x) == p : x == p);
      append(want, l * HW + p, count, a.cand);
    } else {
      const bool mine = in && inside(a, p);
      const int slot = mine ? landing_slot(a, p, label) : -1;
      if (mine) a.slot_of[p] = slot;
      // one lane per slot in the warp tries to claim it
      const unsigned same = __match_any_sync(~0u, slot);
      bool claim = false;
      if (mine && lane == __ffs(same) - 1 && __ldcg(a.flags + slot) == 0)
        claim = atomicCAS(a.flags + slot, 0, 1) == 0;
      append(claim, (int)slot_key(slot, HW), count, a.cand);
    }
  }
}

// -- phase 4: the select ------------------------------------------------------

// The bin of the need-th smallest key by one of the global histograms, the
// keys below that bin and the bin's count, the same in every CTA: each
// thread sums 8 bins, a block scan finds the thread whose range holds it.
__device__ void find_bin(const unsigned* hist, int need, int* s_res) {
  constexpr int kPer = kBins / kThreads;
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int bins[kPer];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    bins[k] = (int)__ldcg(hist + threadIdx.x * kPer + k);
    sum += bins[k];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += warp_sum[w];
  int below = incl - sum;
  if (below < need && need <= incl) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (below + bins[k] >= need) {
        s_res[0] = threadIdx.x * kPer + k;
        s_res[1] = below;
        s_res[2] = bins[k];
        break;
      }
      below += bins[k];
    }
  }
  __syncthreads();
}

// Leaves in sel the ``need`` smallest of the n candidate keys (n > need),
// by radix select over their ``nbits`` bits.
__device__ void select_smallest(const Args& a, int n, int need, int nbits,
                                int* s_hist, unsigned& bar) {
  __shared__ int s_res[3];
  unsigned prefix = 0;
  int hi = nbits;  // bits [hi, nbits) resolved into prefix
  int shift = 0;
  for (int pass = 0; pass < kPasses; ++pass) {
    shift = max(hi - kRadixBits, 0);
    const unsigned digit = (1u << (hi - shift)) - 1;
    for (int i = threadIdx.x; i < kBins; i += kThreads) s_hist[i] = 0;
    __syncthreads();
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += gridDim.x * kThreads) {
      const unsigned key = (unsigned)__ldcg(a.cand + i);
      if ((key >> hi) == prefix)
        atomicAdd(s_hist + ((key >> shift) & digit), 1);
    }
    __syncthreads();
    unsigned* hist = a.header + kHeader + pass * kBins;
    for (int i = threadIdx.x; i < kBins; i += kThreads)
      if (s_hist[i]) atomicAdd(hist + i, (unsigned)s_hist[i]);
    irn::hopper::grid_barrier(a.header, ++bar);
    find_bin(hist, need, s_res);
    prefix = (prefix << (hi - shift)) | (unsigned)s_res[0];
    need -= s_res[1];
    // the bin holds exactly the keys still needed: every key up to it
    if (s_res[2] == need) break;
    hi = shift;
  }
  for (int base = blockIdx.x * kThreads; base < n;
       base += gridDim.x * kThreads) {
    const int i = base + threadIdx.x;
    const unsigned key = i < n ? (unsigned)__ldcg(a.cand + i) : 0;
    append(i < n && (key >> shift) <= prefix, (int)key, a.header + 2, a.sel);
  }
  irn::hopper::grid_barrier(a.header, ++bar);
}

// -- phase 5: rank and scatter ------------------------------------------------

// Shared-memory words sort_kept takes for m keys.
__host__ __device__ __forceinline__ int sort_words(int m) {
  int p2 = 1;
  while (p2 < m) p2 <<= 1;
  return m <= kThreads ? 2 * kThreads : p2;
}

// buf[0..m) = the m keys of list ascending (distinct), in each CTA: up to
// one key per thread, every key counts the smaller ones (the main path's 9
// and 129); more, a bitonic sort over the next power of two.
__device__ void sort_kept(const int* list, int m, unsigned* buf) {
  const int t = threadIdx.x;
  if (m <= kThreads) {
    unsigned* keys = buf + kThreads;
    if (t < m) keys[t] = (unsigned)__ldcg(list + t);
    __syncthreads();
    if (t < m) {
      const unsigned k = keys[t];
      int r = 0;
      for (int j = 0; j < m; ++j) r += keys[j] < k;
      buf[r] = k;
    }
    __syncthreads();
    return;
  }
  const int n = sort_words(m);
  for (int j = t; j < n; j += kThreads)
    buf[j] = j < m ? (unsigned)__ldcg(list + j) : UINT_MAX;
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n / 2; i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const unsigned a = buf[lo], b = buf[lo + stride];
        if ((a > b) == ((lo & size) == 0)) {
          buf[lo] = b;
          buf[lo + stride] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The rank of key among sorted[0..m), or -1 where it was not kept.
__device__ __forceinline__ int rank_of(const unsigned* sorted, int m,
                                       unsigned key) {
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sorted[mid] < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < m && sorted[lo] == key ? lo : -1;
}

__device__ void scatter_masks(const Args& a, const unsigned* sorted, int m) {
  const int HW = a.H * a.W;
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < HW;
       p += gridDim.x * kThreads) {
    const int r =
        inside(a, p) ? rank_of(sorted, m, slot_key(__ldcg(a.slot_of + p), HW))
                     : -1;
    for (int k = 0; k < a.cap; ++k) a.masks[(size_t)k * HW + p] = r == k;
  }
}

__device__ void scatter_tables(const Args& a, const unsigned* sorted, int m,
                               int* acc) {
  const int HW = a.H * a.W;
  const int cap = a.cap;
  const int stride = gridDim.x * kThreads;
  for (int k = threadIdx.x; k < 2 * cap; k += kThreads) acc[k] = 0;
  __syncthreads();
  // four pixels a thread at a time, their loads issued together
  for (int p0 = blockIdx.x * kThreads + threadIdx.x; p0 < HW;
       p0 += 4 * stride) {
    int l[4], t[4];
    float b[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + q * stride;
      l[q] = p < HW ? __ldg(a.labels + p) : 0;
      b[q] = p < HW ? __ldg(a.best + p) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      t[q] = l[q] > 0 ? __ldcg(a.plane + p0 + q * stride) & kIndex : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q)  // root_of, for four pixels
      t[q] = l[q] > 0 ? __ldcg(a.plane + t[q]) & kIndex : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = p0 + q * stride;
      if (p >= HW) continue;
      int id = 0;
      if (l[q] > 0) {
        const int r = rank_of(sorted, m, (unsigned)(l[q] * HW + t[q]));
        if (r >= 0 && r < cap) {
          id = r + 1;
          atomicAdd(acc + r, 1);
          atomicMax(acc + cap + r, __float_as_int(b[q]));
        }
      }
      a.comp_map[p] = id;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cap; k += kThreads) {
    if (acc[k]) {
      atomicAdd(a.sizes + k, acc[k]);
      atomicMax(reinterpret_cast<int*>(a.scores) + k, acc[cap + k]);
    }
  }
}

// -- the kernel ---------------------------------------------------------------

__device__ void zero_counters(const Args& a) {
  if (a.rank == kNone) return;
  const int stride = gridDim.x * kThreads;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t == 0) a.header[1] = a.header[2] = 0;
  for (int i = t; i < kPasses * kBins; i += stride) a.header[kHeader + i] = 0;
  if (a.rank == kClusters) {
    for (int i = t; i <= a.H * a.W; i += stride) a.flags[i] = 0;
  } else {
    for (int i = t; i < a.cap; i += stride) {
      a.sizes[i] = 0;
      a.scores[i] = 0.f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ccl_kernel(const Args a) {
  extern __shared__ int smem[];
  const bool label = a.vals != nullptr;
  unsigned bar = 0;
  zero_counters(a);
  if (label) label_tiles<T>(a, smem, smem + kTilePix);
  irn::hopper::grid_barrier(a.header, ++bar);
  if (label) {
    unite_borders<T>(a);
    irn::hopper::grid_barrier(a.header, ++bar);
    if (a.rank == kNone) {
      compress_tile_roots(a);
      irn::hopper::grid_barrier(a.header, ++bar);
      compress_pixels(a);
      return;
    }
  }
  candidates(a, label);
  irn::hopper::grid_barrier(a.header, ++bar);

  const int n = (int)__ldcg(a.header + 1);
  const int m = min(n, a.cap + 1);
  if (n > m) {
    const int nbits = a.rank == kClusters ? 32 - __clz(a.H * a.W) : 31;
    select_smallest(a, n, m, nbits, smem, bar);
  }
  unsigned* sorted = reinterpret_cast<unsigned*>(smem);
  sort_kept(n > m ? a.sel : a.cand, m, sorted);
  if (blockIdx.x == 0) {
    if (a.rank == kClusters) {
      if (threadIdx.x == 0) *a.n_found = m;
    } else {
      if (threadIdx.x == 0) *a.n_comp = m;
      for (int r = threadIdx.x; r < a.cap; r += kThreads)
        a.rows[r] = r < m ? (int)(sorted[r] / (unsigned)(a.H * a.W)) - 1 : 0;
    }
  }
  if (a.rank == kClusters)
    scatter_masks(a, sorted, m);
  else
    scatter_tables(a, sorted, m, smem + sort_words(m));
}

// CTAs of ccl_kernel<T> that the current device holds at once at the
// largest shared memory a launch asks for, and its SMs; cached per device.
template <typename T>
cudaError_t resident_ctas(int* resident, int* sms) {
  static std::atomic<int> cache[64][2];
  static std::atomic<unsigned long long> smem_set{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && cache[dev][0].load() > 0) {
    *resident = cache[dev][0].load();
    *sms = cache[dev][1].load();
    return cudaSuccess;
  }
  e = irn::allow_smem(ccl_kernel<T>, smem_set, kSmemMax);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ccl_kernel<T>,
                                                      kThreads, kSmemMax);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  *resident = per_sm * *sms;
  if (*resident < 1) return cudaErrorInvalidConfiguration;
  if (dev < 64) {
    cache[dev][1].store(*sms);
    cache[dev][0].store(*resident);
  }
  return cudaSuccess;
}

// The launch: zero the barrier counter, then one cooperative grid: a CTA
// per tile, at least one per kThreads pixels up to one per SM, at most
// what the card holds at once.
template <typename T>
int launch(const Args& a, cudaStream_t s, int* launched) {
  int resident = 0, sms = 0;
  cudaError_t e = resident_ctas<T>(&resident, &sms);
  if (e != cudaSuccess) return (int)e;
  const int tiles = ((a.H + kTile - 1) / kTile) * ((a.W + kTile - 1) / kTile);
  const int by_pixels = std::min((a.H * a.W + kThreads - 1) / kThreads, sms);
  const int smem =
      a.rank == kNone
          ? kSmemBase
          : std::max(kSmemBase, 4 * (sort_words(a.cap + 1) +
                                     (a.rank == kTables ? 2 * a.cap : 0)));
  e = cudaMemsetAsync(a.header, 0, sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(std::min(std::max(tiles, by_pixels), resident), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, ccl_kernel<T>, a);
  if (e != cudaSuccess) {
    cudaGetLastError();  // cleared, so that the next launch does not read it
    return (int)e;
  }
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

bool bad_grid(int H, int W) {
  return H < 1 || W < 1 || (long long)H * W >= (1LL << 30);
}

// Points the scratch arrays of ``a`` into ``scratch``
// (irn_ccl_scratch_words).
void carve(Args& a, int* scratch) {
  const int HW = a.H * a.W;
  a.header = reinterpret_cast<unsigned*>(scratch);
  int* next = scratch + kHeaderWords;
  if (a.rank == kClusters) {
    a.flags = next;
    a.slot_of = a.flags + HW + 1;
    next = a.slot_of + HW;
  }
  a.cand = next;
  a.sel = a.cand + HW + 1;
}

}  // namespace

// Scratch words a K12b call needs beside its outputs (the header, for the
// cluster masks the slot flags and each pixel's slot, the candidates and
// the kept keys), for a grid of HW pixels and a cap.
IRN_API int irn_ccl_scratch_words(int HW, int cap, int clusters) {
  return kHeaderWords + (clusters ? 2 * HW + 1 : 0) + HW + 1 + cap + 1;
}

// K12a. vals: [H, W] uint8 mask (is_u8, cut to [h_ext, w_ext]) or int32
// label map; out: [H, W] int32; header: 1 int32 (the barrier counter).
IRN_API int irn_ccl_label(const void* vals, int is_u8, int* out,
                          int* header, int H, int W, int h_ext, int w_ext,
                          void* stream, int* launched) {
  if (bad_grid(H, W) || h_ext < 0 || w_ext < 0)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.vals = vals;
  a.plane = out;
  a.header = reinterpret_cast<unsigned*>(header);
  a.H = H;
  a.W = W;
  a.h_ext = is_u8 ? h_ext : H;
  a.w_ext = is_u8 ? w_ext : W;
  a.rank = kNone;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_u8 ? launch<uint8_t>(a, s, launched) : launch<int>(a, s, launched);
}

// K12b, cluster masks, with K12a on the basin first when ``basin`` is not
// null (lab is then written: [H, W] int32 scratch), else on the given K12a
// plane lab. cent: [2, H, W] int32 inside [h4, w4]; masks: [k_cap, H, W]
// uint8; n_found: int32; scratch: irn_ccl_scratch_words(HW, k_cap, 1)
// int32. k_cap <= 4096.
IRN_API int irn_cluster_masks(const uint8_t* basin, int* lab, const int* cent,
                              uint8_t* masks, int* n_found, int* scratch,
                              int H, int W, int h4, int w4, int k_cap,
                              void* stream, int* launched) {
  if (bad_grid(H, W) || h4 < 1 || h4 > H || w4 < 1 || w4 > W || k_cap < 1 ||
      k_cap > kCapMax)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.vals = basin;
  a.plane = lab;
  a.cent = cent;
  a.masks = masks;
  a.n_found = n_found;
  a.H = H;
  a.W = W;
  a.h_ext = h4;
  a.w_ext = w4;
  a.rank = kClusters;
  a.cap = k_cap;
  carve(a, scratch);
  return launch<uint8_t>(a, static_cast<cudaStream_t>(stream), launched);
}

// K12b, component tables, with K12a on the labels first when ``label``
// (minidx is then written: [H, W] int32 scratch), else on the given K12a
// plane minidx. labels: [H, W] int32; best: [H, W] f32; comp_map: [H, W]
// int32; rows, sizes: [cap] int32; scores: [cap] f32; n_comp: int32;
// scratch: irn_ccl_scratch_words(HW, cap, 0) int32. label * HW + root
// must fit int32; cap <= 4096.
IRN_API int irn_component_tables(const int* labels, int* minidx, int label,
                                 const float* best, int* comp_map, int* rows,
                                 int* sizes, float* scores, int* n_comp,
                                 int* scratch, int H, int W, int cap,
                                 void* stream, int* launched) {
  if (bad_grid(H, W) || cap < 1 || cap > kCapMax)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.vals = label ? labels : nullptr;
  a.plane = minidx;
  a.labels = labels;
  a.best = best;
  a.comp_map = comp_map;
  a.rows = rows;
  a.sizes = sizes;
  a.scores = scores;
  a.n_comp = n_comp;
  a.H = H;
  a.W = W;
  a.h_ext = H;
  a.w_ext = W;
  a.rank = kTables;
  a.cap = cap;
  carve(a, scratch);
  return launch<int>(a, static_cast<cudaStream_t>(stream), launched);
}
