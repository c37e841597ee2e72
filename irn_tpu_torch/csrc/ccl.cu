// K12 ccl: the instance stage's connected components (K12a) and rank tables
// (K12b).
//
// Replaces: irn_tpu/ops/ccl_tpu.py min_label_plane / min_label_plane_multi
// (XLA segmented min-scans under a while_loop to the fixpoint; in eager
// PyTorch one host sync per sweep) and cluster_masks / component_tables
// (XLA scans of k_cap + 1 and comp_cap + 1 sequential masked minimums).
//
// K12a: every pixel with a nonzero value gets the smallest flat index of its
// 4-connected same-value component, every other pixel H*W. The fixpoint is
// unique, so a union-find gives it: init (parent = self), merge (each pixel
// unites with its left and upper neighbours of equal value; a union links
// the larger root under the smaller with atomicMin, so each root is its
// component's smallest index), compress (parent = root). Three launches, no
// host sync; parents are read through L2 (__ldcg), where the atomics land.
// The input is a uint8 mask cut to an extent (the basin) or an int32 label
// map (0 or below background).
//
// K12b ranks the distinct values ascending: the component roots. Candidates
// are compacted by atomics (cluster masks: the slots some centroid lands on,
// the escape bucket -1 first; tables: key = label * HW + root), each ranks
// itself by counting the smaller keys (staged through shared memory), and a
// scatter pass writes the [k_cap, H, W] masks and n_found, or the id map,
// rows, sizes (atomicAdd) and max scores (atomicMax on the f32 bits: the
// scores are floored at 0, where integer order is float order), summed per
// block in shared memory first, and n_comp. Three launches each, after a
// memset of the counters.
//
// Bound on this card: bytes, in principle (a few MB at 512 x 512), but the
// unions' pointer chasing and the atomics make both latency-bound; the
// rank pass costs candidates^2 comparisons (a few hundred candidates on the
// stage's maps).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// -- K12a ------------------------------------------------------------------

// The value a pixel carries for the labeling, 0 off the foreground: a mask
// inside its extent is 1, a label map keeps its positive values.
__device__ __forceinline__ int value_at(const uint8_t* v, int p, int r, int c,
                                        int h_ext, int w_ext) {
  return (r < h_ext && c < w_ext && v[p] != 0) ? 1 : 0;
}

__device__ __forceinline__ int value_at(const int* v, int p, int, int, int,
                                        int) {
  const int x = v[p];
  return x > 0 ? x : 0;
}

__device__ __forceinline__ int find_root(const int* L, int x) {
  int p = __ldcg(L + x);
  while (p != x) {
    x = p;
    p = __ldcg(L + x);
  }
  return x;
}

// Link the components of a and b: the larger root under the smaller. A
// root that another thread relinked meanwhile is followed and retried.
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
    const int old = atomicMin(L + a, b);
    if (old == a) return;
    a = old;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
label_init(const T* __restrict__ vals, int* __restrict__ L, int H, int W,
           int h_ext, int w_ext) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  L[p] = value_at(vals, p, p / W, p % W, h_ext, w_ext) ? p : H * W;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
label_merge(const T* __restrict__ vals, int* L, int H, int W, int h_ext,
            int w_ext) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int r = p / W;
  const int c = p % W;
  const int v = value_at(vals, p, r, c, h_ext, w_ext);
  if (!v) return;
  if (c > 0 && value_at(vals, p - 1, r, c - 1, h_ext, w_ext) == v)
    unite(L, p, p - 1);
  if (r > 0 && value_at(vals, p - W, r - 1, c, h_ext, w_ext) == v)
    unite(L, p, p - W);
}

__global__ void __launch_bounds__(kThreads)
label_compress(int* L, int HW) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW || __ldcg(L + p) == HW) return;
  L[p] = find_root(L, p);
}

template <typename T>
int label(const T* vals, int* out, int H, int W, int h_ext, int w_ext,
          cudaStream_t s, int* launched) {
  const int blocks = (H * W + kThreads - 1) / kThreads;
  label_init<T><<<blocks, kThreads, 0, s>>>(vals, out, H, W, h_ext, w_ext);
  IRN_CHECK_LAUNCH(launched);
  label_merge<T><<<blocks, kThreads, 0, s>>>(vals, out, H, W, h_ext, w_ext);
  IRN_CHECK_LAUNCH(launched);
  label_compress<<<blocks, kThreads, 0, s>>>(out, H * W);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// -- K12b ------------------------------------------------------------------

// Each candidate's rank among the *count distinct keys = the keys below it.
// Tables: key = label * HW + root; rank_at[root] = rank, rows[rank] =
// label - 1 under the cap. Cluster masks: key = slot (-1 the escape bucket,
// kept in slot HW); rank_at[slot] = rank.
template <bool kTables>
__global__ void __launch_bounds__(kThreads)
rank_keys(const int* __restrict__ cand, const int* __restrict__ count,
          int* __restrict__ rank_at, int* __restrict__ rows, int HW,
          int cap) {
  __shared__ int tile[kThreads];
  const int n = *count;
  if (blockIdx.x * kThreads >= n) return;  // the whole block is idle
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const int key = i < n ? cand[i] : 0;
  int rank = 0;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    __syncthreads();
    if (j0 + threadIdx.x < n) tile[threadIdx.x] = cand[j0 + threadIdx.x];
    __syncthreads();
    const int m = min(kThreads, n - j0);
    for (int j = 0; j < m; ++j) rank += tile[j] < key;
  }
  if (i >= n) return;
  if constexpr (kTables) {
    rank_at[key % HW] = rank;
    if (rank < cap) rows[rank] = key / HW - 1;
  } else {
    rank_at[key < 0 ? HW : key] = rank;
  }
}

// The cluster a pixel's centroid lands on: its basin's root, or slot HW
// (escape) off every basin. The end points lie inside the extent; an index
// past the grid is clamped so that no read leaves the plane.
__device__ __forceinline__ int landing_slot(const int* __restrict__ lab,
                                            const int* __restrict__ cent,
                                            int p, int H, int W) {
  const int HW = H * W;
  const int cy = min(max(cent[p], 0), H - 1);
  const int cx = min(max(cent[HW + p], 0), W - 1);
  const int v = lab[cy * W + cx];
  return v >= HW ? HW : v;
}

__global__ void __launch_bounds__(kThreads)
cluster_candidates(const int* __restrict__ lab, const int* __restrict__ cent,
                   int* taken, int* cand, int* count, int H, int W, int h4,
                   int w4) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int HW = H * W;
  if (p >= HW || p / W >= h4 || p % W >= w4) return;
  const int slot = landing_slot(lab, cent, p, H, W);
  if (atomicExch(taken + slot, 1) == 0)
    cand[atomicAdd(count, 1)] = slot == HW ? -1 : slot;
}

__global__ void __launch_bounds__(kThreads)
cluster_scatter(const int* __restrict__ lab, const int* __restrict__ cent,
                const int* __restrict__ rank_at,
                const int* __restrict__ count, uint8_t* __restrict__ masks,
                int* __restrict__ n_found, int H, int W, int h4, int w4,
                int k_cap) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const int HW = H * W;
  if (p == 0) *n_found = min(*count, k_cap + 1);
  if (p >= HW) return;
  int r = -1;
  if (p / W < h4 && p % W < w4)
    r = rank_at[landing_slot(lab, cent, p, H, W)];
  for (int k = 0; k < k_cap; ++k) masks[(size_t)k * HW + p] = r == k;
}

__global__ void __launch_bounds__(kThreads)
table_candidates(const int* __restrict__ labels,
                 const int* __restrict__ minidx, int* cand, int* count,
                 int HW) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= HW) return;
  const int l = labels[p];
  if (l > 0 && minidx[p] == p) cand[atomicAdd(count, 1)] = l * HW + p;
}

__global__ void __launch_bounds__(kThreads)
table_scatter(const int* __restrict__ labels, const int* __restrict__ minidx,
              const float* __restrict__ best,
              const int* __restrict__ rank_at, const int* __restrict__ count,
              int* __restrict__ comp_map, int* sizes, float* scores,
              int* __restrict__ n_comp, int HW, int cap) {
  extern __shared__ int acc[];  // [cap] sizes, then [cap] score bits
  for (int k = threadIdx.x; k < 2 * cap; k += kThreads) acc[k] = 0;
  __syncthreads();
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p == 0) *n_comp = min(*count, cap + 1);
  if (p < HW) {
    int id = 0;
    if (labels[p] > 0) {
      const int r = rank_at[minidx[p]];
      if (r < cap) {
        id = r + 1;
        atomicAdd(acc + r, 1);
        atomicMax(acc + cap + r, __float_as_int(best[p]));
      }
    }
    comp_map[p] = id;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cap; k += kThreads) {
    if (acc[k]) {
      atomicAdd(sizes + k, acc[k]);
      atomicMax(reinterpret_cast<int*>(scores) + k, acc[cap + k]);
    }
  }
}

}  // namespace

// K12a. vals: [H, W] uint8 mask (is_u8, cut to [h_ext, w_ext]) or int32
// label map; out: [H, W] int32.
IRN_API int irn_ccl_label(const void* vals, int is_u8, int* out, int H, int W,
                          int h_ext, int w_ext, void* stream, int* launched) {
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 30) || h_ext < 0 ||
      w_ext < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_u8)
    return label(static_cast<const uint8_t*>(vals), out, H, W, h_ext, w_ext,
                 s, launched);
  return label(static_cast<const int*>(vals), out, H, W, H, W, s, launched);
}

// K12b, cluster masks. lab: [H, W] int32 (K12a); cent: [2, H, W] int32
// inside [h4, w4]; masks: [k_cap, H, W] uint8; n_found: int32; scratch:
// 2 (HW + 1) + 1 int32 (slot flags then ranks, candidates, their count).
IRN_API int irn_cluster_masks(const int* lab, const int* cent,
                              uint8_t* masks, int* n_found, int* scratch,
                              int H, int W, int h4, int w4, int k_cap,
                              void* stream, int* launched) {
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 30) || h4 < 1 ||
      h4 > H || w4 < 1 || w4 > W || k_cap < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  int* rank_at = scratch;
  int* cand = scratch + HW + 1;
  int* count = cand + HW + 1;
  cudaError_t e = cudaMemsetAsync(scratch, 0, sizeof(int) * (2 * (HW + 1) + 1),
                                  s);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (HW + kThreads - 1) / kThreads;
  cluster_candidates<<<blocks, kThreads, 0, s>>>(lab, cent, rank_at, cand,
                                                 count, H, W, h4, w4);
  IRN_CHECK_LAUNCH(launched);
  rank_keys<false><<<(HW + 1 + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      cand, count, rank_at, nullptr, HW, k_cap);
  IRN_CHECK_LAUNCH(launched);
  cluster_scatter<<<blocks, kThreads, 0, s>>>(lab, cent, rank_at, count,
                                              masks, n_found, H, W, h4, w4,
                                              k_cap);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// K12b, component tables. labels, minidx (K12a of labels): [H, W] int32;
// best: [H, W] f32; comp_map: [H, W] int32; rows, sizes: [cap] int32;
// scores: [cap] f32; n_comp: int32; scratch: 2 HW + 1 int32 (ranks by root,
// candidate keys, their count). label * HW + root must fit int32.
IRN_API int irn_component_tables(const int* labels, const int* minidx,
                                 const float* best, int* comp_map, int* rows,
                                 int* sizes, float* scores, int* n_comp,
                                 int* scratch, int H, int W, int cap,
                                 void* stream, int* launched) {
  if (H < 1 || W < 1 || (long long)H * W >= (1LL << 30) || cap < 1 ||
      cap > 4096)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int HW = H * W;
  int* rank_at = scratch;
  int* cand = scratch + HW;
  int* count = cand + HW;
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(rows, 0, sizeof(int) * cap, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(sizes, 0, sizeof(int) * cap, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(scores, 0, sizeof(float) * cap, s);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (HW + kThreads - 1) / kThreads;
  table_candidates<<<blocks, kThreads, 0, s>>>(labels, minidx, cand, count,
                                               HW);
  IRN_CHECK_LAUNCH(launched);
  rank_keys<true><<<blocks, kThreads, 0, s>>>(cand, count, rank_at, rows, HW,
                                              cap);
  IRN_CHECK_LAUNCH(launched);
  table_scatter<<<blocks, kThreads, 2 * cap * sizeof(int), s>>>(
      labels, minidx, best, rank_at, count, comp_map, sizes, scores, n_comp,
      HW, cap);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
