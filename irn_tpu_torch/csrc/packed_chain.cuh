// The chain body shared by K3 packed_chain, K7 banded_chain and K8
// packed_chain_batched: x @ T^n_apply over T's band tiles, every
// application in one cooperative launch, reading only the tiles' nonzero
// entries.
//
// One application: out[c, j*bs + b] = sum_s xpad[c, j*bs + s] * tile_j[s, b]
// with xpad = x zero-padded by kh*bs columns on both sides, s < span =
// (2kh+1)*bs, and tile_j the rows [(j-kh)*bs, (j+kh+1)*bs) of T's column
// block j (zero past the matrix edge). Where tile_j's elements come from is
// the source's (``Src``): K1's packed tiles (PackedTiles, K3 and K8) or the
// dense T masked to its band (MaskedBand, K7).
//
// Design: one cooperative launch per chain (a refused launch returns its
// error, no fallback), one CTA per SM (the plan,
// matpow_kernels.packed_chain_plan, gives each CTA items_per_cta whole
// items and all the shared memory the card allows). An item is one (tile j,
// 32-column strip): lane = column. A launch may run several images (K8):
// each image has its own ``cpi`` consecutive CTAs, so a CTA's items never
// span two images, and every pointer below is the image's own.
// - Prologue, once per chain: each CTA reads its items' tile columns twice
//   (count, fill) and packs their nonzero entries, per quarter-slot (the
//   bs/4 tile rows of one slot that one fmaf chain runs over), in ELL form:
//   entry k of lane l is the k-th nonzero of column l in row order (its
//   value and its row), and the lanes with fewer nonzeros are padded with
//   zeros up to the longest, so a warp reads one 128-byte line of values per
//   entry. NaN counts as nonzero. As many entries as fit, in order, stay in
//   shared memory for the whole chain (an equal share per item, what one
//   item does not use going to the next); the rest go to a global scratch
//   and are read from L2. Per item it reports (occupied row segments,
//   entries, held entries).
// - Each application, per group of 8 seed rows and per slot m (the bs rows
//   of the tile that contract x block j + m - kh): the x blocks the CTA's
//   items need are staged in shared memory as two [s][4 seed rows] halves
//   (loaded into registers with ld.global.cg two slots ahead, one under
//   the kBatch tuning below); warp (item, quarter u) runs the quarter's fmaf
//   chain over its entries in order, four entries' values and rows (eight
//   under kBatch) loaded while the previous four's products run, each
//   entry's 8 x values two 128-bit loads at its own row (16-byte rows: a
//   warp at consecutive rows meets no bank twice).
//   Then warp (item, u) adds the item's quarters in order 0..3 for two seed
//   rows, and the slots in order 0..2kh, a slot past the matrix edge adding
//   0: a block x past the image's own edge is never read. Each column's
//   chain is the in-order fmaf chain over the tile rows with its zero
//   entries left out (fmaf(x, 0, acc) == acc for finite x), and the order
//   of sums is fixed, so K3, K7 and K8 give the same bits on the same tile
//   elements whatever the plan and tuning.
// - Thread 0 of each CTA counts its clock in each phase (prologue, grid
//   barriers, x waits, products, sums) into ``timing``.
// - x ping-pongs between two [C, n] global buffers per image (L2-resident);
//   a grid barrier (hopper.cuh: release/acquire counter whose wait traps)
//   between applications serves every image of the launch at once.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <cstdint>

namespace irn {
namespace chain {

constexpr int kStrip = 32;    // columns per item (one warp, lane = column)
constexpr int kRows = 8;      // seed rows per group
constexpr int kQuarters = 4;  // warps per item and slot
constexpr int kScan = 16;     // tile rows loaded together in the prologue
constexpr int kMaxThreads = 512;

struct Geometry {
  int C, n, bs, kh, nb, span, strips, items, nqs;  // one image's
  int cpi;       // CTAs per image
  int ipc;       // items per CTA
  int x_blocks;  // x blocks staged per slot
  int slots;     // held entries per CTA
};

// Shared-memory layout (bytes), the same sums as the plan's.
struct Layout {
  size_t xs, red, tot, qs, meta, val, row, total;
};

__host__ __device__ inline Layout layout(const Geometry& g) {
  Layout l;
  l.xs = 0;  // x_blocks x 2 halves x [bs][kRows / 2]
  l.red = l.xs + (size_t)4 * g.x_blocks * kRows * g.bs;
  l.tot = l.red + (size_t)4 * g.ipc * kQuarters * kRows * kStrip;
  l.qs = l.tot + (size_t)4 * g.ipc * kRows * kStrip;
  l.meta = l.qs + (size_t)8 * g.ipc * g.nqs;
  l.val = l.meta + (size_t)32 * g.ipc;
  l.row = l.val + (size_t)4 * kStrip * g.slots;
  l.total = l.row + (size_t)2 * kStrip * g.slots;
  return l;
}

// K1's packed tiles [nb, span, bs] (K3, K8): tile row s of the lane's
// column is tp[j, s, strip * 32 + lane].
struct PackedTiles {
  const float* tp;
  int bs, span, strips;

  struct Column {
    const float* p;
  };
  __device__ __forceinline__ Column column(int gi, int lane) const {
    return {tp + (size_t)(gi / strips) * span * bs + (gi % strips) * kStrip +
            lane};
  }
  __device__ __forceinline__ float at(const Column& c, int s) const {
    return __ldg(c.p + (size_t)s * bs);
  }
};

// The dense T [n, n] masked to its band (K7): tile row s of column c (in
// block j) is T[(j - kh)*bs + s, c] if that row lies in the matrix and
// within h of c, else 0. The mask is a select, so a NaN outside the band
// (K2's unspecified fill) is dropped before the nonzero test.
struct MaskedBand {
  const float* t;
  int n, bs, kh, h, strips;

  struct Column {
    const float* p;
    int r0, c;
  };
  __device__ __forceinline__ Column column(int gi, int lane) const {
    const int j = gi / strips;
    const int c = j * bs + (gi % strips) * kStrip + lane;
    return {t + c, (j - kh) * bs, c};
  }
  __device__ __forceinline__ float at(const Column& c, int s) const {
    const int r = c.r0 + s;
    float v = 0.f;
    if (r >= 0 && r < n) {
      v = __ldg(c.p + (size_t)r * n);
      v = abs(r - c.c) <= h ? v : 0.f;
    }
    return v;
  }
};

// The chain of one CTA, number ``cta`` of its image's g.cpi. x, out,
// scratch: the image's [C, n]; stats: the image's [items, 3]; ell_val /
// ell_row: the image's [items, span, 32] scratch; timing: [gridDim.x, 5].
// kPre: float4 of a slot's x that each thread prefetches (2 or 4). kBatch:
// the tuning for a launch of several images (K8), whose CTAs hold few of
// their entries (about 18% at 4 images, n 14336) and stream the rest from
// the scratch in L2 or device memory, bound by that stream's latency: each
// warp loads 8 entries together (and 8 ahead) instead of 4, and stages x
// one slot ahead instead of two (its steps are long enough to hide that
// load, and its registers go to the entries).
template <int kPre, bool kBatch, class Src>
__device__ __forceinline__ void run(const float* __restrict__ x,
                                    const Src& src, float* out,
                                    float* scratch, unsigned* counter,
                                    int* __restrict__ stats,
                                    long long* __restrict__ timing,
                                    float* __restrict__ ell_val,
                                    uint16_t* __restrict__ ell_row,
                                    const Geometry& g, int cta, int n_apply) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout(g);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* tot = reinterpret_cast<float*>(smem + L.tot);
  int* qs = reinterpret_cast<int*>(smem + L.qs);  // per quarter-slot: off, L
  // per item: occupied row segments, entries, base slot, budget
  int* meta = reinterpret_cast<int*>(smem + L.meta);
  float* val = reinterpret_cast<float*>(smem + L.val);
  uint16_t* row = reinterpret_cast<uint16_t*>(smem + L.row);

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int u = warp % kQuarters;
  const int iw = blockDim.x / (32 * kQuarters);  // item lanes
  const int il = warp / kQuarters;
  const int first = cta * g.ipc;
  const int jt0 = first / g.strips;
  const int nblk = (min(first + g.ipc, g.items) - 1) / g.strips - jt0 + 1;
  const int q = g.bs / kQuarters;
  const int nslot = 2 * g.kh + 1;
  constexpr int kGroup = kBatch ? 8 : 4;  // entries loaded together

  // thread 0's clock in each phase: prologue, grid barriers, x waits,
  // products, sums
  long long clk[5] = {0, 0, 0, 0, 0};
  long long t_mark = clock64();
  auto lap = [&](int phase) {
    const long long now = clock64();
    clk[phase] += now - t_mark;
    t_mark = now;
  };

  // -- prologue ----------------------------------------------------------------
  for (int e = threadIdx.x; e < 8 * g.ipc; e += blockDim.x) meta[e] = 0;
  __syncthreads();
  // count: each quarter-slot's longest column (L) and the occupied rows
  for (int i = il; i < g.ipc; i += iw) {
    const int gi = first + i;
    const auto col = src.column(gi, lane);
    int occupied = 0;
    for (int m = 0; m < nslot; ++m) {
      int cnt = 0;
      if (gi < g.items) {
        for (int b = 0; b < q; b += kScan) {
          const int s0 = m * g.bs + u * q + b;
          float v[kScan];
#pragma unroll
          for (int t = 0; t < kScan; ++t) v[t] = src.at(col, s0 + t);
#pragma unroll
          for (int t = 0; t < kScan; ++t) {
            cnt += v[t] != 0.f;
            occupied += __any_sync(0xffffffffu, v[t] != 0.f);
          }
        }
      }
      const int longest = __reduce_max_sync(0xffffffffu, cnt);
      if (lane == 0) qs[2 * (i * g.nqs + m * kQuarters + u) + 1] = longest;
    }
    if (lane == 0) atomicAdd(&meta[8 * i], occupied);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g.ipc; i += blockDim.x) {
    int off = 0;  // each quarter-slot's first entry
    for (int k = 0; k < g.nqs; ++k) {
      qs[2 * (i * g.nqs + k)] = off;
      off += qs[2 * (i * g.nqs + k) + 1];
    }
    meta[8 * i + 1] = off;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // shares of the entry slots
    int left = g.slots, base = 0;
    for (int i = 0; i < g.ipc; ++i) {
      const int budget = min(meta[8 * i + 1], left / (g.ipc - i));
      meta[8 * i + 2] = base;
      meta[8 * i + 3] = budget;
      base += budget;
      left -= budget;
      if (first + i < g.items) {
        stats[3 * (first + i)] = meta[8 * i];
        stats[3 * (first + i) + 1] = meta[8 * i + 1];
        stats[3 * (first + i) + 2] = budget;
      }
    }
  }
  __syncthreads();
  // fill: entry e of item i at slot base + e if e < budget, else in the
  // item's span of the global scratch
  for (int i = il; i < g.ipc; i += iw) {
    const int gi = first + i;
    if (gi >= g.items) continue;
    const auto col = src.column(gi, lane);
    const int base = meta[8 * i + 2], budget = meta[8 * i + 3];
    auto put = [&](int e, float v, int r) {
      if (e < budget) {
        val[(size_t)(base + e) * kStrip + lane] = v;
        row[(size_t)(base + e) * kStrip + lane] = (uint16_t)r;
      } else {
        const size_t o = ((size_t)gi * g.span + e) * kStrip + lane;
        ell_val[o] = v;
        ell_row[o] = (uint16_t)r;
      }
    };
    for (int m = 0; m < nslot; ++m) {
      const int* qe = qs + 2 * (i * g.nqs + m * kQuarters + u);
      const int off = qe[0], longest = qe[1];
      int k = 0;
      for (int b = 0; b < q; b += kScan) {
        const int s0 = m * g.bs + u * q + b;
        float v[kScan];
#pragma unroll
        for (int t = 0; t < kScan; ++t) v[t] = src.at(col, s0 + t);
#pragma unroll
        for (int t = 0; t < kScan; ++t)
          if (v[t] != 0.f) put(off + k++, v[t], b + t);
      }
      for (; k < longest; ++k) put(off + k, 0.f, 0);  // padding: adds 0
    }
  }
  __syncthreads();

  // -- the chain ---------------------------------------------------------------
  const int ngroups = (g.C + kRows - 1) / kRows;
  const int steps = ngroups * nslot;
  const int row4 = g.bs / 4;  // float4 per x row of a block
  const int total4 = g.x_blocks * kRows * row4;
  float4 pre_a[kPre], pre_b[kPre];
  const float* x_src = x;

  // this thread's float4 elements of a slot's staged x: element e is
  // (block, s4, c) with c fastest, so the transposed stores into
  // [half][s][kRows / 2] spread over the banks. Per element: its offset in
  // x at seed row c0 = 0 and slot m = kh, its block and row (-1: none), and
  // its place in shared memory
  int p_src[kPre], p_info[kPre], p_dst[kPre];
#pragma unroll
  for (int p = 0; p < kPre; ++p) {
    const int e = threadIdx.x + p * blockDim.x;
    const int c = e % kRows;
    const int s4 = (e / kRows) % row4;
    const int blk = e / (kRows * row4);
    p_info[p] = e < total4 && blk < nblk ? blk * kRows + c : -1;
    p_src[p] = c * g.n + (jt0 + blk) * g.bs + 4 * s4;
    p_dst[p] = ((blk * 2 + c / 4) * g.bs + 4 * s4) * 4 + c % 4;
  }

  // step st's x blocks into pre (rows past C, blocks past the image's edge:
  // zeros)
  auto prefetch = [&](float4 (&pre)[kPre], int st) {
    const int c0 = (st / nslot) * kRows;
    const int m = st % nslot;
#pragma unroll
    for (int p = 0; p < kPre; ++p) {
      pre[p] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int sb = jt0 + p_info[p] / kRows + m - g.kh;
      if (p_info[p] >= 0 && sb >= 0 && sb < g.nb &&
          c0 + p_info[p] % kRows < g.C)
        pre[p] = __ldcg(reinterpret_cast<const float4*>(
            x_src + p_src[p] + (size_t)c0 * g.n + (m - g.kh) * g.bs));
    }
  };
  auto stage = [&](const float4 (&pre)[kPre]) {
#pragma unroll
    for (int p = 0; p < kPre; ++p) {
      if (p_info[p] >= 0) {
        float* d = xs + p_dst[p];
        d[0] = pre[p].x;
        d[4] = pre[p].y;
        d[8] = pre[p].z;
        d[12] = pre[p].w;
      }
    }
  };

  for (int a = 0; a < n_apply; ++a) {
    float* dst = ((n_apply - 1 - a) % 2 == 0) ? out : scratch;
    if (a == 0) lap(0);
    if (a > 0) {
      hopper::grid_barrier(counter, (unsigned)a);
      lap(1);
    }
    // x two steps ahead: at step st, ``cur`` holds step st + 1's loads in
    // flight and ``nxt`` takes step st + 2's; with kBatch one step ahead,
    // ``cur`` takes step st + 1's
    prefetch(pre_a, 0);
    stage(pre_a);
    if (!kBatch && steps > 1) prefetch(pre_a, 1);
    __syncthreads();
    lap(2);
    auto step = [&](int st, float4 (&cur)[kPre], float4 (&nxt)[kPre]) {
      const int c0 = (st / nslot) * kRows;
      const int m = st % nslot;
      if (kBatch) {
        if (st + 1 < steps) prefetch(cur, st + 1);
      } else if (st + 2 < steps) {
        prefetch(nxt, st + 2);
      }

      // quarter chains of slot m into red[i][u]
      for (int i = il; i < g.ipc; i += iw) {
        const int gi = first + i;
        if (gi >= g.items) continue;
        const int j = gi / g.strips;
        const int sb = j + m - g.kh;
        if (sb < 0 || sb >= g.nb) continue;  // the reduce adds 0
        // x of seed rows c0 .. c0+3 at tile row m*bs + u*q + r: xlo + 4r;
        // of c0+4 .. c0+7: xhi + 4r (16-byte rows, so a warp's loads at
        // consecutive rows hit every bank once)
        const float* xlo = xs + ((size_t)(j - jt0) * 2 * g.bs + u * q) * 4;
        const float* xhi = xlo + (size_t)g.bs * 4;
        const int* qe = qs + 2 * (i * g.nqs + m * kQuarters + u);
        const int off = qe[0], longest = qe[1];
        const int base = meta[8 * i + 2], budget = meta[8 * i + 3];
        // entries e0 .. e0 + kGroup - 1 of the quarter-slot (0 past its end)
        auto fetch = [&](float (&v)[kGroup], int (&r)[kGroup], int e0) {
#pragma unroll
          for (int t = 0; t < kGroup; ++t) {
            const int e = off + e0 + t;
            v[t] = 0.f;
            r[t] = 0;
            if (e0 + t < longest) {
              if (e < budget) {
                v[t] = val[(size_t)(base + e) * kStrip + lane];
                r[t] = row[(size_t)(base + e) * kStrip + lane];
              } else {
                const size_t o = ((size_t)gi * g.span + e) * kStrip + lane;
                v[t] = __ldcg(ell_val + o);
                r[t] = __ldcg(ell_row + o);
              }
            }
          }
        };
        float acc[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
        if (longest > 0) {
          float cv[kGroup], nv[kGroup];
          int cr[kGroup], nr[kGroup];
          fetch(cv, cr, 0);
          for (int e0 = 0; e0 < longest; e0 += kGroup) {
            if (e0 + kGroup < longest) fetch(nv, nr, e0 + kGroup);
#pragma unroll
            for (int t = 0; t < kGroup; ++t) {
              if (e0 + t >= longest) break;
              const float4 xa =
                  *reinterpret_cast<const float4*>(xlo + cr[t] * 4);
              const float4 xb =
                  *reinterpret_cast<const float4*>(xhi + cr[t] * 4);
              acc[0] = fmaf(xa.x, cv[t], acc[0]);
              acc[1] = fmaf(xa.y, cv[t], acc[1]);
              acc[2] = fmaf(xa.z, cv[t], acc[2]);
              acc[3] = fmaf(xa.w, cv[t], acc[3]);
              acc[4] = fmaf(xb.x, cv[t], acc[4]);
              acc[5] = fmaf(xb.y, cv[t], acc[5]);
              acc[6] = fmaf(xb.z, cv[t], acc[6]);
              acc[7] = fmaf(xb.w, cv[t], acc[7]);
            }
#pragma unroll
            for (int t = 0; t < kGroup; ++t) {
              cv[t] = nv[t];
              cr[t] = nr[t];
            }
          }
        }
        float* rq = red + (size_t)(i * kQuarters + u) * kRows * kStrip + lane;
#pragma unroll
        for (int r = 0; r < kRows; ++r) rq[r * kStrip] = acc[r];
      }
      __syncthreads();  // red is written; x of step st is no longer read
      lap(3);

      // quarters in order into the slot's part, slots in order into tot;
      // the last slot writes dst. Warp (item, u) sums the item's seed rows
      // 2u and 2u + 1.
      for (int i = il; i < g.ipc; i += iw) {
        const int gi = first + i;
        if (gi >= g.items) continue;
        const int j = gi / g.strips;
        const int sb = j + m - g.kh;
#pragma unroll
        for (int k = 0; k < kRows / kQuarters; ++k) {
          const int r = u * (kRows / kQuarters) + k;
          const int rc = r * kStrip + lane;
          float part = 0.f;
          if (sb >= 0 && sb < g.nb) {
            const float* rr = red + (size_t)i * kQuarters * kRows * kStrip + rc;
            part = rr[0];
#pragma unroll
            for (int uu = 1; uu < kQuarters; ++uu)
              part = __fadd_rn(part, rr[uu * kRows * kStrip]);
          }
          float* t_ = tot + (size_t)i * kRows * kStrip + rc;
          const float v = m == 0 ? part : __fadd_rn(*t_, part);
          if (m + 1 < nslot)
            *t_ = v;
          else if (c0 + r < g.C)
            dst[(size_t)(c0 + r) * g.n + (size_t)j * g.bs +
                (gi % g.strips) * kStrip + lane] = v;
        }
      }
      lap(4);
      if (st + 1 < steps) stage(cur);
      __syncthreads();  // step st + 1's x is staged
      lap(2);
    };
    for (int st = 0; st < steps; st += 2) {
      step(st, pre_a, pre_b);
      if (st + 1 < steps) step(st + 1, kBatch ? pre_a : pre_b, pre_a);
    }
    x_src = dst;
  }
  if (threadIdx.x == 0)
    for (int p = 0; p < 5; ++p) timing[5 * blockIdx.x + p] = clk[p];
}

// The geometry of a plan over ``images`` images of ctas / images CTAs
// each, or false if the plan does not fit it.
inline bool geometry(int C, int n, int bs, int kh, int images, int ctas,
                     int ipc, int threads, int x_blocks, int slots,
                     Geometry* g) {
  if (C < 1 || n < 1 || bs < 64 || bs % 64 || n % bs || kh < 0 ||
      images < 1 || ctas < images || ctas % images || ipc < 1 ||
      threads < 32 * kQuarters || threads > kMaxThreads ||
      threads % (32 * kQuarters) || x_blocks < 1 || slots < 0 ||
      bs / kQuarters > 65536 || x_blocks * kRows * (bs / 4) > 4 * threads)
    return false;
  g->C = C;
  g->n = n;
  g->bs = bs;
  g->kh = kh;
  g->nb = n / bs;
  g->span = (2 * kh + 1) * bs;
  g->strips = bs / kStrip;
  g->items = g->nb * g->strips;
  g->nqs = (2 * kh + 1) * kQuarters;
  g->cpi = ctas / images;
  g->ipc = ipc;
  g->x_blocks = x_blocks;
  g->slots = slots;
  if ((long long)g->cpi * ipc < g->items) return false;
  for (int b = 0; b < g->cpi; ++b) {  // every CTA's items span <= x_blocks
    const int first = b * ipc;
    if (first >= g->items) break;
    const int last = min(first + ipc, g->items) - 1;
    if (last / g->strips - first / g->strips + 1 > x_blocks) return false;
  }
  return true;
}

// Which of a kernel's two instantiations a plan takes: the float4 of a
// slot's x each thread prefetches.
inline int prefetch_of(const Geometry& g, int threads) {
  return g.x_blocks * kRows * (g.bs / 4) <= 2 * threads ? 2 : 4;
}

// One cooperative launch of ``kernel`` over ``ctas`` CTAs with all of
// ``smem`` bytes of dynamic shared memory. A refused launch
// (cudaErrorCooperativeLaunchTooLarge when the grid does not fit at once)
// returns its error, cleared so that the next launch does not read it.
template <class... P, class... A>
inline int launch_cooperative(void (*kernel)(P...), int ctas, int threads,
                              int smem, cudaStream_t stream, A... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
  }
  if (err != cudaSuccess) cudaGetLastError();
  return (int)err;
}

}  // namespace chain
}  // namespace irn
