// K0 diag_chain: x @ T^n_apply with the random-walk transition T held in
// diagonal form (the e=0 default walk of make_sem_seg), the whole chain in
// one launch.
//
// Replaces: irn_tpu/ops/random_walk.py apply_diag_chain (an XLA-fused jnp
// stencil in a fori_loop on the TPU, not a Pallas kernel).
//
//   out[c, j] = (x[c, j] + sum_k x[c, j-d_k] * w[k, j-d_k]
//                        + x[c, j+d_k] * w[k, j]) * inv[j]
//
// Bound on this card: an application is 4PCn operations on x [C, n] and the
// weights w [P, n] (15.6 MFLOP and 2.4 MB at n 14336, C 8, P 34): under
// 1 us of f32 arithmetic, so the chain of n_apply dependent applications is
// bound by how fast one application hands its result to the next.
//
// Design: the seed rows are independent, so each group of RT rows gets its
// own thread-block cluster of S CTAs, and clusters never wait on each
// other. The CTAs split the n columns into slices of m (n/S rounded up to
// 4); each CTA keeps its rows' x over its slice plus a halo of hpad >=
// max d_k columns on each side in shared memory, in two ping-pong buffers,
// for the whole chain, so no intermediate x goes through global memory.
// One application: each thread computes columns of the CTA's slice from
// the current buffer into the other buffer's slice; a cluster barrier; each
// CTA copies the other buffer's halo from the CTAs that own those columns
// through distributed shared memory (16-byte loads; a column c belongs to
// rank c / m, so a halo wider than a slice reaches several CTAs, and
// columns outside [0, n) are zeros); __syncthreads. The last application
// writes out in global memory.
//
// w: a CTA reads, per diagonal k, w[k, c - d_k] and w[k, c] for the columns
// c of its slice, the same values in every application. Where they fit
// beside the x buffers (every bucket of the stage's default 128 x 128 grid
// cap: 156 KB at n 14336, 190 KB at n 18432), each CTA copies them once, as
// one window of m + d_k columns per diagonal, into shared memory, so an
// application reads no global memory. Otherwise (larger grids) they come
// through the read-only path from L2, whose traffic then sets the time
// (some 31 MB per application at n 14336 over 128 CTAs).
//
// The plan (random_walk.diag_chain_plan) picks the rows per cluster, the
// cluster size and where w lives from what fits and from how many clusters
// the card holds at once (cudaOccupancyMaxActiveClusters): an H100 80GB
// HBM3 holds 7 clusters of 12-16 CTAs of one CTA per SM, so C 8 runs as 4
// clusters of 2 rows in one wave, not 8 clusters of 1 row in two.
//
// The cluster barrier is two mbarriers in each CTA, used in turn (so a CTA
// a barrier ahead cannot complete a phase another CTA still waits on): each
// CTA's thread t arrives, with release at cluster scope, on CTA t's
// barrier, and every thread waits on its own CTA's with acquire at cluster
// scope. The wait traps after ~2^36 cycles (hopper.cuh), so a faulty
// barrier fails the launch instead of holding the card. The one hardware
// cluster barrier, after set-up, is reached by every CTA.
//
// The adds and multiplies round separately (__fadd_rn/__fmul_rn, no FMA
// contraction) in the term order of the plain twin, for every output
// element, so the two agree to the bit.

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = irn::hopper;

constexpr int kMaxDiags = 64;
constexpr int kThreads = 1024;
constexpr int kSmemMax = 232448;  // dynamic shared memory a CTA may use
constexpr int kBarBytes = 16;     // two mbarriers before the buffers

struct DiagOffsets {
  int d[kMaxDiags];
  int base[kMaxDiags + 1];  // diagonal k's w window in shared memory
                            // (floats); base[P]: all P windows
};

// Cluster barrier number ``k`` (0, 1, ...) of a cluster of ``S`` CTAs.
__device__ __forceinline__ void cluster_barrier(uint64_t* bars, int k,
                                                int S) {
  __syncthreads();  // this CTA's reads and writes of the buffers are done
  uint64_t* bar = bars + (k & 1);
  if (threadIdx.x < S)
    hp::mbar_arrive_cluster(hp::cluster_map(hp::smem_u32(bar), threadIdx.x));
  hp::mbar_wait<true>(bar, (k >> 1) & 1);
}

// Grid (S, ceil(C / RT)), clusters (S, 1, 1): CTA rank blockIdx.x of the
// cluster of row group blockIdx.y. kWShared: w's windows in shared memory.
template <int RT, bool kWShared>
__global__ void __launch_bounds__(kThreads)
diag_chain_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ inv, float* __restrict__ out,
                  const __grid_constant__ DiagOffsets offs, int P, int C,
                  int n, int m, int hpad, int n_apply) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* bufs = reinterpret_cast<float*>(smem_raw + kBarBytes);
  const int S = gridDim.x;
  const int rank = blockIdx.x;
  const int row0 = blockIdx.y * RT;
  const int width = m + 2 * hpad;  // buffer element e holds column base + e
  const int lo = rank * m;
  const int base = lo - hpad;
  auto buf = [&](int b, int r) {
    return bufs + (size_t)(b * RT + r) * width;
  };
  // window k: element i holds w[k, lo - d_k + i], zero outside [0, n)
  float* ws = bufs + 2 * RT * width;

  if (threadIdx.x == 0) {
    hp::mbar_init(&bars[0], S);
    hp::mbar_init(&bars[1], S);
    hp::fence_barrier_init();
  }
  // buffer 0: x over the slice and its halo; zeros outside [0, n) and for
  // rows past C. Buffer 1: zeros (its columns past n stay zero).
  for (int i = threadIdx.x; i < RT * width; i += kThreads) {
    const int r = i / width;
    const int e = i % width;
    const int c = base + e;
    buf(0, r)[e] = (c >= 0 && c < n && row0 + r < C)
                       ? __ldg(x + (size_t)(row0 + r) * n + c)
                       : 0.f;
    buf(1, r)[e] = 0.f;
  }
  if (kWShared) {
    for (int k = 0; k < P; ++k) {
      const int d = offs.d[k];
      const float* wk = w + (size_t)k * n;
      for (int i = threadIdx.x; i < m + d; i += kThreads) {
        const int c = lo - d + i;
        ws[offs.base[k] + i] = (c >= 0 && c < n) ? __ldg(wk + c) : 0.f;
      }
    }
  }
  hp::cluster_sync();  // every CTA's barriers and buffers are ready

  const int hq = hpad / 4;  // 16-byte chunks of halo on each side
  for (int a = 0; a < n_apply; ++a) {
    const int p = a & 1;
    const bool last = a == n_apply - 1;
    for (int j = threadIdx.x; j < m && lo + j < n; j += kThreads) {
      const int c = lo + j;
      const int e = hpad + j;
      float acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = buf(p, r)[e];
      const float* wc = w + c;
#pragma unroll 4
      for (int k = 0; k < P; ++k) {
        const int d = offs.d[k];
        float wl, wr;
        if (kWShared) {
          wl = ws[offs.base[k] + j];  // w[k, c - d], zero for c < d
          wr = ws[offs.base[k] + j + d];
        } else {
          wl = c >= d ? __ldg(wc + (size_t)k * n - d) : 0.f;
          wr = __ldg(wc + (size_t)k * n);
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float* xr = buf(p, r);
          acc[r] = __fadd_rn(__fadd_rn(acc[r], __fmul_rn(xr[e - d], wl)),
                             __fmul_rn(xr[e + d], wr));
        }
      }
      const float s = __ldg(inv + c);
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float v = __fmul_rn(acc[r], s);
        if (!last)
          buf(p ^ 1, r)[e] = v;
        else if (row0 + r < C)
          out[(size_t)(row0 + r) * n + c] = v;
      }
    }
    if (last) break;
    cluster_barrier(bars, a, S);  // every slice of buffer p^1 is written
    const int q = p ^ 1;
    for (int i = threadIdx.x; i < RT * 2 * hq; i += kThreads) {
      const int r = i / (2 * hq);
      const int h = i % (2 * hq);
      const int e = h < hq ? 4 * h : m + 4 * h;  // left halo, then right
      const int c = base + e;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c >= 0 && c < n) {
        const int owner = c / m;
        v = hp::ld_cluster_f4(hp::cluster_map(
            hp::smem_u32(buf(q, r) + hpad + (c - owner * m)), owner));
      }
      *reinterpret_cast<float4*>(buf(q, r) + e) = v;
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its buffers
  if (n_apply > 1) cluster_barrier(bars, n_apply - 1, S);
}

template <int RT, bool kWShared>
int launch(const float* x, const float* w, const float* inv, float* out,
           const DiagOffsets& offs, int P, int C, int n, int m, int hpad,
           int n_apply, int S, cudaStream_t s, int* launched,
           int* max_clusters) {
  const size_t smem =
      kBarBytes + sizeof(float) * (2 * RT * (size_t)(m + 2 * hpad) +
                                   (kWShared ? offs.base[P] : 0));
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  auto kernel = diag_chain_kernel<RT, kWShared>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && S > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (C + RT - 1) / RT, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (max_clusters) {  // a query: no launch
    *max_clusters = clusters;
    return 0;
  }
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, inv, out, offs, P, C, n, m,
                           hpad, n_apply);
  if (err != cudaSuccess) return (int)err;
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// Checks the plan, then launches the chain (max_clusters null) or writes
// how many clusters of the plan the card holds at once.
int run(const float* x, const float* w, const float* inv, const int* doffs,
        float* out, int P, int C, int n, int n_apply, int rows, int cluster,
        int m, int hpad, int w_shared, cudaStream_t s, int* launched,
        int* max_clusters) {
  if (P < 0 || P > kMaxDiags || C < 1 || n < 4 || n % 4 || n_apply < 1 ||
      cluster < 1 || cluster > 16 || m < 4 || m % 4 ||
      (long long)m * cluster < n || hpad < 0 || hpad % 4)
    return (int)cudaErrorInvalidValue;
  DiagOffsets offs;
  offs.base[0] = 0;
  for (int k = 0; k < P; ++k) {
    if (doffs[k] < 0 || doffs[k] >= n || doffs[k] > hpad)
      return (int)cudaErrorInvalidValue;
    offs.d[k] = doffs[k];
    offs.base[k + 1] = offs.base[k] + m + doffs[k];
  }
#define IRN_DIAG_LAUNCH(RT, WS)                                          \
  return launch<RT, WS>(x, w, inv, out, offs, P, C, n, m, hpad, n_apply, \
                        cluster, s, launched, max_clusters)
  switch (rows * 2 + (w_shared ? 1 : 0)) {
    case 2: IRN_DIAG_LAUNCH(1, false);
    case 3: IRN_DIAG_LAUNCH(1, true);
    case 4: IRN_DIAG_LAUNCH(2, false);
    case 5: IRN_DIAG_LAUNCH(2, true);
    case 8: IRN_DIAG_LAUNCH(4, false);
    case 9: IRN_DIAG_LAUNCH(4, true);
    default: return (int)cudaErrorInvalidValue;
  }
#undef IRN_DIAG_LAUNCH
}

}  // namespace

// x, out: [C, n] (out distinct from x); w: [P, n]; inv: [n] (device).
// doffs: [P] host, each in [0, n) and <= hpad. The plan (from
// random_walk.diag_chain_plan): ``rows`` seed rows per cluster (1, 2 or 4),
// ``cluster`` CTAs per cluster (<= 16), column slices of m (a multiple of
// 4, m * cluster >= n), halo hpad (a multiple of 4), ``w_shared`` (w's
// windows in shared memory); n a multiple of 4. One launch for all
// n_apply >= 1 applications.
IRN_API int irn_diag_chain(const float* x, const float* w, const float* inv,
                           const int* doffs, float* out, int P, int C, int n,
                           int n_apply, int rows, int cluster, int m,
                           int hpad, int w_shared, void* stream,
                           int* launched) {
  return run(x, w, inv, doffs, out, P, C, n, n_apply, rows, cluster, m, hpad,
             w_shared, static_cast<cudaStream_t>(stream), launched, nullptr);
}

// How many clusters of a plan the current device holds at once
// (cudaOccupancyMaxActiveClusters), into *max_clusters; launches nothing.
IRN_API int irn_diag_chain_clusters(const int* doffs, int P, int C, int n,
                                    int rows, int cluster, int m, int hpad,
                                    int w_shared, int* max_clusters) {
  return run(nullptr, nullptr, nullptr, doffs, nullptr, P, C, n, 1, rows,
             cluster, m, hpad, w_shared, nullptr, nullptr, max_clusters);
}
