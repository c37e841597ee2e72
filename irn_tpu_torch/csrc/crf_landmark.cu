// K14 crf_landmark: the device CRF's bilateral landmark kernel [N, S] and its
// f32 row sums, built in two launches per call: a table pass over the
// landmarks, then the rows.
//
// Replaces: irn_tpu/ops/crf_tpu.py crf_pair_program's build_chunk (:196),
// mapped over 4096-row chunks with jax.lax.map (:211, :226, :228): one XLA
// program on the TPU. Eager PyTorch ran it as a Python loop over the chunks,
// about 8 launches per chunk over [4096, S] f32 intermediates (268 MB each
// at S 16384).
//
// For the pixel rows p in [r0, r1) of the [ph, pw] bucket (p = y pw + x) and
// the landmark columns j in [0, s_cols), all in f32 with round to nearest:
//
//   f_p = (x / sxy, y / sxy, r / srgb, g / srgb, b / srgb)  IEEE divisions
//   F_p = RN(kSigma f_p), kSigma = f32(sqrt(log2(e) / 2)) = 0x3f596d27
//   chain(P, Q) = fma(P4, Q4, fma(P3, Q3, fma(P2, Q2, fma(P1, Q1,
//                 RN(P0 Q0)))))                       each fma rounded once
//   landmark j = the pixel (off + s (j / lw), off + s (j % lw)), off = s / 2
//   a_p = chain(F_p, F_p);  b_j = chain(F_j, F_j), or +inf when landmark j
//         lies outside the true extent (eh, ew) or j >= n_land (int8's
//         padding of S to a multiple of 8)
//   u   = min(RN(2 c - RN(a_p + b_j)), 0), c = chain(F_p, F_j)  (one fma:
//         2c is exact)
//   k   = exp2(u)  (= exp(-|f_p - f_j|^2 / 2) up to rounding; u = -inf
//         gives +0)
//   store[p - r0, j] = rint(127 k) (int8, round half to even), RN(k) (bf16)
//         or k (f32); nothing in the sums-only mode
//   sums[p - r0] = (sum_j rint(127 k)) * f32(1/127) (int8), else the f32 k
//         summed in the order below
//
// Launch 1, the table: one thread per landmark column writes [F_0 .. F_4,
// b] to a [6, s_tab] f32 buffer (s_tab: S padded to a multiple of 512, the
// padding F = 0, b = +inf; 393 KB at S 16,384, resident in L2), so each
// landmark's divisions and |F|^2 are computed once per call instead of once
// per block.
//
// Launch 2, the rows: a block of 4 warps owns 4 R consecutive pixel rows, R
// per warp (kWarpRows: 32 for int8, 8 for bf16 and f32, the fastest of 8,
// 16, 32 and 64 measured), so every row sum is one warp's and needs no
// atomics; at its start the block computes its rows' F_p and a_p into
// shared memory. The warps walk the landmark columns in tiles of 32 V (V =
// 16 / bytes per entry: 16 int8, 8 bf16, 4 f32): lane l owns the columns
// tile0 + l V .. + V - 1, loads their six table values straight from the
// table into registers by 16-byte loads (96 registers at V 16; no
// block-wide barrier per tile) and reuses them for its warp's R rows. Per
// entry the int8 row loop issues ~12 instructions: FMUL + 4 FFMA (c), FADD
// (t), FFMA + FMNMX (u), MUFU.EX2, FMUL 127 + the magic FADD (the stored
// byte is the low byte of 127 k + 1.5 * 2^23), 3 PRMT per 4 entries to pack
// the bytes into one word and one IDP4A per 4 entries for the row sum;
// with the row's loads, checks and store ~14. One 16-byte store per lane
// and row, consecutive lanes on consecutive 16 bytes, so the [N, S] store
// is written once and coalesced (a row whose start is not 16-byte aligned,
// or the ragged last tile, is written entry by entry). No f32 intermediate
// reaches device memory.
//
// Bit-equality with crf_device.landmark_rows_plain on the card: every
// product, sum and fma is written with __fmul_rn / __fadd_rn / __fmaf_rn in
// the twin's order (nothing is left to contraction); bf16 and f32 take
// exp2f, the function torch.exp2 runs; int8 takes ex2.approx.ftz, which
// differs from exp2f only where the result is subnormal (u < -126), where
// 127 k rounds to 0 either way; rint(127 k) is the round to nearest even of
// 127 k + 1.5 * 2^23 (exact for 0 <= 127 k < 2^22), bf16 is the
// cvt.rn.bf16x2 of __floats2bfloat162_rn. The int8 row sums are exact
// integers before the scale, equal in any order. A dense row sum is lane
// l's running sum over its columns in increasing order (from 0), then lane
// 0's butterfly over the 32 lane sums (l + (l ^ o) for o = 16, 8, 4, 2, 1):
// the twin adds in that order too (columns past s_cols in the last tile
// add +0).
//
// Bound on this card: bytes. At the 512 x 512 bucket (N 262,144, S 16,384)
// the int8 store is 4.29 GB: 1.28 ms at 3.35 TB/s (bf16 2.56 ms, f32 5.13
// ms); the 4.3e9 exps are ~1.0 ms on the SFUs (16 per SM and clock), and
// the ~13.6 SASS instructions per int8 entry ~1.7 ms of issue at 132 SMs x
// 128 lanes x 1.98 GHz: the int8 kernel is bound by its instruction rate
// (2.31 ms measured on an H100 SXM at 700 W, against 5.23 for the first
// design's ~29.7 instructions per entry; tools/probe_crf_landmark.py), the
// f32 store by its bytes.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTabRows = 6;     // F_0 .. F_4, then b
constexpr int kTabAlign = 512;  // the table's columns: whole tiles
constexpr int kPix = 8;         // floats per pixel row in shared memory
constexpr int kTableThreads = 256;
constexpr float kSigma = 0x1.b2da4ep-1f;  // 0x3f596d27

// pixel rows per warp of the rows pass, per store's bytes per entry
template <int kBytes>
constexpr int kWarpRows = kBytes == 1 ? 32 : 8;

struct Geometry {
  int ph, pw, eh, ew, stride, off, lw, n_land, s_cols, s_tab, r0, r1;
  float sxy, srgb;
};

// fma(p4, q4, fma(p3, q3, fma(p2, q2, fma(p1, q1, RN(p0 q0)))))
__device__ __forceinline__ float chain(const float (&p)[5],
                                       const float (&q)[5]) {
  float c = __fmul_rn(p[0], q[0]);
#pragma unroll
  for (int k = 1; k < 5; ++k) c = __fmaf_rn(p[k], q[k], c);
  return c;
}

// the five scaled features F = RN(kSigma f) of the bucket pixel (y, x)
__device__ __forceinline__ void features(const uint8_t* __restrict__ img,
                                         const Geometry& g, int y, int x,
                                         float (&f)[5]) {
  const size_t n = (size_t)g.ph * g.pw;
  const size_t p = (size_t)y * g.pw + x;
  f[0] = __fmul_rn(__fdiv_rn((float)x, g.sxy), kSigma);
  f[1] = __fmul_rn(__fdiv_rn((float)y, g.sxy), kSigma);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    f[2 + c] =
        __fmul_rn(__fdiv_rn((float)__ldg(img + c * n + p), g.srgb), kSigma);
}

__global__ void __launch_bounds__(kTableThreads)
    table_kernel(const uint8_t* __restrict__ img, float* __restrict__ tab,
                 Geometry g) {
  const int j = blockIdx.x * kTableThreads + threadIdx.x;
  if (j >= g.s_tab) return;
  float f[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float b = __int_as_float(0x7f800000);  // +inf: k = +0
  if (j < g.n_land) {
    const int jy = j / g.lw;
    const int y = g.off + g.stride * jy;
    const int x = g.off + g.stride * (j - jy * g.lw);
    features(img, g, y, x, f);
    if (y < g.eh && x < g.ew) b = chain(f, f);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) tab[(size_t)k * g.s_tab + j] = f[k];
  tab[(size_t)5 * g.s_tab + j] = b;
}

__device__ __forceinline__ float ex2_ftz(float u) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(u));
  return r;
}

// k for the pixel (P, a) and the landmark column v of the lane's tile
template <int kBytes, int V>
__device__ __forceinline__ float entry(const float (&P)[5], float a,
                                       const float (&lf)[kTabRows][V],
                                       int v) {
  const float q[5] = {lf[0][v], lf[1][v], lf[2][v], lf[3][v], lf[4][v]};
  const float c = chain(P, q);
  const float t = __fadd_rn(a, lf[5][v]);
  const float u = fminf(__fmaf_rn(2.f, c, -t), 0.f);
  if constexpr (kBytes == 1) {
    return ex2_ftz(u);
  } else {
    return exp2f(u);
  }
}

// entries E, E + 1, .. of w to dst (kBytes-aligned) while they lie inside
// the row's first nbytes: a row that is not 16-byte aligned, or the ragged
// last tile (E a template argument, so w stays in registers)
template <int kBytes, int E>
__device__ __forceinline__ void write_entries(uint8_t* dst,
                                              const uint32_t (&w)[4],
                                              int nbytes) {
  if constexpr (E < 16 / kBytes) {
    if (E * kBytes >= nbytes) return;
    if constexpr (kBytes == 1) {
      dst[E] = (uint8_t)(w[E >> 2] >> (8 * (E & 3)));
    } else if constexpr (kBytes == 2) {
      reinterpret_cast<uint16_t*>(dst)[E] =
          (uint16_t)(w[E >> 1] >> (16 * (E & 1)));
    } else {
      reinterpret_cast<uint32_t*>(dst)[E] = w[E];
    }
    write_entries<kBytes, E + 1>(dst, w, nbytes);
  }
}

// __floats2bfloat162_rn(lo, hi)'s bits, in a register (the intrinsic's
// struct, read back through a pointer, costs a stack slot)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// one row's V entries into the 16 stored bytes w, their sum into acc
template <int kBytes, int V, typename Acc>
__device__ __forceinline__ void row_entries(const float (&P)[5], float a,
                                            const float (&lf)[kTabRows][V],
                                            uint32_t (&w)[4], Acc& acc) {
  if constexpr (kBytes == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t q[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        // 127 k + 1.5 * 2^23 rounds 127 k to the nearest integer, ties to
        // even; the integer (0 .. 127) is the sum's low byte
        q[b] = __float_as_uint(__fadd_rn(
            __fmul_rn(entry<kBytes, V>(P, a, lf, 4 * i + b), 127.f),
            12582912.f));
      }
      w[i] = __byte_perm(__byte_perm(q[0], q[1], 0x0040),
                         __byte_perm(q[2], q[3], 0x0040), 0x5410);
      acc = __dp4a((int)w[i], 0x01010101, acc);
    }
  } else if constexpr (kBytes == 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float k0 = entry<kBytes, V>(P, a, lf, 2 * i);
      const float k1 = entry<kBytes, V>(P, a, lf, 2 * i + 1);
      w[i] = bf16x2(k0, k1);
      acc = __fadd_rn(__fadd_rn(acc, k0), k1);
    }
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float k = entry<kBytes, V>(P, a, lf, v);
      w[v] = __float_as_uint(k);
      acc = __fadd_rn(acc, k);
    }
  }
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
    rows_kernel(const uint8_t* __restrict__ img, const float* __restrict__ tab,
                uint8_t* __restrict__ store, float* __restrict__ sums,
                Geometry g) {
  constexpr int V = 16 / kBytes;  // columns per lane and tile
  constexpr int kTile = 32 * V;
  constexpr int R = kWarpRows<kBytes>;
  constexpr int block_rows = kWarps * R;
  using Acc = typename std::conditional<kBytes == 1, int, float>::type;
  __shared__ __align__(16) float s_pix[block_rows * kPix];
  __shared__ Acc s_acc[block_rows * 32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = g.r0 + blockIdx.x * block_rows;
  const int n_tiles = (g.s_cols + kTile - 1) / kTile;
  // every row starts 16-byte aligned when the store does and a row is a
  // multiple of 16 bytes: then a lane's full tile is one vector store
  const size_t row_bytes = (size_t)g.s_cols * kBytes;
  const bool rows_aligned =
      ((reinterpret_cast<uintptr_t>(store) | row_bytes) & 15) == 0;

  for (int i = threadIdx.x; i < block_rows; i += kThreads) {
    const int p = row0 + i;
    float f[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (p < g.r1) features(img, g, p / g.pw, p % g.pw, f);
#pragma unroll
    for (int k = 0; k < 5; ++k) s_pix[i * kPix + k] = f[k];
    s_pix[i * kPix + 5] = chain(f, f);
    s_pix[i * kPix + 6] = 0.f;
    s_pix[i * kPix + 7] = 0.f;
  }
  // each lane's row sums are its own: written and read by this thread only
#pragma unroll 1
  for (int rr = 0; rr < R; ++rr) s_acc[(warp * R + rr) * 32 + lane] = Acc(0);
  __syncthreads();  // the pixel rows are ready

  // the warp's rows inside [r0, r1): a trip count, because a break in the
  // row loop measured slower at int8 (tools/probe_crf_landmark.py)
  const int rows_here = max(0, min(R, g.r1 - (row0 + warp * R)));
#pragma unroll 1
  for (int t = 0; t < n_tiles; ++t) {
    // the lane's V landmarks' six table values, by 16-byte loads from L2
    float lf[kTabRows][V];
    const float* src = tab + (size_t)t * kTile + lane * V;
#pragma unroll
    for (int k = 0; k < kTabRows; ++k)
#pragma unroll
      for (int v = 0; v < V; v += 4) {
        const float4 x = __ldg(
            reinterpret_cast<const float4*>(src + (size_t)k * g.s_tab + v));
        lf[k][v] = x.x;
        lf[k][v + 1] = x.y;
        lf[k][v + 2] = x.z;
        lf[k][v + 3] = x.w;
      }
    const int c0 = t * kTile + lane * V;
    const int nbytes = min(V, g.s_cols - c0) * kBytes;  // <= 0: none inside
    // per lane and tile: every row one vector store, or entry by entry
    const bool vector = store != nullptr && rows_aligned && nbytes == 16;
    const bool bytes = store != nullptr && !vector && nbytes > 0;
    size_t at = (size_t)(row0 + warp * R - g.r0) * row_bytes + c0 * kBytes;

#pragma unroll 1
    for (int rr = 0; rr < rows_here; ++rr, at += row_bytes) {
      const int lr = warp * R + rr;
      const float4 pa = *reinterpret_cast<const float4*>(s_pix + lr * kPix);
      const float4 pb =
          *reinterpret_cast<const float4*>(s_pix + lr * kPix + 4);
      const float P[5] = {pa.x, pa.y, pa.z, pa.w, pb.x};
      Acc acc = s_acc[lr * 32 + lane];
      uint32_t w[4];
      row_entries<kBytes, V>(P, pb.y, lf, w, acc);
      s_acc[lr * 32 + lane] = acc;
      if (vector) {
        *reinterpret_cast<uint4*>(store + at) = make_uint4(w[0], w[1], w[2],
                                                           w[3]);
      } else if (bytes) {
        write_entries<kBytes, 0>(store + at, w, nbytes);
      }
    }
  }

#pragma unroll 1
  for (int rr = 0; rr < R; ++rr) {
    const int lr = warp * R + rr;
    const int p = row0 + lr;
    if (p >= g.r1) break;
    Acc acc = s_acc[lr * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const Acc other = __shfl_xor_sync(0xffffffffu, acc, o);
      if constexpr (kBytes == 1) {
        acc += other;
      } else {
        acc = __fadd_rn(acc, other);
      }
    }
    if (lane == 0) {
      if constexpr (kBytes == 1) {
        // the twin's np.float32(1 / 127): 0x3c010204
        sums[p - g.r0] = __fmul_rn(__int2float_rn(acc), 1.f / 127.f);
      } else {
        sums[p - g.r0] = acc;
      }
    }
  }
}

template <int kBytes>
cudaError_t launch_rows(const uint8_t* img, const float* tab, uint8_t* store,
                        float* sums, const Geometry& g, cudaStream_t stream) {
  constexpr int block_rows = kWarps * kWarpRows<kBytes>;
  const int blocks = (g.r1 - g.r0 + block_rows - 1) / block_rows;
  rows_kernel<kBytes>
      <<<blocks, kThreads, 0, stream>>>(img, tab, store, sums, g);
  return cudaGetLastError();
}

cudaError_t launch_table(const uint8_t* img, float* tab, const Geometry& g,
                         cudaStream_t stream) {
  const int blocks = (g.s_tab + kTableThreads - 1) / kTableThreads;
  table_kernel<<<blocks, kTableThreads, 0, stream>>>(img, tab, g);
  return cudaGetLastError();
}

bool table_ok(const uint8_t* img, const float* tab, const Geometry& g) {
  return img && tab && g.ph > 0 && g.pw > 0 && g.stride > 0 && g.lw > 0 &&
         g.n_land > 0 && g.s_tab >= g.n_land && g.s_tab % kTabAlign == 0;
}

}  // namespace

// K14's table pass alone: img [3, ph, pw] uint8 (the packed upload's image
// planes); tab [6, s_tab] f32, s_tab a multiple of 512 and >= n_land.
IRN_API int irn_crf_landmark_table(const uint8_t* img, float* tab, int ph,
                                   int pw, int eh, int ew, int stride, int lw,
                                   int n_land, int s_tab, float sxy,
                                   float srgb, cudaStream_t stream,
                                   int* launched) {
  const Geometry g{ph, pw, eh, ew, stride, stride / 2, lw, n_land, n_land,
                   s_tab, 0, 1, sxy, srgb};
  if (!table_ok(img, tab, g)) return (int)cudaErrorInvalidValue;
  const cudaError_t e = launch_table(img, tab, g, stream);
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}

// K14: the table pass into tab [6, s_tab] f32 (scratch), then the rows;
// store [r1 - r0, s_cols] of store_bytes per entry (1 int8, 2 bf16, 4 f32),
// or null for the sums alone; sums [r1 - r0] f32. store_bytes also sets the
// dense sums' order (V = 16 / store_bytes) in the sums-only mode.
IRN_API int irn_crf_landmark(const uint8_t* img, float* tab, void* store,
                             float* sums, int ph, int pw, int eh, int ew,
                             int stride, int lw, int n_land, int s_cols,
                             int s_tab, int store_bytes, int r0, int r1,
                             float sxy, float srgb, cudaStream_t stream,
                             int* launched) {
  const Geometry g{ph, pw, eh, ew, stride, stride / 2, lw, n_land, s_cols,
                   s_tab, r0, r1, sxy, srgb};
  if (!table_ok(img, tab, g) || !sums || s_cols < n_land || s_tab < s_cols ||
      r0 < 0 || r1 <= r0 || (long long)r1 > (long long)ph * pw ||
      (store_bytes != 1 && store_bytes != 2 && store_bytes != 4))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = launch_table(img, tab, g, stream);
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  uint8_t* out = static_cast<uint8_t*>(store);
  switch (store_bytes) {
    case 1:
      e = launch_rows<1>(img, tab, out, sums, g, stream);
      break;
    case 2:
      e = launch_rows<2>(img, tab, out, sums, g, stream);
      break;
    default:
      e = launch_rows<4>(img, tab, out, sums, g, stream);
      break;
  }
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}
