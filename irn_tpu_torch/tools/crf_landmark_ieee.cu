// K14's first design (the landmark-kernel build as the port ran it before
// the table pass), kept only so that the new design can be timed and its
// SASS counted beside it on one card: irn_tpu_torch/tools/
// probe_crf_landmark.py builds this file into its own library. The port
// never calls it.
//
// For the pixel rows p in [r0, r1) and the landmark columns j < s_cols:
// k = exp(-0.5 max(d2, 0)) v_j with d2 = (|f_p|^2 + |l_j|^2) - 2 <f_p, l_j>
// (five-term sums left to right, every operation rounded in turn, expf),
// stored as int8 rint(127 k), bf16 or f32, with the row sums of the stored
// values. A block of 4 warps owns 64 pixel rows; each 32 V-column landmark
// tile is recomputed by every block from the image (five IEEE divisions
// and |l|^2 per landmark) into shared memory between two __syncthreads;
// each lane holds its V landmarks in registers for its warp's 16 rows;
// ~26 instructions per int8 entry.

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 16;
constexpr int kBlockRows = kWarps * kRowsPerWarp;
constexpr int kFeat = 6;  // the five features, then |f|^2

struct Geometry {
  int ph, pw, eh, ew, stride, off, lw, n_land, s_cols, r0, r1;
  float sxy, srgb;
};

// |f|^2 left to right: ((((f0 f0 + f1 f1) + f2 f2) + f3 f3) + f4 f4)
__device__ __forceinline__ float sq5(const float (&f)[5]) {
  float s = __fmul_rn(f[0], f[0]);
#pragma unroll
  for (int k = 1; k < 5; ++k) s = __fadd_rn(s, __fmul_rn(f[k], f[k]));
  return s;
}

// the five features of the bucket pixel (y, x)
__device__ __forceinline__ void features(const uint8_t* __restrict__ img,
                                         const Geometry& g, int y, int x,
                                         float (&f)[5]) {
  const size_t n = (size_t)g.ph * g.pw;
  const size_t p = (size_t)y * g.pw + x;
  f[0] = __fdiv_rn((float)x, g.sxy);
  f[1] = __fdiv_rn((float)y, g.sxy);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    f[2 + c] = __fdiv_rn((float)__ldg(img + c * n + p), g.srgb);
}

// k for one (pixel, landmark) pair: lf holds the landmark's features and
// |l|^2, f0..f4 and sqp the pixel's
__device__ __forceinline__ float entry(float f0, float f1, float f2, float f3,
                                       float f4, float sqp, float l0, float l1,
                                       float l2, float l3, float l4,
                                       float sql) {
  float c = __fmul_rn(f0, l0);
  c = __fadd_rn(c, __fmul_rn(f1, l1));
  c = __fadd_rn(c, __fmul_rn(f2, l2));
  c = __fadd_rn(c, __fmul_rn(f3, l3));
  c = __fadd_rn(c, __fmul_rn(f4, l4));
  const float d2 = __fsub_rn(__fadd_rn(sqp, sql), __fmul_rn(2.f, c));
  return expf(__fmul_rn(-0.5f, fmaxf(d2, 0.f)));
}

// 16 bytes at dst, of which the first nbytes are inside the row: one vector
// store when all are and dst is 16-byte aligned, else byte by byte
__device__ __forceinline__ void write16(uint8_t* dst, const uint32_t (&w)[4],
                                        int nbytes) {
  if (nbytes == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    return;
  }
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < nbytes) dst[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
}

// V entries of one row into the 16 stored bytes w, their sum into acc
template <int kBytes>
__device__ __forceinline__ void pack(const float* k, uint32_t (&w)[4],
                                     typename std::conditional<
                                         kBytes == 1, int, float>::type& acc);

template <>
__device__ __forceinline__ void pack<1>(const float* k, uint32_t (&w)[4],
                                        int& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      // 127 k + 1.5 * 2^23 rounds 127 k to the nearest integer, ties to
      // even; the integer is the low mantissa bits
      const int q = __float_as_int(__fadd_rn(__fmul_rn(k[4 * i + b], 127.f),
                                             12582912.f)) -
                    0x4B400000;
      acc += q;
      word |= (uint32_t)q << (8 * b);
    }
    w[i] = word;
  }
}

template <>
__device__ __forceinline__ void pack<2>(const float* k, uint32_t (&w)[4],
                                        float& acc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(k[2 * i], k[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
#pragma unroll
  for (int v = 0; v < 8; ++v) acc = __fadd_rn(acc, k[v]);
}

template <>
__device__ __forceinline__ void pack<4>(const float* k, uint32_t (&w)[4],
                                        float& acc) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    w[v] = __float_as_uint(k[v]);
    acc = __fadd_rn(acc, k[v]);
  }
}

template <int kBytes>
__global__ void __launch_bounds__(kThreads)
    landmark_kernel(const uint8_t* __restrict__ img, uint8_t* __restrict__ store,
                    float* __restrict__ sums, Geometry g) {
  constexpr int V = 16 / kBytes;  // columns per lane and tile
  constexpr int kTile = 32 * V;
  using Acc = typename std::conditional<kBytes == 1, int, float>::type;
  // landmark (tile0 + l V + v) at [feature][v * 32 + l]
  __shared__ float s_land[kFeat][kTile];
  __shared__ float s_pix[kBlockRows][kFeat];
  __shared__ Acc s_acc[kBlockRows][32];  // [row][lane]: the lane's sum

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = g.r0 + blockIdx.x * kBlockRows;

  if (threadIdx.x < kBlockRows) {
    const int p = row0 + threadIdx.x;
    float f[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (p < g.r1) features(img, g, p / g.pw, p % g.pw, f);
#pragma unroll
    for (int k = 0; k < 5; ++k) s_pix[threadIdx.x][k] = f[k];
    s_pix[threadIdx.x][5] = sq5(f);
  }
  // each lane's row sums are its own: written and read by this thread only
#pragma unroll 1
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
    s_acc[warp * kRowsPerWarp + rr][lane] = Acc(0);

#pragma unroll 1
  for (int tile0 = 0; tile0 < g.s_cols; tile0 += kTile) {
    __syncthreads();  // the previous tile's landmarks are read (and s_pix set)
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      const int j = tile0 + (e % 32) * V + e / 32;
      float f[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
      float sq = __int_as_float(0x7f800000);  // +inf: k = 0
      if (j < g.n_land) {
        const int jy = j / g.lw;
        const int y = g.off + g.stride * jy;
        const int x = g.off + g.stride * (j - jy * g.lw);
        features(img, g, y, x, f);
        if (y < g.eh && x < g.ew) sq = sq5(f);
      }
#pragma unroll
      for (int k = 0; k < 5; ++k) s_land[k][e] = f[k];
      s_land[5][e] = sq;
    }
    __syncthreads();
    float lf[kFeat][V];
#pragma unroll
    for (int k = 0; k < kFeat; ++k)
#pragma unroll
      for (int v = 0; v < V; ++v) lf[k][v] = s_land[k][v * 32 + lane];
    const int c0 = tile0 + lane * V;
    const int nbytes = min(V, g.s_cols - c0) * kBytes;  // <= 0: none inside

#pragma unroll 1
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int lr = warp * kRowsPerWarp + rr;
      const int p = row0 + lr;
      if (p >= g.r1) break;  // uniform over the warp
      const float f0 = s_pix[lr][0], f1 = s_pix[lr][1], f2 = s_pix[lr][2];
      const float f3 = s_pix[lr][3], f4 = s_pix[lr][4], sqp = s_pix[lr][5];
      float k[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        k[v] = entry(f0, f1, f2, f3, f4, sqp, lf[0][v], lf[1][v], lf[2][v],
                     lf[3][v], lf[4][v], lf[5][v]);
      Acc acc = s_acc[lr][lane];
      uint32_t w[4];
      pack<kBytes>(k, w, acc);
      s_acc[lr][lane] = acc;
      if (store != nullptr && nbytes > 0)
        write16(store + ((size_t)(p - g.r0) * g.s_cols + c0) * kBytes, w,
                nbytes);
    }
  }

#pragma unroll 1
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int lr = warp * kRowsPerWarp + rr;
    const int p = row0 + lr;
    if (p >= g.r1) break;
    Acc acc = s_acc[lr][lane];
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
cudaError_t launch(const uint8_t* img, uint8_t* store, float* sums,
                   const Geometry& g, cudaStream_t stream) {
  const int blocks = (g.r1 - g.r0 + kBlockRows - 1) / kBlockRows;
  landmark_kernel<kBytes><<<blocks, kThreads, 0, stream>>>(img, store, sums, g);
  return cudaGetLastError();
}

}  // namespace

// img [3, ph, pw] uint8 (the packed upload's image planes); store [r1 - r0,
// s_cols] of store_bytes per entry (1 int8, 2 bf16, 4 f32), or null for the
// sums alone; sums [r1 - r0] f32. store_bytes also sets the dense sums'
// order (V = 16 / store_bytes) in the sums-only mode.
IRN_API int irn_crf_landmark_ieee(const uint8_t* img, void* store, float* sums,
                             int ph, int pw, int eh, int ew, int stride,
                             int lw, int n_land, int s_cols, int store_bytes,
                             int r0, int r1, float sxy, float srgb,
                             cudaStream_t stream, int* launched) {
  const Geometry g{ph, pw, eh, ew, stride, stride / 2, lw, n_land, s_cols,
                   r0, r1, sxy, srgb};
  if (!img || !sums || ph <= 0 || pw <= 0 || stride <= 0 || lw <= 0 ||
      n_land <= 0 || s_cols < n_land || r0 < 0 || r1 <= r0 ||
      (long long)r1 > (long long)ph * pw)
    return (int)cudaErrorInvalidValue;
  uint8_t* out = static_cast<uint8_t*>(store);
  cudaError_t e;
  switch (store_bytes) {
    case 1:
      e = launch<1>(img, out, sums, g, stream);
      break;
    case 2:
      e = launch<2>(img, out, sums, g, stream);
      break;
    case 4:
      e = launch<4>(img, out, sums, g, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  ++*launched;
  return 0;
}
