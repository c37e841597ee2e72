// The split product shared by K2 square_banded, K5 square_dense and K6
// square_fused_first: L @ R for n x n f32 operands on the tensor cores, in
// one of two modes chosen at compile time by kParts, the bf16 pieces each
// f32 operand value becomes:
//
// - kParts 3, f32-accurate (the TPU's Precision.HIGHEST carried to
//   Hopper): hi, mid and lo pieces, six wgmma products per k16 step;
// - kParts 1, the bf16 operand mode (the JAX package's matmul_dtype
//   bfloat16): the hi piece alone, bf16(x) rounded to nearest even as
//   JAX's astype(bfloat16) rounds it, one wgmma product per k16 step. Each
//   product of two bf16 values is exact in the f32 accumulator.
//
// K5 and K6 take dense operands; K2 takes band layouts and a k range per
// tile (split_tile_at / product_tile_at with its own addressing).
//
// - split_tile: one 64 x 64 tile of the split pass. Each f32 value x becomes
//   hi = bf16(x) and, at kParts 3, mid = bf16(x - hi), lo = bf16(x - hi -
//   mid), which carry its 24 bits (exactly, for x whose lo piece stays a
//   normal bf16). L's pieces are stored as they are ([i][k], K-major for
//   the product's A operand), R's transposed ([j][k], K-major for its B
//   operand, through a shared-memory tile). Pieces [2 kParts, n, n] bf16:
//   L's, then Rt's (12 n^2 bytes at kParts 3, 4 n^2 at kParts 1).
// - product_tile: one 128 x 128 output tile of the product: a ring of TMA
//   loads (two stages of six piece tiles at kParts 3, four of two at
//   kParts 1; one producer warpgroup, of which one thread issues the loads)
//   feeding two consumer warpgroups (64 rows each) through mbarriers; per
//   64-deep k slab, six wgmma products per k16 step at kParts 3, hi.hi,
//   hi.mid, mid.hi, hi.lo, lo.hi, mid.mid, the terms HIGHEST keeps (the
//   dropped ones are about 2^-24 of each product), or hi.hi alone at
//   kParts 1. The tensor cores align their f32 accumulation with fewer
//   guard bits than an FMA chain; over n/16 k steps that could bias the
//   sum by some 1e-5 of its size, so each slab's products start a fresh
//   accumulator (scale-d 0) and are added into an f32 register total in
//   round-to-nearest, once per slab.
// - launch_product: encodes the pieces' tensor map (pieces_map) and
//   launches a kernel whose body is product_tile.
//
// Each source keeps its own __global__ wrappers in its anonymous namespace,
// so the SASS of each kernel carries its source's name. Every wgmma stays
// on a uniform path: a wgmma under a run-time branch makes ptxas serialize
// them all (warning C7520); the mode is a template parameter for that
// reason, never a run-time branch in the mainloop.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

namespace irn {
namespace split {

using bf16 = __nv_bfloat16;

// -- split pass ----------------------------------------------------------------

constexpr int kSplitTile = 64;
constexpr int kSplitThreads = 256;
constexpr int kSplitLd = kSplitTile + 2;  // bf16 row stride of the transpose tile

__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r1 = __fsub_rn(x, __bfloat162float(hi));
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(mid)));
}

// x's first kParts pieces: hi alone at kParts 1 (bf16(x), rounded to
// nearest even), hi, mid and lo at kParts 3.
template <int kParts>
__device__ __forceinline__ void split_parts(float x, bf16 (&p)[kParts]) {
  static_assert(kParts == 1 || kParts == 3, "kParts is 1 or 3");
  if constexpr (kParts == 1)
    p[0] = __float2bfloat16_rn(x);
  else
    split3(x, p[0], p[1], p[2]);
}

// The 64 x 64 tile at (r0, c0) of a [n, n] through the split pass:
// L = a^beta (kBeta > 0: beta fixed at compile time, the multiplies unroll;
// 0: read at run time) and R = L * inv[k] * inv[j] in that multiply order
// (kScale), or R = L (no scaling: ``inv`` is not read), each value rounded
// to its kParts pieces after the f32 pow and scale. L's pieces go to l
// (the tile's first element of the hi piece; row stride ldl, piece stride
// lp), R's transposed to rt (its first element, R[r0, c0], at rt[0]; row
// stride ldr, piece stride rp).
template <int kBeta, bool kScale, int kParts>
__device__ __forceinline__ void split_tile_at(
    const float* __restrict__ a, const float* __restrict__ inv, int n,
    int r0, int c0, bf16* __restrict__ l, int ldl, size_t lp,
    bf16* __restrict__ rt, int ldr, size_t rp, int beta) {
  __shared__ bf16 rts[kParts][kSplitTile][kSplitLd];  // [piece][col][row]
  const int tc = threadIdx.x % kSplitTile;
  const float inv_c = kScale ? __ldg(inv + c0 + tc) : 1.f;
  for (int tr = threadIdx.x / kSplitTile; tr < kSplitTile;
       tr += kSplitThreads / kSplitTile) {
    const int r = r0 + tr;
    const float b = pow_int(__ldg(a + (size_t)r * n + c0 + tc),
                            kBeta > 0 ? kBeta : beta);
    bf16 pc[kParts];
    split_parts<kParts>(b, pc);  // L[r, c]
    const size_t e = (size_t)tr * ldl + tc;
#pragma unroll
    for (int p = 0; p < kParts; ++p) l[p * lp + e] = pc[p];
    if (kScale)
      split_parts<kParts>(__fmul_rn(__fmul_rn(b, __ldg(inv + r)), inv_c), pc);
#pragma unroll
    for (int p = 0; p < kParts; ++p) rts[p][tc][tr] = pc[p];  // at Rt[c, r]
  }
  __syncthreads();
  for (int tr = threadIdx.x / kSplitTile; tr < kSplitTile;
       tr += kSplitThreads / kSplitTile) {
    const size_t e = (size_t)tr * ldr + tc;
#pragma unroll
    for (int p = 0; p < kParts; ++p) rt[p * rp + e] = rts[p][tr][tc];
  }
}

// Tile (blockIdx.y, blockIdx.x) of the split pass over a dense [n, n] into
// pieces [2 kParts, n, n]: L's as [i][k], R's transposed as [j][k].
template <int kBeta, bool kScale, int kParts>
__device__ __forceinline__ void split_tile(const float* __restrict__ a,
                                           const float* __restrict__ inv,
                                           bf16* __restrict__ pieces, int n,
                                           int beta) {
  const size_t nn = (size_t)n * n;
  const int r0 = blockIdx.y * kSplitTile;
  const int c0 = blockIdx.x * kSplitTile;
  split_tile_at<kBeta, kScale, kParts>(
      a, inv, n, r0, c0, pieces + (size_t)r0 * n + c0, n, nn,
      pieces + kParts * nn + (size_t)c0 * n + r0, n, nn, beta);
}

inline dim3 split_grid(int n) { return dim3(n / kSplitTile, n / kSplitTile); }

// -- product -------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kTileBytes = kBM * kBK * 2;       // one piece's 128 x 64 tile
constexpr int kProductThreads = 384;            // producer + 2 consumers
constexpr int kGroup = 16;                      // row tiles per raster group

// The product's ring at kParts pieces per operand: a stage holds L's and
// Rt's piece tiles of one slab (96 KB at kParts 3, 32 KB at 1); two stages
// of six tiles, or four of two, both under 200 KB of shared memory.
template <int kParts>
struct Ring {
  static constexpr int kStages = kParts == 3 ? 2 : 4;
  static constexpr int kStageBytes = 2 * kParts * kTileBytes;
  static constexpr int kProducts = kParts == 3 ? 6 : 1;  // per k16 step
  static constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;
};

// The shapes both products take: n a multiple of the 128-row tile, and a
// split grid within CUDA's limits.
inline bool shape_ok(int n) {
  return n >= kBM && n % kBM == 0 && n / kSplitTile <= 65535;
}

// Product q's pieces (0 hi, 1 mid, 2 lo): hi.hi, hi.mid, mid.hi, hi.lo,
// lo.hi, mid.mid (q 0 alone at kParts 1).
__device__ __forceinline__ int piece_a(int q) {
  return q == 2 || q == 5 ? 1 : q == 4 ? 2 : 0;
}
__device__ __forceinline__ int piece_b(int q) {
  return q == 1 || q == 5 ? 1 : q == 3 ? 2 : 0;
}

// One 128 x 128 output tile of L @ R from the pieces' tensor map (a
// [2 kParts piece_rows, K] bf16 matrix: L's pieces (hi, mid, lo at kParts
// 3), then Rt's, each piece_rows rows, K-major; 64 x 128 boxes, 128-byte
// swizzle): A rows a_row .. a_row + 127 of the L pieces from column a_k,
// B rows b_row .. b_row + 127 of the Rt pieces from column b_k, over kt
// 64-deep slabs; the tile is written at out (row stride ldo). The caller
// keeps kt >= 1 and the same for every thread of the CTA.
template <int kParts>
__device__ __forceinline__ void product_tile_at(const CUtensorMap* pieces,
                                                int piece_rows, int a_row,
                                                int a_k, int b_row, int b_k,
                                                int kt,
                                                float* __restrict__ out,
                                                size_t ldo) {
  namespace hp = irn::hopper;
  using R = Ring<kParts>;
  constexpr int kStages = R::kStages;
  constexpr int kStageBytes = R::kStageBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup: one thread issues the loads
    if (threadIdx.x == 0) {
      for (int k = 0; k < kt; ++k) {
        const int s = k % kStages;
        hp::mbar_wait(&empty[s], ((k / kStages) & 1) ^ 1);
        hp::mbar_expect_tx(&full[s], kStageBytes);
        uint8_t* st = smem + s * kStageBytes;
        for (int p = 0; p < kParts; ++p) {
          hp::tma_load_2d(st + p * kTileBytes, pieces, &full[s],
                          a_k + k * kBK, p * piece_rows + a_row);
          hp::tma_load_2d(st + (kParts + p) * kTileBytes, pieces, &full[s],
                          b_k + k * kBK, (kParts + p) * piece_rows + b_row);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128 - 1;  // consumer warpgroup: rows wg*64..
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x / 32) % 4;
  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;

  for (int k = 0; k < kt; ++k) {
    const int s = k % kStages;
    hp::mbar_wait(&full[s], (k / kStages) & 1);
    const uint32_t st = hp::smem_u32(smem + s * kStageBytes);
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < R::kProducts; ++q) {
        const uint64_t da = hp::desc_k128(st + piece_a(q) * kTileBytes +
                                          wg * 64 * 128) + 2 * kk;
        const uint64_t db =
            hp::desc_k128(st + (kParts + piece_b(q)) * kTileBytes) + 2 * kk;
        hp::wgmma_m64n128k16_ss(acc, da, db, kk > 0 || q > 0);
      }
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
    hp::fence_acc(acc);
    if (lane == 0) hp::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = __fadd_rn(total[i], acc[i]);
  }

  // accumulator layout: per 8-column block j, rows lane/4 and lane/4 + 8 of
  // the warp's 16, columns 8j + 2 (lane % 4) + {0, 1}
  const int row = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(out + (size_t)row * ldo + col) =
        make_float2(total[4 * j], total[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(row + 8) * ldo + col) =
        make_float2(total[4 * j + 2], total[4 * j + 3]);
  }
}

// Output tile blockIdx.x (grouped raster) of the dense out = L @ R
// (pieces [2 kParts, n, n]).
template <int kParts>
__device__ __forceinline__ void product_tile(const CUtensorMap* pieces,
                                             float* __restrict__ out, int n) {
  // grouped raster: kGroup row tiles share the column tiles in flight
  const int tiles = n / kBM;
  const int width = kGroup * tiles;
  const int first = (blockIdx.x / width) * kGroup;
  const int gsize = min(tiles - first, kGroup);
  const int tm = first + (blockIdx.x % width) % gsize;
  const int tn = (blockIdx.x % width) / gsize;
  product_tile_at<kParts>(pieces, n, tm * kBM, 0, tn * kBN, 0, n / kBK,
                          out + (size_t)tm * kBM * n + tn * kBN, n);
}

// The pieces' tensor map: a [pieces x piece_rows, width] bf16 matrix in
// 64 x 128 boxes. False if cuTensorMapEncodeTiled refuses it.
inline bool pieces_map(CUtensorMap* map, const void* pieces, int n_pieces,
                       int piece_rows, int width) {
  const cuuint64_t dims[2] = {(cuuint64_t)width,
                              (cuuint64_t)n_pieces * piece_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)width * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  return irn::hopper::bf16_map(map, pieces, 2, dims, strides, box);
}

// Launch ``kernel`` (a __global__ (const CUtensorMap, float*, int) whose
// body is product_tile<kParts>) over the [2 kParts, n, n] pieces into out.
// Returns the error of the set-up or the launch, or 0 and counts the
// launch.
template <int kParts, typename Kernel>
inline int launch_product(Kernel kernel, const void* pieces, float* out,
                          int n, cudaStream_t s, int* launched) {
  constexpr int kSmem = Ring<kParts>::kSmem;
  CUtensorMap map;
  if (!pieces_map(&map, pieces, 2 * kParts, n, n))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = n / kBM;
  kernel<<<tiles * tiles, kProductThreads, kSmem, s>>>(map, out, n);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

}  // namespace split
}  // namespace irn
