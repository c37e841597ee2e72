// K6 square_fused_first: A -> T @ T with T = colnorm(A^beta) (the first
// squaring of the pure-squaring walk), f32-accurate on the tensor cores.
//
// Replaces: irn_tpu/ops/matpow_pallas.py square_fused_first (_fused_kernel,
// the dense Pallas grid with the transition build folded into its operand
// loads, f32 operands in dots at Precision.HIGHEST: a six-pass bf16
// decomposition on the TPU's matrix unit).
//
//   (T @ T)[i, j] = sum_k L[i, k] * R[k, j],
//   L = B, R[k, j] = B[k, j] * inv[k] * inv[j], B = A^beta,
//   inv = 1 / colsum(B) (computed outside, as the JAX package does with XLA)
//
// This is the TPU's HIGHEST path carried to Hopper, in two launches:
//
// 1. The split pass (one elementwise kernel) raises A to beta by binary
//    exponentiation (matpow_kernels.pow_int's order), scales the right
//    operand in the order B * inv[k] * inv[j], and splits each f32 value x
//    into three bf16 pieces, hi = bf16(x), mid = bf16(x - hi),
//    lo = bf16(x - hi - mid), which carry its 24 bits (exactly, for x whose
//    lo piece stays a normal bf16). L's pieces are stored as they are
//    ([i][k], K-major for the product's A operand), R's transposed ([j][k],
//    K-major for its B operand, through a shared-memory tile). It reads
//    4n^2 bytes and writes 12n^2: about 1 ms of HBM at n 14336. It gives up
//    the TPU kernel's "T never stored", which on this card saves under 1%
//    of the product's time.
// 2. The product: 128 x 128 output tiles, a two-stage ring of TMA loads
//    (one producer warpgroup, of which one thread issues the loads) feeding
//    two consumer warpgroups (64 rows each) through mbarriers; per 64-deep k
//    slab, six wgmma products per k16 step, hi.hi, hi.mid, mid.hi, hi.lo,
//    lo.hi, mid.mid, the terms HIGHEST keeps (the dropped ones are about
//    2^-24 of each product; every term is >= 0, so nothing cancels).
//
// Bound on this card: the bf16 tensor cores, 6 x 2n^3 operations over
// 989 TFLOP/s (35.7 ms at n 14336; the f32 SIMT line of the old design was
// 2n^3 over 67 TFLOP/s, 87.9 ms). The tensor cores align their f32
// accumulation with fewer guard bits than an FMA chain; over n/16 k steps
// that could bias the sum by some 1e-5 of its size, so each slab's products
// start a fresh accumulator (scale-d 0) and are added into an f32 register
// total in round-to-nearest, once per slab. Every operand tile of a slab comes
// from L2 or HBM once per 128 x 128 tile: the 96 KB per slab ask about
// 7.6 TB/s of L2 at the tensor-core peak, more than the cache delivers, so
// a first design reaches some 55-65% of the bound (a 128 x 256 tile would
// halve the B traffic; it needs another accumulator budget).

#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>

namespace {

using bf16 = __nv_bfloat16;
namespace hp = irn::hopper;

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

// kBeta > 0: beta fixed at compile time (the multiplies unroll); 0: beta
// read at run time.
template <int kBeta>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float* __restrict__ a, const float* __restrict__ inv,
             bf16* __restrict__ pieces, int n, int beta) {
  __shared__ bf16 rt[3][kSplitTile][kSplitLd];  // rt[piece][col][row]
  const size_t nn = (size_t)n * n;
  const int r0 = blockIdx.y * kSplitTile;
  const int c0 = blockIdx.x * kSplitTile;
  const int tc = threadIdx.x % kSplitTile;
  const float inv_c = __ldg(inv + c0 + tc);
  for (int tr = threadIdx.x / kSplitTile; tr < kSplitTile;
       tr += kSplitThreads / kSplitTile) {
    const int r = r0 + tr;
    const size_t e = (size_t)r * n + c0 + tc;
    const float b = irn::pow_int(__ldg(a + e), kBeta > 0 ? kBeta : beta);
    bf16 hi, mid, lo;
    split3(b, hi, mid, lo);  // L[r, c]
    pieces[e] = hi;
    pieces[nn + e] = mid;
    pieces[2 * nn + e] = lo;
    split3(__fmul_rn(__fmul_rn(b, __ldg(inv + r)), inv_c), hi, mid, lo);
    rt[0][tc][tr] = hi;  // R[r, c], stored at Rt[c, r]
    rt[1][tc][tr] = mid;
    rt[2][tc][tr] = lo;
  }
  __syncthreads();
  for (int tr = threadIdx.x / kSplitTile; tr < kSplitTile;
       tr += kSplitThreads / kSplitTile) {
    const size_t e = (size_t)(c0 + tr) * n + r0 + tc;
#pragma unroll
    for (int p = 0; p < 3; ++p) pieces[(3 + p) * nn + e] = rt[p][tr][tc];
  }
}

// -- product -------------------------------------------------------------------

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kStages = 2;
constexpr int kTileBytes = kBM * kBK * 2;       // one piece's 128 x 64 tile
constexpr int kStageBytes = 6 * kTileBytes;     // L hi/mid/lo, Rt hi/mid/lo
constexpr int kThreads = 384;                   // producer + 2 consumers
constexpr int kGroup = 16;                      // row tiles per raster group
constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;
// Product q's pieces (0 hi, 1 mid, 2 lo): hi.hi, hi.mid, mid.hi, hi.lo,
// lo.hi, mid.mid.
__device__ __forceinline__ int piece_a(int q) {
  return q == 2 || q == 5 ? 1 : q == 4 ? 2 : 0;
}
__device__ __forceinline__ int piece_b(int q) {
  return q == 1 || q == 5 ? 1 : q == 3 ? 2 : 0;
}

__global__ void __launch_bounds__(kThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap pieces,
               float* __restrict__ out, int n) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  // grouped raster: kGroup row tiles share the column tiles in flight
  const int tiles = n / kBM;
  const int width = kGroup * tiles;
  const int first = (blockIdx.x / width) * kGroup;
  const int gsize = min(tiles - first, kGroup);
  const int tm = first + (blockIdx.x % width) % gsize;
  const int tn = (blockIdx.x % width) / gsize;
  const int kt = n / kBK;

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
        for (int p = 0; p < 3; ++p) {
          hp::tma_load_2d(st + p * kTileBytes, &pieces, &full[s], k * kBK,
                          p * n + tm * kBM);
          hp::tma_load_2d(st + (3 + p) * kTileBytes, &pieces, &full[s],
                          k * kBK, (3 + p) * n + tn * kBN);
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
      for (int q = 0; q < 6; ++q) {
        const uint64_t da = hp::desc_k128(st + piece_a(q) * kTileBytes +
                                          wg * 64 * 128) + 2 * kk;
        const uint64_t db =
            hp::desc_k128(st + (3 + piece_b(q)) * kTileBytes) + 2 * kk;
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
  const int row = tm * kBM + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = tn * kBN + j * 8 + (lane % 4) * 2;
    *reinterpret_cast<float2*>(out + (size_t)row * n + col) =
        make_float2(total[4 * j], total[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (size_t)(row + 8) * n + col) =
        make_float2(total[4 * j + 2], total[4 * j + 3]);
  }
}

int split(const float* a, const float* inv, void* pieces, int n, int beta,
          cudaStream_t s, int* launched) {
  const dim3 grid(n / kSplitTile, n / kSplitTile);
  if (beta == 10)  // the reference's beta
    split_kernel<10><<<grid, kSplitThreads, 0, s>>>(
        a, inv, static_cast<bf16*>(pieces), n, beta);
  else
    split_kernel<0><<<grid, kSplitThreads, 0, s>>>(
        a, inv, static_cast<bf16*>(pieces), n, beta);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

bool shape_ok(int n, int beta) {
  return n >= kBM && n % kBM == 0 && n / kSplitTile <= 65535 && beta >= 1;
}

}  // namespace

// The split pass alone: a, inv as below; pieces [6, n, n] bf16 (L hi, mid,
// lo, then Rt hi, mid, lo). One launch.
IRN_API int irn_square_fused_first_split(const float* a, const float* inv,
                                         void* pieces, int n, int beta,
                                         void* stream, int* launched) {
  if (!shape_ok(n, beta)) return (int)cudaErrorInvalidValue;
  return split(a, inv, pieces, n, beta, static_cast<cudaStream_t>(stream),
               launched);
}

// a, out: [n, n] f32 (out distinct from a), inv: [n] f32, pieces: [6, n, n]
// bf16 scratch; n % 128 == 0, beta >= 1. Two launches: the split pass, then
// the product.
IRN_API int irn_square_fused_first(const float* a, const float* inv,
                                   void* pieces, float* out, int n, int beta,
                                   void* stream, int* launched) {
  if (!shape_ok(n, beta)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = split(a, inv, pieces, n, beta, s, launched);
  if (e) return e;
  CUtensorMap map;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)6 * n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  if (!irn::hopper::bf16_map(&map, pieces, 2, dims, strides, box))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles = n / kBM;
  product_kernel<<<tiles * tiles, kThreads, kSmemBytes, s>>>(map, out, n);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
