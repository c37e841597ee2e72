// K2 square_banded: T @ T for a banded T (T[r, q] == 0 when |q - r| > h),
// f32-accurate on the tensor cores.
//
// Replaces: irn_tpu/ops/matpow_pallas.py square_banded
// (_banded_square_kernel, a Pallas MXU grid over in-band blocks; f32
// operands in dots at Precision.HIGHEST, a six-pass bf16 decomposition on
// the TPU's matrix unit).
//
// Only output blocks (i, j) with |i - j| <= jb = ceil(2h/bs) are computed,
// and each contracts only the blocks k in [max(i,j) - kb, min(i,j) + kb],
// kb = ceil(h/bs), where both operands are in band. Out-of-band output
// blocks are never written: as in the TPU kernel's contract their content
// is unspecified, and every consumer reads in-band tiles only (K1). No
// input block outside the band is read either: from the second squaring on
// those blocks are unspecified too.
//
// Bound on this card: the bf16 tensor cores, six passes of 2 bs^3
// operations per block product (about 640 of them at n 14336, bs 512,
// h 556: 161.6 GFLOP of f32 work, 0.98 ms for the six passes at
// 989 TFLOP/s). The design it replaces, a SIMT f32 SGEMM tile, was bound by
// the f32 work over 67 TFLOP/s (2.41 ms) and reached 48% of it.
//
// Design: the split product of K5 and K6 (split_product.cuh) on band
// layouts, in two launches:
// 1. The split pass reads each in-band input block once and writes its
//    bf16 hi/mid/lo pieces twice: into L's row band, [i][k - (i_blk - kb)bs]
//    (K-major for the A operand), and transposed into R's column band,
//    [j][k - (j_blk - kb)bs] (K-major for B). Pieces [6, n, W] bf16 with
//    W = (2kb+1) bs: 12 bytes per in-band element (0.44 GB at n 14336,
//    h 556, against 2.47 GB for a whole-matrix split). Band positions past
//    the matrix edge are written as zeros, so every byte of the scratch is
//    defined.
// 2. The product: one CTA per 128 x 128 tile of an in-band output block
//    (the others return before any wgmma), K6's TMA + wgmma mainloop over
//    the tile's own k range, six piece products per k16 step, a fresh
//    accumulator per 64-deep slab added into an f32 total.
// When the band covers the matrix the wrapper calls torch.matmul instead,
// as the JAX function falls back to XLA's dot.
//
// The bf16 operand mode (passes 1, the JAX kernel's matmul_dtype bfloat16:
// T rounded once to bf16, products accumulated in f32) is the same two
// launches at kParts 1: the split pass writes the hi pieces alone
// ([2, n, W], 4 bytes per in-band element), the product runs one wgmma per
// k16 step (bound one sixth of the six-pass one, 0.16 ms at n 14336,
// h 556).

#include "split_product.cuh"

namespace {

namespace sp = irn::split;

// Grid ((bs/64)^2, 2kb+1, nb): 64 x 64 tile blockIdx.x of block (r_blk =
// blockIdx.z, c_blk = r_blk + blockIdx.y - kb).
template <int kParts>
__global__ void __launch_bounds__(sp::kSplitThreads)
band_split_kernel(const float* __restrict__ t, sp::bf16* __restrict__ pieces,
                  int n, int bs, int kb) {
  const int nb = n / bs;
  const int w = (2 * kb + 1) * bs;
  const size_t piece = (size_t)n * w;
  const int per = bs / sp::kSplitTile;
  const int d = blockIdx.y;
  const int r_blk = blockIdx.z;
  const int c_blk = r_blk + d - kb;
  const int ty = blockIdx.x / per, tx = blockIdx.x % per;
  const int r0 = r_blk * bs + ty * sp::kSplitTile;
  sp::bf16* l = pieces + (size_t)r0 * w + d * bs + tx * sp::kSplitTile;
  if (c_blk < 0 || c_blk >= nb) {
    // band position past the edge: zeros in L's row band r_blk and in R's
    // column band r_blk (whose row block r_blk + d - kb is c_blk)
    const sp::bf16 z = __float2bfloat16_rn(0.f);
    for (int e = threadIdx.x; e < sp::kSplitTile * sp::kSplitTile;
         e += sp::kSplitThreads) {
      const size_t o = (size_t)(e / sp::kSplitTile) * w + e % sp::kSplitTile;
#pragma unroll
      for (int p = 0; p < 2 * kParts; ++p) l[p * piece + o] = z;
    }
    return;
  }
  const int c0 = c_blk * bs + tx * sp::kSplitTile;
  sp::split_tile_at<1, false, kParts>(
      t, nullptr, n, r0, c0, l, w, piece,
      pieces + kParts * piece + (size_t)c0 * w + (2 * kb - d) * bs +
          ty * sp::kSplitTile,
      w, piece, 1);
}

// Grid ((bs/128)^2, 2jb+1, nb): 128 x 128 tile blockIdx.x of output block
// (i = blockIdx.z, j = i + blockIdx.y - jb).
template <int kParts>
__global__ void __launch_bounds__(sp::kProductThreads, 1)
band_product_kernel(const __grid_constant__ CUtensorMap pieces,
                    float* __restrict__ out, int n, int bs, int kb, int jb) {
  const int nb = n / bs;
  const int i = blockIdx.z;
  const int j = i + (int)blockIdx.y - jb;
  if (j < 0 || j >= nb) return;  // the whole CTA, before any wgmma
  const int per = bs / sp::kBM;
  const int row0 = i * bs + (int)(blockIdx.x / per) * sp::kBM;
  const int col0 = j * bs + (int)(blockIdx.x % per) * sp::kBN;
  const int klo = max(max(i, j) - kb, 0);
  const int khi = min(min(i, j) + kb, nb - 1);
  sp::product_tile_at<kParts>(&pieces, n, row0, (klo - i + kb) * bs, col0,
                      (klo - j + kb) * bs, (khi - klo + 1) * bs / sp::kBK,
                      out + (size_t)row0 * n + col0, n);
}

bool shape_ok(int n, int bs, int kb, int jb) {
  return n >= 1 && bs >= sp::kBM && bs % sp::kBM == 0 && n % bs == 0 &&
         kb >= 0 && jb >= 0 && jb <= 2 * kb && n / bs <= 65535 &&
         2 * jb + 1 <= 65535 && 2 * kb + 1 <= 65535 &&
         (bs / sp::kSplitTile) * (bs / sp::kSplitTile) <= 65535;
}

template <int kParts>
int split(const float* t, void* pieces, int n, int bs, int kb,
          cudaStream_t s, int* launched) {
  const int per = bs / sp::kSplitTile;
  band_split_kernel<kParts><<<dim3(per * per, 2 * kb + 1, n / bs),
                              sp::kSplitThreads, 0, s>>>(
      t, static_cast<sp::bf16*>(pieces), n, bs, kb);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

template <int kParts>
int square(const float* t, void* pieces, float* out, int n, int bs, int kb,
           int jb, cudaStream_t s, int* launched) {
  constexpr int kSmem = sp::Ring<kParts>::kSmem;
  const int e = split<kParts>(t, pieces, n, bs, kb, s, launched);
  if (e) return e;
  CUtensorMap map;
  if (!sp::pieces_map(&map, pieces, 2 * kParts, n, (2 * kb + 1) * bs))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      band_product_kernel<kParts>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int per = bs / sp::kBM;
  band_product_kernel<kParts><<<dim3(per * per, 2 * jb + 1, n / bs),
                                sp::kProductThreads, kSmem, s>>>(
      map, out, n, bs, kb, jb);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

}  // namespace

// The split pass alone: t [n, n] f32; pieces [6, n, (2kb+1) bs] bf16 at
// passes 6 (L's row bands hi, mid, lo, then R's column bands transposed),
// [2, n, (2kb+1) bs] at passes 1 (the hi pieces alone). One launch.
IRN_API int irn_square_banded_split(const float* t, void* pieces, int n,
                                    int bs, int kb, int passes, void* stream,
                                    int* launched) {
  if (!shape_ok(n, bs, kb, 0) || (passes != 6 && passes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 6 ? split<3>(t, pieces, n, bs, kb, s, launched)
                     : split<1>(t, pieces, n, bs, kb, s, launched);
}

// t, out: [n, n] f32 (out distinct from t); pieces: bf16 scratch of
// [6, n, (2kb+1) bs] at passes 6 (f32-accurate), [2, n, (2kb+1) bs] at
// passes 1 (bf16 operands). kb/jb: block-level input/output band
// halfwidths (jb <= 2kb); bs a multiple of 128, n of bs. Two launches: the
// split pass, then the product.
IRN_API int irn_square_banded(const float* t, void* pieces, float* out,
                              int n, int bs, int kb, int jb, int passes,
                              void* stream, int* launched) {
  if (!shape_ok(n, bs, kb, jb) || (passes != 6 && passes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 6
             ? square<3>(t, pieces, out, n, bs, kb, jb, s, launched)
             : square<1>(t, pieces, out, n, bs, kb, jb, s, launched);
}
