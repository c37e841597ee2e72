// K5 square_dense: T @ T for a dense n x n f32 matrix (every squaring of the
// pure-squaring walk after the first), f32-accurate on the tensor cores.
//
// Replaces: irn_tpu/ops/matpow_pallas.py square_pallas (_square_kernel, a
// Pallas MXU grid over (i, j, k) blocks with an f32 VMEM accumulator; f32
// operands in dots at Precision.HIGHEST, a six-pass bf16 decomposition on
// the TPU's matrix unit).
//
// Bound on this card: the bf16 tensor cores, 6 x 2n^3 operations over
// 989 TFLOP/s (35.7 ms at n 14336). The design it replaces, an f32 SIMT
// tile, was bound by 2n^3 over the 67 TFLOP/s f32 peak (87.9 ms) and ran
// 16% behind cuBLAS f32; TF32 would not be the f32 result.
//
// Design: K6's split product (split_product.cuh), with an identity split,
// in two launches:
// 1. The split pass writes the bf16 hi/mid/lo pieces of L = T as [i][k] and
//    of R = T transposed as [j][k], so both operands are K-major: K6's
//    split at beta 1 with no scaling (the same pieces as beta 1 and inv all
//    ones, since x * 1.0 is exact). It reads 4n^2 bytes and writes 12n^2:
//    scratch of 12 n^2 bytes (2.5 GB at n 14336, 4.1 GB at n 18432) and
//    about 1 ms of HBM at n 14336. Reading B through an MN-major wgmma
//    descriptor would halve the scratch; the six pieces keep one product
//    body for K5 and K6.
// 2. K6's product: 128 x 128 tiles, a two-stage TMA ring (one producer
//    warpgroup, two consumer warpgroups), six wgmma piece products per k16
//    step, a fresh accumulator per 64-deep slab added into an f32 total.
// The walk pads n to 512; this kernel takes any n that is a multiple of
// 128.
//
// The bf16 operand mode (passes 1, the JAX package's matmul_dtype
// bfloat16: square_pallas rounds T once to bf16 and accumulates in f32)
// is the same two launches at kParts 1: the split pass writes bf16(T) and
// its transpose ([2, n, n], 4 n^2 bytes), the product runs one wgmma per
// k16 step, bound by 2n^3 over 989 TFLOP/s (5.96 ms at n 14336).

#include "split_product.cuh"

namespace {

namespace sp = irn::split;

template <int kParts>
__global__ void __launch_bounds__(sp::kSplitThreads)
split_kernel(const float* __restrict__ t, sp::bf16* __restrict__ pieces,
             int n) {
  sp::split_tile<1, false, kParts>(t, nullptr, pieces, n, 1);
}

template <int kParts>
__global__ void __launch_bounds__(sp::kProductThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap pieces,
               float* __restrict__ out, int n) {
  sp::product_tile<kParts>(&pieces, out, n);
}

template <int kParts>
int split(const float* t, void* pieces, int n, cudaStream_t s,
          int* launched) {
  split_kernel<kParts><<<sp::split_grid(n), sp::kSplitThreads, 0, s>>>(
      t, static_cast<sp::bf16*>(pieces), n);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

template <int kParts>
int square(const float* t, void* pieces, float* out, int n, cudaStream_t s,
           int* launched) {
  const int e = split<kParts>(t, pieces, n, s, launched);
  if (e) return e;
  return sp::launch_product<kParts>(product_kernel<kParts>, pieces, out, n,
                                    s, launched);
}

}  // namespace

// The split pass alone: t [n, n] f32; pieces [6, n, n] bf16 at passes 6
// (T hi, mid, lo, then T^T hi, mid, lo), [2, n, n] at passes 1 (bf16(T),
// then its transpose). One launch.
IRN_API int irn_square_dense_split(const float* t, void* pieces, int n,
                                   int passes, void* stream, int* launched) {
  if (!sp::shape_ok(n) || (passes != 6 && passes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 6 ? split<3>(t, pieces, n, s, launched)
                     : split<1>(t, pieces, n, s, launched);
}

// t, out: [n, n] f32 (out distinct from t), pieces: bf16 scratch of
// [6, n, n] at passes 6 (f32-accurate), [2, n, n] at passes 1 (bf16
// operands); n % 128 == 0. Two launches: the split pass, then the product.
IRN_API int irn_square_dense(const float* t, void* pieces, float* out, int n,
                             int passes, void* stream, int* launched) {
  if (!sp::shape_ok(n) || (passes != 6 && passes != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 6 ? square<3>(t, pieces, out, n, s, launched)
                     : square<1>(t, pieces, out, n, s, launched);
}
