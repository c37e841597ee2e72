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
// This is the TPU's HIGHEST path carried to Hopper, in two launches, both
// from split_product.cuh (shared with K5 square_dense):
//
// 1. The split pass (one elementwise kernel) raises A to beta by binary
//    exponentiation (matpow_kernels.pow_int's order), scales the right
//    operand in the order B * inv[k] * inv[j], and writes the three bf16
//    pieces of L and of R (R transposed). It reads 4n^2 bytes and writes
//    12n^2: about 1 ms of HBM at n 14336. It gives up the TPU kernel's
//    "T never stored", which on this card saves under 1% of the product's
//    time.
// 2. The product: 128 x 128 output tiles, a two-stage TMA ring, two
//    consumer warpgroups, six wgmma piece products per k16 step, a fresh
//    accumulator per 64-deep slab added into an f32 register total.
//
// Bound on this card: the bf16 tensor cores, 6 x 2n^3 operations over
// 989 TFLOP/s (35.7 ms at n 14336; the f32 SIMT line of the old design was
// 2n^3 over 67 TFLOP/s, 87.9 ms). Every operand tile of a slab comes
// from L2 or HBM once per 128 x 128 tile: the 96 KB per slab ask about
// 7.6 TB/s of L2 at the tensor-core peak, more than the cache delivers, so
// a first design reaches some 55-65% of the bound (a 128 x 256 tile would
// halve the B traffic; it needs another accumulator budget).
//
// The bf16 operand mode (passes 1, the JAX kernel's matmul_dtype bfloat16:
// left = bf16(A^beta), right = bf16(A^beta * inv_k * inv_j), each rounded
// after its f32 pow and scale, products accumulated in f32) is the same
// two launches at kParts 1: the split pass writes the two hi pieces
// ([2, n, n]), the product runs one wgmma per k16 step (bound 2n^3 over
// 989 TFLOP/s, 5.96 ms at n 14336).

#include "split_product.cuh"

namespace {

namespace sp = irn::split;

// kBeta > 0: beta fixed at compile time (the multiplies unroll); 0: beta
// read at run time.
template <int kBeta, int kParts>
__global__ void __launch_bounds__(sp::kSplitThreads)
split_kernel(const float* __restrict__ a, const float* __restrict__ inv,
             sp::bf16* __restrict__ pieces, int n, int beta) {
  sp::split_tile<kBeta, true, kParts>(a, inv, pieces, n, beta);
}

template <int kParts>
__global__ void __launch_bounds__(sp::kProductThreads, 1)
product_kernel(const __grid_constant__ CUtensorMap pieces,
               float* __restrict__ out, int n) {
  sp::product_tile<kParts>(&pieces, out, n);
}

template <int kParts>
int split(const float* a, const float* inv, void* pieces, int n, int beta,
          cudaStream_t s, int* launched) {
  if (beta == 10)  // the reference's beta
    split_kernel<10, kParts><<<sp::split_grid(n), sp::kSplitThreads, 0, s>>>(
        a, inv, static_cast<sp::bf16*>(pieces), n, beta);
  else
    split_kernel<0, kParts><<<sp::split_grid(n), sp::kSplitThreads, 0, s>>>(
        a, inv, static_cast<sp::bf16*>(pieces), n, beta);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

template <int kParts>
int square(const float* a, const float* inv, void* pieces, float* out, int n,
           int beta, cudaStream_t s, int* launched) {
  const int e = split<kParts>(a, inv, pieces, n, beta, s, launched);
  if (e) return e;
  return sp::launch_product<kParts>(product_kernel<kParts>, pieces, out, n,
                                    s, launched);
}

bool shape_ok(int n, int beta, int passes) {
  return sp::shape_ok(n) && beta >= 1 && (passes == 6 || passes == 1);
}

}  // namespace

// The split pass alone: a, inv as below; pieces [6, n, n] bf16 at passes 6
// (L hi, mid, lo, then Rt hi, mid, lo), [2, n, n] at passes 1 (L's and Rt's
// hi pieces). One launch.
IRN_API int irn_square_fused_first_split(const float* a, const float* inv,
                                         void* pieces, int n, int beta,
                                         int passes, void* stream,
                                         int* launched) {
  if (!shape_ok(n, beta, passes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 6 ? split<3>(a, inv, pieces, n, beta, s, launched)
                     : split<1>(a, inv, pieces, n, beta, s, launched);
}

// a, out: [n, n] f32 (out distinct from a), inv: [n] f32, pieces: bf16
// scratch of [6, n, n] at passes 6 (f32-accurate), [2, n, n] at passes 1
// (bf16 operands); n % 128 == 0, beta >= 1. Two launches: the split pass,
// then the product.
IRN_API int irn_square_fused_first(const float* a, const float* inv,
                                   void* pieces, float* out, int n, int beta,
                                   int passes, void* stream, int* launched) {
  if (!shape_ok(n, beta, passes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return passes == 6
             ? square<3>(a, inv, pieces, out, n, beta, s, launched)
             : square<1>(a, inv, pieces, out, n, beta, s, launched);
}
