// K6 square_fused_first: A -> T @ T with T = colnorm(A^beta) never stored
// (the first squaring of the pure-squaring walk).
//
// Replaces: irn_tpu/ops/matpow_pallas.py square_fused_first (_fused_kernel,
// the dense Pallas grid with the transition build folded into its operand
// loads).
//
//   (T @ T)[i, j] = sum_k B[i, k] * (B[k, j] * inv[k] * inv[j]),
//   B = A^beta, inv = 1 / colsum(B)
//
// inv is computed outside the kernel (the JAX package computes it with XLA
// outside the Pallas body). The left operand is raised to beta on load; the
// right operand is raised to beta and scaled by inv[k], then inv[j], on load
// (the JAX order right * invk * invj), with beta applied by binary
// exponentiation (matpow_kernels.pow_int's multiplication order).
//
// Bound on this card: f32 FLOPs, as K5 (2 n^3 at n = 14336 is 5.9 TFLOP); the
// power and scaling add a few multiplies per staged element, each of which
// then serves 128 outputs. It saves the write and re-read of T (0.8 GB).
//
// Design: K5's tile routine (irn::sgemm_tile) with the two load transforms,
// beta fixed at compile time for the reference's beta = 10.

#include "common.cuh"

namespace {

// kBeta > 0: beta fixed at compile time (the multiplies unroll); 0: beta
// read at run time.
template <int kBeta>
__device__ __forceinline__ float pow_beta(float v, int beta) {
  return irn::pow_int(v, kBeta > 0 ? kBeta : beta);
}

template <int kBeta>
struct PowLoad {
  int beta;
  __device__ __forceinline__ float4 operator()(float4 v, int, int) const {
    return make_float4(pow_beta<kBeta>(v.x, beta), pow_beta<kBeta>(v.y, beta),
                       pow_beta<kBeta>(v.z, beta), pow_beta<kBeta>(v.w, beta));
  }
};

template <int kBeta>
struct PowScaleLoad {
  int beta;
  const float* __restrict__ inv;
  __device__ __forceinline__ float4 operator()(float4 v, int k, int j) const {
    const float ik = __ldg(inv + k);
    const float4 ij = __ldg(reinterpret_cast<const float4*>(inv + j));
    return make_float4(
        __fmul_rn(__fmul_rn(pow_beta<kBeta>(v.x, beta), ik), ij.x),
        __fmul_rn(__fmul_rn(pow_beta<kBeta>(v.y, beta), ik), ij.y),
        __fmul_rn(__fmul_rn(pow_beta<kBeta>(v.z, beta), ik), ij.z),
        __fmul_rn(__fmul_rn(pow_beta<kBeta>(v.w, beta), ik), ij.w));
  }
};

template <int kBeta>
__global__ void __launch_bounds__(irn::kGemmThreads, 2)
square_fused_first_kernel(const float* __restrict__ a,
                          const float* __restrict__ inv,
                          float* __restrict__ out, int n, int beta) {
  irn::sgemm_tile(a, a, out, n, PowLoad<kBeta>{beta},
                  PowScaleLoad<kBeta>{beta, inv});
}

}  // namespace

// a, out: [n, n] (out distinct from a), inv: [n] (16-byte aligned);
// n % 128 == 0, beta >= 1.
IRN_API int irn_square_fused_first(const float* a, const float* inv,
                                   float* out, int n, int beta, void* stream,
                                   int* launched) {
  if (n < irn::kGemmBM || n % irn::kGemmBM || n / irn::kGemmBM > 65535 ||
      beta < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(n / irn::kGemmBN, n / irn::kGemmBM);
  if (beta == 10)  // the reference's beta
    square_fused_first_kernel<10>
        <<<grid, irn::kGemmThreads, 0, s>>>(a, inv, out, n, beta);
  else
    square_fused_first_kernel<0>
        <<<grid, irn::kGemmThreads, 0, s>>>(a, inv, out, n, beta);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
