// K0 diag_chain: x @ T^n_apply with the random-walk transition T held in
// diagonal form (the e=0 default walk of make_sem_seg).
//
// Replaces: irn_tpu/ops/random_walk.py apply_diag_chain (an XLA-fused jnp
// stencil on the TPU, not a Pallas kernel).
//
//   out[c, j] = (x[c, j] + sum_k x[c, j-d_k] * w[k, j-d_k]
//                        + x[c, j+d_k] * w[k, j]) * inv[j]
//
// Bound on this card: an application reads x [C, n] at 2P+1 shifts and the
// weights w [P, n] twice. x (<= 1.1 MB) and w (1.9 MB at n = 14336, P = 34)
// stay in the 50 MB L2, so one application is bound by L1/L2 traffic and by
// launch latency (256 applications per image), not by HBM.
//
// Design: one thread per (column j, RT seed rows); each diagonal's two
// weights load once and serve all RT rows, and neighbouring threads read
// neighbouring columns (coalesced). The TPU ran the whole chain in one
// program; Hopper blocks cannot order themselves across an application, so
// this first version launches once per application, ping-ponging two device
// buffers, with the host loop issuing every launch from one C call. The
// adds and multiplies round separately (__fadd_rn/__fmul_rn, no FMA
// contraction) in the term order of the plain twin, so the two agree to the
// bit.

#include "common.cuh"

namespace {

constexpr int kMaxDiags = 64;
constexpr int RT = 4;  // seed rows per thread
constexpr int kThreads = 128;

struct DiagOffsets {
  int d[kMaxDiags];
};

__global__ void __launch_bounds__(kThreads)
diag_apply_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ inv, float* __restrict__ out,
                  DiagOffsets offs, int P, int C, int n) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int c0 = blockIdx.y * RT;
  if (j >= n) return;
  float acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
    acc[r] = (c0 + r < C) ? x[(size_t)(c0 + r) * n + j] : 0.f;
  for (int k = 0; k < P; ++k) {
    const int d = offs.d[k];
    const int jl = j - d;
    const int jr = j + d;
    const float wl = jl >= 0 ? w[(size_t)k * n + jl] : 0.f;
    const float wr = w[(size_t)k * n + j];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (c0 + r < C) {
        const float* xr = x + (size_t)(c0 + r) * n;
        const float xl = jl >= 0 ? xr[jl] : 0.f;
        const float xh = jr < n ? xr[jr] : 0.f;
        acc[r] = __fadd_rn(__fadd_rn(acc[r], __fmul_rn(xl, wl)),
                           __fmul_rn(xh, wr));
      }
    }
  }
  const float s = inv[j];
#pragma unroll
  for (int r = 0; r < RT; ++r)
    if (c0 + r < C) out[(size_t)(c0 + r) * n + j] = __fmul_rn(acc[r], s);
}

}  // namespace

// x, out, scratch: [C, n]; w: [P, n]; inv: [n] (device). doffs: [P] host.
// The last application writes ``out``; ``scratch`` carries the others.
IRN_API int irn_diag_chain(const float* x, const float* w, const float* inv,
                           const int* doffs, float* out, float* scratch,
                           int P, int C, int n, int n_apply, void* stream,
                           int* launched) {
  if (P < 0 || P > kMaxDiags || C < 1 || n < 1 || n_apply < 1)
    return (int)cudaErrorInvalidValue;
  DiagOffsets offs;
  for (int k = 0; k < P; ++k) offs.d[k] = doffs[k];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kThreads);
  const dim3 grid((n + kThreads - 1) / kThreads, (C + RT - 1) / RT);
  const float* src = x;
  for (int a = 0; a < n_apply; ++a) {
    float* dst = ((n_apply - 1 - a) % 2 == 0) ? out : scratch;
    diag_apply_kernel<<<grid, block, 0, s>>>(src, w, inv, dst, offs, P, C, n);
    IRN_CHECK_LAUNCH(launched);
    src = dst;
  }
  return 0;
}
