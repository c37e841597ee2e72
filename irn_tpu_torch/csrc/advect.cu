// K11 advect: the instance stage's 300-step centroid advection and the
// basin predicate, for one image.
//
// Replaces: irn_tpu/ops/centroids.py _find_centroids_matmul (an XLA
// fori_loop; the two-tap separable bilinear sample) and the fused
// |dp| < thres predicate of irn_tpu/pipeline/stages_irn.py
// _advect_pack_core / _cluster_pack_core.
//
// Each pixel's particle starts at (min(row, h4 - 1), min(col, w4 - 1)) and
// moves, 300 times, by the bilinear sample of dp at its position, clipped to
// [0, h4 - 1] x [0, w4 - 1]; the end point rounds half to even (rintf, as
// jnp.rint and torch.round). With ly = floor(y), fy = y - ly:
// r(c) = fma(fy, f[ly + 1, c], (1 - fy) f[ly, c]) at c = lx, lx + 1 (the
// JAX form's row interpolation is a matmul, which XLA's CPU dot accumulates
// by fused multiply-adds), then s = (1 - fx) r(lx) + fx r(lx + 1), a product
// and a sum, both channels at the old (y, x). A tap past the grid has
// weight exactly 0; its index is clamped, as the plain twin clamps it, so
// its product is 0 there too. Every operation is written out (__fmaf_rn,
// __fmul_rn, __fadd_rn) in the twin's order, so nvcc contracts nothing else
// and the kernel is bit-equal to ops/centroids.advect_plain.
//
// Bound on this card: neither bytes nor operations. At the 128 x 128 cap it
// reads 128 KB of dp and writes 144 KB, and does ~20 operations per pixel
// and step (98 MFLOP over 300 steps, ~1.5 us at the f32 peak); but every
// step depends on the one before, so a particle's 300 steps are a chain of
// dependent L1 loads and arithmetic: latency.
//
// Design: one thread per pixel, the particle in registers for all 300 steps
// (no barrier: a step reads only dp), dp through the read-only L1 path
// (__ldg; 128 KB at the cap, which the particles of one block revisit
// within a few cells); the basin predicate fused in the same thread. One
// launch per image.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float sample(const float* __restrict__ f, int i00,
                                        int i10, int dx1, float gy, float fy,
                                        float gx, float fx) {
  const float r0 =
      __fmaf_rn(fy, __ldg(f + i10), __fmul_rn(gy, __ldg(f + i00)));
  const float r1 = __fmaf_rn(fy, __ldg(f + i10 + dx1),
                             __fmul_rn(gy, __ldg(f + i00 + dx1)));
  return __fadd_rn(__fmul_rn(gx, r0), __fmul_rn(fx, r1));
}

__global__ void __launch_bounds__(kThreads)
advect_kernel(const float* __restrict__ dp, int* __restrict__ cent,
              uint8_t* __restrict__ basin, int H, int W, int h4, int w4,
              int iterations, float thres) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= H * W) return;
  const int row = p / W;
  const int col = p % W;
  const float* fdy = dp;
  const float* fdx = dp + H * W;
  const float ymax = (float)(h4 - 1);
  const float xmax = (float)(w4 - 1);
  float y = fminf((float)row, ymax);
  float x = fminf((float)col, xmax);
  for (int it = 0; it < iterations; ++it) {
    const float ly = floorf(y);
    const float lx = floorf(x);
    const float fy = __fsub_rn(y, ly);
    const float fx = __fsub_rn(x, lx);
    const float gy = __fsub_rn(1.f, fy);
    const float gx = __fsub_rn(1.f, fx);
    const int iy = (int)ly;
    const int ix = (int)lx;
    const int i00 = iy * W + ix;
    const int i10 = min(iy + 1, H - 1) * W + ix;
    const int dx1 = min(ix + 1, W - 1) - ix;
    const float sy = sample(fdy, i00, i10, dx1, gy, fy, gx, fx);
    const float sx = sample(fdx, i00, i10, dx1, gy, fy, gx, fx);
    y = fminf(fmaxf(__fadd_rn(y, sy), 0.f), ymax);
    x = fminf(fmaxf(__fadd_rn(x, sx), 0.f), xmax);
  }
  cent[p] = (int)rintf(y);
  cent[H * W + p] = (int)rintf(x);
  const float dy = __ldg(fdy + p);
  const float dx = __ldg(fdx + p);
  basin[p] = __fsqrt_rn(__fadd_rn(__fmul_rn(dy, dy), __fmul_rn(dx, dx))) <
             thres;
}

}  // namespace

// dp: [2, H, W] f32; cent: [2, H, W] int32; basin: [H, W] bool (uint8).
IRN_API int irn_advect(const float* dp, int* cent, uint8_t* basin, int H,
                       int W, int h4, int w4, int iterations, float thres,
                       void* stream, int* launched) {
  if (H < 1 || W < 1 || h4 < 1 || h4 > H || w4 < 1 || w4 > W ||
      iterations < 0 || (long long)H * W >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (H * W + kThreads - 1) / kThreads;
  advect_kernel<<<blocks, kThreads, 0, s>>>(dp, cent, basin, H, W, h4, w4,
                                            iterations, thres);
  IRN_CHECK_LAUNCH(launched);
  return 0;
}
