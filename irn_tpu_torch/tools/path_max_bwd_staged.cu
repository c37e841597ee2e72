// A probe, not on the main path: K13b (path_max.cu's path_max_bwd_kernel)
// in the per-pixel form, with the winners of a block's output window
// staged in shared memory. tools/probe_path_max_bwd.py builds it on its own
// and times it beside the pair-major K13b on the same inputs.
//
// Each thread owns 4 x-adjacent edge pixels of a TX x TY block tile and
// walks every (p, l) entry of JAX's by_cell lists in list order, keeping
// per pixel one sum s_u and the running acc = ((0 + s_u1) + s_u2) + ...
// (only hits are added; path_max.cu's header gives the argument). An
// entry's 4 winner bytes lie side by side in the staged window, so one
// decode serves the 4 pixels: two shared-memory words, a funnel shift and
// one __vcmpeq4 against l. g is read from global memory on a hit only,
// by predicated loads issued for the next kGroup entries before this
// group's adds.
//   The window of pair p is the output rows and columns that its cells
// (their box dy0..dy1, dx0..dx1) take into the tile: TY + dy1 - dy0 rows of
// TX + dx1 - dx0 bytes. The block stages all pairs' windows with 4-byte
// cp.async from the word-aligned global row start (rows of cw bytes are not
// word-aligned, so each row keeps its own byte shift), then writes 0xff,
// which no winner equals, over every byte outside the output window.
//
// tables (host-built by the probe for one tile and shape, in constant
// memory): per entry in by_cell order three words, (its window byte for
// thread (0, 0) at shift 0 | row stride in words << 18 | l << 24 | last of
// its cell << 31), its g offset for pixel (0, 0), p plane - dy cw - (dx +
// rf), and its row shift for pixel (0, 0) of batch 0 at X0 0 (mod 4); then
// per pair two words for the staging, its window's word offset | row
// stride in words << 16, and dy1 | (dx1 + rf) << 8 | (dx0 + rf) << 16 |
// rows << 24.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kPx = 4;
constexpr int kMaxWords = 12288;
constexpr int kSmemMax = 232448;
__constant__ int c_tab[kMaxWords];

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// a predicated load: v stays as it is where pred is false
__device__ __forceinline__ void ld_if(float& v, const float* p, bool pred) {
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}"
      : "+f"(v)
      : "l"(p), "r"((unsigned)pred));
}

template <int kGroup>
__global__ void __launch_bounds__(256)
staged_bwd_kernel(const float* __restrict__ g,
                  const int8_t* __restrict__ winner,
                  float* __restrict__ d_edge, int H, int W, int rf,
                  int n_pairs, int n_entries, int tx_tile, int ty_tile,
                  int max_rows, long long total_bytes) {
  extern __shared__ __align__(16) uint32_t win[];
  const int ch = H - rf;
  const int cw = W - 2 * rf;
  const int b = blockIdx.z;
  const int X0 = blockIdx.x * tx_tile;
  const int Y0 = blockIdx.y * ty_tile;
  const int lanes = tx_tile / kPx;
  const int nthr = lanes * ty_tile;
  const int t = threadIdx.y * lanes + threadIdx.x;
  const int* pair = c_tab + 3 * n_entries;
  const long long bplane = (long long)b * n_pairs * ch;
  // stage every pair's window, word by word
  for (int p = 0; p < n_pairs; ++p) {
    const int w0 = pair[2 * p], w1 = pair[2 * p + 1];
    const int rw = w0 >> 16;
    const int oy0 = Y0 - (w1 & 0xff);
    const long long gs0 =
        (bplane + (long long)p * ch + oy0) * cw + X0 - (w1 >> 8 & 0xff);
    for (int i = t; i < (w1 >> 24) * rw; i += nthr) {
      const int r = i / rw;
      const int oy = oy0 + r;
      const long long gs = gs0 + (long long)r * cw;
      const long long at = gs - (gs & 3) + 4LL * (i - r * rw);
      uint32_t* dst = win + (w0 & 0xffff) + i;
      if (oy < 0 || oy >= ch || at < 0 || at >= total_bytes)
        *dst = 0xffffffffu;
      else
        cp_async4((uint32_t)__cvta_generic_to_shared(dst), winner + at);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // 0xff over the columns outside the output window (edge blocks only)
  if (X0 - 2 * rf < 0 || X0 + tx_tile > cw) {
    unsigned char* bytes = reinterpret_cast<unsigned char*>(win);
    for (int i = t; i < n_pairs * max_rows; i += nthr) {
      const int p = i / max_rows;
      const int r = i - p * max_rows;
      const int w0 = pair[2 * p], w1 = pair[2 * p + 1];
      const int dx1r = w1 >> 8 & 0xff;
      const int cols = tx_tile + dx1r - (w1 >> 16 & 0xff);
      const int oy = Y0 - (w1 & 0xff) + r;
      if (r >= (w1 >> 24) || oy < 0 || oy >= ch) continue;
      const int ox0 = X0 - dx1r;
      const long long gs = (bplane + (long long)p * ch + oy) * cw + ox0;
      unsigned char* row =
          bytes + 4 * ((w0 & 0xffff) + r * (w0 >> 16)) + (gs & 3);
      for (int c = 0; c < min(cols, -ox0); ++c) row[c] = 0xff;
      for (int c = max(0, cw - ox0); c < cols; ++c) row[c] = 0xff;
    }
  }
  __syncthreads();
  const int ty = threadIdx.y;
  const int tx = threadIdx.x * kPx;
  const int Y = Y0 + ty;
  const int X = X0 + tx;
  // g of batch b at output (Y, X); an entry adds its own offset
  const float* gb = g + (long long)b * n_pairs * ch * cw + Y * cw + X;
  // the row shift of pixel (Y, X0) mod 4, from 32-bit arithmetic
  const unsigned sh = (unsigned)bplane * (unsigned)cw + (unsigned)X0 +
                      (unsigned)Y * (unsigned)cw;
  // a group's hit masks, cell-end flags and cotangents (loads in flight)
  uint32_t m[kGroup], last[kGroup];
  float v[kGroup][kPx];
  auto decode = [&](int e0) {
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int e = e0 + q;
      const bool ok = e < n_entries;
      const uint32_t a = (uint32_t)c_tab[ok ? 3 * e : 0];
      const int off = c_tab[ok ? 3 * e + 1 : 0];
      const int byte = (a & 0x3ffff) + ty * (a >> 16 & 0xfc) +
                       ((sh + c_tab[ok ? 3 * e + 2 : 0]) & 3) + tx;
      const uint32_t w4 =
          __funnelshift_r(win[byte >> 2], win[(byte >> 2) + 1], byte * 8);
      m[q] = ok ? __vcmpeq4(w4, (a >> 24 & 127) * 0x01010101u) : 0u;
      last[q] = ok ? a >> 31 : 0u;
#pragma unroll
      for (int k = 0; k < kPx; ++k) {
        v[q][k] = 0.f;
        ld_if(v[q][k], gb + off + k, m[q] >> (8 * k) & 1);
      }
    }
  };
  float s[kPx], acc[kPx];
#pragma unroll
  for (int k = 0; k < kPx; ++k) s[k] = acc[k] = 0.f;
  decode(0);
  for (int e0 = 0; e0 < n_entries; e0 += kGroup) {
    // this group's, while the next group's loads are issued
    uint32_t mc[kGroup], lc[kGroup];
    float vc[kGroup][kPx];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      mc[q] = m[q];
      lc[q] = last[q];
#pragma unroll
      for (int k = 0; k < kPx; ++k) vc[q][k] = v[q][k];
    }
    decode(e0 + kGroup);
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
#pragma unroll
      for (int k = 0; k < kPx; ++k)
        if (mc[q] >> (8 * k) & 1) s[k] = __fadd_rn(s[k], vc[q][k]);
      if (lc[q]) {
#pragma unroll
        for (int k = 0; k < kPx; ++k) {
          acc[k] = __fadd_rn(acc[k], s[k]);
          s[k] = 0.f;
        }
      }
    }
  }
  if (Y < H) {
#pragma unroll
    for (int k = 0; k < kPx; ++k)
      if (X + k < W) d_edge[((long long)b * H + Y) * W + X + k] = acc[k];
  }
}

}  // namespace

// g, winner [B, n_pairs, H - rf, W - 2 rf] -> d_edge [B, H, W]; tab int32
// [n_words] on the device (the probe's tables for this tile), smem the
// bytes of all windows, group the entries whose loads go out together (4
// or 8).
IRN_API int irn_path_max_bwd_staged(const float* g, const int8_t* winner,
                                    float* d_edge, const int* tab, int B,
                                    int H, int W, int rf, int n_pairs,
                                    int n_entries, int n_words, int tx_tile,
                                    int ty_tile, int max_rows, int smem,
                                    int group, cudaStream_t stream,
                                    int* launched) {
  if (B < 1 || H - rf < 1 || W - 2 * rf < 1 || n_words > kMaxWords ||
      tx_tile % kPx || tx_tile / kPx * ty_tile > 256 || smem > kSmemMax ||
      (group != 4 && group != 8) ||
      (long long)n_pairs * (H - rf) * (W - 2 * rf) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  auto kernel = group == 4 ? staged_bwd_kernel<4> : staged_bwd_kernel<8>;
  cudaError_t e = cudaMemcpyToSymbolAsync(c_tab, tab, 4 * n_words, 0,
                                          cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((W + tx_tile - 1) / tx_tile, (H + ty_tile - 1) / ty_tile,
                  B);
  kernel<<<grid, dim3(tx_tile / kPx, ty_tile), smem, stream>>>(
      g, winner, d_edge, H, W, rf, n_pairs, n_entries, tx_tile, ty_tile,
      max_rows, (long long)B * n_pairs * (H - rf) * (W - 2 * rf));
  IRN_CHECK_LAUNCH(launched);
  return 0;
}

// blocks of threads x smem bytes that one SM holds at once
IRN_API int irn_path_max_bwd_staged_occupancy(int threads, int smem,
                                              int group, int* blocks) {
  auto kernel = group == 4 ? staged_bwd_kernel<4> : staged_bwd_kernel<8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      threads, smem);
  return (int)e;
}
