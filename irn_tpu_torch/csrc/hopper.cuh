// Hopper (sm_90a) building blocks shared by the tensor-core kernels (the
// split product of K2 square_banded, K5 square_dense and K6
// square_fused_first, K9 conv3x3), the cluster-resident K0 diag_chain and
// the cooperative K3 packed_chain: mbarriers, thread-block cluster
// barriers and distributed shared memory, a grid barrier, TMA tile loads,
// the wgmma shared-memory descriptor and two wgmma shapes with 128 output
// columns. Written as inline PTX; the tensor maps are encoded on the host
// through the driver entry point that the runtime hands out, so the
// library needs no link against libcuda.
//
// Layout convention of both kernels: every operand tile in shared memory is
// K-major with 128-byte rows (64 bf16) in TMA's 128-byte swizzle, which
// XORs the 16-byte chunk index (address bits 4-6) with the row index
// modulo 8 (address bits 7-9). Tiles start on 1024-byte boundaries, so the
// pattern is a function of the shared-memory address alone.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace irn {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One arrival that also announces ``bytes`` of TMA traffic to come.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// One try of a parity wait: true once the phase of parity ``parity`` has
// completed. kCluster: acquire at cluster scope, for a barrier on which
// other CTAs of the cluster arrive (mbar_arrive_cluster).
template <bool kCluster>
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done = 0;
  if constexpr (kCluster) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
  return done != 0;
}

// Wait until the barrier's phase differs from ``parity``. A wait that lasts
// past ~2^36 cycles (over half a minute) is a fault of the kernel: it traps,
// so the launch fails with an error instead of holding the card.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  while (!mbar_try_wait<kCluster>(addr, parity)) {
    if (!start) {
      start = clock64();
    } else if (clock64() - start > (1ll << 36)) {
      __trap();
    }
  }
}

// -- thread-block clusters ---------------------------------------------------

// Every thread of every CTA of the cluster, with release and acquire at
// cluster scope: the hardware cluster barrier. It has no bound, so it is
// used only where every CTA reaches it (a cluster's CTAs are scheduled
// together); waits on other CTAs' progress go through mbarriers.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of this CTA's shared address ``addr`` in the
// CTA of rank ``rank`` of the cluster (distributed shared memory).
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes from a shared::cluster address (16-byte aligned).
__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// One arrival, with release at cluster scope, on the mbarrier at the
// shared::cluster address ``addr`` (this CTA's or another's).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(addr)
               : "memory");
}

// -- grid barrier (cooperative launches) -------------------------------------

// Barrier number ``k`` (1, 2, ...) of every CTA of a cooperative grid on a
// global counter that is 0 at launch: each CTA adds one with release at gpu
// scope and waits, with acquire, until the counter reaches k * gridDim.x.
// The wait traps after ~2^36 cycles, so a grid whose CTAs are not all
// resident fails the launch instead of holding the card.
__device__ __forceinline__ void grid_barrier(unsigned* counter, unsigned k) {
  __syncthreads();  // this CTA's reads and writes are done
  if (threadIdx.x == 0) {
    // the release orders the CTA's writes (ordered before it by the
    // __syncthreads above) before the arrival, as CUTLASS's grid barrier
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(counter)
                 : "memory");
    const unsigned target = k * gridDim.x;
    long long start = 0;
    unsigned seen;
    for (;;) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (seen >= target) break;
      if (!start) {
        start = clock64();
      } else if (clock64() - start > (1ll << 36)) {
        __trap();
      }
    }
  }
  __syncthreads();  // every thread sees what the other CTAs wrote
}

// -- TMA tile loads (zero fill outside the tensor) ---------------------------

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Descriptor of a K-major tile with 128-byte swizzled rows at shared
// address ``addr`` (1024-byte aligned): 8-row groups 1024 bytes apart. One
// k16 step further along K is +32 bytes, i.e. +2 in the start-address field.
__device__ __forceinline__ uint64_t desc_k128(uint32_t addr) {
  uint64_t d = (addr & 0x3FFFF) >> 4;
  d |= uint64_t(1) << 16;          // leading byte offset (unused when swizzled)
  d |= uint64_t(1024 >> 4) << 32;  // stride byte offset: 8 rows of 128 B
  d |= uint64_t(1) << 62;          // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (the registers change under it until the wait).
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define IRN_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define IRN_ACC16(i) IRN_ACC4(i), IRN_ACC4(i + 4), IRN_ACC4(i + 8), IRN_ACC4(i + 12)
#define IRN_ACC64 IRN_ACC16(0), IRN_ACC16(16), IRN_ACC16(32), IRN_ACC16(48)
#define IRN_D64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], f32 accumulators, both operands
// bf16 in shared memory (K-major). scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IRN_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : IRN_ACC64
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The same with A from registers: each warp of the warpgroup holds its 16
// rows of A as the four b32 registers of an m16k16 fragment (ldmatrix.x4).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " IRN_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : IRN_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

#undef IRN_ACC4
#undef IRN_ACC16
#undef IRN_ACC64
#undef IRN_D64

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// -- host: tensor maps -------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of ``rank`` dims (innermost first; strides in bytes of
// dims 1..rank-1), box ``box``, 128-byte swizzle, zeros outside the tensor.
// Returns false if the driver refuses it.
inline bool bf16_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
}  // namespace irn
