// Hopper (sm_90a) primitives shared by the port's pipelined kernels
// (qmm_tile.cuh, prefill.cu): mbarriers, TMA tile loads through tensor maps
// built per call on the host, named barriers, wgmma shared-memory
// descriptors and the wgmma instructions themselves.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tkq {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
// TKQ_MBAR_WATCHDOG (a debugging build): a wait that lasts over ~10 s of
// clocks traps, so that a deadlocked pipeline fails instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
#ifdef TKQ_MBAR_WATCHDOG
  const long long t0 = clock64();
#endif
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
#ifdef TKQ_MBAR_WATCHDOG
    if (!done && clock64() - t0 > 20000000000LL) __trap();
#endif
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// TMA tile loads into shared memory; each completes on mbarrier `bar`, whose
// expect_tx counts the box's bytes (a box's bytes past the tensor's edge
// arrive as zeros and count too)
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
// contiguous bytes global -> shared (16-byte aligned, a multiple of 16),
// completing on `bar` like a TMA tile load
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// TMA tile store from shared memory (a box past the tensor's edge is
// clipped); completes in this thread's bulk group
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// wait until this thread's bulk stores have read their shared memory
// (READ) or completed
template <bool READ>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (READ) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// arrive on `bar` once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}
// 4 bytes global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
// generic-proxy shared-memory writes made visible to wgmma / TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma shared-memory descriptor: start address, leading byte offset
// (MN-major: between 64-element atoms along N; unused for a K-major
// operand), stride byte offset (between 8-row groups), swizzle (1: 128
// bytes, 2: 64 bytes). A K-major operand in the 128-byte swizzle steps
// along K by adding 32 bytes (16 bf16) to the start address.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
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
// Keep registers that an asynchronous wgmma reads or writes in place until
// the wait that covers it: the compiler sees them used here.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R, int C>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 sums in registers d[N / 2] (row 16 w + g +
// 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (lane % 4) + (i & 1) for warp w
// of the warpgroup, g = lane / 4). B from shared memory through descriptor
// db, K-major (TB = 0) or MN-major (TB = 1, the transposed-B bit). A from
// shared memory (ss: K-major descriptor da) or from registers (rs: the
// m16n8k16 A fragment of the warp's 16 rows, a[0..3] = rows g / g + 8 at
// columns 2 (lane % 4) and 8 + 2 (lane % 4)). scale_d = 0 overwrites d.
#define TKQ_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define TKQ_D32 TKQ_D8(0), TKQ_D8(8), TKQ_D8(16), TKQ_D8(24)
#define TKQ_D64 TKQ_D32, TKQ_D8(32), TKQ_D8(40), TKQ_D8(48), TKQ_D8(56)
#define TKQ_R32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define TKQ_R64                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "           \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "           \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

template <int N, int TB>
struct Wgmma;

template <int TB>
struct Wgmma<64, TB> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TKQ_R32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : TKQ_D32
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TKQ_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : TKQ_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <int TB>
struct Wgmma<128, TB> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TKQ_R64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : TKQ_D64
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TKQ_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : TKQ_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

#undef TKQ_D8
#undef TKQ_D32
#undef TKQ_D64
#undef TKQ_R32
#undef TKQ_R64

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (no libcuda link)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tiled map of an array of `rank` (<= 5) dimensions, innermost first:
// dims in elements, strides (of dimensions 1..rank-1) in bytes; box in
// elements. Reads past the array's edge fill zeros.
inline bool encode_map(CUtensorMap* m, CUtensorMapDataType t, int rank, const void* p,
                       const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                       CUtensorMapSwizzle sw) {
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  EncodeTiled fn = encode_tiled();
  return fn != nullptr &&
         fn(m, t, rank, const_cast<void*>(p), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, sw, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tkq
