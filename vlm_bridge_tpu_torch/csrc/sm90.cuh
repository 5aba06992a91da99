// Hopper helpers shared by the wgmma + TMA kernels (tiled_matmul.cu,
// flash_fwd.cu, flash_bwd.cu, decode_gemm.cuh, tied_head.cu, int8_linear.cu):
// shared-memory addresses, mbarriers, TMA and bulk loads (with L2 policies) and stores
// with their bulk groups, named barriers, the wgmma shared-memory descriptor
// with its fence / commit / wait, the widening of int8 and int4 weights into
// bf16, cluster barriers and another block's shared-memory addresses, and the
// host's tensor-map encoder. Built for sm_90a only
// (wgmma and setmaxnreg exist nowhere else).
#pragma once

#include <cuda.h>   // CUtensorMap and its enums; the encoder comes through the runtime

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers and the TMA ----

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of this parity has completed. A wait that
// never ends (a parity slip) traps after ~2^26 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

// box at coordinates (c0 innermost, c1) of the map -> shared memory at dst;
// completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// tma_load under the L2 policy `pol`
__device__ __forceinline__ void tma_load_hint(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                              uint32_t bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "l"(pol)
      : "memory");
}

// `bytes` (a multiple of 16) of device memory at src -> shared memory at dst,
// both 16-byte aligned; completion counts the bytes on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 4 bytes global -> shared by cp.async (any 4-byte aligned address)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

// box of shared memory at src -> the map at coordinates (c0 innermost, c1),
// clipped to the tensor; completion tracked by the issuing thread's bulk groups
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// this thread's stores have read their shared memory (.read) or are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// shared-memory writes of this thread made visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrive at a named barrier without waiting (its other threads bar.sync)
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ float2 ld_shared_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// ---- wgmma ----

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), 128-byte swizzle (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulator across a wait
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define TM_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// 3-D box at coordinates (c0 innermost, c1, c2) of the map -> shared memory at
// dst; completion counts its bytes on `bar` (zeros beyond the tensor)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// an L2 policy under which the lines a load brings in are the first evicted:
// for data read once, so that it does not push out what is read again
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// 4-D box at coordinates (c0 innermost, ..., c3) of the map -> shared memory
// at dst; completion counts its bytes on `bar` (elements beyond the tensor in
// any dimension read as zero)
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// tma_load_4d under the L2 policy `pol`
__device__ __forceinline__ void tma_load_4d_hint(uint32_t dst, const CUtensorMap* map, int c0,
                                                 int c1, int c2, int c3, uint32_t bar,
                                                 uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar),
      "l"(pol)
      : "memory");
}

// 4-D box of shared memory at src -> the map at (c0, ..., c3), clipped to the tensor
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- thread-block clusters ----

// Every thread of every block of the cluster arrives, then waits: shared-memory
// writes before it are seen by the other blocks' reads after it. All threads of
// a block call it, each warp converged.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address, in the shared memory of the cluster's block `rank`, of what lies
// at `addr` in this block's
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: taken through the runtime's
// entry-point query, so the library needs no -lcuda
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a bf16 matrix of rows x cols (cols contiguous), moved in boxes of box_rows
// rows x 64 columns under the 128-byte swizzle; loads read zeros beyond the
// matrix, stores are clipped to it
inline bool make_map(EncodeTiled enc, CUtensorMap* map, const void* base, int rows, int cols,
                     int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 tensor of `rank` dimensions (dims innermost first, the innermost
// contiguous; strides in bytes of dimensions 1..rank-1, multiples of 16),
// moved in boxes of `box` elements under the 128-byte swizzle (box[0] = 64);
// loads read zeros beyond the tensor in every dimension, stores are clipped
inline bool make_map_nd(EncodeTiled enc, CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a byte matrix of rows x cols (cols contiguous, a multiple of 16) in boxes
// of box_rows x box_cols, unswizzled or (box_cols 128) under the 128-byte
// swizzle; loads read zeros beyond the matrix
inline bool make_byte_map(EncodeTiled enc, CUtensorMap* map, const void* base, int rows, int cols,
                          int box_rows, int box_cols, bool swizzle128) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- the flash-attention kernels' shared pieces (flash_fwd.cu, flash_bwd.cu) ----

constexpr float LOG2E = 1.4426950408889634f;

// S[64, N] = A[64, 16] . B[N, 16]^T (+ S if scale_d): A and B K-major, both read
// from shared memory through their descriptors
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24), TM_D8(32), TM_D8(40), TM_D8(48), TM_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64, 128] (+)= A[64, 16] . B[16, 128]: A K-major, B MN-major (trans-b), both
// read from shared memory through their descriptors; scale_d == 0 ignores D
// (tiled_matmul.cu, int8_linear.cu).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24),
        TM_D8(32), TM_D8(40), TM_D8(48), TM_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64, N] += A[64, 16] . B[16, N]: A from registers (four bf16x2 a thread, the
// m16n8k16 A fragment of the thread's warp), B MN-major (trans-b) in shared memory
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24), TM_D8(32), TM_D8(40), TM_D8(48), TM_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24), TM_D8(32), TM_D8(40), TM_D8(48), TM_D8(56),
        TM_D8(64), TM_D8(72), TM_D8(80), TM_D8(88), TM_D8(96), TM_D8(104), TM_D8(112),
        TM_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh within a few ulp: x - x^3 / 3 + 2 x^5 / 15 - 17 x^7 / 315 + 62 x^9 / 2835
// below |x| = 1/4 (next term < 2e-9 x), else 1 - 2 / (e^2x + 1) (one
// exponential, one division; the exponent is clamped so that the division
// never sees infinity)
__device__ __forceinline__ float tanh_acc(float x) {
  const float x2 = x * x;
  float s = fmaf(x2, 62.f / 2835.f, -17.f / 315.f);
  s = fmaf(s, x2, 2.f / 15.f);
  s = fmaf(s, x2, -1.f / 3.f);
  const float series = fmaf(s * x2, x, x);
  const float e = ex2(fminf(x * (2.f * LOG2E), 126.f));
  return fabsf(x) < 0.25f ? series : 1.f - __fdividef(2.f, e + 1.f);
}

// 16 bytes of shared memory
__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// word q (0..3) of a 16-byte value; q a compile-time constant after unrolling
__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// 4 int8 -> two bf16x2 registers b0 = (byte 0, byte 1), b1 = (byte 2, byte 3)
// without I2F or F2F: byte x becomes the low mantissa of the f32 2^23 +
// (x + 128), one full-rate add removes the offset, and since the integer x
// is a bf16 value, the f32's upper half is it (exact for every byte).
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& b0, uint32_t& b1) {
  w ^= 0x80808080u;
  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) - 8388736.f);
  b0 = __byte_perm(f[0], f[1], 0x7632);
  b1 = __byte_perm(f[2], f[3], 0x7632);
}

// 8 int4 (a word of nibbles whose sign bits are flipped, w ^ 0x88888888, so
// a nibble reads value + 8 in 0..15) -> four bf16x2 registers: lo0 / lo1 the
// low nibbles of bytes (0, 1) / (2, 3), hi0 / hi1 their high nibbles. Each
// nibble n is dropped into the mantissa of 128.0 (bf16 0x4300, whose
// mantissa step is 1), which then reads 128 + n, and one bf16x2 subtract of
// 136 leaves n - 8 (two bytes spread over a register's halves by one
// permute). Exact, no conversion issued.
__device__ __forceinline__ void widen8_nibbles(uint32_t wb, uint32_t& lo0, uint32_t& lo1,
                                               uint32_t& hi0, uint32_t& hi1) {
  const uint32_t x0 = __byte_perm(wb, 0u, 0x4140), x1 = __byte_perm(wb, 0u, 0x4342);
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  auto val = [&](uint32_t bits) {   // (bits & 0x000F000F) | 128.0 pair, less 136
    bits = (bits & 0x000F000Fu) | 0x43004300u;
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&bits), off);
    return *reinterpret_cast<const uint32_t*>(&v);
  };
  lo0 = val(x0);
  lo1 = val(x1);
  hi0 = val(x0 >> 4);
  hi1 = val(x1 >> 4);
}

// the SMs of the current device (one persistent block each)
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

// Make the device that holds `p` current on the calling thread, with its
// primary context: cuTensorMapEncodeTiled is a driver call and fails on a
// thread where no context is current yet (PyTorch's autograd thread, when a
// backward kernel is the first CUDA work it does).
inline int bind_device(const void* p) {
  cudaPointerAttributes a;
  VBT_CHECK(cudaPointerGetAttributes(&a, p));
  VBT_CHECK(cudaSetDevice(a.device));
  return 0;
}

// a [B, L, NH, D] bf16 tensor with element strides (batch, row, head), D
// contiguous, as a 4-D map (D, NH, L, B) in boxes of 64 x 1 x box_rows x 1
inline bool bhsd_map(EncodeTiled enc, CUtensorMap* map, const void* base, int B, int L,
                     int NH, int D, long long sb, long long sr, long long sh,
                     int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)NH, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sr * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  return make_map_nd(enc, map, base, 4, dims, strides, box);
}

}  // namespace
