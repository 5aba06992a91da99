// Shared helpers of the decode kernels (built with nvcc for sm_90a into one
// shared library with a plain C interface; see ops/cuda_lib.py).
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define VBT_CHECK_LAUNCH()                       \
  do {                                           \
    cudaError_t e_ = cudaGetLastError();         \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

#define VBT_CHECK(call)                          \
  do {                                           \
    cudaError_t e_ = (call);                     \
    if (e_ != cudaSuccess) return (int)e_;       \
  } while (0)

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum / max; `red` is >= 32 floats of shared memory. Every
// thread of the block must call it; all receive the result.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : 0.f;
  return warp_sum(r);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nw ? red[lane] : -INFINITY;
  return warp_max(r);
}

// q[e..e+3] . four int8 packed in w (little-endian: element e in the low byte)
__device__ __forceinline__ float dot4_i8(const float* q, uint32_t w) {
  return q[0] * (float)(int8_t)(w & 0xff) + q[1] * (float)(int8_t)((w >> 8) & 0xff) +
         q[2] * (float)(int8_t)((w >> 16) & 0xff) + q[3] * (float)(int8_t)(w >> 24);
}

// Per-vector int8 of a new K or V row (the cache's format): the scale of a
// vector from its largest magnitude, and a value's code under that scale
// (round half to even, clipped).
__device__ __forceinline__ float kv_scale(float absmax) { return fmaxf(absmax, 1e-12f) / 127.f; }

__device__ __forceinline__ int8_t kv_code(float v, float scale) {
  return (int8_t)fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
}

// Gemma-2's logit soft-cap.
__device__ __forceinline__ float soft_cap(float l, float cap) { return tanhf(l / cap) * cap; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- flash attention's mask, one definition for the forward (flash_fwd.cu)
// and the backward (flash_bwd.cu) ----

// lse of a row with empty support
constexpr float FA_NEG_INF = -2.3819763e38f;

__device__ __forceinline__ bool attends(int qpos, int kpos, int kv_len, int causal, int window) {
  bool m = kpos < kv_len;
  if (causal) m = m && (kpos <= qpos);
  if (window > 0) m = m && (kpos > qpos - window);
  return m;
}

// Tiles [lo, hi) of BN keys that a query tile starting at position q_start
// (BM rows) can attend to; lo = hi = 0 when it sees none (a window past a
// short kv_len), so that an empty range never points past a caller's loads.
__device__ __forceinline__ void key_tile_range(int q_start, int BM, int BN, int kv_len, int S,
                                               int causal, int window, int& lo, int& hi) {
  int end = min(kv_len, S);
  if (causal) end = min(end, q_start + BM);
  hi = end > 0 ? (end + BN - 1) / BN : 0;
  lo = 0;
  if (window > 0) {
    const int first = q_start - window + 1;  // smallest key the tile's first row sees
    if (first > 0) lo = first / BN;
  }
  if (hi <= lo) lo = hi = 0;
}

// Query tiles [lo, hi) of BM rows (row t at position t + q_offset, t < T)
// that attend to some key of the tile starting at k_start (BK keys): the
// dk/dv kernel's loop. lo = hi = 0 when none does (a tile at or past kv_len,
// or one a window leaves to no row), as key_tile_range.
__device__ __forceinline__ void query_tile_range(int k_start, int BK, int BM, int kv_len, int T,
                                                 int q_offset, int causal, int window, int& lo,
                                                 int& hi) {
  lo = hi = 0;
  const int k_last = min(k_start + BK, kv_len) - 1;   // last key of the tile a row can see
  if (k_last < k_start) return;
  int first = 0, last = T - 1;                         // rows that can see one of its keys
  if (causal) first = max(0, k_start - q_offset);      // kpos <= qpos
  if (window > 0) last = min(last, k_last + window - 1 - q_offset);   // kpos > qpos - window
  if (last < first) return;
  lo = first / BM;
  hi = last / BM + 1;
}

// Row kernels (residual + norm) keep one row of up to 256 * ROW_REGS values
// in registers, 256 threads a row.
constexpr int ROW_REGS = 16;

// Activations that feed an int8 GEMM are stored split: a = hi + lo with
// hi = bf16(a) and lo = bf16(a - hi), so the bf16 tensor cores see about 16
// bits of each f32 value. A split buffer of R rows x C columns holds the hi
// rows, then the lo rows (lo = hi + R * C).
__device__ __forceinline__ void store_split(bf16* hi, size_t lo_off, size_t i, float v) {
  const bf16 h = __float2bfloat16(v);
  hi[i] = h;
  hi[lo_off + i] = __float2bfloat16(v - __bfloat162float(h));
}

// ---- tensor cores: mma.sync m16n8k16, bf16 operands, f32 accumulation ----

// four 8x8 matrices of 16-bit units; lanes 8i..8i+7 give the row addresses
// of matrix i, and register i of every lane receives its piece of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- int4: two signed nibbles (-8..7) a byte ----
// `wb` is a word of packed nibbles with every nibble's sign bit flipped
// (w ^ 0x88888888), so a nibble reads as value + 8 in 0..15. The nibbles at
// bit offsets s0 and s1 become one bf16x2 register (s0 in the low half):
// the biased nibble is dropped into the mantissa of 128.0 (bf16 0x4300, whose
// mantissa step is 1), which reads 128 + value + 8, and one bf16x2 subtract of
// 136 leaves the value, exactly. No integer-to-float conversion is issued.
__device__ __forceinline__ uint32_t nib_pair(uint32_t wb, int s0, int s1) {
  uint32_t bits = ((wb >> s0) & 0xFu) | (((wb >> s1) & 0xFu) << 16) | 0x43004300u;
  const uint32_t off = 0x43084308u;  // bf16x2 {136, 136}
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&bits),
                             *reinterpret_cast<const __nv_bfloat162*>(&off));
  return *reinterpret_cast<uint32_t*>(&v);
}
