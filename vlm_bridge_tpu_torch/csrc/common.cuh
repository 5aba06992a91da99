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

// Row kernels (residual + norm) keep one row in registers, 256 threads a row
// and R values a thread: R = 16 up to 4096 values, 32 up to 8192, 64 up to
// ROW_MAX. A launch picks R by the row's width (row_regs).
constexpr int ROW_MAX = 256 * 64;
inline int row_regs(int H) { return H <= 256 * 16 ? 16 : H <= 256 * 32 ? 32 : 64; }

// kernel<R><<<grid, 256, smem, stream>>>(args...) with R = row_regs(H)
#define VBT_ROW_LAUNCH(kernel, H, grid, smem, stream, ...)                     \
  do {                                                                          \
    const int r_ = row_regs(H);                                                 \
    if (r_ == 16) kernel<16><<<(grid), 256, (smem), (stream)>>>(__VA_ARGS__);   \
    else if (r_ == 32) kernel<32><<<(grid), 256, (smem), (stream)>>>(__VA_ARGS__); \
    else kernel<64><<<(grid), 256, (smem), (stream)>>>(__VA_ARGS__);            \
  } while (0)

// Activations that feed an int8 GEMM are stored split: a = hi + lo with
// hi = bf16(a) and lo = bf16(a - hi), so the bf16 tensor cores see about 16
// bits of each f32 value. A split buffer of R rows x C columns holds the hi
// rows, then the lo rows (lo = hi + R * C).
__device__ __forceinline__ void store_split(bf16* hi, size_t lo_off, size_t i, float v) {
  const bf16 h = __float2bfloat16(v);
  hi[i] = h;
  hi[lo_off + i] = __float2bfloat16(v - __bfloat162float(h));
}

// ---- cp.async ----

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
