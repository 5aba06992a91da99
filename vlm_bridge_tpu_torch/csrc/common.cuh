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

// Y[M, N] (f32, zeroed by this call) = (A[M, K] @ W[K, N] int8) * scale[N]
// (+ bias[N]); A split (hi rows at Ah, lo rows at Ah + M * lda), W row-major
// [in, out] in fragment order. Defined in i8_gemm.cu. Requires N % 128 ==
// 0, K % 128 == 0, lda % 8 == 0 and 16-byte aligned A/W.
int launch_i8_gemm(const bf16* Ah, int lda, const int8_t* W, const float* scale,
                   const float* bias, float* Y, int M, int N, int K,
                   cudaStream_t stream);
