// The second pass of the split linear layers (int8_linear.cu,
// int4_linear.cu): adds the product kernel's K slices in a fixed order,
// applies scale, bias and activation, and rounds to bf16.
#pragma once

#include "common.cuh"

namespace {

enum { EPI_SCALE = 0, EPI_GEGLU = 1, EPI_GELU_ERF = 2 };

__device__ __forceinline__ float gelu_tanh_f(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_erf_f(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// out[M, N] bf16 from a product kernel's slices, four columns a thread. A null
// scale stands for 1 (the product kernel applied its scales itself).
//   EPI_SCALE     sum * s0 (+ bias)
//   EPI_GEGLU     gelu_tanh(sum0 * s0) * (sum1 * s1)     (two sources)
//   EPI_GELU_ERF  gelu_erf(sum * s0 + bias)
template <int EPI>
__global__ void i8l_epilogue_kernel(const float* __restrict__ P, int splits, int M, int N,
                                    const float* __restrict__ s0, const float* __restrict__ s1,
                                    const float* __restrict__ bias, bf16* __restrict__ out) {
  constexpr int NSRC = EPI == EPI_GEGLU ? 2 : 1;
  const size_t quads = (size_t)M * N / 4;
  const size_t q = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= quads) return;
  const int col = (int)((q * 4) % N);
  const float4* P4 = reinterpret_cast<const float4*>(P);
  float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
  for (int sp = 0; sp < splits; ++sp) {   // fixed order: the same bits every run
    const float4 v = P4[(size_t)(sp * NSRC) * quads + q];
    a[0] += v.x; a[1] += v.y; a[2] += v.z; a[3] += v.w;
    if (NSRC == 2) {
      const float4 u = P4[(size_t)(sp * NSRC + 1) * quads + q];
      b[0] += u.x; b[1] += u.y; b[2] += u.z; b[3] += u.w;
    }
  }
  float r[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = col + e;
    const float sc0 = s0 != nullptr ? s0[n] : 1.f;
    if (EPI == EPI_SCALE) {
      r[e] = a[e] * sc0 + (bias != nullptr ? bias[n] : 0.f);
    } else if (EPI == EPI_GEGLU) {
      r[e] = gelu_tanh_f(a[e] * sc0) * (b[e] * (s1 != nullptr ? s1[n] : 1.f));
    } else {
      r[e] = gelu_erf_f(a[e] * sc0 + bias[n]);
    }
  }
  __nv_bfloat162 lo = __floats2bfloat162_rn(r[0], r[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(r[2], r[3]);
  uint2 packed;
  packed.x = *reinterpret_cast<uint32_t*>(&lo);
  packed.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(out + q * 4) = packed;
}

template <int EPI>
int launch_epilogue(const float* P, int splits, int M, int N, const float* s0, const float* s1,
                    const float* bias, bf16* out, cudaStream_t st) {
  const size_t quads = (size_t)M * N / 4;
  i8l_epilogue_kernel<EPI><<<(unsigned)((quads + 255) / 256), 256, 0, st>>>(P, splits, M, N, s0,
                                                                           s1, bias, out);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace
