// LayerNorm over the rows of a [N, H] array, exact two-pass statistics in f32:
//   y = (x - mean) * rsqrt(mean((x - mean)^2) + eps) * scale + bias
//
// Replaces: vlm_bridge_tpu/ops/norm_kernels.py:_ln_forward (body _ln_kernel),
// the forward of layer_norm_fast: the ViT's 49 norms and, in training, the
// bridge's. Its backward is plain tensor code on both sides.
//
// Bound: bytes. Every element is read once and written once (67.4 MB for the
// ViT's 16448 x 1024 bf16 rows) and meets a dozen operations on the way: the
// least time is those bytes over the card's 3.35 TB/s.
//
// Design. One warp a row, four rows a block. The row stays in registers
// between the two passes (a lane holds 8 adjacent values of every 256, loaded
// as one or two 16-byte pieces), so device memory sees each value once; mean
// and variance are warp shuffles, no shared memory and no block barrier.
// Rows wider than 256 * LN_CHUNKS (Gemma-2-27B's bridge: 4608) take
// layer_norm_wide_kernel, the same arithmetic in the same order over a row
// read three times (the L1 holds it). H must be a multiple of 8.

#include "common.cuh"

namespace {

constexpr int LN_CHUNKS = 16;      // 8 values a lane a chunk: rows up to 4096 wide
constexpr int LN_WARPS = 4;        // rows a block

__device__ __forceinline__ void load8(const bf16* p, float (&v)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T>
__global__ void __launch_bounds__(32 * LN_WARPS)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y, int rows, int H, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;   // whole warps leave: the shuffles below stay full
  const T* xr = x + (size_t)row * H;
  T* yr = y + (size_t)row * H;

  float v[LN_CHUNKS][8];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int i = c * 256 + lane * 8;
    if (i < H) {
      load8(xr + i, v[c]);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += v[c][e];
    }
  }
  const float mean = warp_sum(sum) / H;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    if (c * 256 + lane * 8 < H) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[c][e] -= mean;
        sq += v[c][e] * v[c][e];
      }
    }
  }
  const float r = rsqrtf(warp_sum(sq) / H + eps);
#pragma unroll
  for (int c = 0; c < LN_CHUNKS; ++c) {
    const int i = c * 256 + lane * 8;
    if (i < H) {
      float s[8], b[8], o[8];
      load8(scale + i, s);
      load8(bias + i, b);
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = v[c][e] * r * s[e] + b[e];
      store8(yr + i, o);
    }
  }
}

// Rows of any width: the warp walks the row in 256-value chunks in each pass
// (the mean, the squared deviations, the output), reading it again each time.
template <typename T>
__global__ void __launch_bounds__(32 * LN_WARPS)
layer_norm_wide_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y, int rows, int H,
                       float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * H;
  T* yr = y + (size_t)row * H;
  float v[8], sum = 0.f;
  for (int i = lane * 8; i < H; i += 256) {
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
  }
  const float mean = warp_sum(sum) / H;
  float sq = 0.f;
  for (int i = lane * 8; i < H; i += 256) {
    load8(xr + i, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      v[e] -= mean;
      sq += v[e] * v[e];
    }
  }
  const float r = rsqrtf(warp_sum(sq) / H + eps);
  for (int i = lane * 8; i < H; i += 256) {
    float s8[8], b8[8], o[8];
    load8(xr + i, v);
    load8(scale + i, s8);
    load8(bias + i, b8);
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = (v[e] - mean) * r * s8[e] + b8[e];
    store8(yr + i, o);
  }
}

template <typename T>
int launch(const T* x, const float* scale, const float* bias, T* y, int rows, int H, float eps,
           cudaStream_t st) {
  const int blocks = (rows + LN_WARPS - 1) / LN_WARPS;
  if (H <= 256 * LN_CHUNKS)
    layer_norm_kernel<T><<<blocks, 32 * LN_WARPS, 0, st>>>(x, scale, bias, y, rows, H, eps);
  else
    layer_norm_wide_kernel<T><<<blocks, 32 * LN_WARPS, 0, st>>>(x, scale, bias, y, rows, H, eps);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// y[rows, H] = LayerNorm(x[rows, H]) in x's type (bf16, or f32 when is_f32);
// scale, bias: f32 [H]. H % 8 == 0.
extern "C" int vbt_layer_norm(const void* x, const void* scale, const void* bias, void* y,
                              int rows, int H, int is_f32, float eps, void* stream_ptr) {
  if (rows < 1 || H < 8 || H % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (is_f32)
    return launch<float>((const float*)x, (const float*)scale, (const float*)bias, (float*)y,
                         rows, H, eps, st);
  return launch<bf16>((const bf16*)x, (const float*)scale, (const float*)bias, (bf16*)y, rows, H,
                      eps, st);
}
