// One Gemma-2 decoder layer at decode, as two calls (int8 weights as
// quantize_int8 gives them, row-major [in, out]; int8 KV cache):
//   fused_attn_step  x + rms_post(o(attention(rope(qkv(bf16(rms_in(x)))))))
//   fused_mlp_step   x + rms_post(down(bf16(gelu_tanh(gate(h)) * up(h)))),
//                    h = bf16(rms_pre(x))
//
// Replaces: vlm_bridge_tpu/ops/decode_kernels.py:fused_attn_step (body
// _attn_kernel) and vlm_bridge_tpu/ops/decode_kernels.py:fused_mlp_step (body
// _mlp_kernel). The TPU kernels hold a layer's weights and both caches in
// VMEM inside one program (the MLP walks F on a sequential grid and carries
// its accumulator); here each call is a short chain of kernels on one
// stream with no host synchronisation, the activations between them (at most
// 1.2 MB at batch 64) staying in the L2.
//
// Bound: bytes. At batch 64 a weight byte feeds 64 multiply-adds, far below
// the ~295 operations per byte where the tensor cores become the limit: the
// least time is the layer's int8 weights over 3.35 TB/s (14.2 MB for q|k|v
// and o, 63.7 MB for the MLP) plus the live cache rows.
//
// Design. The four products are the int8 product kernel of int8_linear.cu
// (launch_i8mm: bf16 x, weights as they are, TMA + wgmma, the contraction
// split over the blocks of one cluster and added in rank order): q|k|v, o and
// down leave their raw f32 sums, and gate|up the MLP's bf16 hidden through
// its GeGLU epilogue. What is new sits between them:
//   ls_rms_kernel       the pre-norm, rounded to bf16 as the TPU kernel does;
//   ls_attn_kernel      one block per (kv head, batch row): applies the
//                       q|k|v scales and RoPE,
//                       quantizes the new K and V per vector and hands them
//                       back (the cache is read, never written: the caller
//                       writes row t), then attends over rows s < t and the
//                       new row, which enters through its quantized value.
//                       Rows at and beyond t are skipped, not masked, so
//                       whatever they hold is never read; at t = 0 only the
//                       self term is left. q and p * v_scale are rounded to
//                       bf16 before their products and the output to bf16,
//                       where the TPU kernel casts;
//   ls_residual_kernel  applies the o / down scales, the post-norm and the
//                       residual, and rounds once to bf16.
// The row kernels hold a row in registers, R values a thread (common.cuh:
// row_regs; rows up to ROW_MAX wide).
// No atomics anywhere: the same inputs give the same bits. The stack step
// (stack_step.cu) computes the same layer with f32 (hi + lo) activations
// between its stages and an f32 residual across layers; here the residual
// stream is bf16 between calls, as in the TPU kernels.
//
// Cache layout (this port's own): K/V [B, KH, S, D] int8 a layer, scales
// [B, KH, S] f32, so a block reads one contiguous [t, D] slab.

#include "common.cuh"
#include "linear_common.cuh"

namespace {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// h[row] = bf16(rms(x[row]) * (1 + w)); one block of 256 threads a row. The
// norm weights are bf16, as the model holds them on the card.
template <int R>
__global__ void __launch_bounds__(256)
ls_rms_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              bf16* __restrict__ h, int H, float eps) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  float v[R], ss = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    v[k] = i < H ? __bfloat162float(x[row + i]) : 0.f;
    ss += v[k] * v[k];
  }
  const float r = rsqrtf(block_sum(ss, red) / H + eps);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    if (i < H) h[row + i] = __float2bfloat16(v[k] * r * (1.f + __bfloat162float(w[i])));
  }
}

// x_out[row] = bf16(x[row] + rms(y) * (1 + w)), y = part[row] * scale.
template <int R>
__global__ void __launch_bounds__(256)
ls_residual_kernel(const bf16* __restrict__ x, const float* __restrict__ part,
                   const float* __restrict__ scale, const bf16* __restrict__ w,
                   bf16* __restrict__ x_out, int H, float eps) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  float y[R], ss = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    y[k] = i < H ? part[row + i] * scale[i] : 0.f;
    ss += y[k] * y[k];
  }
  const float r = rsqrtf(block_sum(ss, red) / H + eps);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    if (i < H)
      x_out[row + i] = __float2bfloat16(__bfloat162float(x[row + i]) +
                                        y[k] * r * (1.f + __bfloat162float(w[i])));
  }
}

// One block per (kv head, batch row); blockDim.x == D. part: the q|k|v
// product's f32 sums [B][NQKV]. Shared memory: (2 G + 1) D + G t floats.
__global__ void ls_attn_kernel(const float* __restrict__ part,
                               const float* __restrict__ qkv_scale,
                               const float* __restrict__ cosv, const float* __restrict__ sinv,
                               const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                               const float* __restrict__ ks, const float* __restrict__ vs,
                               bf16* __restrict__ attn, int8_t* __restrict__ k_new,
                               int8_t* __restrict__ v_new, float* __restrict__ k_sc,
                               float* __restrict__ v_sc, int NH, int KH, int D, int S, int t,
                               float attn_scale, float softcap) {
  extern __shared__ float sm[];
  const int G = NH / KH;
  float* raw = sm;                  // [G + 1][D]: the q heads, then k, before RoPE
  float* qb = raw + (G + 1) * D;    // [G][D]: q after RoPE, rounded to bf16
  float* lg = qb + G * D;           // [G][t]
  __shared__ float red[32];
  __shared__ float self_l[32], self_w[32];   // per q head: self logit, self probability
  const int kh = blockIdx.x, b = blockIdx.y, B = gridDim.y, d = threadIdx.x;
  const int QHD = NH * D, KHD = KH * D, NQKV = QHD + 2 * KHD, half = D / 2;

  auto column = [&](int col) { return part[(size_t)b * NQKV + col] * qkv_scale[col]; };
  for (int g = 0; g < G; ++g) raw[g * D + d] = column((kh * G + g) * D + d);
  raw[G * D + d] = column(QHD + kh * D + d);
  const float vnew = column(QHD + KHD + kh * D + d);
  __syncthreads();

  const float c = cosv[d], s = sinv[d];
  const int dp = d < half ? d + half : d - half;
  const float sign = d < half ? -1.f : 1.f;
  const float knew = raw[G * D + d] * c + sign * raw[G * D + dp] * s;
  const float ksc = kv_scale(block_max(fabsf(knew), red));
  const float vsc = kv_scale(block_max(fabsf(vnew), red));
  const int8_t kcode = kv_code(knew, ksc), vcode = kv_code(vnew, vsc);
  k_new[(size_t)b * KHD + kh * D + d] = kcode;
  v_new[(size_t)b * KHD + kh * D + d] = vcode;
  if (d == 0) {
    k_sc[kh * B + b] = ksc;
    v_sc[kh * B + b] = vsc;
  }
  // the new row attends through its quantized value, as a cache row would
  const float k_q = (float)kcode * ksc, v_q = (float)vcode * vsc;
  for (int g = 0; g < G; ++g) {
    const float q = raw[g * D + d] * c + sign * raw[g * D + dp] * s;
    qb[g * D + d] = round_bf16(q);
    const float l = block_sum(q * k_q, red) * attn_scale;   // the self logit keeps q in f32
    if (d == 0) self_l[g] = soft_cap(l, softcap);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const size_t slab = ((size_t)b * KH + kh) * S;   // row index of (b, kh, 0)
  for (int p = warp; p < G * t; p += nw) {
    const int g = p / t, j = p % t;
    const uint32_t* kj = reinterpret_cast<const uint32_t*>(kc + (slab + j) * D);
    float acc = 0.f;
    for (int e = lane; e < D / 4; e += 32) acc += dot4_i8(&qb[g * D + 4 * e], kj[e]);
    acc = warp_sum(acc);
    if (lane == 0) lg[g * t + j] = soft_cap(acc * ks[slab + j] * attn_scale, softcap);
  }
  __syncthreads();
  if (warp < G) {   // softmax of head g by warp g, over the t history rows and the new row
    float* l = lg + warp * t;
    float m = self_l[warp];
    for (int j = lane; j < t; j += 32) m = fmaxf(m, l[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(l[j] - m);
      l[j] = e;
      sum += e;
    }
    const float e_self = expf(self_l[warp] - m);
    const float denom = warp_sum(sum) + e_self;
    for (int j = lane; j < t; j += 32) l[j] = round_bf16(l[j] / denom * vs[slab + j]);
    if (lane == 0) self_w[warp] = e_self / denom;
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < t; ++j) acc += lg[g * t + j] * (float)vc[(slab + j) * D + d];
    acc += self_w[g] * v_q;
    attn[(size_t)b * QHD + (kh * G + g) * D + d] = __float2bfloat16(acc);
  }
}

}  // namespace

// The attention half of one layer at position t. x, x_out, h: bf16 [B, H];
// wqkv: int8 [H, (NH + 2 KH) D]; wo: int8 [NH D, H]; scales f32; norms bf16 [H];
// cos, sin: f32 [D]; kc, vc: int8 [B, KH, S, D] and ks, vs: f32 [B, KH, S],
// read at rows s < t only; attn: bf16 [B, NH D]; k_new, v_new: int8
// [B, KH D]; k_sc, v_sc: f32 [KH, B]; part: f32 scratch of
// B * max((NH + 2 KH) D, H); splits_qkv / splits_o: the products' slices.
extern "C" int vbt_fused_attn_step(
    const void* x, const void* wqkv, const void* qkv_scale, const void* wo, const void* o_scale,
    const void* in_norm, const void* post_norm, const void* cosv, const void* sinv,
    const void* kc, const void* vc, const void* ks, const void* vs,
    void* x_out, void* k_new, void* v_new, void* k_sc, void* v_sc,
    void* h, void* attn, void* part,
    int B, int H, int NH, int KH, int D, int S, int t, int splits_qkv, int splits_o,
    float attn_scale, float softcap, float eps, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int G = NH / KH, QHD = NH * D, NQKV = QHD + 2 * KH * D;
  const size_t attn_smem = sizeof(float) * ((size_t)(2 * G + 1) * D + (size_t)G * t);
  if (t < 0 || t >= S || D % 32 != 0 || D > 1024 || G * KH != NH || G > D / 32 ||
      H > ROW_MAX || attn_smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  VBT_ROW_LAUNCH(ls_rms_kernel, H, B, 0, st, (const bf16*)x, (const bf16*)in_norm, (bf16*)h, H,
                 eps);
  VBT_CHECK_LAUNCH();
  int rc = launch_i8mm((const bf16*)h, (const int8_t*)wqkv, nullptr, B, NQKV, H, I8_RAW, nullptr,
                       nullptr, nullptr, part, splits_qkv, st);
  if (rc != 0) return rc;
  ls_attn_kernel<<<dim3(KH, B), D, attn_smem, st>>>(
      (const float*)part, (const float*)qkv_scale, (const float*)cosv,
      (const float*)sinv, (const int8_t*)kc, (const int8_t*)vc, (const float*)ks,
      (const float*)vs, (bf16*)attn, (int8_t*)k_new, (int8_t*)v_new, (float*)k_sc, (float*)v_sc,
      NH, KH, D, S, t, attn_scale, softcap);
  VBT_CHECK_LAUNCH();
  rc = launch_i8mm((const bf16*)attn, (const int8_t*)wo, nullptr, B, H, QHD, I8_RAW, nullptr,
                   nullptr, nullptr, part, splits_o, st);
  if (rc != 0) return rc;
  VBT_ROW_LAUNCH(ls_residual_kernel, H, B, 0, st, (const bf16*)x, (const float*)part,
                 (const float*)o_scale, (const bf16*)post_norm, (bf16*)x_out, H, eps);
  VBT_CHECK_LAUNCH();
  return 0;
}

// The MLP half of one layer. x, x_out, h: bf16 [B, H]; gate, up: int8 [H, F];
// down: int8 [F, H]; scales f32; norms bf16 [H]; hidden: bf16 [B, F];
// part: f32 scratch of B * H; splits1 / splits2: the products' slices.
extern "C" int vbt_fused_mlp_step(
    const void* x, const void* gate, const void* up, const void* gs, const void* us,
    const void* down, const void* ds, const void* pre_norm, const void* post_norm,
    void* x_out, void* h, void* hidden, void* part,
    int B, int H, int F, int splits1, int splits2, float eps,
    void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (H > ROW_MAX) return (int)cudaErrorInvalidValue;
  VBT_ROW_LAUNCH(ls_rms_kernel, H, B, 0, st, (const bf16*)x, (const bf16*)pre_norm, (bf16*)h, H,
                 eps);
  VBT_CHECK_LAUNCH();
  int rc = launch_i8mm((const bf16*)h, (const int8_t*)gate, (const int8_t*)up, B, F, H, I8_GEGLU,
                       (const float*)gs, (const float*)us, nullptr, hidden, splits1, st);
  if (rc != 0) return rc;
  rc = launch_i8mm((const bf16*)hidden, (const int8_t*)down, nullptr, B, H, F, I8_RAW, nullptr,
                   nullptr, nullptr, part, splits2, st);
  if (rc != 0) return rc;
  VBT_ROW_LAUNCH(ls_residual_kernel, H, B, 0, st, (const bf16*)x, (const float*)part,
                 (const float*)ds, (const bf16*)post_norm, (bf16*)x_out, H, eps);
  VBT_CHECK_LAUNCH();
  return 0;
}
