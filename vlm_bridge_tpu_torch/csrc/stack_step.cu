// One greedy decode step through every Gemma-2 decoder layer (int8 weights,
// or int8 attention weights with int4 MLP weights; int8 KV cache).
//
// Replaces: vlm_bridge_tpu/ops/decode_kernels.py:fused_stack_step, whose
// body is _stack_kernel. Per layer: RMSNorm(1+w) -> int8 fused q|k|v
// projection -> RoPE -> per-vector int8 quantization of the new K/V, written
// into cache row t -> GQA attention with logit softcap over rows <= t (the
// new row attends through its quantize->dequantize value, k scales folded
// into the logits and v scales into the probabilities) -> int8 o-proj ->
// post-attention RMSNorm + residual -> pre-FFN RMSNorm -> int8 gate|up ->
// gelu_tanh(gate) * up -> int8 down -> post-FFN RMSNorm + residual. With
// mlp4 != 0 the gate|up and down products read nibble-packed int4 weights
// (the TPU kernel's `mlp4=True` stage) through i4_gemm.cu, with one scale
// per output column (mlp4_group == 0) or per group of mlp4_group rows; the
// hidden stays f32 (split hi + lo) between the two products, as with int8.
//
// Bound: weight bandwidth. A token streams 26 x 78 MB of int8 layer weights
// at the Gemma-2-2B widths (2.0 GB), against 0.3 MB of activations and a
// 26 x 8 MB int8 cache read. The design keeps the activations between the
// projections in small scratch (L2-resident at batch 64; split into bf16
// hi + lo where they feed a GEMM, common.cuh), runs
// every projection through the split-K int8 GEMM of i8_gemm.cu, and loops
// over the layers here on the host: one call from Python per token, with
// no host synchronisation, so the launches queue back to back. The residual
// stream stays f32 across all layers, as in the TPU kernel.
//
// Cache layout (this port's own): K/V [L, B, KH, S, D] int8, so one block
// reads one contiguous [S, D] slab per (row, kv head); scales [L, B, KH, S].
//
// The per-layer steps (layer_step.cu: fused_attn_step, fused_mlp_step) compute
// the same layer in two calls. The two files share the helpers of common.cuh
// (the block reductions, dot4_i8, kv_scale / kv_code for the per-vector int8
// of a new K/V row, soft_cap), not their kernels, because they round at
// other places: here every value between two stages stays f32, stored as
// bf16 hi + lo halves for the split-K GEMM of i8_gemm.cu over weights in
// fragment order, the residual is f32 across all layers, and the attention
// kernel writes cache row t itself; there the normed input, q, p * v_scale,
// the attention output and the MLP hidden are rounded to one bf16 value each,
// as the TPU's per-layer kernels round them, the products run through the
// row-major int8 product kernel of int8_linear.cu, the residual is rounded to
// bf16 at the end of each half, and the cache is only read.

#include "common.cuh"

namespace {

// x (f32 residual) update and next RMSNorm, one block of 256 threads per
// batch row, the row held in registers (H <= 256 * ROW_REGS):
//   x_in != null : x = float(x_in)
//   y    != null : x += rms(y) * (1 + w_post)
//   h    != null : h = rms(x) * (1 + w_next), split [2, B, H]
//   xo   != null : xo = bf16(x)
__global__ void __launch_bounds__(256)
residual_rms_kernel(const bf16* __restrict__ x_in, float* __restrict__ x,
                    const float* __restrict__ y, const float* __restrict__ w_post,
                    const float* __restrict__ w_next, bf16* __restrict__ h,
                    bf16* __restrict__ xo, int H, float eps) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  float v[ROW_REGS];
#pragma unroll
  for (int k = 0; k < ROW_REGS; ++k) {
    const int i = threadIdx.x + k * 256;
    v[k] = i >= H ? 0.f : (x_in != nullptr ? __bfloat162float(x_in[row + i]) : x[row + i]);
  }
  if (y != nullptr) {
    float yv[ROW_REGS], ss = 0.f;
#pragma unroll
    for (int k = 0; k < ROW_REGS; ++k) {
      const int i = threadIdx.x + k * 256;
      yv[k] = i < H ? y[row + i] : 0.f;
      ss += yv[k] * yv[k];
    }
    const float r = rsqrtf(block_sum(ss, red) / H + eps);
#pragma unroll
    for (int k = 0; k < ROW_REGS; ++k) {
      const int i = threadIdx.x + k * 256;
      if (i < H) v[k] += yv[k] * r * (1.f + w_post[i]);
    }
  }
#pragma unroll
  for (int k = 0; k < ROW_REGS; ++k) {
    const int i = threadIdx.x + k * 256;
    if (i < H) {
      x[row + i] = v[k];
      if (xo != nullptr) xo[row + i] = __float2bfloat16(v[k]);
    }
  }
  if (h != nullptr) {
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < ROW_REGS; ++k) ss += v[k] * v[k];
    const float r = rsqrtf(block_sum(ss, red) / H + eps);
#pragma unroll
    for (int k = 0; k < ROW_REGS; ++k) {
      const int i = threadIdx.x + k * 256;
      if (i < H) store_split(h, (size_t)gridDim.x * H, row + i, v[k] * r * (1.f + w_next[i]));
    }
  }
}

// One block per (kv head, batch row); blockDim.x == D. qkv: [B, QHD+2KHD]
// f32 (scaled projection). Writes the new int8 K/V row t and its scales,
// then attends over cache rows 0..t; out: split [2, B, QHD].
__global__ void stack_attn_kernel(const float* __restrict__ qkv, const float* __restrict__ cosv,
                                  const float* __restrict__ sinv, int8_t* __restrict__ kc,
                                  int8_t* __restrict__ vc, float* __restrict__ ks,
                                  float* __restrict__ vs, bf16* __restrict__ out, int NH, int KH,
                                  int D, int S, int t, float attn_scale, float softcap) {
  extern __shared__ float sm[];
  const int G = NH / KH;
  float* q = sm;                 // [G][D]
  float* lg = sm + G * D;        // [G][t+1]
  __shared__ float red[32];
  const int kh = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int QHD = NH * D, KHD = KH * D, half = D / 2;
  const float* row = qkv + (size_t)b * (QHD + 2 * KHD);
  const float c = cosv[d], s = sinv[d];
  const int dp = d < half ? d + half : d - half;
  const float sign = d < half ? -1.f : 1.f;

  const float* kr = row + QHD + kh * D;
  const float knew = kr[d] * c + sign * kr[dp] * s;
  const float vnew = row[QHD + KHD + kh * D + d];
  const float kamax = block_max(fabsf(knew), red);
  const float vamax = block_max(fabsf(vnew), red);
  const float ksc = kv_scale(kamax), vsc = kv_scale(vamax);
  const size_t slab = ((size_t)b * KH + kh) * S;  // row index of (b, kh, 0)
  kc[(slab + t) * D + d] = kv_code(knew, ksc);
  vc[(slab + t) * D + d] = kv_code(vnew, vsc);
  if (d == 0) {
    ks[slab + t] = ksc;
    vs[slab + t] = vsc;
  }
  for (int g = 0; g < G; ++g) {
    const float* qr = row + (kh * G + g) * D;
    q[g * D + d] = qr[d] * c + sign * qr[dp] * s;
  }
  __syncthreads();  // cache row t and q visible to the whole block

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int n = t + 1;
  for (int p = warp; p < G * n; p += nw) {
    const int g = p / n, j = p % n;
    const uint32_t* kj = reinterpret_cast<const uint32_t*>(kc + (slab + j) * D);
    float acc = 0.f;
    for (int e = lane; e < D / 4; e += 32) acc += dot4_i8(&q[g * D + 4 * e], kj[e]);
    acc = warp_sum(acc);
    if (lane == 0) {
      lg[g * n + j] = soft_cap(acc * ks[slab + j] * attn_scale, softcap);
    }
  }
  __syncthreads();
  if (warp < G) {  // softmax of head g by warp g
    float* l = lg + warp * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, l[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(l[j] - m);
      l[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) l[j] = l[j] / sum * vs[slab + j];
  }
  __syncthreads();
  for (int g = 0; g < G; ++g) {
    float acc = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) acc += lg[g * n + j] * (float)vc[(slab + j) * D + d];
    store_split(out, (size_t)gridDim.y * QHD, (size_t)b * QHD + (kh * G + g) * D + d, acc);
  }
}

// a[b, f] = gelu_tanh(gu[b, f]) * gu[b, F + f], split [2, B, F]
__global__ void geglu_kernel(const float* __restrict__ gu, bf16* __restrict__ a, int B, int F) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * F) return;
  const size_t b = i / F, f = i % F;
  const float g = gu[b * 2 * F + f], u = gu[b * 2 * F + F + f];
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float gl = 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
  store_split(a, (size_t)B * F, i, gl * u);
}

}  // namespace

extern "C" int vbt_fused_stack_step(
    const void* x_in, void* x_out,
    const void* wqkv, const void* qkv_scale, const void* wo, const void* o_scale,
    const void* wgu, const void* gu_scale, const void* wd, const void* d_scale,
    const void* norms, const void* cosv, const void* sinv,
    void* kc, void* vc, void* ks, void* vs,
    void* x32, void* hbuf, void* abuf, void* ybuf,
    int L, int B, int H, int NH, int KH, int D, int F, int S, int t, int mlp4, int mlp4_group,
    float attn_scale, float softcap, float eps, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int QHD = NH * D, KHD = KH * D, NQKV = QHD + 2 * KHD;
  float* x = (float*)x32;
  bf16* h = (bf16*)hbuf;
  bf16* a = (bf16*)abuf;
  float* y = (float*)ybuf;
  const float* nrm = (const float*)norms;
  const size_t cache_layer = (size_t)B * KH * S * D, scale_layer = (size_t)B * KH * S;
  const int G = NH / KH;
  const size_t attn_smem = sizeof(float) * (size_t)G * (D + t + 1);
  // int4 MLP: rows of K that share a scale row, and scale rows per layer
  const int gu_group = mlp4_group ? mlp4_group : H, d_group = mlp4_group ? mlp4_group : F;

  residual_rms_kernel<<<B, 256, 0, st>>>((const bf16*)x_in, x, nullptr, nullptr, nrm, h,
                                         nullptr, H, eps);
  VBT_CHECK_LAUNCH();
  for (int l = 0; l < L; ++l) {
    const float* nl = nrm + (size_t)l * 4 * H;
    int rc = launch_i8_gemm(h, H, (const int8_t*)wqkv + (size_t)l * H * NQKV,
                            (const float*)qkv_scale + (size_t)l * NQKV, nullptr, y, B, NQKV,
                            H, st);
    if (rc) return rc;
    stack_attn_kernel<<<dim3(KH, B), D, attn_smem, st>>>(
        y, (const float*)cosv, (const float*)sinv, (int8_t*)kc + l * cache_layer,
        (int8_t*)vc + l * cache_layer, (float*)ks + l * scale_layer,
        (float*)vs + l * scale_layer, a, NH, KH, D, S, t, attn_scale, softcap);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(a, QHD, (const int8_t*)wo + (size_t)l * QHD * H,
                        (const float*)o_scale + (size_t)l * H, nullptr, y, B, H, QHD, st);
    if (rc) return rc;
    residual_rms_kernel<<<B, 256, 0, st>>>(nullptr, x, y, nl + H, nl + 2 * H, h, nullptr, H,
                                           eps);
    VBT_CHECK_LAUNCH();
    if (mlp4)
      rc = launch_i4_gemm(h, H, (const uint8_t*)wgu + (size_t)l * H * F,
                          (const float*)gu_scale + (size_t)l * (H / gu_group) * 2 * F, gu_group,
                          y, B, 2 * F, H, st);
    else
      rc = launch_i8_gemm(h, H, (const int8_t*)wgu + (size_t)l * H * 2 * F,
                          (const float*)gu_scale + (size_t)l * 2 * F, nullptr, y, B, 2 * F, H,
                          st);
    if (rc) return rc;
    const size_t n = (size_t)B * F;
    geglu_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(y, a, B, F);
    VBT_CHECK_LAUNCH();
    if (mlp4)
      rc = launch_i4_gemm(a, F, (const uint8_t*)wd + (size_t)l * (F / 2) * H,
                          (const float*)d_scale + (size_t)l * (F / d_group) * H, d_group, y, B,
                          H, F, st);
    else
      rc = launch_i8_gemm(a, F, (const int8_t*)wd + (size_t)l * F * H,
                          (const float*)d_scale + (size_t)l * H, nullptr, y, B, H, F, st);
    if (rc) return rc;
    const bool last = (l == L - 1);
    residual_rms_kernel<<<B, 256, 0, st>>>(nullptr, x, y, nl + 3 * H,
                                           last ? nullptr : nl + 4 * H, last ? nullptr : h,
                                           last ? (bf16*)x_out : nullptr, H, eps);
    VBT_CHECK_LAUNCH();
  }
  return 0;
}
