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
// Bound: weight bandwidth, and the tensor cores close behind. A token
// streams 26 x 78 MB of int8 layer weights at the Gemma-2-2B widths (2.02 GB:
// 0.60 ms at 3.35 TB/s), against 0.3 MB of activations and a 26 x 8 MB int8
// cache read; the products' tensor work (weights x 64 rows x the activations'
// two bf16 halves) is 0.52 ms at 989 TFLOP/s, and with int4 MLP weights (1.30
// GB, 0.39 ms) the tensor cores set the floor. The design keeps the
// activations between the projections in small scratch (L2-resident at batch
// 64; split into bf16 hi + lo where they feed a GEMM, common.cuh), runs every
// projection through the swap-AB wgmma + TMA GEMM core of decode_gemm.cuh
// (i8_gemm.cu, i4_gemm.cu: one wave of stream-K blocks a product, f32 vector
// reductions into y), and loops over the layers here on the host: one call
// from Python per token, with no host synchronisation, so the launches queue
// back to back: 8 a layer, 209 a token (launching them with programmatic
// dependent launch gained nothing on an H100: PERF.md). y is zero whenever a
// product starts: the first kernel zeroes it, and each kernel that reads a
// product's output (attention, the residual norms, GeGLU) writes zeros back,
// so no memset is launched. The residual stream stays f32 across all layers,
// as in the TPU kernel.
// Measured on an H100 (PERF.md, scripts/decode_gemm_torch.py): the step at
// ~4x its byte bound, the products ~60 % of it, then the attention and the
// row kernels.
//
// Cache layout (this port's own): K/V [L, B, KH, S, D] int8, so one block
// reads one contiguous [S, D] slab per (row, kv head); scales [L, B, KH, S].
//
// The per-layer steps (layer_step.cu: fused_attn_step, fused_mlp_step) compute
// the same layer in two calls. The two files share the helpers of common.cuh
// (the block reductions, dot4_i8, kv_scale / kv_code for the per-vector int8
// of a new K/V row, soft_cap), not their kernels, because they round at
// other places: here every value between two stages stays f32, stored as
// bf16 hi + lo halves for the GEMM core of i8_gemm.cu over weights in
// fragment order, the residual is f32 across all layers, and the attention
// kernel writes cache row t itself; there the normed input, q, p * v_scale,
// the attention output and the MLP hidden are rounded to one bf16 value each,
// as the TPU's per-layer kernels round them, the products run through the
// row-major int8 product kernel of int8_linear.cu, the residual is rounded to
// bf16 at the end of each half, and the cache is only read.

#include "decode_gemm.cuh"   // the int8 / int4 GEMM core, sm90.cuh, common.cuh

namespace {

// x (f32 residual) update and next RMSNorm, one block of 256 threads per
// batch row, the row held in registers (H <= 256 * ROW_REGS):
//   x_in != null : x = float(x_in), and the n_zero floats at zero are zeroed
//   y    != null : x += rms(y) * (1 + w_post); y's row is zeroed once read
//   h    != null : h = rms(x) * (1 + w_next), split [2, B, H]
//   xo   != null : xo = bf16(x)
__global__ void __launch_bounds__(256)
residual_rms_kernel(const bf16* __restrict__ x_in, float* __restrict__ x,
                    float* __restrict__ y, const float* __restrict__ w_post,
                    const float* __restrict__ w_next, bf16* __restrict__ h,
                    bf16* __restrict__ xo, int H, float eps, float* __restrict__ zero,
                    size_t n_zero) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n_zero; i += (size_t)gridDim.x * 256)
    zero[i] = 0.f;
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
      yv[k] = 0.f;
      if (i < H) {
        yv[k] = y[row + i];
        y[row + i] = 0.f;   // the next product accumulates into zeros
      }
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
// f32 (scaled projection), zeroed once read. Writes the new int8 K/V row t
// and its scales, then attends over cache rows 0..t; out: split [2, B, QHD].
__global__ void stack_attn_kernel(float* __restrict__ qkv, const float* __restrict__ cosv,
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
  float* row = qkv + (size_t)b * (QHD + 2 * KHD);
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
  // every value of the block's q heads, k and v read (RoPE reads a partner)
  row[QHD + kh * D + d] = 0.f;
  row[QHD + KHD + kh * D + d] = 0.f;
  for (int g = 0; g < G; ++g) row[(kh * G + g) * D + d] = 0.f;

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

// a[b, f] = gelu_tanh(gu[b, f]) * gu[b, F + f], split [2, B, F]; gu zeroed
// once read. A thread takes four neighbouring f (F % 4 == 0).
__global__ void geglu_kernel(float* __restrict__ gu, bf16* __restrict__ a, int B, int F) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= (size_t)B * F) return;
  const size_t b = i / F, f = i % F;
  float4* gp = reinterpret_cast<float4*>(gu + b * 2 * F + f);
  float4* up = reinterpret_cast<float4*>(gu + b * 2 * F + F + f);
  const float4 g4 = *gp, u4 = *up;
  *gp = *up = make_float4(0.f, 0.f, 0.f, 0.f);
  const float g[4] = {g4.x, g4.y, g4.z, g4.w}, u[4] = {u4.x, u4.y, u4.z, u4.w};
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  float v[4];
  bf16 hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = 0.5f * g[e] * (1.f + tanhf(k0 * (g[e] + 0.044715f * g[e] * g[e] * g[e]))) * u[e];
    hi[e] = __float2bfloat16(v[e]);
    lo[e] = __float2bfloat16(v[e] - __bfloat162float(hi[e]));
  }
  *reinterpret_cast<uint2*>(a + i) = *reinterpret_cast<const uint2*>(hi);
  *reinterpret_cast<uint2*>(a + (size_t)B * F + i) = *reinterpret_cast<const uint2*>(lo);
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
  VBT_CHECK((cudaError_t)bind_device(x_in));
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
  // the products' activations: h (K = H) for q|k|v and gate|up, a for o (K =
  // QHD) and down (K = F); and the four stacked weights; one tensor map each
  // for the whole call
  CUtensorMap map_h, map_o, map_d, w_qkv, w_o, w_gu, w_d;
  int rc = make_act_map(&map_h, h, H, B, H);
  if (!rc) rc = make_act_map(&map_o, a, QHD, B, QHD);
  if (!rc) rc = make_act_map(&map_d, a, F, B, F);
  if (!rc) rc = make_weight_map(&w_qkv, wqkv, L, H, NQKV, false);
  if (!rc) rc = make_weight_map(&w_o, wo, L, QHD, H, false);
  if (!rc) rc = make_weight_map(&w_gu, wgu, L, H, 2 * F, mlp4);
  if (!rc) rc = make_weight_map(&w_d, wd, L, F, H, mlp4);
  if (rc) return rc;

  // y starts at zero: every product accumulates into it, every kernel that
  // reads it writes zeros back
  residual_rms_kernel<<<B, 256, 0, st>>>((const bf16*)x_in, x, nullptr, nullptr, nrm, h,
                                         nullptr, H, eps, y,
                                         (size_t)B * max(max(NQKV, 2 * F), H));
    VBT_CHECK_LAUNCH();
  for (int l = 0; l < L; ++l) {
    const float* nl = nrm + (size_t)l * 4 * H;
    rc = launch_i8_gemm(map_h, w_qkv, l, (const float*)qkv_scale + (size_t)l * NQKV, nullptr, y,
                        B, NQKV, H, st);
    if (rc) return rc;
    stack_attn_kernel<<<dim3(KH, B), D, attn_smem, st>>>(
        y, (const float*)cosv, (const float*)sinv, (int8_t*)kc + l * cache_layer,
        (int8_t*)vc + l * cache_layer, (float*)ks + l * scale_layer,
        (float*)vs + l * scale_layer, a, NH, KH, D, S, t, attn_scale, softcap);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(map_o, w_o, l, (const float*)o_scale + (size_t)l * H, nullptr, y, B, H,
                        QHD, st);
    if (rc) return rc;
    residual_rms_kernel<<<B, 256, 0, st>>>(nullptr, x, y, nl + H, nl + 2 * H, h, nullptr, H,
                                           eps, nullptr, 0);
    VBT_CHECK_LAUNCH();
    if (mlp4)
      rc = launch_i4_gemm(map_h, w_gu, l,
                          (const float*)gu_scale + (size_t)l * (H / gu_group) * 2 * F, gu_group,
                          y, B, 2 * F, H, st);
    else
      rc = launch_i8_gemm(map_h, w_gu, l, (const float*)gu_scale + (size_t)l * 2 * F, nullptr, y,
                          B, 2 * F, H, st);
    if (rc) return rc;
    const size_t n = (size_t)B * F;
    geglu_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, st>>>(y, a, B, F);
    VBT_CHECK_LAUNCH();
    if (mlp4)
      rc = launch_i4_gemm(map_d, w_d, l, (const float*)d_scale + (size_t)l * (F / d_group) * H,
                          d_group, y, B, H, F, st);
    else
      rc = launch_i8_gemm(map_d, w_d, l, (const float*)d_scale + (size_t)l * H, nullptr, y, B, H, F,
                          st);
    if (rc) return rc;
    const bool last = (l == L - 1);
    residual_rms_kernel<<<B, 256, 0, st>>>(nullptr, x, y, nl + 3 * H,
                                           last ? nullptr : nl + 4 * H, last ? nullptr : h,
                                           last ? (bf16*)x_out : nullptr, H, eps, nullptr, 0);
    VBT_CHECK_LAUNCH();
  }
  return 0;
}
