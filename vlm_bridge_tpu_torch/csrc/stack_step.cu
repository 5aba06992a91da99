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
// GB, 0.39 ms) the tensor cores set the floor.
//
// Design: five kernels a layer. Each product runs on decode_gemm.cuh's
// core, whose stream-K grid stores its partial sums into slots; the kernel
// that consumes a product reads each value as the sum of its slots in block
// order, so the bits are fixed and nothing is zeroed, or summed apart,
// between a product and its consumer. q|k|v -> attn_kernel (RoPE, the new
// row's int8 into the cache, GQA with all G heads of a kv head in one pass
// over its rows, which come into shared memory by bulk copies and are read
// 16 bytes a thread; a block an item, several to an SM); o, with the
// post-attention RMSNorm, the residual add and the pre-FFN RMSNorm as its
// stage; gate|up, with GeGLU as its stage (gate and up columns interleave in
// runs of 32, gemma2.stack_decode_params, so that each 64-column tile holds
// both halves of its features); down, with the post-FFN RMSNorm, the
// residual add and the next layer's input RMSNorm (the last layer's output
// instead). A stage runs in the product's own kernel behind one barrier of
// its resident grid (a residual norm needs its whole row: 12 tiles at H
// 2304; one block takes a row). With the input RMSNorm of layer 0 (a row
// kernel), a token is 1 + 5 L launches (131 at L 26), queued back to back
// from one C call with no host synchronisation. The activations between the
// projections stay f32 (split into bf16 hi + lo where they feed a product,
// common.cuh), and the residual stream stays f32 across all layers, as in
// the TPU kernel.
// Measured on an H100: PERF.md (scripts/decode_gemm_torch.py's breakdown).
//
// Cache layout (this port's own): K/V [L, B, KH, S, D] int8, so the rows a
// (row, kv head) item reads are one contiguous run of its [S, D] slab;
// scales [L, B, KH, S].
//
// The per-layer steps (layer_step.cu: fused_attn_step, fused_mlp_step) compute
// the same layer in two calls on the same GEMM core, with their own stages
// and attention kernel, because they round at other places: here every value
// between two stages stays f32, stored as bf16 hi + lo halves, the residual
// is f32 across all layers, and the attention kernel writes cache row t
// itself; there the normed input, q, p * v_scale, the attention output and
// the MLP hidden are rounded to one bf16 value each, as the TPU's per-layer
// kernels round them, and the products take that one half; the residual is
// rounded to bf16 at the end of each half, and the cache is only read.

#include "decode_gemm.cuh"   // the int8 / int4 GEMM core, sm90.cuh, common.cuh

namespace {

// Layer 0's input: x = float(x_in) (the f32 residual) and h = rms(x) (1 +
// w), split [2, B, H]; one block of 256 threads a row, R values a thread
// (H <= 256 R)
template <int R>
__global__ void __launch_bounds__(256)
input_rms_kernel(const bf16* __restrict__ x_in, float* __restrict__ x,
                 const float* __restrict__ w, bf16* __restrict__ h, int H, float eps) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  float v[R], ss = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    v[k] = i < H ? __bfloat162float(x_in[row + i]) : 0.f;
    if (i < H) x[row + i] = v[k];
    ss += v[k] * v[k];
  }
  const float r = rsqrtf(block_sum(ss, red) / H + eps);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    if (i < H) store_split(h, (size_t)gridDim.x * H, row + i, v[k] * r * (1.f + w[i]));
  }
}

}  // namespace

extern "C" int vbt_fused_stack_step(
    const void* x_in, void* x_out,
    const void* wqkv, const void* qkv_scale, const void* wo, const void* o_scale,
    const void* wgu, const void* gu_scale, const void* wd, const void* d_scale,
    const void* norms, const void* cosv, const void* sinv,
    void* kc, void* vc, void* ks, void* vs,
    void* x32, void* hbuf, void* abuf, void* ws, int n_slots, int n_counters,
    int L, int B, int H, int NH, int KH, int D, int F, int S, int t, int mlp4, int mlp4_group,
    float attn_scale, float softcap, float eps, void* stream_ptr) {
  if (H > ROW_MAX || NH % KH != 0) return (int)cudaErrorInvalidValue;
  VBT_CHECK((cudaError_t)bind_device(x_in));
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int QHD = NH * D, KHD = KH * D, NQKV = QHD + 2 * KHD;
  if (!stack_attn_fits(NH / KH, D, t)) return (int)cudaErrorInvalidValue;
  // each product's stage: q|k|v's stays in the slots for the attention kernel
  DgStage none{}, attn{}, post_attn{}, geglu{}, post_ffn{};
  none.kind = DG_NONE;
  float* x = (float*)x32;
  bf16* h = (bf16*)hbuf;
  bf16* a = (bf16*)abuf;
  const DgWork work = dg_work(ws, n_slots, n_counters);
  const float* nrm = (const float*)norms;
  const size_t cache_layer = (size_t)B * KH * S * D, scale_layer = (size_t)B * KH * S;
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

  attn.kind = DG_STACK_ATTN;
  attn.out = a;
  attn.out_ld = QHD;
  attn.cosv = (const float*)cosv;
  attn.sinv = (const float*)sinv;
  attn.heads = NH;
  attn.kv_heads = KH;
  attn.D = D;
  attn.S = S;
  attn.t = t;
  attn.attn_scale = attn_scale;
  attn.softcap = softcap;
  post_attn.kind = post_ffn.kind = DG_RMS;
  post_attn.x = post_ffn.x = x;
  post_attn.out = post_ffn.out = h;
  post_attn.out_ld = post_ffn.out_ld = H;
  post_attn.eps = post_ffn.eps = eps;
  geglu.kind = DG_GEGLU;
  geglu.out = a;
  geglu.out_ld = F;

  VBT_ROW_LAUNCH(input_rms_kernel, H, B, 0, st, (const bf16*)x_in, x, nrm, h, H, eps);
  VBT_CHECK_LAUNCH();
  for (int l = 0; l < L; ++l) {
    const float* nl = nrm + (size_t)l * 4 * H;
    const bool last = l == L - 1;
    attn.kc = (int8_t*)kc + l * cache_layer;
    attn.vc = (int8_t*)vc + l * cache_layer;
    attn.ks = (float*)ks + l * scale_layer;
    attn.vs = (float*)vs + l * scale_layer;
    post_attn.w_post = nl + H;
    post_attn.w_s = nl + 2 * H;
    post_ffn.w_post = nl + 3 * H;
    post_ffn.w_s = last ? nullptr : nl + 4 * H;
    post_ffn.xo = last ? (bf16*)x_out : nullptr;
    rc = launch_i8_gemm(map_h, w_qkv, l, (const float*)qkv_scale + (size_t)l * NQKV, nullptr, B,
                        NQKV, H, work, none, st);
    if (!rc) rc = launch_attn(attn, work, B, NQKV, H, st);
    if (!rc)
      rc = launch_i8_gemm(map_o, w_o, l, (const float*)o_scale + (size_t)l * H, nullptr, B, H,
                          QHD, work, post_attn, st);
    if (!rc)
      rc = mlp4 ? launch_i4_gemm(map_h, w_gu, l,
                                 (const float*)gu_scale + (size_t)l * (H / gu_group) * 2 * F,
                                 gu_group, B, 2 * F, H, work, geglu, st)
                : launch_i8_gemm(map_h, w_gu, l, (const float*)gu_scale + (size_t)l * 2 * F,
                                 nullptr, B, 2 * F, H, work, geglu, st);
    if (!rc)
      rc = mlp4 ? launch_i4_gemm(map_d, w_d, l,
                                 (const float*)d_scale + (size_t)l * (F / d_group) * H, d_group,
                                 B, H, F, work, post_ffn, st)
                : launch_i8_gemm(map_d, w_d, l, (const float*)d_scale + (size_t)l * H, nullptr,
                                 B, H, F, work, post_ffn, st);
    if (rc) return rc;
  }
  return 0;
}

