// One greedy decode step through both Bridge-Lite blocks (int8 weights).
//
// Replaces: vlm_bridge_tpu/ops/decode_kernels.py:fused_bridge_step, whose
// body is _bridge_kernel. Per block: LayerNorm (mean-subtracting, biased
// variance) -> int8 cross q (+bias after the per-column scale) -> softmax
// over the cached int8 vision K/V with per-vector scales -> int8 o (+bias)
// -> residual; LayerNorm -> int8 fused self q|k|v (+bias) -> the new K/V
// rounded to the cache dtype (bf16) and written at row t -> causal attention
// over rows <= t -> int8 o (+bias) -> residual; LayerNorm -> int8 fc1 (+bias)
// -> exact (erf) GELU -> int8 fc2 (+bias) -> residual. The residual stream
// stays f32 across both blocks.
//
// Bound: bandwidth again: 148 MB of int8 bridge weights plus the 152 MB int8
// cross cache (B = 64 rows x 257 vision tokens x 2304 x K and V x 2 blocks)
// per token.
//
// Design: eight kernels a block, on decode_gemm.cuh's core (the products'
// stream-K partials in slots, read by their consumers as sums in block
// order, so the bits are fixed): q -> attn_kernel, the cross attention (a
// (row, head) item a block, its K and V rows streamed into shared memory by
// bulk copies of 18 KB and read 16 bytes a thread, several blocks to an
// SM); cross o with residual add and LayerNorm as its stage; self q|k|v ->
// self_attn_kernel (the new K/V rounded to bf16 into row t, a (row, head)
// item a warp); self o with residual add and LayerNorm; fc1 with exact GELU
// as its stage; fc2 with residual add and the next block's LayerNorm (the
// last block's output instead). With block 0's input LayerNorm (a row
// kernel), a step is 1 + 8 nb launches (17 at nb 2).

// Cache layouts (this port's own): cross K/V [nb, B, Hc, Sv, Dc] int8 with
// scales [nb, B, Hc, Sv]; self K/V [nb, B, Hs, Smax, Ds] bf16.

#include "decode_gemm.cuh"   // the int8 GEMM core, sm90.cuh, common.cuh

namespace {

// Block 0's input: x = float(x_in) (the f32 residual) and h = LN(x) * ln_s +
// ln_b, split [2, B, H]; one block of 256 threads a row, R values a thread
// (H <= 256 R)
template <int R>
__global__ void __launch_bounds__(256)
input_ln_kernel(const bf16* __restrict__ x_in, float* __restrict__ x,
                const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                bf16* __restrict__ h, int H, float eps) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  float v[R], s = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    v[k] = i < H ? __bfloat162float(x_in[row + i]) : 0.f;
    if (i < H) x[row + i] = v[k];
    s += v[k];
  }
  const float mu = block_sum(s, red) / H;
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    if (i < H) ss += (v[k] - mu) * (v[k] - mu);
  }
  const float r = rsqrtf(block_sum(ss, red) / H + eps);
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    if (i < H) store_split(h, (size_t)gridDim.x * H, row + i, (v[k] - mu) * r * ln_s[i] + ln_b[i]);
  }
}

}  // namespace

extern "C" int vbt_fused_bridge_step(
    const void* x_in, void* x_out, const void* lns,
    const void* wq, const void* q_scale, const void* q_bias,
    const void* ck, const void* cks, const void* cv, const void* cvs,
    const void* woc, const void* oc_scale, const void* oc_bias,
    const void* wqkv, const void* qkv_scale, const void* qkv_bias,
    void* sk, void* sv,
    const void* wos, const void* os_scale, const void* os_bias,
    const void* fc1, const void* f1_scale, const void* f1_bias,
    const void* fc2, const void* f2_scale, const void* f2_bias,
    void* x32, void* hbuf, void* abuf, void* ws, int n_slots, int n_counters,
    int nb, int B, int ld, int Hc, int Hs, int Sv, int Smax, int F, int t, float eps,
    void* stream_ptr) {
  const int Dc = ld / Hc, Ds = ld / Hs;
  if (ld > ROW_MAX || !self_attn_fits(Ds, t)) return (int)cudaErrorInvalidValue;
  VBT_CHECK((cudaError_t)bind_device(x_in));
  if (!cross_attn_fits(Dc, Sv)) return (int)cudaErrorInvalidValue;
  // each product's stage: q's and self q|k|v's stay in the slots for the
  // attention kernels
  DgStage none{}, cross{}, self{}, norm{}, gelu{};
  none.kind = DG_NONE;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  float* x = (float*)x32;
  bf16* h = (bf16*)hbuf;
  bf16* a = (bf16*)abuf;
  const DgWork work = dg_work(ws, n_slots, n_counters);
  const float* ln = (const float*)lns;
  const size_t cross_blk = (size_t)B * Hc * Sv, self_blk = (size_t)B * Hs * Smax * Ds;
  // the products' activations: h (K = ld), a for the o projections (K = ld)
  // and fc2 (K = F); and the six stacked weights; one tensor map each for the
  // whole call
  CUtensorMap map_h, map_a, map_f, w_q, w_oc, w_qkv, w_os, w_1, w_2;
  int rc = make_act_map(&map_h, h, ld, B, ld);
  if (!rc) rc = make_act_map(&map_a, a, ld, B, ld);
  if (!rc) rc = make_act_map(&map_f, a, F, B, F);
  if (!rc) rc = make_weight_map(&w_q, wq, nb, ld, ld, false);
  if (!rc) rc = make_weight_map(&w_oc, woc, nb, ld, ld, false);
  if (!rc) rc = make_weight_map(&w_qkv, wqkv, nb, ld, 3 * ld, false);
  if (!rc) rc = make_weight_map(&w_os, wos, nb, ld, ld, false);
  if (!rc) rc = make_weight_map(&w_1, fc1, nb, ld, F, false);
  if (!rc) rc = make_weight_map(&w_2, fc2, nb, F, ld, false);
  if (rc) return rc;

  cross.kind = DG_CROSS_ATTN;
  cross.out = self.out = a;
  cross.out_ld = self.out_ld = ld;
  cross.heads = cross.kv_heads = Hc;
  cross.D = Dc;
  cross.S = Sv;
  cross.attn_scale = 1.f / sqrtf((float)Dc);
  self.kind = DG_SELF_ATTN;
  self.heads = self.kv_heads = Hs;
  self.D = Ds;
  self.S = Smax;
  self.t = t;
  self.attn_scale = 1.f / sqrtf((float)Ds);
  norm.kind = DG_LN;
  norm.x = x;
  norm.out = h;
  norm.out_ld = ld;
  norm.eps = eps;
  gelu.kind = DG_GELU;
  gelu.out = a;
  gelu.out_ld = F;

  VBT_ROW_LAUNCH(input_ln_kernel, ld, B, 0, st, (const bf16*)x_in, x, ln, ln + ld, h, ld, eps);
  VBT_CHECK_LAUNCH();
  for (int k = 0; k < nb && !rc; ++k) {
    const float* lk = ln + (size_t)k * 6 * ld;
    const bool last = k == nb - 1;
    cross.kc = (int8_t*)ck + k * cross_blk * Dc;
    cross.vc = (int8_t*)cv + k * cross_blk * Dc;
    cross.ks = (float*)cks + k * cross_blk;
    cross.vs = (float*)cvs + k * cross_blk;
    self.sk = (bf16*)sk + k * self_blk;
    self.sv = (bf16*)sv + k * self_blk;
    // the LayerNorms after the cross o and the self o, then after fc2 the
    // next block's input LayerNorm (the last block: its output)
    DgStage ln_c = norm, ln_s = norm, ln_f = norm;
    ln_c.w_s = lk + 2 * ld;
    ln_c.w_b = lk + 3 * ld;
    ln_s.w_s = lk + 4 * ld;
    ln_s.w_b = lk + 5 * ld;
    ln_f.w_s = last ? nullptr : lk + 6 * ld;
    ln_f.w_b = last ? nullptr : lk + 7 * ld;
    ln_f.xo = last ? (bf16*)x_out : nullptr;
    rc = launch_i8_gemm(map_h, w_q, k, (const float*)q_scale + (size_t)k * ld,
                        (const float*)q_bias + (size_t)k * ld, B, ld, ld, work, none, st);
    if (!rc) rc = launch_attn(cross, work, B, ld, ld, st);
    if (!rc)
      rc = launch_i8_gemm(map_a, w_oc, k, (const float*)oc_scale + (size_t)k * ld,
                          (const float*)oc_bias + (size_t)k * ld, B, ld, ld, work, ln_c, st);
    if (!rc)
      rc = launch_i8_gemm(map_h, w_qkv, k, (const float*)qkv_scale + (size_t)k * 3 * ld,
                          (const float*)qkv_bias + (size_t)k * 3 * ld, B, 3 * ld, ld, work, none,
                          st);
    if (!rc) rc = launch_self_attn(self, work, B, 3 * ld, ld, st);
    if (!rc)
      rc = launch_i8_gemm(map_a, w_os, k, (const float*)os_scale + (size_t)k * ld,
                          (const float*)os_bias + (size_t)k * ld, B, ld, ld, work, ln_s, st);
    if (!rc)
      rc = launch_i8_gemm(map_h, w_1, k, (const float*)f1_scale + (size_t)k * F,
                          (const float*)f1_bias + (size_t)k * F, B, F, ld, work, gelu, st);
    if (!rc)
      rc = launch_i8_gemm(map_f, w_2, k, (const float*)f2_scale + (size_t)k * ld,
                          (const float*)f2_bias + (size_t)k * ld, B, ld, F, work, ln_f, st);
  }
  return rc;
}
