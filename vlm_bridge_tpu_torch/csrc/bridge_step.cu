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
// per token. The projections go through the GEMM core of i8_gemm.cu
// (decode_gemm.cuh: swap-AB wgmma + TMA, split sums added in a fixed order
// into y, which every kernel that reads it zeroes again, so no memset is
// launched); the cross
// attention reads each (row, head) slab of K and V exactly once, one block
// per (row, head), with the 288-wide heads spread over nine warps (no
// power-of-two tiling needed).
//
// Cache layouts (this port's own): cross K/V [nb, B, Hc, Sv, Dc] int8 with
// scales [nb, B, Hc, Sv]; self K/V [nb, B, Hs, Smax, Ds] bf16.

#include "decode_gemm.cuh"   // the int8 GEMM core, sm90.cuh, common.cuh

namespace {

// x (f32 residual) update and the next LayerNorm, one block of 256 threads
// per batch row, the row held in registers, R values a thread (H <= 256 R):
//   x_in != null : x = float(x_in), and the n_zero floats at zero are zeroed
//   y    != null : x += y; y's row is zeroed once read
//   h    != null : h = LN(x) * ln_s + ln_b, split [2, B, H]
//   xo   != null : xo = bf16(x)
template <int R>
__global__ void __launch_bounds__(256)
residual_ln_kernel(const bf16* __restrict__ x_in, float* __restrict__ x,
                   float* __restrict__ y, const float* __restrict__ ln_s,
                   const float* __restrict__ ln_b, bf16* __restrict__ h,
                   bf16* __restrict__ xo, int H, float eps, float* __restrict__ zero,
                   size_t n_zero) {
  __shared__ float red[32];
  const size_t row = (size_t)blockIdx.x * H;
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n_zero; i += (size_t)gridDim.x * 256)
    zero[i] = 0.f;
  float v[R], s = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = threadIdx.x + k * 256;
    v[k] = 0.f;
    if (i < H) {
      v[k] = x_in != nullptr ? __bfloat162float(x_in[row + i]) : x[row + i];
      if (y != nullptr) {
        v[k] += y[row + i];
        y[row + i] = 0.f;   // the next product accumulates into zeros
      }
      x[row + i] = v[k];
      if (xo != nullptr) xo[row + i] = __float2bfloat16(v[k]);
    }
    s += v[k];
  }
  if (h != nullptr) {
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
}

// Cross attention, one block per (head, batch row), blockDim.x == Dc.
// q: [B, ld] f32, zeroed once read; K/V slabs [Sv, Dc] int8 with scales [Sv];
// out split [2, B, ld].
__global__ void cross_attn_kernel(float* __restrict__ q, const int8_t* __restrict__ ck,
                                  const float* __restrict__ cks, const int8_t* __restrict__ cv,
                                  const float* __restrict__ cvs, bf16* __restrict__ out,
                                  int Hc, int Dc, int Sv, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;        // [Dc]
  float* p = sm + Dc;    // [Sv]
  __shared__ float red[32];
  const int hc = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int ld = Hc * Dc;
  const size_t slab = ((size_t)b * Hc + hc) * Sv;
  qs[d] = q[(size_t)b * ld + hc * Dc + d];
  q[(size_t)b * ld + hc * Dc + d] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int j = warp; j < Sv; j += nw) {
    const uint32_t* kj = reinterpret_cast<const uint32_t*>(ck + (slab + j) * Dc);
    float acc = 0.f;
    for (int e = lane; e < Dc / 4; e += 32) acc += dot4_i8(&qs[4 * e], kj[e]);
    acc = warp_sum(acc);
    if (lane == 0) p[j] = acc * scale * cks[slab + j];
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = threadIdx.x; j < Sv; j += blockDim.x) m = fmaxf(m, p[j]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < Sv; j += blockDim.x) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);  // its __syncthreads also publishes p
  float acc = 0.f;
  const float inv = 1.f / sum;
#pragma unroll 8
  for (int j = 0; j < Sv; ++j) acc += p[j] * inv * cvs[slab + j] * (float)cv[(slab + j) * Dc + d];
  store_split(out, (size_t)gridDim.y * ld, (size_t)b * ld + hc * Dc + d, acc);
}

// Causal self attention, one block per (head, batch row), blockDim.x == Ds.
// qkv: [B, 3*ld] f32 (q | k | v), zeroed once read; caches [B, Hs, Smax, Ds]
// bf16, row t written here; out split [2, B, ld].
__global__ void self_attn_kernel(float* __restrict__ qkv, bf16* __restrict__ sk,
                                 bf16* __restrict__ sv, bf16* __restrict__ out, int Hs, int Ds,
                                 int Smax, int t, float scale) {
  extern __shared__ float sm[];
  float* qs = sm;        // [Ds]
  float* p = sm + Ds;    // [t+1]
  __shared__ float red[32];
  const int hs = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int ld = Hs * Ds;
  float* row = qkv + (size_t)b * 3 * ld;
  const size_t slab = ((size_t)b * Hs + hs) * Smax;
  qs[d] = row[hs * Ds + d];
  sk[(slab + t) * Ds + d] = __float2bfloat16(row[ld + hs * Ds + d]);
  sv[(slab + t) * Ds + d] = __float2bfloat16(row[2 * ld + hs * Ds + d]);
  row[hs * Ds + d] = row[ld + hs * Ds + d] = row[2 * ld + hs * Ds + d] = 0.f;
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int n = t + 1;
  for (int j = warp; j < n; j += nw) {
    const bf16* kj = sk + (slab + j) * Ds;
    float acc = 0.f;
    for (int e = lane; e < Ds; e += 32) acc += qs[e] * __bfloat162float(kj[e]);
    acc = warp_sum(acc);
    if (lane == 0) p[j] = acc * scale;
  }
  __syncthreads();
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += blockDim.x) m = fmaxf(m, p[j]);
  m = block_max(m, red);
  float sum = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float e = expf(p[j] - m);
    p[j] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  float acc = 0.f;
  for (int j = 0; j < n; ++j) acc += p[j] / sum * __bfloat162float(sv[(slab + j) * Ds + d]);
  store_split(out, (size_t)gridDim.y * ld, (size_t)b * ld + hs * Ds + d, acc);
}

// a = gelu_exact(y), erf-based, split (n values, then their lo halves); y
// zeroed once read
__global__ void gelu_exact_kernel(float* __restrict__ y, bf16* __restrict__ a, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float g = y[i];
  y[i] = 0.f;
  store_split(a, n, i, 0.5f * g * (1.f + erff(g * 0.7071067811865476f)));
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
    void* x32, void* hbuf, void* abuf, void* ybuf, void* ws, int n_slots, int n_counters,
    int nb, int B, int ld, int Hc, int Hs, int Sv, int Smax, int F, int t, float eps,
    void* stream_ptr) {
  if (ld > ROW_MAX) return (int)cudaErrorInvalidValue;
  VBT_CHECK((cudaError_t)bind_device(x_in));
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int Dc = ld / Hc, Ds = ld / Hs;
  float* x = (float*)x32;
  bf16* h = (bf16*)hbuf;
  bf16* a = (bf16*)abuf;
  float* y = (float*)ybuf;
  const DgWork work = dg_work(ws, n_slots, n_counters);
  const float* ln = (const float*)lns;
  const size_t cross_blk = (size_t)B * Hc * Sv, self_blk = (size_t)B * Hs * Smax * Ds;
  const float c_scale = 1.f / sqrtf((float)Dc), s_scale = 1.f / sqrtf((float)Ds);
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

  // y starts at zero: every product accumulates into it, every kernel that
  // reads it writes zeros back
  VBT_ROW_LAUNCH(residual_ln_kernel, ld, B, 0, st, (const bf16*)x_in, x, nullptr, ln, ln + ld, h,
                 nullptr, ld, eps, y, (size_t)B * max(3 * ld, F));
  VBT_CHECK_LAUNCH();
  for (int k = 0; k < nb; ++k) {
    const float* lk = ln + (size_t)k * 6 * ld;
    rc = launch_i8_gemm(map_h, w_q, k, (const float*)q_scale + (size_t)k * ld,
                        (const float*)q_bias + (size_t)k * ld, y, B, ld, ld, work, st);
    if (rc) return rc;
    cross_attn_kernel<<<dim3(Hc, B), Dc, sizeof(float) * (Dc + Sv), st>>>(
        y, (const int8_t*)ck + k * cross_blk * Dc, (const float*)cks + k * cross_blk,
        (const int8_t*)cv + k * cross_blk * Dc, (const float*)cvs + k * cross_blk, a, Hc, Dc,
        Sv, c_scale);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(map_a, w_oc, k, (const float*)oc_scale + (size_t)k * ld,
                        (const float*)oc_bias + (size_t)k * ld, y, B, ld, ld, work, st);
    if (rc) return rc;
    VBT_ROW_LAUNCH(residual_ln_kernel, ld, B, 0, st, nullptr, x, y, lk + 2 * ld, lk + 3 * ld, h,
                   nullptr, ld, eps, nullptr, 0);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(map_h, w_qkv, k, (const float*)qkv_scale + (size_t)k * 3 * ld,
                        (const float*)qkv_bias + (size_t)k * 3 * ld, y, B, 3 * ld, ld, work, st);
    if (rc) return rc;
    self_attn_kernel<<<dim3(Hs, B), Ds, sizeof(float) * (Ds + t + 1), st>>>(
        y, (bf16*)sk + k * self_blk, (bf16*)sv + k * self_blk, a, Hs, Ds, Smax, t, s_scale);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(map_a, w_os, k, (const float*)os_scale + (size_t)k * ld,
                        (const float*)os_bias + (size_t)k * ld, y, B, ld, ld, work, st);
    if (rc) return rc;
    VBT_ROW_LAUNCH(residual_ln_kernel, ld, B, 0, st, nullptr, x, y, lk + 4 * ld, lk + 5 * ld, h,
                   nullptr, ld, eps, nullptr, 0);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(map_h, w_1, k, (const float*)f1_scale + (size_t)k * F,
                        (const float*)f1_bias + (size_t)k * F, y, B, F, ld, work, st);
    if (rc) return rc;
    const size_t n = (size_t)B * F;
    gelu_exact_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(y, a, n);
    VBT_CHECK_LAUNCH();
    rc = launch_i8_gemm(map_f, w_2, k, (const float*)f2_scale + (size_t)k * ld,
                        (const float*)f2_bias + (size_t)k * ld, y, B, ld, F, work, st);
    if (rc) return rc;
    const bool last = (k == nb - 1);
    const float* nxt = ln + (size_t)(k + 1) * 6 * ld;
    VBT_ROW_LAUNCH(residual_ln_kernel, ld, B, 0, st, nullptr, x, y, last ? nullptr : nxt,
                   last ? nullptr : nxt + ld, last ? nullptr : h,
                   last ? (bf16*)x_out : nullptr, ld, eps, nullptr, 0);
    VBT_CHECK_LAUNCH();
  }
  return 0;
}
