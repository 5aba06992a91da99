// One Gemma-2 decoder layer at decode, as two calls (int8 weights in the
// GEMM core's fragment order, ops/decode_kernels.to_fragments; int8 KV cache):
//   fused_attn_step  x + rms_post(o(attention(rope(qkv(bf16(rms_in(x)))))))
//   fused_mlp_step   x + rms_post(down(bf16(gelu_tanh(gate(h)) * up(h)))),
//                    h = bf16(rms_pre(x))
//
// Replaces: vlm_bridge_tpu/ops/decode_kernels.py:fused_attn_step (body
// _attn_kernel) and vlm_bridge_tpu/ops/decode_kernels.py:fused_mlp_step (body
// _mlp_kernel). The TPU kernels hold a layer's weights and both caches in
// VMEM inside one program (the MLP walks F on a sequential grid and carries
// its accumulator); here each call is a short chain of kernels on one stream
// with no host synchronisation, the activations between them (at most 1.2 MB
// at batch 64) staying in the L2.
//
// Bound: bytes. At batch 64 a weight byte feeds 64 multiply-adds, far below
// the ~295 operations per byte where the tensor cores become the limit: the
// least time is the layer's int8 weights over 3.35 TB/s (14.2 MB for q|k|v
// and o, 4.2 us; 63.7 MB for the MLP, 19.0 us) plus the live cache rows.
//
// Design. The activations are bf16 by definition here: the TPU kernels cast
// h, the attention output and the MLP hidden to bf16 before each product and
// keep the residual bf16 between calls. So the four products run on
// decode_gemm.cuh's GEMM core (swap-AB wgmma, the weights the register A
// operand, TMA ring, stream-K over every SM) fed ONE bf16 half
// (launch_i8_gemm_bf16): an m64n64k16 a k16 step and 8 KB of activations a
// stage, half the tensor work and bytes of the stack step's hi + lo form,
// which this function does not need (B 64: q|k|v 8.6 us against the stack
// step's 9.4, gate|up with GeGLU 32 against 34.5; PERF.md). Batch rows past
// 64 take a second row tile of the core (its weights read again). Each
// product's stream-K runs store their partial sums into workspace slots;
// what consumes the product adds a value's slots in block order (product4),
// so the same inputs give the same bits and no atomics are used; a block
// takes at least DG1_MIN_UNITS units, so that o's stage adds fewer slots a
// value. The kernels of a call:
//   ls_rms_kernel      the pre-norm, rounded to bf16 as the TPU kernel does: a
//                      row kernel. As a stage ahead of the product (the
//                      consumers norming the rows while the weights stream,
//                      the activations' producer waiting at a grid barrier)
//                      the norm and q|k|v took 13.6 us against 3.0 + 8.6 here;
//   q|k|v (attn)       the product alone (DG_NONE): its slots stay for
//   layer_attn_kernel  a (row, kv head) a block, all G heads in one pass,
//                      16-byte K/V loads, every device read asked for first
//                      (stack_attn_kernel's design, decode_gemm.cuh), q in
//                      registers and the P.V partials laid out so that no
//                      shared-memory access of a phase conflicts across the
//                      lanes of a row (17.2 us with them, 10.1 without, at
//                      t = 20): q, k, v as their slots added in order, RoPE,
//                      the new K and V quantized per vector and handed back
//                      (the cache is read, never written: the caller writes
//                      row t), then
//                      attention over rows s < t and the new row, which
//                      enters through its quantized value. Rows at and beyond
//                      t are skipped, not masked, so whatever they hold is
//                      never read; at t = 0 only the self term is left. q and
//                      p * v_scale are rounded to bf16 before their products
//                      and the output to bf16, where the TPU kernel casts;
//   o (attn), down     with the post-norm and the residual as their stage
//   (mlp)              (DG_RMS_BF16): behind one barrier of the product's
//                      resident grid a block takes a row, reads bf16 x, adds
//                      rms(Y) (1 + w) and rounds once to bf16 x_out;
//   gate|up (mlp)      gate and up columns interleaved in runs of 32
//                      (interleave_gate_up), GeGLU as the stage
//                      (DG_GEGLU_BF16), writing the bf16 hidden.
// fused_attn_step is 4 launches, fused_mlp_step 3. The stack step
// (stack_step.cu) computes the same layer with f32 (hi + lo) activations
// between its stages and an f32 residual across layers; here the residual
// stream is bf16 between calls, as in the TPU kernels.
//
// Cache layout (this port's own): K/V [B, KH, S, D] int8 a layer, scales
// [B, KH, S] f32, so a block reads one contiguous [t, D] slab.

#include "decode_gemm.cuh"   // the GEMM core, sm90.cuh, common.cuh

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

constexpr int LA_THREADS = 256;
constexpr int LA_HC = 2;   // heads a pass of the logits and of P.V (G > 2: several passes)

// Shared memory (floats) of layer_attn_kernel at position t: q|k|v from the
// slots (G + 2) D, q and k after RoPE (G + 1) D, q rounded to bf16 G D, the
// new K and V rows' codes D / 2, the history rows' K and V scales 2 t, logits
// G t, the self logits and weights 2 G, the P.V partials of the row groups
// (at most 256 threads x 16 columns, LA_HC heads) and the reductions 32
__host__ __device__ inline int layer_attn_floats(int G, int D, int t) {
  return (G + 2) * D + (G + 1) * D + G * D + D / 2 + 2 * t + G * t + 2 * G + 4096 * LA_HC + 32;
}

// The kernel takes heads of D % 32 == 0 dims (up to 1024: a row's 16-byte
// segments on at most 32 lanes, two each), at most D / 32 query heads a kv
// head, at position t (its shared memory fits)
inline bool layer_attn_fits(int G, int D, int t) {
  return D % 32 == 0 && D >= 32 && D <= 1024 && G >= 1 && G <= D / 32 &&
         (size_t)layer_attn_floats(G, D, t) * 4 <= (size_t)DG_STAGE_SMEM;
}

// One (row, kv head) item a block of 256 threads, after the q|k|v product
// left its partial sums in the slots. Logits: a row of D int8 on spw lanes
// (the power of two at or above D / 16, at most 32; SPL 16-byte segments a
// lane), the lane's dims of LA_HC heads' q in registers (from shared memory,
// read with a 64-byte stride between lanes, that would conflict on every
// row), the rows' dot products summed over the row's lanes by shuffles (one
// order); each warp's rows two at a time, the first two asked for first.
// P.V: a thread a (row group, 16-byte column segment), 16 bytes of V a row,
// two rows' loads in flight; the row groups' partials go through shared
// memory with the segment innermost (neighbouring lanes, neighbouring words)
// and are added in row-group order.
template <int SPL>
__global__ void __launch_bounds__(LA_THREADS, SPL == 1 ? 2 : 1)
layer_attn_kernel(const float* __restrict__ slots, const DgPlan p, const float* __restrict__ cosv,
                  const float* __restrict__ sinv, const int8_t* __restrict__ kc,
                  const int8_t* __restrict__ vc, const float* __restrict__ ks,
                  const float* __restrict__ vs, bf16* __restrict__ attn,
                  int8_t* __restrict__ k_new, int8_t* __restrict__ v_new,
                  float* __restrict__ k_sc, float* __restrict__ v_sc, int B, int NH, int KH,
                  int D, int S, int t, float attn_scale, float softcap) {
  extern __shared__ __align__(16) float la_buf[];
  const int G = NH / KH, QHD = NH * D, KHD = KH * D, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int it = blockIdx.x, b = it / KH, kh = it % KH;
  const size_t slab = (size_t)it * S;   // item = b * KH + kh: rows of [B, KH, S]
  float* raw = la_buf;                  // (G + 2) D
  float* qr = raw + (G + 2) * D;        // (G + 1) D
  float* qb = qr + (G + 1) * D;         // G D
  int8_t* kn = reinterpret_cast<int8_t*>(qb + G * D);   // D codes, then the V row's D
  int8_t* vn = kn + D;
  float* kss = qb + G * D + D / 2;      // t, then vss t
  float* vss = kss + t;
  float* lg = vss + t;                  // G t
  float* self_l = lg + G * t;           // G, then self_w G
  float* self_w = self_l + G;
  float* red = self_w + G;              // 4096 LA_HC
  float* rd = red + 4096 * LA_HC;       // 32
  // the lanes of a logits row: nseg segments on spw lanes, SPL a lane
  const int nseg = D / 16;
  int spw = 1;
  while (spw < nseg && spw < 32) spw <<= 1;
  const int rpw = 32 / spw, step = (LA_THREADS / 32) * rpw;
  const int seg = lane % spw;
  // P.V: thread (row group rg, segment sg)
  const int RG = LA_THREADS / nseg, rg = tid / nseg, sg = tid % nseg;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto row_bytes = [&](int j, uint4 (&w)[SPL]) {   // the lane's segments of history row j
#pragma unroll
    for (int u = 0; u < SPL; ++u) {
      const int s = seg + spw * u;
      w[u] = j < t && s < nseg
                 ? __ldg(reinterpret_cast<const uint4*>(kc + (slab + j) * D + 16 * s))
                 : zero;
    }
  };
  auto v_seg = [&](int j) {
    return __ldg(reinterpret_cast<const uint4*>(vc + (slab + j) * D + 16 * sg));
  };
  // Everything the item reads from device memory is asked for first, so that
  // the latencies overlap: the logits' first two rows, P.V's first two rows,
  // the rows' scales, RoPE's rows, and q (G heads), k, v from the slots.
  const int j0 = warp * rpw + lane / spw;
  uint4 kf0[SPL], kf1[SPL];
  row_bytes(j0, kf0);
  row_bytes(j0 + step, kf1);
  const bool pv = rg < RG;
  const uint4 vw0 = pv && rg < t ? v_seg(rg) : zero, vw1 = pv && rg + RG < t ? v_seg(rg + RG) : zero;
  // (the first of each into registers before any is stored: a store into
  // shared memory waits for its load, and the loads behind it with it)
  const float k0 = tid < t ? ks[slab + tid] : 0.f, v0 = tid < t ? vs[slab + tid] : 0.f;
  const float c0 = tid < D ? cosv[tid] : 0.f, s0 = tid < D ? sinv[tid] : 0.f;
  auto col_of = [&](int e) {   // q|k|v column of element e of raw
    const int head = e / D, d = e % D;
    return head < G ? (kh * G + head) * D + d
                    : (head == G ? QHD + kh * D + d : QHD + KHD + kh * D + d);
  };
  const float4 r0 = 4 * tid < (G + 2) * D ? product4(slots, p, b, col_of(4 * tid))
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
  float* cs = red;   // RoPE's rows, in the P.V partials' room until P.V
  if (tid < D) cs[tid] = c0, cs[D + tid] = s0;
  if (4 * tid < (G + 2) * D) *reinterpret_cast<float4*>(raw + 4 * tid) = r0;
  for (int d = tid + LA_THREADS; d < D; d += LA_THREADS) cs[d] = cosv[d], cs[D + d] = sinv[d];
  for (int e = 4 * (tid + LA_THREADS); e < (G + 2) * D; e += 4 * LA_THREADS)
    *reinterpret_cast<float4*>(raw + e) = product4(slots, p, b, col_of(e));
  __syncthreads();
  // RoPE of the q heads and k; q rounded to bf16 for the history's logits
  const int half = D / 2;
  for (int e = tid; e < (G + 1) * D; e += LA_THREADS) {
    const int h0 = e / D * D, d = e % D, dp = d < half ? d + half : d - half;
    const float sign = d < half ? -1.f : 1.f;
    const float v = raw[h0 + d] * cs[d] + sign * raw[h0 + dp] * cs[D + d];
    qr[e] = v;
    if (e < G * D) qb[e] = round_bf16(v);
  }
  __syncthreads();
  // the new K and V, quantized per vector and handed back
  float ka = 0.f, va = 0.f;
  for (int d = tid; d < D; d += LA_THREADS) {
    ka = fmaxf(ka, fabsf(qr[G * D + d]));
    va = fmaxf(va, fabsf(raw[(G + 1) * D + d]));
  }
  const float2 mx = reduce2(ka, va, rd, true, 0, LA_THREADS);
  const float ksc = kv_scale(mx.x), vsc = kv_scale(mx.y);
  for (int d = tid; d < D; d += LA_THREADS) {
    const int8_t kq = kv_code(qr[G * D + d], ksc), vq = kv_code(raw[(G + 1) * D + d], vsc);
    k_new[(size_t)b * KHD + kh * D + d] = kq;
    v_new[(size_t)b * KHD + kh * D + d] = vq;
    kn[d] = kq;
    vn[d] = vq;
  }
  if (tid == 0) {
    k_sc[kh * B + b] = ksc;
    v_sc[kh * B + b] = vsc;
  }
  // the history's scales (from device memory: stored only now, so that no
  // earlier phase waits for them)
  if (tid < t) kss[tid] = k0, vss[tid] = v0;
  for (int j = tid + LA_THREADS; j < t; j += LA_THREADS) kss[j] = ks[slab + j], vss[j] = vs[slab + j];
  __syncthreads();   // kn, kss, vss
  // the self logits: q in f32 against the new row's quantized K, a warp a head
  for (int g = warp; g < G; g += LA_THREADS / 32) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc += qr[g * D + d] * ((float)kn[d] * ksc);
    acc = warp_sum(acc);
    if (lane == 0) self_l[g] = soft_cap(acc * attn_scale, softcap);
  }

  // the history's logits, rows j < t, LA_HC heads a pass: lane (row, segment
  // seg), the pass's q dims of its segments in registers
  for (int g0 = 0; g0 < G; g0 += LA_HC) {
    float q[LA_HC][SPL][16];
#pragma unroll
    for (int h = 0; h < LA_HC; ++h)
#pragma unroll
      for (int u = 0; u < SPL; ++u) {
        const int s = seg + spw * u;
        const bool in = g0 + h < G && s < nseg;
        const float4* qv = reinterpret_cast<const float4*>(qb + (g0 + h) * D + 16 * s);
#pragma unroll
        for (int c = 0; c < 4; ++c) {   // 16 bytes a load: a quarter of the conflicts
          const float4 f = in ? qv[c] : make_float4(0.f, 0.f, 0.f, 0.f);
          q[h][u][4 * c] = f.x, q[h][u][4 * c + 1] = f.y;
          q[h][u][4 * c + 2] = f.z, q[h][u][4 * c + 3] = f.w;
        }
      }
    auto logit = [&](int j, const uint4 (&w)[SPL]) {
      float v[SPL][16];
#pragma unroll
      for (int u = 0; u < SPL; ++u) unpack16(w[u], v[u]);
#pragma unroll
      for (int h = 0; h < LA_HC; ++h) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < SPL; ++u)
#pragma unroll
          for (int e = 0; e < 16; ++e) acc += q[h][u][e] * v[u][e];
        for (int o = spw / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (seg == 0 && j < t && g0 + h < G)
          lg[(g0 + h) * t + j] = soft_cap(acc * kss[j] * attn_scale, softcap);
      }
    };
    for (int jb = warp * rpw; jb < t; jb += 2 * step) {   // the same trips for a warp's lanes
      const int ja = jb + lane / spw;
      uint4 wa[SPL], wn[SPL];
      if (jb == warp * rpw && g0 == 0) {
#pragma unroll
        for (int u = 0; u < SPL; ++u) wa[u] = kf0[u], wn[u] = kf1[u];
      } else {
        row_bytes(ja, wa);
        row_bytes(ja + step, wn);
      }
      logit(ja, wa);
      logit(ja + step, wn);
    }
  }
  __syncthreads();
  // softmax of head g by warp g over the history and the self logit; p times
  // each row's V scale, rounded to bf16
  for (int g = warp; g < G; g += LA_THREADS / 32) {
    float* l = lg + g * t;
    float m = self_l[g];
    for (int j = lane; j < t; j += 32) m = fmaxf(m, l[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < t; j += 32) {
      const float e = expf(l[j] - m);
      l[j] = e;
      sum += e;
    }
    const float e_self = expf(self_l[g] - m);
    const float denom = warp_sum(sum) + e_self;
    for (int j = lane; j < t; j += 32) l[j] = round_bf16(l[j] / denom * vss[j]);
    if (lane == 0) self_w[g] = e_self / denom;
  }
  __syncthreads();
  // P.V, LA_HC heads a pass: thread (rg, sg) over rows rg, rg + RG, ...; its
  // partial of (head h, dim 16 sg + e) at red[((rg LA_HC + h) 16 + e) nseg + sg]
  const int nrg = t < RG ? t : RG;   // row groups that saw a row
  for (int g0 = 0; g0 < G; g0 += LA_HC) {
    float acc[LA_HC][16];
#pragma unroll
    for (int h = 0; h < LA_HC; ++h)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[h][e] = 0.f;
    if (pv) {
      auto v_row = [&](int j, uint4 w) {
        float v[16];
        unpack16(w, v);
#pragma unroll
        for (int h = 0; h < LA_HC; ++h) {
          if (g0 + h >= G) break;
          const float pj = lg[(g0 + h) * t + j];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[h][e] += pj * v[e];
        }
      };
      uint4 w0 = vw0, w1 = vw1;   // rows rg and rg + RG, asked for first
#pragma unroll 1
      for (int j = rg; j < t; j += 2 * RG) {   // two rows' loads in flight
        if (j != rg || g0 != 0) {
          w0 = v_seg(j);
          w1 = j + RG < t ? v_seg(j + RG) : zero;
        }
        v_row(j, w0);
        if (j + RG < t) v_row(j + RG, w1);
      }
      if (rg < nrg) {
#pragma unroll
        for (int h = 0; h < LA_HC; ++h)
#pragma unroll
          for (int e = 0; e < 16; ++e) red[((rg * LA_HC + h) * 16 + e) * nseg + sg] = acc[h][e];
      }
    }
    __syncthreads();
    for (int o = tid; o < LA_HC * D; o += LA_THREADS) {   // o = (h 16 + e) nseg + sg
      const int h = o / D, e = o % D / nseg, s = o % nseg, g = g0 + h, d = 16 * s + e;
      if (g >= G) break;
      float v = 0.f;
#pragma unroll 4
      for (int r = 0; r < nrg; ++r) v += red[r * LA_HC * D + o];
      v += self_w[g] * ((float)vn[d] * vsc);   // the new row through its quantized value
      attn[(size_t)b * QHD + (kh * G + g) * D + d] = __float2bfloat16(v);
    }
    __syncthreads();   // red is read before the next pass writes it
  }
}

}  // namespace

// The attention half of one layer at position t. x, x_out: bf16 [B, H];
// wqkv: int8 [H, (NH + 2 KH) D] and wo: int8 [NH D, H], both in fragment
// order (to_fragments); scales f32; norms bf16 [H]; cos, sin: f32 [D]; kc,
// vc: int8 [B, KH, S, D] and ks, vs: f32 [B, KH, S], read at rows s < t only;
// k_new, v_new: int8 [B, KH D]; k_sc, v_sc: f32 [KH, B]; h: bf16 [B, H] and
// attn: bf16 [B, NH D] scratch; ws the stream-K workspace of n_slots slots
// and n_counters barrier words (stream_k_workspace) for both products.
extern "C" int vbt_fused_attn_step(
    const void* x, const void* wqkv, const void* qkv_scale, const void* wo, const void* o_scale,
    const void* in_norm, const void* post_norm, const void* cosv, const void* sinv,
    const void* kc, const void* vc, const void* ks, const void* vs,
    void* x_out, void* k_new, void* v_new, void* k_sc, void* v_sc,
    void* h, void* attn, void* ws, int n_slots, int n_counters,
    int B, int H, int NH, int KH, int D, int S, int t,
    float attn_scale, float softcap, float eps, void* stream_ptr) {
  if (H > ROW_MAX || KH < 1 || NH % KH != 0 || t < 0 || t >= S ||
      !layer_attn_fits(NH / KH, D, t))
    return (int)cudaErrorInvalidValue;
  VBT_CHECK((cudaError_t)bind_device(x));
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int QHD = NH * D, NQKV = QHD + 2 * KH * D;
  CUtensorMap map_h, map_a, w_qkv, w_o;
  int rc = make_act_map(&map_h, (const bf16*)h, H, B, H, 1);
  if (!rc) rc = make_act_map(&map_a, (const bf16*)attn, QHD, B, QHD, 1);
  if (!rc) rc = make_weight_map(&w_qkv, wqkv, 1, H, NQKV, false);
  if (!rc) rc = make_weight_map(&w_o, wo, 1, QHD, H, false);
  if (rc) return rc;
  const DgWork work = dg_work(ws, n_slots, n_counters);
  DgStage none{}, post{};
  none.kind = DG_NONE;
  post.kind = DG_RMS_BF16;
  post.xb = (const bf16*)x;
  post.wb = (const bf16*)post_norm;
  post.xo = (bf16*)x_out;
  post.eps = eps;

  VBT_ROW_LAUNCH(ls_rms_kernel, H, B, 0, st, (const bf16*)x, (const bf16*)in_norm, (bf16*)h, H,
                 eps);
  VBT_CHECK_LAUNCH();
  rc = launch_i8_gemm_bf16(map_h, w_qkv, 0, (const float*)qkv_scale, nullptr, B, NQKV, H, work,
                           none, st);
  if (rc) return rc;
  // a row's segments on the lanes: one a lane up to D 512, two past it
  static bool allowed[2] = {false, false};
  auto attn_kernel = D <= 512 ? layer_attn_kernel<1> : layer_attn_kernel<2>;
  VBT_CHECK((cudaError_t)allow_smem(attn_kernel, allowed[D <= 512 ? 0 : 1]));
  attn_kernel<<<B * KH, LA_THREADS, layer_attn_floats(NH / KH, D, t) * 4, st>>>(
      work.slots, dg_plan_host(B, NQKV, H, DG1_MIN_UNITS), (const float*)cosv, (const float*)sinv,
      (const int8_t*)kc, (const int8_t*)vc, (const float*)ks, (const float*)vs, (bf16*)attn,
      (int8_t*)k_new, (int8_t*)v_new, (float*)k_sc, (float*)v_sc, B, NH, KH, D, S, t, attn_scale,
      softcap);
  VBT_CHECK_LAUNCH();
  return launch_i8_gemm_bf16(map_a, w_o, 0, (const float*)o_scale, nullptr, B, H, QHD, work, post,
                             st);
}

// The MLP half of one layer. x, x_out: bf16 [B, H]; wgu: int8 [H, 2F], gate
// and up interleaved in runs of 32 (interleave_gate_up), and wd: int8 [F, H],
// both in fragment order; gu_scale [2F] (interleaved alike), d_scale [H] f32;
// norms bf16 [H]; h: bf16 [B, H] and hidden: bf16 [B, F] scratch; ws the
// stream-K workspace for both products.
extern "C" int vbt_fused_mlp_step(
    const void* x, const void* wgu, const void* gu_scale, const void* wd, const void* d_scale,
    const void* pre_norm, const void* post_norm, void* x_out, void* h, void* hidden, void* ws,
    int n_slots, int n_counters, int B, int H, int F, float eps, void* stream_ptr) {
  if (H > ROW_MAX) return (int)cudaErrorInvalidValue;
  VBT_CHECK((cudaError_t)bind_device(x));
  cudaStream_t st = (cudaStream_t)stream_ptr;
  CUtensorMap map_h, map_f, w_gu, w_d;
  int rc = make_act_map(&map_h, (const bf16*)h, H, B, H, 1);
  if (!rc) rc = make_act_map(&map_f, (const bf16*)hidden, F, B, F, 1);
  if (!rc) rc = make_weight_map(&w_gu, wgu, 1, H, 2 * F, false);
  if (!rc) rc = make_weight_map(&w_d, wd, 1, F, H, false);
  if (rc) return rc;
  const DgWork work = dg_work(ws, n_slots, n_counters);
  DgStage geglu{}, post{};
  geglu.kind = DG_GEGLU_BF16;
  geglu.out = (bf16*)hidden;
  geglu.out_ld = F;
  post.kind = DG_RMS_BF16;
  post.xb = (const bf16*)x;
  post.wb = (const bf16*)post_norm;
  post.xo = (bf16*)x_out;
  post.eps = eps;

  VBT_ROW_LAUNCH(ls_rms_kernel, H, B, 0, st, (const bf16*)x, (const bf16*)pre_norm, (bf16*)h, H,
                 eps);
  VBT_CHECK_LAUNCH();
  rc = launch_i8_gemm_bf16(map_h, w_gu, 0, (const float*)gu_scale, nullptr, B, 2 * F, H, work,
                           geglu, st);
  if (rc) return rc;
  return launch_i8_gemm_bf16(map_f, w_d, 0, (const float*)d_scale, nullptr, B, H, F, work, post,
                             st);
}
