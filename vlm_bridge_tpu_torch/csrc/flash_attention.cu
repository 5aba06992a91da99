// Flash attention for training: backward dq and backward dk/dv (the forward
// is flash_fwd.cu).
//
// Replaces: the two pallas_calls of
// vlm_bridge_tpu/ops/flash_attention.py:_flash_bwd (bodies _bwd_dq_kernel and
// _bwd_dkv_kernel) with fa_bwd_dq_kernel and fa_bwd_dkv_kernel.
//
// What they compute. q [B, T, H, D], k/v [B, S, KH, D] bf16 in the package's
// layout (offsets are computed from it; nothing is transposed), G = H / KH
// query heads per kv head, kv_lens [B]. Logits = (q . k) * scale in f32 from
// bf16 operands, then tanh(x / cap) * cap, then the mask
//   kpos < kv_len  and  (causal: kpos <= qpos)  and  (window: kpos > qpos - W)
// with qpos = t + q_offset. From the forward's out and per-row logsumexp
// lse [B, H, T] (f32) the backward recomputes p = exp(logits - lse) per
// tile (zero where masked) and
//   dv += p^T . do       dp = do . v^T       ds = p (dp - delta) dcap scale
//   dq += ds . k         dk += ds^T . q      dcap = 1 - tanh^2
// with p and ds rounded to bf16 before their products and f32 sums.
//
// Bound: bytes. At the train step's Gemma shape (B 8, T = S 256, H 8, KH 4,
// D 256) a call reads and writes about 34 MB (10 us at 3.35 TB/s) and does
// about 3-4 GFLOP on its causal half (3-4 us at the bf16 tensor-core peak).
// What the design has to keep is that the [T, S] logits never reach device
// memory and that tiles outside kv_len, the causal diagonal and the window
// are skipped, not masked.
//
// Design. The TPU grid's sequential k-block axis is a loop inside the block
// here. A block owns a tile of "row" positions (64 queries in dq, 64 keys in
// dk/dv), one warp per 16 rows, and loops over tiles of the other sequence.
// Both products of a step run on the tensor cores with mma.sync m16n8k16: the
// first (rows . cols^T, contraction over D) reads both operands from shared
// memory; its f32 result stays in registers, is turned into p or ds there,
// and is fed as the A operand of the second product without a round trip
// (the accumulator layout of two adjacent 8-column tiles is the A layout of
// one 16-deep step). The second product's B operand (v, k, do or q, with
// the contraction running over rows) comes through ldmatrix.trans. The dk/dv
// kernel computes the transposed scores k . q^T directly, so the same code
// serves it; one block owns a (batch, kv head, key tile), loops over its G
// query heads and the query tiles, and so needs no atomics and gives the
// same bits from run to run. At D = 64 and 128 the block holds both the dv and
// the dk accumulator and computes the scores once (4 products a tile). At
// D = 256 two f32 accumulators of 16 x 256 a warp do not fit the register
// file, so blockIdx.z splits dv and dk into two blocks (dv: 2 products a
// tile, dk: 3, the scores twice). Rows past T or S are zero-filled in
// shared memory and masked, so no length need be a multiple of a tile.

#include "common.cuh"

namespace {

constexpr int FA_ROWS = 64;      // rows a block owns; one warp per 16
constexpr int FA_THREADS = 128;

struct FaParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse_in;
  const float* delta;
  const int* kv_lens;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int B, T, S, H, KH;
  int causal, window, q_offset;   // window <= 0: none
  float scale, softcap;           // softcap <= 0: none
};

// Rows [row0, row0 + R) of one head of a [*, L, NH, D] tensor -> shared
// [R][D + 8]; `src` points at (b, 0, head, 0), rows are row_stride apart.
// Rows at or past L are zero.
template <int D, int R>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0, int L,
                                          size_t row_stride) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CH; i += FA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

// x[16 x NC] = As[16 rows of this warp][D] . Bs[NC][D]^T, f32, both in
// shared memory with row pitch D + 8. Lane (g = lane / 4, t = lane % 4)
// holds x[j][0..1] = (row g, cols 8 j + 2 t, + 1) and x[j][2..3] = row g + 8.
template <int D, int NC>
__device__ __forceinline__ void gemm_nt(float (&x)[NC / 8][4], const bf16* As, const bf16* Bs) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) x[j][r] = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < D; k0 += 16) {
    const bf16* ap = As + g * LD + k0 + t * 2;
    uint32_t a[4];
    a[0] = *reinterpret_cast<const uint32_t*>(ap);
    a[1] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD);
    a[2] = *reinterpret_cast<const uint32_t*>(ap + 8);
    a[3] = *reinterpret_cast<const uint32_t*>(ap + 8 * LD + 8);
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const bf16* bp = Bs + (j * 8 + g) * LD + k0 + t * 2;
      mma_bf16(x[j], a, *reinterpret_cast<const uint32_t*>(bp),
               *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// acc[16 x D] += bf16(x[16 x NC]) . Ws[NC][D]; x in gemm_nt's layout, Ws in
// shared memory with row pitch D + 8 (contraction over its rows).
template <int D, int NC>
__device__ __forceinline__ void gemm_acc(float (&acc)[D / 8][4], const float (&x)[NC / 8][4],
                                         const bf16* Ws) {
  constexpr int LD = D + 8;
  const int lane = threadIdx.x & 31, mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NC / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    // four 8x8 blocks: rows 16 kk + 8 (mi & 1) + r, columns 8 (nt + (mi >> 1))
    const bf16* wp = Ws + (kk * 16 + (mi & 1) * 8 + r) * LD + (mi >> 1) * 8;
#pragma unroll
    for (int nt = 0; nt < D / 8; nt += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, wp + nt * 8);
      mma_bf16(acc[nt], a, b[0], b[1]);
      mma_bf16(acc[nt + 1], a, b[2], b[3]);
    }
  }
}

// Capped logit and its derivative factor from the raw product.
__device__ __forceinline__ float cap_logit(float raw, float scale, float softcap, float& dcap) {
  float s = raw * scale;
  dcap = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = th * softcap;
    dcap = 1.f - th * th;
  }
  return s;
}

// Store a warp's 16 x D f32 accumulator as bf16 rows of a [*, L, NH, D] tensor.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, size_t row_stride, int row0, int L,
                                           const float (&acc)[D / 8][4], float mul0, float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = row0 + g, r1 = row0 + g + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + t * 2;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r0 * row_stride + c) =
          pack_bf16(acc[nt][0] * mul0, acc[nt][1] * mul0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(dst + (size_t)r1 * row_stride + c) =
          pack_bf16(acc[nt][2] * mul1, acc[nt][3] * mul1);
  }
}

// ------------------------------------------------------------ backward dq

template <int D, int BN>
__global__ void __launch_bounds__(FA_THREADS) fa_bwd_dq_kernel(const FaParams p) {
  constexpr int LD = D + 8, BM = FA_ROWS;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(fa_smem);
  bf16* dOs = Qs + BM * LD;
  bf16* Ks = dOs + BM * LD;
  bf16* Vs = Ks + BN * LD;

  const int b = blockIdx.y / p.H, h = blockIdx.y % p.H, kh = h / (p.H / p.KH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row_tile = blockIdx.x * BM;
  const int q_start = row_tile + p.q_offset;
  const int kv_len = min(p.kv_lens[b], p.S);
  const size_t q_stride = (size_t)p.H * D, k_stride = (size_t)p.KH * D;
  const size_t q_base = ((size_t)b * p.T * p.H + h) * D;
  const bf16* kg = p.k + ((size_t)b * p.S * p.KH + kh) * D;
  const bf16* vg = p.v + ((size_t)b * p.S * p.KH + kh) * D;

  load_tile<D, BM>(Qs, p.q + q_base, row_tile, p.T, q_stride);
  load_tile<D, BM>(dOs, p.dout + q_base, row_tile, p.T, q_stride);

  // this lane's two rows: lse and delta (0 for rows past T, which are not stored)
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_tile + warp * 16 + g + i * 8;
    const size_t at = ((size_t)b * p.H + h) * p.T + row;
    lse[i] = row < p.T ? p.lse_in[at] : 0.f;
    delta[i] = row < p.T ? p.delta[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;

  int lo, hi;
  key_tile_range(q_start, BM, BN, kv_len, p.S, p.causal, p.window, lo, hi);
  const int qpos0 = q_start + warp * 16 + g;

  for (int j = lo; j < hi; ++j) {
    const int k_start = j * BN;
    __syncthreads();
    load_tile<D, BN>(Ks, kg, k_start, p.S, k_stride);
    load_tile<D, BN>(Vs, vg, k_start, p.S, k_stride);
    __syncthreads();

    float s[BN / 8][4], dp[BN / 8][4];
    gemm_nt<D, BN>(s, Qs + warp * 16 * LD, Ks);
    gemm_nt<D, BN>(dp, dOs + warp * 16 * LD, Vs);
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float dcap;
        const float capped = cap_logit(s[jn][r], p.scale, p.softcap, dcap);
        const int qpos = qpos0 + (r >> 1) * 8, kpos = k_start + jn * 8 + t * 2 + (r & 1);
        const bool keep = attends(qpos, kpos, kv_len, p.causal, p.window);
        const float pv = keep ? __expf(capped - lse[r >> 1]) : 0.f;
        s[jn][r] = pv * (dp[jn][r] - delta[r >> 1]) * dcap * p.scale;  // ds
      }
    gemm_acc<D, BN>(acc, s, Ks);
  }
  store_rows<D>(p.dq + q_base, q_stride, row_tile + warp * 16, p.T, acc, 1.f, 1.f);
}

// --------------------------------------------------------- backward dk/dv

// What a dk/dv block accumulates: dv alone, dk alone, or both.
constexpr int FA_DV = 0, FA_DK = 1, FA_BOTH = 2;

// One (batch, kv head, key tile). The scores are computed transposed (keys
// as rows), so lse and delta go by column.
template <int D, int BC, int MODE>
__device__ __forceinline__ void fa_bwd_dkv_body(const FaParams& p) {
  constexpr int LD = D + 8, BR = FA_ROWS;
  constexpr bool DV = MODE != FA_DK, DK = MODE != FA_DV;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(fa_smem);
  bf16* Vs = Ks + BR * LD;
  bf16* Qs = Vs + BR * LD;
  bf16* dOs = Qs + BC * LD;
  float* lse_s = reinterpret_cast<float*>(dOs + BC * LD);
  float* delta_s = lse_s + BC;

  const int G = p.H / p.KH;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k_start = blockIdx.x * BR;
  const int kv_len = min(p.kv_lens[b], p.S);
  const size_t q_stride = (size_t)p.H * D, k_stride = (size_t)p.KH * D;
  const size_t k_base = ((size_t)b * p.S * p.KH + kh) * D;

  // one accumulator a result; the unused one of a split block is one tile
  float acc_v[DV ? D / 8 : 1][4], acc_k[DK ? D / 8 : 1][4];
#pragma unroll
  for (int nt = 0; nt < (DV ? D / 8 : 1); ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_v[nt][r] = 0.f;
#pragma unroll
  for (int nt = 0; nt < (DK ? D / 8 : 1); ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_k[nt][r] = 0.f;

  // query tiles [lo, hi) of BC rows that see a key of this tile
  int lo = 0, hi = 0;
  if (k_start < kv_len) {
    hi = (p.T + BC - 1) / BC;
    if (p.causal) {
      const int first = k_start - p.q_offset;  // first query position at or past the tile's first key
      if (first > 0) lo = first / BC;
    }
    if (p.window > 0) {
      // a query tile starting at q0 reaches back to q0 - window + 1
      const int last_q0 = k_start + BR - 2 + p.window - p.q_offset;
      hi = last_q0 < 0 ? 0 : min(hi, last_q0 / BC + 1);
    }
  }

  if (lo < hi) {
    load_tile<D, BR>(Ks, p.k + k_base, k_start, p.S, k_stride);
    if (DK) load_tile<D, BR>(Vs, p.v + k_base, k_start, p.S, k_stride);
  }
  const int kpos0 = k_start + warp * 16 + g;

  for (int gi = 0; gi < G; ++gi) {
    const int h = kh * G + gi;
    const size_t q_base = ((size_t)b * p.T * p.H + h) * D;
    const size_t row_base = ((size_t)b * p.H + h) * p.T;
    for (int i = lo; i < hi; ++i) {
      const int q_row0 = i * BC;
      __syncthreads();
      load_tile<D, BC>(Qs, p.q + q_base, q_row0, p.T, q_stride);
      load_tile<D, BC>(dOs, p.dout + q_base, q_row0, p.T, q_stride);
      for (int c = threadIdx.x; c < BC; c += FA_THREADS) {
        const bool in = q_row0 + c < p.T;
        lse_s[c] = in ? p.lse_in[row_base + q_row0 + c] : 0.f;
        delta_s[c] = in ? p.delta[row_base + q_row0 + c] : 0.f;
      }
      __syncthreads();

      float s[BC / 8][4], dp[DK ? BC / 8 : 1][4];
      gemm_nt<D, BC>(s, Ks + warp * 16 * LD, Qs);  // s^T: rows keys, columns queries
      if constexpr (DK) gemm_nt<D, BC>(dp, Vs + warp * 16 * LD, dOs);  // dp^T = v . do^T
#pragma unroll
      for (int jn = 0; jn < BC / 8; ++jn)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float dcap;
          const float capped = cap_logit(s[jn][r], p.scale, p.softcap, dcap);
          const int col = jn * 8 + t * 2 + (r & 1);
          const int qrow = q_row0 + col, kpos = kpos0 + (r >> 1) * 8;
          const bool keep = qrow < p.T &&
                            attends(qrow + p.q_offset, kpos, kv_len, p.causal, p.window);
          const float pv = keep ? __expf(capped - lse_s[col]) : 0.f;
          s[jn][r] = pv;  // p^T
          if constexpr (DK) dp[jn][r] = pv * (dp[jn][r] - delta_s[col]) * dcap * p.scale;  // ds^T
        }
      if constexpr (DV) gemm_acc<D, BC>(acc_v, s, dOs);  // dv += p^T . do
      if constexpr (DK) gemm_acc<D, BC>(acc_k, dp, Qs);  // dk += ds^T . q
    }
  }
  if constexpr (DV)
    store_rows<D>(p.dv + k_base, k_stride, k_start + warp * 16, p.S, acc_v, 1.f, 1.f);
  if constexpr (DK)
    store_rows<D>(p.dk + k_base, k_stride, k_start + warp * 16, p.S, acc_k, 1.f, 1.f);
}

// FUSED: one block holds both accumulators and computes the scores once;
// else blockIdx.z splits dv and dk into two blocks.
template <int D, int BC, bool FUSED>
__global__ void __launch_bounds__(FA_THREADS) fa_bwd_dkv_kernel(const FaParams p) {
  if constexpr (FUSED)
    fa_bwd_dkv_body<D, BC, FA_BOTH>(p);
  else if (blockIdx.z == 0)
    fa_bwd_dkv_body<D, BC, FA_DV>(p);
  else
    fa_bwd_dkv_body<D, BC, FA_DK>(p);
}

// ------------------------------------------------------------ host side

// Tile of the looped sequence: 64, or 32 at D = 256 in the backward, where
// two 16 x 64 f32 score tiles beside the 16 x 256 accumulator would spill.
// Largest D whose dk/dv block holds both accumulators (-DFA_DKV_FUSED_MAX_D=0
// builds the split form at every D, to time the two against each other).
#ifndef FA_DKV_FUSED_MAX_D
#define FA_DKV_FUSED_MAX_D 128
#endif
template <int D> struct FaTiles {
  static constexpr int BWD_BN = D == 256 ? 32 : 64;
  static constexpr bool DKV_FUSED = D <= FA_DKV_FUSED_MAX_D;
  // two 16 x 128 accumulators beside two 16 x 64 score tiles spill; 32 columns do not
  static constexpr int DKV_BC = (D == 128 && DKV_FUSED) ? 32 : BWD_BN;
};

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_bwd_dq(const FaParams& p, cudaStream_t st) {
  constexpr int BN = FaTiles<D>::BWD_BN;
  constexpr int smem = (2 * FA_ROWS + 2 * BN) * (D + 8) * 2;
  static int attr = allow_smem(fa_bwd_dq_kernel<D, BN>, smem);
  if (attr != 0) return attr;
  dim3 grid((p.T + FA_ROWS - 1) / FA_ROWS, p.B * p.H);
  fa_bwd_dq_kernel<D, BN><<<grid, FA_THREADS, smem, st>>>(p);
  VBT_CHECK_LAUNCH();
  return 0;
}

template <int D>
int launch_bwd_dkv(const FaParams& p, cudaStream_t st) {
  constexpr int BC = FaTiles<D>::DKV_BC;
  constexpr bool FUSED = FaTiles<D>::DKV_FUSED;
  constexpr int smem = (2 * FA_ROWS + 2 * BC) * (D + 8) * 2 + 2 * BC * 4;
  static int attr = allow_smem(fa_bwd_dkv_kernel<D, BC, FUSED>, smem);
  if (attr != 0) return attr;
  dim3 grid((p.S + FA_ROWS - 1) / FA_ROWS, p.B * p.KH, FUSED ? 1 : 2);
  fa_bwd_dkv_kernel<D, BC, FUSED><<<grid, FA_THREADS, smem, st>>>(p);
  VBT_CHECK_LAUNCH();
  return 0;
}

bool fa_shape_ok(int B, int T, int S, int H, int KH, int D) {
  return B > 0 && T > 0 && S > 0 && H > 0 && KH > 0 && H % KH == 0 &&
         (D == 64 || D == 128 || D == 256) && (long long)B * H <= 65535 &&
         (long long)B * KH <= 65535;
}

FaParams fa_params(int B, int T, int S, int H, int KH, int causal, int window, float scale,
                   float softcap) {
  FaParams p = {};
  p.B = B; p.T = T; p.S = S; p.H = H; p.KH = KH;
  p.causal = causal; p.window = window; p.q_offset = causal ? S - T : 0;
  p.scale = scale; p.softcap = softcap;
  return p;
}

}  // namespace

#define FA_DISPATCH(D, fn, p, st)                   \
  ((D) == 256 ? fn<256>(p, st) : (D) == 128 ? fn<128>(p, st) : fn<64>(p, st))

extern "C" int vbt_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          const void* kv_lens, void* dq, int B, int T, int S,
                                          int H, int KH, int D, int causal, int window,
                                          float scale, float softcap, void* stream_ptr) {
  if (!fa_shape_ok(B, T, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  FaParams p = fa_params(B, T, S, H, KH, causal, window, scale, softcap);
  p.q = (const bf16*)q; p.k = (const bf16*)k; p.v = (const bf16*)v; p.dout = (const bf16*)dout;
  p.lse_in = (const float*)lse; p.delta = (const float*)delta;
  p.kv_lens = (const int*)kv_lens; p.dq = (bf16*)dq;
  return FA_DISPATCH(D, launch_bwd_dq, p, (cudaStream_t)stream_ptr);
}

extern "C" int vbt_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           const void* kv_lens, void* dk, void* dv, int B, int T,
                                           int S, int H, int KH, int D, int causal, int window,
                                           float scale, float softcap, void* stream_ptr) {
  if (!fa_shape_ok(B, T, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  FaParams p = fa_params(B, T, S, H, KH, causal, window, scale, softcap);
  p.q = (const bf16*)q; p.k = (const bf16*)k; p.v = (const bf16*)v; p.dout = (const bf16*)dout;
  p.lse_in = (const float*)lse; p.delta = (const float*)delta;
  p.kv_lens = (const int*)kv_lens; p.dk = (bf16*)dk; p.dv = (bf16*)dv;
  return FA_DISPATCH(D, launch_bwd_dkv, p, (cudaStream_t)stream_ptr);
}
