// The Gemma-2 GeGLU MLP over nibble-packed int4 weights, in one call:
//   int4_mlp   y = (bf16(gelu_tanh(x.G4) * (x.U4)) . D4)                 bf16 out
// where W4 stands for a weight dequantized with one scale per output channel
// or one per (group of rows, output channel).
//
// Replaces: vlm_bridge_tpu/ops/quant.py:int4_mlp (bodies _int4_mlp_kernel and
// _int4_mlp_group_kernel). The TPU kernels walk the F blocks in order and
// carry the down projection's f32 sum in VMEM; here blocks run in parallel,
// the contraction is a loop inside the block, and where it is split over
// blocks a second kernel adds the slices (linear_common.cuh), as in
// int8_linear.cu.
//
// Bound: at decode (M = batch = 64 rows) each weight byte feeds 128
// multiply-adds, below the ~295 operations per byte at which the H100's bf16
// tensor cores, not its 3.35 TB/s of HBM, become the limit: the least time is
// the weights' bytes over the memory rate (31.9 MB of nibbles and 2.0 MB of
// group scales for Gemma-2-2B's MLP, half of int8_mlp's).
//
// Design: int8_linear.cu's product kernel, at two nibbles a byte. The
// weights are read in the layout the JAX package's quantizers give them and
// no copy in another order is kept: gate and up packed over the whole
// contraction (byte row p of [H/2, F] holds rows p and p + H/2:
// quantize_int4, "global"), down packed block by block (inside each block
// of block_f rows, byte row r holds rows r and r + block_f/2:
// repack_down_blockwise). Both are one rule with a half-width `half`:
// packed row p holds row lo(p) = (p / half) * 2 * half + p % half in its
// low nibbles and row lo(p) + half in its high nibbles. cp.async brings KC
// packed rows of both weight sources and the TWO matching 64 x KC tiles of x
// into a ring of STAGES shared-memory stages. A stage is multiplied in two
// passes, low nibbles against the first x tile, high nibbles against the
// second: ldmatrix.trans on pairs of bytes hands each lane packed bytes
// (k, n), (k, n+1), (k+1, n), (k+1, n+1), whose nibbles widen in registers
// (common.cuh:nib_pair, exact) into the B fragments of an even-column and an
// odd-column n8 tile, exactly as the int8 kernel widens bytes.
//
// Scales per group vary along the contraction and cannot fold into one
// output multiply. A stage never straddles a group (the group size is a
// multiple of KC), so with groups each pass runs into a partial
// accumulator, which is added into the sum times scale[group, column] when
// the pass ends; the slices then leave the block already scaled and the
// second kernel gets no scale. With one scale per channel both passes add
// straight into the sum and the second kernel scales, as for int8. The
// slices are added in a fixed order: the same inputs give the same bits.

#include "common.cuh"
#include "linear_common.cuh"

namespace {

constexpr int BM = 64;                 // rows of x per block
constexpr int BNH = 64;                // columns per weight source per block
constexpr int KC = 64;                 // packed rows of the weights per stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;
constexpr int X_LD = KC + 8;           // bf16 per x row (ldmatrix conflict-free)
constexpr int W_LD = BNH + 16;         // bytes per weight row (80: conflict-free)
constexpr int X_TILE = BM * X_LD;      // bf16 elements of one x tile
constexpr int X_STAGE = 2 * X_TILE;    // low-nibble rows' tile, then high-nibble rows'
constexpr int W_STAGE = 2 * KC * W_LD; // bytes, both sources
constexpr int SMEM_BYTES = STAGES * (X_STAGE * 2 + W_STAGE);

// w holds packed bytes (k, n), (k, n+1), (k+1, n), (k+1, n+1) from low byte to
// high; pass 0 takes their low nibbles, pass 1 their high nibbles.
// even = bf16x2 {(k, n), (k+1, n)}, odd = bf16x2 {(k, n+1), (k+1, n+1)}.
__device__ __forceinline__ void widen_nibble_pairs(uint32_t w, int pass, uint32_t& even,
                                                   uint32_t& odd) {
  const uint32_t wb = w ^ 0x88888888u;
  const int sh = 4 * pass;
  even = nib_pair(wb, sh, 16 + sh);
  odd = nib_pair(wb, 8 + sh, 24 + sh);
}

// P[split][source][M][N] (one source when W1 is null) = f32 sums of
// X[M, 2 Kp] (bf16) . W4[2 Kp, N] (int4, Kp packed rows of N bytes) over
// this block's slice of the packed rows; raw sums when !GROUPED, sums of
// group partials times S[group, N] when GROUPED.
// grid = (column tiles, splits, row tiles).
template <bool GROUPED>
__global__ void __launch_bounds__(THREADS)
i4l_product_kernel(const bf16* __restrict__ X, const uint8_t* __restrict__ W0,
                   const uint8_t* __restrict__ W1, const float* __restrict__ S0,
                   const float* __restrict__ S1, float* __restrict__ P, int M, int N, int Kp,
                   int half, int group, int k_per_split) {
  extern __shared__ __align__(16) unsigned char i4l_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(i4l_smem);                              // [STAGES][2][BM][X_LD]
  uint8_t* Ws = reinterpret_cast<uint8_t*>(i4l_smem) + STAGES * X_STAGE * 2;  // [STAGES][2][KC][W_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool dual = W1 != nullptr;
  const int K = 2 * Kp;
  const int m0 = blockIdx.z * BM;
  const int p_begin = blockIdx.y * k_per_split;
  const int p_end = min(Kp, p_begin + k_per_split);
  const int n_iters = p_end > p_begin ? (p_end - p_begin + KC - 1) / KC : 0;
  const uint8_t* const src0 = W0;
  const uint8_t* const src1 = dual ? W1 : W0;
  const float* const sc0 = S0;
  const float* const sc1 = dual ? S1 : S0;
  const int col0 = dual ? blockIdx.x * BNH : blockIdx.x * 2 * BNH;  // first column, source 0
  const int col1 = dual ? col0 : col0 + BNH;                         // first column, source 1

  // first row of x's columns that the low nibbles of packed row p multiply
  auto lo_row = [&](int p) { return (p / half) * 2 * half + p % half; };

  auto load_stage = [&](int stage, int p0) {
    bf16* xs = Xs + stage * X_STAGE;
    uint8_t* ws = Ws + stage * W_STAGE;
    const int lo = lo_row(p0);
    for (int i = tid; i < 2 * BM * KC / 8; i += THREADS) {
      const int pass = i / (BM * KC / 8), ii = i % (BM * KC / 8);
      const int r = ii / (KC / 8), c = (ii % (KC / 8)) * 8;
      const bool ok = (m0 + r < M) && (p0 + c < p_end);
      const bf16* src = ok ? X + (size_t)(m0 + r) * K + lo + pass * half + c : X;
      cp_async16(xs + pass * X_TILE + r * X_LD + c, src, ok);
    }
    for (int i = tid; i < KC * BNH / 16; i += THREADS) {
      const int r = i >> 2, c = (i & 3) * 16;
      const bool row_ok = p0 + r < p_end;
      const bool ok0 = row_ok && (col0 + c < N);
      const bool ok1 = row_ok && (col1 + c < N);
      const size_t off = (size_t)(p0 + r) * N + c;
      cp_async16(ws + r * W_LD + c, ok0 ? src0 + off + col0 : src0, ok0);
      cp_async16(ws + KC * W_LD + r * W_LD + c, ok1 ? src1 + off + col1 : src1, ok1);
    }
  };

  float acc[4][2][2][4];   // [m16 tile][source][even/odd columns][fragment]
  float part[4][2][2][4];  // one pass's sums, GROUPED only
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][s][p][e] = part[m][s][p][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iters) load_stage(s, p_begin + s * KC);
    cp_async_commit();
  }

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<STAGES - 2>();   // stage `it` has landed (this thread's part)
    __syncthreads();               // ... everyone's part; stage it - 1 is free
    const int nxt = it + STAGES - 1;
    if (nxt < n_iters) load_stage(nxt % STAGES, p_begin + nxt * KC);
    cp_async_commit();

    const bf16* xs = Xs + (it % STAGES) * X_STAGE;
    const uint8_t* ws = Ws + (it % STAGES) * W_STAGE;
    const int lo = lo_row(p_begin + it * KC);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const bf16* xa = xs + pass * X_TILE;
#pragma unroll
      for (int ks = 0; ks < KC / 16; ++ks) {
        // four 8 x 16-byte blocks: source (lane >> 4), rows 16 ks + 8 ((lane >> 3) & 1)
        // + (lane & 7), this warp's 16 columns
        uint32_t raw[4];
        ldmatrix_x4_trans(raw, ws + (lane >> 4) * (KC * W_LD) +
                                   (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * W_LD +
                                   warp * 16);
        uint32_t b[2][2][2];  // [source][even/odd][k 0..7 | k 8..15]
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          widen_nibble_pairs(raw[2 * s], pass, b[s][0][0], b[s][1][0]);
          widen_nibble_pairs(raw[2 * s + 1], pass, b[s][0][1], b[s][1][1]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          uint32_t a[4];
          ldmatrix_x4(a, xa + (m * 16 + (lane & 15)) * X_LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int p = 0; p < 2; ++p) {
              if (GROUPED)
                mma_bf16(part[m][s][p], a, b[s][p][0], b[s][p][1]);
              else
                mma_bf16(acc[m][s][p], a, b[s][p][0], b[s][p][1]);
            }
        }
      }
      if (GROUPED) {
        // acc[m][s][p][2 hh + e] sits at column base + 2 e + p (see the store below)
        const size_t srow = (size_t)((lo + pass * half) / group) * N;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int col = (s ? col1 : col0) + warp * 16 + 4 * t;
          float4 sv = make_float4(0.f, 0.f, 0.f, 0.f);
          if (col < N) sv = *reinterpret_cast<const float4*>((s ? sc1 : sc0) + srow + col);
          const float sve[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int p = 0; p < 2; ++p)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[m][s][p][e] += part[m][s][p][e] * sve[2 * (e & 1) + p];
                part[m][s][p][e] = 0.f;
              }
        }
      }
    }
  }
  cp_async_wait<0>();

  // tile column j of the even tile is column 2 j of the warp's 16, of the odd
  // tile 2 j + 1; a lane holds tile columns 2t, 2t + 1 of rows g and g + 8:
  // four adjacent columns 4t .. 4t + 3
  const int nsrc = dual ? 2 : 1;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int col = (s ? col1 : col0) + warp * 16 + 4 * t;
    if (col >= N) continue;
    float* base = P + ((size_t)blockIdx.y * nsrc + (dual ? s : 0)) * M * N;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + m * 16 + g + hh * 8;
        if (row >= M) continue;
        const float4 v = make_float4(acc[m][s][0][2 * hh], acc[m][s][1][2 * hh],
                                     acc[m][s][0][2 * hh + 1], acc[m][s][1][2 * hh + 1]);
        *reinterpret_cast<float4*>(base + (size_t)row * N + col) = v;
      }
  }
}

// X[M, 2 Kp] . W4 (Kp packed rows, `half` as in the header); group == 0: raw
// sums, else sums scaled by S[row / group, N].
template <bool GROUPED>
int launch_product4(const bf16* X, const uint8_t* W0, const uint8_t* W1, const float* S0,
                    const float* S1, float* P, int M, int N, int Kp, int half, int group,
                    int splits, cudaStream_t st) {
  if (N % 16 != 0 || half <= 0 || half % KC != 0 || Kp % half != 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (GROUPED && (group <= 0 || group % KC != 0 || half % group != 0))
    return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(i4l_product_kernel<GROUPED>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
    allowed = true;
  }
  const int chunks = Kp / KC;
  const int k_per_split = ((chunks + splits - 1) / splits) * KC;
  const int tile = W1 != nullptr ? BNH : 2 * BNH;
  dim3 grid((N + tile - 1) / tile, splits, (M + BM - 1) / BM);
  i4l_product_kernel<GROUPED><<<grid, THREADS, SMEM_BYTES, st>>>(X, W0, W1, S0, S1, P, M, N, Kp,
                                                                 half, group, k_per_split);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Gemma's GeGLU MLP over int4 weights. gate, up: packed [H/2, F] (global);
// down: packed [F/2, H] (block-local, block_f); group == 0: scales gs, us [F]
// and ds [H], else gs, us [H/group, F] and ds [F/group, H]. part: f32 scratch
// of max(2 * splits1 * M * F, splits2 * M * H); hidden: bf16 [M, F].
extern "C" int vbt_int4_mlp(const void* x, const void* gate, const void* up, const void* gs,
                            const void* us, const void* down, const void* ds, void* part,
                            void* hidden, void* y, int M, int H, int F, int block_f, int group,
                            int splits1, int splits2, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const uint8_t *g4 = (const uint8_t*)gate, *u4 = (const uint8_t*)up, *d4 = (const uint8_t*)down;
  const float *gsf = (const float*)gs, *usf = (const float*)us, *dsf = (const float*)ds;
  float* P = (float*)part;
  if (H % 2 != 0 || block_f % 2 != 0 || F % 2 != 0) return (int)cudaErrorInvalidValue;
  int rc;
  if (group == 0) {
    rc = launch_product4<false>((const bf16*)x, g4, u4, nullptr, nullptr, P, M, F, H / 2, H / 2,
                                0, splits1, st);
    if (rc != 0) return rc;
    rc = launch_epilogue<EPI_GEGLU>(P, splits1, M, F, gsf, usf, nullptr, (bf16*)hidden, st);
    if (rc != 0) return rc;
    rc = launch_product4<false>((const bf16*)hidden, d4, nullptr, nullptr, nullptr, P, M, H,
                                F / 2, block_f / 2, 0, splits2, st);
    if (rc != 0) return rc;
    return launch_epilogue<EPI_SCALE>(P, splits2, M, H, dsf, nullptr, nullptr, (bf16*)y, st);
  }
  rc = launch_product4<true>((const bf16*)x, g4, u4, gsf, usf, P, M, F, H / 2, H / 2, group,
                             splits1, st);
  if (rc != 0) return rc;
  rc = launch_epilogue<EPI_GEGLU>(P, splits1, M, F, nullptr, nullptr, nullptr, (bf16*)hidden, st);
  if (rc != 0) return rc;
  rc = launch_product4<true>((const bf16*)hidden, d4, nullptr, dsf, nullptr, P, M, H, F / 2,
                             block_f / 2, group, splits2, st);
  if (rc != 0) return rc;
  return launch_epilogue<EPI_SCALE>(P, splits2, M, H, nullptr, nullptr, nullptr, (bf16*)y, st);
}
