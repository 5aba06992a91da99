// Int8-weight linear layers over row-major [in, out] weights:
//   int8_matmul  y = (x . W) * scale                                  bf16 out
//   int8_mlp     y = (bf16(gelu_tanh(x.G * gs) * (x.U * us)) . D) * ds
//   int8_ffn     y = (bf16(gelu_erf(x.F1 * s1 + b1)) . F2) * s2 + b2
//
// Replaces: vlm_bridge_tpu/ops/quant.py:int8_matmul (body _int8_mm_kernel),
// vlm_bridge_tpu/ops/quant.py:int8_mlp (body _int8_mlp_kernel) and
// vlm_bridge_tpu/ops/quant.py:int8_ffn (body _int8_ffn_kernel). The TPU
// kernels walk a sequential grid and carry an f32 accumulator in VMEM from
// one step to the next; here blocks run in parallel, so the contraction is
// a loop inside the block and, where it is split over blocks, a second
// kernel adds the slices.
//
// Bound: at decode (M = batch = 64 rows) each weight byte feeds 64
// multiply-adds, far below the ~295 operations per byte at which the H100's
// bf16 tensor cores, not its 3.35 TB/s of HBM, become the limit: the least
// time is the weights' bytes over the memory rate (9.4 MB for Gemma-2-2B's
// fused qkv, 63.7 MB for its MLP).
//
// Design. One product kernel serves all three functions. A block of four
// warps owns 64 rows of x and 64 columns of each of two weight sources:
// the two halves of a 128-column tile of one matrix, or the same 64 columns
// of gate and up (so the GeGLU's two operands meet in one thread). The
// weights stay in the layout quantize_int8 gives them, int8 [in, out] with
// `out` contiguous: no second copy in another order is kept. cp.async
// brings KC rows of both sources and of x into a ring of STAGES shared
// memory stages. ldmatrix.trans, which transposes 8x8 blocks of 16-bit
// units, is run on PAIRS of int8: a lane receives w[2t][2g], w[2t][2g+1],
// w[2t+1][2g], w[2t+1][2g+1], which are the mma.sync m16n8k16 B fragments of
// two n8 tiles whose columns interleave (even columns one tile, odd columns
// the other). The bytes are widened to bf16 in registers (exact, |w| <= 127)
// and the f32 accumulators of the two tiles give each lane four adjacent
// output columns. x is bf16 already, one product per fragment.
//
// With 64 rows a matrix of 2304 columns gives only 18 blocks, so the
// contraction is split over grid.y until the card is filled. Every block
// writes its raw f32 sums to a scratch [split][source][M][N]; an
// elementwise kernel then adds the slices IN A FIXED ORDER, applies scale,
// bias and activation, and rounds to bf16. No atomics: the same inputs give
// the same bits, which sampling with a seed relies on. int8_mlp and
// int8_ffn are product, epilogue, product, epilogue inside one C call; the
// bf16 hidden [M, F] (1.2 MB at M = 64) passes through device memory
// between them.

#include "common.cuh"
#include "linear_common.cuh"

namespace {

#ifndef I8L_KC
#define I8L_KC 64
#endif
#ifndef I8L_STAGES
#define I8L_STAGES 3
#endif

constexpr int BM = 64;                 // rows of x per block
constexpr int BNH = 64;                // columns per weight source per block
constexpr int KC = I8L_KC;             // rows of the weights per stage
constexpr int STAGES = I8L_STAGES;
constexpr int THREADS = 128;
constexpr int X_LD = KC + 8;           // bf16 per x row (ldmatrix conflict-free)
constexpr int W_LD = BNH + 16;         // bytes per weight row (80: conflict-free)
constexpr int X_STAGE = BM * X_LD;     // bf16 elements
constexpr int W_STAGE = 2 * KC * W_LD; // bytes, both sources
constexpr int SMEM_BYTES = STAGES * (X_STAGE * 2 + W_STAGE);

// w holds int8 (k, n), (k, n+1), (k+1, n), (k+1, n+1) from low byte to high.
// even = bf16x2 {(k, n), (k+1, n)}, odd = bf16x2 {(k, n+1), (k+1, n+1)}: one
// B-fragment register of the even-column tile and of the odd-column tile.
// Byte x becomes the low mantissa of the f32 2^23 + (x + 128); one add
// removes the offset (no I2F).
__device__ __forceinline__ void widen_pairs(uint32_t w, uint32_t& even, uint32_t& odd) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) - 8388736.f;
  __nv_bfloat162 pe = __floats2bfloat162_rn(f[0], f[2]);
  __nv_bfloat162 po = __floats2bfloat162_rn(f[1], f[3]);
  even = *reinterpret_cast<uint32_t*>(&pe);
  odd = *reinterpret_cast<uint32_t*>(&po);
}

// P[split][source][M][N] (one source when W1 is null) = raw f32 sums of
// X[M, K] (bf16, row stride K) . W[K, N] (int8, row stride N) over this
// block's slice of K. grid = (column tiles, splits, row tiles).
__global__ void __launch_bounds__(THREADS)
i8l_product_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ W0,
                   const int8_t* __restrict__ W1, float* __restrict__ P, int M, int N, int K,
                   int k_per_split) {
  extern __shared__ __align__(16) unsigned char i8l_smem[];
  bf16* Xs = reinterpret_cast<bf16*>(i8l_smem);                       // [STAGES][BM][X_LD]
  int8_t* Ws = reinterpret_cast<int8_t*>(i8l_smem) + STAGES * X_STAGE * 2;  // [STAGES][2][KC][W_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool dual = W1 != nullptr;
  const int m0 = blockIdx.z * BM;
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_iters = k_end > k_begin ? (k_end - k_begin + KC - 1) / KC : 0;
  const int8_t* const src0 = W0;
  const int8_t* const src1 = dual ? W1 : W0;
  const int col0 = dual ? blockIdx.x * BNH : blockIdx.x * 2 * BNH;  // first column, source 0
  const int col1 = dual ? col0 : col0 + BNH;                         // first column, source 1

  auto load_stage = [&](int stage, int k0) {
    bf16* xs = Xs + stage * X_STAGE;
    int8_t* ws = Ws + stage * W_STAGE;
    for (int i = tid; i < BM * KC / 8; i += THREADS) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      const bool ok = (m0 + r < M) && (k0 + c < k_end);
      const bf16* src = ok ? X + (size_t)(m0 + r) * K + k0 + c : X;
      cp_async16(xs + r * X_LD + c, src, ok);
    }
    for (int i = tid; i < KC * BNH / 16; i += THREADS) {
      const int r = i >> 2, c = (i & 3) * 16;
      const bool row_ok = k0 + r < k_end;
      const bool ok0 = row_ok && (col0 + c < N);
      const bool ok1 = row_ok && (col1 + c < N);
      const size_t off = (size_t)(k0 + r) * N + c;
      cp_async16(ws + r * W_LD + c, ok0 ? src0 + off + col0 : src0, ok0);
      cp_async16(ws + KC * W_LD + r * W_LD + c, ok1 ? src1 + off + col1 : src1, ok1);
    }
  };

  float acc[4][2][2][4];  // [m16 tile][source][even/odd columns][fragment]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][s][p][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iters) load_stage(s, k_begin + s * KC);
    cp_async_commit();
  }

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<STAGES - 2>();   // stage `it` has landed (this thread's part)
    __syncthreads();               // ... everyone's part; stage it - 1 is free
    const int nxt = it + STAGES - 1;
    if (nxt < n_iters) load_stage(nxt % STAGES, k_begin + nxt * KC);
    cp_async_commit();

    const bf16* xs = Xs + (it % STAGES) * X_STAGE;
    const int8_t* ws = Ws + (it % STAGES) * W_STAGE;
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
        widen_pairs(raw[2 * s], b[s][0][0], b[s][1][0]);
        widen_pairs(raw[2 * s + 1], b[s][0][1], b[s][1][1]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t a[4];
        ldmatrix_x4(a, xs + (m * 16 + (lane & 15)) * X_LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int p = 0; p < 2; ++p) mma_bf16(acc[m][s][p], a, b[s][p][0], b[s][p][1]);
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

}  // namespace

// Declared in linear_common.cuh: the per-layer decode steps (layer_step.cu)
// run their four products through it too.
int launch_i8l_product(const bf16* X, const int8_t* W0, const int8_t* W1, float* P, int M, int N,
                       int K, int splits, cudaStream_t st) {
  if (N % 16 != 0 || K % 8 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(i8l_product_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
    allowed = true;
  }
  const int chunks = (K + KC - 1) / KC;
  const int k_per_split = ((chunks + splits - 1) / splits) * KC;
  const int tile = W1 != nullptr ? BNH : 2 * BNH;
  dim3 grid((N + tile - 1) / tile, splits, (M + BM - 1) / BM);
  i8l_product_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(X, W0, W1, P, M, N, K, k_per_split);
  VBT_CHECK_LAUNCH();
  return 0;
}

// y[M, N] bf16 = (x[M, K] bf16 . w[K, N] int8) * scale[N]. part: f32 scratch
// of splits * M * N.
extern "C" int vbt_int8_matmul(const void* x, const void* w, const void* scale, void* part,
                               void* y, int M, int K, int N, int splits, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int rc = launch_i8l_product((const bf16*)x, (const int8_t*)w, nullptr, (float*)part, M, N, K,
                              splits, st);
  if (rc != 0) return rc;
  return launch_epilogue<EPI_SCALE>((const float*)part, splits, M, N, (const float*)scale,
                                    nullptr, nullptr, (bf16*)y, st);
}

// Gemma's GeGLU MLP. gate, up: int8 [H, F]; down: int8 [F, H]. part: f32
// scratch of max(2 * splits1 * M * F, splits2 * M * H); hidden: bf16 [M, F].
extern "C" int vbt_int8_mlp(const void* x, const void* gate, const void* up, const void* gs,
                            const void* us, const void* down, const void* ds, void* part,
                            void* hidden, void* y, int M, int H, int F, int splits1,
                            int splits2, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int rc = launch_i8l_product((const bf16*)x, (const int8_t*)gate, (const int8_t*)up, (float*)part,
                          M, F, H, splits1, st);
  if (rc != 0) return rc;
  rc = launch_epilogue<EPI_GEGLU>((const float*)part, splits1, M, F, (const float*)gs,
                                  (const float*)us, nullptr, (bf16*)hidden, st);
  if (rc != 0) return rc;
  rc = launch_i8l_product((const bf16*)hidden, (const int8_t*)down, nullptr, (float*)part, M, H, F,
                      splits2, st);
  if (rc != 0) return rc;
  return launch_epilogue<EPI_SCALE>((const float*)part, splits2, M, H, (const float*)ds,
                                    nullptr, nullptr, (bf16*)y, st);
}

// The bridge's biased FFN. fc1: int8 [H, F]; fc2: int8 [F, H]. part: f32
// scratch of max(splits1 * M * F, splits2 * M * H); hidden: bf16 [M, F].
extern "C" int vbt_int8_ffn(const void* x, const void* fc1, const void* s1, const void* b1,
                            const void* fc2, const void* s2, const void* b2, void* part,
                            void* hidden, void* y, int M, int H, int F, int splits1,
                            int splits2, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int rc = launch_i8l_product((const bf16*)x, (const int8_t*)fc1, nullptr, (float*)part, M, F, H,
                          splits1, st);
  if (rc != 0) return rc;
  rc = launch_epilogue<EPI_GELU_ERF>((const float*)part, splits1, M, F, (const float*)s1,
                                     nullptr, (const float*)b1, (bf16*)hidden, st);
  if (rc != 0) return rc;
  rc = launch_i8l_product((const bf16*)hidden, (const int8_t*)fc2, nullptr, (float*)part, M, H, F,
                      splits2, st);
  if (rc != 0) return rc;
  return launch_epilogue<EPI_SCALE>((const float*)part, splits2, M, H, (const float*)s2,
                                    nullptr, (const float*)b2, (bf16*)y, st);
}
