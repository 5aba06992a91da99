// Tiled bf16 matrix product with a fused bias / GELU epilogue:
//   out[M, N] = act(A[M, K] . B[K, N] + bias[N]),  act = identity or erf GELU
//
// Replaces: vlm_bridge_tpu/ops/matmul_kernels.py:_tiled_matmul_jit, both of
// its pallas_call sites (bodies _mm_kernel and _mm_bias_kernel): the ViT's
// projections under VLM_BRIDGE_VIT_MM. The TPU kernel keeps the whole
// contraction of a (block_m, block_n) tile in VMEM (an A tile of up to 4 MB);
// a block here has 227 KB of shared memory at most, so the contraction is a
// loop of BK-deep stages through a cp.async ring, and the accumulator lives
// in registers.
//
// Bound: operations. At the ViT shapes (M = 64 x 257 rows, K and N in
// 1024..4096) every byte read feeds several hundred multiply-adds, above the
// ~295 operations per byte at which the H100's bf16 tensor cores, not its
// HBM, are the limit: the least time is 2 M N K over 989 TFLOP/s.
//
// Design. A block of eight warps owns a 128 x 128 tile of the output; each
// warp a 32 x 64 part of it as 2 x 8 mma.sync m16n8k16 tiles (64 f32
// accumulators a lane), over stages 64 deep in a ring of three. A and B stay
// row-major as the caller has them: ldmatrix reads A's fragments,
// ldmatrix.trans B's. Rows of A beyond M,
// columns of B beyond N and depths beyond K are zero-filled by cp.async
// (16-byte pieces, hence K and N multiples of 8), and the stores are guarded
// by row and column, so no shape is padded. The f32 bias is added to the f32
// accumulator, the GELU sees that f32 value, and the only rounding is the
// store's. blockIdx.x walks the column tiles, so blocks that run together
// share their rows of A in the L2.

#include "common.cuh"

namespace {

// The block's tile, a warp's part of it, the depth of a stage and the ring's
// length; an SM is to hold two blocks.
constexpr int BM = 128, BN = 128, BK = 64, WM = 32, WN = 64;
constexpr int STAGES = 3;
constexpr int MIN_BLOCKS = 2;
constexpr int WARPS_N = BN / WN;
constexpr int THREADS = (BM / WM) * WARPS_N * 32;
constexpr int MI = WM / 16, NJ = WN / 8;   // mma tiles of a warp: rows, columns
static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0,
              "tile constants");
constexpr int A_LD = BK + 8;   // bf16 per A row in shared memory (144 bytes: ldmatrix conflict-free)
constexpr int B_LD = BN + 8;   // bf16 per B row (272 bytes: conflict-free)
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <typename OutT, bool GELU>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
tiled_matmul_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                    const float* __restrict__ bias, OutT* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(16) unsigned char tm_smem[];
  bf16* As = reinterpret_cast<bf16*>(tm_smem);   // [STAGES][BM][A_LD]
  bf16* Bs = As + STAGES * A_STAGE;              // [STAGES][BK][B_LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;   // this warp's corner
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int n_iters = (K + BK - 1) / BK;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As + stage * A_STAGE;
    bf16* bs = Bs + stage * B_STAGE;
    // 16-byte pieces: BM rows x BK depths of A, BK depths x BN columns of B
#pragma unroll
    for (int i = tid; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = (m0 + r < M) && (k0 + c < K);
      cp_async16(as + r * A_LD + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
    }
#pragma unroll
    for (int i = tid; i < BK * BN / 8; i += THREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = (k0 + r < K) && (n0 + c < N);
      cp_async16(bs + r * B_LD + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
    }
  };

  float acc[MI][NJ][4];   // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_iters) load_stage(s, s * BK);
    cp_async_commit();
  }

  for (int it = 0; it < n_iters; ++it) {
    cp_async_wait<STAGES - 2>();   // stage `it` has landed (this thread's part)
    __syncthreads();               // ... everyone's part; stage it - 1 is free
    const int nxt = it + STAGES - 1;
    if (nxt < n_iters) load_stage(nxt % STAGES, nxt * BK);
    cp_async_commit();

    const bf16* as = As + (it % STAGES) * A_STAGE;
    const bf16* bs = Bs + (it % STAGES) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      // B fragments of the warp's n8 tiles: matrix i of an x4 load is depths
      // 16 ks + 8 (i & 1) .., columns 8 (i >> 1) .. of a 16-column pair
      uint32_t b[NJ][2];
#pragma unroll
      for (int jj = 0; jj < NJ / 2; ++jj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, bs + (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * B_LD + wn +
                                 jj * 16 + (lane >> 4) * 8);
        b[2 * jj][0] = r[0]; b[2 * jj][1] = r[1];
        b[2 * jj + 1][0] = r[2]; b[2 * jj + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        uint32_t a[4];
        ldmatrix_x4(a, as + (wm + i * 16 + (lane & 15)) * A_LD + ks * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NJ; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();

  // a lane holds columns 2t, 2t + 1 of rows g and g + 8 of every 16 x 8 tile
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    if (col >= N) continue;   // N % 8 == 0: col + 1 < N as well
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + wm + i * 16 + g + hh * 8;
        if (row >= M) continue;
        float v0 = acc[i][j][2 * hh] + b0, v1 = acc[i][j][2 * hh + 1] + b1;
        if (GELU) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        store2(out + (size_t)row * N + col, v0, v1);
      }
  }
}

template <typename OutT, bool GELU>
int launch(const bf16* A, const bf16* B, const float* bias, OutT* out, int M, int N, int K,
           cudaStream_t st) {
  static bool allowed = false;   // one flag for each instantiation
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(tiled_matmul_kernel<OutT, GELU>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
    allowed = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  tiled_matmul_kernel<OutT, GELU><<<grid, THREADS, SMEM_BYTES, st>>>(A, B, bias, out, M, N, K);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// out[M, N] (bf16, or f32 when out_f32) = act(a[M, K] bf16 . b[K, N] bf16 +
// bias[N] f32); bias may be null; gelu != 0 applies the erf GELU. K and N
// must be multiples of 8.
extern "C" int vbt_tiled_matmul(const void* a, const void* b, const void* bias, void* out, int M,
                                int K, int N, int gelu, int out_f32, void* stream_ptr) {
  if (M < 1 || K % 8 != 0 || N % 8 != 0 || K < 8 || N < 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const bf16* A = (const bf16*)a;
  const bf16* B = (const bf16*)b;
  const float* bs = (const float*)bias;
  if (out_f32)
    return gelu ? launch<float, true>(A, B, bs, (float*)out, M, N, K, st)
                : launch<float, false>(A, B, bs, (float*)out, M, N, K, st);
  return gelu ? launch<bf16, true>(A, B, bs, (bf16*)out, M, N, K, st)
              : launch<bf16, false>(A, B, bs, (bf16*)out, M, N, K, st);
}
