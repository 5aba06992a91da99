// Int8-weight GEMM at decode batch: Y = (A @ W int8) * scale (+ bias).
//
// The building block of the fused decode steps (stack_step.cu,
// bridge_step.cu), which replace the Pallas kernels
// vlm_bridge_tpu/ops/decode_kernels.py:_stack_kernel and :_bridge_kernel.
// It carries their int8 products: every projection of a decoder layer and a
// bridge block.
//
// Bound: at decode (M = batch = 64 rows) the kernel is bound by streaming
// the weights (about 2.6 GB per token over the whole step): each weight
// byte feeds 64 multiply-adds per activation pass, below the ~295
// operations per byte at which the H100's bf16 tensor cores, not its
// 3.35 TB/s of HBM, become the limit.
//
// Design. The weights are stored in mma.sync fragment order (see
// ops/decode_kernels.to_fragments): for every 32 output columns and every
// 16 rows of K, 512 bytes hold each lane's B fragments of four n8 tiles as
// 16 contiguous bytes. A warp therefore streams its columns as one
// sequential run, 16 bytes a lane per 16 rows of K, straight into registers
// (DEPTH steps in flight), widens them to bf16 there (exact for |w| <= 127)
// and feeds mma.sync m16n8k16 with f32 accumulation: the weights never pass
// through shared memory. Only the activation chunk (64 rows x 128 of K) is
// staged in shared memory and read with ldmatrix. The f32 activations
// arrive split by their producers into two bf16 halves (hi = bf16(a),
// lo = bf16(a - hi), common.cuh), two MMAs per fragment, so the products
// keep about 16 bits of the activation where one bf16 operand keeps 8: the
// spare tensor-core rate buys f32-class agreement with the plain PyTorch
// version, which decides greedy ids on near-ties. A block is four warps
// (128 columns; eight measured slower on an H100); the K range is split until the grid has at least four
// blocks per SM, and the K slices are combined with f32 vector atomics into
// an output zeroed first, so results may differ run to run in the last f32
// bits.

#include "common.cuh"

namespace {

constexpr int BM = 64;            // rows per block (the decode batch)
constexpr int KC = 128;           // K chunk staged in shared memory
constexpr int A_LD = KC + 8;      // padded row (272 bytes: ldmatrix conflict-free)
constexpr int DEPTH = 4;          // weight fragment loads in flight per lane
constexpr int WARPS = 4;          // a block covers 32 * WARPS output columns
constexpr int BN = 32 * WARPS;

// 4 int8 (one lane's share of a 16x8 B tile) -> two bf16x2 registers b0, b1
// without I2F: byte x becomes the low mantissa of the f32 2^23 + (x + 128)
// and one full-rate add removes the offset.
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& b0, uint32_t& b1) {
  w ^= 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) - 8388736.f;
  __nv_bfloat162 p0 = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 p1 = __floats2bfloat162_rn(f[2], f[3]);
  b0 = *reinterpret_cast<uint32_t*>(&p0);
  b1 = *reinterpret_cast<uint32_t*>(&p1);
}

__global__ void __launch_bounds__(32 * WARPS)
i8_gemm_kernel(const bf16* __restrict__ Ah, int lda, const int8_t* __restrict__ Wf,
               const float* __restrict__ scale, const float* __restrict__ bias,
               float* __restrict__ Y, int M, int N, int K, int k_per_split) {
  __shared__ __align__(16) bf16 Hs[BM * A_LD];
  __shared__ __align__(16) bf16 Ls[BM * A_LD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, m0 = blockIdx.z * BM;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_tile = blockIdx.x * WARPS + warp;      // this warp's 32 columns
  const bf16* Al = Ah + (size_t)M * lda;
  // this lane's 16 bytes of fragment chunk (n_tile, k16) sit at
  // wp[k16 * 32]
  const int4* wp = reinterpret_cast<const int4*>(Wf) + (size_t)n_tile * (K / 16) * 32 + lane;

  float acc[4][4][4];  // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const int steps = (k_end - k_begin) / 16;          // k16 steps of this block
  const int s0 = k_begin / 16;
  int4 wbuf[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (d < steps) wbuf[d] = __ldg(wp + (size_t)(s0 + d) * 32);

  for (int kc = k_begin; kc < k_end; kc += KC) {
    // activation chunk: 64 rows x 128, hi and lo (1024 16-byte pieces each)
    for (int i = threadIdx.x; i < BM * KC / 8; i += blockDim.x) {
      const int r = i >> 4, c = (i & 15) * 8;
      uint4 h = make_uint4(0, 0, 0, 0), l = h;
      if (m0 + r < M) {
        const size_t off = (size_t)(m0 + r) * lda + kc + c;
        h = *reinterpret_cast<const uint4*>(Ah + off);
        l = *reinterpret_cast<const uint4*>(Al + off);
      }
      *reinterpret_cast<uint4*>(&Hs[r * A_LD + c]) = h;
      *reinterpret_cast<uint4*>(&Ls[r * A_LD + c]) = l;
    }
    __syncthreads();
    const int sc = (kc - k_begin) / 16;              // first step of this chunk
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      const int4 w = wbuf[ks % DEPTH];
      const int nxt = sc + ks + DEPTH;
      if (nxt < steps) wbuf[ks % DEPTH] = __ldg(wp + (size_t)(s0 + nxt) * 32);
      uint32_t b[4][2];
      widen4((uint32_t)w.x, b[0][0], b[0][1]);
      widen4((uint32_t)w.y, b[1][0], b[1][1]);
      widen4((uint32_t)w.z, b[2][0], b[2][1]);
      widen4((uint32_t)w.w, b[3][0], b[3][1]);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        uint32_t ah[4], al[4];
        const int off = (m * 16 + (lane & 15)) * A_LD + ks * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ah, &Hs[off]);
        ldmatrix_x4(al, &Ls[off]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[m][j], al, b[j][0], b[j][1]);
          mma_bf16(acc[m][j], ah, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n_tile * 32 + j * 8 + 2 * t;
    const float2 s = *reinterpret_cast<const float2*>(scale + n);
    float2 bb = make_float2(0.f, 0.f);
    if (bias != nullptr && split == 0) bb = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + m * 16 + g + hh * 8;
        if (row >= M) continue;
        const float2 v = make_float2(acc[m][j][2 * hh] * s.x + bb.x,
                                     acc[m][j][2 * hh + 1] * s.y + bb.y);
        float* yp = Y + (size_t)row * N + n;
#if __CUDA_ARCH__ >= 900 && (__CUDACC_VER_MAJOR__ > 12 || __CUDACC_VER_MINOR__ >= 4)
        atomicAdd(reinterpret_cast<float2*>(yp), v);
#else
        atomicAdd(yp, v.x);
        atomicAdd(yp + 1, v.y);
#endif
      }
  }
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace

int launch_i8_gemm(const bf16* A, int lda, const int8_t* Wf, const float* scale,
                   const float* bias, float* Y, int M, int N, int K, cudaStream_t stream) {
  if (N % BN != 0 || K % KC != 0 || lda % 8 != 0) return (int)cudaErrorInvalidValue;
  VBT_CHECK(cudaMemsetAsync(Y, 0, sizeof(float) * (size_t)M * N, stream));
  const int n_blocks = N / BN, m_blocks = (M + BM - 1) / BM, chunks = K / KC;
  // smallest divisor of the K chunks giving >= 4 blocks per SM
  const int want = 4 * num_sms();
  int splits = 1;
  for (int s = 1; s <= chunks; ++s) {
    if (chunks % s) continue;
    splits = s;
    if (n_blocks * m_blocks * s >= want) break;
  }
  dim3 grid(n_blocks, splits, m_blocks);
  i8_gemm_kernel<<<grid, 32 * WARPS, 0, stream>>>(A, lda, Wf, scale, bias, Y, M, N, K,
                                           (chunks / splits) * KC);
  VBT_CHECK_LAUNCH();
  return 0;
}
