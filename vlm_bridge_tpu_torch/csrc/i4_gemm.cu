// Int4-weight GEMM at decode batch: Y = sum over scale groups of
// (A[:, group] @ W4[group, :]) * scale[group, :].
//
// The int4 MLP stage of the fused decoder step (stack_step.cu), which
// replaces the `mlp4=True` stage of the Pallas kernel
// vlm_bridge_tpu/ops/decode_kernels.py:_stack_kernel (reached through
// fused_stack_step): the gate|up and the down projections of every layer
// with nibble-packed weights, per output channel or per group of rows.
//
// Bound: at decode (M = batch = 64 rows) the kernel is bound by streaming
// the weights, half of the int8 MLP's bytes: each weight byte now feeds 128
// multiply-adds per activation pass, still below the ~295 operations per
// byte at which the H100's bf16 tensor cores, not its 3.35 TB/s of HBM,
// become the limit.
//
// Design: i8_gemm.cu's, at two nibbles a byte. The weights are stored in
// the packed fragment order of ops/decode_kernels.to_fragments4: for every
// 32 output columns and every 32 rows of K, 512 bytes hold each lane's B
// fragments of four n8 tiles for TWO k16 steps as 16 contiguous bytes (low
// nibbles the first 16 rows, high nibbles the next 16). A warp streams its
// columns as one sequential run straight into registers (DEPTH loads in
// flight), widens the nibbles to bf16 there (common.cuh:nib_pair, exact)
// and feeds mma.sync m16n8k16 with f32 accumulation. The layout is this
// port's own: the TPU kernel's pairing of row k with row k + K/2, its
// block-local down projection and its MLP chunk width exist for Mosaic's
// tiling and have no counterpart here. The f32 activations arrive split
// into bf16 hi + lo halves (common.cuh), two MMAs per fragment, as in the
// int8 GEMM, so kernel and plain version agree to f32 rounding.
//
// Scales that vary along the contraction cannot fold into one output
// multiply, and a second accumulator for the current group's raw sums costs
// 64 registers a thread, which costs resident blocks, which is what this
// kernel's time follows (measured: scripts/tune_int4_torch.py). So there is
// ONE accumulator, kept in the unit of the current group's scale: the MMAs
// add raw products into it; when a group ends it is multiplied by
// scale[group] / scale[next group], and when the block's K slice ends by the
// last group's scale. That is the same sum, sum_g P_g * scale[g], at one more
// f32 rounding a group. A scale of 0 is taken as 1e-30 (its group then weighs
// 1e-30 instead of 0); the quantizers floor scales at 1e-12 / 7. One scale per
// output column is the case group == K. A K slice may cut a group: both
// blocks scale their share by the same factor. The K slices are combined with
// f32 vector atomics into an output zeroed first, as in i8_gemm.cu.

#include "common.cuh"

// Build-time constants, for timing against each other (VBT_NVCC_FLAGS;
// scripts/tune_int4_torch.py): I4_MIN_BLOCKS is the resident blocks per SM the
// compiler must leave registers for (4: at most 128 a thread; 5 spills and is
// slower), I4_BLOCKS_PER_SM the blocks per SM the K range is split for.
#ifndef I4_MIN_BLOCKS
#define I4_MIN_BLOCKS 4
#endif
#ifndef I4_BLOCKS_PER_SM
#define I4_BLOCKS_PER_SM 4
#endif

namespace {

constexpr int BM = 64;            // rows per block (the decode batch)
constexpr int KC = 128;           // K chunk staged in shared memory
constexpr int A_LD = KC + 8;      // padded row (272 bytes: ldmatrix conflict-free)
constexpr int DEPTH = 4;          // weight fragment loads (32 rows of K each) in flight per lane
constexpr int WARPS = 4;          // a block covers 32 * WARPS output columns
constexpr int BN = 32 * WARPS;

__global__ void __launch_bounds__(32 * WARPS, I4_MIN_BLOCKS)
i4_gemm_kernel(const bf16* __restrict__ Ah, int lda, const uint8_t* __restrict__ Wf,
               const float* __restrict__ scale, int group, float* __restrict__ Y, int M, int N,
               int K, int k_per_split) {
  __shared__ __align__(16) bf16 Hs[BM * A_LD];
  __shared__ __align__(16) bf16 Ls[BM * A_LD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = blockIdx.y, m0 = blockIdx.z * BM;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_tile = blockIdx.x * WARPS + warp;      // this warp's 32 columns
  const bf16* Al = Ah + (size_t)M * lda;
  // this lane's 16 bytes of fragment chunk (n_tile, k32) sit at wp[k32 * 32]
  const int4* wp = reinterpret_cast<const int4*>(Wf) + (size_t)n_tile * (K / 32) * 32 + lane;

  float acc[4][4][4];                 // [m16 tile][n8 tile][fragment], in the current group's unit
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  const int steps = (k_end - k_begin) / 32;          // k32 steps of this block
  const int s0 = k_begin / 32;
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
    const int sc = (kc - k_begin) / 32;              // first k32 step of this chunk
#pragma unroll
    for (int kq = 0; kq < KC / 32; ++kq) {
      const int4 w = wbuf[kq % DEPTH];
      const int nxt = sc + kq + DEPTH;
      if (nxt < steps) wbuf[kq % DEPTH] = __ldg(wp + (size_t)(s0 + nxt) * 32);
      const uint32_t wb[4] = {(uint32_t)w.x ^ 0x88888888u, (uint32_t)w.y ^ 0x88888888u,
                              (uint32_t)w.z ^ 0x88888888u, (uint32_t)w.w ^ 0x88888888u};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {               // low nibbles: rows 0..15, high: 16..31
        uint32_t b[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = nib_pair(wb[j], 4 * hf, 8 + 4 * hf);
          b[j][1] = nib_pair(wb[j], 16 + 4 * hf, 24 + 4 * hf);
        }
        const int ks = 2 * kq + hf;
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
      // the scale group, or this block's slice, ends with these 32 rows
      const int k_next = kc + (kq + 1) * 32;
      if (k_next % group == 0 || k_next == k_end) {
        const float* srow = scale + (size_t)((k_next - 1) / group) * N + n_tile * 32 + 2 * t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float2 s = *reinterpret_cast<const float2*>(srow + j * 8);
          s = make_float2(fmaxf(s.x, 1e-30f), fmaxf(s.y, 1e-30f));
          if (k_next != k_end) {      // rescale to the next group's unit
            const float2 sn = *reinterpret_cast<const float2*>(srow + N + j * 8);
            s = make_float2(s.x / fmaxf(sn.x, 1e-30f), s.y / fmaxf(sn.y, 1e-30f));
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[m][j][0] *= s.x;
            acc[m][j][1] *= s.y;
            acc[m][j][2] *= s.x;
            acc[m][j][3] *= s.y;
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n_tile * 32 + j * 8 + 2 * t;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + m * 16 + g + hh * 8;
        if (row >= M) continue;
        const float2 v = make_float2(acc[m][j][2 * hh], acc[m][j][2 * hh + 1]);
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

int launch_i4_gemm(const bf16* A, int lda, const uint8_t* Wf, const float* scale, int group,
                   float* Y, int M, int N, int K, cudaStream_t stream) {
  if (N % BN != 0 || K % KC != 0 || lda % 8 != 0 || group <= 0 || group % 32 != 0 ||
      K % group != 0)
    return (int)cudaErrorInvalidValue;
  VBT_CHECK(cudaMemsetAsync(Y, 0, sizeof(float) * (size_t)M * N, stream));
  const int n_blocks = N / BN, m_blocks = (M + BM - 1) / BM, chunks = K / KC;
  // smallest divisor of the K chunks giving >= 4 blocks per SM
  const int want = I4_BLOCKS_PER_SM * num_sms();
  int splits = 1;
  for (int s = 1; s <= chunks; ++s) {
    if (chunks % s) continue;
    splits = s;
    if (n_blocks * m_blocks * s >= want) break;
  }
  dim3 grid(n_blocks, splits, m_blocks);
  i4_gemm_kernel<<<grid, 32 * WARPS, 0, stream>>>(A, lda, Wf, scale, group, Y, M, N, K,
                                                  (chunks / splits) * KC);
  VBT_CHECK_LAUNCH();
  return 0;
}
