// The tied int8 head, E int8 [V, H] with one scale per vocab row:
//   greedy   ids[m] = argmax_v (x[m] . E[v]) * scale[v]
//   logits   y[m, v] = (x[m] . E[v]) * scale[v], f32 (the sampled head)
//
// Replaces: vlm_bridge_tpu/ops/quant.py:int8_matmul_t_argmax, whose body is
// _int8_mmt_argmax_kernel. Gemma's final softcap is monotonic, so it is
// skipped; the [B, V] logits are never written to device memory.
// Replaces: vlm_bridge_tpu/ops/quant.py:int8_matmul_t, whose body is
// _int8_mmt_kernel: the same 64 x 128 tile product (`xet_tile`), each tile
// scaled and written out as f32. Its bound adds the logits' bytes (65.5 MB
// at M = 64) to the table's.
//
// Bound: streaming the 590 MB int8 table (V = 256000, H = 2304) once per
// token; ~0.18 ms at 3.35 TB/s. One block per 128 vocab rows (2000 blocks)
// keeps every SM streaming; x (64 x 2304 bf16) is re-read from L2.
//
// Argmax rules. The V blocks run in parallel, so the reduce is two-pass:
// each block writes (max, first index reaching it) for its 128 rows, and a
// second kernel takes, per batch row, the FIRST block whose max is strictly
// greater than every earlier one. That keeps the first-index tie rule of
// jnp.argmax. NaN follows the TPU kernel, not the jnp fallback: a block
// whose logits hold a NaN never wins (its max compares false), and a row
// where no block wins (all-NaN) returns 0. The blocking therefore belongs
// to the semantics of a row that is NaN only in part; the plain version in
// ops/quant.py uses the same 128-row blocks.

#include <climits>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 64, BV = 128, BK = 64, LDS = BK + 8, C_LD = BV + 4;
constexpr int SMEM_MAIN = (BM * LDS + BV * LDS) * 2;
constexpr int SMEM_C = BM * C_LD * 4;
constexpr int SMEM = SMEM_MAIN > SMEM_C ? SMEM_MAIN : SMEM_C;

// Cs[BM][C_LD] (f32, in `raw`) = X[m0 .. m0+63] . E[v0 .. v0+127]^T, rows
// past M and vocab rows past V as zeros. 256 threads; ends on a barrier.
__device__ __forceinline__ void xet_tile(const bf16* __restrict__ X,
                                         const int8_t* __restrict__ E, unsigned char* raw,
                                         int m0, int v0, int M, int V, int H) {
  bf16* Xs = reinterpret_cast<bf16*>(raw);        // [BM][LDS]
  bf16* Es = Xs + BM * LDS;                       // [BV][LDS]  (E rows, H contiguous)
  float* Cs = reinterpret_cast<float*>(raw);      // [BM][C_LD] after the main loop

  const int warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += blockDim.x) {
      const int r = i >> 3, c = (i & 7) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(X + (size_t)(m0 + r) * H + k0 + c);
      *reinterpret_cast<uint4*>(&Xs[r * LDS + c]) = v;
    }
    for (int i = threadIdx.x; i < BV * BK / 16; i += blockDim.x) {
      const int r = i >> 2, c = (i & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (v0 + r < V) v = __ldg(reinterpret_cast<const int4*>(E + (size_t)(v0 + r) * H + k0 + c));
      const int8_t* b = reinterpret_cast<const int8_t*>(&v);
      __align__(16) bf16 tmp[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) tmp[e] = __float2bfloat16((float)b[e]);
      reinterpret_cast<uint4*>(&Es[r * LDS + c])[0] = reinterpret_cast<uint4*>(tmp)[0];
      reinterpret_cast<uint4*>(&Es[r * LDS + c])[1] = reinterpret_cast<uint4*>(tmp)[1];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, &Xs[(wm * 16) * LDS + kk], LDS);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B[k][n] = E[v0 + n][k0 + k]: column-major with leading dim LDS
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, &Es[(wn * 64 + j * 16) * LDS + kk], LDS);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(&Cs[(wm * 16) * C_LD + wn * 64 + j * 16], acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();
}

__global__ void __launch_bounds__(256)
argmax_block_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ E,
                    const float* __restrict__ scale, float* __restrict__ bval,
                    int* __restrict__ bidx, int M, int V, int H) {
  __shared__ __align__(32) unsigned char raw[SMEM];
  const int v0 = blockIdx.x * BV, m0 = blockIdx.y * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  xet_tile(X, E, raw, m0, v0, M, V, H);
  const float* Cs = reinterpret_cast<const float*>(raw);

  // each warp reduces 8 batch rows; lane covers columns lane + 32 i
  for (int r = warp; r < BM; r += 8) {
    const int m = m0 + r;
    if (m >= M) break;
    bool nan = false;
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int c = lane; c < BV; c += 32) {
      const int v = v0 + c;
      if (v >= V) break;
      const float y = Cs[r * C_LD + c] * scale[v];
      if (isnan(y)) nan = true;
      else if (y > best) { best = y; arg = v; }   // columns rise with c: first index kept
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
      if (ob > best || (ob == best && oa < arg)) { best = ob; arg = oa; }
    }
    nan = __any_sync(0xffffffffu, nan);
    if (lane == 0) {
      bval[(size_t)blockIdx.x * M + m] = nan ? -INFINITY : best;
      bidx[(size_t)blockIdx.x * M + m] = arg;
    }
  }
}

// y[m, v0 .. v0+127] = tile * scale: consecutive threads write consecutive
// vocab columns of one batch row.
__global__ void __launch_bounds__(256)
logits_block_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ E,
                    const float* __restrict__ scale, float* __restrict__ Y, int M, int V,
                    int H) {
  __shared__ __align__(32) unsigned char raw[SMEM];
  const int v0 = blockIdx.x * BV, m0 = blockIdx.y * BM;
  xet_tile(X, E, raw, m0, v0, M, V, H);
  const float* Cs = reinterpret_cast<const float*>(raw);
  for (int i = threadIdx.x; i < BM * BV; i += blockDim.x) {
    const int r = i / BV, c = i % BV;
    const int m = m0 + r, v = v0 + c;
    if (m < M && v < V) Y[(size_t)m * V + v] = Cs[r * C_LD + c] * scale[v];
  }
}

// ids[m]: the first block (in vocab order) whose max is strictly greater
// than all earlier blocks' wins; no winner (all -inf/NaN) -> 0.
__global__ void argmax_reduce_kernel(const float* __restrict__ bval, const int* __restrict__ bidx,
                                     int* __restrict__ ids, int M, int nblk) {
  __shared__ float sv[256];
  __shared__ int sb[256];
  const int m = blockIdx.x;
  float best = -INFINITY;
  int blk = INT_MAX;
  for (int k = threadIdx.x; k < nblk; k += blockDim.x) {
    const float v = bval[(size_t)k * M + m];
    if (v > best) { best = v; blk = k; }
  }
  sv[threadIdx.x] = best;
  sb[threadIdx.x] = blk;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      const float ov = sv[threadIdx.x + s];
      const int ob = sb[threadIdx.x + s];
      if (ov > sv[threadIdx.x] || (ov == sv[threadIdx.x] && ob < sb[threadIdx.x])) {
        sv[threadIdx.x] = ov;
        sb[threadIdx.x] = ob;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0)
    ids[m] = (sv[0] > -INFINITY) ? bidx[(size_t)sb[0] * M + m] : 0;
}

}  // namespace

extern "C" int vbt_int8_matmul_t_argmax(const void* x, const void* E, const void* scale,
                                        void* bval, void* bidx, void* ids, int M, int V, int H,
                                        void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (H % BK != 0) return (int)cudaErrorInvalidValue;
  const int nblk = (V + BV - 1) / BV;
  argmax_block_kernel<<<dim3(nblk, (M + BM - 1) / BM), 256, 0, st>>>(
      (const bf16*)x, (const int8_t*)E, (const float*)scale, (float*)bval, (int*)bidx, M, V, H);
  VBT_CHECK_LAUNCH();
  argmax_reduce_kernel<<<M, 256, 0, st>>>((const float*)bval, (const int*)bidx, (int*)ids, M,
                                          nblk);
  VBT_CHECK_LAUNCH();
  return 0;
}

// y[M, V] f32 = (x[M, H] bf16 . E[V, H]^T int8) * scale[V]
extern "C" int vbt_int8_matmul_t(const void* x, const void* E, const void* scale, void* y,
                                 int M, int V, int H, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  if (H % BK != 0) return (int)cudaErrorInvalidValue;
  logits_block_kernel<<<dim3((V + BV - 1) / BV, (M + BM - 1) / BM), 256, 0, st>>>(
      (const bf16*)x, (const int8_t*)E, (const float*)scale, (float*)y, M, V, H);
  VBT_CHECK_LAUNCH();
  return 0;
}
