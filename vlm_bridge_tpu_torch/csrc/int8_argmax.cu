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
// The same two heads over the rows-packed int4 table (E4 int8 [V, H/2], byte
// (v, k) holding columns k and k + H/2; scales per row [V] or per (H-group,
// row) [H/g, V]):
// Replaces: vlm_bridge_tpu/ops/quant.py:int4_matmul_t_argmax, whose body is
// _int4_mmt_argmax_kernel, and
// Replaces: vlm_bridge_tpu/ops/quant.py:int4_matmul_t, whose body is
// _int4_mmt_kernel. Their bound is the 295 MB of nibbles plus 18 MB of
// group scales (and the logits, for the sampled head). One byte of a table
// row meets two columns of x, so a tile of the table meets TWO tiles of x
// (`xet4_tile`): the nibbles are widened to bf16 on their way into shared
// memory (common.cuh:nib_pair, exact), low nibbles into one tile and high
// nibbles into another, and each is multiplied with its own x tile by
// mma.sync. Group scales vary along the contraction: the MMAs of a group run
// into partial accumulators (one for each half), which are added into the
// sum times scale[group, v] when the group ends; per-row scales are the case
// of one group. The weights are never multiplied by their scales in bf16.
// The argmax rules below hold for both tables.
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

// Per batch row of the tile Cs[BM][C_LD]: (max, first index reaching it) of
// Cs * scale over this block's vocab rows, -inf if any is NaN. A null scale
// stands for 1. Each warp reduces 8 batch rows; a lane covers columns
// lane + 32 i.
__device__ __forceinline__ void tile_argmax(const float* Cs, const float* __restrict__ scale,
                                            float* __restrict__ bval, int* __restrict__ bidx,
                                            int m0, int v0, int M, int V) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BM; r += 8) {
    const int m = m0 + r;
    if (m >= M) break;
    bool nan = false;
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int c = lane; c < BV; c += 32) {
      const int v = v0 + c;
      if (v >= V) break;
      const float y = Cs[r * C_LD + c] * (scale != nullptr ? scale[v] : 1.f);
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

// y[m, v0 .. v0+127] = tile * scale (null: 1): consecutive threads write
// consecutive vocab columns of one batch row.
__device__ __forceinline__ void tile_store(const float* Cs, const float* __restrict__ scale,
                                           float* __restrict__ Y, int m0, int v0, int M, int V) {
  for (int i = threadIdx.x; i < BM * BV; i += blockDim.x) {
    const int r = i / BV, c = i % BV;
    const int m = m0 + r, v = v0 + c;
    if (m < M && v < V)
      Y[(size_t)m * V + v] = Cs[r * C_LD + c] * (scale != nullptr ? scale[v] : 1.f);
  }
}

__global__ void __launch_bounds__(256)
argmax_block_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ E,
                    const float* __restrict__ scale, float* __restrict__ bval,
                    int* __restrict__ bidx, int M, int V, int H) {
  __shared__ __align__(32) unsigned char raw[SMEM];
  const int v0 = blockIdx.x * BV, m0 = blockIdx.y * BM;
  xet_tile(X, E, raw, m0, v0, M, V, H);
  tile_argmax(reinterpret_cast<const float*>(raw), scale, bval, bidx, m0, v0, M, V);
}

__global__ void __launch_bounds__(256)
logits_block_kernel(const bf16* __restrict__ X, const int8_t* __restrict__ E,
                    const float* __restrict__ scale, float* __restrict__ Y, int M, int V,
                    int H) {
  __shared__ __align__(32) unsigned char raw[SMEM];
  const int v0 = blockIdx.x * BV, m0 = blockIdx.y * BM;
  xet_tile(X, E, raw, m0, v0, M, V, H);
  tile_store(reinterpret_cast<const float*>(raw), scale, Y, m0, v0, M, V);
}

// ---- the rows-packed int4 table -------------------------------------------

// Resident blocks per SM the compiler must leave registers for in the two int4
// head kernels (a build-time constant, VBT_NVCC_FLAGS): at 2 (128 registers a
// thread, ~200 bytes spilled) the heads take 0.72x the time they take at 1
// (172 registers, one block an SM).
#ifndef I4H_MIN_BLOCKS
#define I4H_MIN_BLOCKS 2
#endif

constexpr int K4 = 64;                 // packed bytes of a table row per stage
constexpr int L4 = K4 + 8;             // bf16 per shared-memory row (ldmatrix conflict-free)
constexpr int X4_TILE = BM * L4, E4_TILE = BV * L4;   // bf16 elements
constexpr int SMEM4_MAIN = (2 * X4_TILE + 2 * E4_TILE) * 2;
constexpr int SMEM4 = SMEM4_MAIN > SMEM_C ? SMEM4_MAIN : SMEM_C;

// Cs[BM][C_LD] (f32, in `raw`) = scaled logits of rows m0 .. m0+63 and vocab
// rows v0 .. v0+127: sum over scale groups of (X_lo . E_lo^T) * s[g, v] +
// (X_hi . E_hi^T) * s[hi_rows + g, v], where E_lo / E_hi are the low / high
// nibbles of `group` packed bytes and X_lo / X_hi the columns of x they
// stand for (k and H/2 + k). Per-row scales: group == H/2, hi_rows == 0.
// Rows past M and vocab rows past V give zeros (or NaN under a NaN x: the
// callers mask them). 256 threads; ends on a barrier.
__device__ __forceinline__ void xet4_tile(const bf16* __restrict__ X,
                                          const uint8_t* __restrict__ E,
                                          const float* __restrict__ scale, unsigned char* raw,
                                          int m0, int v0, int M, int V, int H, int group,
                                          int hi_rows) {
  bf16* Xs = reinterpret_cast<bf16*>(raw);        // [2][BM][L4]: columns k.., columns H/2 + k..
  bf16* Es = Xs + 2 * X4_TILE;                    // [2][BV][L4]: low nibbles, high nibbles
  float* Cs = reinterpret_cast<float*>(raw);      // [BM][C_LD] after the main loop

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;        // 16 rows x 64 vocab rows a warp
  const int g = lane >> 2, t = lane & 3;
  const int H2 = H / 2;

  float acc[8][4], part[2][8][4];                 // [n8 tile][fragment], [half]
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = part[0][j][e] = part[1][j][e] = 0.f;

  // the next stage's global data waits in registers while this one is multiplied
  uint4 xr[4], er[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * 256;               // 2 halves x 64 rows x 8 pieces
      const int hsel = i >> 9, r = (i & 511) >> 3, c = (i & 7) * 8;
      xr[it] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M)
        xr[it] = *reinterpret_cast<const uint4*>(X + (size_t)(m0 + r) * H + hsel * H2 + k0 + c);
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + it * 256;               // 128 vocab rows x 4 pieces of 16 bytes
      const int r = i >> 2, c = (i & 3) * 16;
      er[it] = make_uint4(0, 0, 0, 0);
      if (v0 + r < V)
        er[it] = __ldg(reinterpret_cast<const uint4*>(E + (size_t)(v0 + r) * H2 + k0 + c));
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int i = tid + it * 256;
      const int hsel = i >> 9, r = (i & 511) >> 3, c = (i & 7) * 8;
      *reinterpret_cast<uint4*>(&Xs[hsel * X4_TILE + r * L4 + c]) = xr[it];
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int i = tid + it * 256;
      const int r = i >> 2, c = (i & 3) * 16;
      const uint32_t w[4] = {er[it].x ^ 0x88888888u, er[it].y ^ 0x88888888u,
                             er[it].z ^ 0x88888888u, er[it].w ^ 0x88888888u};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {            // low nibbles, then high nibbles
        uint32_t o[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {             // word q: bytes 4q .. 4q+3
          o[2 * q] = nib_pair(w[q], 4 * hf, 8 + 4 * hf);
          o[2 * q + 1] = nib_pair(w[q], 16 + 4 * hf, 24 + 4 * hf);
        }
        uint4* dst = reinterpret_cast<uint4*>(&Es[hf * E4_TILE + r * L4 + c]);
        dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
        dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
      }
    }
  };

  const int n_stages = H2 / K4;
  fetch(0);
  for (int st = 0; st < n_stages; ++st) {
    stash();
    __syncthreads();
    if (st + 1 < n_stages) fetch((st + 1) * K4);
#pragma unroll
    for (int kk = 0; kk < K4; kk += 16) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        uint32_t a[4];
        ldmatrix_x4(a, &Xs[hf * X4_TILE + (wm * 16 + (lane & 15)) * L4 + kk + (lane >> 4) * 8]);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          // B[k][n] = E[v0 + n][k]: vocab rows are the matrices' rows. Registers
          // 0, 1: rows n0 .. n0+7 at k 0..7 | 8..15; 2, 3: rows n0+8 .. n0+15
          uint32_t b[4];
          ldmatrix_x4(b, &Es[hf * E4_TILE +
                             (wn * 64 + jj * 16 + ((lane >> 4) << 3) + (lane & 7)) * L4 + kk +
                             ((lane >> 3) & 1) * 8]);
          mma_bf16(part[hf][2 * jj], a, b[0], b[1]);
          mma_bf16(part[hf][2 * jj + 1], a, b[2], b[3]);
        }
      }
    }
    if (((st + 1) * K4) % group == 0) {           // a scale group ends with this stage
      const int gi = ((st + 1) * K4) / group - 1;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + wn * 64 + j * 8 + 2 * t + e;
          const float sl = v < V ? scale[(size_t)gi * V + v] : 0.f;
          const float sh = v < V ? scale[(size_t)(hi_rows + gi) * V + v] : 0.f;
          acc[j][e] += part[0][j][e] * sl + part[1][j][e] * sh;
          acc[j][2 + e] += part[0][j][2 + e] * sl + part[1][j][2 + e] * sh;
          part[0][j][e] = part[1][j][e] = part[0][j][2 + e] = part[1][j][2 + e] = 0.f;
        }
    }
    __syncthreads();
  }
  // c0, c1 at (row g, columns 2t, 2t+1), c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* cp = &Cs[(wm * 16 + g + hh * 8) * C_LD + wn * 64 + j * 8 + 2 * t];
      cp[0] = acc[j][2 * hh];
      cp[1] = acc[j][2 * hh + 1];
    }
  __syncthreads();
}

__global__ void __launch_bounds__(256, I4H_MIN_BLOCKS)
argmax4_block_kernel(const bf16* __restrict__ X, const uint8_t* __restrict__ E,
                     const float* __restrict__ scale, float* __restrict__ bval,
                     int* __restrict__ bidx, int M, int V, int H, int group, int hi_rows) {
  extern __shared__ __align__(32) unsigned char raw4[];
  const int v0 = blockIdx.x * BV, m0 = blockIdx.y * BM;
  xet4_tile(X, E, scale, raw4, m0, v0, M, V, H, group, hi_rows);
  tile_argmax(reinterpret_cast<const float*>(raw4), nullptr, bval, bidx, m0, v0, M, V);
}

__global__ void __launch_bounds__(256, I4H_MIN_BLOCKS)
logits4_block_kernel(const bf16* __restrict__ X, const uint8_t* __restrict__ E,
                     const float* __restrict__ scale, float* __restrict__ Y, int M, int V, int H,
                     int group, int hi_rows) {
  extern __shared__ __align__(32) unsigned char raw4[];
  const int v0 = blockIdx.x * BV, m0 = blockIdx.y * BM;
  xet4_tile(X, E, scale, raw4, m0, v0, M, V, H, group, hi_rows);
  tile_store(reinterpret_cast<const float*>(raw4), nullptr, Y, m0, v0, M, V);
}

// group (columns of x a scale covers; 0: one scale per table row) -> the
// kernels' (packed bytes per group, scale rows before the high half's)
int rows_plan(int H, int group, int* kgroup, int* hi_rows) {
  const int H2 = H / 2;
  if (H % 2 != 0 || H2 % K4 != 0) return (int)cudaErrorInvalidValue;
  if (group == 0) {
    *kgroup = H2;
    *hi_rows = 0;
    return 0;
  }
  if (group % K4 != 0 || H2 % group != 0) return (int)cudaErrorInvalidValue;
  *kgroup = group;
  *hi_rows = H2 / group;
  return 0;
}

template <typename Kernel>
int allow_smem4(Kernel kernel) {
  VBT_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM4));
  return 0;
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

// ids[m] = argmax_v of x[M, H] bf16 . dequant4(E4[V, H/2])^T; scale f32 [V]
// (group == 0) or [H/group, V]. bval/bidx: scratch of ceil(V / 128) * M each.
extern "C" int vbt_int4_matmul_t_argmax(const void* x, const void* E, const void* scale,
                                        void* bval, void* bidx, void* ids, int M, int V, int H,
                                        int group, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int kgroup, hi_rows;
  int rc = rows_plan(H, group, &kgroup, &hi_rows);
  if (rc != 0) return rc;
  static bool allowed = false;
  if (!allowed) {
    rc = allow_smem4(argmax4_block_kernel);
    if (rc != 0) return rc;
    allowed = true;
  }
  const int nblk = (V + BV - 1) / BV;
  argmax4_block_kernel<<<dim3(nblk, (M + BM - 1) / BM), 256, SMEM4, st>>>(
      (const bf16*)x, (const uint8_t*)E, (const float*)scale, (float*)bval, (int*)bidx, M, V, H,
      kgroup, hi_rows);
  VBT_CHECK_LAUNCH();
  argmax_reduce_kernel<<<M, 256, 0, st>>>((const float*)bval, (const int*)bidx, (int*)ids, M,
                                          nblk);
  VBT_CHECK_LAUNCH();
  return 0;
}

// y[M, V] f32 = x[M, H] bf16 . dequant4(E4[V, H/2])^T
extern "C" int vbt_int4_matmul_t(const void* x, const void* E, const void* scale, void* y,
                                 int M, int V, int H, int group, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int kgroup, hi_rows;
  int rc = rows_plan(H, group, &kgroup, &hi_rows);
  if (rc != 0) return rc;
  static bool allowed = false;
  if (!allowed) {
    rc = allow_smem4(logits4_block_kernel);
    if (rc != 0) return rc;
    allowed = true;
  }
  logits4_block_kernel<<<dim3((V + BV - 1) / BV, (M + BM - 1) / BM), 256, SMEM4, st>>>(
      (const bf16*)x, (const uint8_t*)E, (const float*)scale, (float*)y, M, V, H, kgroup,
      hi_rows);
  VBT_CHECK_LAUNCH();
  return 0;
}
