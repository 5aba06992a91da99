// Tiled bf16 matrix product with a fused bias / GELU epilogue:
//   out[M, N] = act(A[M, K] . B[K, N] + bias[N]),  act = identity or erf GELU
//
// Replaces: vlm_bridge_tpu/ops/matmul_kernels.py:_tiled_matmul_jit, both of
// its pallas_call sites (bodies _mm_kernel and _mm_bias_kernel): the ViT's
// projections under VLM_BRIDGE_VIT_MM. The TPU kernel keeps the whole
// contraction of a (block_m, block_n) tile in VMEM (an A tile of up to 4 MB);
// a block here has 227 KB of shared memory at most, so the contraction is a
// loop of BK-deep stages through a ring, and the accumulator lives in
// registers.
//
// Bound: operations. At the ViT shapes (M = 64 x 257 rows, K and N in
// 1024..4096) every byte read feeds several hundred multiply-adds, above the
// ~295 operations per byte at which the H100's bf16 tensor cores, not its
// HBM, are the limit: the least time is 2 M N K over 989 TFLOP/s. Only
// wgmma reaches that rate, so the design is Hopper's own:
//
// - TMA loads under mbarriers into a ring of STAGES stages. A stage holds a
//   128 x 64 tile of A (K-major: each row's 64 depths are one 128-byte line)
//   and two boxes of 64 depths x 64 columns of B, which is [K, N] with N
//   contiguous, the MN-major operand. Both use the 128-byte swizzle, so the
//   tiles in shared memory are what wgmma's descriptors read, and are
//   1024-byte aligned. Tensor maps are built on the host per call from the
//   pointers; the TMA zero-fills rows beyond M and depths beyond K, and a box
//   wholly beyond N is not loaded (its columns are never stored), so no shape
//   is padded (K and N multiples of 8: the maps' strides are 16-byte units).
// - wgmma.mma_async m64n128k16, both operands from shared memory; B is read
//   MN-major through the transpose bit, so the weights are used as the
//   caller holds them, with no transposed copy.
// - Persistent and ping-pong: one block an SM walks the 128 x 128 output
//   tiles, column tiles fastest, so that the blocks in flight share their
//   rows of A in the L2 (B, the weights, is at most 8 MB and stays there). A
//   block is a producer warpgroup, one thread of which issues the TMA, and
//   two consumer warpgroups that take the block's tiles in turn, each a whole
//   tile (2 x 64 accumulators a thread). An ordering barrier hands the
//   tensor cores from one warpgroup to the other once its tile's last stage
//   has arrived: while one runs its products, the other runs its epilogue,
//   so bias, GELU and stores stay off the tensor cores' path. (Two
//   warpgroups sharing one 128 x 256 tile read fewer bytes a product but
//   stop the tensor cores for every epilogue; PERF.md §6 has the A/B.)
// - Epilogue on the f32 accumulator: + bias (f32), erf GELU, one rounding at
//   the store, to bf16 or f32. bf16 leaves through shared memory and TMA
//   stores, which clip the ragged edge; f32 by guarded stores. No split of K
//   and no atomics: every output has one summation order, so two calls give
//   the same bits.
// - Registers: a consumer thread holds 128 accumulators. An SM sub-partition
//   has 16,384 registers and every third warp of a block, so a block of 9-12
//   warps starts at 168 a thread (a 288-thread build at 185 failed to
//   launch); the producer warpgroup gives its registers up (setmaxnreg 40)
//   and the consumers take 232 (2 x 232 + 40 = 3 x 168).

#include <type_traits>

#include "sm90.cuh"   // mbarriers, TMA, wgmma (wgmma_n128) and its fences, tensor maps

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int STAGES = 6;
// warps 0-7: the two consumer warpgroups; 8-11: the producer warpgroup
constexpr int THREADS = 384;
constexpr int A_BYTES = BM * BK * 2;      // a stage's A tile: 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;    // one 64 x 64 box of B: 8 KB
constexpr int STAGE_BYTES = A_BYTES + 2 * BOX_BYTES;
constexpr int SWIZZLE_ROW = 128;          // bytes in a line of the 128-byte swizzle
constexpr int ATOM_BYTES = 8 * SWIZZLE_ROW;   // 8 lines: the swizzle's repeat
// bf16 output leaves through shared memory, 64 rows at a time: each
// warpgroup stages 64 x 128 (two 64 x 64 boxes, 128-byte swizzle) for TMA
// stores. (Staging the whole tile in a fifth stage's room ran qkv 7 % faster
// but made ptxas spill the GELU instantiation: PERF.md §6.)
constexpr int OUT_WG_BYTES = 2 * BOX_BYTES;
constexpr int RING = STAGES * STAGE_BYTES;
// the ring, the staging, each warpgroup's bias (BN floats), the full, empty
// and ordering barriers, and slack to align the ring to 1024
constexpr int SMEM = RING + 2 * OUT_WG_BYTES + 2 * BN * 4 + (2 * STAGES + 2) * 8 + 1024;
static_assert(SMEM <= 232448, "shared memory of one block");

// GELU(x) = 0.5 x (1 + erf(x / sqrt 2)) = 0.5 x (2 - erfc(a)) for x >= 0 and
// 0.5 x erfc(a) for x < 0, a = |x| / sqrt 2, with erfc from Abramowitz &
// Stegun 7.1.26 (|error| <= 1.5e-7 against erf): one reciprocal, one
// exponential and five FMAs, no branch, where erff takes ~4x the
// instructions; for x < 0 it skips the cancellation of 1 + erf.
__device__ __forceinline__ float gelu_erf(float x) {
  const float a = fabsf(x) * 0.7071067811865476f;
  const float t = __fdividef(1.f, fmaf(0.3275911f, a, 1.f));
  float p = fmaf(1.061405429f, t, -1.453152027f);
  p = fmaf(p, t, 1.421413741f);
  p = fmaf(p, t, -0.284496736f);
  p = fmaf(p, t, 0.254829592f);
  const float q = p * t * __expf(-a * a);   // erfc(a)
  return 0.5f * x * (x >= 0.f ? 2.f - q : q);
}

template <typename OutT, bool GELU>
__global__ void __launch_bounds__(THREADS, 1)
tiled_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const __grid_constant__ CUtensorMap map_out, const float* __restrict__ bias,
                    OutT* __restrict__ out, int M, int N, int K) {
  constexpr bool TMA_OUT = std::is_same<OutT, bf16>::value;   // f32: guarded stores
  extern __shared__ unsigned char tm_smem[];
  // the ring at the first 1024-byte boundary (the swizzle's atoms must be aligned)
  const uint32_t ring = (smem_u32(tm_smem) + 1023u) & ~1023u;
  const uint32_t staged = ring + RING;                  // 2 x OUT_WG_BYTES
  const uint32_t biases = staged + 2 * OUT_WG_BYTES;    // 2 x BN floats
  const uint32_t full = biases + 2 * BN * 4;            // STAGES barriers: stage loaded
  const uint32_t empty = full + STAGES * 8;             // STAGES barriers: stage consumed
  const uint32_t order = empty + STAGES * 8;            // 2 barriers: warpgroup c's turn

  const int col_tiles = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * col_tiles;
  const int n_k = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;   // wg 2: the producer

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);    // the producer's arrive, plus the bytes
      mbar_init(empty + 8 * s, 4);   // lane 0 of each warp of the consuming warpgroup
    }
    mbar_init(order, 4);
    mbar_init(order + 8, 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full, tile after tile ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / col_tiles * BM, n0 = tile % col_tiles * BN;
        const int boxes = min(2, (N - n0 + 63) / 64);   // a box wholly beyond N: skipped
        for (int kb = 0; kb < n_k; ++kb) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t st = ring + s * STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, A_BYTES + boxes * BOX_BYTES);
          tma_load(st, &map_a, kb * BK, m0, bar);
          for (int j = 0; j < boxes; ++j)
            tma_load(st + A_BYTES + j * BOX_BYTES, &map_b, n0 + 64 * j, kb * BK, bar);
          if (++s == STAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup c takes the block's tiles c, c + 2, c + 4, ... ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int c = wg, warp = t / 32, lane = t % 32;
  const uint32_t my_bias = biases + c * BN * 4, out_s = staged + c * OUT_WG_BYTES;
  float acc[2][BN / 2];   // rows 0-63 and 64-127 of the tile
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[0][i] = acc[1][i] = 0.f;   // the first k16 step ignores them
  int turn = 0;
  for (int tile = blockIdx.x + c * gridDim.x; tile < tiles; tile += 2 * gridDim.x, ++turn) {
    const int m0 = tile / col_tiles * BM, n0 = tile % col_tiles * BN;
    // the tile's bias into this warpgroup's shared memory (zeros beyond N);
    // its epilogue's first barrier publishes it, and the last tile's
    // epilogue has read the old one
    if (t < BN / 2) {
      const int col = n0 + 2 * t;
      float2 bj = make_float2(0.f, 0.f);
      if (bias != nullptr && col < N) bj = *reinterpret_cast<const float2*>(bias + col);
      asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(my_bias + 8 * t), "f"(bj.x),
                   "f"(bj.y)
                   : "memory");
    }
    // Products. Stages are consumed in the producer's order: this tile's
    // k-blocks start at position (2 turn + c) n_k of the sequence. Warpgroup
    // c waits for its turn (the other one has seen its last stage loaded, so
    // every earlier stage is, and no parity below is a lap ahead).
    mbar_wait(order + 8 * c, (turn & 1) ^ (c == 0));
    const int pos = (2 * turn + c) * n_k;
    int s = pos % STAGES, prev = 0;
    uint32_t ph = (pos / STAGES) & 1;
    for (int kb = 0; kb < n_k; ++kb) {
      mbar_wait(full + 8 * s, ph);
      // every stage of this tile is loaded: the other warpgroup may start
      if (kb == n_k - 1 && lane == 0) mbar_arrive(order + 8 * (1 - c));
      // A: a k16 step is 32 bytes along the swizzled line, rows 64-127 are
      // 64 lines on. B: a k16 step is 16 lines (two 1024-byte atoms); LBO
      // steps between the two 64-column boxes, SBO between the atoms.
      const uint32_t a = ring + s * STAGE_BYTES, b = a + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = smem_desc(b + kk * 2 * ATOM_BYTES, BOX_BYTES, ATOM_BYTES);
        wgmma_n128(acc[0], smem_desc(a + kk * 32, 16, ATOM_BYTES), db, kb | kk);
        wgmma_n128(acc[1], smem_desc(a + 64 * SWIZZLE_ROW + kk * 32, 16, ATOM_BYTES), db, kb | kk);
      }
      wgmma_commit();
      // one group stays in flight: the stage before this one is done
      if (kb > 0) {
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      prev = s;
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (lane == 0) mbar_arrive(empty + 8 * prev);

    // a thread holds columns 8 j + 2 (lane % 4) + {0, 1} of rows r and r + 8
    // (h = 0, 1) of each 64-row half, for every j
    const int r = warp * 16 + lane / 4;
    // acc + bias (+ GELU) of one such pair
    auto pair = [&](const float (&d)[BN / 2], int j, int h) {
      const float2 bj = ld_shared_f2(my_bias + 4 * (8 * j + 2 * (lane % 4)));
      float v0 = d[4 * j + 2 * h] + bj.x, v1 = d[4 * j + 2 * h + 1] + bj.y;
      if (GELU) {
        v0 = gelu_erf(v0);
        v1 = gelu_erf(v1);
      }
      return make_float2(v0, v1);
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if constexpr (TMA_OUT) {
        // each 64-row half staged as two swizzled 64 x 64 boxes (row r's
        // 16-byte chunk ch at ch ^ (r % 8): a warp's stores hit 32 banks) and
        // stored by the TMA, which clips rows beyond M and columns beyond N
        if (t == 0) bulk_wait_read();   // the last stores have read the staging
        named_bar(2 + c, 128);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 v = pair(acc[half], j, h);
            __nv_bfloat162 p2 = __floats2bfloat162_rn(v.x, v.y);
            const int row = r + 8 * h;
            st_shared(out_s + (j / 8) * BOX_BYTES + row * SWIZZLE_ROW +
                          (((j % 8) ^ (row % 8)) << 4) + 4 * (lane % 4),
                      *reinterpret_cast<uint32_t*>(&p2));
          }
        fence_proxy_async();
        named_bar(2 + c, 128);
        if (t == 0 && m0 + 64 * half < M) {
          for (int box = 0; box < 2; ++box)
            if (n0 + 64 * box < N)
              tma_store(&map_out, out_s + box * BOX_BYTES, n0 + 64 * box, m0 + 64 * half);
          bulk_commit();
        }
      } else {
        named_bar(2 + c, 128);   // the bias is in
        const int row = m0 + 64 * half + r;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * (lane % 4);
          if (col >= N) continue;   // N % 8 == 0: col + 1 < N as well
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (row + 8 * h < M)
              *reinterpret_cast<float2*>(out + (size_t)(row + 8 * h) * N + col) =
                  pair(acc[half], j, h);
        }
      }
    }
    if (!TMA_OUT) named_bar(2 + c, 128);   // the bias is read before the next tile's
  }
  if (TMA_OUT && t == 0) bulk_wait();   // the staging stays until the last store is done
}

// ---- host: the launch ----

template <typename OutT, bool GELU>
int launch(const void* a, const void* b, const float* bias, OutT* out, int M, int N, int K,
           cudaStream_t st) {
  VBT_CHECK((cudaError_t)bind_device(a));
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_a, map_b, map_out = {};   // map_out: bf16 out only
  if (!make_map(enc, &map_a, a, M, K, BM) || !make_map(enc, &map_b, b, K, N, BK) ||
      (std::is_same<OutT, bf16>::value && !make_map(enc, &map_out, out, M, N, 64)))
    return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // one flag for each instantiation
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(tiled_matmul_kernel<OutT, GELU>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM));
    allowed = true;
  }
  int dev = 0, sms = 0;
  VBT_CHECK(cudaGetDevice(&dev));
  VBT_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  tiled_matmul_kernel<OutT, GELU>
      <<<min(tiles, sms), THREADS, SMEM, st>>>(map_a, map_b, map_out, bias, out, M, N, K);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// out[M, N] (bf16, or f32 when out_f32) = act(a[M, K] bf16 . b[K, N] bf16 +
// bias[N] f32); bias may be null; gelu != 0 applies the erf GELU. K and N
// must be multiples of 8, a, b and out 16-byte aligned.
extern "C" int vbt_tiled_matmul(const void* a, const void* b, const void* bias, void* out, int M,
                                int K, int N, int gelu, int out_f32, void* stream_ptr) {
  if (M < 1 || K % 8 != 0 || N % 8 != 0 || K < 8 || N < 8) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const float* bs = (const float*)bias;
  if (out_f32)
    return gelu ? launch<float, true>(a, b, bs, (float*)out, M, N, K, st)
                : launch<float, false>(a, b, bs, (float*)out, M, N, K, st);
  return gelu ? launch<bf16, true>(a, b, bs, (bf16*)out, M, N, K, st)
              : launch<bf16, false>(a, b, bs, (bf16*)out, M, N, K, st);
}
