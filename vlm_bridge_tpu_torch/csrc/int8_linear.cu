// Int8- and int4-weight linear layers over row-major [in, out] weights:
//   int8_matmul  y = (x . W) * scale                                  bf16 out
//   int8_mlp     y = (bf16(gelu_tanh(x.G * gs) * (x.U * us)) . D) * ds
//   int8_ffn     y = (bf16(gelu_erf(x.F1 * s1 + b1)) . F2) * s2 + b2
//   int4_mlp     y = bf16(bf16(gelu_tanh(x.G4) * (x.U4)) . D4), where W4 is
//                a nibble-packed weight dequantized with one scale per output
//                channel or one per (group of rows, output channel)
//
// Replaces: vlm_bridge_tpu/ops/quant.py:int8_matmul (body _int8_mm_kernel),
// vlm_bridge_tpu/ops/quant.py:int8_mlp (body _int8_mlp_kernel),
// vlm_bridge_tpu/ops/quant.py:int8_ffn (body _int8_ffn_kernel).
// Replaces: vlm_bridge_tpu/ops/quant.py:int4_mlp (bodies _int4_mlp_kernel and
// _int4_mlp_group_kernel). The TPU kernels walk a sequential grid and carry
// an f32 accumulator in VMEM from one step to the next; here blocks run in
// parallel, so the contraction is a loop inside the block and, where it is
// split over blocks, the blocks of one cluster add their slices through each
// other's shared memory.
//
// Bound: at decode (M = batch = 64 rows) each weight byte feeds 64
// multiply-adds (int4: 128), far below the ~295 operations per byte at which
// the H100's bf16 tensor cores, not its 3.35 TB/s of HBM, become the limit:
// the least time is the weights' bytes over the memory rate (9.4 MB for
// Gemma-2-2B's fused qkv, 63.7 MB for its MLP; int4: 31.9 MB of nibbles and
// 2.0 MB of scales in groups of 128). In the int8 vision tower (M = 64 x 257 =
// 16448 rows) every weight byte feeds 16448 multiply-adds: the tensor cores
// set the floor, 2 M N K over 989 TFLOP/s.
//
// Design (Hopper's own; scripts/int8_linear_torch.py times it). One product
// kernel, i8mm_kernel, serves the four functions:
// - The operands are read where they lie, by TMA into an mbarrier ring: x
//   bf16 [M, K] as wgmma's A operand (K-major, boxes of 64 depths under the
//   128-byte swizzle, rows past M and depths past K read as zeros), and the
//   weights int8 [K, N], N contiguous, exactly as quantize_int8(axis=0)
//   gives them, in byte boxes of 64 rows x 64 columns (rows past K read as
//   zeros; a box wholly past N is not loaded and its columns are never
//   stored). No copy of the weights in another order is kept.
// - The consumer warpgroups widen each stage's weight bytes to bf16 (exact,
//   |w| <= 127; sm90.cuh:widen4) into a 64 x 128 B tile in shared memory, in
//   the swizzled MN-major layout that tiled_matmul.cu's TMA gives its B
//   operand, and run wgmma m64n128k16 with both operands from shared memory
//   and B read through the transpose bit. The next stage is widened into the
//   second B tile while the products of this one run; one barrier a stage,
//   after every thread's fence.proxy.async and every warp's wait.
// - A unit is a row tile of x, a column tile of the output and a slice of
//   the contraction. A column tile is 128 columns of one weight, or (GeGLU)
//   64 columns of gate and the same 64 of up as the B tile's two halves, so
//   that both GeGLU operands of a column sit in one thread's accumulators.
// - Decode rows (M <= 128): i8mm_kernel<1, 1>, a block of one consumer
//   warpgroup (64 rows of x) and one producer warpgroup, two blocks an SM.
//   With 64 rows a matrix of 2304 columns has only 18 column tiles, so the
//   contraction is cut into `split` slices (ops/quant.contraction_split: up
//   to 8, as many clusters as run at once), one block each, launched as one
//   thread-block cluster: once every block's ring is spent, each copies its
//   f32 sums of block q's rows into block q's ring by one bulk copy, and
//   block q adds the slots in rank order 0, 1, ..., applies the epilogue and
//   stores them. No atomics and no scratch in device memory: the same inputs
//   give the same bits. Where split is 1 the block applies the epilogue
//   straight from its accumulators.
// - The tower's rows (M > 128): i8mm_kernel<2, 2>, persistent, one block an
//   SM walking 256 x 128 output tiles, column tiles fastest (the blocks in
//   flight share their rows of x in the L2), the contraction never split.
//   Two consumer warpgroups of 128 rows each share every widened B tile, so
//   a weight value is widened once for 256 rows; each runs two m64n128k16 a
//   k16 step (128 accumulators a thread, setmaxnreg 232; the producer
//   warpgroup gives its registers up, as in tiled_matmul.cu).
// - Epilogues on the f32 sums, one instantiation each: x scale (+ bias),
//   gelu_erf(x scale + bias), or GeGLU; one rounding to bf16. The unit's
//   scales and biases are fetched into registers a unit ahead and put in
//   shared memory as it starts, and its output rows leave through a staging
//   in shared memory (the spent ring, or the tower's spent B tile), so that
//   a warp stores whole rows.
//   int8_mlp and int8_ffn are two product launches in one C call; the bf16
//   hidden [M, F] (1.2 MB at M = 64) passes through device memory between
//   them.
// - int4 weights (INT4; int4_mlp, two launches: gate | up with GeGLU, then
//   down with the scale) take the decode form at every M, row tiles of 64.
//   They are read in the layout the quantizers give them: gate and up packed
//   over the whole contraction (byte row p of [H/2, F] holds rows p and
//   p + H/2: quantize_int4, "global"), down block by block (inside each block
//   of block_f rows, byte row r holds rows r and r + block_f/2:
//   repack_down_blockwise). One rule with a half-width `half` covers both:
//   packed row p holds row lo(p) = (p / half) 2 half + p % half of the
//   contraction in its low nibbles and row lo(p) + half in its high nibbles.
//   A stage brings 64 packed rows of the weights in the int8 byte boxes and
//   two boxes of x, at depths lo(p0) and lo(p0) + half (half is a multiple
//   of 64, so a box never straddles a block), three stages in the ring. A
//   stage is two sub-steps: the low nibbles widened into a B tile (exact,
//   sm90.cuh:widen8_nibbles) against the first x box, then the high nibbles
//   against the second; each sub-step's tile is widened while the previous
//   one's products run.
// - int4 scales in groups (GROUPED): the group size is a multiple of 64 that
//   divides half, so a sub-step lies in one group. The sum is kept in the
//   unit of the scale of the sub-step in hand: between two sub-steps each
//   column's sum is multiplied by the old scale over the new one, and after
//   the unit's last by its scale, which gives sum_g P_g s_g at one more f32
//   rounding a sub-step and no second accumulator (the decode form's 128
//   registers a thread hold one set of 64). A stage brings its two scale
//   rows of the tile's 128 columns by bulk copies beside its boxes; each
//   thread turns its column's into a factor, a row of 128 that every thread
//   reads its 32 columns' from. A scale below 1e-30 in magnitude counts as
//   1e-30 (as in tied_head.cu). The slices then leave a block already
//   scaled, and the epilogue multiplies by 1.
// - Tensor maps are encoded once for each (pointer, shape): a map holds
//   nothing else, so a cached one is right for whatever tensor lies there.

#include <mutex>
#include <unordered_map>

#include "linear_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int I8_BK = 64;                 // rows of the weights (depths of x) a stage
constexpr int I8_WBOX = I8_BK * 64;       // a weight box: 64 rows x 64 bytes
constexpr int I8_BBOX = I8_BK * 64 * 2;   // a 64-column half of the B tile, bf16
constexpr int I8_BTILE = 2 * I8_BBOX;     // the widened B tile: 64 x 128 bf16
constexpr int I8_ROW = 128 * 4;           // a row of 128 f32: a tile's scales or factors

// A block of WGS consumer warpgroups, each multiplying MT 64-row tiles of x by
// the whole B tile, and a producer warpgroup. WGS 1: the decode form. INT4:
// nibble-packed weights, two sub-steps a stage; GROUPED: their scales in
// groups of rows.
template <int WGS_, int MT_, bool INT4_ = false, bool GROUPED_ = false>
struct I8Shape {
  static constexpr int WGS = WGS_, MT = MT_;
  static constexpr bool DECODE = WGS == 1, INT4 = INT4_, GROUPED = GROUPED_;
  static_assert(DECODE || !INT4, "int4 weights take the decode form");
  static_assert(INT4 || !GROUPED, "groups of scales are int4's");
  static constexpr int SUB = INT4 ? 2 : 1;   // sub-steps a stage: int4's low, then high nibbles
  static constexpr int BM = 64 * MT * WGS;   // rows of x a unit
  static constexpr int THREADS = 128 * (WGS + 1);
  static constexpr int X_BOX = BM * I8_BK * 2;   // the x of a sub-step
  static constexpr int X_BYTES = SUB * X_BOX;
  static constexpr int SC_BYTES = GROUPED ? 2 * I8_ROW : 0;   // a stage's two scale rows
  static constexpr int STAGE_BYTES = X_BYTES + 2 * I8_WBOX + SC_BYTES;
  static constexpr int STAGES = INT4 ? 3 : 4;
  static constexpr int MIN_BLOCKS = DECODE ? 2 : 1;   // blocks an SM
  // the unit's scales and biases (the tower: two units', by unit parity), and
  // GROUPED's two rows of factors. The cluster's sums and the staging of
  // output rows lie in the spent ring and B tiles.
  static constexpr int PRM_BYTES = (DECODE ? 1 : 2) * 3 * I8_ROW + (GROUPED ? 2 * I8_ROW : 0);
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * I8_BTILE + PRM_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(SMEM * MIN_BLOCKS + 1024 * (MIN_BLOCKS - 1) <= 232448, "blocks an SM");
  // the cluster's slots, split x ceil(64 / split) rows of 128 f32 (at most 70
  // rows: split 7), in the ring; the block's own sums in the B tiles
  static_assert(!DECODE || (70 * I8_ROW <= STAGES * STAGE_BYTES &&
                            64 * I8_ROW <= 2 * I8_BTILE), "the sums fit");
};

struct I8Args {
  const float* s0;    // per-column scale (gate's under GeGLU; int4 in groups: [K / group, N])
  const float* s1;    // up's scale (GeGLU)
  const float* bias;  // per-column bias, or null
  void* out;          // [M, N] bf16
  int M, N, K;        // N: output columns (F under GeGLU); K: int4's packed rows
  int epi, split, dual;
  int half, group;    // int4: the packing's half-width; the scales' group (GROUPED)
};

__device__ __forceinline__ float gelu_tanh_f(float x) {
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

__device__ __forceinline__ float gelu_erf_f(float x) {
  return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
}

// the epilogue EPI of columns n, n + 1 from their f32 sums v (under GeGLU
// gate's, and up's in u); s0 / s1 / bias point at column n's scales and bias.
// A compile-time choice: each instantiation's unrolled epilogue holds its own
// code only (the four in one kernel ran the tower's epilogue several times
// slower on an H100: PERF.md).
template <int EPI>
__device__ __forceinline__ float2 i8_value(float2 v, float2 u, const float* s0, const float* s1,
                                           const float* bias) {
  if constexpr (EPI == I8_GEGLU) {
    return make_float2(gelu_tanh_f(v.x * s0[0]) * (u.x * s1[0]),
                       gelu_tanh_f(v.y * s0[1]) * (u.y * s1[1]));
  } else {
    const float2 y = make_float2(v.x * s0[0] + bias[0], v.y * s0[1] + bias[1]);
    if constexpr (EPI == I8_GELU_ERF) return make_float2(gelu_erf_f(y.x), gelu_erf_f(y.y));
    return y;
  }
}

// Output rows leave through shared memory, so that a warp's stores are whole
// rows: a staged row of `rb` bytes (a multiple of 128) keeps its 16-byte chunk
// c at c ^ (row % 8), which spreads a warp's pair writes (8 rows x 4 lanes)
// over the 32 banks.
__device__ __forceinline__ void stage_pair(uint32_t stage, int rb, int row, int col, float2 y,
                                           bool f32) {
  const int byte = col * (f32 ? 4 : 2), c = byte >> 4;
  const uint32_t at = stage + row * rb + (((c ^ (row & 7)) << 4) | (byte & 15));
  if (f32)
    asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(at), "f"(y.x), "f"(y.y) : "memory");
  else
    st_shared(at, pack_bf16(y.x, y.y));
}

// rows [0, rows) of a staged block to out rows m0 .. and columns n0 .., 16
// bytes a thread (nt threads from thread index ti), within M and N
__device__ __forceinline__ void stage_out(uint32_t stage, int rb, int rows, void* out, int M,
                                          int N, int m0, int n0, int ti, int nt) {
  const int es = 2, chunks = rb / 16;
  for (int idx = ti; idx < rows * chunks; idx += nt) {
    const int r = idx / chunks, c = idx % chunks, n = n0 + c * 16 / es;
    if (m0 + r >= M || n >= N) continue;
    const uint4 v = ld_shared_v4(stage + r * rb + ((c ^ (r & 7)) << 4));
    *reinterpret_cast<uint4*>(static_cast<char*>(out) + ((size_t)(m0 + r) * N + n) * es) = v;
  }
}

// out = EPI(X[M, K] . W[K, N]) over the units [blockIdx.x, units) in steps of
// gridDim.x (INT4: X[M, 2 K] . W4[2 K, N], K packed rows); with split > 1
// (decode only) one unit a block, the grid in clusters of split
template <int WGS_, int MT_, int EPI, bool INT4 = false, bool GROUPED = false>
__global__ void __launch_bounds__(I8Shape<WGS_, MT_, INT4, GROUPED>::THREADS,
                                  I8Shape<WGS_, MT_, INT4, GROUPED>::MIN_BLOCKS)
i8mm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w0map,
            const __grid_constant__ CUtensorMap w1map, const I8Args a) {
  using S = I8Shape<WGS_, MT_, INT4, GROUPED>;
  constexpr int WGS = S::WGS, MT = S::MT;
  constexpr bool DECODE = S::DECODE;
  extern __shared__ unsigned char i8_smem[];
  __shared__ __align__(8) uint64_t i8_bars[2 * S::STAGES + 1];
  const uint32_t base = smem_u32(i8_smem);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const uint32_t btiles = ring + S::STAGES * S::STAGE_BYTES;   // two B tiles
  float* const prms = reinterpret_cast<float*>(i8_smem + (btiles + 2 * I8_BTILE - base));
  auto fptr = [&](uint32_t at) { return reinterpret_cast<const float*>(i8_smem + (at - base)); };
  const uint32_t full = smem_u32(i8_bars), empty = full + 8 * S::STAGES;
  const uint32_t recv = empty + 8 * S::STAGES;   // decode: the cluster's sums have landed

  const int tn = a.dual ? 64 : 128;   // output columns a unit
  const int col_tiles = (a.N + tn - 1) / tn;
  const int chunks = (a.K + I8_BK - 1) / I8_BK;
  const int units = (a.M + S::BM - 1) / S::BM * col_tiles * a.split;
  // unit u: slice u % split of the contraction, column tile (u / split) %
  // col_tiles, row tile u / split / col_tiles; the slice's stages [c0, c1)
  struct Unit {
    int mb, nt, ks, c0, c1;
  };
  auto unit_of = [&](int u) {
    Unit r;
    r.ks = u % a.split;
    const int q = u / a.split;
    r.nt = q % col_tiles;
    r.mb = q / col_tiles;
    r.c0 = r.ks * chunks / a.split;
    r.c1 = (r.ks + 1) * chunks / a.split;
    return r;
  };
  const bool clustered = DECODE && a.split > 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 1);          // the producer's arrive, plus the bytes
      mbar_init(empty + 8 * s, 4 * WGS);   // lane 0 of each consumer warp
    }
    mbar_init(recv, 1);   // this block's expect_tx, plus the bytes the cluster pushes
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  if (wg == WGS) {
    // ---- the producer: stage i into slot i % STAGES once its last use is done ----
    if constexpr (!DECODE) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tw == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w0map)) : "memory");
      // at decode the weights are read once: they must not push x out of the L2
      const uint64_t pol = l2_evict_first();
      int i = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit t = unit_of(u);
        const int n0 = t.nt * tn;
        // the second weight box: up's columns (GeGLU), or the tile's last 64
        const bool second = a.dual || n0 + 64 < a.N;
        const CUtensorMap* m1 = a.dual ? &w1map : &w0map;
        const int n1 = a.dual ? n0 : n0 + 64;
        // GROUPED: the scales of the tile's columns a row (up's after gate's)
        const int sc_cols = min(a.dual ? 64 : 128, a.N - n0);
        const uint32_t sc_bytes = GROUPED ? 2 * (a.dual ? 2 : 1) * sc_cols * 4 : 0;
        for (int c = t.c0; c < t.c1; ++c, ++i) {
          const int s = i % S::STAGES;
          if (i >= S::STAGES) mbar_wait(empty + 8 * s, (i / S::STAGES - 1) & 1);
          const uint32_t st = ring + s * S::STAGE_BYTES, bar = full + 8 * s;
          mbar_expect_tx(bar, S::X_BYTES + (second ? 2 : 1) * I8_WBOX + sc_bytes);
          if constexpr (INT4) {   // x at depths lo(p0) (low nibbles) and lo(p0) + half
            const int p0 = c * I8_BK, lo = p0 / a.half * 2 * a.half + p0 % a.half;
            tma_load(st, &xmap, lo, t.mb * S::BM, bar);
            tma_load(st + S::X_BOX, &xmap, lo + a.half, t.mb * S::BM, bar);
            if constexpr (GROUPED) {   // the low and the high half's scale rows
              const uint32_t sc = st + S::X_BYTES + 2 * I8_WBOX;
              for (int h = 0; h < 2; ++h) {
                const size_t row = (size_t)((lo + h * a.half) / a.group) * a.N + n0;
                bulk_load(sc + h * I8_ROW, a.s0 + row, sc_cols * 4, bar);
                if (a.dual) bulk_load(sc + h * I8_ROW + 256, a.s1 + row, sc_cols * 4, bar);
              }
            }
          } else {
            tma_load(st, &xmap, c * I8_BK, t.mb * S::BM, bar);
          }
          const uint32_t wb = st + S::X_BYTES;
          if constexpr (DECODE) {
            tma_load_hint(wb, &w0map, n0, c * I8_BK, bar, pol);
            if (second) tma_load_hint(wb + I8_WBOX, m1, n1, c * I8_BK, bar, pol);
          } else {   // the tower: every row tile reads the weights again
            tma_load(wb, &w0map, n0, c * I8_BK, bar);
            if (second) tma_load(wb + I8_WBOX, m1, n1, c * I8_BK, bar);
          }
        }
      }
    }
    __syncwarp();
    if (clustered) {   // the consumers' two cluster barriers (below)
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  // ---- the consumers: warpgroup wg multiplies rows (wg MT + mt) 64 .. of each unit ----
  if constexpr (!DECODE) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = tw / 32, lane = tw % 32, g = lane / 4, t4 = lane % 4;
  // [mt][4 j + 2 h + e]: row 16 warp + g + 8 h of 64-row tile mt, B-tile
  // column 8 j + 2 t4 + e
  float acc[MT][64];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[mt][x] = 0.f;

  // The weight bytes of the stage at st into the B tile at bt, by all 128 WGS
  // consumer threads: a thread takes 16-byte pieces of the two 64 x 64 boxes
  // (a quarter warp: two rows x four pieces, 128 bytes, no bank conflict) and
  // stores each one's 16 bf16 as two 16-byte chunks of its row of the tile's
  // half, chunk c at c ^ (row % 8) under the swizzle. INT4: sub-step h's
  // nibbles of the bytes, the low (h = 0) or the high ones.
  auto widen = [&](uint32_t st, int h, uint32_t bt) {
    const uint32_t wb = st + S::X_BYTES;
#pragma unroll
    for (int it = 0; it < 2 * 64 * 4 / (128 * WGS); ++it) {
      const int q = threadIdx.x + 128 * WGS * it;
      const int box = q / 256, row = (q / 4) % 64, p = q % 4, sw = row % 8;
      const uint4 r = ld_shared_v4(wb + box * I8_WBOX + row * 64 + 16 * p);
      uint32_t b[8];
      if constexpr (INT4) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t l0, l1, h0, h1;
          widen8_nibbles(word_of(r, w) ^ 0x88888888u, l0, l1, h0, h1);
          b[2 * w] = h ? h0 : l0;
          b[2 * w + 1] = h ? h1 : l1;
        }
      } else {
        widen4(r.x, b[0], b[1]);
        widen4(r.y, b[2], b[3]);
        widen4(r.z, b[4], b[5]);
        widen4(r.w, b[6], b[7]);
      }
      const uint32_t d = bt + box * I8_BBOX + row * 128;
      st_shared_v4(d + (((2 * p) ^ sw) << 4), make_uint4(b[0], b[1], b[2], b[3]));
      st_shared_v4(d + (((2 * p + 1) ^ sw) << 4), make_uint4(b[4], b[5], b[6], b[7]));
    }
  };
  // acc += x rows (at xs) . B tile over a sub-step's 64 depths, committed;
  // the products run on while the caller goes on. B: a k16 step is 16 rows
  // (two 1024-byte atoms); LBO steps between the two 64-column halves. A: 32
  // bytes along each swizzled row.
  auto products = [&](uint32_t xs, uint32_t bt) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < I8_BK / 16; ++kk) {
      const uint64_t db = smem_desc(bt + kk * 2048, I8_BBOX, 1024);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        wgmma_n128(acc[mt], smem_desc(xs + (wg * MT + mt) * 64 * 128 + kk * 32, 16, 1024), db, 1);
    }
    wgmma_commit();
  };
  // the unit's output column of accumulator column group j (e = 0); under
  // GeGLU groups 0-7 are gate's and 8-15 up's of the same columns
  auto col_of = [&](int j) { return 8 * (j & (a.dual ? 7 : 15)) + 2 * t4; };
  auto is_gate = [&](int j) { return !a.dual || j < 8; };
  // A unit's scales and biases (column threadIdx.x < tn of its tile) are
  // fetched into registers a unit ahead, so that no thread waits on them, and
  // put into prm as the unit starts; its epilogue reads them after the
  // stages' barriers.
  // GROUPED: the sums leave the mainloop scaled, so the epilogue's are 1.
  float pv[3];
  auto fetch_prm = [&](int u) {
    const int n = unit_of(u).nt * tn + threadIdx.x;
    const bool in = u < units && threadIdx.x < tn && n < a.N;
    pv[0] = in ? (GROUPED ? 1.f : a.s0[n]) : 0.f;
    pv[1] = a.dual && in ? (GROUPED ? 1.f : a.s1[n]) : 0.f;
    pv[2] = a.bias != nullptr && in ? a.bias[n] : 0.f;
  };
  auto put_prm = [&](float* prm) {
    if (threadIdx.x < tn) prm[threadIdx.x] = pv[0], prm[128 + threadIdx.x] = pv[1],
                          prm[256 + threadIdx.x] = pv[2];
  };

  // GROUPED: column tw's factor of the sub-step h of the stage at st into
  // factor row `row`: its scale over the next sub-step's (this stage's high
  // half, or the low half of the stage at st1), or, after the unit's last
  // sub-step, its scale itself.
  float* const fac = prms + (DECODE ? 1 : 2) * 3 * 128;
  auto factor = [&](uint32_t st, int h, uint32_t st1, bool last, int row) {
    auto nz = [](float v) { return fabsf(v) < 1e-30f ? 1e-30f : v; };
    const uint32_t sc = S::X_BYTES + 2 * I8_WBOX + tw * 4;
    const float cur = nz(*fptr(st + sc + h * I8_ROW));
    fac[row * 128 + tw] =
        last ? cur : __fdividef(cur, nz(*fptr((h == 0 ? st + I8_ROW : st1) + sc)));
  };
  auto rescale = [&](int row) {   // acc *= factor row `row`, column by column
    const float* fp = fac + row * 128 + 2 * t4;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 f = *reinterpret_cast<const float2*>(fp + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[0][4 * j + 2 * h] *= f.x, acc[0][4 * j + 2 * h + 1] *= f.y;
    }
  };

  int u = blockIdx.x, i = 0, k = 0;   // i: the block's stages so far; k: its units
  fetch_prm(u);
  if (u < units) {
    mbar_wait(full, 0);
    widen(ring, 0, btiles);
    fence_proxy_async();
    named_bar(1, 128 * WGS);
  }
  for (; u < units; u += gridDim.x, ++k) {
    const Unit t = unit_of(u);
    const bool more_units = u + (int)gridDim.x < units;
    float* const prm = prms + (k & 1) * 3 * 128;
    put_prm(prm);
    fetch_prm(u + gridDim.x);
    for (int c = t.c0; c < t.c1; ++c, ++i) {
      const int s = i % S::STAGES;
      if constexpr (!S::INT4) {   // one sub-step a stage
        products(ring + s * S::STAGE_BYTES, btiles + (i % 2) * I8_BTILE);
        if (c + 1 < t.c1 || more_units) {   // the next stage, into the other B tile
          const int s1 = (i + 1) % S::STAGES;
          mbar_wait(full + 8 * s1, ((i + 1) / S::STAGES) & 1);
          widen(ring + s1 * S::STAGE_BYTES, 0, btiles + ((i + 1) % 2) * I8_BTILE);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
        fence_proxy_async();   // the widened tile, before the tensor cores read it
        if (lane == 0) mbar_arrive(empty + 8 * s);
        named_bar(1, 128 * WGS);
      } else {
        const uint32_t st = ring + s * S::STAGE_BYTES;
        const uint32_t st1 = ring + ((i + 1) % S::STAGES) * S::STAGE_BYTES;
#pragma unroll
        for (int h = 0; h < 2; ++h) {   // int4: the low, then the high nibbles
          const int j = 2 * i + h;   // the block's sub-steps so far: B tile j % 2
          const bool stage_end = h == 1;
          products(st + h * S::X_BOX, btiles + (j % 2) * I8_BTILE);
          // the next sub-step, into the other B tile: this stage's high nibbles,
          // or the next stage
          if (!stage_end) {
            widen(st, h + 1, btiles + ((j + 1) % 2) * I8_BTILE);
          } else if (c + 1 < t.c1 || more_units) {
            mbar_wait(full + 8 * ((i + 1) % S::STAGES), ((i + 1) / S::STAGES) & 1);
            widen(st1, 0, btiles + ((j + 1) % 2) * I8_BTILE);
          }
          if constexpr (GROUPED) factor(st, h, st1, stage_end && c + 1 == t.c1, j % 2);
          wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
          fence_proxy_async();   // the widened tile, before the tensor cores read it
          if (stage_end) {
            if constexpr (GROUPED) __syncwarp();   // every lane has read the stage's scales
            if (lane == 0) mbar_arrive(empty + 8 * s);
          }
          named_bar(1, 128 * WGS);
          if constexpr (GROUPED) rescale(j % 2);
        }
      }
    }
    if (a.split == 1) {   // the epilogue from the accumulators, through a staging of rows
      const int n0 = t.nt * tn;
      const int rb = tn * 2;   // bytes of a staged row
      // decode: the unit's 64 x tn tile in the spent ring; the tower: each
      // warpgroup's 64-row tiles in turn, 8 KB at a time, in its half of the
      // spent B tile (the last stage's; the other holds the next unit's first).
      // (TMA stores of the tower's rows, which run on under the next unit,
      // were slower on an H100: PERF.md.)
      const uint32_t stage = DECODE ? ring : btiles + ((i - 1) % 2) * I8_BTILE + wg * 8192;
      const int rp = DECODE ? 64 : min(64, 8192 / rb);   // rows a pass
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m0 = t.mb * S::BM + (wg * MT + mt) * 64;
        for (int pass = 0; pass < 64 / rp; ++pass) {
          named_bar(2 + wg, 128);   // the staging's last rows have left
          if (warp * 16 / rp == pass) {
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              const int c = col_of(j), jj = (j + 8) % 16;   // jj: up's under GeGLU
              if (is_gate(j)) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                  const float2 y = i8_value<EPI>(
                      make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]),
                      make_float2(acc[mt][4 * jj + 2 * h], acc[mt][4 * jj + 2 * h + 1]),
                      prm + c, prm + 128 + c, prm + 256 + c);
                  stage_pair(stage, rb, warp * 16 + g + 8 * h - pass * rp, c, y, false);
                }
              }
            }
          }
          named_bar(2 + wg, 128);
          stage_out(stage, rb, rp, a.out, a.M, a.N, m0 + pass * rp, n0, tw, 128);
        }
#pragma unroll
        for (int x = 0; x < 64; ++x) acc[mt][x] = 0.f;
      }
      // the tower: the next unit widens into this staging
      if constexpr (!DECODE) named_bar(1, 128 * WGS);
    }
  }

  if constexpr (DECODE) {
    if (clustered) {
      // The cluster's blocks are the unit's slices, rank = slice. Block q owns
      // rows q rmax .. (q + 1) rmax - 1 of the tile. Each block stages its
      // sums (rows of 128 f32, 16-byte chunks swizzled by row) in its spent B
      // tiles; once every ring is spent, it copies block q's rows into block
      // q's ring (the slot of its own rank) by one bulk copy each, completing
      // on block q's `recv` barrier, and block q adds the slots in rank
      // order. The last cluster barrier keeps every block until the copies
      // out of its staging are done.
      const Unit t = unit_of(blockIdx.x);
      const int rows = min(64, a.M - t.mb * 64), rmax = (64 + a.split - 1) / a.split;
      const uint32_t staging = btiles;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          stage_pair(staging, 512, warp * 16 + g + 8 * h, is_gate(j) ? col_of(j) : 64 + col_of(j),
                     make_float2(acc[0][4 * j + 2 * h], acc[0][4 * j + 2 * h + 1]), true);
      fence_proxy_async();   // the staging, before the bulk copies read it
      cluster_sync();        // every ring of the cluster is spent
      const int own = max(0, min(rmax, rows - t.ks * rmax));   // rows this block adds
      if (tw == 0) {
        if (own > 0) mbar_expect_tx(recv, a.split * own * 512);
        for (int q = 0; q < a.split; ++q) {
          const int n = min(rmax, rows - q * rmax);
          if (n > 0)
            asm volatile(
                "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
                " [%0], [%1], %2, [%3];\n" ::"r"(cluster_addr(ring + t.ks * rmax * 512, q)),
                "r"(staging + q * rmax * 512), "r"(n * 512), "r"(cluster_addr(recv, q))
                : "memory");
        }
      }
      if (own > 0) mbar_wait(recv, 0);
      const int r0 = t.ks * rmax;
      const int quads = tn / 4;   // output column quads a row
      for (int idx = tw; idx < own * quads; idx += 128) {
        const int lr = idx / quads, c = 4 * (idx % quads), n = t.nt * tn + c;
        if (n >= a.N) continue;
        const int sw = (r0 + lr) & 7;   // the pusher's swizzle of tile row r0 + lr
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f), w = v;
#pragma unroll 4
        for (int q = 0; q < 8; ++q) {
          if (q < a.split) {   // in rank order
            const uint32_t row = ring + (q * rmax + lr) * 512;
            const uint4 x = ld_shared_v4(row + (((c / 4) ^ sw) << 4));
            v.x += __uint_as_float(x.x), v.y += __uint_as_float(x.y);
            v.z += __uint_as_float(x.z), v.w += __uint_as_float(x.w);
            if (a.dual) {   // up's columns, 64 on
              const uint4 y = ld_shared_v4(row + (((c / 4 + 16) ^ sw) << 4));
              w.x += __uint_as_float(y.x), w.y += __uint_as_float(y.y);
              w.z += __uint_as_float(y.z), w.w += __uint_as_float(y.w);
            }
          }
        }
        const float2 y0 = i8_value<EPI>(make_float2(v.x, v.y), make_float2(w.x, w.y), prms + c,
                                        prms + 128 + c, prms + 256 + c);
        const float2 y1 = i8_value<EPI>(make_float2(v.z, v.w), make_float2(w.z, w.w),
                                        prms + c + 2, prms + 130 + c, prms + 258 + c);
        const size_t o = (size_t)(t.mb * 64 + r0 + lr) * a.N + n;   // one 8- or 16-byte store
        *reinterpret_cast<uint2*>(static_cast<bf16*>(a.out) + o) =
            make_uint2(pack_bf16(y0.x, y0.y), pack_bf16(y1.x, y1.y));
      }
      cluster_sync();   // every copy out of this block's staging is done
    }
  }
}

// ---- host ----

struct MapKey {
  const void* p;
  int rows, cols, box_rows, bytes;
  bool operator==(const MapKey& o) const {
    return p == o.p && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           bytes == o.bytes;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    for (int v : {k.rows, k.cols, k.box_rows, k.bytes}) h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

// The tensor map of a bf16 [rows, cols] matrix in boxes of box_rows x 64
// columns under the 128-byte swizzle, or (bytes) of an int8 one in unswizzled
// boxes of box_rows x 64 bytes; encoded once for each key
int cached_map(CUtensorMap* out, const void* p, int rows, int cols, int box_rows, bool bytes) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{p, rows, cols, box_rows, bytes ? 1 : 0};
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) {
      *out = it->second;
      return 0;
    }
  }
  VBT_CHECK((cudaError_t)bind_device(p));   // the encoder is a driver call
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const bool ok = bytes ? make_byte_map(enc, out, p, rows, cols, box_rows, 64, false)
                        : make_map(enc, out, p, rows, cols, box_rows);
  if (!ok) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *out);
  return 0;
}

template <typename S, int EPI>
int i8mm_launch(const bf16* X, const int8_t* W0, const int8_t* W1, const I8Args& a,
                cudaStream_t st) {
  auto kernel = i8mm_kernel<S::WGS, S::MT, EPI, S::INT4, S::GROUPED>;
  CUtensorMap xm, w0m, w1m;
  // INT4: a.K counts packed rows, each two depths of x
  int rc = cached_map(&xm, X, a.M, S::INT4 ? 2 * a.K : a.K, S::BM, false);
  if (!rc) rc = cached_map(&w0m, W0, a.K, a.N, I8_BK, true);
  if (!rc) rc = cached_map(&w1m, a.dual ? W1 : W0, a.K, a.N, I8_BK, true);
  if (rc) return rc;
  static bool allowed = false;   // one flag for each instantiation
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM));
    allowed = true;
  }
  const int tn = a.dual ? 64 : 128;
  const int units = (a.M + S::BM - 1) / S::BM * ((a.N + tn - 1) / tn) * a.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S::DECODE ? units : min(units, sm_count()));
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.split > 1 ? 1 : 0;
  VBT_CHECK(cudaLaunchKernelEx(&cfg, kernel, xm, w0m, w1m, a));
  VBT_CHECK_LAUNCH();
  return 0;
}

// one instantiation for each epilogue
template <typename S>
int i8mm_form(const bf16* X, const int8_t* W0, const int8_t* W1, const I8Args& a,
              cudaStream_t st) {
  switch (a.epi) {
    case I8_SCALE: return i8mm_launch<S, I8_SCALE>(X, W0, W1, a, st);
    case I8_GEGLU: return i8mm_launch<S, I8_GEGLU>(X, W0, W1, a, st);
    case I8_GELU_ERF: return i8mm_launch<S, I8_GELU_ERF>(X, W0, W1, a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the decode form and the tower's; int4's decode form, per channel or in groups
using I8Decode = I8Shape<1, 1>;
using I8Tower = I8Shape<2, 2>;
template <bool GROUPED>
using I4Decode = I8Shape<1, 1, true, GROUPED>;

// The clusters of `split` blocks of the decode form S that the current device
// runs at once (cudaOccupancyMaxActiveClusters), or -1 on an error: the split
// plan keeps a product's clusters to one wave.
template <typename S>
int clusters_of(int split) {
  auto kernel = i8mm_kernel<S::WGS, S::MT, I8_SCALE, S::INT4, S::GROUPED>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM) !=
      cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split * 32);
  cfg.blockDim = dim3(S::THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// out = EPI(X[M, 2 Kp] . W4[2 Kp, N]) over nibble-packed weights (Kp packed
// rows of N bytes, `half` as in the header), GeGLU over gate W0 and up W1 or
// the scale; group 0: scales per column, else s0 / s1 [2 Kp / group, N]
template <bool GROUPED>
int launch_i4mm(const bf16* X, const void* W0, const void* W1, int M, int N, int Kp, int half,
                int group, int epi, const float* s0, const float* s1, bf16* out, int split,
                cudaStream_t st) {
  const I8Args a{s0, s1, nullptr, out, M, N, Kp, epi, split, W1 != nullptr ? 1 : 0, half, group};
  const int8_t *w0 = (const int8_t*)W0, *w1 = (const int8_t*)W1;
  return epi == I8_GEGLU ? i8mm_launch<I4Decode<GROUPED>, I8_GEGLU>(X, w0, w1, a, st)
                         : i8mm_launch<I4Decode<GROUPED>, I8_SCALE>(X, w0, w1, a, st);
}

}  // namespace

// Declared in linear_common.cuh.
int launch_i8mm(const bf16* X, const int8_t* W0, const int8_t* W1, int M, int N, int K, int epi,
                const float* s0, const float* s1, const float* bias, void* out, int split,
                cudaStream_t st) {
  const int chunks = (K + I8_BK - 1) / I8_BK;
  if (M < 1 || K < 8 || N < 16 || K % 8 != 0 || N % 16 != 0 || split < 1 || split > 8 ||
      split > chunks || (split > 1 && M > 128) || (epi == I8_GEGLU) != (W1 != nullptr))
    return (int)cudaErrorInvalidValue;
  const I8Args a{s0, s1, bias, out, M, N, K, epi, split, W1 != nullptr ? 1 : 0, 0, 0};
  return M <= 128 ? i8mm_form<I8Decode>(X, W0, W1, a, st) : i8mm_form<I8Tower>(X, W0, W1, a, st);
}

// The clusters of `split` blocks that the current device runs at once, of the
// int8 decode form or (vbt_int4_clusters) of the int4 one, per channel or in
// groups; -1 on an error
extern "C" int vbt_int8_clusters(int split, void* stream_ptr) {
  (void)stream_ptr;
  return clusters_of<I8Decode>(split);
}

extern "C" int vbt_int4_clusters(int split, int grouped, void* stream_ptr) {
  (void)stream_ptr;
  return grouped ? clusters_of<I4Decode<true>>(split) : clusters_of<I4Decode<false>>(split);
}

// y[M, N] bf16 = (x[M, K] bf16 . w[K, N] int8) * scale[N], the contraction in
// `split` slices (1 when M > 128)
extern "C" int vbt_int8_matmul(const void* x, const void* w, const void* scale, void* y, int M,
                               int K, int N, int split, void* stream_ptr) {
  return launch_i8mm((const bf16*)x, (const int8_t*)w, nullptr, M, N, K, I8_SCALE,
                     (const float*)scale, nullptr, nullptr, y, split, (cudaStream_t)stream_ptr);
}

// Gemma's GeGLU MLP. gate, up: int8 [H, F]; down: int8 [F, H]; hidden: bf16
// [M, F]; split1 / split2: the two products' slices.
extern "C" int vbt_int8_mlp(const void* x, const void* gate, const void* up, const void* gs,
                            const void* us, const void* down, const void* ds, void* hidden,
                            void* y, int M, int H, int F, int split1, int split2,
                            void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int rc = launch_i8mm((const bf16*)x, (const int8_t*)gate, (const int8_t*)up, M, F, H, I8_GEGLU,
                       (const float*)gs, (const float*)us, nullptr, hidden, split1, st);
  if (rc != 0) return rc;
  return launch_i8mm((const bf16*)hidden, (const int8_t*)down, nullptr, M, H, F, I8_SCALE,
                     (const float*)ds, nullptr, nullptr, y, split2, st);
}

// The bridge's biased FFN. fc1: int8 [H, F]; fc2: int8 [F, H]; hidden: bf16
// [M, F]; split1 / split2: the two products' slices.
extern "C" int vbt_int8_ffn(const void* x, const void* fc1, const void* s1, const void* b1,
                            const void* fc2, const void* s2, const void* b2, void* hidden,
                            void* y, int M, int H, int F, int split1, int split2,
                            void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  int rc = launch_i8mm((const bf16*)x, (const int8_t*)fc1, nullptr, M, F, H, I8_GELU_ERF,
                       (const float*)s1, nullptr, (const float*)b1, hidden, split1, st);
  if (rc != 0) return rc;
  return launch_i8mm((const bf16*)hidden, (const int8_t*)fc2, nullptr, M, H, F, I8_SCALE,
                     (const float*)s2, nullptr, (const float*)b2, y, split2, st);
}

// Gemma's GeGLU MLP over int4 weights, two product launches: gate | up with
// the GeGLU epilogue into the bf16 hidden [M, F], then down with the scale.
// gate, up: packed [H/2, F] (global); down: packed [F/2, H] (block-local,
// block_f); group 0: scales gs, us [F] and ds [H], else gs, us [H/group, F]
// and ds [F/group, H]; split1 / split2: the two products' slices.
extern "C" int vbt_int4_mlp(const void* x, const void* gate, const void* up, const void* gs,
                            const void* us, const void* down, const void* ds, void* hidden,
                            void* y, int M, int H, int F, int block_f, int group, int split1,
                            int split2, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int hh = H / 2, hb = block_f / 2;   // the packings' half-widths
  if (M < 1 || H % 128 != 0 || block_f % 128 != 0 || F % block_f != 0 || split1 < 1 ||
      split2 < 1 || split1 > 8 || split2 > 8 || split1 > hh / I8_BK || split2 > F / 2 / I8_BK ||
      (group != 0 && (group % I8_BK != 0 || hh % group != 0 || hb % group != 0)))
    return (int)cudaErrorInvalidValue;
  auto product = group ? launch_i4mm<true> : launch_i4mm<false>;
  const int rc = product((const bf16*)x, gate, up, M, F, hh, hh, group, I8_GEGLU,
                         (const float*)gs, (const float*)us, (bf16*)hidden, split1, st);
  if (rc != 0) return rc;
  return product((const bf16*)hidden, down, nullptr, M, H, F / 2, hb, group, I8_SCALE,
                 (const float*)ds, nullptr, (bf16*)y, split2, st);
}
