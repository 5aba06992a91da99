// Flash attention forward for Hopper: TMA loads under an mbarrier ring, both
// products on wgmma, q, k and v read where they lie.
//
// Replaces: vlm_bridge_tpu/ops/flash_attention.py:_flash_fwd (pallas_call at
// :216, body _fwd_kernel :250). The backward kernels are flash_bwd.cu.
//
// What it computes. q [B, T, H, D], k / v [B, S, KH, D] bf16, D in {64, 128,
// 256}, G = H / KH query heads a kv head, kv_lens [B]. Logits = (q . k) *
// scale in f32, then tanh(x / cap) * cap, then the mask
//   kpos < kv_len  and  (causal: kpos <= qpos)  and  (window: kpos > qpos - W)
// with qpos = t + q_offset (S - T when causal). A running max and sum per
// row, p rounded to bf16 before p . v, out (bf16, [B, T, H, D] contiguous) and
// the natural-log lse [B, H, T] (f32). A row with empty support gives out = 0
// and lse = -2.3819763e38. Tiles wholly outside kv_len, the causal diagonal
// or the window are skipped, not masked.
//
// Bound: bytes. q, k, v and out once: at the train step's Gemma shape (B 8,
// T = S 256, H 8, KH 4, D 256) ~25 MB, 7.5 us at 3.35 TB/s, against ~2 GFLOP
// (2 us at the bf16 tensor-core peak); the ViT's encode (B 64, T 257, H 16,
// D 64) 135 MB, 40 us. So the design keeps the [T, S] logits out of device
// memory, reads each tensor where the caller holds it (the ViT's q, k and v
// are column views of one fused projection: no copies), and keeps loads in
// flight while the tensor cores work:
//
// - A block is a producer warpgroup (one thread issues the TMA) and two
//   consumer warpgroups of 64 query rows each, which share every K / V stage.
//   Work comes in units: two items of one (batch, kv head), an item being
//   (query head, 64-row tile), ordered tile-major: at G = 2 the two query
//   heads of one kv head on the same rows, at G = 1 two neighbouring row tiles
//   of one head. At D 256 a unit is one item whose O columns the two
//   warpgroups split (see Fwd). A tail tile (T = 257: one row) is one
//   warpgroup's item; the other idles through that unit. A warpgroup skips a
//   key tile outside its own range but still waits for it and releases it,
//   so the ring's phases stay in step.
// - Persistent: one block an SM walks the units (causal: the longest of all
//   heads first; else head by head, so that the blocks in flight share their
//   heads' K and V in the L2). The producer loads each unit's Q into one of
//   two buffers while the consumers work on the last unit, and keeps the K /
//   V ring full across units; out leaves through a staging buffer of its own
//   by TMA stores, so neither waits on the other.
// - Tensor maps are 4-D, (D, heads, rows, batch) with the caller's strides
//   (multiples of 16 bytes, D contiguous), so a tile that runs past T or S
//   reads zeros, not the next batch's rows, and the output's TMA store clips
//   rows past T. Under the 128-byte swizzle a box is 64 bf16 wide: a row of
//   D takes D / 64 panels. K and V of a stage have a barrier each, so S =
//   Q . K^T starts before V has landed.
// - S = Q . K^T: wgmma with both operands in shared memory, K-major (K's
//   natural layout). O += P . V: P from registers (the S accumulator, rounded
//   to bf16 and packed: the accumulator layout of two adjacent 8-column
//   groups is the A fragment of one k16 step), V the MN-major B operand
//   (transpose bit set; LBO steps between the 64-column panels, SBO between
//   8-line atoms), as tiled_matmul.cu holds its B. Each product is waited for
//   before the next step; the two warpgroups' steps interleave on the SM.
//   (Running tile j - 1's P . V under tile j's softmax was slower on the card
//   at every shape: PERF.md.)
// - Softmax in log2 units: exp2 with scale * log2 e folded into one FMA; the
//   soft-cap's tanh as 1 - 2 / (exp2(2x log2 e) + 1), with an odd series
//   below |x| = 1/4 where that form cancels (tanh.approx errs ~2^-11, which a
//   cap of 50 makes 0.025 in a logit). Only the kv_len tile, the causal
//   diagonal and the window's edge are masked element by element, and the
//   8-column groups past the last key a warpgroup's rows see take no
//   exponential: the exponentials bound the softmax at D 64.
// - Registers: ptxas gives a thread of this 12-warp block 168 registers (the
//   setmaxnreg 40 / 232 split changes nothing at compile time), which holds
//   O (D 64: 32, D 128: 64, D 256: half the columns, 64) beside S and P.
// - Keys a stage (BN) and ring depth by D, in 225 KB of shared memory beside
//   two Q buffers and the staging: D 64: 128 keys, 5 stages; D 128: 64 keys,
//   4 stages (128 keys spill with the softmax's variants); D 256: 64 keys,
//   2 stages.

#include "sm90.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;
constexpr int ROWS = 64;        // query rows of a consumer warpgroup (wgmma's M)
constexpr int THREADS = 384;    // warpgroups 0 and 1 consume, 2 produces
constexpr int LINE = 128;       // bytes of a swizzled line: 64 bf16 of one row
constexpr int ATOM = 8 * LINE;  // the swizzle's repeat

template <int D>
struct Fwd {
  // D 256: the two warpgroups share one item's rows and each holds half of
  // O's columns (64 x 128 f32, 64 registers a thread): ptxas gives a thread
  // of a 12-warp block 168 registers whatever setmaxnreg does at run time, and
  // a whole 64 x 256 O (128) beside S and P spills and serialises the wgmma.
  // Both compute the same S. D 64 / 128: a warpgroup a item, all of O.
  static constexpr bool SPLIT = D == 256;
  static constexpr int DO = SPLIT ? D / 2 : D;     // O's columns a warpgroup holds
  static constexpr int Q_TILES = SPLIT ? 1 : 2;    // 64-row Q tiles a unit
  static constexpr int BN = D == 64 ? 128 : 64;   // keys a stage
  static constexpr int Q_PANEL = ROWS * LINE;      // 64 rows x 64 columns
  static constexpr int Q_BYTES = D / 64 * Q_PANEL; // one 64-row Q tile
  static constexpr int QBUF = Q_TILES * Q_BYTES;   // a unit's Q; two buffers
  static constexpr int O_BYTES = DO / 64 * Q_PANEL;   // a warpgroup's 64 x DO staging of out
  static constexpr int KV_PANEL = BN * LINE;
  static constexpr int KV_BYTES = D / 64 * KV_PANEL;   // K (or V) of one stage
  // as many stages as fit beside the two Q buffers and the staging, at most 8
  static constexpr int STAGES_FIT = (225 * 1024 - 2 * QBUF - 2 * O_BYTES) / (2 * KV_BYTES);
  static constexpr int STAGES = STAGES_FIT > 8 ? 8 : STAGES_FIT;
  static constexpr int RING = 2 * QBUF + 2 * O_BYTES + STAGES * 2 * KV_BYTES;
  // the Q buffers, the staging, the ring, the barriers (Q full and empty a
  // buffer; K full, V full and empty a stage) and slack to align to 1024
  static constexpr int SMEM = RING + (4 + 3 * STAGES) * 8 + 1024;
  static_assert(STAGES >= 2 && SMEM <= 232448, "shared memory of one block");
};

struct FwdParams {
  const int* kv_lens;
  float* lse;
  int T, S, H, KH, G, items;     // items: (query head, 64-row tile) pairs of one kv head
  int units, total;              // units of one (batch, kv head); of the call
  int causal, window, q_offset;  // window <= 0: none
  int softcap;                   // logit = tanh(raw * cap_in) * cap_out, else raw
  float cap_in, cap_out;         // scale / cap and cap * log2 e
  float mul;                     // logit -> log2 units: 1 with the cap, else scale * log2 e
};

// One warpgroup's work item and the key tiles [lo, hi) of BN keys its rows
// can attend to: lo = hi = 0 when they see none or the item does not exist,
// so that a warpgroup's own tiles always lie inside its unit's loads.
struct Item {
  int head, q0, lo, hi;
  bool valid;
};

template <int BN>
__device__ __forceinline__ Item item_of(const FwdParams& p, int i, int kh, int kv_len) {
  Item it;
  it.valid = i < p.items;
  it.head = kh * p.G + i % p.G;
  it.q0 = i / p.G * ROWS;
  it.lo = it.hi = 0;
  if (it.valid)
    key_tile_range(it.q0 + p.q_offset, ROWS, BN, kv_len, p.S, p.causal, p.window, it.lo, it.hi);
  return it;
}

// The u-th unit of the call: its (batch, kv head) bk and its unit index
// within that kv head, the last (under a causal mask, the longest) first.
// Causal: unit-major, so that the longest units of all heads start together;
// else head-major, so that the blocks in flight share their heads' K and V in
// the L2.
__device__ __forceinline__ void unit_at(const FwdParams& p, int u, int& bk, int& unit) {
  const int bkh = p.total / p.units;
  if (p.causal) {
    bk = u % bkh;
    unit = p.units - 1 - u / bkh;
  } else {
    bk = u / p.units;
    unit = p.units - 1 - u % p.units;
  }
}

// A unit's two items and the key tiles [lo, hi) its block loads: the union of
// their ranges.
template <int D>
struct Unit {
  int b, kh, kv_len, lo, hi;
  Item it0, it1;

  __device__ __forceinline__ Unit(const FwdParams& p, int u) {
    using C = Fwd<D>;
    int bk, unit;
    unit_at(p, u, bk, unit);
    b = bk / p.KH;
    kh = bk % p.KH;
    kv_len = min(p.kv_lens[b], p.S);
    it0 = item_of<C::BN>(p, C::SPLIT ? unit : 2 * unit, kh, kv_len);
    it1 = C::SPLIT ? it0 : item_of<C::BN>(p, 2 * unit + 1, kh, kv_len);
    lo = it0.lo;
    hi = it0.hi;
    if (it1.hi > it1.lo) {
      lo = hi > lo ? min(lo, it1.lo) : it1.lo;
      hi = max(hi, it1.hi);
    }
  }
};

// A tile of the block's range that is not this warpgroup's: waited for and
// released all the same.
template <int STAGES>
__device__ __forceinline__ void skip_tile(uint32_t full_k, uint32_t full_v, uint32_t empty, int& s,
                                          uint32_t& ph, int lane) {
  mbar_wait(full_k + 8 * s, ph);
  mbar_wait(full_v + 8 * s, ph);
  if (lane == 0) mbar_arrive(empty + 8 * s);
  if (++s == STAGES) s = 0, ph ^= 1;
}

// S = Q . K^T of one tile (K landed): a k16 step is 32 bytes along the
// swizzled line, a panel every four steps. S lives within one tile (the
// first k16 step ignores its zeros).
template <int D>
__device__ __forceinline__ void s_product(float (&sc)[Fwd<D>::BN / 2], uint32_t qs, uint32_t kst) {
  using C = Fwd<D>;
#pragma unroll
  for (int i = 0; i < C::BN / 2; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<C::BN>(sc, smem_desc(qs + (kk / 4) * C::Q_PANEL + (kk % 4) * 32, 16, ATOM),
                    smem_desc(kst + (kk / 4) * C::KV_PANEL + (kk % 4) * 32, 16, ATOM), kk);
  wgmma_commit();
}

// O += P . V of one tile (V landed): P from registers, V's stage at vst (its
// columns from panel panel0 on). A k16 step is 16 lines of V (two atoms); LBO
// steps between the 64-column panels, SBO between the atoms.
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[Fwd<D>::DO / 2],
                                           const uint32_t (&pa)[Fwd<D>::BN / 8][2], uint32_t vst,
                                           int panel0) {
  using C = Fwd<D>;
#pragma unroll
  for (int kk = 0; kk < C::BN / 16; ++kk) {
    const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0], pa[2 * kk + 1][1]};
    wgmma_rs<C::DO>(o, a, smem_desc(vst + panel0 * C::KV_PANEL + kk * 2 * ATOM, C::KV_PANEL, ATOM));
  }
  wgmma_commit();
}

// The softmax of one tile of S, in place: the soft-cap, the mask (on edge
// tiles: kv_len, the causal diagonal, the window's edge), the running max in
// log2 units, the factor corr that rescales the earlier sums, p = exp2(logit
// * mul - m) in f32 and the row sums. A thread holds columns 8 jn + 2 c +
// {0, 1} of rows qpos0 and qpos0 + 8, at sc[4 jn + 2 h + {0, 1}]. Only the
// first NCH 8-column groups can hold a key the warpgroup's rows see: the rest
// get p = 0 and no exponential, which is what bounds the softmax (the ViT's
// 257th key is a tile of its own).
template <int BN, int NCH>
__device__ __forceinline__ void softmax_tile(float (&sc)[BN / 2], float (&m_run)[2],
                                             float (&l_run)[2], float (&corr)[2],
                                             const FwdParams& p, int k0, int qpos0, int c,
                                             int kv_len, bool edge) {
#pragma unroll
  for (int i = 4 * NCH; i < BN / 2; ++i) sc[i] = 0.f;
  if (p.softcap) {
#pragma unroll
    for (int i = 0; i < 4 * NCH; ++i) sc[i] = tanh_acc(sc[i] * p.cap_in) * p.cap_out;
  }
  if (edge) {
#pragma unroll
    for (int jn = 0; jn < NCH; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * jn + 2 * c + (e & 1), qpos = qpos0 + (e >> 1) * 8;
        if (!attends(qpos, kpos, kv_len, p.causal, p.window)) sc[4 * jn + e] = -INFINITY;
      }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 4 * NCH; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h] * p.mul);
    neg_m[h] = m_new == -INFINITY ? 0.f : -m_new;   // a row with nothing yet: p = 0
    corr[h] = ex2(m_run[h] + neg_m[h]);
    m_run[h] = m_new;
    l_run[h] *= corr[h];
  }
  // the row sums take p in f32, the product in bf16
#pragma unroll
  for (int i = 0; i < 4 * NCH; ++i) {
    sc[i] = ex2(fmaf(sc[i], p.mul, neg_m[(i >> 1) & 1]));
    l_run[(i >> 1) & 1] += sc[i];
  }
}

// softmax_tile with NCH = nch (1 .. BN / 8) rounded up to a power of two
template <int BN>
__device__ __forceinline__ void softmax_any(int nch, float (&sc)[BN / 2], float (&m_run)[2],
                                            float (&l_run)[2], float (&corr)[2],
                                            const FwdParams& p, int k0, int qpos0, int c,
                                            int kv_len, bool edge) {
  if (nch > BN / 16)
    softmax_tile<BN, BN / 8>(sc, m_run, l_run, corr, p, k0, qpos0, c, kv_len, edge);
  else if (BN == 128 && nch > 4)
    softmax_tile<BN, 8>(sc, m_run, l_run, corr, p, k0, qpos0, c, kv_len, edge);
  else if (nch > 2)
    softmax_tile<BN, 4>(sc, m_run, l_run, corr, p, k0, qpos0, c, kv_len, edge);
  else if (nch == 2)
    softmax_tile<BN, 2>(sc, m_run, l_run, corr, p, k0, qpos0, c, kv_len, edge);
  else
    softmax_tile<BN, 1>(sc, m_run, l_run, corr, p, k0, qpos0, c, kv_len, edge);
}

template <int DO>
__device__ __forceinline__ void rescale_o(float (&o)[DO / 2], const float (&corr)[2]) {
#pragma unroll
  for (int i = 0; i < DO / 2; ++i) o[i] *= corr[(i >> 1) & 1];
}

// p of one tile as the A fragments of P . V: two adjacent 8-column groups of
// the accumulator are one k16 step's fragment
template <int BN>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BN / 8][2], const float (&sc)[BN / 2]) {
#pragma unroll
  for (int jn = 0; jn < BN / 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) pa[jn][h] = pack_bf16(sc[4 * jn + 2 * h], sc[4 * jn + 2 * h + 1]);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, const FwdParams p) {
  using C = Fwd<D>;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  extern __shared__ unsigned char fa_smem[];
  // two Q buffers, each consumer warpgroup's staging of out, then the ring,
  // at the first 1024-byte boundary
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t ostage = base + 2 * C::QBUF, ring = ostage + 2 * C::O_BYTES;
  const uint32_t q_full = base + C::RING, q_empty = q_full + 16;
  const uint32_t full_k = q_empty + 16, full_v = full_k + 8 * STAGES, empty = full_v + 8 * STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);    // the producer's arrive, plus the bytes
      mbar_init(q_empty + 8 * i, 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread walks the block's units, loads each unit's Q
    // into the buffer its last-but-one unit released and keeps the ring full
    // across units ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int u = blockIdx.x, n = 0; u < p.total; u += gridDim.x, ++n) {
        const Unit<D> un(p, u);
        const int qb = n & 1;
        mbar_wait(q_empty + 8 * qb, ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, (C::SPLIT ? 1 : un.it0.valid + un.it1.valid) * C::Q_BYTES);
#pragma unroll
        for (int w = 0; w < C::Q_TILES; ++w) {
          const Item& it = w == 0 ? un.it0 : un.it1;
          if (!it.valid) continue;
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(base + qb * C::QBUF + w * C::Q_BYTES + pn * C::Q_PANEL, &map_q, 64 * pn,
                        it.head, it.q0, un.b, q_full + 8 * qb);
        }
        for (int j = un.lo; j < un.hi; ++j) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const uint32_t kst = ring + s * 2 * C::KV_BYTES, vst = kst + C::KV_BYTES;
          mbar_expect_tx(full_k + 8 * s, C::KV_BYTES);
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(kst + pn * C::KV_PANEL, &map_k, 64 * pn, un.kh, j * BN, un.b,
                        full_k + 8 * s);
          mbar_expect_tx(full_v + 8 * s, C::KV_BYTES);
          for (int pn = 0; pn < D / 64; ++pn)
            tma_load_4d(vst + pn * C::KV_PANEL, &map_v, 64 * pn, un.kh, j * BN, un.b,
                        full_v + 8 * s);
          if (++s == STAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup w owns the 64 rows of its item (D 256: O's
  // columns from panel0 on, of the unit's one item), unit after unit ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
  const int panel0 = C::SPLIT ? wg * C::DO / 64 : 0;   // O's first 64-column panel
  int s = 0;
  uint32_t ph = 0;
  for (int u = blockIdx.x, n = 0; u < p.total; u += gridDim.x, ++n) {
    const Unit<D> un(p, u);
    const Item it = wg == 0 ? un.it0 : un.it1;
    const int qb = n & 1;
    const uint32_t qs = base + qb * C::QBUF + (C::SPLIT ? 0 : wg * C::Q_BYTES);
    const int q_start = it.q0 + p.q_offset;
    const int qpos0 = q_start + warp * 16 + g;   // this thread's rows: qpos0 and qpos0 + 8
    // a thread holds columns 8 j + 2 c + {0, 1} of rows g and g + 8 of its
    // warp's 16, at o[4 j + 2 h + {0, 1}] (h = 0, 1); S likewise
    float o[C::DO / 2];
#pragma unroll
    for (int i = 0; i < C::DO / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};   // running max, log2 units
    float l_run[2] = {0.f, 0.f};                // this thread's share of the row sums
    // every warpgroup waits for the unit's Q, its own loaded or not: one with
    // no item must not run a unit ahead and release a Q buffer the other
    // warpgroup still reads (the producer refills a buffer once all eight
    // warps have released it, counting arrivals, not units)
    mbar_wait(q_full + 8 * qb, (n >> 1) & 1);

    // Tiles before and after the warpgroup's own [it.lo, it.hi) are waited
    // for and released, so that the ring's phases stay in step. On its own
    // tiles: S = Q . K^T, the softmax, O rescaled, O += P . V, each product
    // waited for before the next step (the two warpgroups' steps interleave
    // on the SM), and the stage released. key_end: the key past the last one
    // the warpgroup's rows see, kv_len or (causal) its last row's position.
    const int key_end = p.causal ? min(un.kv_len, q_start + ROWS) : un.kv_len;
    int j = un.lo;
    for (; j < un.hi && j < it.lo; ++j) skip_tile<STAGES>(full_k, full_v, empty, s, ph, lane);
    for (; j < it.hi; ++j) {
      const uint32_t kst = ring + s * 2 * C::KV_BYTES;
      const int k0 = j * BN;
      const bool edge = k0 + BN > un.kv_len || (p.causal && k0 + BN - 1 > q_start) ||
                        (p.window > 0 && k0 <= q_start + ROWS - 1 - p.window);
      // 8-column groups with a key the warpgroup's rows see (at least one: the
      // tile is in its range). The same for its four warps: a choice that
      // differs between the warps of a warpgroup corrupts its shared wgmma
      // (seen on the card when warps of padding rows past T skipped theirs).
      const int nch = min(BN / 8, (key_end - k0 + 7) / 8);
      float sc[BN / 2], corr[2];
      uint32_t pa[BN / 8][2];
      mbar_wait(full_k + 8 * s, ph);
      s_product<D>(sc, qs, kst);
      wgmma_wait<0>();
      fence_acc(sc);
      softmax_any<BN>(nch, sc, m_run, l_run, corr, p, k0, qpos0, c, un.kv_len, edge);
      rescale_o<C::DO>(o, corr);
      pack_p<BN>(pa, sc);
      mbar_wait(full_v + 8 * s, ph);
      wgmma_fence();
      pv_product<D>(o, pa, kst + C::KV_BYTES, panel0);
      wgmma_wait<0>();
      fence_acc(o);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      if (++s == STAGES) s = 0, ph ^= 1;
    }
    // this warp's last S product is done (a warp's share of a wgmma completes
    // on its own): once all eight have said so, the producer may refill the
    // unit's Q buffer
    if (lane == 0) mbar_arrive(q_empty + 8 * qb);
    for (; j < un.hi; ++j) skip_tile<STAGES>(full_k, full_v, empty, s, ph, lane);

    if (it.valid) {
      // ---- epilogue: out through this warpgroup's staging and TMA stores,
      // which clip rows past T; lse from registers ----
      float inv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
        l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
        inv[h] = l_run[h] == 0.f ? 0.f : 1.f / l_run[h];
      }
      const uint32_t os = ostage + wg * C::O_BYTES;
      if (t == 0) bulk_wait_read();   // the last unit's stores have read the staging
      named_bar(2 + wg, 128);
#pragma unroll
      for (int i = 0; i < C::DO / 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // row r's 16-byte chunk ch sits at ch ^ (r % 8): a warp's stores hit 32 banks
          const int row = warp * 16 + g + 8 * h, ch = i % 8;
          st_shared(os + (i / 8) * C::Q_PANEL + row * LINE + ((ch ^ (row % 8)) << 4) + 4 * c,
                    pack_bf16(o[4 * i + 2 * h] * inv[h], o[4 * i + 2 * h + 1] * inv[h]));
        }
      fence_proxy_async();
      named_bar(2 + wg, 128);
      if (t == 0) {
        for (int pn = 0; pn < C::DO / 64; ++pn)
          tma_store_4d(&map_o, os + pn * C::Q_PANEL, 64 * (panel0 + pn), it.head, it.q0, un.b);
        bulk_commit();
      }
      if (c == 0 && (!C::SPLIT || wg == 0)) {
        float* lse = p.lse + ((size_t)un.b * p.H + it.head) * p.T;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = it.q0 + warp * 16 + g + 8 * h;
          if (row < p.T)
            lse[row] = l_run[h] == 0.f ? FA_NEG_INF : m_run[h] * LN2 + logf(l_run[h]);
        }
      }
    }
  }
  if (t == 0) bulk_wait();   // the staging stays until the last stores are done
}

// ---- host: tensor maps and the launch ----

template <int D>
int launch(const FwdParams& p, const CUtensorMap (&maps)[4], cudaStream_t st) {
  using C = Fwd<D>;
  static const int attr = (int)cudaFuncSetAttribute(
      fa_fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != 0) return attr;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    VBT_CHECK(cudaGetDevice(&dev));
    VBT_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  }
  const dim3 grid(min(p.total, sms));   // persistent: one block an SM walks the units
  fa_fwd_sm90_kernel<D><<<grid, THREADS, C::SMEM, st>>>(maps[0], maps[1], maps[2], maps[3], p);
  VBT_CHECK_LAUNCH();
  return 0;
}

template <int D>
int run(const void* q, const void* k, const void* v, void* out, int B, const long long (&st)[9],
        FwdParams& p, cudaStream_t stream) {
  VBT_CHECK((cudaError_t)bind_device(q));
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int T = p.T, S = p.S, H = p.H, KH = p.KH, BN = Fwd<D>::BN;
  CUtensorMap maps[4];
  if (!bhsd_map(enc, &maps[0], q, B, T, H, D, st[0], st[1], st[2], ROWS) ||
      !bhsd_map(enc, &maps[1], k, B, S, KH, D, st[3], st[4], st[5], BN) ||
      !bhsd_map(enc, &maps[2], v, B, S, KH, D, st[6], st[7], st[8], BN) ||
      !bhsd_map(enc, &maps[3], out, B, T, H, D, (long long)T * H * D, (long long)H * D, D, ROWS))
    return (int)cudaErrorInvalidValue;
  return launch<D>(p, maps, stream);
}

}  // namespace

// out [B, T, H, D] (contiguous) and lse [B, H, T] from q [B, T, H, D] and k, v
// [B, S, KH, D], each given with its element strides (batch, row, head): D
// contiguous, every stride a multiple of 8 elements (16 bytes), pointers
// 16-byte aligned. softcap <= 0: none; window <= 0: none.
extern "C" int vbt_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* kv_lens, void* out, void* lse, int B, int T,
                                       int S, int H, int KH, int D, int causal, int window,
                                       float scale, float softcap, long long q_sb, long long q_st,
                                       long long q_sh, long long k_sb, long long k_ss,
                                       long long k_sh, long long v_sb, long long v_ss,
                                       long long v_sh, void* stream_ptr) {
  if (B < 1 || T < 1 || S < 1 || H < 1 || KH < 1 || H % KH != 0 ||
      (D != 64 && D != 128 && D != 256))
    return (int)cudaErrorInvalidValue;
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  FwdParams p = {};
  p.kv_lens = (const int*)kv_lens;
  p.lse = (float*)lse;
  p.T = T; p.S = S; p.H = H; p.KH = KH; p.G = H / KH;
  p.items = p.G * ((T + ROWS - 1) / ROWS);
  p.units = D == 256 ? p.items : (p.items + 1) / 2;   // Fwd<256>::SPLIT: an item a unit
  if ((long long)p.units * B * KH > 0x7fffffff) return (int)cudaErrorInvalidValue;
  p.total = p.units * B * KH;
  p.causal = causal; p.window = window; p.q_offset = causal ? S - T : 0;
  p.softcap = softcap > 0.f;
  p.cap_in = p.softcap ? scale / softcap : 0.f;
  p.cap_out = p.softcap ? softcap * LOG2E : 0.f;
  p.mul = p.softcap ? 1.f : scale * LOG2E;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return D == 256 ? run<256>(q, k, v, out, B, st, p, stream)
       : D == 128 ? run<128>(q, k, v, out, B, st, p, stream)
                  : run<64>(q, k, v, out, B, st, p, stream);
}
