// Flash attention backward for Hopper: dq and dk/dv, TMA loads under an
// mbarrier ring, every product on wgmma, q, k, v and dout read where they lie.
//
// Replaces: the two pallas_calls of
// vlm_bridge_tpu/ops/flash_attention.py:_flash_bwd (:329): dq at :358 (body
// _bwd_dq_kernel :451) with fa_bwd_dq_sm90_kernel, dk/dv at :382 (body
// _bwd_dkv_kernel :496) with fa_bwd_dkv_sm90_kernel.
//
// What they compute. q [B, T, H, D], k / v [B, S, KH, D] bf16, D in {64, 128,
// 256}, G = H / KH query heads a kv head, kv_lens [B], the forward's lse
// [B, H, T] (f32, natural log) and dout [B, T, H, D]. Logits = (q . k) * scale
// in f32, then tanh(x / cap) * cap, under the mask of common.cuh (`attends`);
// p = exp(logit - lse), zero where masked, and
//   dv = sum p^T . do      dp = do . v^T      ds = p (dp - delta) dcap scale
//   dq = ds . k            dk = ds^T . q      dcap = 1 - tanh^2
// with delta = sum_d out * dout (f32), p and ds rounded to bf16 before their
// products, f32 sums. The dq kernel computes delta itself from out and dout
// and writes it ([B, H, T] f32) for the dk/dv kernel. The G query heads of a
// kv head are summed inside the dk/dv kernel: no atomics, two calls give the
// same bits. A row with empty support gives dq = 0, a key no row sees dk = dv
// = 0. Tiles outside kv_len, the causal diagonal or the window are skipped,
// not masked.
//
// Bound: bytes. At the train step's Gemma shape (B 8, T = S 256, H 8, KH 4,
// D 256, causal) the pair reads q, k, v, out, dout, lse and delta and writes
// dq, dk, dv and delta: ~51 MB, 15 us at 3.35 TB/s, against ~5 GFLOP on the
// causal half (5 us at the bf16 tensor-core peak). So the design keeps the
// [T, S] scores out of device memory, reads each tensor where the caller
// holds it, and keeps loads in flight while the tensor cores work:
//
// - A block is two consumer warpgroups (8 warps: ptxas gives each thread 255
//   registers, where a 9-12-warp block gets 168, and dK and dV of a 64-key
//   tile at D 128 need more than 168). One block a unit:
//   - dq: a unit is two items (query head, 64-row tile) of one (batch, kv
//     head), tile-major as in flash_fwd.cu, each warpgroup holding one item's
//     Q and dO tiles and its 64 x D of dQ; the unit streams the K and V tiles
//     of the union of its items' key ranges.
//   - dk/dv: a unit is two neighbouring 64-key tiles of one (batch, kv head),
//     each warpgroup holding one tile's K and V and its 64 x D of dK and dV;
//     the unit streams the Q and dO tiles of every query head of the kv head
//     over the union of its tiles' query ranges (query_tile_range).
//   - D 256: a unit is one item, whose work the two warpgroups split by
//     role, so that no product is computed twice: warpgroup 0 computes the
//     scores (S, or S^T) and p, and hands p * dscale to warpgroup 1 through
//     16 KB of shared memory (two named barriers: ready, free); warpgroup 1
//     computes dP (dP^T) and ds. dq: warpgroup 1 holds all of dQ (128
//     registers a thread). dk/dv: warpgroup 0 holds dV, warpgroup 1 dK. (Both
//     warpgroups computing the same scores, each holding half the columns,
//     as the forward splits O, was slower: PERF.md.)
//   A warpgroup skips a streamed tile outside its own range but waits for it
//   and releases it, so the ring stays in step; an item that sees nothing has
//   the range [0, 0). Causal units go longest first (dq: the last row tile;
//   dk/dv: the first key tile), else head by head so that the blocks in
//   flight share a head's tiles in the L2.
// - Tensor maps are 4-D (D, heads, rows, batch) with the caller's strides, so
//   a tile past T or S reads zeros, and the outputs leave by TMA stores (staged
//   in the resident tiles, once every product is done), which clip rows past T
//   or S. Thread 0 issues the resident loads before kv_lens is read, then the
//   ring's first stages; the ring is refilled as both warpgroups release a
//   stage (by thread 0, or under the role split by warpgroup 1's first
//   thread, which ends each tile last). The dq kernel reads its rows' lse and
//   out while those loads are in flight.
// - Products, only the forward's two wgmma forms. Scores (both operands in
//   shared memory, K-major): dq S = Q . K^T, dP = dO . V^T; dk/dv S^T = K .
//   Q^T, dP^T = V . dO^T. Accumulating products (A from registers: p or ds
//   rounded to bf16 and packed, the accumulator's layout being the A
//   fragment; B MN-major with the transpose bit): dQ += dS . K; dV += P^T .
//   dO, dK += dS^T . Q. Each is issued and waited on in straight-line code.
//   At D 64 / 128 the warpgroups take turns at issuing their score products
//   (Turns), so that one's elementwise work runs under the other's products.
// - The elementwise work bounds a tile: with the soft-cap ~20 instructions
//   and three MUFU operations an element. The soft-cap and the edge mask are
//   compile-time flags of the element loop, chosen once a tile (by_flags).
// - lse and delta of a streamed query tile (dk/dv) are read by the warpgroup's
//   own threads, one computed tile ahead, into a small double buffer of
//   shared memory (a [B, H, T] f32 row is no TMA box when T is not a multiple
//   of 4). lse is kept as lse * log2 e, and as +inf for a row past T or with
//   empty support, so that p = exp2(logit * mul - lse2) is 0 there with no
//   mask.

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int ROWS = 64;             // rows of an item and of a streamed tile (wgmma's M)
constexpr int THREADS = 256;         // two consumer warpgroups
constexpr int LINE = 128;            // bytes of a swizzled line: 64 bf16 of one row
constexpr int ATOM = 8 * LINE;       // the swizzle's repeat
constexpr int PANEL = ROWS * LINE;   // 64 rows x 64 columns

template <int D>
struct Bwd {
  // D 256: one item a unit, whose work the two warpgroups split by role (see
  // the kernels); else an item a warpgroup
  static constexpr bool ROLES = D == 256;
  static constexpr int ITEMS = ROLES ? 1 : 2;
  static constexpr int TILE = D / 64 * PANEL;      // one 64-row tile of D columns
  static constexpr int RES = ITEMS * 2 * TILE;     // resident: two tiles an item
  static constexpr int STAGE = 2 * TILE;           // streamed: two tiles a stage
  static constexpr int STATS = 2 * 2 * 2 * ROWS * 4;   // lse2 and delta, 2 buffers, 2 warpgroups
  static constexpr int XCHG = ROLES ? 32 * 128 * 4 : 0;  // p * dscale of a tile, wg 0 -> wg 1
  static constexpr int STAGES_FIT = (225 * 1024 - RES - STATS - XCHG) / STAGE;
  static constexpr int STAGES = STAGES_FIT > 4 ? 4 : STAGES_FIT;
  // the resident tiles, the ring, the stats, the exchange, the barriers
  // (resident full; a full and an empty a stage) and slack to align to 1024
  static constexpr int SMEM =
      RES + STAGES * STAGE + STATS + XCHG + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(STAGES >= 2 && SMEM <= 232448, "shared memory of one block");
};

// named barriers: 1 + wg a warpgroup's own; the exchange's two; TURN + wg the
// turn of warpgroup wg to issue its score products (D 64 / 128)
constexpr int BAR_READY = 3, BAR_FREE = 4, BAR_TURN = 5;

// D 64 / 128: the two warpgroups take turns at issuing their score products
// for each streamed tile, warpgroup 0 first, so that one's softmax-like work
// runs under the other's products (both wait for the same stage; without
// turns they issue, then compute, in step, and the tensor cores idle).
// Every streamed tile is a turn, also one a warpgroup skips, so both take
// the same number; begin() waits for this warpgroup's turn, end() passes it.
struct Turns {
  int wg;
  bool on;
  __device__ __forceinline__ void start() const {
    if (on && wg == 1) named_arrive(BAR_TURN, 256);
  }
  __device__ __forceinline__ void begin() const {
    if (on) named_bar(BAR_TURN + wg, 256);
  }
  __device__ __forceinline__ void end() const {
    if (on) named_arrive(BAR_TURN + 1 - wg, 256);
  }
  __device__ __forceinline__ void finish() const {   // warpgroup 1's last pass
    if (on && wg == 0) named_bar(BAR_TURN, 256);
  }
};

struct BwdParams {
  const int* kv_lens;
  const float* lse;         // [B, H, T]
  const float* delta_in;    // dk/dv: [B, H, T]
  float* delta_out;         // dq: [B, H, T]
  const bf16* out;          // dq: read for delta, with its element strides
  long long o_sb, o_st, o_sh;
  int T, S, H, KH, G;
  int items, units, total;  // items of one (batch, kv head); units of it; of the call
  int causal, window, q_offset;   // window <= 0: none
  int softcap;                    // logit = tanh(raw * cap_in) * cap_out, else raw
  float cap_in, cap_out;          // scale / cap and cap * log2 e
  float mul;                      // logit -> log2 units: 1 with the cap, else scale * log2 e
  float scale;
};

// An item: its first row (dq: query row; dk/dv: key), its query head (dq)
// and the streamed tiles [lo, hi) it sees: key tiles (dq), query tiles of
// every head (dk/dv). lo = hi = 0 when it sees none or does not exist.
struct Item {
  int row0, head, lo, hi;
  bool valid;
};

template <bool DQ>
__device__ __forceinline__ Item item_of(const BwdParams& p, int i, int kh) {
  Item it;
  it.valid = i < p.items;
  it.lo = it.hi = 0;
  it.head = DQ ? kh * p.G + i % p.G : kh;
  it.row0 = (DQ ? i / p.G : i) * ROWS;
  return it;
}

template <bool DQ>
__device__ __forceinline__ void item_range(const BwdParams& p, Item& it, int kv_len) {
  if (!it.valid) return;
  if (DQ)
    key_tile_range(it.row0 + p.q_offset, ROWS, ROWS, kv_len, p.S, p.causal, p.window, it.lo,
                   it.hi);
  else
    query_tile_range(it.row0, ROWS, ROWS, kv_len, p.T, p.q_offset, p.causal, p.window, it.lo,
                     it.hi);
}

// The block's unit: its (batch, kv head), its items and (after ranges(), which
// reads kv_lens) the union [lo, hi) of their ranges. Causal: unit-major, the
// longest units of all heads first (dq: the last row tile sees the most keys;
// dk/dv: the first key tile the most rows); else head-major.
template <int D, bool DQ>
struct Unit {
  int b, kh, kv_len, lo, hi;
  Item it0, it1;

  __device__ __forceinline__ Unit(const BwdParams& p, int u) {
    const int bkh = p.total / p.units;
    int bk, unit;
    if (p.causal) {
      bk = u % bkh;
      unit = DQ ? p.units - 1 - u / bkh : u / bkh;
    } else {
      bk = u / p.units;
      unit = u % p.units;
    }
    b = bk / p.KH;
    kh = bk % p.KH;
    it0 = item_of<DQ>(p, Bwd<D>::ROLES ? unit : 2 * unit, kh);
    it1 = Bwd<D>::ROLES ? it0 : item_of<DQ>(p, 2 * unit + 1, kh);
  }

  __device__ __forceinline__ void ranges(const BwdParams& p) {
    kv_len = min(p.kv_lens[b], p.S);
    item_range<DQ>(p, it0, kv_len);
    if (Bwd<D>::ROLES)
      it1 = it0;
    else
      item_range<DQ>(p, it1, kv_len);
    lo = it0.lo;
    hi = it0.hi;
    if (it1.hi > it1.lo) {
      lo = hi > lo ? min(lo, it1.lo) : it1.lo;
      hi = max(hi, it1.hi);
    }
  }
};

// d[64, 64] = A[64, D] . B[64, D]^T, both 64-row tiles in shared memory (K-major)
template <int D>
__device__ __forceinline__ void score_product(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<64>(d, smem_desc(a + (kk / 4) * PANEL + (kk % 4) * 32, 16, ATOM),
                 smem_desc(b + (kk / 4) * PANEL + (kk % 4) * 32, 16, ATOM), kk);
}

// acc[64, D] += A[64, 64] . B[64, D]: A the packed bf16 fragments, B a
// 64-row tile read MN-major (a k16 step is 16 lines, two atoms; LBO steps
// between 64-column panels, SBO between atoms)
template <int D>
__device__ __forceinline__ void acc_product(float (&acc)[D / 2], const uint32_t (&a)[8][2],
                                            uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t f[4] = {a[2 * kk][0], a[2 * kk][1], a[2 * kk + 1][0], a[2 * kk + 1][1]};
    wgmma_rs<D>(acc, f, smem_desc(b + kk * 2 * ATOM, PANEL, ATOM));
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// p of one element from its raw score x (dscale: the logits' scale, times 1 -
// tanh^2 under the cap); h and col its place in the tile (below), lse2 its
// row's or column's lse in log2 units, pos(h, col, qpos, kpos) its positions
// for the mask, applied only on an edge tile. CAP and EDGE are compile-time
// (see by_flags), so that a tile's 32 elements a thread are branch-free
// chains the compiler interleaves: with the soft-cap they are ~20
// instructions and three MUFU operations each, and under ROLES one warp a
// scheduler computes them.
template <bool CAP, bool EDGE, typename Pos>
__device__ __forceinline__ float p_elem(float x, float lse2, const BwdParams& p, int kv_len,
                                        int h, int col, Pos pos, float& dscale) {
  dscale = p.scale;
  if (CAP) {
    const float th = tanh_acc(x * p.cap_in);
    x = th * p.cap_out;
    dscale = p.scale * (1.f - th * th);
  }
  float pr = ex2(fmaf(x, p.mul, -lse2));
  if (EDGE) {
    int qpos, kpos;
    pos(h, col, qpos, kpos);
    if (!attends(qpos, kpos, kv_len, p.causal, p.window)) pr = 0.f;
  }
  return pr;
}

// p and ds of one 64 x 64 tile in one pass, as bf16 A fragments (p in pa when
// PACK_P, ds in da): sc holds the raw scores, dp dO . V^T (or their
// transposes). A thread holds columns 8 jn + 2 c + {0, 1} of rows 16 warp + g
// + {0, 8} at [4 jn + 2 h + {0, 1}]; lse2(h, col) and delta(h, col) give the
// statistics of an element pair's row, or of its two columns (a float2).
template <bool PACK_P, bool CAP, bool EDGE, typename Lse, typename Delta, typename Pos>
__device__ __forceinline__ void p_and_ds(const float (&sc)[32], const float (&dp)[32],
                                         uint32_t (&pa)[8][2], uint32_t (&da)[8][2],
                                         const BwdParams& p, int c, int kv_len, Lse lse2,
                                         Delta delta, Pos pos) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pv[2], ds[2];
      const int col0 = 8 * jn + 2 * c;
      const float2 l2 = lse2(h, col0), dl = delta(h, col0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jn + 2 * h + e;
        float dscale;
        pv[e] = p_elem<CAP, EDGE>(sc[i], e ? l2.y : l2.x, p, kv_len, h, col0 + e, pos, dscale);
        ds[e] = pv[e] * dscale * (dp[i] - (e ? dl.y : dl.x));
      }
      if (PACK_P) pa[jn][h] = pack_bf16(pv[0], pv[1]);
      da[jn][h] = pack_bf16(ds[0], ds[1]);
    }
}

// The role split's first half: p of one tile, in place as p * dscale (all
// that ds needs besides dp and delta), and p as bf16 A fragments in pa when
// PACK_P.
template <bool PACK_P, bool CAP, bool EDGE, typename Lse, typename Pos>
__device__ __forceinline__ void p_tile(float (&sc)[32], uint32_t (&pa)[8][2], const BwdParams& p,
                                       int c, int kv_len, Lse lse2, Pos pos) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pv[2];
      const int col0 = 8 * jn + 2 * c;
      const float2 l2 = lse2(h, col0);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * jn + 2 * h + e;
        float dscale;
        pv[e] = p_elem<CAP, EDGE>(sc[i], e ? l2.y : l2.x, p, kv_len, h, col0 + e, pos, dscale);
        sc[i] = pv[e] * dscale;
      }
      if (PACK_P) pa[jn][h] = pack_bf16(pv[0], pv[1]);
    }
}

// f(cap, edge) with the two flags as std::integral_constant<bool, ...>: one
// branch a tile, none inside the element loops
template <typename F>
__device__ __forceinline__ void by_flags(bool cap, bool edge, F f) {
  using T = std::true_type;
  using N = std::false_type;
  if (cap) {
    if (edge) f(T{}, T{}); else f(T{}, N{});
  } else {
    if (edge) f(N{}, T{}); else f(N{}, N{});
  }
}

// The role split's second half: ds = (p * dscale) (dp - delta) of one tile
// as bf16 A fragments; delta(h, col) gives the delta of an element pair's row
// or of its two columns
template <typename Delta>
__device__ __forceinline__ void ds_tile(const float (&pd)[32], const float (&dp)[32],
                                        uint32_t (&da)[8][2], int c, Delta delta) {
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 4 * jn + 2 * h;
      const float2 dl = delta(h, 8 * jn + 2 * c);
      da[jn][h] = pack_bf16(pd[i] * (dp[i] - dl.x), pd[i + 1] * (dp[i + 1] - dl.y));
    }
}

// p * dscale of a tile from warpgroup 0's thread t to warpgroup 1's thread t
// (the same positions of the accumulator): 16 bytes a thread at a time, [i /
// 4][t][i % 4], so that a warp's accesses are contiguous
__device__ __forceinline__ void xchg_put(uint32_t buf, const float (&v)[32], int t) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(buf + (q * 128 + t) * 16),
                 "f"(v[4 * q]), "f"(v[4 * q + 1]), "f"(v[4 * q + 2]), "f"(v[4 * q + 3])
                 : "memory");
}

__device__ __forceinline__ void xchg_get(uint32_t buf, float (&v)[32], int t) {
#pragma unroll
  for (int q = 0; q < 8; ++q)
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[4 * q]), "=f"(v[4 * q + 1]), "=f"(v[4 * q + 2]), "=f"(v[4 * q + 3])
                 : "r"(buf + (q * 128 + t) * 16)
                 : "memory");
}

// Stage a warpgroup's 64 x D accumulator as bf16 in a resident tile
// (swizzled as the TMA reads it) and store it by TMA.
template <int D>
__device__ __forceinline__ void store_tile(const float (&acc)[D / 2], uint32_t tile,
                                           const CUtensorMap* map, int head, int row0, int b,
                                           int wg, int t) {
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // row r's 16-byte chunk ch sits at ch ^ (r % 8): a warp's stores hit 32 banks
      const int row = warp * 16 + g + 8 * h, ch = i % 8;
      st_shared(tile + (i / 8) * PANEL + row * LINE + ((ch ^ (row % 8)) << 4) + 4 * c,
                pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]));
    }
  fence_proxy_async();
  named_bar(1 + wg, 128);
  if (t == 0) {
    for (int pn = 0; pn < D / 64; ++pn)
      tma_store_4d(map, tile + pn * PANEL, 64 * pn, head, row0, b);
    bulk_commit();
    bulk_wait_read();   // the block may leave once the stores have read the staging
  }
}

// The ring of streamed tiles: its barriers, the stage s in use and its
// parity, and the count n of the unit's streamed tiles.
struct Ring {
  uint32_t full, empty;
  int s, n;
  uint32_t ph;
};

// The block's barriers, initialised by thread 0.
__device__ __forceinline__ void init_barriers(uint32_t res_full, uint32_t full, uint32_t empty,
                                              int stages) {
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);    // the loading thread's arrive, plus the bytes
      mbar_init(empty + 8 * s, 8);   // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------- dq

template <int D>
struct DqLoad {
  const CUtensorMap *k, *v;
  int kh, b, lo;
  uint32_t ring;
  // streamed tile x (key tile lo + x): K, then V, into stage s
  __device__ __forceinline__ void operator()(int x, int s, uint32_t bar) const {
    using C = Bwd<D>;
    const uint32_t kst = ring + s * C::STAGE;
    mbar_expect_tx(bar, C::STAGE);
    for (int pn = 0; pn < D / 64; ++pn) {
      tma_load_4d(kst + pn * PANEL, k, 64 * pn, kh, (lo + x) * ROWS, b, bar);
      tma_load_4d(kst + C::TILE + pn * PANEL, v, 64 * pn, kh, (lo + x) * ROWS, b, bar);
    }
  }
};

// Release stage s of streamed tile x (both warpgroups); one thread then
// refills it with tile x + STAGES once all eight warps have: thread 0, or
// under ROLES warpgroup 1's first thread, since warpgroup 1 ends each tile
// last and so never waits there for warpgroup 0.
template <int STAGES, bool ROLES, typename Load>
__device__ __forceinline__ void advance(Ring& r, int x, int lane, const Load& load) {
  if (lane == 0) mbar_arrive(r.empty + 8 * r.s);
  if (threadIdx.x == (ROLES ? 128 : 0) && x + STAGES < r.n) {
    mbar_wait(r.empty + 8 * r.s, r.ph);
    load(x + STAGES, r.s, r.full + 8 * r.s);
  }
  if (++r.s == STAGES) r.s = 0, r.ph ^= 1;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_dq, const BwdParams p) {
  using C = Bwd<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + C::RES, xchg = ring + STAGES * C::STAGE + C::STATS;
  const uint32_t res_full = xchg + C::XCHG;
  const uint32_t full = res_full + 8, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;

  Unit<D, true> un(p, blockIdx.x);
  init_barriers(res_full, full, empty, STAGES);
  if (threadIdx.x == 0) {   // the items' Q and dO
    mbar_expect_tx(res_full, (un.it0.valid + (C::ROLES ? 0 : un.it1.valid)) * 2 * C::TILE);
#pragma unroll
    for (int w = 0; w < C::ITEMS; ++w) {
      const Item& it = w == 0 ? un.it0 : un.it1;
      if (!it.valid) continue;
      for (int pn = 0; pn < D / 64; ++pn) {
        tma_load_4d(base + w * 2 * C::TILE + pn * PANEL, &map_q, 64 * pn, it.head, it.row0, un.b,
                    res_full);
        tma_load_4d(base + w * 2 * C::TILE + C::TILE + pn * PANEL, &map_do, 64 * pn, it.head,
                    it.row0, un.b, res_full);
      }
    }
  }
  // this thread's rows (16 warp + g + 8 h of the item): their lse and D / 4
  // columns of out, read now, so that their latency passes under the loads'
  const Item itw = (C::ROLES || wg == 0) ? un.it0 : un.it1;
  float lraw[2];
  uint4 ov[2][D / 32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = itw.row0 + warp * 16 + g + 8 * h;
    const bool in = itw.valid && row < p.T;
    lraw[h] = in ? p.lse[((size_t)un.b * p.H + itw.head) * p.T + row] : FA_NEG_INF;
    const bf16* o = p.out + un.b * p.o_sb + (in ? row : 0) * p.o_st + itw.head * p.o_sh;
#pragma unroll
    for (int m = 0; m < D / 32; ++m)
      ov[h][m] = in ? *reinterpret_cast<const uint4*>(o + c * (D / 4) + 8 * m)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
  un.ranges(p);
  const DqLoad<D> load{&map_k, &map_v, un.kh, un.b, un.lo, ring};
  Ring r{full, empty, 0, un.hi - un.lo, 0u};
  if (threadIdx.x == 0)   // the ring's first stages
    for (int x = 0; x < r.n && x < STAGES; ++x) load(x, x, full + 8 * x);

  const Item it = (C::ROLES || wg == 0) ? un.it0 : un.it1;
  const uint32_t qs = base + (C::ROLES ? 0 : wg) * 2 * C::TILE, dos = qs + C::TILE;
  const int q_start = it.row0 + p.q_offset;
  mbar_wait(res_full, 0);

  // lse in log2 units (+inf past T or with empty support: p = 0 there) and
  // delta = sum_d out * dout, of D / 4 columns a thread, summed over the four
  // threads of a row
  float lse2[2], delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rt = warp * 16 + g + 8 * h, row = it.row0 + rt;
    float acc = 0.f;
    lse2[h] = lraw[h] == FA_NEG_INF ? INFINITY : lraw[h] * LOG2E;
#pragma unroll
    for (int m = 0; m < D / 32; ++m) {
      const int col = c * (D / 4) + 8 * m, ch = (col % 64) / 8;
      const uint4 dv = ld_shared_v4(dos + (col / 64) * PANEL + rt * LINE + ((ch ^ (rt % 8)) << 4));
      const uint32_t ow[4] = {ov[h][m].x, ov[h][m].y, ov[h][m].z, ov[h][m].w};
      const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
        const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[e]));
        acc = fmaf(a.x, d.x, acc);
        acc = fmaf(a.y, d.y, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    delta[h] = acc;
    if (c == 0 && it.valid && row < p.T && (!C::ROLES || wg == 0))
      p.delta_out[((size_t)un.b * p.H + it.head) * p.T + row] = acc;
  }

  float dq[D / 2];
  zero(dq);
  const auto lse_of = [&](int h, int) { return make_float2(lse2[h], lse2[h]); };
  const auto delta_of = [&](int h, int) { return make_float2(delta[h], delta[h]); };
  // Tiles before and after the warpgroup's own [it.lo, it.hi) are waited for
  // and released. On its own: S and dP, p and ds, dQ += dS . K, each product
  // waited for before the next step, and the stage released. D 256 (ROLES):
  // warpgroup 0 computes S and p * dscale and hands it over; warpgroup 1
  // computes dP and ds and holds dQ (all 256 columns), so no product is
  // computed twice.
  const Turns turns{wg, !C::ROLES};
  turns.start();
  int j = un.lo, done = 0;
  for (; j < un.hi && j < it.lo; ++j) {
    mbar_wait(full + 8 * r.s, r.ph);
    turns.begin();
    turns.end();
    advance<STAGES, C::ROLES>(r, j - un.lo, lane, load);
  }
  for (; j < it.hi; ++j, ++done) {
    const uint32_t kst = ring + r.s * C::STAGE, vst = kst + C::TILE;
    const int k0 = j * ROWS;
    const bool edge = k0 + ROWS > un.kv_len || (p.causal && k0 + ROWS - 1 > q_start) ||
                      (p.window > 0 && k0 <= q_start + ROWS - 1 - p.window);
    const auto pos = [&](int h, int col, int& qpos, int& kpos) {
      qpos = q_start + warp * 16 + g + 8 * h;
      kpos = k0 + col;
    };
    uint32_t pa[8][2], da[8][2];
    mbar_wait(full + 8 * r.s, r.ph);
    if constexpr (C::ROLES) {
      // S = Q . K^T (warpgroup 0) or dP = dO . V^T (warpgroup 1), operands
      // chosen before the product
      float sc[32];
      zero(sc);
      wgmma_fence();
      score_product<D>(sc, wg == 0 ? qs : dos, wg == 0 ? kst : vst);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(sc);
      if (wg == 0) {
        by_flags(p.softcap, edge, [&](auto cap, auto ed) {
          p_tile<false, decltype(cap)::value, decltype(ed)::value>(sc, pa, p, c, un.kv_len,
                                                                   lse_of, pos);
        });
        if (done > 0) named_bar(BAR_FREE, 256);   // warpgroup 1 has read the last tile's
        xchg_put(xchg, sc, t);
        named_arrive(BAR_READY, 256);
      } else {
        float pd[32];
        named_bar(BAR_READY, 256);
        xchg_get(xchg, pd, t);
        named_arrive(BAR_FREE, 256);
        ds_tile(pd, sc, da, c, delta_of);
        wgmma_fence();
        acc_product<D>(dq, da, kst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(dq);
      }
    } else {
      float sc[32], dp[32];
      zero(sc);
      zero(dp);
      turns.begin();
      wgmma_fence();
      score_product<D>(sc, qs, kst);
      score_product<D>(dp, dos, vst);
      wgmma_commit();
      turns.end();
      wgmma_wait<0>();
      fence_acc(sc);
      fence_acc(dp);
      by_flags(p.softcap, edge, [&](auto cap, auto ed) {
        p_and_ds<false, decltype(cap)::value, decltype(ed)::value>(sc, dp, pa, da, p, c,
                                                                   un.kv_len, lse_of, delta_of,
                                                                   pos);
      });
      wgmma_fence();
      acc_product<D>(dq, da, kst);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dq);
    }
    advance<STAGES, C::ROLES>(r, j - un.lo, lane, load);
  }
  if (C::ROLES && wg == 0 && done > 0) named_bar(BAR_FREE, 256);   // the last tile's release
  for (; j < un.hi; ++j) {
    mbar_wait(full + 8 * r.s, r.ph);
    turns.begin();
    turns.end();
    advance<STAGES, C::ROLES>(r, j - un.lo, lane, load);
  }
  turns.finish();

  // ---- epilogue: dQ staged in the Q tile (once both warpgroups' products
  // are done) and stored by TMA, clipped past T ----
  __syncthreads();
  if (it.valid && (!C::ROLES || wg == 1))
    store_tile<D>(dq, qs, &map_dq, it.head, it.row0, un.b, wg, t);
}

// ---------------------------------------------------------------- dk/dv

template <int D>
struct DkvLoad {
  const CUtensorMap *q, *dout;
  int kh, b, lo, n_tiles, G;
  uint32_t ring;
  // streamed tile x: query head kh G + x / n_tiles, query tile lo + x % n_tiles
  __device__ __forceinline__ void operator()(int x, int s, uint32_t bar) const {
    using C = Bwd<D>;
    const uint32_t qst = ring + s * C::STAGE;
    const int head = kh * G + x / n_tiles, row = (lo + x % n_tiles) * ROWS;
    mbar_expect_tx(bar, C::STAGE);
    for (int pn = 0; pn < D / 64; ++pn) {
      tma_load_4d(qst + pn * PANEL, q, 64 * pn, head, row, b, bar);
      tma_load_4d(qst + C::TILE + pn * PANEL, dout, 64 * pn, head, row, b, bar);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
fa_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv, const BwdParams p) {
  using C = Bwd<D>;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char fa_smem[];
  const uint32_t base = (smem_u32(fa_smem) + 1023u) & ~1023u;
  const uint32_t ring = base + C::RES, stats = ring + STAGES * C::STAGE;
  const uint32_t xchg = stats + C::STATS, res_full = xchg + C::XCHG;
  const uint32_t full = res_full + 8, empty = full + 8 * STAGES;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, g = lane / 4, c = lane % 4;

  Unit<D, false> un(p, blockIdx.x);
  init_barriers(res_full, full, empty, STAGES);
  if (threadIdx.x == 0) {   // the items' K and V
    mbar_expect_tx(res_full, (un.it0.valid + (C::ROLES ? 0 : un.it1.valid)) * 2 * C::TILE);
#pragma unroll
    for (int w = 0; w < C::ITEMS; ++w) {
      const Item& it = w == 0 ? un.it0 : un.it1;
      if (!it.valid) continue;
      for (int pn = 0; pn < D / 64; ++pn) {
        tma_load_4d(base + w * 2 * C::TILE + pn * PANEL, &map_k, 64 * pn, un.kh, it.row0, un.b,
                    res_full);
        tma_load_4d(base + w * 2 * C::TILE + C::TILE + pn * PANEL, &map_v, 64 * pn, un.kh,
                    it.row0, un.b, res_full);
      }
    }
  }
  un.ranges(p);
  const int n_tiles = un.hi - un.lo;
  const DkvLoad<D> load{&map_q, &map_do, un.kh, un.b, un.lo, max(n_tiles, 1), p.G, ring};
  Ring r{full, empty, 0, p.G * n_tiles, 0u};
  if (threadIdx.x == 0)   // the ring's first stages
    for (int x = 0; x < r.n && x < STAGES; ++x) load(x, x, full + 8 * x);

  const Item it = (C::ROLES || wg == 0) ? un.it0 : un.it1;
  const uint32_t ks = base + (C::ROLES ? 0 : wg) * 2 * C::TILE, vs = ks + C::TILE;
  const uint32_t my_stats = stats + wg * 2 * 2 * ROWS * 4;   // [buffer][lse2, delta][64]
  mbar_wait(res_full, 0);

  // acc0: dV, and acc1: dK; D 256 (ROLES): warpgroup 0 computes S^T and p,
  // hands p * dscale over and holds dV in acc0; warpgroup 1 computes dP^T
  // and ds and holds dK in acc0, so no product is computed twice
  float acc0[D / 2], acc1[C::ROLES ? 2 : D / 2];
  zero(acc0);
  zero(acc1);
  // a computed tile's lse (thread t < 64) or delta (t >= 64) of query row q0 +
  // t % 64, read one computed tile ahead so that its latency passes under a
  // step; lse in log2 units, +inf past T or with empty support
  const auto stat_of = [&](int gi, int i) {
    const int srow = i * ROWS + t % 64;
    const size_t at = ((size_t)un.b * p.H + un.kh * p.G + gi) * p.T + srow;
    float v = t < 64 ? INFINITY : 0.f;
    if (gi < p.G && srow < p.T) {
      if (t < 64) {
        const float l = p.lse[at];
        if (l != FA_NEG_INF) v = l * LOG2E;
      } else {
        v = p.delta_in[at];
      }
    }
    return v;
  };
  float stat_next = stat_of(it.hi > it.lo ? 0 : p.G, it.lo);
  const Turns turns{wg, !C::ROLES};
  turns.start();
  int x = 0, nbuf = 0, done = 0;
  for (int gi = 0; gi < p.G; ++gi) {
    int i = un.lo;
    for (; i < un.hi && i < it.lo; ++i, ++x) {
      mbar_wait(full + 8 * r.s, r.ph);
      turns.begin();
      turns.end();
      advance<STAGES, C::ROLES>(r, x, lane, load);
    }
    for (; i < it.hi; ++i, ++x, ++done) {
      const uint32_t qst = ring + r.s * C::STAGE, dost = qst + C::TILE;
      const int q0 = i * ROWS, k0 = it.row0;
      const bool edge = k0 + ROWS > un.kv_len ||
                        (p.causal && k0 + ROWS - 1 > q0 + p.q_offset) ||
                        (p.window > 0 && k0 <= q0 + p.q_offset + ROWS - 1 - p.window);
      const float stat = stat_next;
      stat_next = i + 1 < it.hi ? stat_of(gi, i + 1) : stat_of(gi + 1, it.lo);
      const uint32_t sb = my_stats + nbuf * 2 * ROWS * 4;
      // the buffer as a pointer: plain loads, which the compiler may schedule
      // and merge (the named barrier orders them after the stores)
      const float* sbp = reinterpret_cast<const float*>(fa_smem + (sb - smem_u32(fa_smem)));
      nbuf ^= 1;
      const auto lse_of = [&](int, int col) {
        return *reinterpret_cast<const float2*>(sbp + col);
      };
      const auto delta_of = [&](int, int col) {
        return *reinterpret_cast<const float2*>(sbp + ROWS + col);
      };
      const auto pos = [&](int h, int col, int& qpos, int& kpos) {
        qpos = q0 + col + p.q_offset;
        kpos = k0 + warp * 16 + g + 8 * h;
      };
      uint32_t pa[8][2], da[8][2];
      mbar_wait(full + 8 * r.s, r.ph);
      if constexpr (C::ROLES) {
        // the operands are chosen before the products, which are issued and
        // waited for on one path: S^T = K . Q^T and dV += P^T . dO (warpgroup
        // 0), dP^T = V . dO^T and dK += dS^T . Q (warpgroup 1)
        float sc[32];
        zero(sc);
        wgmma_fence();
        score_product<D>(sc, wg == 0 ? ks : vs, wg == 0 ? qst : dost);
        wgmma_commit();
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sb + 4 * t), "f"(stat) : "memory");
        named_bar(1 + wg, 128);
        wgmma_wait<0>();
        fence_acc(sc);
        if (wg == 0) {   // p (the A fragments in pa) and p * dscale, handed over
          by_flags(p.softcap, edge, [&](auto cap, auto ed) {
            p_tile<true, decltype(cap)::value, decltype(ed)::value>(sc, pa, p, c, un.kv_len,
                                                                    lse_of, pos);
          });
          if (done > 0) named_bar(BAR_FREE, 256);   // warpgroup 1 has read the last tile's
          xchg_put(xchg, sc, t);
          named_arrive(BAR_READY, 256);
        } else {         // ds, its A fragments in pa
          float pd[32];
          named_bar(BAR_READY, 256);
          xchg_get(xchg, pd, t);
          named_arrive(BAR_FREE, 256);
          ds_tile(pd, sc, pa, c, delta_of);
        }
        wgmma_fence();
        acc_product<D>(acc0, pa, wg == 0 ? dost : qst);
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc0);
      } else {
        float sc[32], dp[32];
        zero(sc);
        zero(dp);
        turns.begin();
        wgmma_fence();
        score_product<D>(sc, ks, qst);    // S^T = K . Q^T
        score_product<D>(dp, vs, dost);   // dP^T = V . dO^T
        wgmma_commit();
        turns.end();
        asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(sb + 4 * t), "f"(stat) : "memory");
        named_bar(1 + wg, 128);
        wgmma_wait<0>();
        fence_acc(sc);
        fence_acc(dp);
        by_flags(p.softcap, edge, [&](auto cap, auto ed) {
          p_and_ds<true, decltype(cap)::value, decltype(ed)::value>(sc, dp, pa, da, p, c,
                                                                    un.kv_len, lse_of, delta_of,
                                                                    pos);
        });
        wgmma_fence();
        acc_product<D>(acc0, pa, dost);   // dV += P^T . dO
        acc_product<D>(acc1, da, qst);    // dK += dS^T . Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_acc(acc0);
        fence_acc(acc1);
      }
      advance<STAGES, C::ROLES>(r, x, lane, load);
    }
    for (; i < un.hi; ++i, ++x) {
      mbar_wait(full + 8 * r.s, r.ph);
      turns.begin();
      turns.end();
      advance<STAGES, C::ROLES>(r, x, lane, load);
    }
  }
  turns.finish();
  if (C::ROLES && wg == 0 && done > 0) named_bar(BAR_FREE, 256);   // the last tile's release

  // ---- epilogue: dK and dV staged in the K and V tiles and stored by TMA,
  // clipped past S ----
  __syncthreads();
  if (it.valid) {
    if constexpr (C::ROLES) {
      store_tile<D>(acc0, wg == 0 ? vs : ks, wg == 0 ? &map_dv : &map_dk, un.kh, it.row0, un.b,
                    wg, t);
    } else {
      store_tile<D>(acc1, ks, &map_dk, un.kh, it.row0, un.b, wg, t);
      store_tile<D>(acc0, vs, &map_dv, un.kh, it.row0, un.b, wg, t);
    }
  }
}

// ---------------------------------------------------------------- host

BwdParams params(int B, int T, int S, int H, int KH, int D, int causal, int window, float scale,
                 float softcap, int items) {
  BwdParams p = {};
  p.T = T; p.S = S; p.H = H; p.KH = KH; p.G = H / KH;
  p.items = items;
  p.units = D == 256 ? items : (items + 1) / 2;   // Bwd<256>::ROLES: an item a unit
  p.total = p.units * B * KH;
  p.causal = causal; p.window = window; p.q_offset = causal ? S - T : 0;
  p.softcap = softcap > 0.f;
  p.cap_in = p.softcap ? scale / softcap : 0.f;
  p.cap_out = p.softcap ? softcap * LOG2E : 0.f;
  p.mul = p.softcap ? 1.f : scale * LOG2E;
  p.scale = scale;
  return p;
}

bool shape_ok(int B, int T, int S, int H, int KH, int D) {
  return B > 0 && T > 0 && S > 0 && H > 0 && KH > 0 && H % KH == 0 &&
         (D == 64 || D == 128 || D == 256);
}

template <int D>
int run_dq(const void* const (&ptr)[5], const long long (&st)[15], int B, const BwdParams& p,
           cudaStream_t stream) {
  VBT_CHECK((cudaError_t)bind_device(ptr[0]));
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int T = p.T, S = p.S, H = p.H, KH = p.KH;
  CUtensorMap maps[5];
  // q, k, v, dout read in place; dq contiguous
  if (!bhsd_map(enc, &maps[0], ptr[0], B, T, H, D, st[0], st[1], st[2], ROWS) ||
      !bhsd_map(enc, &maps[1], ptr[1], B, S, KH, D, st[3], st[4], st[5], ROWS) ||
      !bhsd_map(enc, &maps[2], ptr[2], B, S, KH, D, st[6], st[7], st[8], ROWS) ||
      !bhsd_map(enc, &maps[3], ptr[3], B, T, H, D, st[12], st[13], st[14], ROWS) ||
      !bhsd_map(enc, &maps[4], ptr[4], B, T, H, D, (long long)T * H * D, (long long)H * D, D,
                ROWS))
    return (int)cudaErrorInvalidValue;
  static const int attr = (int)cudaFuncSetAttribute(
      fa_bwd_dq_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<D>::SMEM);
  if (attr != 0) return attr;
  fa_bwd_dq_sm90_kernel<D><<<p.total, THREADS, Bwd<D>::SMEM, stream>>>(maps[0], maps[1], maps[2],
                                                                       maps[3], maps[4], p);
  VBT_CHECK_LAUNCH();
  return 0;
}

template <int D>
int run_dkv(const void* const (&ptr)[6], const long long (&st)[12], int B, const BwdParams& p,
            cudaStream_t stream) {
  VBT_CHECK((cudaError_t)bind_device(ptr[0]));
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int T = p.T, S = p.S, H = p.H, KH = p.KH;
  const long long packed[3] = {(long long)S * KH * D, (long long)KH * D, D};
  CUtensorMap maps[6];
  // q, k, v, dout read in place; dk, dv contiguous
  if (!bhsd_map(enc, &maps[0], ptr[0], B, T, H, D, st[0], st[1], st[2], ROWS) ||
      !bhsd_map(enc, &maps[1], ptr[1], B, S, KH, D, st[3], st[4], st[5], ROWS) ||
      !bhsd_map(enc, &maps[2], ptr[2], B, S, KH, D, st[6], st[7], st[8], ROWS) ||
      !bhsd_map(enc, &maps[3], ptr[3], B, T, H, D, st[9], st[10], st[11], ROWS) ||
      !bhsd_map(enc, &maps[4], ptr[4], B, S, KH, D, packed[0], packed[1], packed[2], ROWS) ||
      !bhsd_map(enc, &maps[5], ptr[5], B, S, KH, D, packed[0], packed[1], packed[2], ROWS))
    return (int)cudaErrorInvalidValue;
  static const int attr = (int)cudaFuncSetAttribute(
      fa_bwd_dkv_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Bwd<D>::SMEM);
  if (attr != 0) return attr;
  fa_bwd_dkv_sm90_kernel<D><<<p.total, THREADS, Bwd<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// dq [B, T, H, D] (contiguous) and delta [B, H, T] (f32, = sum_d out * dout)
// from q [B, T, H, D], k, v [B, S, KH, D], out and dout [B, T, H, D], each
// given with its element strides (batch, row, head): D contiguous, every
// stride a multiple of 8 elements (16 bytes), pointers 16-byte aligned; lse
// [B, H, T] contiguous. softcap <= 0: none; window <= 0: none.
extern "C" int vbt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out, const void* dout,
    const void* lse, const void* kv_lens, void* dq, void* delta, int B, int T, int S, int H,
    int KH, int D, int causal, int window, float scale, float softcap, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_st, long long o_sh,
    long long do_sb, long long do_st, long long do_sh, void* stream_ptr) {
  if (!shape_ok(B, T, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  const long long items = (long long)(H / KH) * ((T + ROWS - 1) / ROWS);
  const long long units = D == 256 ? items : (items + 1) / 2;
  if (units * B * KH > 0x7fffffff) return (int)cudaErrorInvalidValue;
  BwdParams p = params(B, T, S, H, KH, D, causal, window, scale, softcap, (int)items);
  p.kv_lens = (const int*)kv_lens;
  p.lse = (const float*)lse;
  p.delta_out = (float*)delta;
  p.out = (const bf16*)out;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  const void* const ptr[5] = {q, k, v, dout, dq};
  const long long st[15] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                            o_sb, o_st, o_sh, do_sb, do_st, do_sh};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return D == 256 ? run_dq<256>(ptr, st, B, p, stream)
       : D == 128 ? run_dq<128>(ptr, st, B, p, stream)
                  : run_dq<64>(ptr, st, B, p, stream);
}

// dk, dv [B, S, KH, D] (contiguous; the G query heads of a kv head summed)
// from q, k, v and dout with their strides (as above), lse and delta [B, H, T]
// contiguous f32.
extern "C" int vbt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, const void* kv_lens, void* dk, void* dv, int B, int T, int S, int H,
    int KH, int D, int causal, int window, float scale, float softcap, long long q_sb,
    long long q_st, long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_st, long long do_sh,
    void* stream_ptr) {
  if (!shape_ok(B, T, S, H, KH, D)) return (int)cudaErrorInvalidValue;
  const long long items = (S + ROWS - 1) / ROWS;
  const long long units = D == 256 ? items : (items + 1) / 2;
  if (units * B * KH > 0x7fffffff) return (int)cudaErrorInvalidValue;
  BwdParams p = params(B, T, S, H, KH, D, causal, window, scale, softcap, (int)items);
  p.kv_lens = (const int*)kv_lens;
  p.lse = (const float*)lse;
  p.delta_in = (const float*)delta;
  const void* const ptr[6] = {q, k, v, dout, dk, dv};
  const long long st[12] = {q_sb, q_st, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, do_sb, do_st, do_sh};
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  return D == 256 ? run_dkv<256>(ptr, st, B, p, stream)
       : D == 128 ? run_dkv<128>(ptr, st, B, p, stream)
                  : run_dkv<64>(ptr, st, B, p, stream);
}
