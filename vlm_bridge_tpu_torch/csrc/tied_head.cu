// The tied heads: x . E^T of the batch's hidden rows with the tied table, read
// where it lies (the same dict is the embedding the model gathers from), in
// one kernel whose epilogue is the only part that differs between them.
//   int8  E int8 [V, H] with one scale per vocab row:
//         y[m, v] = (x[m] . E[v]) * scale[v]
//   int4  the rows-packed table E4 int8 [V, H/2] (byte (v, k) holds columns k
//         and k + H/2, the low nibble first) with scales per row [V] or per
//         (H-group, row) [H/g, V]
// The sampled heads (LOGITS) write y as f32 logits [M, V], one launch a call;
// the greedy heads take ids[m] = argmax_v y[m, v] and never write y.
// Replaces: vlm_bridge_tpu/ops/quant.py:int8_matmul_t, whose body is
// _int8_mmt_kernel,
// Replaces: vlm_bridge_tpu/ops/quant.py:int4_matmul_t, whose body is
// _int4_mmt_kernel (the soft-cap stays with their caller, logits_from_hidden,
// as in JAX),
// Replaces: vlm_bridge_tpu/ops/quant.py:int8_matmul_t_argmax, whose body is
// _int8_mmt_argmax_kernel, and
// Replaces: vlm_bridge_tpu/ops/quant.py:int4_matmul_t_argmax, whose body is
// _int4_mmt_argmax_kernel. Gemma's final soft-cap is monotonic and skipped.
//
// Bound: bytes. At M = 64, V = 256000, H = 2304 a call streams the 590 MB int8
// table once (0.1765 ms at 3.35 TB/s), or 295 MB of nibbles and 18 MB of group
// scales (0.0936 ms); the sampled heads also write 65.5 MB of logits (+0.0196
// ms). The products, 2 M V H = 75.5 GFLOP, take 0.076 ms at 989 TFLOP/s: with
// int4 the tensor cores come close to the bytes.
//
// Design (scripts/head_torch.py times it):
// - Persistent blocks, one an SM. A unit is a 128-row vocab block
//   (ARGMAX_BLOCK_V, the block of the NaN rule) of one 64-row batch tile. A
//   block takes a run of units that differs from every other block's by at
//   most one, two at a time: its two consumer warpgroups, a unit each, share
//   each stage's slice of x, so x is read from the L2 once per 256 table rows.
// - A producer warp keeps a ring of stages full by TMA. A stage holds, for
//   each unit, a box of its 128 table rows read where they lie (the same dict
//   is the embedding the model gathers from; evict-first in the L2): int8 128
//   bytes a row under the 128-byte swizzle, int4 64. It is consumed in two
//   sub-steps of 64 columns (int8: its two chunks; int4: the low, then the
//   high nibbles), each with its box of x (64 rows, rows past M read as zeros).
// - A warpgroup widens its unit's bytes of a sub-step to bf16 in registers
//   (sm90.cuh: widen4, widen8_nibbles; exact) and stores them, in the table's
//   own column order, as a K-major 128-row B tile under the 128-byte swizzle.
//   Y[64 batch rows, 128 vocab rows] += x . E_unit^T is then four m64n128k16
//   wgmma, both operands from shared memory, while the next sub-step is
//   widened into the warpgroup's other B tile. Neither operand is permuted,
//   and nothing is copied in device memory. (With the table as the register A
//   operand the products are m64n64 at the batch's 64 columns, and ran slower
//   than this on an H100: PERF.md section 6.) 128 table bytes a row a stage read
//   faster than 64 there.
// - int4 scales that vary along the contraction: the sum is kept in the unit
//   of the scale of the half in hand (the low, then the high nibbles of each
//   stage); between two halves it is multiplied, column by column, by the old
//   scale over the new, and at the end by the last scale: sum_g P_g * s_g at
//   one more f32 rounding a half, and no second accumulator. A stage's two
//   scale rows of a warpgroup's 128 columns come by cp.async (4 bytes a copy:
//   any V) four stages ahead, and each thread turns its column's into the
//   factors once. Per-row scales multiply the sum once, as the int8 head's do.
// - The logits (LOGITS) leave from the accumulator as they lie: lane (g, t) of
//   warp wq holds batch rows 16 wq + g and + 8, vocab columns 8 j + 2 t and
//   + 1 of the unit, so each pair goes out as one float2 (a quad of lanes
//   writes 32 bytes of a row: whole sectors), streaming past the L2 (st.cs:
//   the logits are read once, by the sampler, after the call). Rows past M and
//   columns past V are not written. A unit's sums come from one fixed order,
//   so two calls give the same bits.
// - The argmax runs in registers: a batch row of the accumulator lies in one
//   warp, 32 vocab columns a lane, so each lane takes its columns' max and two
//   shuffles merge the four lanes of a row. A unit writes its (max, first
//   index) per batch row to bval / bidx, and argmax_reduce_kernel takes the
//   first winning unit.
//
// Argmax rules. The units run in parallel, so the reduce is two-pass: each
// unit writes (max, first index reaching it) for its 128 rows, and a second
// kernel takes, per batch row, the FIRST unit whose max is strictly greater
// than every earlier one. That keeps the first-index tie rule of jnp.argmax.
// NaN follows the TPU kernel, not the jnp fallback: a block whose logits hold
// a NaN never wins (its max compares false), and a row where no block wins
// (all-NaN) returns 0. The blocking belongs to the semantics of a row that is
// NaN only in part; the plain versions in ops/quant.py use the same 128 rows.
// The logits follow the plain version: a NaN in x or in a scale gives NaN.

#include <climits>

#include "sm90.cuh"

namespace {

constexpr int TH_WGS = 2;                       // consumer warpgroups, a unit each
constexpr int TH_THREADS = 128 * TH_WGS + 32;   // + the producer warp
constexpr int TH_UNIT = 128;                    // vocab rows of a unit (ARGMAX_BLOCK_V)
constexpr int TH_XBOX = 64 * 64 * 2;            // an x box: 64 batch rows x 64 columns bf16
constexpr int TH_BTILE = TH_UNIT * 64 * 2;      // a widened B tile: 128 rows x 64 columns bf16
constexpr int TH_SMEM_MAX = 232448;
// grouped int4: stages whose scales are on their way (cp.async) ahead of the
// one in hand, and the stages the scale buffers hold
constexpr int TH_AHEAD = 4, TH_RING = TH_AHEAD + 1;

template <bool INT4, bool GROUPED>
struct ThShape {
  // table bytes of a unit row a stage (int8: under the 128-byte swizzle when 128)
  static constexpr int BK = INT4 ? 64 : 128;
  // a stage's sub-steps of 64 columns: int8 its chunks, int4 the low and the
  // high nibbles; each has its x box
  static constexpr int SUB = INT4 ? 2 : BK / 64;
  static constexpr int X_BYTES = SUB * TH_XBOX;
  static constexpr int TBOX = TH_UNIT * BK;   // a unit's table box
  static constexpr int STAGE_BYTES = X_BYTES + TH_WGS * TBOX;
  // a warpgroup's scales, rows of its 128 columns: grouped int4, the low and
  // the high row of TH_RING stages, then two stages' factor rows; else two
  // pairs' per-row scales of its unit
  static constexpr int S_BYTES = (GROUPED ? TH_RING * 2 + 4 : 2) * TH_UNIT * 4;
  // the alignment slack, two B tiles a warpgroup, the scales
  static constexpr int FIXED = 1024 + TH_WGS * (2 * TH_BTILE + S_BYTES);
  // as many stages as fit, at most 8 (their barriers are static)
  static constexpr int STAGES_FIT = (TH_SMEM_MAX - 256 - FIXED) / STAGE_BYTES;
  static constexpr int STAGES = STAGES_FIT > 8 ? 8 : STAGES_FIT;
  static constexpr int SMEM = FIXED + STAGES * STAGE_BYTES;
  static_assert(STAGE_BYTES % 1024 == 0 && (TH_WGS * S_BYTES) % 1024 == 0,
                "each stage keeps the swizzle's 1024-byte alignment");
  static_assert(STAGES >= 2, "shared memory for two stages");
};

// The block's units [u, u1) of the (batch tile, vocab block) order, two at a
// time where the next one is of the same batch tile; a step is one stage. u =
// mb * nu + vb is kept as its batch tile mb and vocab block vb too, and the
// stage's scale group of grouped int4 as gi (c / kg), with no division.
struct Walk {
  int u, c, u1, nu, chunks, mb, vb, kg, gi, gc;
  bool two;   // the pair holds unit u + 1
  __device__ void start(int u0, int u1_, int nu_, int chunks_, int kg_) {
    u = u0, c = 0, u1 = u1_, nu = nu_, chunks = chunks_, kg = kg_, gi = 0, gc = 0;
    mb = u / nu, vb = u - mb * nu;
    two = pair();
  }
  __device__ bool pair() const { return u + 1 < u1 && vb + 1 < nu; }
  __device__ bool done() const { return u >= u1; }
  __device__ bool last() const { return c == chunks - 1; }
  __device__ void next() {
    if (++gc == kg) gc = 0, ++gi;
    if (++c == chunks) {
      c = 0, gi = 0, gc = 0;
      const int d = two ? 2 : 1;
      u += d, vb += d;
      if (vb >= nu) vb -= nu, ++mb;
      two = pair();
    }
  }
};

// (max, index) of two candidates: a NaN wins and stays; a tie takes the lower index
__device__ __forceinline__ void merge(float& b, int& a, float ob, int oa) {
  if (isnan(ob)) b = ob;
  else if (!isnan(b) && (ob > b || (ob == b && oa < a))) b = ob, a = oa;
}

// GROUPED: int4 scales per (H-group, row), scale_rows = H / group of them.
// LOGITS: out is y [M, V]; else out is bval [units, M], beside bidx.
template <bool INT4, bool GROUPED, bool LOGITS>
__global__ void __launch_bounds__(TH_THREADS, 1)
tied_head_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap tmap,
                 const float* __restrict__ scale, float* __restrict__ out,
                 int* __restrict__ bidx, int M, int V, int H, int scale_rows) {
  using S = ThShape<INT4, GROUPED>;
  constexpr int stages = S::STAGES;
  extern __shared__ unsigned char th_smem[];
  __shared__ __align__(8) uint64_t th_bars[2 * 8];   // each stage's loaded and consumed barriers
  const uint32_t base = smem_u32(th_smem);
  const uint32_t btiles = (base + 1023u) & ~1023u;              // [wg][2][128 x 64 bf16]
  const uint32_t scales = btiles + TH_WGS * 2 * TH_BTILE;       // [wg][S_BYTES]
  const uint32_t ring = scales + TH_WGS * S::S_BYTES;
  const uint32_t full = smem_u32(th_bars), empty = full + 8 * stages;

  const int nu = (V + TH_UNIT - 1) / TH_UNIT;
  const int units = (M + 63) / 64 * nu;
  // stages of a unit (int8 at 128 bytes: the last may reach past H, read as zeros)
  const int chunks = ((INT4 ? H / 2 : H) + S::BK - 1) / S::BK;
  Walk w;   // grouped int4: a scale group is kg stages of 64 packed bytes
  w.start((int)((long long)blockIdx.x * units / gridDim.x),
          (int)((long long)(blockIdx.x + 1) * units / gridDim.x), nu, chunks,
          GROUPED ? H / scale_rows / S::BK : 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * TH_WGS);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_id = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp_id == 4 * TH_WGS) {
    // ---- the producer: step i into stage i % stages once its last use is done ----
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmap)) : "memory");
      const uint64_t pol = l2_evict_first();   // the table is read once; x by every block
      for (int i = 0; !w.done(); ++i, w.next()) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
        const uint32_t st = ring + s * S::STAGE_BYTES, bar = full + 8 * s;
        const int mb = w.mb, vb = w.vb;
        mbar_expect_tx(bar, S::X_BYTES + (w.two ? 2 : 1) * S::TBOX);
        for (int j = 0; j < S::SUB; ++j)   // int8: chunk j of the stage; int4: the low, the high half
          tma_load(st + j * TH_XBOX, &xmap, INT4 ? j * (H / 2) + w.c * 64 : (w.c * S::SUB + j) * 64,
                   mb * 64, bar);
        for (int k = 0; k < (w.two ? 2 : 1); ++k)
          tma_load_hint(st + S::X_BYTES + k * S::TBOX, &tmap, w.c * S::BK, (vb + k) * TH_UNIT, bar,
                        pol);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes the pair's unit wg ----
  const int wg = warp_id / 4, wq = warp_id % 4, g = lane / 4, t = lane % 4;
  const int tw = threadIdx.x % 128;
  const uint32_t bt = btiles + wg * 2 * TH_BTILE;   // this warpgroup's two B tiles
  const uint32_t sc = scales + wg * S::S_BYTES;
  const float* scs = reinterpret_cast<const float*>(th_smem + (sc - base));
  // [4 j + 2 h + e]: batch row 16 wq + g + 8 h, vocab column 8 j + 2 t + e of the unit
  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;

  // Widen sub-step j of this warpgroup's unit bytes in the stage at st (int8:
  // the 64 bytes of chunk j of each row; int4: the low (j = 0) or the high
  // nibbles of its 64 bytes) into the B tile at dst: a thread takes four
  // 16-byte pieces of the 128 rows and stores each one's 16 bf16 as two
  // 16-byte chunks of its row, chunk c at c ^ (row % 8) under the swizzle. A
  // 128-byte table row lies under the swizzle too.
  auto widen = [&](uint32_t st, int j, uint32_t dst) {
    const uint32_t tb = st + S::X_BYTES + wg * S::TBOX;
#pragma unroll
    for (int it = 0; it < TH_UNIT * 64 / 16 / 128; ++it) {
      // 128-byte rows (under the swizzle): a lane a row, so a quarter warp's 8
      // lanes hit 8 chunk positions; 64-byte rows: 2 rows x 4 pieces of 16 bytes
      const int q = tw + 128 * it, row = S::BK == 128 ? q % 128 : q / 4,
                pp = S::BK == 128 ? q / 128 : q % 4, sw = row % 8;
      const uint32_t src = S::BK == 128 ? tb + row * 128 + (((4 * j + pp) ^ sw) << 4)
                                        : tb + row * S::BK + 16 * pp;
      const uint4 r = ld_shared_v4(src);
      const uint32_t d = dst + row * 128;
      uint32_t b[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (INT4) {
          uint32_t l0, l1, h0, h1;
          widen8_nibbles(word_of(r, k) ^ 0x88888888u, l0, l1, h0, h1);
          b[2 * k] = j ? h0 : l0;
          b[2 * k + 1] = j ? h1 : l1;
        } else {
          widen4(word_of(r, k), b[2 * k], b[2 * k + 1]);
        }
      }
      st_shared_v4(d + (((2 * pp) ^ sw) << 4), make_uint4(b[0], b[1], b[2], b[3]));
      st_shared_v4(d + (((2 * pp + 1) ^ sw) << 4), make_uint4(b[4], b[5], b[6], b[7]));
    }
  };
  // d += x_tile . B_tile^T over 64 columns, committed; the products run on
  // while the caller goes on
  auto products = [&](float (&d)[64], uint32_t xs, uint32_t bs) {
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<128>(d, smem_desc(xs + 32 * kk, 16, 1024), smem_desc(bs + 32 * kk, 16, 1024), 1);
    wgmma_commit();
  };
  auto finish = [&](float (&d)[64]) {
    wgmma_wait<0>();
    fence_acc(d);
  };
  // grouped int4: the sum is kept in the unit of the scale of the half in
  // hand. Each stage, a thread turns its column's scales into two factor rows
  // (TH_RING * 2 + 2 (i % 2) and the next): low / high, and high / the next
  // stage's low (the unit's last stage: its high, the final factor). A
  // scale below 1e-30 in magnitude counts as 1e-30; a NaN stays a NaN.
  float* fac = const_cast<float*>(scs) + TH_RING * 2 * TH_UNIT;
  auto factors = [&](int i, bool last) {
    const float* raw = scs + tw;
    auto nz = [](float v) { return fabsf(v) < 1e-30f ? 1e-30f : v; };
    const float lo = nz(raw[(i % TH_RING) * 2 * TH_UNIT]);
    const float hi = nz(raw[((i % TH_RING) * 2 + 1) * TH_UNIT]);
    const float lo1 = nz(raw[((i + 1) % TH_RING) * 2 * TH_UNIT]);
    fac[(i % 2) * 2 * TH_UNIT + tw] = __fdividef(lo, hi);
    fac[((i % 2) * 2 + 1) * TH_UNIT + tw] = last ? hi : __fdividef(hi, lo1);
  };
  auto rescale = [&](int row) {   // acc *= factor row `row`, column by column
    const float* fp = fac + row * TH_UNIT + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 f = *reinterpret_cast<const float2*>(fp + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h) acc[4 * j + 2 * h] *= f.x, acc[4 * j + 2 * h + 1] *= f.y;
    }
  };
  // scales into the warpgroup's buffers by cp.async (4 bytes a copy: any V),
  // one commit group: grouped int4, stage n's low and high rows of its unit's
  // columns into rows 2 (k % TH_RING) and the one after; else the per-row
  // scales of the pair that starts at n into row k % 2
  auto fetch = [&](const Walk& n, int k) {
    const int v = (n.vb + wg) * TH_UNIT + tw;   // past V: WG 1 of a pair of one unit
    if (!n.done() && v < V) {
      if constexpr (GROUPED) {
        const int gi = n.gi;
        const uint32_t d = sc + ((k % TH_RING) * 2 * TH_UNIT + tw) * 4;
        cp_async4(d, scale + (size_t)gi * V + v);
        cp_async4(d + TH_UNIT * 4, scale + (size_t)(scale_rows / 2 + gi) * V + v);
      } else {
        cp_async4(sc + ((k % 2) * TH_UNIT + tw) * 4, scale + v);
      }
    }
    cp_async_commit();
  };
  // LOGITS: acc times the factors at rsa (the per-row scales, or grouped
  // int4's final factor; a shared address) of unit vb, batch tile mb, into y:
  // a float2 a lane where the row stride keeps them 8-byte aligned (V even),
  // else one by one. The lane's place (t, g, wq) is read again from %tid.x:
  // kept from the mainloop it stays live across the unit, and the grouped
  // instantiation then spills at its 168 registers.
  auto store_logits = [&](int vb, int mb, uint32_t rsa) {
    uint32_t tx;
    asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tx));
    const int lt = tx % 4, lg = (tx % 32) / 4, lw = (tx / 32) % 4;
    const bool pairs = V % 2 == 0;
    const int v0 = vb * TH_UNIT + 2 * lt;   // the lane's first vocab column, then + 8 j
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb * 64 + 16 * lw + lg + 8 * h;
      float* yp = out + (size_t)m * V + v0;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 f = ld_shared_f2(rsa + 4 * (8 * j + 2 * lt));
        const float y0 = acc[4 * j + 2 * h] * f.x, y1 = acc[4 * j + 2 * h + 1] * f.y;
        const int v = v0 + 8 * j;
        if (pairs && v + 1 < V) {
          __stcs(reinterpret_cast<float2*>(yp + 8 * j), make_float2(y0, y1));
        } else {
          if (v < V) __stcs(yp + 8 * j, y0);
          if (v + 1 < V) __stcs(yp + 8 * j + 1, y1);
        }
      }
    }
  };
  // logits acc times the factors rs (the per-row scales, or grouped int4's
  // final factor) of unit vb, batch tile mb: (max, first index) per batch row
  // into bval / bidx
  auto epilogue = [&](int vb, int mb, const float* rs) {
    float best[2] = {-INFINITY, -INFINITY};
    int arg[2] = {INT_MAX, INT_MAX};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 f = *reinterpret_cast<const float2*>(rs + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // this lane's vocab columns, in order
        const int v = vb * TH_UNIT + 8 * j + 2 * t + e;
        if (v < V) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float y = acc[4 * j + 2 * h + e] * (e ? f.y : f.x);
            if (isnan(y)) best[h] = y;   // sticks: nothing compares above a NaN
            else if (y > best[h]) best[h] = y, arg[h] = v;
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1)   // the four lanes of the row
        merge(best[h], arg[h], __shfl_xor_sync(0xffffffffu, best[h], o),
              __shfl_xor_sync(0xffffffffu, arg[h], o));
      const int m = mb * 64 + 16 * wq + g + 8 * h;
      if (t == 0 && m < M) {
        out[(size_t)vb * M + m] = isnan(best[h]) ? -INFINITY : best[h];
        bidx[(size_t)vb * M + m] = arg[h];
      }
    }
  };

  // Sub-step k (sub-step j of stage i): its products run from B tile k % 2
  // while the next sub-step's bytes are widened into the other tile. One
  // barrier a sub-step: every warp's products are done with a tile before it
  // is widened into again, and every thread's widening is done before the
  // products read it.
  int pair_no = 0;   // pairs done (the per-row scales of pair p are in row p % 2)
  {
    Walk n = w;
    for (int k = 0; k < (GROUPED ? TH_AHEAD : 1); ++k, n.next()) fetch(n, k);
    if constexpr (GROUPED) cp_async_wait<TH_AHEAD - 2>();   // stages 0 and 1's
    else cp_async_wait<0>();
  }
  mbar_wait(full, 0);
  widen(ring, 0, bt);
  fence_proxy_async();
  named_bar(1 + wg, 128);
  for (int i = 0, k = 0; !w.done(); ++i) {
    const int s = i % stages, s1 = (i + 1) % stages;
    const uint32_t st = ring + s * S::STAGE_BYTES, st1 = ring + s1 * S::STAGE_BYTES;
    Walk n = w;
    n.next();
    const bool more = !n.done();
    if constexpr (GROUPED) {   // this stage's factors; stage i + TH_AHEAD's scales
      factors(i, w.last());
      Walk n2 = n;
      for (int k = 1; k < TH_AHEAD; ++k) n2.next();
      fetch(n2, i + TH_AHEAD);
    }
#pragma unroll
    for (int j = 0; j < S::SUB; ++j, ++k) {
      const uint32_t cur = bt + (k % 2) * TH_BTILE, nxt = bt + ((k + 1) % 2) * TH_BTILE;
      if constexpr (GROUPED) {   // into the unit of this half's scale
        if (j == 1) rescale((i % 2) * 2);
        else if (w.c != 0) rescale(((i + 1) % 2) * 2 + 1);
      }
      products(acc, st + j * TH_XBOX, cur);
      if (j + 1 < S::SUB) {
        widen(st, j + 1, nxt);
      } else if (more) {
        mbar_wait(full + 8 * s1, ((i + 1) / stages) & 1);
        widen(st1, 0, nxt);
      }
      finish(acc);
      fence_proxy_async();       // the next tile, before the tensor cores read it
      if (j == S::SUB - 1) {
        if (lane == 0) mbar_arrive(empty + 8 * s);
        if constexpr (GROUPED) cp_async_wait<TH_AHEAD - 2>();   // stage i + 2's have landed
        else cp_async_wait<0>();
      }
      named_bar(1 + wg, 128);
    }
    if (!GROUPED && w.c == 0) {   // the pair after this one: its per-row scales
      Walk n2 = w;
      for (int c = 0; c < chunks; ++c) n2.next();
      fetch(n2, pair_no + 1);
    }
    if (w.last()) {
      if (wg == 0 || w.two) {
        if constexpr (LOGITS)
          store_logits(w.vb + wg, w.mb,
                       sc + 4 * (GROUPED ? TH_RING * 2 * TH_UNIT + ((i % 2) * 2 + 1) * TH_UNIT
                                         : (pair_no % 2) * TH_UNIT));
        else
          epilogue(w.vb + wg, w.mb,
                   GROUPED ? fac + ((i % 2) * 2 + 1) * TH_UNIT : scs + (pair_no % 2) * TH_UNIT);
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] = 0.f;
      ++pair_no;
    }
    w.next();
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

// One call: the head kernel over min(SMs, units) blocks, then (argmax) the
// reduce. scale_rows: grouped int4's scale rows (H / group), else 0. LOGITS:
// out is y, and bidx, ids are not used.
template <bool INT4, bool GROUPED, bool LOGITS>
int th_launch(const void* x, const void* E, const void* scale, void* out, void* bidx, void* ids,
              int M, int V, int H, int scale_rows, cudaStream_t st) {
  using S = ThShape<INT4, GROUPED>;
  VBT_CHECK((cudaError_t)bind_device(x));
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap xm, tm;
  if (!make_map(enc, &xm, x, M, H, 64) ||
      !make_byte_map(enc, &tm, E, V, INT4 ? H / 2 : H, TH_UNIT, S::BK, S::BK == 128))
    return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // one flag for each instantiation
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(tied_head_kernel<INT4, GROUPED, LOGITS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM));
    allowed = true;
  }
  const int nblk = (V + TH_UNIT - 1) / TH_UNIT, units = (M + 63) / 64 * nblk;
  tied_head_kernel<INT4, GROUPED, LOGITS><<<min(sm_count(), units), TH_THREADS, S::SMEM, st>>>(
      xm, tm, (const float*)scale, (float*)out, (int*)bidx, M, V, H, scale_rows);
  VBT_CHECK_LAUNCH();
  if constexpr (!LOGITS) {
    argmax_reduce_kernel<<<M, 256, 0, st>>>((const float*)out, (const int*)bidx, (int*)ids, M,
                                            nblk);
    VBT_CHECK_LAUNCH();
  }
  return 0;
}

// What the kernel takes: int8 H a multiple of 64 (a stage of 128 columns whose
// last 64 lie past H reads them as zeros); int4 H a multiple of 128 and a group
// (0: one scale a row) that is a multiple of 64 dividing H / 2. Returns grouped
// int4's scale rows (H / group), 0 for per-row scales, or -1 for a shape it
// does not take.
int th_scale_rows(bool int4, int M, int V, int H, int group) {
  if (M < 1 || V < 1 || H < 64 || H % (int4 ? 128 : 64) != 0) return -1;
  if (!int4 || group == 0) return 0;
  return group % 64 != 0 || (H / 2) % group != 0 ? -1 : H / group;
}

}  // namespace

// y[M, V] f32 = (x[M, H] bf16 . E[V, H]^T int8) * scale[V]
extern "C" int vbt_int8_matmul_t(const void* x, const void* E, const void* scale, void* y,
                                 int M, int V, int H, void* stream_ptr) {
  if (th_scale_rows(false, M, V, H, 0) < 0) return (int)cudaErrorInvalidValue;
  return th_launch<false, false, true>(x, E, scale, y, nullptr, nullptr, M, V, H, 0,
                                       (cudaStream_t)stream_ptr);
}

// y[M, V] f32 = x[M, H] bf16 . dequant4(E4[V, H/2])^T; scale f32 [V] (group ==
// 0) or [H/group, V]
extern "C" int vbt_int4_matmul_t(const void* x, const void* E, const void* scale, void* y,
                                 int M, int V, int H, int group, void* stream_ptr) {
  const int rows = th_scale_rows(true, M, V, H, group);
  if (rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  return rows ? th_launch<true, true, true>(x, E, scale, y, nullptr, nullptr, M, V, H, rows, st)
              : th_launch<true, false, true>(x, E, scale, y, nullptr, nullptr, M, V, H, 0, st);
}

// ids[m] = argmax_v of x[M, H] bf16 . (E[V, H] int8)^T * scale[V]; bval/bidx:
// scratch of ceil(V / 128) * M each.
extern "C" int vbt_int8_matmul_t_argmax(const void* x, const void* E, const void* scale,
                                        void* bval, void* bidx, void* ids, int M, int V, int H,
                                        void* stream_ptr) {
  if (th_scale_rows(false, M, V, H, 0) < 0) return (int)cudaErrorInvalidValue;
  return th_launch<false, false, false>(x, E, scale, bval, bidx, ids, M, V, H, 0,
                                        (cudaStream_t)stream_ptr);
}

// ids[m] = argmax_v of x[M, H] bf16 . dequant4(E4[V, H/2])^T; scale f32 [V]
// (group == 0) or [H/group, V]. bval/bidx as for the int8 head.
extern "C" int vbt_int4_matmul_t_argmax(const void* x, const void* E, const void* scale,
                                        void* bval, void* bidx, void* ids, int M, int V, int H,
                                        int group, void* stream_ptr) {
  const int rows = th_scale_rows(true, M, V, H, group);
  if (rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream_ptr;
  return rows ? th_launch<true, true, false>(x, E, scale, bval, bidx, ids, M, V, H, rows, st)
              : th_launch<true, false, false>(x, E, scale, bval, bidx, ids, M, V, H, 0, st);
}
