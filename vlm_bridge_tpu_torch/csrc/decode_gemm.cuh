// The decode GEMM core of the fused decode steps (stack_step.cu,
// bridge_step.cu): Y[M, N] += (A[M, K] @ W[K, N]) * scale, W int8
// (i8_gemm.cu) or int4 with scales per group of rows (i4_gemm.cu), A f32
// stored split as bf16 hi + lo halves (common.cuh:store_split). The design
// and its bound are described at the top of i8_gemm.cu; this header holds
// the kernel both files instantiate and the host's side of a launch.
#pragma once

#include "sm90.cuh"

namespace {

// warps 0-11: three consumer warpgroups, one 64-column tile each; warps 12
// and 13: the producers (lane 0 of one loads the activations, of the other
// the weights). Compiled for 512 threads so that ptxas keeps to the 128
// registers a thread a block of 14 warps can have (four warps share a
// sub-partition's 16,384).
constexpr int DG_WGS = 3;
constexpr int DG_THREADS = 128 * DG_WGS + 64;
constexpr int DG_BN = 64 * DG_WGS;   // weight columns a block covers
constexpr int DG_BK = 64;            // depth of a stage
constexpr int DG_FRAG = 2048;        // one 64-column tile's fragment run: 16 bytes x 128 lanes
// a stage's activations: hi and lo rows (2 x 64) x DG_BK bf16, one box of
// the (K, M, 2) tensor map under the 128-byte swizzle
constexpr int DG_ACT_BYTES = 2 * 64 * DG_BK * 2;
// the epilogue's staging: 32 rows x DG_BN columns f32, rows padded by 4
// floats so that a warp's stores of a fragment hit 32 banks
constexpr int DG_EPI_LD = DG_BN + 4;
constexpr int DG_EPI_BYTES = 32 * DG_EPI_LD * 4;
// one slot of the stream-K workspace: a run's partial sums of one tile, 64
// rows x DG_BN columns f32 (ops/decode_kernels.py:stream_k_workspace)
constexpr int DG_SLOT = 64 * DG_BN;

}  // namespace

// The stream-K workspace of a launch. A block's run of a tile that other
// blocks also contribute to ends in `slots`: slot 2 b for the run that begins
// at the block's first unit, 2 b + 1 for the one that begins later (a block
// has at most one of each). counters[tile] counts the arrivals of the tile's
// contributors and then those done with their share of the sum; the last one
// sets it back to zero, so the counters are zero between launches. The sum
// of a tile is in slot order, so the bits of Y depend on the shapes and the
// SM count only.
struct DgWork {
  float* slots;
  unsigned* counters;
  int n_slots, n_counters;
};

// The workspace behind `ws` (f32: n_slots slots, then n_counters u32
// counters, zero between launches)
inline DgWork dg_work(void* ws, int n_slots, int n_counters) {
  float* slots = static_cast<float*>(ws);
  return DgWork{slots, reinterpret_cast<unsigned*>(slots + (size_t)n_slots * DG_SLOT), n_slots,
                n_counters};
}

namespace {

template <bool INT4>
struct DgShape {
  static constexpr int SUB_BYTES = INT4 ? 64 * DG_BK / 2 : 64 * DG_BK;   // a 64-column tile a stage
  static constexpr int STAGE_BYTES = DG_ACT_BYTES + DG_WGS * SUB_BYTES;
  static constexpr int STAGES = INT4 ? 9 : 7;
  // the ring (aligned to 1024 for the swizzle), the staging, the stages'
  // full and empty barriers
  static constexpr int SMEM = STAGES * STAGE_BYTES + DG_EPI_BYTES + 1024 + STAGES * 16;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// D[64, 128] += A[64, 16] . B[16, 128]: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24), TM_D8(32), TM_D8(40), TM_D8(48), TM_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// keeps the compiler from moving writes of A fragments past a wgmma fence
template <int R>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

__device__ __forceinline__ float scale_or(const float* p, bool valid) {
  return valid ? fmaxf(*p, 1e-30f) : 1.f;
}

// Y[m, n..n+3] += v, one vector reduction in the L2: used by a tile's only
// writer, so the one addition has one order
__device__ __forceinline__ void red_add4(float* y, float4 v) {
#if __CUDA_ARCH__ >= 900 && (__CUDACC_VER_MAJOR__ > 12 || __CUDACC_VER_MINOR__ >= 4)
  atomicAdd(reinterpret_cast<float4*>(y), v);
#else
  atomicAdd(y, v.x);
  atomicAdd(y + 1, v.y);
  atomicAdd(y + 2, v.z);
  atomicAdd(y + 3, v.w);
#endif
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// the block whose units [u0, u1) hold unit x: the largest b with
// floor(b units / grid) <= x
__device__ __forceinline__ int block_of(long long x, int units, int grid) {
  return (int)(((x + 1) * grid - 1) / units);
}

// Float4s [lo, hi) of a tile's share (float4 it at row it / q4, column
// 4 (it % q4) of the tile's y): the sum over the n slots in contributor order
// (slot 0 `first`, slot j >= 1 at rest + 2 j slots), added into y (zero there:
// one writer, one addition). A thread takes IPT float4s at a time, with the
// loads of JB slots of each in flight together, so that their L2 latencies
// overlap.
template <int JB, int IPT>
__device__ __forceinline__ void sum_share(const float* first, const float* rest, int n, int lo,
                                          int hi, int q4, float* y, int N) {
  for (int base = lo + threadIdx.x; base < hi; base += 128 * DG_WGS * IPT) {
    int at[IPT];
    float4 acc[IPT];
#pragma unroll
    for (int u = 0; u < IPT; ++u) {
      const int it = base + u * 128 * DG_WGS;
      at[u] = it < hi ? it / q4 * DG_BN + 4 * (it % q4) : -1;
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j0 = 0; j0 < n; j0 += JB) {
      float4 v[JB][IPT];
#pragma unroll
      for (int j = 0; j < JB; ++j) {
        const float* slot = j0 + j == 0 ? first : rest + (size_t)2 * (j0 + j) * DG_SLOT;
#pragma unroll
        for (int u = 0; u < IPT; ++u)
          if (j0 + j < n && at[u] >= 0)
            v[j][u] = __ldcg(reinterpret_cast<const float4*>(slot + at[u]));
      }
#pragma unroll
      for (int j = 0; j < JB; ++j)
#pragma unroll
        for (int u = 0; u < IPT; ++u)
          if (j0 + j < n && at[u] >= 0) acc[u] = add4(acc[u], v[j][u]);
    }
#pragma unroll
    for (int u = 0; u < IPT; ++u)
      if (at[u] >= 0) red_add4(y + (size_t)(at[u] / DG_BN) * N + at[u] % DG_BN, acc[u]);
  }
}

// The fixed-order sum of tile `tile`, whose units are [x0, x0 + chunks):
// wait for the arrivals of its n contributors (blocks bf .. bf + n - 1),
// count this block past the wait, and sum this block's 1/n of the tile's
// float4s over the n slots in contributor order into Y. All the grid's
// blocks are resident (one a SM), and every block arrives at all its tiles
// before it waits at any, so the wait ends. Run by the DG_WGS consumer
// warpgroups after finish_tiles arrived.
__device__ __forceinline__ void finish_tile(int tile, int n_tiles, int chunks, int units,
                                            const DgWork& ws, float* __restrict__ Y, int M,
                                            int N) {
  const long long x0 = (long long)tile * chunks;
  const int G = gridDim.x, bf = block_of(x0, units, G);
  const int n = block_of(x0 + chunks - 1, units, G) - bf + 1, k = blockIdx.x - bf;
  // the first contributor's run begins after its first unit: its tail slot
  const bool mid = (long long)bf * units / G < x0;
  unsigned* cnt = ws.counters + tile;
  if (threadIdx.x == 0) {
    while (ld_acquire(cnt) < (unsigned)n) __nanosleep(32);
    // done with the wait: the last of the n to pass it sets the counter back
    // to zero for the next launch (which starts after every block's exit)
    if (atomicAdd(cnt, 1u) == (unsigned)(2 * n - 1)) atomicExch(cnt, 0u);
  }
  named_bar(4, 128 * DG_WGS);
  const int m0 = tile / n_tiles * 64, n0 = tile % n_tiles * DG_BN;
  const int q4 = min(DG_BN, N - n0) / 4, items = min(64, M - m0) * q4;
  const int lo = k * items / n, hi = (k + 1) * items / n;
  const float* first = ws.slots + (size_t)(mid ? 2 * bf + 1 : 2 * bf) * DG_SLOT;
  const float* rest = ws.slots + (size_t)2 * bf * DG_SLOT;   // slot 2 (bf + j) for j >= 1
  float* y = Y + (size_t)m0 * N + n0;
  // many contributors leave a thread about one float4 with all its slots'
  // loads in flight; few leave it several float4s, four slots of each
  if (n > 4)
    sum_share<16, 1>(first, rest, n, lo, hi, q4, y, N);
  else
    sum_share<4, 4>(first, rest, n, lo, hi, q4, y, N);
}

// After a block's last unit: the tiles it shares with other blocks, the one
// its first unit is in (unless the block ran all of it) and the one its last
// unit is in (unless that run ended the tile, so that the block ran it
// whole). Their partial sums are in the slots: the block arrives at both
// counters (one fence publishes both runs' stores, so that no warp waits on
// its stores inside the main loop), then sums its share of each. Not
// inlined: the split is recomputed here, so that none of it stays in
// registers across the main loop.
__device__ __noinline__ void finish_tiles(DgWork ws, float* Y, int M, int N, int K) {
  const int n_tiles = (N + DG_BN - 1) / DG_BN, chunks = K / DG_BK;
  const int units = (M + 63) / 64 * n_tiles * chunks;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int u1 = (int)((long long)(blockIdx.x + 1) * units / gridDim.x);
  const int t_head = u0 / chunks, t_tail = (u1 - 1) / chunks;
  const bool head = u0 % chunks != 0 || u1 < (t_head + 1) * chunks;
  const bool tail = t_tail != t_head && u1 % chunks != 0;
  named_bar(4, 128 * DG_WGS);   // every consumer's slot stores are issued
  if (threadIdx.x == 0) {
    __threadfence();
    if (head) atomicAdd(ws.counters + t_head, 1u);
    if (tail) atomicAdd(ws.counters + t_tail, 1u);
  }
  if (head) finish_tile(t_head, n_tiles, chunks, units, ws, Y, M, N);
  if (tail) finish_tile(t_tail, n_tiles, chunks, units, ws, Y, M, N);
}

// This lane's bytes of its warpgroup's 64-column tile in a stage (int8: two
// runs of 32 rows of K; int4: one run of 64 rows, two nibbles a byte) ...
template <bool INT4>
struct FragBytes {
  uint4 v[INT4 ? 1 : 2];
};

template <bool INT4>
__device__ __forceinline__ FragBytes<INT4> load_bytes(uint32_t wsm) {
  FragBytes<INT4> b;
#pragma unroll
  for (int r = 0; r < (INT4 ? 1 : 2); ++r) b.v[r] = ld_shared_v4(wsm + r * DG_FRAG);
  return b;
}

// ... widened to its A fragments of the stage's four k16 steps
template <bool INT4>
__device__ __forceinline__ void widen_frags(const FragBytes<INT4>& b, uint32_t (&a)[4][4]) {
  if constexpr (INT4) {
    // low nibbles: k16 steps 0, 1; high nibbles: 2, 3 (words x, y a step's
    // rows g / g + 8 at k 2t.., z, w the next step's)
    const uint32_t wd[4] = {b.v[0].x ^ 0x88888888u, b.v[0].y ^ 0x88888888u,
                            b.v[0].z ^ 0x88888888u, b.v[0].w ^ 0x88888888u};
#pragma unroll
    for (int w = 0; w < 4; ++w)   // word w: registers 2 (w % 2), + 1 of steps w / 2 and 2 + w / 2
      widen8_nibbles(wd[w], a[w / 2][2 * (w % 2)], a[w / 2][2 * (w % 2) + 1],
                     a[2 + w / 2][2 * (w % 2)], a[2 + w / 2][2 * (w % 2) + 1]);
  } else {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      widen4(b.v[r].x, a[2 * r][0], a[2 * r][1]);
      widen4(b.v[r].y, a[2 * r][2], a[2 * r][3]);
      widen4(b.v[r].z, a[2 * r + 1][0], a[2 * r + 1][1]);
      widen4(b.v[r].w, a[2 * r + 1][2], a[2 * r + 1][3]);
    }
  }
}

// One block a stream of work units (a DG_BN-column tile's 64 rows of K, for
// one 64-row block of A): units [u0, u1) of the tile-major order, so a block
// takes a run of K slices of one tile, or the end of one tile and the start
// of the next. Each run of one tile ends in an epilogue: a run of the whole
// tile adds its sums into Y; any other run stores its partial sums into its
// workspace slot. After its last unit the block arrives at the counters of
// the tiles it left partial and sums its share of each (finish_tiles). KSUB: k16
// steps between two waits on the tensor cores (4: a stage; 2: int4 scale
// groups that end inside a stage).
template <bool INT4, int KSUB>
__global__ void __launch_bounds__(512, 1)
decode_gemm_kernel(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap wts,
                   int layer, const float* __restrict__ scale, const float* __restrict__ bias,
                   int group, float* __restrict__ Y, int M, int N, int K, const DgWork ws) {
  using S = DgShape<INT4>;
  extern __shared__ unsigned char dg_smem[];
  const uint32_t ring = (smem_u32(dg_smem) + 1023u) & ~1023u;
  const uint32_t epi = ring + S::STAGES * S::STAGE_BYTES;
  const uint32_t full = epi + DG_EPI_BYTES;    // STAGES barriers: stage loaded
  const uint32_t empty = full + S::STAGES * 8;   // STAGES barriers: stage consumed

  const int n_tiles = (N + DG_BN - 1) / DG_BN, chunks = K / DG_BK;
  const int units = (M + 63) / 64 * n_tiles * chunks;
  const int u0 = (int)((long long)blockIdx.x * units / gridDim.x);
  const int n_units = (int)((long long)(blockIdx.x + 1) * units / gridDim.x) - u0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + 8 * s, 2);               // the producers' arrives, plus the bytes
      mbar_init(empty + 8 * s, 4 * DG_WGS);     // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * DG_WGS) {
    // ---- producers: unit i into stage i % STAGES once its last use is done:
    // the activations' box, and the weights' box of the DG_WGS 64-column
    // fragment runs of the tile (zeros past N) ----
    const int role = threadIdx.x - 128 * DG_WGS;   // 0: activations, 32: weights
    if (role % 32 == 0) {
      const CUtensorMap* map = role == 0 ? &act : &wts;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
      // the weights are read once: they must not push the activations and
      // the output, which the reductions read and write, out of the L2
      const uint64_t pol = l2_evict_first();
      int c = u0 % chunks, nt = u0 / chunks % n_tiles, mb = u0 / chunks / n_tiles;
      for (int i = 0, s = 0; i < n_units; ++i) {
        if (i >= S::STAGES) mbar_wait(empty + 8 * s, (i / S::STAGES - 1) & 1);
        const uint32_t st = ring + s * S::STAGE_BYTES, bar = full + 8 * s;
        if (role == 0) {
          mbar_expect_tx(bar, DG_ACT_BYTES);
          tma_load_3d(st, &act, c * DG_BK, mb * 64, 0, bar);
        } else {
          mbar_expect_tx(bar, DG_WGS * S::SUB_BYTES);
          tma_load_4d_hint(st + DG_ACT_BYTES, &wts, 0, c * DG_BK / (INT4 ? 64 : 32),
                           nt * DG_WGS, layer, bar, pol);
        }
        if (++s == S::STAGES) s = 0;
        if (++c == chunks) {
          c = 0;
          if (++nt == n_tiles) nt = 0, ++mb;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg holds the block's 64-column tile wg ----
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_groups = INT4 ? K / group : 1;
  // the hi and lo halves are the B tile's rows 0-63 and 64-127: [4 j + 2 h +
  // e] holds row m = 8 (j % 8) + 2 t + e of weight column col(h), of hi for
  // j < 8 and of lo for j >= 8
  float acc[64];
#pragma unroll
  for (int x = 0; x < 64; ++x) acc[x] = 0.f;
  // per row of the accumulator (h): int8 the column's scale and bias; int4
  // the scale of the current and the next group
  float sc[2], nx[2], bi[2];
  const uint32_t wlane = DG_ACT_BYTES + wg * S::SUB_BYTES + warp * 512 + lane * 16;
  // the unit in hand: its index in the block's run, its K slice, column tile
  // and row block, its stage and the stage's parity
  int i = 0, c = u0 % chunks, nt = u0 / chunks % n_tiles, mb = u0 / chunks / n_tiles;
  int s = 0;
  uint32_t ph = 0;
  bool run_start = true;

  // unit i: its products from the fragments in `a`; while they run, the next
  // unit's fragments into `an` (int8), or its bytes into `nb` (int4: the
  // widened fragments of two units do not fit beside the accumulator; the
  // nibbles are widened as the unit starts)
  FragBytes<INT4> nb;
  auto unit = [&](uint32_t (&a)[4][4], uint32_t (&an)[4][4]) {
    if constexpr (INT4) widen_frags<INT4>(nb, a);
    const int n0 = nt * DG_BN;
    const bool last = i == n_units - 1 || c == chunks - 1;   // this run of the tile ends
    auto col = [&](int h) { return n0 + 64 * wg + 16 * warp + g + 8 * h; };
    if (run_start) {   // its rows' scales (and the bias on a tile's first slice)
      const int grp = INT4 ? c * DG_BK / group : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = col(h);
        const bool in = n < N;
        sc[h] = INT4 ? scale_or(scale + (size_t)grp * N + n, in) : (in ? scale[n] : 0.f);
        nx[h] = scale_or(scale + (size_t)(grp + 1) * N + n, INT4 && in && grp + 1 < n_groups);
        bi[h] = (!INT4 && bias != nullptr && c == 0 && in) ? bias[n] : 0.f;
      }
    }
    const uint32_t st = ring + s * S::STAGE_BYTES;
#pragma unroll
    for (int part = 0; part < 4 / KSUB; ++part) {
      fence_acc(acc);
#pragma unroll
      for (int kk = part * KSUB; kk < (part + 1) * KSUB; ++kk) fence_frag(a[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = part * KSUB; kk < (part + 1) * KSUB; ++kk)
        wgmma_rs_n128(acc, a[kk], smem_desc(st + kk * 32, 16, 1024));
      wgmma_commit();
      if (part == 4 / KSUB - 1 && i + 1 < n_units) {   // under the products: the next unit's
        const int s1 = s + 1 == S::STAGES ? 0 : s + 1;
        mbar_wait(full + 8 * s1, s1 == 0 ? ph ^ 1 : ph);
        if constexpr (INT4) {
          nb = load_bytes<INT4>(ring + s1 * S::STAGE_BYTES + wlane);
        } else {
          widen_frags<INT4>(load_bytes<INT4>(ring + s1 * S::STAGE_BYTES + wlane), an);
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if constexpr (INT4) {
        // a scale group ends here inside this run: the accumulator moves to
        // the next group's unit, sum_g P_g * scale[g] at one rounding a group
        const int k_next = c * DG_BK + (part + 1) * KSUB * 16;
        if (k_next % group == 0 && !(last && part == 4 / KSUB - 1)) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float f = sc[h] / nx[h];
#pragma unroll
            for (int j = 0; j < 16; ++j) {
              acc[4 * j + 2 * h] *= f;
              acc[4 * j + 2 * h + 1] *= f;
            }
            sc[h] = nx[h];
            const int grp = k_next / group + 1, n = col(h);
            nx[h] = scale_or(scale + (size_t)grp * N + n, n < N && grp < n_groups);
          }
        }
      }
    }
    // this warp is done with the stage (its share of each wgmma is complete)
    if (lane == 0) mbar_arrive(empty + 8 * s);

    if (last) {
      // (hi + lo) * scale (+ bias), staged in shared memory as rows of Y, half
      // the rows at a time, then, a warp a row segment of 256 bytes, added
      // into Y (a run of the whole tile) or stored into the run's slot
      const int m0 = mb * 64;
      const int tw = threadIdx.x % 128, cc = 64 * wg + 4 * (tw % 16);   // 4 columns of the block
      // the run began at the block's first unit (i - c is minus the first
      // unit's K slice there, the run's first unit index elsewhere); it
      // covers the tile whole if it ends the tile and is `chunks` units long
      const bool first_run = i <= c;
      const bool whole = c == chunks - 1 && (!first_run || i + 1 == chunks);
      float* dst = whole ? Y + (size_t)m0 * N + n0
                         : ws.slots + (size_t)(2 * blockIdx.x + (first_run ? 0 : 1)) * DG_SLOT;
      const int ld = whole ? N : DG_BN;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cb = 64 * wg + 16 * warp + g + 8 * h;   // column in the block
#pragma unroll
          for (int j = 4 * half; j < 4 * half + 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                               epi + ((8 * j + 2 * t + e - 32 * half) * DG_EPI_LD + cb) * 4),
                           "f"((acc[4 * j + 2 * h + e] + acc[4 * j + 32 + 2 * h + e]) * sc[h] +
                               bi[h])
                           : "memory");
        }
        named_bar(1 + wg, 128);
        if (n0 + cc < N)
          for (int r = tw / 16; r < 32 && m0 + 32 * half + r < M; r += 8) {
            const uint4 u = ld_shared_v4(epi + (r * DG_EPI_LD + cc) * 4);
            const float4 v = make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                                         __uint_as_float(u.z), __uint_as_float(u.w));
            float* p = dst + (size_t)(32 * half + r) * ld + cc;
            if (whole)   // this block alone adds into the tile
              red_add4(p, v);
            else
              __stcg(reinterpret_cast<float4*>(p), v);
          }
        named_bar(1 + wg, 128);   // the staging is read before it is written again
      }
#pragma unroll
      for (int x = 0; x < 64; ++x) acc[x] = 0.f;
    }
    // the next unit
    ++i;
    if (++s == S::STAGES) s = 0, ph ^= 1;
    run_start = ++c == chunks;
    if (run_start) {
      c = 0;
      if (++nt == n_tiles) nt = 0, ++mb;
    }
  };

  uint32_t fa[4][4], fb[4][4];
  mbar_wait(full, 0);
  if constexpr (INT4) {
    nb = load_bytes<INT4>(ring + wlane);
  } else {
    widen_frags<INT4>(load_bytes<INT4>(ring + wlane), fa);
  }
  while (i < n_units) {
    unit(fa, fb);
    if (i < n_units) unit(fb, fa);
  }
  finish_tiles(ws, Y, M, N, K);
}

// ---- host ----

// A split activation [2, M, lda] bf16 (hi rows, then lo rows) as the GEMMs'
// B operand: a (K, M, 2) tensor map in boxes of 64 x 64 x 2, rows past M
// read as zeros
inline int make_act_map(CUtensorMap* map, const bf16* a, int lda, int M, int K) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)lda * 2, (cuuint64_t)M * lda * 2};
  const cuuint32_t box[3] = {DG_BK, 64, 2};
  return make_map_nd(enc, map, a, 3, dims, strides, box) ? 0 : (int)cudaErrorInvalidValue;
}

// L stacked weights [L, K, N] in fragment order (to_fragments: [N/64, K/32,
// 2048 B] a layer; to_fragments4: [N/64, K/64, 2048 B]) as a 4-D tensor map
// of 8-byte words (256 a fragment run, runs, 64-column tiles, layers) in
// boxes of one stage: DG_BK rows of K for DG_WGS tiles; tiles past N read as
// zeros
inline int make_weight_map(CUtensorMap* map, const void* w, int L, int K, int N, bool int4) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const int run = int4 ? 64 : 32, runs = K / run;
  const cuuint64_t dims[4] = {DG_FRAG / 8, (cuuint64_t)runs, (cuuint64_t)N / 64, (cuuint64_t)L};
  const cuuint64_t strides[3] = {DG_FRAG, (cuuint64_t)runs * DG_FRAG,
                                 (cuuint64_t)runs * DG_FRAG * (N / 64)};
  const cuuint32_t box[4] = {DG_FRAG / 8, (cuuint32_t)(DG_BK / run), DG_WGS, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_INT64, 4, const_cast<void*>(w), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

// Y[M, N] += the product of layer `layer` of the weights behind `wts`, over
// one grid of min(SMs, units) blocks; `ws` must hold 2 x grid slots and a
// counter a tile (stream_k_workspace)
template <bool INT4, int KSUB>
int dg_launch(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
              const float* bias, int group, float* Y, int M, int N, int K, const DgWork& ws,
              cudaStream_t st) {
  if (M < 1 || N % 64 != 0 || K % DG_BK != 0 || N < 64) return (int)cudaErrorInvalidValue;
  using S = DgShape<INT4>;
  const int tiles = (M + 63) / 64 * ((N + DG_BN - 1) / DG_BN);
  const int units = tiles * (K / DG_BK), grid = min(sm_count(), units);
  if (ws.slots == nullptr || ws.n_slots < 2 * grid || ws.n_counters < tiles)
    return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // one flag for each instantiation
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(decode_gemm_kernel<INT4, KSUB>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM));
    allowed = true;
  }
  decode_gemm_kernel<INT4, KSUB><<<grid, DG_THREADS, S::SMEM, st>>>(
      act, wts, layer, scale, bias, group, Y, M, N, K, ws);
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// Y[M, N] (f32, zero on entry: the kernels accumulate) += (A @ W int8) *
// scale[N] (+ bias[N]); A the split activation behind `act` (make_act_map),
// W layer `layer` of the weights behind `wts` (make_weight_map, int8), ws
// the stream-K workspace (dg_work). Requires N % 64 == 0, K % 64 == 0.
// Defined in i8_gemm.cu.
int launch_i8_gemm(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
                   const float* bias, float* Y, int M, int N, int K, const DgWork& ws,
                   cudaStream_t stream);

// Y[M, N] (f32, zero on entry) += sum over groups of (A[:, group rows] @
// W4[group rows, :]) * scale[group, N]; W4 layer `layer` of the int4 weights
// behind `wts` (make_weight_map, int4), scale [K / group, N] (group == K: one
// scale per output column). Defined in i4_gemm.cu. Requires N % 64 == 0,
// K % 64 == 0, group % 32 == 0, K % group == 0.
int launch_i4_gemm(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
                   int group, float* Y, int M, int N, int K, const DgWork& ws,
                   cudaStream_t stream);
