// The decode GEMM core of the fused decode steps (stack_step.cu,
// bridge_step.cu, layer_step.cu), the stages that run in its kernel and the
// attention kernels that read its products: Y[M, N] = (A[M, K] @ W[K, N]) *
// scale, W int8 (i8_gemm.cu) or int4 with scales per group of rows
// (i4_gemm.cu), A f32 stored split as bf16 hi + lo halves
// (common.cuh:store_split), or A bf16 as one half (the per-layer steps,
// whose activations are bf16 by definition). The mainloop and its bound are
// described at the top of i8_gemm.cu; this header holds the kernels, their
// stages and the host's side of a launch.
//
// Y is never stored whole. The (tile, K slice) units are split stream-K, one
// equal run for each SM; every run of one tile stores its partial sums into
// a workspace slot of its own (slot tile + block: the contributors of a tile
// are consecutive blocks, so the slots of consecutive tiles never meet).
// Whatever consumes Y reads each value as the sum of its tile's slots in
// block order (product4), so the bits depend on the shapes and the SM count
// only, and no sum of partials and no zeroing of Y stands between a product
// and its consumer: either the product's own grid, resident (a cooperative
// launch, one block a SM), meets at one barrier after its stores and runs
// the stage (a residual norm, GeGLU, GELU, an add into a caller's tensor:
// DgKind), or the product ends (DG_NONE) and an attention kernel of its own
// (attn_kernel, self_attn_kernel) reads the slots.
#pragma once

#include "sm90.cuh"

namespace {

// warps 0-11: three consumer warpgroups, one 64-column tile each; warps 12
// and 13: the producers (lane 0 of one loads the activations, of the other
// the weights). Compiled for 512 threads so that ptxas keeps to the 128
// registers a thread a block of 14 warps can have (four warps share a
// sub-partition's 16,384). The consumers also run the stage.
constexpr int DG_WGS = 3;
constexpr int DG_CONSUMERS = 128 * DG_WGS;
constexpr int DG_THREADS = DG_CONSUMERS + 64;
constexpr int DG_BN = 64 * DG_WGS;   // weight columns a block covers
constexpr int DG_BK = 64;            // depth of a stage
constexpr int DG_FRAG = 2048;        // one 64-column tile's fragment run: 16 bytes x 128 lanes
// the epilogue's staging: 32 rows x DG_BN columns f32, rows padded by 4
// floats so that a warp's stores of a fragment hit 32 banks
constexpr int DG_EPI_LD = DG_BN + 4;
constexpr int DG_EPI_BYTES = 32 * DG_EPI_LD * 4;
// one slot of the stream-K workspace: a run's partial sums of one tile, 64
// rows x DG_BN columns f32 (ops/decode_kernels.py:stream_k_workspace)
constexpr int DG_SLOT = 64 * DG_BN;
// threads of a cross-attention block (rows of the vision K a pass)
constexpr int DG_XATTN_THREADS = 320;

// heads of a kv head the stack's attention stage takes (the wrapper refuses more)
constexpr int DG_GMAX = 4;

}  // namespace

// The workspace of a launch: the slots, then the grid barrier's arrival
// count and its release flag (ops/decode_kernels.py:stream_k_workspace). The
// count is zero between launches; the flag holds the epoch of the last
// launch whose barrier it released, and every launch has an epoch of its own
// (dg_next_epoch), so a waiter never mistakes an earlier launch's release.
struct DgWork {
  float* slots;
  unsigned* bar;
  int n_slots, n_counters;
  unsigned epoch;
};

// A new epoch for a launch's grid barrier: one counter for the whole
// library (i8_gemm.cu), never 0 (the flag's value in a new workspace).
unsigned dg_next_epoch();

// The workspace behind `ws` (f32: n_slots slots, then n_counters u32 words)
inline DgWork dg_work(void* ws, int n_slots, int n_counters) {
  float* slots = static_cast<float*>(ws);
  return DgWork{slots, reinterpret_cast<unsigned*>(slots + (size_t)n_slots * DG_SLOT), n_slots,
                n_counters, 0u};
}

// What a launch does with its product Y [M, N] once the grid has stored it.
// A split output [2, M, out_ld] holds the hi rows, then the lo rows.
enum DgKind {
  DG_ADD,          // y[M, N] += Y (the core alone)
  DG_STACK_ATTN,   // Y = q|k|v: RoPE, the new int8 K/V into row t, GQA over rows <= t -> out
  DG_RMS,          // x += rms(Y) (1 + w_post); out = rms(x) (1 + w_s) (or xo = bf16(x))
  DG_GEGLU,        // out = gelu_tanh(gate) * up, gate and up interleaved in runs of 32 columns
  DG_CROSS_ATTN,   // Y = q: softmax over the int8 cross K/V -> out
  DG_SELF_ATTN,    // Y = q|k|v: the new bf16 K/V into row t, attention over rows <= t -> out
  DG_LN,           // x += Y; out = LN(x) w_s + w_b (or xo = bf16(x))
  DG_GELU,         // out = gelu_erf(Y)
  DG_NONE,         // Y stays in the slots for a kernel of its own (attn_kernel, self_attn_kernel)
  DG_GEGLU_BF16,   // out = bf16(gelu_tanh(gate) * up), one half (the per-layer MLP's hidden)
  DG_RMS_BF16,     // xo = bf16(xb + rms(Y) (1 + wb)): the per-layer steps' bf16 residual
};

struct DgStage {
  int kind;
  float* y;              // DG_ADD
  bf16* out;             // the stage's split output (the next product's activation)
  int out_ld;
  float* x;              // the f32 residual [M, N] (the norm stages)
  const float* w_post;   // DG_RMS: the product's norm weight
  const float* w_s;      // the next norm's weight (DG_LN: scale); null: no next norm
  const float* w_b;      // DG_LN: the next LayerNorm's bias
  bf16* xo;              // bf16(x), written where there is no next norm (null: not written)
  const bf16* xb;        // DG_RMS_BF16: the bf16 residual [M, N] and the norm's bf16 weight
  const bf16* wb;
  float eps;
  const float* cosv;     // DG_STACK_ATTN: RoPE rows of position t [D]
  const float* sinv;
  int8_t* kc;            // int8 K/V [M, kv_heads, S, D] with scales [M, kv_heads, S]
  int8_t* vc;            // (DG_CROSS_ATTN: the cross cache, read only)
  float* ks;
  float* vs;
  bf16* sk;              // DG_SELF_ATTN: bf16 K/V [M, heads, S, D]
  bf16* sv;
  int heads, kv_heads, D, S, t;
  float attn_scale, softcap;
};

namespace {

// HALVES 2: a stage's activations are hi and lo rows (2 x 64) x DG_BK bf16,
// one box of the (K, M, 2) tensor map under the 128-byte swizzle; HALVES 1:
// 64 rows of one bf16 half, a box of the (K, M, 1) map (half the bytes, so
// the ring holds more stages)
template <bool INT4, int HALVES = 2>
struct DgShape {
  static constexpr int ACT_BYTES = HALVES * 64 * DG_BK * 2;
  static constexpr int SUB_BYTES = INT4 ? 64 * DG_BK / 2 : 64 * DG_BK;   // a 64-column tile a stage
  static constexpr int STAGE_BYTES = ACT_BYTES + DG_WGS * SUB_BYTES;
  static constexpr int STAGES = INT4 ? 9 : HALVES == 2 ? 7 : 10;
  // the ring and the epilogue's staging: the stage's shared memory afterwards
  static constexpr int REGION = STAGES * STAGE_BYTES + DG_EPI_BYTES;
  // the region (aligned to 1024 for the swizzle), the stages' full and empty
  // barriers
  static constexpr int SMEM = REGION + 1024 + STAGES * 16;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// shared memory every stage may use, whichever instantiation runs it (the
// one-half ring is the largest of the three)
static_assert(DgShape<false, 1>::REGION >= DgShape<false>::REGION, "the one-half ring");
constexpr int DG_STAGE_SMEM = DgShape<false>::REGION < DgShape<true>::REGION
                                  ? DgShape<false>::REGION
                                  : DgShape<true>::REGION;

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

// D[64, 64] += A[64, 16] . B[16, 64]: as wgmma_rs_n128, for one half's 64
// activation rows
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : TM_D8(0), TM_D8(8), TM_D8(16), TM_D8(24)
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

// ---- the stages' side: Y read from the slots ----

// A launch's split: its tiles, K slices a tile, units and blocks.
struct DgPlan {
  int n_tiles, chunks, units, grid;
};

__device__ __forceinline__ DgPlan dg_plan(int M, int N, int K) {
  const int n_tiles = (N + DG_BN - 1) / DG_BN, chunks = K / DG_BK;
  return DgPlan{n_tiles, chunks, (M + 63) / 64 * n_tiles * chunks, (int)gridDim.x};
}

// Y[m, n..n+3] (n % 4 == 0): the partial sums of its tile's contributors,
// blocks bf .. bl, added in block order (the loads of up to eight slots in
// flight at once)
__device__ __forceinline__ float4 product4(const float* slots, const DgPlan& p, int m, int n) {
  const int tile = (m >> 6) * p.n_tiles + n / DG_BN;
  const long long x0 = (long long)tile * p.chunks;
  const int bf = block_of(x0, p.units, p.grid), bl = block_of(x0 + p.chunks - 1, p.units, p.grid);
  const float* s = slots + (size_t)(tile + bf) * DG_SLOT + (m & 63) * DG_BN + n % DG_BN;
  float4 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (bf + j <= bl) v[j] = __ldcg(reinterpret_cast<const float4*>(s + (size_t)j * DG_SLOT));
  float4 acc = v[0];
#pragma unroll
  for (int j = 1; j < 8; ++j)
    if (bf + j <= bl) acc = add4(acc, v[j]);
  for (int b = bf + 8; b <= bl; ++b)
    acc = add4(acc, __ldcg(reinterpret_cast<const float4*>(s + (size_t)(b - bf) * DG_SLOT)));
  return acc;
}

// the two bf16 of a word (element 0 in the low half) as floats: a bf16's
// bits are the top half of its f32's
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Sums and maxima over a group of `threads` threads (named barrier `id`; the
// whole stage: 4, DG_CONSUMERS), in one order: each warp's shuffle tree,
// then the warps in order. `red`: 32 floats of shared memory; every thread
// of the group receives the result.
__device__ __forceinline__ float2 reduce2(float a, float b, float* red, bool is_max, int id,
                                          int threads) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % threads) >> 5;
  a = is_max ? warp_max(a) : warp_sum(a);
  b = is_max ? warp_max(b) : warp_sum(b);
  named_bar(id, threads);   // red is free
  if (lane == 0) red[warp] = a, red[16 + warp] = b;
  named_bar(id, threads);
  float ra = red[0], rb = red[16];
  for (int w = 1; w < threads / 32; ++w) {
    ra = is_max ? fmaxf(ra, red[w]) : ra + red[w];
    rb = is_max ? fmaxf(rb, red[16 + w]) : rb + red[16 + w];
  }
  return make_float2(ra, rb);
}

// 16 bytes global -> shared by cp.async (both 16-byte aligned)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Every block of the grid past this point once every block reached it: the
// slots' stores before it are seen by the loads after it. The caller has
// met its consumers at named barrier 4 after their stores. The last block to
// arrive sets the count back to zero and releases the flag with this
// launch's epoch; the others spin on the flag with acquire loads.
__device__ __forceinline__ void grid_barrier(unsigned* bar, unsigned epoch) {
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      bar[0] = 0u;   // ordered before the release
      st_release(bar + 1, epoch);
    } else {
      for (uint32_t polls = 0; ld_acquire(bar + 1) != epoch;)
        if (++polls == (1u << 28)) __trap();
    }
  }
  named_bar(4, DG_CONSUMERS);
}

__device__ __forceinline__ void store_split4(bf16* out, size_t lo_off, size_t i, float4 v) {
  bf16 hi[4], lo[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = __float2bfloat16(elem(v, e));
    lo[e] = __float2bfloat16(elem(v, e) - __bfloat162float(hi[e]));
  }
  *reinterpret_cast<uint2*>(out + i) = *reinterpret_cast<const uint2*>(hi);
  *reinterpret_cast<uint2*>(out + lo_off + i) = *reinterpret_cast<const uint2*>(lo);
}

__device__ __forceinline__ float gelu_tanh_f(float g) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.f + tanhf(k0 * (g + 0.044715f * g * g * g)));
}

__device__ __forceinline__ float gelu_erf_f(float g) {
  return 0.5f * g * (1.f + erff(g * 0.7071067811865476f));
}

// DG_ADD, DG_GEGLU, DG_GELU: elementwise over Y, four columns a thread at a time
__device__ __noinline__ void stage_elementwise(const DgStage& st, const float* slots, DgPlan p,
                                               int M, int N) {
  const int kind = st.kind;
  const int q4 = (kind == DG_GEGLU ? N / 2 : N) / 4;   // four outputs an item
  const long long total = (long long)M * q4;
  for (long long i = (long long)blockIdx.x * DG_CONSUMERS + threadIdx.x; i < total;
       i += (long long)gridDim.x * DG_CONSUMERS) {
    const int m = (int)(i / q4), f = 4 * (int)(i % q4);
    const size_t at = (size_t)m * st.out_ld + f, lo = (size_t)M * st.out_ld;
    if (kind == DG_ADD) {
      float4* y = reinterpret_cast<float4*>(st.y + (size_t)m * N + f);
      *y = add4(*y, product4(slots, p, m, f));
    } else if (kind == DG_GEGLU) {
      // run f / 32 of gate columns, then the same run of up columns
      const int col = 64 * (f / 32) + f % 32;
      const float4 g = product4(slots, p, m, col), u = product4(slots, p, m, col + 32);
      store_split4(st.out, lo, at,
                   make_float4(gelu_tanh_f(g.x) * u.x, gelu_tanh_f(g.y) * u.y,
                               gelu_tanh_f(g.z) * u.z, gelu_tanh_f(g.w) * u.w));
    } else {
      const float4 g = product4(slots, p, m, f);
      store_split4(st.out, lo, at,
                   make_float4(gelu_erf_f(g.x), gelu_erf_f(g.y), gelu_erf_f(g.z),
                               gelu_erf_f(g.w)));
    }
  }
}

// DG_RMS, DG_LN: a row of the residual a block, the row of Y staged in
// shared memory. Before the grid barrier the block copies its first row of x
// and the norms' weights into shared memory (cp.async, where 5 N + 32 floats
// fit), so that after it only the product's slots are read from the L2.
__device__ __noinline__ void stage_norm(const DgStage& st, const float* slots, DgPlan p, int M,
                                        int N, float* sm, unsigned* bar, unsigned epoch) {
  const bool rms = st.kind == DG_RMS;
  const bool pre = (size_t)(5 * N + 32) * 4 <= (size_t)DG_STAGE_SMEM;
  float* row = sm;
  float* xs = sm + N;
  float* red = sm + (pre ? 5 * N : N);
  const float* wp = pre ? sm + 2 * N : st.w_post;   // RMS: the product's norm weight
  const float* w1 = pre ? sm + 3 * N : st.w_s;      // the next norm's weight or scale
  const float* w2 = pre ? sm + 4 * N : st.w_b;      // LN: the next norm's bias
  const int m0 = blockIdx.x;
  if (pre && m0 < M) {
    for (int n = 4 * threadIdx.x; n < N; n += 4 * DG_CONSUMERS) {
      cp_async16(xs + n, st.x + (size_t)m0 * N + n);
      if (rms) cp_async16(sm + 2 * N + n, st.w_post + n);
      if (st.w_s != nullptr) cp_async16(sm + 3 * N + n, st.w_s + n);
      if (!rms && st.w_s != nullptr) cp_async16(sm + 4 * N + n, st.w_b + n);
    }
    cp_async_commit();
  }
  grid_barrier(bar, epoch);
  cp_async_wait<0>();   // a thread reads back only what it copied
  for (int m = m0; m < M; m += gridDim.x) {
    float* x = st.x + (size_t)m * N;
    const float* xr = pre && m == m0 ? xs : x;
    float ss = 0.f;
    for (int n = 4 * threadIdx.x; n < N; n += 4 * DG_CONSUMERS) {
      const float4 y = product4(slots, p, m, n);
      *reinterpret_cast<float4*>(row + n) = y;
      ss += y.x * y.x + y.y * y.y + y.z * y.z + y.w * y.w;
    }
    const float r =
        rms ? rsqrtf(reduce2(ss, 0.f, red, false, 4, DG_CONSUMERS).x / N + st.eps) : 0.f;
    float s1 = 0.f;
    for (int n = 4 * threadIdx.x; n < N; n += 4 * DG_CONSUMERS) {
      const float4 y = *reinterpret_cast<const float4*>(row + n);
      float4 v = *reinterpret_cast<const float4*>(xr + n);
      if (rms) {
        v.x += y.x * r * (1.f + wp[n]);
        v.y += y.y * r * (1.f + wp[n + 1]);
        v.z += y.z * r * (1.f + wp[n + 2]);
        v.w += y.w * r * (1.f + wp[n + 3]);
        s1 += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
      } else {
        v = add4(v, y);
        s1 += v.x + v.y + v.z + v.w;
      }
      *reinterpret_cast<float4*>(row + n) = v;
      *reinterpret_cast<float4*>(x + n) = v;
      if (st.xo != nullptr) {
        const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<__nv_bfloat162*>(st.xo + (size_t)m * N + n) = a;
        *reinterpret_cast<__nv_bfloat162*>(st.xo + (size_t)m * N + n + 2) = b;
      }
    }
    if (st.w_s != nullptr) {
      const size_t lo = (size_t)M * st.out_ld, at = (size_t)m * st.out_ld;
      if (rms) {
        const float r2 = rsqrtf(reduce2(s1, 0.f, red, false, 4, DG_CONSUMERS).x / N + st.eps);
        for (int n = 4 * threadIdx.x; n < N; n += 4 * DG_CONSUMERS) {
          const float4 v = *reinterpret_cast<const float4*>(row + n);
          store_split4(st.out, lo, at + n,
                       make_float4(v.x * r2 * (1.f + w1[n]), v.y * r2 * (1.f + w1[n + 1]),
                                   v.z * r2 * (1.f + w1[n + 2]), v.w * r2 * (1.f + w1[n + 3])));
        }
      } else {
        const float mu = reduce2(s1, 0.f, red, false, 4, DG_CONSUMERS).x / N;
        float sd = 0.f;
        for (int n = 4 * threadIdx.x; n < N; n += 4 * DG_CONSUMERS) {
          const float4 v = *reinterpret_cast<const float4*>(row + n);
          sd += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu) + (v.z - mu) * (v.z - mu) +
                (v.w - mu) * (v.w - mu);
        }
        const float r2 = rsqrtf(reduce2(sd, 0.f, red, false, 4, DG_CONSUMERS).x / N + st.eps);
        for (int n = 4 * threadIdx.x; n < N; n += 4 * DG_CONSUMERS) {
          const float4 v = *reinterpret_cast<const float4*>(row + n);
          store_split4(st.out, lo, at + n,
                       make_float4((v.x - mu) * r2 * w1[n] + w2[n],
                                   (v.y - mu) * r2 * w1[n + 1] + w2[n + 1],
                                   (v.z - mu) * r2 * w1[n + 2] + w2[n + 2],
                                   (v.w - mu) * r2 * w1[n + 3] + w2[n + 3]));
        }
      }
    }
    named_bar(4, DG_CONSUMERS);   // the row's staging is read before the next row's
  }
}

// DG_GEGLU_BF16 (the per-layer MLP, layer_step.cu): DG_GEGLU into one bf16
// half, four outputs a thread at a time (a function of its own, so that the
// stack and bridge steps' elementwise stages keep their code)
__device__ __noinline__ void stage_geglu_bf16(const DgStage& st, const float* slots, DgPlan p,
                                              int M, int N) {
  const int q4 = N / 8;
  const long long total = (long long)M * q4;
  for (long long i = (long long)blockIdx.x * DG_CONSUMERS + threadIdx.x; i < total;
       i += (long long)gridDim.x * DG_CONSUMERS) {
    const int m = (int)(i / q4), f = 4 * (int)(i % q4);
    const int col = 64 * (f / 32) + f % 32;   // run f / 32 of gate columns, then of up columns
    const float4 g = product4(slots, p, m, col), u = product4(slots, p, m, col + 32);
    *reinterpret_cast<uint2*>(st.out + (size_t)m * st.out_ld + f) =
        make_uint2(pack_bf16(gelu_tanh_f(g.x) * u.x, gelu_tanh_f(g.y) * u.y),
                   pack_bf16(gelu_tanh_f(g.z) * u.z, gelu_tanh_f(g.w) * u.w));
  }
}

// DG_RMS_BF16 (the per-layer steps, layer_step.cu): xo = bf16(xb + rms(Y) (1
// + wb)), the residual, the norm's weight and the result bf16, a row a block
// as in stage_norm. Before the grid barrier the block copies its first row
// of xb and the weight into shared memory (cp.async); each thread then reads
// back only the 16-byte runs it copied, eight columns at a time.
__device__ __noinline__ void stage_resid_bf16(const DgStage& st, const float* slots, DgPlan p,
                                              int M, int N, float* sm, unsigned* bar,
                                              unsigned epoch) {
  float* row = sm;                                      // N: the row of Y
  bf16* xs = reinterpret_cast<bf16*>(sm + N);           // N bf16: the first row of xb
  bf16* ws = xs + N;                                    // N bf16: the weight
  float* red = sm + 2 * N;                              // 32
  const int m0 = blockIdx.x;
  if (m0 < M) {
    for (int n = 8 * threadIdx.x; n < N; n += 8 * DG_CONSUMERS) {
      cp_async16(xs + n, st.xb + (size_t)m0 * N + n);
      cp_async16(ws + n, st.wb + n);
    }
    cp_async_commit();
  }
  grid_barrier(bar, epoch);
  cp_async_wait<0>();
  for (int m = m0; m < M; m += gridDim.x) {
    const bf16* xr = m == m0 ? xs : st.xb + (size_t)m * N;
    float ss = 0.f;
    for (int n = 8 * threadIdx.x; n < N; n += 8 * DG_CONSUMERS) {
      const float4 a = product4(slots, p, m, n), b = product4(slots, p, m, n + 4);
      *reinterpret_cast<float4*>(row + n) = a;
      *reinterpret_cast<float4*>(row + n + 4) = b;
      ss += a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w + b.x * b.x + b.y * b.y + b.z * b.z +
            b.w * b.w;
    }
    const float r = rsqrtf(reduce2(ss, 0.f, red, false, 4, DG_CONSUMERS).x / N + st.eps);
    for (int n = 8 * threadIdx.x; n < N; n += 8 * DG_CONSUMERS) {
      const uint4 xw = *reinterpret_cast<const uint4*>(xr + n);
      const uint4 ww = *reinterpret_cast<const uint4*>(ws + n);
      uint32_t o[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t xq = word_of(xw, q), wq = word_of(ww, q);
        const float y0 = row[n + 2 * q], y1 = row[n + 2 * q + 1];
        o[q] = pack_bf16(bf16_lo(xq) + y0 * r * (1.f + bf16_lo(wq)),
                         bf16_hi(xq) + y1 * r * (1.f + bf16_hi(wq)));
      }
      *reinterpret_cast<uint4*>(st.xo + (size_t)m * N + n) = make_uint4(o[0], o[1], o[2], o[3]);
    }
    named_bar(4, DG_CONSUMERS);   // the row's staging and red are read before the next row's
  }
}

// 16 int8 values of w as floats, without I2F: byte x ^ 0x80 becomes the low
// mantissa of the f32 2^23 + (x + 128), and one add removes the offset
// (exact for every byte; sm90.cuh:widen4 does the same for bf16)
__device__ __forceinline__ void unpack16(uint4 w, float (&v)[16]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t x = word_of(w, q) ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[4 * q + i] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | i)) - 8388736.f;
  }
}

// Shared memory (floats) of stack_attn_kernel: q|k|v from the slots (G + 2)
// D, q and k after RoPE (G + 1) D, the new row's codes (D / 2: 2 D bytes),
// the rows' K and V scales 2 n, logits G n (n = t + 1), the P.V partials of
// the row groups (256 / (D / 16) groups x G D = 4096 G), the reductions 32
__host__ __device__ inline int stack_attn_floats(int G, int D, int n) {
  return (G + 2) * D + (G + 1) * D + D / 2 + 2 * n + G * n + 4096 * G + 32;
}

// The stack's attention (DG_STACK_ATTN), a kernel of its own after the
// q|k|v product, which left its partial sums in the slots (DG_NONE): one
// (row, kv head) item a block of 256 threads, all G query heads of the kv
// head in one pass over its cache rows. q, k and v are read as their slots
// added in block order; RoPE; the new K/V row's per-vector int8 (kv_scale /
// kv_code), written into cache row t and attended through its codes, as a
// cache row. Logits: a row of D int8 a D / 16 lanes, 16 bytes a lane, the
// lane's 16 dims of each head's q in registers, the rows' dot products
// summed over the row's lanes by shuffles (one order); each warp's rows
// loaded two iterations at a time. P.V: a thread a (row group, 16-byte
// column segment), 16 bytes of V a row, the row groups' partials added in
// order through shared memory. GM: the most heads a kv head it takes.
template <int GM>
__global__ void __launch_bounds__(256)
stack_attn_kernel(const __grid_constant__ DgStage st, const float* __restrict__ slots,
                  const DgPlan p, int M) {
  extern __shared__ __align__(16) float sa_buf[];
  const int KH = st.kv_heads, G = st.heads / KH, D = st.D, S = st.S, t = st.t, n = t + 1;
  const int QHD = st.heads * D, KHD = KH * D, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int it = blockIdx.x, b = it / KH, kh = it % KH;
  const size_t slab = (size_t)it * S;   // item = b * KH + kh
  float* raw = sa_buf;                   // (G + 2) D
  float* qr = raw + (G + 2) * D;         // (G + 1) D
  int8_t* kn = reinterpret_cast<int8_t*>(qr + (G + 1) * D);   // D codes, then D
  int8_t* vn = kn + D;
  float* kss = qr + (G + 1) * D + D / 2;   // n, then vss n
  float* vss = kss + n;
  float* lg = vss + n;                     // G n
  float* red = lg + G * n;                 // 4096 G
  float* rd = red + 4096 * G;              // 32
  // Everything the item reads from device memory is asked for first, so that
  // the latencies overlap: the logits' first pass of cache rows (lane `seg`
  // of each group of spw lanes holds segment seg of a row), P.V's first two
  // rows, the rows' scales, RoPE's rows, and q (G heads), k, v of the item
  // from the slots.
  const int spw = D / 16, rpw = 32 / spw, seg = lane % spw, step = 8 * rpw;
  const int nseg = D / 16, RG = 256 / nseg, rg = tid / nseg, sg = tid % nseg;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  auto k_bytes = [&](int j) {   // the row's segment from the cache (rows < t)
    return __ldg(reinterpret_cast<const uint4*>(st.kc + (slab + j) * D + 16 * seg));
  };
  auto v_bytes = [&](int j) {
    return __ldg(reinterpret_cast<const uint4*>(st.vc + (slab + j) * D + 16 * sg));
  };
  const int jf = warp * rpw + lane / spw;
  const uint4 kw0 = jf < t ? k_bytes(jf) : zero, kw1 = jf + step < t ? k_bytes(jf + step) : zero;
  const uint4 vw0 = rg < t ? v_bytes(rg) : zero, vw1 = rg + RG < t ? v_bytes(rg + RG) : zero;
  const float k0 = tid < t ? st.ks[slab + tid] : 0.f, v0 = tid < t ? st.vs[slab + tid] : 0.f;
  const float c0 = tid < D ? st.cosv[tid] : 0.f, s0 = tid < D ? st.sinv[tid] : 0.f;
  const float c1 = tid + 256 < D ? st.cosv[tid + 256] : 0.f;
  const float s1 = tid + 256 < D ? st.sinv[tid + 256] : 0.f;
  for (int e = 4 * tid; e < (G + 2) * D; e += 4 * 256) {
    const int head = e / D, d = e % D;
    const int col = head < G ? (kh * G + head) * D + d
                             : (head == G ? QHD + kh * D + d : QHD + KHD + kh * D + d);
    *reinterpret_cast<float4*>(raw + e) = product4(slots, p, b, col);
  }
  float* cs = red;   // RoPE's rows, in the P.V partials' room until P.V
  if (tid < t) kss[tid] = k0, vss[tid] = v0;
  for (int j = tid + 256; j < t; j += 256) kss[j] = st.ks[slab + j], vss[j] = st.vs[slab + j];
  if (tid < D) cs[tid] = c0, cs[D + tid] = s0;
  if (tid + 256 < D) cs[tid + 256] = c1, cs[D + tid + 256] = s1;
  __syncthreads();
  // RoPE of the q heads and k; the new K/V row's int8, into cache row t
  const int half = D / 2;
  for (int e = tid; e < (G + 1) * D; e += 256) {
    const int h0 = e / D * D, d = e % D, dp = d < half ? d + half : d - half;
    const float sign = d < half ? -1.f : 1.f;
    qr[e] = raw[h0 + d] * cs[d] + sign * raw[h0 + dp] * cs[D + d];
  }
  __syncthreads();
  float ka = 0.f, va = 0.f;
  for (int d = tid; d < D; d += 256) {
    ka = fmaxf(ka, fabsf(qr[G * D + d]));
    va = fmaxf(va, fabsf(raw[(G + 1) * D + d]));
  }
  const float2 mx = reduce2(ka, va, rd, true, 0, 256);
  const float ksc = kv_scale(mx.x), vsc = kv_scale(mx.y);
  for (int d = tid; d < D; d += 256) {
    kn[d] = kv_code(qr[G * D + d], ksc);
    vn[d] = kv_code(raw[(G + 1) * D + d], vsc);
    st.kc[(slab + t) * D + d] = kn[d];
    st.vc[(slab + t) * D + d] = vn[d];
  }
  if (tid == 0) {
    st.ks[slab + t] = ksc;
    st.vs[slab + t] = vsc;
    kss[t] = ksc;
    vss[t] = vsc;
  }
  __syncthreads();

  // logits: the lane's 16 dims of each head's q in registers
  float q[GM][16];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) q[g][e] = g < G ? qr[g * D + 16 * seg + e] : 0.f;
  auto logit = [&](int j, uint4 w) {
    float v[16];
    unpack16(w, v);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc += q[g][e] * v[e];
      for (int o = spw / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (seg == 0 && j < n)
        lg[g * n + j] = soft_cap(acc * kss[j] * st.attn_scale, st.softcap);
    }
  };
  const uint4 knew = *reinterpret_cast<const uint4*>(kn + 16 * seg);   // the new row's segment
  for (int jb = warp * rpw; jb < n; jb += 2 * step) {   // the same trips for a warp's lanes
    const int j0 = jb + lane / spw, j1 = j0 + step;
    uint4 w0 = kw0, w1 = kw1;
    if (jb != warp * rpw) {
      w0 = j0 < t ? k_bytes(j0) : zero;
      w1 = j1 < t ? k_bytes(j1) : zero;
    }
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {   // one copy of the code: rows past n shuffle, unwritten
      const int j = r == 0 ? j0 : j1;
      logit(j, j == t ? knew : r == 0 ? w0 : w1);
    }
  }
  __syncthreads();
  // softmax of head g by warp g, times each row's V scale
  for (int g = warp; g < G; g += 8) {
    float* l = lg + g * n;
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, l[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(l[j] - m);
      l[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < n; j += 32) l[j] = l[j] / sum * vss[j];
  }
  __syncthreads();
  // P.V: thread (row group rg, segment sg) over rows rg, rg + RG, ..., two at a time
  float acc[GM][16];
#pragma unroll
  for (int g = 0; g < GM; ++g)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[g][e] = 0.f;
  auto v_row = [&](int j, uint4 w) {
    float v[16];
    unpack16(w, v);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float pj = lg[g * n + j];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[g][e] += pj * v[e];
    }
  };
  if (rg < RG) {
    const uint4 vnew = *reinterpret_cast<const uint4*>(vn + 16 * sg);
    auto v_at = [&](int j) { return j == t ? vnew : v_bytes(j); };
    uint4 w0 = vw0, w1 = vw1;   // rows rg and rg + RG, asked for first
#pragma unroll 1
    for (int j = rg; j < n; j += 2 * RG) {   // one copy of the code, two rows' loads in flight
      if (j != rg) {
        w0 = v_at(j);
        w1 = j + RG < n ? v_at(j + RG) : zero;
      } else {
        w0 = j == t ? vnew : w0;
        w1 = j + RG == t ? vnew : w1;
      }
#pragma unroll 1
      for (int r = 0; r < 2; ++r)
        if (j + r * RG < n) v_row(j + r * RG, r == 0 ? w0 : w1);
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
#pragma unroll
      for (int e = 0; e < 16; ++e) red[(rg * G + g) * D + 16 * sg + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int o = tid; o < G * D; o += 256) {
    float v = 0.f;
    for (int r = 0; r < RG; ++r) v += red[r * G * D + o];
    const int g = o / D, d = o % D;
    store_split(st.out, (size_t)M * st.out_ld, (size_t)b * st.out_ld + (kh * G + g) * D + d, v);
  }
  __syncthreads();
}

// Shared memory (floats) of cross_attn_kernel: q D, the rows' K and V scales
// 2 S, logits S, the P.V partials of the row groups (at most 5120), the
// reductions 32
__host__ __device__ inline int cross_attn_floats(int D, int S) {
  return D + 3 * S + (DG_XATTN_THREADS / (D / 16)) * D + 32;
}

// The bridge's cross attention (DG_CROSS_ATTN), a kernel of its own after
// the q product (left in the slots): one (row, head) item a block of
// DG_XATTN_THREADS threads over the int8 vision K/V slab with per-row
// scales. q is read as its slots added in block order. Logits: a row a
// thread, its 16-byte segments loaded six at a time, q from shared memory
// (every thread at the same segment: a broadcast). P.V: a thread a (row
// group, 16-byte column segment), 16 bytes of V a row, four rows' loads in
// flight, the row groups' partials added in order through shared memory.
__global__ void __launch_bounds__(DG_XATTN_THREADS)
cross_attn_kernel(const __grid_constant__ DgStage st, const float* __restrict__ slots,
                  const DgPlan p, int M) {
  extern __shared__ __align__(16) float xa_buf[];
  const int H = st.heads, D = st.D, S = st.S, T = DG_XATTN_THREADS, tid = threadIdx.x;
  const int it = blockIdx.x, b = it / H, h = it % H, nseg = D / 16;
  const size_t slab = (size_t)it * S;   // item = b * H + h
  float* q = xa_buf;                    // D
  float* kss = q + D;                   // S, then vss S
  float* vss = kss + S;
  float* lg = vss + S;                  // S
  float* red = lg + S;                  // (T / nseg) D
  float* rd = red + (T / nseg) * D;     // 32
  for (int j = tid; j < S; j += T) kss[j] = st.ks[slab + j], vss[j] = st.vs[slab + j];
  for (int e = 4 * tid; e < D; e += 4 * T)
    *reinterpret_cast<float4*>(q + e) = product4(slots, p, b, h * D + e);
  __syncthreads();
  // logits: a row a thread
  float mloc = -INFINITY;
  for (int j = tid; j < S; j += T) {
    const uint4* kr = reinterpret_cast<const uint4*>(st.kc + (slab + j) * D);
    float acc = 0.f;
    for (int s0 = 0; s0 < nseg; s0 += 6) {
      uint4 w[6];
#pragma unroll
      for (int u = 0; u < 6; ++u)
        if (s0 + u < nseg) w[u] = __ldg(kr + s0 + u);
#pragma unroll
      for (int u = 0; u < 6; ++u)
        if (s0 + u < nseg) {
          float v[16];
          unpack16(w[u], v);
#pragma unroll
          for (int e = 0; e < 16; ++e) acc += q[16 * (s0 + u) + e] * v[e];
        }
    }
    lg[j] = acc * st.attn_scale * kss[j];
    mloc = fmaxf(mloc, lg[j]);
  }
  const float m = reduce2(mloc, 0.f, rd, true, 0, T).x;
  float sloc = 0.f;
  for (int j = tid; j < S; j += T) {
    const float e = expf(lg[j] - m);
    lg[j] = e;
    sloc += e;
  }
  const float sum = reduce2(sloc, 0.f, rd, false, 0, T).x;   // its barriers publish lg
  for (int j = tid; j < S; j += T) lg[j] = lg[j] / sum * vss[j];
  __syncthreads();
  // P.V
  const int RG = T / nseg, rg = tid / nseg, sg = tid % nseg;
  if (rg < RG) {
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    const uint4* vcol = reinterpret_cast<const uint4*>(st.vc + slab * D) + sg;
    for (int j0 = rg; j0 < S; j0 += 4 * RG) {
      uint4 w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u * RG < S) w[u] = __ldg(vcol + (size_t)(j0 + u * RG) * nseg);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u * RG < S) {
          float v[16];
          unpack16(w[u], v);
          const float pj = lg[j0 + u * RG];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] += pj * v[e];
        }
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) red[rg * D + 16 * sg + e] = acc[e];
  }
  __syncthreads();
  for (int d = tid; d < D; d += T) {
    float v = 0.f;
    for (int r = 0; r < RG; ++r) v += red[r * D + d];
    store_split(st.out, (size_t)M * st.out_ld, (size_t)b * st.out_ld + h * D + d, v);
  }
}

// DPL bf16 values at p (DPL * 2 bytes, aligned to that) as floats
template <int DPL>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&v)[DPL]) {
  if constexpr (DPL == 1) {
    v[0] = __bfloat162float(*p);
  } else if constexpr (DPL == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    v[0] = bf16_lo(w), v[1] = bf16_hi(w);
  } else {
#pragma unroll
    for (int c = 0; c < DPL / 4; ++c) {
      const uint2 w = *reinterpret_cast<const uint2*>(p + 4 * c);
      v[4 * c] = bf16_lo(w.x), v[4 * c + 1] = bf16_hi(w.x);
      v[4 * c + 2] = bf16_lo(w.y), v[4 * c + 3] = bf16_hi(w.y);
    }
  }
}

// The bridge's self attention (DG_SELF_ATTN), a kernel of its own after
// the q|k|v product (left in the slots): one (row, head) item a warp, lane l
// holding dims DPL l .. DPL l + DPL - 1 (D = 32 DPL). The logits of rows < t
// lane-parallel (a row a lane, q from shared memory), the new row's by a
// shuffle sum; P.V a row at a time with each lane's dims, the rows' loads
// unrolled. Shared memory: each warp's q and t + 1 logits.
template <int DPL>
__global__ void __launch_bounds__(128)
self_attn_kernel(const __grid_constant__ DgStage st, const float* __restrict__ slots,
                 const DgPlan p, int M) {
  extern __shared__ float sa_smem[];
  float* sm = sa_smem;
  constexpr int D = 32 * DPL;
  constexpr int KU = D / 8 <= 16 ? D / 8 : 8;   // a row's 16-byte loads in flight at once
  const int H = st.heads, S = st.S, t = st.t, ld = H * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, d0 = DPL * lane;
  float* qw = sm + (size_t)warp * (D + t + 1);
  float* lw = qw + D;
  const int nw = blockDim.x / 32;
  for (int it = (int)blockIdx.x * nw + warp; it < M * H; it += (int)gridDim.x * nw) {
    const int b = it / H, h = it % H;
    const size_t slab = (size_t)it * S;   // it = b * H + h
    float q[DPL], k[DPL], v[DPL];
#pragma unroll
    for (int e = 0; e < DPL; e += (DPL >= 4 ? 4 : DPL)) {
      if constexpr (DPL >= 4) {
        const float4 a = product4(slots, p, b, h * D + d0 + e);
        const float4 c = product4(slots, p, b, ld + h * D + d0 + e);
        const float4 f = product4(slots, p, b, 2 * ld + h * D + d0 + e);
#pragma unroll
        for (int u = 0; u < 4; ++u) q[e + u] = elem(a, u), k[e + u] = elem(c, u), v[e + u] = elem(f, u);
      } else {
        // four lanes share a float4; each keeps its DPL values
        const int base = (d0 / 4) * 4, off = d0 % 4;
        const float4 a = product4(slots, p, b, h * D + base);
        const float4 c = product4(slots, p, b, ld + h * D + base);
        const float4 f = product4(slots, p, b, 2 * ld + h * D + base);
#pragma unroll
        for (int u = 0; u < DPL; ++u)
          q[u] = elem(a, off + u), k[u] = elem(c, off + u), v[u] = elem(f, off + u);
      }
    }
    // the new row, rounded to the cache's bf16, into row t
    float dt = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const bf16 kb = __float2bfloat16(k[e]), vb = __float2bfloat16(v[e]);
      st.sk[(slab + t) * D + d0 + e] = kb;
      st.sv[(slab + t) * D + d0 + e] = vb;
      k[e] = __bfloat162float(kb);
      v[e] = __bfloat162float(vb);
      dt += q[e] * k[e];
      qw[d0 + e] = q[e];
    }
    dt = warp_sum(dt);
    __syncwarp();
    for (int j = lane; j < t; j += 32) {   // rows < t: a row a lane
      const bf16* kr = st.sk + (slab + j) * D;
      float acc = 0.f;
#pragma unroll(KU)
      for (int c = 0; c < D / 8; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(kr + 8 * c);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const uint32_t x = word_of(w, u);
          acc += qw[8 * c + 2 * u] * bf16_lo(x) + qw[8 * c + 2 * u + 1] * bf16_hi(x);
        }
      }
      lw[j] = acc * st.attn_scale;
    }
    if (lane == 0) lw[t] = dt * st.attn_scale;
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j <= t; j += 32) mx = fmaxf(mx, lw[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j <= t; j += 32) {
      const float e = expf(lw[j] - mx);
      lw[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();
    float acc[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
#pragma unroll 8
    for (int j = 0; j < t; ++j) {
      float vr[DPL];
      load_bf16<DPL>(st.sv + (slab + j) * D + d0, vr);
      const float pj = lw[j] / sum;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] += pj * vr[e];
    }
    const float pt = lw[t] / sum;
#pragma unroll
    for (int e = 0; e < DPL; ++e)
      store_split(st.out, (size_t)M * st.out_ld, (size_t)b * st.out_ld + h * D + d0 + e,
                  acc[e] + pt * v[e]);
    __syncwarp();   // qw and lw are read before the next item writes them
  }
}

// After a block's last unit: the stage, behind the grid barrier.
__device__ __noinline__ void dg_finish(const DgStage& st, DgWork ws, int M, int N, int K,
                                       unsigned char* sm) {
  named_bar(4, DG_CONSUMERS);   // every consumer is done with the ring
  const DgPlan p = dg_plan(M, N, K);
  if (st.kind == DG_RMS || st.kind == DG_LN) {   // these prefetch before the barrier
    stage_norm(st, ws.slots, p, M, N, reinterpret_cast<float*>(sm), ws.bar, ws.epoch);
    return;
  }
  if (st.kind == DG_RMS_BF16) {
    stage_resid_bf16(st, ws.slots, p, M, N, reinterpret_cast<float*>(sm), ws.bar, ws.epoch);
    return;
  }
  grid_barrier(ws.bar, ws.epoch);
  if (st.kind == DG_GEGLU_BF16) {
    stage_geglu_bf16(st, ws.slots, p, M, N);
    return;
  }
  stage_elementwise(st, ws.slots, p, M, N);
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
// of the next. Each run of one tile ends in an epilogue that stores its
// partial sums into the run's slot (tile + block). After its last unit the
// block runs the stage (dg_finish). KSUB: k16 steps between two waits on the
// tensor cores (4: a stage; 2: int4 scale groups that end inside a stage).
// HALVES: the activations' bf16 halves (2: hi + lo, 128 B-tile rows, an
// m64n128k16 a k16 step; 1: one half, 64 rows, an m64n64k16: half the
// tensor work and half the activation bytes).
template <bool INT4, int KSUB, int HALVES>
__global__ void __launch_bounds__(512, 1)
decode_gemm_kernel(const __grid_constant__ CUtensorMap act, const __grid_constant__ CUtensorMap wts,
                   int layer, const float* __restrict__ scale, const float* __restrict__ bias,
                   int group, int M, int N, int K, const DgWork ws,
                   const __grid_constant__ DgStage stage) {
  using S = DgShape<INT4, HALVES>;
  constexpr int NACC = 32 * HALVES;   // accumulators a thread
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

  if (threadIdx.x >= DG_CONSUMERS) {
    // ---- producers: unit i into stage i % STAGES once its last use is done:
    // the activations' box, and the weights' box of the DG_WGS 64-column
    // fragment runs of the tile (zeros past N) ----
    const int role = threadIdx.x - DG_CONSUMERS;   // 0: activations, 32: weights
    if (role % 32 == 0) {
      const CUtensorMap* map = role == 0 ? &act : &wts;
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
      // the weights are read once: they must not push the activations and
      // the slots, which the stage reads, out of the L2
      const uint64_t pol = l2_evict_first();
      int c = u0 % chunks, nt = u0 / chunks % n_tiles, mb = u0 / chunks / n_tiles;
      for (int i = 0, s = 0; i < n_units; ++i) {
        if (i >= S::STAGES) mbar_wait(empty + 8 * s, (i / S::STAGES - 1) & 1);
        const uint32_t st = ring + s * S::STAGE_BYTES, bar = full + 8 * s;
        if (role == 0) {
          mbar_expect_tx(bar, S::ACT_BYTES);
          tma_load_3d(st, &act, c * DG_BK, mb * 64, 0, bar);
        } else {
          mbar_expect_tx(bar, DG_WGS * S::SUB_BYTES);
          tma_load_4d_hint(st + S::ACT_BYTES, &wts, 0, c * DG_BK / (INT4 ? 64 : 32),
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
  // j < 8 and of lo for j >= 8 (one half: j < 8 only)
  float acc[NACC];
#pragma unroll
  for (int x = 0; x < NACC; ++x) acc[x] = 0.f;
  // per row of the accumulator (h): int8 the column's scale and bias; int4
  // the scale of the current and the next group
  float sc[2], nx[2], bi[2];
  const uint32_t wlane = S::ACT_BYTES + wg * S::SUB_BYTES + warp * 512 + lane * 16;
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
      for (int kk = part * KSUB; kk < (part + 1) * KSUB; ++kk) {
        if constexpr (HALVES == 2) {
          wgmma_rs_n128(acc, a[kk], smem_desc(st + kk * 32, 16, 1024));
        } else {
          wgmma_rs_n64(acc, a[kk], smem_desc(st + kk * 32, 16, 1024));
        }
      }
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
            for (int j = 0; j < NACC / 4; ++j) {
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
      // (hi + lo) * scale (+ bias) (one half: the half * scale), staged in
      // shared memory as rows of Y, half the rows at a time, then, a warp a
      // row segment of 256 bytes, stored into the run's slot
      const int m0 = mb * 64;
      const int tw = threadIdx.x % 128, cc = 64 * wg + 4 * (tw % 16);   // 4 columns of the block
      float* dst = ws.slots + (size_t)(mb * n_tiles + nt + blockIdx.x) * DG_SLOT;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cb = 64 * wg + 16 * warp + g + 8 * h;   // column in the block
#pragma unroll
          for (int j = 4 * half; j < 4 * half + 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float v = acc[4 * j + 2 * h + e];
              if constexpr (HALVES == 2) v += acc[4 * j + 32 + 2 * h + e];
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                               epi + ((8 * j + 2 * t + e - 32 * half) * DG_EPI_LD + cb) * 4),
                           "f"(v * sc[h] + bi[h])
                           : "memory");
            }
        }
        named_bar(1 + wg, 128);
        if (n0 + cc < N)
          for (int r = tw / 16; r < 32 && m0 + 32 * half + r < M; r += 8) {
            const uint4 u = ld_shared_v4(epi + (r * DG_EPI_LD + cc) * 4);
            __stcg(reinterpret_cast<float4*>(dst + (size_t)(32 * half + r) * DG_BN + cc),
                   make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                               __uint_as_float(u.z), __uint_as_float(u.w)));
          }
        named_bar(1 + wg, 128);   // the staging is read before it is written again
      }
#pragma unroll
      for (int x = 0; x < NACC; ++x) acc[x] = 0.f;
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
  if (stage.kind != DG_NONE) dg_finish(stage, ws, M, N, K, dg_smem + (ring - smem_u32(dg_smem)));
}

// ---- host ----

// A split activation [2, M, lda] bf16 (hi rows, then lo rows) as the GEMMs'
// B operand: a (K, M, 2) tensor map in boxes of 64 x 64 x 2, rows past M
// read as zeros; halves 1: one bf16 [M, lda], a (K, M, 1) map in boxes of 64
// x 64 x 1
inline int make_act_map(CUtensorMap* map, const bf16* a, int lda, int M, int K, int halves = 2) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)M, (cuuint64_t)halves};
  const cuuint64_t strides[2] = {(cuuint64_t)lda * 2, (cuuint64_t)M * lda * 2};
  const cuuint32_t box[3] = {DG_BK, 64, (cuuint32_t)halves};
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

// units a block takes at least in the one-half instantiation: the per-layer o
// product (384 units at Gemma-2-2B) then runs on 96 blocks, whose stage adds
// fewer slots a value (measured faster than 132 blocks or 48; PERF.md)
constexpr int DG1_MIN_UNITS = 4;

// The grid of a product: one block a SM, or a block a unit (at least
// min_units units a block)
inline int dg_grid(int M, int N, int K, int min_units = 1) {
  const int units = (M + 63) / 64 * ((N + DG_BN - 1) / DG_BN) * (K / DG_BK);
  return min(sm_count(), (units + min_units - 1) / min_units);
}

// A product's split, on the host: what the kernels after it read its slots by
inline DgPlan dg_plan_host(int M, int N, int K, int min_units = 1) {
  const int n_tiles = (N + DG_BN - 1) / DG_BN, chunks = K / DG_BK;
  return DgPlan{n_tiles, chunks, (M + 63) / 64 * n_tiles * chunks, dg_grid(M, N, K, min_units)};
}

// stack_attn_kernel takes G <= DG_GMAX query heads a kv head of D = 32, 64,
// 128, 256 or 512 dims, at position t (its shared memory fits); cross_attn_kernel
// heads of D = 32 k dims over S rows
inline bool stack_attn_fits(int G, int D, int t) {
  return G >= 1 && G <= DG_GMAX && (D == 32 || D == 64 || D == 128 || D == 256 || D == 512) &&
         (size_t)stack_attn_floats(G, D, t + 1) * 4 <= (size_t)DG_STAGE_SMEM;
}
inline bool cross_attn_fits(int D, int S) {
  return D % 32 == 0 && D / 16 <= DG_XATTN_THREADS &&
         (size_t)cross_attn_floats(D, S) * 4 <= (size_t)DG_STAGE_SMEM;
}

// self_attn_kernel takes heads of 32, 64, 128 or 256 dims, four warps' q and
// t + 1 logits in shared memory
inline bool self_attn_fits(int D, int t) {
  return (D == 32 || D == 64 || D == 128 || D == 256) &&
         (size_t)4 * (D + t + 1) * 4 <= (size_t)DG_STAGE_SMEM;
}

// Dynamic shared memory above 48 KB for `kernel`, once
template <typename Kernel>
inline int allow_smem(Kernel kernel, bool& done) {
  if (!done) {
    VBT_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   DG_STAGE_SMEM));
    done = true;
  }
  return 0;
}

// stack_attn_kernel or cross_attn_kernel (`st`: DG_STACK_ATTN or
// DG_CROSS_ATTN) over the slots of the product (M, N, K) just launched with
// DG_NONE: a block an item
inline int launch_attn(const DgStage& st, const DgWork& ws, int M, int N, int K,
                       cudaStream_t s) {
  const DgPlan p = dg_plan_host(M, N, K);
  const int items = M * st.kv_heads;
  if (st.kind == DG_CROSS_ATTN) {
    if (!cross_attn_fits(st.D, st.S)) return (int)cudaErrorInvalidValue;
    static bool done = false;
    VBT_CHECK((cudaError_t)allow_smem(cross_attn_kernel, done));
    cross_attn_kernel<<<items, DG_XATTN_THREADS, cross_attn_floats(st.D, st.S) * 4, s>>>(
        st, ws.slots, p, M);
  } else {
    const int G = st.heads / st.kv_heads;
    if (!stack_attn_fits(G, st.D, st.t)) return (int)cudaErrorInvalidValue;
    const int smem = stack_attn_floats(G, st.D, st.t + 1) * 4;
    static bool done[3] = {false, false, false};   // one flag for each instantiation
    if (G == 1) {
      VBT_CHECK((cudaError_t)allow_smem(stack_attn_kernel<1>, done[0]));
      stack_attn_kernel<1><<<items, 256, smem, s>>>(st, ws.slots, p, M);
    } else if (G == 2) {
      VBT_CHECK((cudaError_t)allow_smem(stack_attn_kernel<2>, done[1]));
      stack_attn_kernel<2><<<items, 256, smem, s>>>(st, ws.slots, p, M);
    } else {
      VBT_CHECK((cudaError_t)allow_smem(stack_attn_kernel<DG_GMAX>, done[2]));
      stack_attn_kernel<DG_GMAX><<<items, 256, smem, s>>>(st, ws.slots, p, M);
    }
  }
  VBT_CHECK_LAUNCH();
  return 0;
}

// self_attn_kernel (`st`: DG_SELF_ATTN) over the slots of the q|k|v product
// (M, N, K) just launched with DG_NONE: four items a block
inline int launch_self_attn(const DgStage& st, const DgWork& ws, int M, int N, int K,
                            cudaStream_t s) {
  if (!self_attn_fits(st.D, st.t)) return (int)cudaErrorInvalidValue;
  const int smem = 4 * (st.D + st.t + 1) * 4, items = M * st.heads;
  const int i = st.D == 32 ? 0 : st.D == 64 ? 1 : st.D == 128 ? 2 : 3;
  auto kernel = i == 0 ? self_attn_kernel<1> : i == 1 ? self_attn_kernel<2>
              : i == 2 ? self_attn_kernel<4> : self_attn_kernel<8>;
  static bool done[4] = {false, false, false, false};
  VBT_CHECK((cudaError_t)allow_smem(kernel, done[i]));
  kernel<<<(items + 3) / 4, 128, smem, s>>>(st, ws.slots, dg_plan_host(M, N, K), M);
  VBT_CHECK_LAUNCH();
  return 0;
}

// The product of layer `layer` of the weights behind `wts`, then `stage`, over
// one cooperative grid of min(SMs, units) blocks; `ws` must hold tiles + grid
// - 1 slots and the barrier's two words (stream_k_workspace); `act` made with
// HALVES halves
template <bool INT4, int KSUB, int HALVES = 2>
int dg_launch(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
              const float* bias, int group, int M, int N, int K, const DgWork& ws,
              const DgStage& stage, cudaStream_t st) {
  if (M < 1 || N % 64 != 0 || K % DG_BK != 0 || N < 64) return (int)cudaErrorInvalidValue;
  using S = DgShape<INT4, HALVES>;
  const int tiles = (M + 63) / 64 * ((N + DG_BN - 1) / DG_BN);
  const int units = tiles * (K / DG_BK), grid = dg_grid(M, N, K, HALVES == 1 ? DG1_MIN_UNITS : 1);
  if (ws.slots == nullptr || ws.n_slots < tiles + grid - 1 || ws.n_counters < 2)
    return (int)cudaErrorInvalidValue;
  if ((stage.kind == DG_RMS || stage.kind == DG_LN) &&
      (size_t)(N + 32) * 4 > (size_t)DG_STAGE_SMEM)
    return (int)cudaErrorInvalidValue;
  if (stage.kind == DG_RMS_BF16 && (N % 8 != 0 || (size_t)(2 * N + 32) * 4 > (size_t)DG_STAGE_SMEM))
    return (int)cudaErrorInvalidValue;
  static bool allowed = false;   // one flag for each instantiation
  if (!allowed) {
    VBT_CHECK(cudaFuncSetAttribute(decode_gemm_kernel<INT4, KSUB, HALVES>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM));
    allowed = true;
  }
  // cooperative: the grid is resident at once (one block a SM), which the
  // barrier before the stage needs, or the launch fails
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(DG_THREADS);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  DgWork w = ws;
  w.epoch = stage.kind == DG_NONE ? 0u : dg_next_epoch();
  VBT_CHECK(cudaLaunchKernelEx(&cfg, decode_gemm_kernel<INT4, KSUB, HALVES>, act, wts, layer, scale, bias,
                               group, M, N, K, w, stage));
  VBT_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// The product (A @ W int8) * scale[N] (+ bias[N]), A the split activation
// behind `act` (make_act_map), W layer `layer` of the weights behind `wts`
// (make_weight_map, int8), then `stage`; ws the workspace (dg_work).
// Requires N % 64 == 0, K % 64 == 0. Defined in i8_gemm.cu.
int launch_i8_gemm(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
                   const float* bias, int M, int N, int K, const DgWork& ws, const DgStage& stage,
                   cudaStream_t stream);

// The same product with A one bf16 half (make_act_map with halves 1): the
// per-layer steps' (layer_step.cu). Defined in i8_gemm.cu.
int launch_i8_gemm_bf16(const CUtensorMap& act, const CUtensorMap& wts, int layer,
                        const float* scale, const float* bias, int M, int N, int K,
                        const DgWork& ws, const DgStage& stage, cudaStream_t stream);

// The product sum over groups of (A[:, group rows] @ W4[group rows, :]) *
// scale[group, N], W4 layer `layer` of the int4 weights behind `wts`
// (make_weight_map, int4), scale [K / group, N] (group == K: one scale per
// output column), then `stage`. Defined in i4_gemm.cu. Requires N % 64 == 0,
// K % 64 == 0, group % 32 == 0, K % group == 0.
int launch_i4_gemm(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
                   int group, int M, int N, int K, const DgWork& ws, const DgStage& stage,
                   cudaStream_t stream);
