// Int8-weight GEMM at decode batch: Y += (A @ W int8) * scale (+ bias).
//
// The building block of the fused decode steps (stack_step.cu,
// bridge_step.cu), which replace the Pallas kernels
// vlm_bridge_tpu/ops/decode_kernels.py:_stack_kernel and :_bridge_kernel.
// It carries their int8 products: every projection of a decoder layer and a
// bridge block. The kernel is decode_gemm.cuh's, shared with the int4 MLP
// stage (i4_gemm.cu).
//
// Bound. At decode (M = batch = 64 rows) a token's 104 stack products stream
// 2.02 GB of int8 weights: 0.60 ms at 3.35 TB/s. The f32 activations reach
// the tensor cores as two bf16 halves (hi = bf16(a), lo = bf16(a - hi),
// common.cuh), which keeps 64 of 64 greedy first tokens equal to the plain
// version's where one bf16 operand flipped one: that doubles the tensor work
// to 2 x 64 x 2.02 G multiply-adds, 0.52 ms at 989 TFLOP/s. So both bounds
// are close, and only wgmma reaches the tensor-core rate. (With int4 weights,
// i4_gemm.cu, the tensor cores set the floor.)
//
// Design (Hopper's own; swap-AB; scripts/decode_gemm_torch.py times it):
// - Y^T = W^T . A^T: the weight columns are wgmma's 64-row M side, the 64
//   activation rows (hi and lo: 128) its N side, so one m64n128k16 does a
//   k16 step of 64 weight columns for both halves; a thread holds columns n
//   and n + 64 of the accumulator (the n8 tiles j and j + 8), so hi + lo is a
//   register add in the epilogue.
// - The weights are the A operand from registers. Their layout is this
//   port's own (ops/decode_kernels.to_fragments): for 64 columns and 32 rows
//   of K, a lane's 16 contiguous bytes are its A fragments of two k16 steps,
//   widened in registers to bf16 (exact for |w| <= 127; widen4). Widened
//   weights never pass through shared memory. A warpgroup widens the next
//   stage's fragments while its products of this one run.
// - A block is three consumer warpgroups, a 64-column tile each (192
//   columns, 64 accumulators a thread), and two producer warps: one thread
//   loads the activations' 16 KB box of a (K, M, 2) tensor map (128-byte
//   swizzle, rows past M zero: any M works, in blocks of 64), another the
//   weights' box of the three tiles' fragment runs (a 4-D map over the
//   stacked layers; evict-first in the L2, so that the weights do not push
//   out the activations and Y). 14 warps leave 128 registers a thread;
//   two 64-column tiles a warpgroup (128 accumulators) or four warpgroups
//   (96) do not fit. A stage is 64 rows of K; the ring holds 7.
// - Work is split "stream-K": the (tile, K slice) units in tile-major order
//   are cut into one equal run for each SM, so the grid is one wave at every
//   shape (gate|up's 96 tiles and o's 12 alike); each run of one tile ends in
//   an epilogue that stages (hi + lo) * scale (+ bias) in shared memory and
//   adds it into Y with 16-byte f32 vector reductions (split sums may differ
//   run to run in the last f32 bits). Y must be zero on entry: the step's
//   kernels that read Y write zeros back, so the step launches no memset.
// Measured on an H100 (PERF.md): 1.8x the byte bound at gate|up, 3-5x at
// the small products, whose runs are two to five stages deep.

#include "decode_gemm.cuh"

int launch_i8_gemm(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
                   const float* bias, float* Y, int M, int N, int K, cudaStream_t stream) {
  return dg_launch<false, 4>(act, wts, layer, scale, bias, 0, Y, M, N, K, stream);
}

// The GEMM core alone (scripts/decode_gemm_torch.py, the cuda tests):
// y[M, N] (f32, accumulated into) += ((a[0] + a[1]) @ W int8) * scale (+ bias),
// a [2, M, K] bf16.
extern "C" int vbt_i8_gemm(const void* a, const void* w, const void* scale, const void* bias,
                           void* y, int M, int N, int K, void* stream_ptr) {
  VBT_CHECK((cudaError_t)bind_device(a));
  CUtensorMap act, wts;
  int rc = make_act_map(&act, (const bf16*)a, K, M, K);
  if (!rc) rc = make_weight_map(&wts, w, 1, K, N, false);
  if (rc) return rc;
  return launch_i8_gemm(act, wts, 0, (const float*)scale, (const float*)bias, (float*)y, M, N, K,
                        (cudaStream_t)stream_ptr);
}
