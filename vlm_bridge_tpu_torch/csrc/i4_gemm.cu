// Int4-weight GEMM at decode batch: Y += sum over scale groups of
// (A[:, group] @ W4[group, :]) * scale[group, :].
//
// The int4 MLP stage of the fused decoder step (stack_step.cu), which
// replaces the `mlp4=True` stage of the Pallas kernel
// vlm_bridge_tpu/ops/decode_kernels.py:_stack_kernel (reached through
// fused_stack_step): the gate|up and the down projections of every layer
// with nibble-packed weights, per output channel or per group of rows.
//
// Bound: operations. The weights are half the int8 MLP's bytes (a token's
// stack streams 1.30 GB: 0.39 ms at 3.35 TB/s), but the tensor work is the
// int8 stack's, 2 x 64 rows x the weights x the two bf16 halves of the
// activations (hi + lo, common.cuh): 0.52 ms at 989 TFLOP/s. The halves stay,
// because they keep the kernel within f32 rounding of the plain version.
//
// Design: decode_gemm.cuh's kernel, described in i8_gemm.cu, at two nibbles
// a byte. The layout is ops/decode_kernels.to_fragments4: for 64 columns and
// 64 rows of K a lane's 16 bytes hold its A fragments of four k16 steps, the
// first two in the low nibbles; they are widened in registers to bf16
// (widen8_nibbles, exact). A stage moves a 2 KB run a 64-column tile; the
// ring holds 9. The two per-group scales a thread keeps leave no registers
// for a second unit's widened fragments: the next unit's 16 bytes are read
// under the products and widened when its turn comes.
// The TPU layout's pairing of row k with k + K/2, its block-local down
// projection and its MLP chunk width exist for Mosaic's tiling and have no
// counterpart here.
//
// Scales that vary along the contraction cannot fold into one output
// multiply, and a second accumulator for the current group's raw sums costs
// 128 registers a thread. So there is ONE accumulator, kept in the unit of the
// current group's scale: the products add raw sums into it; when a group ends
// it is multiplied by scale[group] / scale[next group] (the scale now runs
// along the accumulator's rows: four values a thread, read one group ahead),
// and when a run of K slices ends by the last group's scale. That is the same
// sum, sum_g P_g * scale[g], at one more f32 rounding a group. The multiply
// needs the group's products finished: the kernel waits on the tensor cores
// at every stage (64 rows of K) anyway, and for groups of an odd multiple of
// 32 rows also inside a stage (KSUB = 2). A scale of 0 is taken as 1e-30 (its
// group then weighs 1e-30 instead of 0); the quantizers floor scales at
// 1e-12 / 7. One scale per output column is the case group == K. A run may
// start or end inside a group: both runs scale their share by the same factor.

#include "decode_gemm.cuh"

int launch_i4_gemm(const CUtensorMap& act, const CUtensorMap& wts, int layer, const float* scale,
                   int group, float* Y, int M, int N, int K, cudaStream_t stream) {
  if (group <= 0 || group % 32 != 0 || K % group != 0) return (int)cudaErrorInvalidValue;
  if (group % DG_BK == 0)
    return dg_launch<true, 4>(act, wts, layer, scale, nullptr, group, Y, M, N, K, stream);
  return dg_launch<true, 2>(act, wts, layer, scale, nullptr, group, Y, M, N, K, stream);
}

// The GEMM core alone (scripts/decode_gemm_torch.py, the cuda tests):
// y[M, N] (f32, accumulated into) += sum over groups of ((a[0] + a[1])[:, group]
// @ W4[group, :]) * scale[group, :], a [2, M, K] bf16, scale [K / group, N].
extern "C" int vbt_i4_gemm(const void* a, const void* w4, const void* scale, void* y, int group,
                           int M, int N, int K, void* stream_ptr) {
  VBT_CHECK((cudaError_t)bind_device(a));
  CUtensorMap act, wts;
  int rc = make_act_map(&act, (const bf16*)a, K, M, K);
  if (!rc) rc = make_weight_map(&wts, w4, 1, K, N, true);
  if (rc) return rc;
  return launch_i4_gemm(act, wts, 0, (const float*)scale, group, (float*)y, M, N, K,
                        (cudaStream_t)stream_ptr);
}
