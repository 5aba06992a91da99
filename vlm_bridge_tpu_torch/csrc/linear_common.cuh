// The int8 product kernel's launcher (defined and called in int8_linear.cu)
// and its epilogues.
#pragma once

#include "common.cuh"

// The int8 product kernel's epilogues (int8_linear.cu:launch_i8mm)
enum { I8_SCALE = 1, I8_GEGLU = 2, I8_GELU_ERF = 3 };

// out[M, N] = epi(X[M, K] (bf16) . W[K, N] (int8, row-major [in, out])):
//   I8_SCALE     sum * s0 (+ bias)                          (out bf16)
//   I8_GELU_ERF  gelu_erf(sum * s0 + bias)                  (out bf16)
//   I8_GEGLU     gelu_tanh(sum0 * s0) * (sum1 * s1), sum0 over W0 and sum1
//                over W1 (gate and up, both [K, N])         (out bf16)
// The contraction in `split` slices (1..8, at most ceil(K / 64); 1 when
// M > 128), added in a fixed order. Requires N % 16 == 0, K % 8 == 0.
// Defined in int8_linear.cu.
int launch_i8mm(const bf16* X, const int8_t* W0, const int8_t* W1, int M, int N, int K, int epi,
                const float* s0, const float* s1, const float* bias, void* out, int split,
                cudaStream_t st);
