"""Device ms a token in the decoder stack step: the kernels launched inside
the "stack_step" range (decode_kernels.fused_stack_step -> csrc/stack_step.cu,
csrc/decode_gemm.cuh via i8_gemm.cu / i4_gemm.cu)."""


def read(trace):
    s = trace.range_seconds("stack_step")
    return s / trace.work["tokens"] * 1e3 if s > 0 and trace.work.get("tokens") else None
