"""Device ms a token in the routed experts' products: the kernels named
moe_expert_kernel (csrc/decode_gemm.cuh, launched by csrc/stack_step.cu
inside the stack step: gate|up with GeGLU and the routing weights, down with
the post-FFN norm and residual). Silent where none ran."""


def read(trace):
    s = trace.kernel_seconds(lambda name: "moe_expert_kernel" in name)
    return s / trace.work["tokens"] * 1e3 if s > 0 and trace.work.get("tokens") else None
