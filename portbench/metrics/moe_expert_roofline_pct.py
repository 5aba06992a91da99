"""The expert products' share of their roofline: the least time the card
could take for them (per step the larger of the touched experts' bytes over
3.35 TB/s and the routed rows' operations over 989 TFLOP/s,
portbench.arith_moe) over the device time of the moe_expert_kernel kernels."""


def read(trace):
    s = trace.kernel_seconds(lambda name: "moe_expert_kernel" in name)
    bound = trace.work.get("moe_expert_bound_s")
    return 100.0 * bound / s if s > 0 and bound else None
