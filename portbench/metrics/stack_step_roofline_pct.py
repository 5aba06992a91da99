"""The stack steps' share of their roofline: the least time the card could
take for them (per step the larger of its bytes over 3.35 TB/s and its
operations over 989 TFLOP/s, portbench.arith, summed over the traced
steps) over the device time of the kernels launched inside the
"stack_step" range."""


def read(trace):
    s = trace.range_seconds("stack_step")
    bound = trace.work.get("stack_bound_s")
    return 100.0 * bound / s if s > 0 and bound else None
