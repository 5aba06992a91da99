"""Device ms a token in the bridge step: the kernels launched inside the
"bridge_step" range (decode_kernels.fused_bridge_step -> csrc/bridge_step.cu)."""


def read(trace):
    s = trace.range_seconds("bridge_step")
    return s / trace.work["tokens"] * 1e3 if s > 0 and trace.work.get("tokens") else None
