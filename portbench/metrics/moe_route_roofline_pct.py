"""The routing kernel's share of its roofline: the least time the card could
take for it (the f32 router, the rows in and the weights out over 3.35 TB/s,
or its operations over 989 TFLOP/s, portbench.arith_moe) over the device time
of moe_route_kernel."""


def read(trace):
    s = trace.kernel_seconds(lambda name: "moe_route_kernel" in name)
    bound = trace.work.get("moe_route_bound_s")
    return 100.0 * bound / s if s > 0 and bound else None
