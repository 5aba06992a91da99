"""Device ms a token in the routing kernel (moe_route_kernel,
csrc/stack_step.cu: router logits, softmax, top k and weights of every row,
a launch a layer). Silent where none ran."""


def read(trace):
    s = trace.kernel_seconds(lambda name: "moe_route_kernel" in name)
    return s / trace.work["tokens"] * 1e3 if s > 0 and trace.work.get("tokens") else None
