"""Device ms a train step in PyTorch's own elementwise, reduction and
indexing kernels (names in at::native): the train step's eager work
(training/train_step.py), apart from the matrix products and the port's
kernels."""


def read(trace):
    s = trace.kernel_seconds(lambda name: "at::native" in name)
    return s / trace.work["steps"] * 1e3 if s > 0 and trace.work.get("steps") else None
