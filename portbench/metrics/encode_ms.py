"""Device ms a batch in the vision encode: the kernels launched inside the
"encode" range (full_model.encode_image: models/dinov2.py, csrc/flash_fwd.cu)."""


def read(trace):
    s = trace.range_seconds("encode")
    return s / trace.work["batches"] * 1e3 if s > 0 and trace.work.get("batches") else None
