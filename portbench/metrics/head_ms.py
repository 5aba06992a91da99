"""Device ms a token in the head and the sampler: the kernels launched
inside the "head" ranges (the greedy heads int8_matmul_t_argmax /
int4_matmul_t_argmax -> csrc/tied_head.cu; sampled: gemma2.logits_from_hidden,
that is int8_matmul_t and the soft-cap) and the "sampler" range
(ops/sampling.sample_token)."""


def read(trace):
    s = trace.range_seconds("head", "sampler")
    return s / trace.work["tokens"] * 1e3 if s > 0 and trace.work.get("tokens") else None
