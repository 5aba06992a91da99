"""Device ms a train step in the flash attention kernels, by their names in
csrc/flash_fwd.cu and csrc/flash_bwd.cu (ops/flash_attention.py)."""

NAMES = ("fa_fwd_sm90_kernel", "fa_bwd_dq_sm90_kernel", "fa_bwd_dkv_sm90_kernel")


def read(trace):
    s = trace.kernel_seconds(lambda name: any(n in name for n in NAMES))
    return s / trace.work["steps"] * 1e3 if s > 0 and trace.work.get("steps") else None
