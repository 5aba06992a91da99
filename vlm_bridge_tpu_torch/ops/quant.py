"""Int8 weight-only quantization and the greedy int8 head (port of
vlm_bridge_tpu.ops.quant).

Scheme: symmetric per-channel int8, w ~= w_int8 * scale. The greedy head
`int8_matmul_t_argmax` is a CUDA kernel (csrc/int8_argmax.cu) on CUDA
tensors and its plain version `int8_matmul_t_argmax_plain` on CPU tensors.
"""

from __future__ import annotations

import torch

from vlm_bridge_tpu_torch.ops import cuda_lib

# Vocab rows per block of the greedy head. It fixes which logits a NaN
# disqualifies (a block holding a NaN never wins), so the kernel and the
# plain version share it (csrc/int8_argmax.cu: BV).
ARGMAX_BLOCK_V = 128


def quantize_int8(w: torch.Tensor, *, axis: int = 0) -> dict:
    """Symmetric per-channel int8. axis is the CONTRACTION axis: [I, O]
    weights use axis=0 (per-O scale); the [V, H] tied embedding uses axis=1
    (per-V scale). Returns {"w_int8": int8 same shape, "scale": f32}."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis)
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    q = torch.round(wf / scale.unsqueeze(axis))
    return {"w_int8": torch.clamp(q, -127, 127).to(torch.int8), "scale": scale}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "w_int8" in w


def dequantize(wq: dict, *, axis: int = 0, dtype=torch.float32) -> torch.Tensor:
    return (wq["w_int8"].float() * wq["scale"].unsqueeze(axis)).to(dtype)


def int8_matmul_t(x: torch.Tensor, wq: dict, *, out_dtype=torch.float32,
                  chunk: int = 32768) -> torch.Tensor:
    """Plain y[M, V] = x[M, H] @ dequant(w[V, H]).T (per-V scales), f32
    products over x rounded to its own dtype; the table is widened in
    vocab chunks so no f32 copy of the whole table exists."""
    w, scale = wq["w_int8"], wq["scale"]
    xf = x.float()
    out = torch.empty(x.shape[0], w.shape[0], dtype=out_dtype, device=x.device)
    for v0 in range(0, w.shape[0], chunk):
        blk = w[v0:v0 + chunk].float()
        out[:, v0:v0 + chunk] = (xf @ blk.T * scale[v0:v0 + chunk]).to(out_dtype)
    return out


def int8_matmul_t_argmax_plain(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """Plain version of the greedy head: argmax_v of x @ dequant(E).T with
    the kernel's NaN and tie rules (first index; a block of ARGMAX_BLOCK_V
    vocab rows holding a NaN never wins; no winner -> 0). Returns [M] int32."""
    y = int8_matmul_t(x, wq)
    M, V = y.shape
    nb = -(-V // ARGMAX_BLOCK_V)
    pad = nb * ARGMAX_BLOCK_V - V
    yb = torch.nn.functional.pad(y, (0, pad), value=float("-inf")).view(M, nb, ARGMAX_BLOCK_V)
    has_nan = torch.isnan(yb).any(dim=-1)
    bmax = torch.where(has_nan, torch.full_like(yb[..., 0], float("-inf")),
                       yb.nan_to_num(nan=float("-inf")).amax(dim=-1))
    best = bmax.amax(dim=-1, keepdim=True)
    blk = torch.argmax((bmax == best).to(torch.int8), dim=-1)  # first winning block
    rows = torch.arange(M, device=y.device)
    inblk = yb[rows, blk]
    first = torch.argmax((inblk == best).to(torch.int8), dim=-1)
    ids = blk * ARGMAX_BLOCK_V + first
    return torch.where(best[:, 0] > float("-inf"), ids, torch.zeros_like(ids)).to(torch.int32)


def int8_matmul_t_argmax(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """Greedy head: argmax_v of x[M, H] @ dequant(w[V, H]).T, logits never
    written. CPU tensors take the plain version; CUDA tensors launch the
    kernel (x bf16, table int8, scales f32) or raise."""
    w, scale = wq["w_int8"], wq["scale"]
    if not x.is_cuda:
        return int8_matmul_t_argmax_plain(x, wq)
    M, H = x.shape
    V = w.shape[0]
    cuda_lib.check(x, "x", torch.bfloat16, (M, H))
    cuda_lib.check(w, "w_int8", torch.int8, (V, H))
    cuda_lib.check(scale, "scale", torch.float32, (V,))
    if H % 64:
        raise ValueError(f"hidden size {H} must be a multiple of 64")
    nb = -(-V // ARGMAX_BLOCK_V)
    bval = torch.empty(nb, M, dtype=torch.float32, device=x.device)
    bidx = torch.empty(nb, M, dtype=torch.int32, device=x.device)
    ids = torch.empty(M, dtype=torch.int32, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int8_matmul_t_argmax", p(x), p(w), p(scale), p(bval),
                  p(bidx), p(ids), M, V, H)
    int8_matmul_t_argmax.launches += 1
    return ids


int8_matmul_t_argmax.launches = 0
