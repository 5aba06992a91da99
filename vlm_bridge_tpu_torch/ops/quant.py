"""Int8 weight-only quantization and its kernels (port of
vlm_bridge_tpu.ops.quant).

Scheme: symmetric per-channel int8, w ~= w_int8 * scale. Five functions have
a CUDA kernel: `int8_matmul`, `int8_mlp`, `int8_ffn` (csrc/int8_linear.cu),
`int8_matmul_t` and the greedy head `int8_matmul_t_argmax`
(csrc/int8_argmax.cu). Each wrapper launches its kernel on CUDA tensors (x
bf16, weights int8 in the layout `quantize_int8` gives, scales and biases
f32) or raises, runs its plain version `*_plain` on CPU tensors, and counts
its launches in `.launches`. The plain versions multiply in f32 over x in
its own dtype and round where the JAX functions round: the result to
x.dtype, and the hidden of the two fused layers to x.dtype before the second
product.
"""

from __future__ import annotations

import functools

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


def int8_matmul_t_plain(x: torch.Tensor, wq: dict, *, out_dtype=torch.float32,
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
    y = int8_matmul_t_plain(x, wq)
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


def int8_matmul_t(x: torch.Tensor, wq: dict, *, out_dtype=torch.float32) -> torch.Tensor:
    """The sampled head's logits: y[M, V] = x[M, H] @ dequant(w[V, H]).T in
    f32. CPU tensors take the plain version; CUDA tensors launch the kernel
    (x bf16, f32 out) or raise."""
    if not x.is_cuda:
        return int8_matmul_t_plain(x, wq, out_dtype=out_dtype)
    w, scale = wq["w_int8"], wq["scale"]
    M, H = x.shape
    V = w.shape[0]
    if out_dtype != torch.float32:
        raise ValueError(f"the kernel writes float32 logits, not {out_dtype}")
    cuda_lib.check(x, "x", torch.bfloat16, (M, H))
    cuda_lib.check(w, "w_int8", torch.int8, (V, H))
    cuda_lib.check(scale, "scale", torch.float32, (V,))
    if H % 64:
        raise ValueError(f"hidden size {H} must be a multiple of 64")
    y = torch.empty(M, V, dtype=torch.float32, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int8_matmul_t", p(x), p(w), p(scale), p(y), M, V, H)
    int8_matmul_t.launches += 1
    return y


int8_matmul_t.launches = 0


# ---------------------------------------------------------------------------
# x[M, I] @ w[I, O] (axis=0 quantization, per-O scales) and the two fused
# layers built on it
# ---------------------------------------------------------------------------


def _mm(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """f32 (x @ w_int8) * scale."""
    return (x.float() @ wq["w_int8"].float()) * wq["scale"]


def int8_matmul_plain(x: torch.Tensor, wq: dict) -> torch.Tensor:
    return _mm(x, wq).to(x.dtype)


def int8_mlp_plain(x: torch.Tensor, gate_q: dict, up_q: dict, down_q: dict) -> torch.Tensor:
    h = (torch.nn.functional.gelu(_mm(x, gate_q), approximate="tanh") * _mm(x, up_q)).to(x.dtype)
    return _mm(h, down_q).to(x.dtype)


def int8_ffn_plain(x: torch.Tensor, fc1_q: dict, b1: torch.Tensor, fc2_q: dict,
                   b2: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.gelu(_mm(x, fc1_q) + b1.float()).to(x.dtype)
    return (_mm(h, fc2_q) + b2.float()).to(x.dtype)


# columns of one weight a block of csrc/int8_linear.cu covers, rows of x per
# block, rows of the weights per pipeline stage
_TILE_N, _TILE_M, _TILE_K = 128, 64, 64
# blocks per SM the contraction is split for, when the tiles alone give fewer
_BLOCKS_PER_SM = 2
_MAX_SPLITS = 16


def _splits(M: int, N: int, K: int, *, dual: bool, sms: int) -> int:
    """How many slices of the contraction the product kernel runs, each in a
    block of its own, so that a small batch still fills the card. The slices
    are added in a fixed order, so the result does not depend on the
    count's timing, only on the shapes and the card."""
    tiles = -(-N // (_TILE_N // 2 if dual else _TILE_N)) * -(-M // _TILE_M)
    chunks = -(-K // _TILE_K)
    want = max(1, min(_MAX_SPLITS, chunks, (_BLOCKS_PER_SM * sms) // tiles))
    per = -(-chunks // want)
    return -(-chunks // per)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_kn(wq: dict, name: str, K: int, N: int) -> None:
    cuda_lib.check(wq["w_int8"], f"{name}.w_int8", torch.int8, (K, N))
    cuda_lib.check(wq["scale"], f"{name}.scale", torch.float32, (N,))
    if K % 8 or N % 16:
        raise ValueError(f"{name}: int8 weight {K}x{N} needs the input width a multiple "
                         "of 8 and the output width a multiple of 16")


def int8_matmul(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """y[M, O] = x[M, I] @ dequant(w[I, O]) in x.dtype, f32 accumulation; w
    quantized with axis=0 (per-O scales). CPU tensors take the plain version;
    CUDA tensors launch the kernel (x bf16) or raise."""
    if not x.is_cuda:
        return int8_matmul_plain(x, wq)
    M, I = x.shape
    O = wq["w_int8"].shape[1]
    cuda_lib.check(x, "x", torch.bfloat16, (M, I))
    _check_kn(wq, "w", I, O)
    splits = _splits(M, O, I, dual=False, sms=_sms(x.device))
    part = torch.empty(splits * M * O, dtype=torch.float32, device=x.device)
    y = torch.empty(M, O, dtype=torch.bfloat16, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int8_matmul", p(x), p(wq["w_int8"]), p(wq["scale"]), p(part), p(y),
                  M, I, O, splits)
    int8_matmul.launches += 1
    return y


int8_matmul.launches = 0


def int8_mlp(x: torch.Tensor, gate_q: dict, up_q: dict, down_q: dict) -> torch.Tensor:
    """The Gemma-2 MLP with int8 weights in one call:
    down(gelu_tanh(x @ gate) * (x @ up)). x: [M, H]; gate/up: axis=0-quantized
    [H, F]; down: axis=0-quantized [F, H]. Returns [M, H] in x.dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel (x bf16)
    or raise."""
    if not x.is_cuda:
        return int8_mlp_plain(x, gate_q, up_q, down_q)
    M, H = x.shape
    F = gate_q["w_int8"].shape[1]
    cuda_lib.check(x, "x", torch.bfloat16, (M, H))
    _check_kn(gate_q, "gate", H, F)
    _check_kn(up_q, "up", H, F)
    _check_kn(down_q, "down", F, H)
    sms = _sms(x.device)
    s1 = _splits(M, F, H, dual=True, sms=sms)
    s2 = _splits(M, H, F, dual=False, sms=sms)
    part = torch.empty(max(2 * s1 * M * F, s2 * M * H), dtype=torch.float32, device=x.device)
    hidden = torch.empty(M, F, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(M, H, dtype=torch.bfloat16, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int8_mlp", p(x), p(gate_q["w_int8"]), p(up_q["w_int8"]),
                  p(gate_q["scale"]), p(up_q["scale"]), p(down_q["w_int8"]), p(down_q["scale"]),
                  p(part), p(hidden), p(y), M, H, F, s1, s2)
    int8_mlp.launches += 1
    return y


int8_mlp.launches = 0


def int8_ffn(x: torch.Tensor, fc1_q: dict, b1: torch.Tensor, fc2_q: dict,
             b2: torch.Tensor) -> torch.Tensor:
    """A biased FFN with int8 weights in one call (the bridge's at decode):
    gelu_exact(x @ fc1 + b1) @ fc2 + b2. x: [M, H]; fc1: axis=0-quantized
    [H, F]; b1: [F]; fc2: axis=0-quantized [F, H]; b2: [H]. Returns [M, H] in
    x.dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (x bf16, biases f32) or raise."""
    if not x.is_cuda:
        return int8_ffn_plain(x, fc1_q, b1, fc2_q, b2)
    M, H = x.shape
    F = fc1_q["w_int8"].shape[1]
    cuda_lib.check(x, "x", torch.bfloat16, (M, H))
    _check_kn(fc1_q, "fc1", H, F)
    _check_kn(fc2_q, "fc2", F, H)
    cuda_lib.check(b1, "b1", torch.float32, (F,))
    cuda_lib.check(b2, "b2", torch.float32, (H,))
    sms = _sms(x.device)
    s1 = _splits(M, F, H, dual=False, sms=sms)
    s2 = _splits(M, H, F, dual=False, sms=sms)
    part = torch.empty(max(s1 * M * F, s2 * M * H), dtype=torch.float32, device=x.device)
    hidden = torch.empty(M, F, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(M, H, dtype=torch.bfloat16, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int8_ffn", p(x), p(fc1_q["w_int8"]), p(fc1_q["scale"]), p(b1),
                  p(fc2_q["w_int8"]), p(fc2_q["scale"]), p(b2), p(part), p(hidden), p(y),
                  M, H, F, s1, s2)
    int8_ffn.launches += 1
    return y


int8_ffn.launches = 0
