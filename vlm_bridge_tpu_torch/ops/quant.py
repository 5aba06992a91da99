"""Int8 and int4 weight-only quantization and their kernels (port of
vlm_bridge_tpu.ops.quant).

Int8: symmetric per-channel, w ~= w_int8 * scale. Five functions have a CUDA
kernel: `int8_matmul`, `int8_mlp`, `int8_ffn` (csrc/int8_linear.cu),
`int8_matmul_t` and the greedy head `int8_matmul_t_argmax`
(csrc/int8_argmax.cu).

Int4: symmetric, values -7..7, two to a byte. `quantize_int4` packs a weight
[K, N] along its contraction axis (byte (k, n) holds rows k and k + K/2;
scales per output channel or per group of `group_size` rows);
`quantize_int4_rows` packs a lookup table [V, H] along H (byte (v, k) holds
columns k and k + H/2; scales per row, or per (row, H-group) stored
transposed [H/g, V]). The dicts carry the JAX package's keys and, bit for
bit, its bytes and scales. Three functions have a CUDA kernel: the heads
`int4_matmul_t` and `int4_matmul_t_argmax` (csrc/int8_argmax.cu) and
`int4_mlp` (csrc/int4_linear.cu). The kernels read the packed layouts as
they are: the rows-packed table, gate/up packed over the whole of H
("global") and the down projection packed block by block
(`repack_down_blockwise`); no copy in another order is kept.

Each wrapper launches its kernel on CUDA tensors (x bf16, weights int8 in
the layout the quantizers give, scales and biases f32) or raises, runs its
plain version `*_plain` on CPU tensors, and counts its launches in
`.launches`. The plain versions multiply in f32 over x in its own dtype and
round where the JAX functions round: the result to x.dtype, and the hidden
of the fused layers to x.dtype before the second product.
"""

from __future__ import annotations

import functools
from typing import Optional

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


def _argmax_blocks(y: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of y [M, V] with the heads' NaN and tie
    rules: first index; a block of ARGMAX_BLOCK_V columns holding a NaN never
    wins; no winner -> 0. Returns [M] int32."""
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


def int8_matmul_t_argmax_plain(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """Plain version of the greedy head: argmax_v of x @ dequant(E).T with
    the kernel's NaN and tie rules (`_argmax_blocks`). Returns [M] int32."""
    return _argmax_blocks(int8_matmul_t_plain(x, wq))


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


# ---------------------------------------------------------------------------
# int4: the rows-packed table (embedding / lm_head) and its two heads
# ---------------------------------------------------------------------------


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two int8 tensors of values -8..7 -> one int8 tensor, lo in the low
    nibble. Done in int32: hi << 4 leaves int8's range only in its sign."""
    return ((lo.int() & 0xF) | (hi.int() << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor):
    """int8 bytes -> (lo, hi) int8 nibbles, sign-extended."""
    w = packed.int()
    return (((w & 0xF) ^ 8) - 8).to(torch.int8), (w >> 4).to(torch.int8)


def quantize_int4_rows(w: torch.Tensor, *, group_size: Optional[int] = None) -> dict:
    """Symmetric int4 for row-major lookup tables [V, H]: nibble-packed along
    H (contiguous halves), scales per vocab row or, with group_size, per
    (row, H-group), stored transposed [H/g, V]. Returns {"w_int4": int8
    [V, H/2], "scale": f32 [V] or [H/g, V]}: tensors only, the group size is
    recovered from the scale's shape."""
    wf = w.float()
    V, H = wf.shape
    if H % 2:
        raise ValueError("H must be even to nibble-pack")
    if group_size is None:
        scale = torch.clamp(wf.abs().amax(dim=1), min=1e-12) / 7.0
        scale_full = scale[:, None]
    else:
        g = group_size
        if (H // 2) % g:
            raise ValueError(f"group_size {g} must divide H/2 ({H // 2}) so each nibble half "
                             "holds whole groups")
        scale_vg = torch.clamp(wf.reshape(V, H // g, g).abs().amax(dim=2), min=1e-12) / 7.0
        scale = scale_vg.T.contiguous()
        scale_full = scale_vg.repeat_interleave(g, dim=1)
    q = torch.clamp(torch.round(wf / scale_full), -7, 7).to(torch.int8)
    return {"w_int4": _pack_nibbles(q[:, :H // 2], q[:, H // 2:]), "scale": scale}


def is_quantized_int4_rows(w) -> bool:
    """Rows-packed table: [V, H/2] nibbles + per-row(-group) scales; the
    shapes tell it from an axis-0 int4 weight."""
    if not (isinstance(w, dict) and "w_int4" in w and "scale" in w):
        return False
    s, V = w["scale"], w["w_int4"].shape[0]
    return (s.dim() == 1 and s.shape[0] == V) or (s.dim() == 2 and s.shape[1] == V)


def _rows_group(wq: dict) -> Optional[int]:
    """Group size of a rows-packed table, from the scale's shape alone."""
    s = wq["scale"]
    return None if s.dim() == 1 else (2 * wq["w_int4"].shape[1]) // s.shape[0]


def _rows_scale_full(wq: dict, v0: int = 0, v1: Optional[int] = None) -> torch.Tensor:
    """[v1 - v0, H]-broadcastable f32 scale of rows v0..v1 of a rows-packed table."""
    g = _rows_group(wq)
    if g is None:
        return wq["scale"][v0:v1, None]
    return wq["scale"][:, v0:v1].T.repeat_interleave(g, dim=1)


def _check_rows(wq: dict) -> None:
    if not is_quantized_int4_rows(wq):
        raise ValueError("expected a rows-packed int4 table (quantize_int4_rows)")


def dequantize_int4_rows(wq: dict, *, dtype=torch.float32) -> torch.Tensor:
    _check_rows(wq)
    q = torch.cat(unpack_int4(wq["w_int4"]), dim=1).float()
    return (q * _rows_scale_full(wq)).to(dtype)


def take_int4_rows(wq: dict, ids: torch.Tensor) -> torch.Tensor:
    """Gather + dequantize rows of a rows-packed int4 table (f32 out); only
    the gathered rows are unpacked."""
    q = torch.cat(unpack_int4(wq["w_int4"][ids]), dim=-1).float()
    g = _rows_group(wq)
    if g is None:
        return q * wq["scale"][ids][..., None]
    s = wq["scale"][:, ids].movedim(0, -1)                 # [..., H/g]
    return q * s.repeat_interleave(g, dim=-1)


def int4_matmul_t_plain(x: torch.Tensor, wq: dict, *, out_dtype=torch.float32,
                        chunk: int = 32768) -> torch.Tensor:
    """Plain y[M, V] = x[M, H] @ dequant4(w[V, H]).T in f32 over x rounded to
    its own dtype; the table is widened in vocab chunks."""
    _check_rows(wq)
    w = wq["w_int4"]
    xf = x.float()
    out = torch.empty(x.shape[0], w.shape[0], dtype=out_dtype, device=x.device)
    for v0 in range(0, w.shape[0], chunk):
        q = torch.cat(unpack_int4(w[v0:v0 + chunk]), dim=1).float()
        out[:, v0:v0 + chunk] = (xf @ (q * _rows_scale_full(wq, v0, v0 + chunk)).T).to(out_dtype)
    return out


def int4_matmul_t_argmax_plain(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """Plain version of the int4 greedy head, with the int8 head's NaN and
    tie rules (`_argmax_blocks`). Returns [M] int32."""
    return _argmax_blocks(int4_matmul_t_plain(x, wq))


def _check_rows_cuda(x: torch.Tensor, wq: dict):
    """Shapes and types the int4 head kernels take; returns (M, V, H, group
    or 0)."""
    _check_rows(wq)
    w, scale = wq["w_int4"], wq["scale"]
    M, H = x.shape
    V = w.shape[0]
    g = _rows_group(wq)
    cuda_lib.check(x, "x", torch.bfloat16, (M, H))
    cuda_lib.check(w, "w_int4", torch.int8, (V, H // 2))
    cuda_lib.check(scale, "scale", torch.float32, (V,) if g is None else (H // g, V))
    if (H // 2) % 64 or (g is not None and (g % 64 or (H // 2) % g)):
        raise ValueError(f"hidden size {H} must be a multiple of 128 and the scale group "
                         f"({g}) a multiple of 64 that divides {H // 2}")
    return M, V, H, g or 0


def int4_matmul_t(x: torch.Tensor, wq: dict, *, out_dtype=torch.float32) -> torch.Tensor:
    """`int8_matmul_t` at 4 bits: y[M, V] = x[M, H] @ dequant4(w[V, H]).T in
    f32. CPU tensors take the plain version; CUDA tensors launch the kernel
    (x bf16, f32 out) or raise."""
    if not x.is_cuda:
        return int4_matmul_t_plain(x, wq, out_dtype=out_dtype)
    if out_dtype != torch.float32:
        raise ValueError(f"the kernel writes float32 logits, not {out_dtype}")
    M, V, H, g = _check_rows_cuda(x, wq)
    y = torch.empty(M, V, dtype=torch.float32, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int4_matmul_t", p(x), p(wq["w_int4"]), p(wq["scale"]), p(y), M, V, H, g)
    int4_matmul_t.launches += 1
    return y


int4_matmul_t.launches = 0


def int4_matmul_t_argmax(x: torch.Tensor, wq: dict) -> torch.Tensor:
    """`int8_matmul_t_argmax` at 4 bits: argmax_v of x[M, H] @
    dequant4(w[V, H]).T, logits never written. CPU tensors take the plain
    version; CUDA tensors launch the kernel (x bf16) or raise."""
    if not x.is_cuda:
        return int4_matmul_t_argmax_plain(x, wq)
    M, V, H, g = _check_rows_cuda(x, wq)
    nb = -(-V // ARGMAX_BLOCK_V)
    bval = torch.empty(nb, M, dtype=torch.float32, device=x.device)
    bidx = torch.empty(nb, M, dtype=torch.int32, device=x.device)
    ids = torch.empty(M, dtype=torch.int32, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int4_matmul_t_argmax", p(x), p(wq["w_int4"]), p(wq["scale"]), p(bval),
                  p(bidx), p(ids), M, V, H, g)
    int4_matmul_t_argmax.launches += 1
    return ids


int4_matmul_t_argmax.launches = 0


# ---------------------------------------------------------------------------
# int4: [K, N] weights packed along the contraction axis, and the fused MLP
# ---------------------------------------------------------------------------


def quantize_int4(w: torch.Tensor, *, axis: int = 0, group_size: Optional[int] = None) -> dict:
    """Symmetric int4, nibble-packed along `axis` (contiguous halves: byte k
    holds k and k + K/2). group_size=None: one scale per output channel;
    group_size=g (axis 0 only): scale[k // g, n]. Returns {"w_int4": int8
    [K/2, N] (axis=0), "scale": f32 [N] or [K/g, N], "packing": "global",
    "group_size": group_size}, values in [-7, 7]."""
    if axis != 0 and group_size is not None:
        raise ValueError("group-wise int4 is only implemented for axis=0 (MLP weights)")
    wf = w.float()
    K = wf.shape[axis]
    if K % 2:
        raise ValueError("contraction axis must be even to nibble-pack")
    if group_size is None:
        scale = torch.clamp(wf.abs().amax(dim=axis), min=1e-12) / 7.0
        scale_full = scale.unsqueeze(axis)
    else:
        g = group_size
        if (K // 2) % g:
            raise ValueError(f"group_size {g} must divide half the contraction axis ({K}//2) "
                             "so each nibble half packs whole groups")
        scale = torch.clamp(wf.reshape(K // g, g, -1).abs().amax(dim=1), min=1e-12) / 7.0
        scale_full = scale.repeat_interleave(g, dim=0)
    q = torch.clamp(torch.round(wf / scale_full), -7, 7).to(torch.int8)
    lo, hi = (q[:K // 2], q[K // 2:]) if axis == 0 else (q[:, :K // 2], q[:, K // 2:])
    return {"w_int4": _pack_nibbles(lo, hi), "scale": scale, "packing": "global",
            "group_size": group_size}


def is_quantized_int4(w) -> bool:
    return isinstance(w, dict) and "w_int4" in w


def _scale_rows(wq: dict) -> torch.Tensor:
    """The [K, N]-broadcastable f32 scale of an axis=0-quantized weight."""
    g = wq.get("group_size")
    s = wq["scale"]
    return s[None, :] if g is None else s.repeat_interleave(g, dim=0)


def dequantize_int4(wq: dict, *, axis: int = 0, dtype=torch.float32) -> torch.Tensor:
    if wq.get("packing", "global") != "global":
        raise ValueError(f"expected global packing, got {wq.get('packing')!r}")
    q = torch.cat(unpack_int4(wq["w_int4"]), dim=axis).float()
    scale = _scale_rows(wq) if axis == 0 else wq["scale"].unsqueeze(axis)
    return (q * scale).to(dtype)


def repack_down_blockwise(down_q: dict, *, block_f: int = 512) -> dict:
    """A globally packed [F/2, H] down projection -> the block-local packing
    `int4_mlp` takes: within each block of block_f rows, byte r holds rows r
    and r + block_f/2."""
    if down_q.get("packing", "global") != "global":
        raise ValueError(f"expected global packing, got {down_q.get('packing')!r}")
    q = torch.cat(unpack_int4(down_q["w_int4"]), dim=0)    # [F, H] int4 values
    F, H = q.shape
    half = block_f // 2
    g = down_q.get("group_size")
    if F % block_f or (g is not None and half % g):
        raise ValueError(f"block_f {block_f} must divide F ({F}) and its half hold whole "
                         f"groups of {g}")
    qb = q.reshape(F // block_f, 2, half, H)
    return {"w_int4": _pack_nibbles(qb[:, 0], qb[:, 1]).reshape(F // 2, H),
            "scale": down_q["scale"], "packing": f"blockwise{block_f}", "group_size": g}


def dequantize_int4_blockwise(wq: dict, *, block_f: int, dtype=torch.float32) -> torch.Tensor:
    """Dequantize a block-locally packed [F/2, H] weight."""
    if wq.get("packing") != f"blockwise{block_f}":
        raise ValueError(f"expected packing blockwise{block_f}, got {wq.get('packing')!r}")
    lo, hi = unpack_int4(wq["w_int4"])
    half = block_f // 2
    F2, H = lo.shape
    q = torch.stack([lo.reshape(F2 // half, half, H), hi.reshape(F2 // half, half, H)],
                    dim=1).reshape(2 * F2, H)
    return (q.float() * _scale_rows(wq)).to(dtype)


def _check_int4_mlp(x, gate_q: dict, up_q: dict, down_q: dict, block_f: int):
    """The layouts `int4_mlp` takes, as the JAX function demands them; returns
    (H, F, group or None). A wrongly packed down projection has the right
    shape and would give garbage silently, hence the explicit tag."""
    H2, F = gate_q["w_int4"].shape
    H = 2 * H2
    if x.shape[1] != H or tuple(down_q["w_int4"].shape) != (F // 2, H) \
            or tuple(up_q["w_int4"].shape) != (H2, F):
        raise ValueError("int4_mlp: x / gate / up / down shapes do not fit together")
    if down_q.get("packing") != f"blockwise{block_f}":
        raise ValueError(f"int4_mlp needs down packed by repack_down_blockwise(block_f="
                         f"{block_f}); got packing={down_q.get('packing')!r}")
    if gate_q.get("packing") != "global" or up_q.get("packing") != "global":
        raise ValueError("int4_mlp needs gate and up packed globally (quantize_int4)")
    group = gate_q.get("group_size")
    if up_q.get("group_size") != group or down_q.get("group_size") != group:
        raise ValueError("gate/up/down must share one group_size: "
                         f"{group}/{up_q.get('group_size')}/{down_q.get('group_size')}")
    return H, F, group


def int4_mlp_plain(x: torch.Tensor, gate_q: dict, up_q: dict, down_q: dict, *,
                   block_f: int = 512) -> torch.Tensor:
    _check_int4_mlp(x, gate_q, up_q, down_q, block_f)
    xf = x.float()
    h = (torch.nn.functional.gelu(xf @ dequantize_int4(gate_q), approximate="tanh")
         * (xf @ dequantize_int4(up_q))).to(x.dtype)
    return (h.float() @ dequantize_int4_blockwise(down_q, block_f=block_f)).to(x.dtype)


def int4_mlp(x: torch.Tensor, gate_q: dict, up_q: dict, down_q: dict, *,
             block_f: int = 512) -> torch.Tensor:
    """`int8_mlp` with nibble-packed int4 weights: down(gelu_tanh(x @ gate) *
    (x @ up)). gate/up: `quantize_int4` dicts [H/2, F]; down:
    `repack_down_blockwise(quantize_int4(...), block_f=block_f)` [F/2, H];
    one group_size for all three. x: [M, H]; returns [M, H] in x.dtype. CPU
    tensors take the plain version; CUDA tensors launch the kernel (x bf16)
    or raise."""
    if not x.is_cuda:
        return int4_mlp_plain(x, gate_q, up_q, down_q, block_f=block_f)
    H, F, group = _check_int4_mlp(x, gate_q, up_q, down_q, block_f)
    M = x.shape[0]
    cuda_lib.check(x, "x", torch.bfloat16, (M, H))
    for name, q, K, N in (("gate", gate_q, H, F), ("up", up_q, H, F), ("down", down_q, F, H)):
        cuda_lib.check(q["w_int4"], f"{name}.w_int4", torch.int8, (K // 2, N))
        cuda_lib.check(q["scale"], f"{name}.scale", torch.float32,
                       (N,) if group is None else (K // group, N))
    half_h, half_b = H // 2, block_f // 2
    if half_h % _TILE_K or half_b % _TILE_K or F % block_f or H % 16 or F % 16:
        raise ValueError(f"int4_mlp: H/2 ({half_h}) and block_f/2 ({half_b}) must be multiples "
                         f"of {_TILE_K}, block_f must divide F ({F}), widths multiples of 16")
    if group is not None and (group % _TILE_K or half_h % group or half_b % group):
        raise ValueError(f"int4_mlp: group_size {group} must be a multiple of {_TILE_K} that "
                         f"divides H/2 ({half_h}) and block_f/2 ({half_b})")
    sms = _sms(x.device)
    s1 = _splits(M, F, half_h, dual=True, sms=sms)
    s2 = _splits(M, H, F // 2, dual=False, sms=sms)
    part = torch.empty(max(2 * s1 * M * F, s2 * M * H), dtype=torch.float32, device=x.device)
    hidden = torch.empty(M, F, dtype=torch.bfloat16, device=x.device)
    y = torch.empty(M, H, dtype=torch.bfloat16, device=x.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_int4_mlp", p(x), p(gate_q["w_int4"]), p(up_q["w_int4"]),
                  p(gate_q["scale"]), p(up_q["scale"]), p(down_q["w_int4"]), p(down_q["scale"]),
                  p(part), p(hidden), p(y), M, H, F, block_f, group or 0, s1, s2)
    int4_mlp.launches += 1
    return y


int4_mlp.launches = 0
