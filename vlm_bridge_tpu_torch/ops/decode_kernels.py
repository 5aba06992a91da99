"""Fused decode steps (port of vlm_bridge_tpu.ops.decode_kernels).

`fused_stack_step` runs one token through every Gemma-2 decoder layer and
`fused_bridge_step` through both bridge blocks. On CUDA tensors each
launches the hand-written kernels of csrc/stack_step.cu / csrc/bridge_step.cu
(one C call per token that launches every layer's kernels); on CPU tensors
each runs its plain PyTorch version (`*_plain`, same signature), which is
also the reference the kernels are held to on the card.

Both versions keep everything inside a step in f32: the residual stream,
the norms, the projection inputs and outputs, the softmaxes. The input and
output are in the activation dtype (x.dtype; bf16 on the card) and so is
the bridge's self cache. The kernels feed each f32 projection input to the
bf16 tensor cores as two halves (hi + lo, csrc/common.cuh), so they agree with the plain
versions to f32 rounding, which greedy decoding needs on near-ties. At f32
activations this is the JAX jnp-int8 decode path's algebra; the TPU kernels
instead round projection inputs to bf16.

Layouts are this port's own (not the TPU's head-major/64-row/8-row-window
ones). Every stacked int8 weight [K, N] ([in, out]) is stored in mma.sync
fragment order, `to_fragments(w)` = [N/32, K/16, 32, 16] (see there):
  stacked LM weights (models/gemma2.stack_decode_params):
    wqkv [L, *frag(H, QHD+2KHD)] + qkv_scale [L, QHD+2KHD],
    wo [L, *frag(QHD, H)] + o_scale [L, H], wgu [L, *frag(H, 2F)] (gate | up)
    + gu_scale [L, 2F], wd [L, *frag(F, H)] + d_scale [L, H], norms
    [L, 4, H] f32 (input / post-attn / pre-FFN / post-FFN).
  with int4 MLP weights (stack_decode_params(mlp_int4=True)) the MLP fields
    are instead wgu4 [L, *frag4(H, 2F)] + gu_scale4 [L, H/g, 2F] and wd4
    [L, *frag4(F, H)] + d_scale4 [L, F/g, H]: nibbles in the packed fragment
    order of `to_fragments4`, scales per group of g rows of the contraction,
    or one row of scales (per output channel) when the second dim is 1. The
    TPU layout's pairing of row k with k + K/2, its block-local down
    projection and its MLP chunk width serve Mosaic's tiling and are not
    copied; the nibbles' values and the scales are the same.
  LM KV cache: K/V [L, B, KH, S, D] int8, scales [L, B, KH, S] f32.
  stacked bridge weights (models/bridge.stack_bridge_decode_params):
    lns [nb, 6, ld]; wq/wo_c/wo_s [nb, *frag(ld, ld)], wqkv
    [nb, *frag(ld, 3ld)], fc1 [nb, *frag(ld, F)], fc2 [nb, *frag(F, ld)],
    each with *_scale and *_bias [nb, N] f32.
  bridge caches: cross K/V [nb, B, Hc, Sv, Dc] int8 + scales
    [nb, B, Hc, Sv]; self K/V [nb, B, Hs, Smax, Ds] in the activation dtype.
The caches are updated in place at row t.
"""

from __future__ import annotations

import torch

from vlm_bridge_tpu_torch.ops import cuda_lib
from vlm_bridge_tpu_torch.ops.layers import gelu_exact, gelu_tanh
from vlm_bridge_tpu_torch.ops.quant import _pack_nibbles, unpack_int4


def _rms(v: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMSNorm with Gemma's (1 + w) weighting."""
    return v * torch.rsqrt(v.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _ln(v: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 LayerNorm, mean-subtracting with biased variance (torch form)."""
    mu = v.mean(-1, keepdim=True)
    d = v - mu
    return d * torch.rsqrt(d.square().mean(-1, keepdim=True) + eps) * s + b


def to_fragments(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] ([in, out]) -> [N/32, K/16, 32, 16], the order in which
    csrc/i8_gemm.cu streams it: for output columns 32c..32c+31 and rows
    16r..16r+15, lane l (g = l // 4, t = l % 4) holds, for n8 tiles j = 0..3,
    w[16r + (2t, 2t+1, 2t+8, 2t+9), 32c + 8j + g]: its mma.sync m16n8k16 B
    fragments, 16 contiguous bytes."""
    K, N = w.shape
    if K % 16 or N % 32:
        raise ValueError(f"weight {K}x{N}: K must be a multiple of 16, N of 32")
    v = w.reshape(K // 16, 2, 4, 2, N // 32, 4, 8)   # k16, h, t, i, c, j, g
    return v.permute(4, 0, 6, 2, 5, 1, 3).reshape(N // 32, K // 16, 32, 16).contiguous()


def from_fragments(wf: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_fragments`: [N/32, K/16, 32, 16] -> [K, N]."""
    C, R = wf.shape[:2]
    v = wf.reshape(C, R, 8, 4, 4, 2, 2)              # c, k16, g, t, j, h, i
    return v.permute(1, 5, 3, 6, 0, 4, 2).reshape(16 * R, 32 * C)


def frag_shape(K: int, N: int) -> tuple:
    return (N // 32, K // 16, 32, 16)


def to_fragments4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (int8 in -8..7) [K, N] -> packed [N/32, K/32, 32, 16], the
    order in which csrc/i4_gemm.cu streams them: the 16 bytes of a lane hold
    its `to_fragments` bytes of rows 32r..32r+15 in their low nibbles and of
    rows 32r+16..32r+31 in their high nibbles."""
    K, N = q.shape
    if K % 32 or N % 32:
        raise ValueError(f"weight {K}x{N}: K and N must be multiples of 32")
    v = q.reshape(K // 32, 2, 16, N)
    return _pack_nibbles(to_fragments(v[:, 0].reshape(K // 2, N)),
                         to_fragments(v[:, 1].reshape(K // 2, N)))


def from_fragments4(wf: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_fragments4`: packed [N/32, K/32, 32, 16] -> int8 [K, N]."""
    lo, hi = (from_fragments(h) for h in unpack_int4(wf))
    K2, N = lo.shape
    return torch.stack([lo.reshape(K2 // 16, 16, N), hi.reshape(K2 // 16, 16, N)],
                       dim=1).reshape(2 * K2, N)


def frag4_shape(K: int, N: int) -> tuple:
    return (N // 32, K // 32, 32, 16)


def _mm4(a: torch.Tensor, wf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 a @ (w_int4 * scale), w in packed fragment order, scale [K/g, N]
    (one row: per output channel)."""
    w = from_fragments4(wf).float()
    return a @ (w * scale.repeat_interleave(w.shape[0] // scale.shape[0], dim=0))


def _mlp4_group(stacked: dict, H: int):
    """Rows of the contraction that share a scale in an int4 stack, from the
    scales' shapes alone (None: one scale per output channel)."""
    rows = stacked["gu_scale4"].shape[1]
    return None if rows == 1 else H // rows


def _mm(a: torch.Tensor, wf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 (a @ w_int8) * scale, w given in fragment order."""
    return (a @ from_fragments(wf).float()) * scale


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


# ---------------------------------------------------------------------------
# Whole decoder stack
# ---------------------------------------------------------------------------


def fused_stack_step_plain(t: int, x, stacked: dict, kc, vc, ks, vs, cos, sin, *,
                           num_heads: int, num_kv_heads: int, head_dim: int,
                           attn_scale: float, softcap: float, eps: float):
    """Plain version of `fused_stack_step` (same arguments and effects)."""
    from vlm_bridge_tpu_torch.models.gemma2 import quantize_kv

    act = x.dtype
    L = stacked["wqkv"].shape[0]
    B = x.shape[0]
    NH, KH, D = num_heads, num_kv_heads, head_dim
    G, QHD, KHD = NH // KH, NH * head_dim, KH * head_dim
    mlp4 = "wgu4" in stacked
    if mlp4:
        gu, gus, wd, ds = (stacked[k] for k in ("wgu4", "gu_scale4", "wd4", "d_scale4"))
        mm, F = _mm4, 32 * wd.shape[2]
    else:
        gu, gus, wd, ds = (stacked[k] for k in ("wgu", "gu_scale", "wd", "d_scale"))
        mm, F = _mm, 16 * wd.shape[2]
    n = t + 1
    xf = x.float()
    for i in range(L):
        nl = stacked["norms"][i]
        h = _rms(xf, nl[0], eps)
        qkv = _mm(h, stacked["wqkv"][i], stacked["qkv_scale"][i])
        q = _rope(qkv[:, :QHD].reshape(B, KH, G, D), cos, sin)
        k = _rope(qkv[:, QHD:QHD + KHD].reshape(B, KH, D), cos, sin)
        v = qkv[:, QHD + KHD:].reshape(B, KH, D)
        kc[i, :, :, t], ks[i, :, :, t] = quantize_kv(k)
        vc[i, :, :, t], vs[i, :, :, t] = quantize_kv(v)
        lg = torch.einsum("bkgd,bknd->bkgn", q, kc[i, :, :, :n].float())
        lg = lg * ks[i, :, :, None, :n] * attn_scale
        lg = torch.tanh(lg / softcap) * softcap
        p = torch.softmax(lg, dim=-1) * vs[i, :, :, None, :n]
        attn = torch.einsum("bkgn,bknd->bkgd", p, vc[i, :, :, :n].float())
        o = _mm(attn.reshape(B, QHD), stacked["wo"][i], stacked["o_scale"][i])
        xf = xf + _rms(o, nl[1], eps)
        h = _rms(xf, nl[2], eps)
        gate_up = mm(h, gu[i], gus[i])
        a = gelu_tanh(gate_up[:, :F]) * gate_up[:, F:]
        y = mm(a, wd[i], ds[i])
        xf = xf + _rms(y, nl[3], eps)
    return xf.to(act)


def fused_stack_step(t: int, x, stacked: dict, kc, vc, ks, vs, cos, sin, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     attn_scale: float, softcap: float, eps: float):
    """One lockstep decode step (position t) through all decoder layers.

    x: [B, H] scaled token embeddings; cos/sin: [head_dim] f32 RoPE rows of
    position t. Writes the new int8 K/V and scales of every layer into row
    t of kc/vc/ks/vs in place and returns the last layer's output [B, H]
    (before the final norm) in x.dtype. CUDA tensors run
    csrc/stack_step.cu (x bf16) or raise; CPU tensors run the plain version.
    A stacked dict with "wgu4" runs the int4 MLP stage (csrc/i4_gemm.cu); one
    with neither "wgu" nor "wgu4" is refused.
    """
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              attn_scale=attn_scale, softcap=softcap, eps=eps)
    mlp4 = "wgu4" in stacked
    if not mlp4 and "wgu" not in stacked:
        raise ValueError("stacked weights carry neither int8 (wgu) nor int4 (wgu4) MLP fields")
    if not x.is_cuda:
        return fused_stack_step_plain(t, x, stacked, kc, vc, ks, vs, cos, sin, **kw)
    B, H = x.shape
    L = stacked["wqkv"].shape[0]
    NQKV = 32 * stacked["wqkv"].shape[1]
    F = (32 if mlp4 else 16) * stacked["wd4" if mlp4 else "wd"].shape[2]
    NH, KH, D = num_heads, num_kv_heads, head_dim
    QHD, KHD = NH * D, KH * D
    S = kc.shape[3]
    if not 0 <= t < S:
        raise ValueError(f"position {t} outside the {S}-row cache")
    if D % 32 or D > 1024 or NH % KH or NH // KH > D // 32:
        raise ValueError(f"unsupported head layout NH={NH} KH={KH} D={D}")
    for n in (NQKV, H, 2 * F):
        if n % 128:
            raise ValueError(f"projection width {n} must be a multiple of 128")
    if NQKV != QHD + 2 * KHD or H % 128 or QHD % 128 or F % 128 or H > 4096:
        raise ValueError("stacked weight widths do not match the head layout "
                         "or exceed the row kernels' 4096")
    c = cuda_lib.check
    c(x, "x", torch.bfloat16, (B, H))
    if mlp4:
        group = _mlp4_group(stacked, H)
        if group is not None and (group % 32 or H % group or F % group):
            raise ValueError(f"int4 scale group {group} must be a multiple of 32 that divides "
                             f"H={H} and F={F}")
        mlp = (("wgu4", (L, *frag4_shape(H, 2 * F)), torch.int8),
               ("gu_scale4", (L, H // (group or H), 2 * F), torch.float32),
               ("wd4", (L, *frag4_shape(F, H)), torch.int8),
               ("d_scale4", (L, F // (group or F), H), torch.float32))
    else:
        group = None
        mlp = (("wgu", (L, *frag_shape(H, 2 * F)), torch.int8),
               ("gu_scale", (L, 2 * F), torch.float32),
               ("wd", (L, *frag_shape(F, H)), torch.int8), ("d_scale", (L, H), torch.float32))
    for name, shape, dt in (
            ("wqkv", (L, *frag_shape(H, NQKV)), torch.int8),
            ("qkv_scale", (L, NQKV), torch.float32),
            ("wo", (L, *frag_shape(QHD, H)), torch.int8), ("o_scale", (L, H), torch.float32),
            *mlp, ("norms", (L, 4, H), torch.float32)):
        c(stacked[name], name, dt, shape)
    for name, tt, dt, shape in (("kc", kc, torch.int8, (L, B, KH, S, D)),
                                ("vc", vc, torch.int8, (L, B, KH, S, D)),
                                ("ks", ks, torch.float32, (L, B, KH, S)),
                                ("vs", vs, torch.float32, (L, B, KH, S)),
                                ("cos", cos, torch.float32, (D,)),
                                ("sin", sin, torch.float32, (D,))):
        c(tt, name, dt, shape)
    dev = x.device
    x_out = torch.empty(B, H, dtype=torch.bfloat16, device=dev)
    x32 = torch.empty(B, H, dtype=torch.float32, device=dev)
    hbuf = torch.empty(2, B, H, dtype=torch.bfloat16, device=dev)  # split hi | lo
    abuf = torch.empty(2, B, max(QHD, F), dtype=torch.bfloat16, device=dev)
    ybuf = torch.empty(B, max(NQKV, 2 * F, H), dtype=torch.float32, device=dev)
    s = stacked
    p = cuda_lib.ptr
    cuda_lib.call(
        "vbt_fused_stack_step", p(x), p(x_out),
        p(s["wqkv"]), p(s["qkv_scale"]), p(s["wo"]), p(s["o_scale"]),
        *(p(s[name]) for name, _, _ in mlp), p(s["norms"]),
        p(cos), p(sin), p(kc), p(vc), p(ks), p(vs),
        p(x32), p(hbuf), p(abuf), p(ybuf),
        L, B, H, NH, KH, D, F, S, int(t), int(mlp4), group or 0,
        float(attn_scale), float(softcap), float(eps))
    fused_stack_step.launches += 1
    return x_out


fused_stack_step.launches = 0


# ---------------------------------------------------------------------------
# Whole bridge
# ---------------------------------------------------------------------------


def fused_bridge_step_plain(t: int, x, bst: dict, ck, cks, cv, cvs, sk, sv, *,
                            num_heads_cross: int, num_heads_self: int, eps: float):
    """Plain version of `fused_bridge_step` (same arguments and effects)."""
    act = x.dtype
    nb = bst["wq"].shape[0]
    B, ld = x.shape
    Hc, Hs = num_heads_cross, num_heads_self
    Dc, Ds = ld // Hc, ld // Hs
    n = t + 1
    xf = x.float()
    for k in range(nb):
        ln = bst["lns"][k]
        h = _ln(xf, ln[0], ln[1], eps)
        q = (_mm(h, bst["wq"][k], bst["q_scale"][k]) + bst["q_bias"][k]).reshape(B, Hc, Dc)
        lg = torch.einsum("bhd,bhsd->bhs", q, ck[k].float()) * Dc ** -0.5 * cks[k]
        p = torch.softmax(lg, dim=-1) * cvs[k]
        o = torch.einsum("bhs,bhsd->bhd", p, cv[k].float()).reshape(B, ld)
        xf = xf + _mm(o, bst["wo_c"][k], bst["o_c_scale"][k]) + bst["o_c_bias"][k]

        h = _ln(xf, ln[2], ln[3], eps)
        qkv = _mm(h, bst["wqkv"][k], bst["qkv_scale"][k]) + bst["qkv_bias"][k]
        q = qkv[:, :ld].reshape(B, Hs, Ds)
        sk[k, :, :, t] = qkv[:, ld:2 * ld].reshape(B, Hs, Ds).to(sk.dtype)
        sv[k, :, :, t] = qkv[:, 2 * ld:].reshape(B, Hs, Ds).to(sv.dtype)
        lg = torch.einsum("bhd,bhnd->bhn", q, sk[k, :, :, :n].float()) * Ds ** -0.5
        p = torch.softmax(lg, dim=-1)
        o = torch.einsum("bhn,bhnd->bhd", p, sv[k, :, :, :n].float()).reshape(B, ld)
        xf = xf + _mm(o, bst["wo_s"][k], bst["o_s_scale"][k]) + bst["o_s_bias"][k]

        h = _ln(xf, ln[4], ln[5], eps)
        g = _mm(h, bst["fc1"][k], bst["fc1_scale"][k]) + bst["fc1_bias"][k]
        a = gelu_exact(g)
        xf = xf + _mm(a, bst["fc2"][k], bst["fc2_scale"][k]) + bst["fc2_bias"][k]
    return xf.to(act)


# stacked bridge weight -> prefix of its scale/bias entries
_BRIDGE_PREFIX = {"wq": "q", "wo_c": "o_c", "wqkv": "qkv", "wo_s": "o_s",
                  "fc1": "fc1", "fc2": "fc2"}


def fused_bridge_step(t: int, x, bst: dict, ck, cks, cv, cvs, sk, sv, *,
                      num_heads_cross: int, num_heads_self: int, eps: float):
    """One decode step (position t) through both bridge blocks.

    x: [B, ld] token embeddings. Writes the new self-attention K/V (rounded
    to the cache dtype) into row t of sk/sv in place and returns the bridge
    output [B, ld] in x.dtype. CUDA tensors run csrc/bridge_step.cu (x and
    the self caches bf16) or raise; CPU tensors run the plain version.
    """
    kw = dict(num_heads_cross=num_heads_cross, num_heads_self=num_heads_self, eps=eps)
    if not x.is_cuda:
        return fused_bridge_step_plain(t, x, bst, ck, cks, cv, cvs, sk, sv, **kw)
    B, ld = x.shape
    nb = bst["wq"].shape[0]
    F = 32 * bst["fc1"].shape[1]
    Hc, Hs = num_heads_cross, num_heads_self
    Dc, Ds = ld // Hc, ld // Hs
    Sv, Smax = ck.shape[3], sk.shape[3]
    if not 0 <= t < Smax:
        raise ValueError(f"position {t} outside the {Smax}-row self cache")
    if Dc * Hc != ld or Ds * Hs != ld or Dc % 32 or Ds % 32 or Dc > 1024 or Ds > 1024:
        raise ValueError(f"unsupported head widths Dc={Dc} Ds={Ds}")
    if ld % 128 or F % 128 or ld > 4096:
        raise ValueError(f"widths ld={ld} F={F} must be multiples of 128, ld <= 4096")
    c = cuda_lib.check
    c(x, "x", torch.bfloat16, (B, ld))
    c(bst["lns"], "lns", torch.float32, (nb, 6, ld))
    shapes = {"wq": (ld, ld), "wo_c": (ld, ld), "wqkv": (ld, 3 * ld),
              "wo_s": (ld, ld), "fc1": (ld, F), "fc2": (F, ld)}
    for name, prefix in _BRIDGE_PREFIX.items():
        kin, nout = shapes[name]
        c(bst[name], name, torch.int8, (nb, *frag_shape(kin, nout)))
        for part in ("scale", "bias"):
            key = f"{prefix}_{part}"
            c(bst[key], key, torch.float32, (nb, nout))
    c(ck, "ck", torch.int8, (nb, B, Hc, Sv, Dc))
    c(cv, "cv", torch.int8, (nb, B, Hc, Sv, Dc))
    c(cks, "cks", torch.float32, (nb, B, Hc, Sv))
    c(cvs, "cvs", torch.float32, (nb, B, Hc, Sv))
    c(sk, "sk", torch.bfloat16, (nb, B, Hs, Smax, Ds))
    c(sv, "sv", torch.bfloat16, (nb, B, Hs, Smax, Ds))
    dev = x.device
    x_out = torch.empty(B, ld, dtype=torch.bfloat16, device=dev)
    x32 = torch.empty(B, ld, dtype=torch.float32, device=dev)
    hbuf = torch.empty(2, B, ld, dtype=torch.bfloat16, device=dev)  # split hi | lo
    abuf = torch.empty(2, B, max(ld, F), dtype=torch.bfloat16, device=dev)
    ybuf = torch.empty(B, max(3 * ld, F), dtype=torch.float32, device=dev)
    s = bst
    p = cuda_lib.ptr
    cuda_lib.call(
        "vbt_fused_bridge_step", p(x), p(x_out), p(s["lns"]),
        p(s["wq"]), p(s["q_scale"]), p(s["q_bias"]),
        p(ck), p(cks), p(cv), p(cvs),
        p(s["wo_c"]), p(s["o_c_scale"]), p(s["o_c_bias"]),
        p(s["wqkv"]), p(s["qkv_scale"]), p(s["qkv_bias"]),
        p(sk), p(sv),
        p(s["wo_s"]), p(s["o_s_scale"]), p(s["o_s_bias"]),
        p(s["fc1"]), p(s["fc1_scale"]), p(s["fc1_bias"]),
        p(s["fc2"]), p(s["fc2_scale"]), p(s["fc2_bias"]),
        p(x32), p(hbuf), p(abuf), p(ybuf),
        nb, B, ld, Hc, Hs, Sv, Smax, F, int(t), float(eps))
    fused_bridge_step.launches += 1
    return x_out


fused_bridge_step.launches = 0
