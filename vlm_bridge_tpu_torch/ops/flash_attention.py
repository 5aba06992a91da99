"""Flash attention, forward and backward (port of
vlm_bridge_tpu.ops.flash_attention).

Three CUDA kernels (the forward in csrc/flash_fwd.cu, the two backward
kernels in csrc/flash_bwd.cu) behind three wrappers, `flash_attention_fwd`,
`flash_attention_bwd_dq` and `flash_attention_bwd_dkv`, tied together by a
`torch.autograd.Function`; `flash_attention` keeps the JAX signature. Each
wrapper launches its kernel on CUDA tensors (bf16, head dim 64, 128 or 256)
or raises, takes the plain version on CPU tensors, and counts its launches.
All three read q, k, v (and the backward dout, the dq kernel also out) where
they lie: views of a fused projection included, D contiguous, the other
strides multiples of 16 bytes. The dq kernel also computes delta = sum_d out
* dout and returns it, and the autograd function hands it to the dk/dv
kernel. The plain versions `flash_attention_plain` and
`flash_attention_bwd_plain` are the same recurrence written with
whole-matrix torch ops and the same rounding points (p and ds rounded to the
inputs' dtype before their products, f32 sums).

Feature union: GQA (H % KH == 0), causal masking with the queries taken as
the last T of the S positions, sliding windows, tanh logit soft-capping with
its exact gradient, per-row `kv_lengths` (right padding; tiles past a row's
length are skipped), T != S. A row with empty support gives out = 0 and
lse = -2.3819763e38.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vlm_bridge_tpu_torch.ops import cuda_lib

_NEG_INF = -2.3819763e38
HEAD_DIMS = (64, 128, 256)  # the instantiations csrc/flash_fwd.cu and flash_bwd.cu build


def _scores(q, k, kv_lens, *, scale, is_causal, logit_softcap, sliding_window):
    """Capped logits [B, KH, G, T, S] (f32), d(capped)/d(raw logit), and the
    boolean attend mask, from q [B, T, H, D] and k [B, S, KH, D]."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 1, 3).float()
    logits = torch.einsum("bkgtd,bksd->bkgts", qg, kt) * scale
    if logit_softcap is not None:
        th = torch.tanh(logits / logit_softcap)
        logits = th * logit_softcap
        dcap = 1.0 - th * th
    else:
        dcap = torch.ones_like(logits)
    kpos = torch.arange(S, device=q.device)
    qpos = torch.arange(T, device=q.device) + ((S - T) if is_causal else 0)
    mask = (kpos[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, None, :]
    if is_causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if sliding_window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - sliding_window)
    return logits, dcap, mask.expand_as(logits)


def flash_attention_plain(q, k, v, kv_lens, *, scale, is_causal=False, logit_softcap=None,
                          sliding_window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward: (out [B, T, H, D] in q's dtype, lse [B, H, T] f32)."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    logits, _, mask = _scores(q, k, kv_lens, scale=scale, is_causal=is_causal,
                              logit_softcap=logit_softcap, sliding_window=sliding_window)
    neg = torch.full_like(logits, _NEG_INF)
    m = torch.where(mask, logits, neg).amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros_like(logits))
    denom = p.sum(dim=-1, keepdim=True)
    empty = denom == 0.0
    safe = torch.where(empty, torch.ones_like(denom), denom)
    vt = v.permute(0, 2, 1, 3).float()
    out = torch.einsum("bkgts,bksd->bkgtd", p.to(v.dtype).float(), vt) / safe
    lse = torch.where(empty, torch.full_like(m, _NEG_INF), m + torch.log(safe))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)
    return out, lse.reshape(B, H, T)


def flash_attention_bwd_plain(q, k, v, kv_lens, out, lse, dout, *, scale, is_causal=False,
                              logit_softcap=None, sliding_window=None):
    """Plain backward: (dq, dk, dv) in the inputs' dtypes from the saved
    out and lse, recomputing p = exp(logits - lse)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    logits, dcap, mask = _scores(q, k, kv_lens, scale=scale, is_causal=is_causal,
                                 logit_softcap=logit_softcap, sliding_window=sliding_window)
    lse_g = lse.reshape(B, KH, G, T, 1)
    p = torch.where(mask, torch.exp(torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
                                    - lse_g), torch.zeros_like(logits))
    dog = dout.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4).float()
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4).float()
    kt = k.permute(0, 2, 1, 3).float()
    vt = v.permute(0, 2, 1, 3).float()
    delta = (out.float() * dout.float()).sum(dim=-1)                 # [B, T, H]
    delta = delta.reshape(B, T, KH, G).permute(0, 2, 3, 1)[..., None]
    dv = torch.einsum("bkgts,bkgtd->bksd", p.to(dout.dtype).float(), dog)
    dp = torch.einsum("bkgtd,bksd->bkgts", dog, vt)
    ds = (p * (dp - delta) * dcap * scale).to(q.dtype).float()
    dq = torch.einsum("bkgts,bksd->bkgtd", ds, kt)
    dk = torch.einsum("bkgts,bkgtd->bksd", ds, qg)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)
    return dq, dk.permute(0, 2, 1, 3).to(k.dtype), dv.permute(0, 2, 1, 3).to(v.dtype)


def _dims(q, k):
    """(B, T, S, H, KH, D) of q [B, T, H, D] and k [B, S, KH, D]; raise on a
    head dim no kernel is built for or heads that do not group."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not built (kernels exist for {HEAD_DIMS})")
    if H % KH:
        raise ValueError(f"{H} query heads do not divide into {KH} kv heads")
    return B, T, S, H, KH, D


def _strides(t: torch.Tensor, name: str, shape) -> Tuple[int, int, int]:
    """The (batch, row, head) element strides of a [B, L, NH, D] bf16 CUDA
    tensor a kernel reads in place; raise on what its tensor maps cannot
    take. A dimension of size 1 is never stepped, so its stride is
    given as the packed one."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: expected {torch.bfloat16}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous (stride {t.stride(3)})")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
    B, L, NH, D = shape
    packed = (L * NH * D, NH * D, D)
    out = []
    for dim, size in enumerate((B, L, NH)):
        st = t.stride(dim) if size > 1 else packed[dim]
        if st <= 0 or (st * t.element_size()) % 16:
            raise ValueError(f"{name}: stride {st} of dim {dim} is not a positive multiple "
                             f"of 16 bytes")
        out.append(st)
    return tuple(out)


def _tail(B, T, S, H, KH, D, scale, is_causal, logit_softcap, sliding_window):
    """The scalar arguments every entry point ends with (0 = no window / cap)."""
    return (B, T, S, H, KH, D, int(bool(is_causal)), int(sliding_window or 0),
            float(scale), float(logit_softcap or 0.0))


def flash_attention_fwd(q, k, v, kv_lens, *, scale, is_causal=False, logit_softcap=None,
                        sliding_window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (out [B, T, H, D] contiguous, lse [B, H, T] f32).
    kv_lens [B] int32, <= S. q, k and v may be strided views (see
    `_strides`); nothing is copied."""
    kw = dict(scale=scale, is_causal=is_causal, logit_softcap=logit_softcap,
              sliding_window=sliding_window)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, kv_lens, **kw)
    B, T, S, H, KH, D = _dims(q, k)
    strides = (*_strides(q, "q", (B, T, H, D)), *_strides(k, "k", (B, S, KH, D)),
               *_strides(v, "v", (B, S, KH, D)))
    cuda_lib.check(kv_lens, "kv_lens", torch.int32, (B,))
    out = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_flash_attention_fwd", p(q), p(k), p(v), p(kv_lens), p(out), p(lse),
                  *_tail(B, T, S, H, KH, D, **kw), *strides)
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd_dq(q, k, v, kv_lens, out, lse, dout, *, scale, is_causal=False,
                           logit_softcap=None, sliding_window=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel: (dq [B, T, H, D] contiguous, delta [B, H, T] f32), delta
    = sum_d out * dout, computed by the kernel for the dk/dv kernel. q, k, v,
    out and dout may be strided views (see `_strides`)."""
    kw = dict(scale=scale, is_causal=is_causal, logit_softcap=logit_softcap,
              sliding_window=sliding_window)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, kv_lens, out, lse, dout, **kw)[0], \
            _delta(out, dout)
    dims = _dims(q, k)
    B, T, S, H, KH, D = dims
    strides = (*_strides(q, "q", (B, T, H, D)), *_strides(k, "k", (B, S, KH, D)),
               *_strides(v, "v", (B, S, KH, D)), *_strides(out, "out", (B, T, H, D)),
               *_strides(dout, "dout", (B, T, H, D)))
    cuda_lib.check(kv_lens, "kv_lens", torch.int32, (B,))
    cuda_lib.check(lse, "lse", torch.float32, (B, H, T))
    dq = torch.empty(B, T, H, D, dtype=q.dtype, device=q.device)
    delta = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_flash_attention_bwd_dq", p(q), p(k), p(v), p(out), p(dout), p(lse),
                  p(kv_lens), p(dq), p(delta), *_tail(*dims, **kw), *strides)
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, kv_lens, out, lse, dout, *, scale, is_causal=False,
                            logit_softcap=None, sliding_window=None, delta=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel for (dk, dv) [B, S, KH, D] contiguous; the G query
    heads of a kv head are summed inside the kernel. delta: the dq kernel's,
    else `_delta(out, dout)`. q, k, v and dout may be strided views."""
    kw = dict(scale=scale, is_causal=is_causal, logit_softcap=logit_softcap,
              sliding_window=sliding_window)
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, kv_lens, out, lse, dout, **kw)[1:]
    dims = _dims(q, k)
    B, T, S, H, KH, D = dims
    strides = (*_strides(q, "q", (B, T, H, D)), *_strides(k, "k", (B, S, KH, D)),
               *_strides(v, "v", (B, S, KH, D)), *_strides(dout, "dout", (B, T, H, D)))
    cuda_lib.check(kv_lens, "kv_lens", torch.int32, (B,))
    cuda_lib.check(lse, "lse", torch.float32, (B, H, T))
    if delta is None:
        delta = _delta(out, dout)
    cuda_lib.check(delta, "delta", torch.float32, (B, H, T))
    dk = torch.empty(B, S, KH, D, dtype=k.dtype, device=k.device)
    dv = torch.empty(B, S, KH, D, dtype=v.dtype, device=v.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_flash_attention_bwd_dkv", p(q), p(k), p(v), p(dout), p(lse), p(delta),
                  p(kv_lens), p(dk), p(dv), *_tail(*dims, **kw), *strides)
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0


def _delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta[b, h, t] = sum_d out * dout in f32 (a torch expression, as the
    JAX package leaves it to XLA): the plain version of what the dq kernel
    computes, and the dk/dv kernel's input when no dq kernel ran."""
    return (out.float() * dout.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def _backward(q, k, v, kv_lens, out, lse, dout, kw, need_dq: bool, need_dkv: bool):
    """The kernels' backward: dq first, whose delta the dk/dv kernel gets
    (`_delta` only when dq is not asked for). q, k and v are read as saved;
    dout is copied only when it is not contiguous (an expanded gradient, say)."""
    if not dout.is_contiguous():
        dout = dout.contiguous()
    dq = dk = dv = delta = None
    if need_dq:
        dq, delta = flash_attention_bwd_dq(q, k, v, kv_lens, out, lse, dout, **kw)
    if need_dkv:
        dk, dv = flash_attention_bwd_dkv(q, k, v, kv_lens, out, lse, dout, delta=delta, **kw)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """Counterpart of the JAX package's `_flash_core` custom_vjp: the forward
    saves q, k, v (as given: views stay views), kv_lens, out and lse; the
    backward is the two kernels, reading the saved tensors in place."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, scale, is_causal, logit_softcap, sliding_window):
        kw = dict(scale=scale, is_causal=is_causal, logit_softcap=logit_softcap,
                  sliding_window=sliding_window)
        out, lse = flash_attention_fwd(q, k, v, kv_lens, **kw)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        if not q.is_cuda:  # the plain backward gives all three at once
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, kv_lens, out, lse, dout, **ctx.kw)
        else:
            dq, dk, dv = _backward(q, k, v, kv_lens, out, lse, dout, ctx.kw,
                                   ctx.needs_input_grad[0],
                                   ctx.needs_input_grad[1] or ctx.needs_input_grad[2])
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float,
                    is_causal: bool = False, logit_softcap: Optional[float] = None,
                    sliding_window: Optional[int] = None,
                    kv_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: [B, T, H, D], k/v: [B, S, KH, D] -> [B, T, H, D]. Differentiable.

    kv_lengths: optional [B] int — per-row number of valid keys, assuming
    right padding. Keys at positions >= kv_lengths[b] are masked and their
    tiles are skipped for that row. With is_causal the queries are the last
    T of the S positions."""
    B, S = q.shape[0], k.shape[1]
    if kv_lengths is None:
        kv_lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
    else:
        kv_lens = torch.clamp(kv_lengths.to(torch.int32), max=S)
    return _FlashCore.apply(q, k, v, kv_lens, float(scale), bool(is_causal), logit_softcap,
                            sliding_window)
