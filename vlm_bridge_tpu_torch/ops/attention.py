"""Attention (port of vlm_bridge_tpu.ops.attention).

`dot_product_attention` is the one entry point of the ViT, the bridge and
Gemma-2: shapes the flash kernels take go to ops.flash_attention, everything
else to the plain `_attention_reference`. Decode attention folds the int8 cache scales into the algebra as
the JAX function does.

`reference=True` is a request, never a fallback: it names
`_attention_reference` for a call whatever its shape. Exact-mode generation
and the bridge's `debug_forward` make it, so that f32 tensors on the card,
which the bf16 flash kernels refuse, run the plain f32 attention.
"""

from __future__ import annotations

from typing import Optional

import torch

from vlm_bridge_tpu_torch.ops import flash_attention as fa

_NEG_INF = -2.3819763e38  # XLA's min bf16-representable f32 fill


def make_position_mask(*, T: int, S: int, is_causal: bool,
                       sliding_window: Optional[int],
                       q_positions: Optional[torch.Tensor],
                       kv_positions: Optional[torch.Tensor],
                       device=None) -> Optional[torch.Tensor]:
    """Boolean [(...,) T, S] mask from causal/window constraints; None if vacuous."""
    if not is_causal and sliding_window is None:
        return None
    if q_positions is None:
        q_positions = torch.arange(T, device=device) + (S - T)
    if kv_positions is None:
        kv_positions = torch.arange(S, device=device)
    qp = q_positions[..., :, None].long()
    kp = kv_positions[..., None, :].long()
    mask = None
    if is_causal:
        mask = kp <= qp
    if sliding_window is not None:
        w = kp > qp - sliding_window
        mask = w if mask is None else (mask & w)
    return mask


def _attention_reference(q, k, v, *, scale, mask=None, is_causal=False,
                         logit_softcap=None, sliding_window=None,
                         q_positions=None, kv_positions=None):
    """q: [B, T, H, D]; k/v: [B, S, KH, D] (GQA). Softmax in f32."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    qg = q.reshape(B, T, KH, G, D).permute(0, 2, 3, 1, 4)  # [B,KH,G,T,D]
    kt = k.permute(0, 2, 1, 3)  # [B, KH, S, D]
    vt = v.permute(0, 2, 1, 3)
    logits = torch.einsum("bkgtd,bksd->bkgts", qg.float(), kt.float()) * scale
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    pos_mask = make_position_mask(
        T=T, S=S, is_causal=is_causal, sliding_window=sliding_window,
        q_positions=q_positions, kv_positions=kv_positions, device=q.device)
    full_mask = None
    if mask is not None:
        m = mask
        if m.dim() == 2:
            m = m[None, None]
        elif m.dim() == 3:
            m = m[:, None]
        if m.shape[1] == H and H != 1:
            m = m.reshape(m.shape[0], KH, G, T, S)
        else:
            m = m[:, :, None]
        full_mask = m
    if pos_mask is not None:
        pm = pos_mask[None, None, None] if pos_mask.dim() == 2 else pos_mask[:, None, None]
        full_mask = pm if full_mask is None else (full_mask & pm)
    if full_mask is not None:
        logits = torch.where(full_mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgts,bksd->bkgtd", probs, vt.to(q.dtype))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


def dot_product_attention(q, k, v, *, scale: Optional[float] = None,
                          mask=None, is_causal: bool = False,
                          logit_softcap: Optional[float] = None,
                          sliding_window: Optional[int] = None,
                          q_positions=None, kv_positions=None,
                          kv_lengths=None, reference: bool = False) -> torch.Tensor:
    """Multi-head scaled dot-product attention (arguments as in the JAX
    package: q [B, T, H, D], k/v [B, S, KH, D], mask True = attend).

    The gate is by what the call states, never by a failure. A head dim the
    kernels are built for, no explicit positions, and a mask that is absent
    or restated as `kv_lengths` (a right-padding prefix mask, by the
    callers' contract) go to the flash function: on CUDA tensors its
    kernels, which take bf16 and raise on another dtype or if they cannot
    build or launch; on CPU tensors the kernels' plain versions through the
    same autograd function. Everything else (another head dim, a dense mask,
    explicit positions) takes `_attention_reference`, which applies `mask`
    exactly and ignores `kv_lengths`. reference=True asks for
    `_attention_reference` whatever the shape."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not reference and flash_supported(q, mask=mask, q_positions=q_positions,
                                         kv_positions=kv_positions, kv_lengths=kv_lengths):
        return fa.flash_attention(q, k, v, scale=scale, is_causal=is_causal,
                                  logit_softcap=logit_softcap, sliding_window=sliding_window,
                                  kv_lengths=kv_lengths)
    return _attention_reference(
        q, k, v, scale=scale, mask=mask, is_causal=is_causal,
        logit_softcap=logit_softcap, sliding_window=sliding_window,
        q_positions=q_positions, kv_positions=kv_positions)


def flash_supported(q, *, mask, q_positions, kv_positions, kv_lengths) -> bool:
    """The shape gate of `dot_product_attention` (see there)."""
    if q.shape[-1] not in fa.HEAD_DIMS:
        return False
    if q_positions is not None or kv_positions is not None:
        return False
    return mask is None or kv_lengths is not None


def decode_attention(q, k_cache, v_cache, cache_len, *, scale: float,
                     logit_softcap: Optional[float] = None,
                     window_start=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Single-token attention against a preallocated cache.

    q: [B, 1, H, D]; k_cache/v_cache: [B, Smax, KH, D]; cache_len: [B], []
    or int. k_scale/v_scale [B, Smax, KH]: per-key-vector dequant scales of
    an int8 cache, folded into the logits and the probabilities."""
    B, _, H, D = q.shape
    Smax, KH = k_cache.shape[1], k_cache.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1)[:, :, None, :]
    if logit_softcap is not None:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    pos = torch.arange(Smax, device=q.device)[None, :]
    valid = pos < torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    if window_start is not None:
        valid = valid & (pos >= torch.as_tensor(window_start, device=q.device).reshape(-1, 1))
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, :]
    else:
        probs = probs.to(q.dtype).float()
    out = torch.einsum("bkgs,bskd->bkgd", probs, v_cache.float())
    return out.to(q.dtype).reshape(B, 1, H, D)
