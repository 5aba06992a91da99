"""Gemma-2 decoder (port of vlm_bridge_tpu.models.gemma2).

Ported: random `init`, `embed`, the int8 serving transformation
(`quantize_params` / `quantize_layer` / `quantize_embedding_part`), the KV
quantizer, the whole-stack greedy decode step (`stack_decode_params`,
`StackedKVCache`, `decode_step_stacked`) over ops.decode_kernels, and the
full-sequence training forward (`forward_hidden` with per-layer
recomputation, `logits_from_hidden`, `forward`) over float weights. Prefill,
the int8 MLP kernel and the jnp-int8 per-layer decode are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vlm_bridge_tpu_torch.configs import Gemma2Config
from vlm_bridge_tpu_torch.ops import decode_kernels
from vlm_bridge_tpu_torch.ops.attention import dot_product_attention
from vlm_bridge_tpu_torch.ops.layers import (apply_rope, gelu_tanh, linear, rms_norm, rope_table,
                                             softcap)
from vlm_bridge_tpu_torch.ops.quant import int8_matmul_t, is_quantized, quantize_int8


def fused_cache_rows(n_tokens: int) -> int:
    """Cache rows the fused decode allocates for n_tokens (64-row rounded,
    as in the JAX package, so the sliding-window precondition is the same
    on both sides)."""
    return ((n_tokens + 63) // 64) * 64


def supports_fused_decode(params: dict, cfg: Gemma2Config, max_len: int) -> bool:
    """Fully int8 layers (fused qkv + o + mlp dicts) and a cache that fits
    inside every sliding window (the kernels do not mask windows)."""
    if fused_cache_rows(max_len) > cfg.sliding_window:
        return False
    for lp in params["layers"].values():
        attn, mlp = lp["attn"], lp["mlp"]
        if not (is_quantized(attn.get("qkv")) and is_quantized(attn.get("o"))):
            return False
        if not all(is_quantized(mlp[k]) for k in ("gate", "up", "down")):
            return False
    return True


class StackedKVCache(NamedTuple):
    """Layer-stacked int8 decode cache: K/V [L, B, KH, S, D] int8, per-vector
    scales [L, B, KH, S] f32 (this port's layout; updated in place)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor
    v_scale: torch.Tensor

    @staticmethod
    def zeros(cfg: Gemma2Config, batch: int, max_len: int, device=None) -> "StackedKVCache":
        S = fused_cache_rows(max_len)
        shape = (cfg.num_layers, batch, cfg.num_kv_heads, S, cfg.head_dim)
        return StackedKVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            k_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        )


def stack_decode_params(params: dict, cfg: Gemma2Config) -> dict:
    """Layer-stack the int8 decoder weights in the layout of
    ops.decode_kernels.fused_stack_step (int8 layers only; weights in
    fragment order, decode_kernels.to_fragments)."""
    lps = [params["layers"][str(i)] for i in range(cfg.num_layers)]
    frag = decode_kernels.to_fragments

    def stk(get):
        return torch.stack([get(lp) for lp in lps]).contiguous()

    mlp = lambda lp, k: lp["mlp"][k]  # noqa: E731
    return {
        "wqkv": stk(lambda lp: frag(lp["attn"]["qkv"]["w_int8"])),
        "qkv_scale": stk(lambda lp: lp["attn"]["qkv"]["scale"].float()),
        "wo": stk(lambda lp: frag(lp["attn"]["o"]["w_int8"])),
        "o_scale": stk(lambda lp: lp["attn"]["o"]["scale"].float()),
        "wgu": stk(lambda lp: frag(torch.cat([mlp(lp, "gate")["w_int8"],
                                              mlp(lp, "up")["w_int8"]], dim=1))),
        "gu_scale": stk(lambda lp: torch.cat([mlp(lp, "gate")["scale"],
                                              mlp(lp, "up")["scale"]]).float()),
        "wd": stk(lambda lp: frag(mlp(lp, "down")["w_int8"])),
        "d_scale": stk(lambda lp: mlp(lp, "down")["scale"].float()),
        "norms": stk(lambda lp: torch.stack([
            lp["input_norm"], lp["post_attn_norm"],
            lp["pre_ffn_norm"], lp["post_ffn_norm"]]).float()),
    }


def decode_step_stacked(params: dict, cfg: Gemma2Config, stacked: dict,
                        token_embeds: torch.Tensor, cache: StackedKVCache,
                        position: int, *, plain: bool = False
                        ) -> Tuple[torch.Tensor, StackedKVCache]:
    """Lockstep decode step at `position` through the whole stack.

    token_embeds: [B, 1, H] raw (bridged) embeddings. The √H normalizer is
    cast to the activation dtype before the multiply, as in the JAX package.
    plain=True pins the plain PyTorch stack step on any device (the
    reference the kernel is compared with on the card).
    Returns (final-normed hidden [B, 1, H], cache updated in place)."""
    t = int(position)
    dev = token_embeds.device
    cos, sin = rope_table(torch.tensor([t], device=dev), cfg.head_dim, cfg.rope_theta)
    normalizer = torch.tensor(cfg.hidden_size ** 0.5, dtype=token_embeds.dtype, device=dev)
    x = (token_embeds * normalizer)[:, 0].contiguous()
    step = (decode_kernels.fused_stack_step_plain if plain
            else decode_kernels.fused_stack_step)
    x_out = step(
        t, x, stacked, cache.k, cache.v, cache.k_scale, cache.v_scale,
        cos[0].contiguous(), sin[0].contiguous(),
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, attn_scale=cfg.attn_scale,
        softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
    hidden = rms_norm(x_out[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    return hidden, cache


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 over the trailing dim:
    x [..., D] -> (int8 [..., D], f32 scale [...])."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.round(xf / scale[..., None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def init(cfg: Gemma2Config, *, generator: torch.Generator, dtype=torch.bfloat16,
         device=None) -> dict:
    """Random init with the JAX `init`'s shapes and distributions (weights
    N(0, 0.02), zero-centred norms), drawn from `generator` on `device`."""
    h, hd = cfg.hidden_size, cfg.head_dim

    def dense(fan_in, fan_out):
        return (torch.randn(fan_in, fan_out, generator=generator, device=device) * 0.02).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "input_norm": zeros(h), "post_attn_norm": zeros(h),
            "pre_ffn_norm": zeros(h), "post_ffn_norm": zeros(h),
            "attn": {"q": dense(h, cfg.num_heads * hd), "k": dense(h, cfg.num_kv_heads * hd),
                     "v": dense(h, cfg.num_kv_heads * hd), "o": dense(cfg.num_heads * hd, h)},
            "mlp": {"gate": dense(h, cfg.intermediate_size),
                    "up": dense(h, cfg.intermediate_size),
                    "down": dense(cfg.intermediate_size, h)},
        }
    emb = (torch.randn(cfg.vocab_size, h, generator=generator, device=device) * 0.02).to(dtype)
    return {"embedding": emb, "final_norm": zeros(h), "layers": layers}


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Raw (un-normalized) embedding lookup. An int8 table dequantizes only
    the gathered rows, in f32."""
    E = params["embedding"]
    if isinstance(E, dict):
        return E["w_int8"][input_ids].float() * E["scale"][input_ids][..., None]
    return E[input_ids]


def _qkv_proj(attn: dict, x: torch.Tensor, cfg: Gemma2Config):
    """Project to (q, k, v) heads; int8 params may carry a fused "qkv"."""
    B, T = x.shape[0], x.shape[1]
    H, D, KH = cfg.num_heads, cfg.head_dim, cfg.num_kv_heads
    if "qkv" in attn:
        y = linear(x, attn["qkv"])
        q, k, v = y[..., :H * D], y[..., H * D:(H + KH) * D], y[..., (H + KH) * D:]
    else:
        q, k, v = linear(x, attn["q"]), linear(x, attn["k"]), linear(x, attn["v"])
    return q.reshape(B, T, H, D), k.reshape(B, T, KH, D), v.reshape(B, T, KH, D)


def _attention_block(lp: dict, cfg: Gemma2Config, x: torch.Tensor, layer_idx: int, *,
                     cos, sin, attn_mask, positions, kv_lengths=None) -> torch.Tensor:
    """positions=None means "queries are the trailing T of S positions", the
    convention the attention op and the flash kernels assume. kv_lengths:
    per-row valid key counts when attn_mask is a right-padding prefix mask
    (it lets padded training shapes take the flash kernels)."""
    B, T, H, D = x.shape[0], x.shape[1], cfg.num_heads, cfg.head_dim
    q, k, v = _qkv_proj(lp["attn"], x, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    window = cfg.sliding_window if cfg.layer_is_sliding(layer_idx) else None
    out = dot_product_attention(
        q, k, v, scale=cfg.attn_scale, mask=attn_mask, is_causal=True,
        logit_softcap=cfg.attn_logit_softcap, sliding_window=window,
        q_positions=positions, kv_positions=positions, kv_lengths=kv_lengths)
    return linear(out.reshape(B, T, H * D), lp["attn"]["o"])


def _mlp_block(lp: dict, x: torch.Tensor) -> torch.Tensor:
    if is_quantized(lp["mlp"]["gate"]):
        raise NotImplementedError(
            "the int8 GeGLU MLP kernel (int8_mlp) is not ported yet: ROADMAP.md, "
            "kernels still to be ported, vlm_bridge_tpu/ops/quant.py:int8_mlp")
    gate = gelu_tanh(linear(x, lp["mlp"]["gate"]))
    up = linear(x, lp["mlp"]["up"])
    return linear(gate * up, lp["mlp"]["down"])


def _layer(lp: dict, cfg: Gemma2Config, x: torch.Tensor, layer_idx: int, cos, sin,
           attn_mask, positions, kv_lengths=None) -> torch.Tensor:
    eps = cfg.rms_norm_eps
    h = rms_norm(x, lp["input_norm"], eps)
    h = _attention_block(lp, cfg, h, layer_idx, cos=cos, sin=sin, attn_mask=attn_mask,
                         positions=positions, kv_lengths=kv_lengths)
    x = x + rms_norm(h, lp["post_attn_norm"], eps)
    h = rms_norm(x, lp["pre_ffn_norm"], eps)
    h = _mlp_block(lp, h)
    return x + rms_norm(h, lp["post_ffn_norm"], eps)


def forward_hidden(params: dict, cfg: Gemma2Config, inputs_embeds: torch.Tensor, *,
                   attn_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   remat: bool = False) -> torch.Tensor:
    """Full-sequence forward from embeddings to final-norm hidden states.

    inputs_embeds: [B, T, H] RAW embeddings (the sqrt-hidden normalizer is
    applied here, cast to the activation dtype first). attn_mask: [B, T]
    with 1 = real token; pads are masked from keys. remat=True recomputes
    each layer in the backward (torch.utils.checkpoint) instead of keeping
    its activations. Returns hidden [B, T, H]."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    default_positions = positions is None
    if default_positions:
        positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)

    normalizer = torch.tensor(cfg.hidden_size ** 0.5, dtype=inputs_embeds.dtype, device=dev)
    x = inputs_embeds * normalizer

    key_mask = None
    kv_lengths = None
    if attn_mask is not None:
        key_mask = attn_mask[:, None, :].bool()  # [B, 1(q), S]
        # right-padding prefix masks by contract, so the per-row length says
        # the same and qualifies padded shapes for the flash kernels
        kv_lengths = attn_mask.sum(dim=-1).to(torch.int32)
    attn_positions = None if default_positions else positions

    for i in range(cfg.num_layers):
        args = (params["layers"][str(i)], cfg, x, i, cos, sin, key_mask, attn_positions,
                kv_lengths)
        if remat and torch.is_grad_enabled():
            # no random draw inside a layer, so no generator state to carry
            x = checkpoint(_layer, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(*args)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


class _HeadProduct(torch.autograd.Function):
    """hidden [N, H] @ table[V, H].T on the card with the f32 accumulator
    kept as the output (the JAX package's preferred_element_type=f32; a
    plain matmul of bf16 operands rounds every logit to bf16 first). The
    backward takes the cotangent in the operands' dtype, as autograd does
    behind a cast."""

    @staticmethod
    def forward(ctx, hidden, table):
        ctx.save_for_backward(hidden, table)
        return torch.mm(hidden, table.T, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        hidden, table = ctx.saved_tensors
        grad = grad.to(hidden.dtype)
        d_hidden = torch.mm(grad, table) if ctx.needs_input_grad[0] else None
        d_table = torch.mm(grad.T, hidden) if ctx.needs_input_grad[1] else None
        return d_hidden, d_table


def logits_from_hidden(params: dict, cfg: Gemma2Config, hidden: torch.Tensor) -> torch.Tensor:
    """Tied lm_head + final softcap, f32 output."""
    E = params["embedding"]
    B, T, H = hidden.shape
    if isinstance(E, dict):
        logits = int8_matmul_t(hidden.reshape(B * T, H), E).reshape(B, T, -1)
    elif hidden.is_cuda and hidden.dtype != torch.float32:
        logits = _HeadProduct.apply(hidden.reshape(B * T, H), E.to(hidden.dtype))
        logits = logits.reshape(B, T, -1)
    else:
        logits = torch.matmul(hidden, E.to(hidden.dtype).T).float()
    if cfg.final_logit_softcap is not None:
        logits = softcap(logits, cfg.final_logit_softcap)
    return logits


def forward(params: dict, cfg: Gemma2Config, *, input_ids: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None,
            attn_mask: Optional[torch.Tensor] = None, remat: bool = False) -> torch.Tensor:
    """Full forward to [B, T, V] logits (f32)."""
    if inputs_embeds is None:
        inputs_embeds = embed(params, input_ids)
    hidden = forward_hidden(params, cfg, inputs_embeds, attn_mask=attn_mask, remat=remat)
    return logits_from_hidden(params, cfg, hidden)


def quantize_embedding_part(emb: torch.Tensor, parts: Tuple[str, ...]):
    """Quantize the tied embedding per `parts` (int8 per vocab row)."""
    if "embedding4" in parts:
        raise NotImplementedError("int4 embedding not ported yet")
    if "embedding" in parts:
        return quantize_int8(emb, axis=1)
    return emb


def quantize_layer(lp: dict, parts: Tuple[str, ...]) -> dict:
    """Quantize one decoder layer: q/k/v fuse into one [H, (NH+2KH)D] int8
    weight; per-output-channel scales; norms unchanged."""
    out = {k: lp[k] for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm")}
    if "attn" in parts:
        qkv = torch.cat([lp["attn"]["q"], lp["attn"]["k"], lp["attn"]["v"]], dim=1).float()
        out["attn"] = {"qkv": quantize_int8(qkv, axis=0),
                       "o": quantize_int8(lp["attn"]["o"], axis=0)}
    else:
        out["attn"] = lp["attn"]
    out["mlp"] = ({k: quantize_int8(v, axis=0) for k, v in lp["mlp"].items()}
                  if "mlp" in parts else lp["mlp"])
    return out


def quantize_params(params: dict, parts: Tuple[str, ...] = ("embedding", "mlp", "attn")) -> dict:
    """Int8 weight-only quantization of the frozen decoder for serving."""
    unknown = set(parts) - {"embedding", "embedding4", "mlp", "attn"}
    if unknown:
        raise ValueError(f"unknown quantize parts: {sorted(unknown)} "
                         f"(valid: embedding, embedding4, mlp, attn)")
    return {
        "embedding": quantize_embedding_part(params["embedding"], parts),
        "final_norm": params["final_norm"],
        "layers": {name: quantize_layer(lp, parts) for name, lp in params["layers"].items()},
    }
