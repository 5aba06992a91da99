"""Batched greedy caption generation, fast mode (port of
vlm_bridge_tpu.inference.generate).

The image is encoded once and each bridge block's cross-attention K/V are
computed once; then a Python loop over preallocated caches runs, per token:
embed the last token -> both bridge blocks (causal self cache) -> every
Gemma layer against the int8 KV cache -> the greedy int8 head. The caches
are updated in place. On CUDA tensors the three per-token stages run the
port's kernels (ops.decode_kernels, ops.quant.int8_matmul_t_argmax).

Ported: the int8 serving recipe (int8 LM layers and embedding, int8 KV
cache, greedy). Exact mode, sampling, the jnp-int8/bf16 LM decode and
meshes are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from vlm_bridge_tpu_torch.configs import BridgeConfig, VLMConfig
from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
from vlm_bridge_tpu_torch.ops import decode_kernels, quant
from vlm_bridge_tpu_torch.ops.attention import decode_attention
from vlm_bridge_tpu_torch.ops.layers import gelu_exact, layer_norm, linear


@dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 50          # max new tokens
    greedy: bool = False          # False (sampling) is not ported yet
    exact: bool = False           # reference-parity mode: not ported yet
    early_stop: bool = False      # stop once every row has emitted EOS
    kv_quant: bool = False        # int8 Gemma KV cache (required here)
    force_plain: bool = False     # run the plain PyTorch versions of the
                                  # decode kernels on any device: the
                                  # reference path the kernels are compared
                                  # with on the card


class BridgeCache(NamedTuple):
    """Bridge decode caches (this port's layout, updated in place):
    self_k/self_v [nb, B, Hs, L, Ds] in the activation dtype; cross_k/
    cross_v [nb, B, Hc, Sv, Dc] (int8 with kv_quant) with scales
    [nb, B, Hc, Sv] f32."""

    self_k: torch.Tensor
    self_v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    cross_k_scale: Optional[torch.Tensor] = None
    cross_v_scale: Optional[torch.Tensor] = None


def resolve_activation_dtype(activation_dtype, gen: GenerationConfig):
    """None -> bf16 for fast serving, f32 for exact mode."""
    if activation_dtype is not None:
        return activation_dtype
    return torch.float32 if gen.exact else torch.bfloat16


def _eos_lengths(tokens: torch.Tensor, eos_id: int) -> torch.Tensor:
    """Per-row caption length = index of the first EOS (or full length)."""
    return (torch.cumsum((tokens == eos_id).int(), dim=1) == 0).sum(dim=1)


def _w(w, dtype):
    return w if isinstance(w, dict) else w.to(dtype)


def _build_cross_cache(bridge_params, cfg: BridgeConfig, vision: torch.Tensor,
                       max_len: int, dtype, kv_quant: bool = False) -> BridgeCache:
    """Cross-attention K/V of every block from the vision features (a plain
    matmul in `dtype`, as the JAX package leaves it to XLA), quantized per
    vector with kv_quant; zeroed self caches of max_len rows."""
    B, S, _ = vision.shape
    Hc, Hs = cfg.num_heads_cross, cfg.num_heads_self
    Dc, Ds = cfg.language_dim // Hc, cfg.language_dim // Hs
    ks, vs = [], []
    for b in range(cfg.num_blocks):
        cp = bridge_params["blocks"][str(b)]["cross"]
        k = linear(vision, cp["k"].to(dtype), cp["k_bias"].to(dtype))
        v = linear(vision, cp["v"].to(dtype), cp["v_bias"].to(dtype))
        ks.append(k.reshape(B, S, Hc, Dc).transpose(1, 2))
        vs.append(v.reshape(B, S, Hc, Dc).transpose(1, 2))
    cross_k = torch.stack(ks).contiguous()
    cross_v = torch.stack(vs).contiguous()
    ck_scale = cv_scale = None
    if kv_quant:
        cross_k, ck_scale = gemma2.quantize_kv(cross_k)
        cross_v, cv_scale = gemma2.quantize_kv(cross_v)
    shape = (cfg.num_blocks, B, Hs, max_len, Ds)
    return BridgeCache(
        self_k=torch.zeros(shape, dtype=dtype, device=vision.device),
        self_v=torch.zeros(shape, dtype=dtype, device=vision.device),
        cross_k=cross_k, cross_v=cross_v,
        cross_k_scale=ck_scale, cross_v_scale=cv_scale)


def _bridge_decode_step(bridge_params, cfg: BridgeConfig, cache: BridgeCache,
                        embed_t: torch.Tensor, t: int) -> Tuple[torch.Tensor, BridgeCache]:
    """Plain bridge forward for ONE new position t (embed_t [B, 1, ld]) over
    plain or int8-dict params; writes the self-cache row t in place."""
    dtype = embed_t.dtype
    B = embed_t.shape[0]
    ld = cfg.language_dim
    Hc, Hs = cfg.num_heads_cross, cfg.num_heads_self
    Dc, Ds = ld // Hc, ld // Hs
    eps = cfg.layer_norm_eps
    x = embed_t
    for b in range(cfg.num_blocks):
        bp = bridge_params["blocks"][str(b)]
        h = layer_norm(x, bp["ln_cross"]["scale"], bp["ln_cross"]["bias"], eps)
        q = linear(h, _w(bp["cross"]["q"], dtype), bp["cross"]["q_bias"].to(dtype))
        scale_k = None if cache.cross_k_scale is None else cache.cross_k_scale[b].transpose(1, 2)
        scale_v = None if cache.cross_v_scale is None else cache.cross_v_scale[b].transpose(1, 2)
        attn = decode_attention(
            q.reshape(B, 1, Hc, Dc), cache.cross_k[b].transpose(1, 2),
            cache.cross_v[b].transpose(1, 2), cache.cross_k.shape[3],
            scale=Dc ** -0.5, k_scale=scale_k, v_scale=scale_v)
        x = x + linear(attn.reshape(B, 1, ld), _w(bp["cross"]["o"], dtype),
                       bp["cross"]["o_bias"].to(dtype))

        h = layer_norm(x, bp["ln_self"]["scale"], bp["ln_self"]["bias"], eps)
        sp = bp["self"]
        if "qkv" in sp:
            bias = torch.cat([sp["q_bias"], sp["k_bias"], sp["v_bias"]]).to(dtype)
            q, k, v = linear(h, sp["qkv"], bias).split(ld, dim=-1)
        else:
            q = linear(h, _w(sp["q"], dtype), sp["q_bias"].to(dtype))
            k = linear(h, _w(sp["k"], dtype), sp["k_bias"].to(dtype))
            v = linear(h, _w(sp["v"], dtype), sp["v_bias"].to(dtype))
        cache.self_k[b, :, :, t] = k.reshape(B, Hs, Ds).to(cache.self_k.dtype)
        cache.self_v[b, :, :, t] = v.reshape(B, Hs, Ds).to(cache.self_v.dtype)
        attn = decode_attention(
            q.reshape(B, 1, Hs, Ds), cache.self_k[b].transpose(1, 2),
            cache.self_v[b].transpose(1, 2), t + 1, scale=Ds ** -0.5)
        x = x + linear(attn.reshape(B, 1, ld), _w(sp["o"], dtype), sp["o_bias"].to(dtype))

        h = layer_norm(x, bp["ln_ffn"]["scale"], bp["ln_ffn"]["bias"], eps)
        fp = bp["ffn"]
        if isinstance(fp["fc1"], dict):
            g = linear(h.float(), fp["fc1"]) + fp["fc1_bias"].float()
            y = linear(gelu_exact(g).to(dtype).float(), fp["fc2"]) + fp["fc2_bias"].float()
            h = y.to(dtype)
        else:
            h = linear(h, fp["fc1"].to(dtype), fp["fc1_bias"].to(dtype))
            h = linear(gelu_exact(h), fp["fc2"].to(dtype), fp["fc2_bias"].to(dtype))
        x = x + h
    return x, cache


def _check_supported(params, cfg: VLMConfig, gen: GenerationConfig) -> None:
    if gen.exact:
        raise NotImplementedError("exact generation mode is not ported yet")
    if not gen.greedy:
        raise NotImplementedError("sampled decoding is not ported yet (use greedy=True)")
    if not gen.kv_quant:
        raise NotImplementedError("only the int8 KV cache decode is ported (kv_quant=True)")
    lm = params["lm"]
    if not quant.is_quantized(lm["embedding"]):
        raise NotImplementedError("only the int8 greedy head is ported "
                                  "(quantize the embedding)")
    if "stacked_decode" not in lm and not gemma2.supports_fused_decode(
            lm, cfg.lm, gen.max_length + 1):
        raise NotImplementedError(
            "only the fused int8 stack decode is ported: the LM layers must be "
            "int8 (quantize mlp,attn) and the cache rows "
            f"{gemma2.fused_cache_rows(gen.max_length + 1)} must fit "
            f"sliding_window={cfg.lm.sliding_window}")


@torch.no_grad()
def _generate_fast(params, cfg: VLMConfig, vision: torch.Tensor, gen: GenerationConfig,
                   activation_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    B = vision.shape[0]
    L = gen.max_length + 1  # BOS + generated
    lm_cfg, br_cfg = cfg.lm, cfg.bridge
    dev = vision.device
    vision = vision.to(activation_dtype)

    def cast(p):
        if isinstance(p, dict):
            return {k: cast(v) for k, v in p.items()}
        return p.to(activation_dtype) if (p.dim() >= 2 and p.is_floating_point()) else p

    bridge_params = cast(params["bridge"])
    bridge_cache = _build_cross_cache(bridge_params, br_cfg, vision, L, activation_dtype,
                                      kv_quant=gen.kv_quant)
    use_fused_bridge = bridge.supports_fused_decode(bridge_params)
    if use_fused_bridge:
        bst = bridge.stack_bridge_decode_params(bridge_params, br_cfg)
        bridge_step = (decode_kernels.fused_bridge_step_plain if gen.force_plain
                       else decode_kernels.fused_bridge_step)
    lm = params["lm"]
    stacked = lm.get("stacked_decode")
    if stacked is None:
        stacked = gemma2.stack_decode_params(lm, lm_cfg)
    kv = gemma2.StackedKVCache.zeros(lm_cfg, B, L, device=dev)
    head = (quant.int8_matmul_t_argmax_plain if gen.force_plain
            else quant.int8_matmul_t_argmax)

    bos = torch.full((B,), lm_cfg.bos_token_id, dtype=torch.int32, device=dev)
    toks = torch.full((B, gen.max_length), lm_cfg.pad_token_id, dtype=torch.int32, device=dev)
    tok, done = bos, torch.zeros(B, dtype=torch.bool, device=dev)
    for t in range(gen.max_length):
        if gen.early_stop and bool(done.all()):
            break
        emb = gemma2.embed(lm, tok.long()[:, None]).to(activation_dtype)
        if use_fused_bridge:
            x = bridge_step(
                t, emb[:, 0].contiguous(), bst, bridge_cache.cross_k,
                bridge_cache.cross_k_scale, bridge_cache.cross_v, bridge_cache.cross_v_scale,
                bridge_cache.self_k, bridge_cache.self_v,
                num_heads_cross=br_cfg.num_heads_cross,
                num_heads_self=br_cfg.num_heads_self, eps=br_cfg.layer_norm_eps)
            bridged = x[:, None, :]
        else:
            bridged, bridge_cache = _bridge_decode_step(bridge_params, br_cfg, bridge_cache,
                                                        emb, t)
        hidden, kv = gemma2.decode_step_stacked(lm, lm_cfg, stacked, bridged, kv, t,
                                                plain=gen.force_plain)
        nxt = head(hidden[:, 0].contiguous(), lm["embedding"])
        nxt = torch.where(done, torch.full_like(nxt, lm_cfg.pad_token_id), nxt)
        done = done | (nxt == lm_cfg.eos_token_id)
        toks[:, t] = nxt
        tok = nxt
    tokens = torch.cat([bos[:, None], toks], dim=1)
    return tokens, _eos_lengths(tokens, lm_cfg.eos_token_id)


def generate_tokens(params, cfg: VLMConfig, *, pixel_values: Optional[torch.Tensor] = None,
                    vision_features: Optional[torch.Tensor] = None,
                    gen: GenerationConfig = GenerationConfig(),
                    activation_dtype=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate caption tokens greedily.

    Returns (tokens [B, max_length+1] int32 incl. BOS, lengths [B] = index
    of the first EOS or the full length). Rows that emitted EOS are padded
    with pad_token_id afterwards. Runs on the device of the inputs."""
    activation_dtype = resolve_activation_dtype(activation_dtype, gen)
    _check_supported(params, cfg, gen)
    if vision_features is None:
        vision_features = full_model.encode_image(params, cfg, pixel_values)
    return _generate_fast(params, cfg, vision_features, gen, activation_dtype)
