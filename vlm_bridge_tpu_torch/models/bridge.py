"""Bridge-Lite adapter (port of vlm_bridge_tpu.models.bridge).

Ported: Xavier `init`, the training `forward` (pre-LN cross attention over
the vision tokens, non-causal or causal text self attention, exact-GELU FFN;
dropout on each attention output and on the FFN's activation and output),
the int8 serving transformation `quantize_decode_params`,
`supports_fused_decode` and the block stacking for
ops.decode_kernels.fused_bridge_step (in this port's own layout), and the
deterministic `debug_forward` with its per-block statistics and
`has_anomaly`.
"""

from __future__ import annotations

from typing import Optional

import torch

from vlm_bridge_tpu_torch.configs import BridgeConfig
from vlm_bridge_tpu_torch.ops.attention import dot_product_attention
from vlm_bridge_tpu_torch.ops.decode_kernels import to_fragments
from vlm_bridge_tpu_torch.ops.layers import gelu_exact, layer_norm, linear
from vlm_bridge_tpu_torch.ops.quant import is_quantized, quantize_int8


def init(cfg: BridgeConfig, *, generator: torch.Generator, dtype=torch.float32,
         device=None) -> dict:
    """Xavier-uniform weights, zero biases, LayerNorm ones/zeros (the JAX
    `init`'s shapes and distributions), drawn from `generator` on `device`."""
    ld, vd = cfg.language_dim, cfg.vision_dim
    ffn = ld * cfg.ffn_mult

    def xavier(fan_in, fan_out):
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand(fan_in, fan_out, generator=generator, device=device)
        return (u * (2 * bound) - bound).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones(ld, dtype=dtype, device=device), "bias": zeros(ld)}

    def attn(kv_dim):
        return {"q": xavier(ld, ld), "q_bias": zeros(ld), "k": xavier(kv_dim, ld),
                "k_bias": zeros(ld), "v": xavier(kv_dim, ld), "v_bias": zeros(ld),
                "o": xavier(ld, ld), "o_bias": zeros(ld)}

    blocks = {}
    for b in range(cfg.num_blocks):
        blocks[str(b)] = {
            "cross": attn(vd), "ln_cross": ln(),
            "self": attn(ld), "ln_self": ln(),
            "ffn": {"fc1": xavier(ld, ffn), "fc1_bias": zeros(ffn),
                    "fc2": xavier(ffn, ld), "fc2_bias": zeros(ld)},
            "ln_ffn": ln(),
        }
    return {"blocks": blocks}


def num_params(params: dict) -> int:
    return sum(p.numel() for p in _leaves(params))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def quantize_decode_params(params: dict) -> dict:
    """Int8 weight-only bridge for serving: cross q/o, fused self q|k|v, self
    o and the FFN become int8 dicts; cross k/v stay float (they run once per
    generation, for the cross cache); biases f32; LayerNorms unchanged."""
    f32 = lambda w: w.float()  # noqa: E731
    blocks = {}
    for name, bp in params["blocks"].items():
        qkv = torch.cat([f32(bp["self"]["q"]), f32(bp["self"]["k"]), f32(bp["self"]["v"])], dim=1)
        blocks[name] = {
            "cross": {
                "q": quantize_int8(bp["cross"]["q"], axis=0), "q_bias": f32(bp["cross"]["q_bias"]),
                "k": bp["cross"]["k"], "k_bias": bp["cross"]["k_bias"],
                "v": bp["cross"]["v"], "v_bias": bp["cross"]["v_bias"],
                "o": quantize_int8(bp["cross"]["o"], axis=0), "o_bias": f32(bp["cross"]["o_bias"]),
            },
            "self": {
                "qkv": quantize_int8(qkv, axis=0),
                "q_bias": f32(bp["self"]["q_bias"]), "k_bias": f32(bp["self"]["k_bias"]),
                "v_bias": f32(bp["self"]["v_bias"]),
                "o": quantize_int8(bp["self"]["o"], axis=0), "o_bias": f32(bp["self"]["o_bias"]),
            },
            "ffn": {
                "fc1": quantize_int8(bp["ffn"]["fc1"], axis=0),
                "fc1_bias": f32(bp["ffn"]["fc1_bias"]),
                "fc2": quantize_int8(bp["ffn"]["fc2"], axis=0),
                "fc2_bias": f32(bp["ffn"]["fc2_bias"]),
            },
            "ln_cross": bp["ln_cross"], "ln_self": bp["ln_self"], "ln_ffn": bp["ln_ffn"],
        }
    return {"blocks": blocks}


def supports_fused_decode(params: dict) -> bool:
    """True when every projection the fused bridge step streams is int8."""
    for bp in params["blocks"].values():
        if not (is_quantized(bp["cross"].get("q")) and is_quantized(bp["cross"].get("o"))
                and is_quantized(bp["self"].get("qkv")) and is_quantized(bp["self"].get("o"))
                and is_quantized(bp["ffn"].get("fc1")) and is_quantized(bp["ffn"].get("fc2"))):
            return False
    return True


def stack_bridge_decode_params(params: dict, cfg: BridgeConfig) -> dict:
    """Block-stack the int8 bridge weights for fused_bridge_step: whole
    [in, out] weights per block (no head-major split) in fragment order
    (ops.decode_kernels.to_fragments), f32 scales/biases."""
    bps = [params["blocks"][str(b)] for b in range(cfg.num_blocks)]

    def stk(get):
        return torch.stack([get(bp) for bp in bps]).contiguous()

    out = {"lns": stk(lambda bp: torch.stack([
        bp["ln_cross"]["scale"], bp["ln_cross"]["bias"],
        bp["ln_self"]["scale"], bp["ln_self"]["bias"],
        bp["ln_ffn"]["scale"], bp["ln_ffn"]["bias"]]).float())}
    # (stacked weight, scale/bias prefix, sub-dict, weight key, bias getter)
    table = (
        ("wq", "q", "cross", "q", lambda bp: bp["cross"]["q_bias"]),
        ("wo_c", "o_c", "cross", "o", lambda bp: bp["cross"]["o_bias"]),
        ("wqkv", "qkv", "self", "qkv", lambda bp: torch.cat(
            [bp["self"]["q_bias"], bp["self"]["k_bias"], bp["self"]["v_bias"]])),
        ("wo_s", "o_s", "self", "o", lambda bp: bp["self"]["o_bias"]),
        ("fc1", "fc1", "ffn", "fc1", lambda bp: bp["ffn"]["fc1_bias"]),
        ("fc2", "fc2", "ffn", "fc2", lambda bp: bp["ffn"]["fc2_bias"]),
    )
    for wname, prefix, sub, key, bias in table:
        out[wname] = stk(lambda bp: to_fragments(bp[sub][key]["w_int8"]))
        out[f"{prefix}_scale"] = stk(lambda bp: bp[sub][key]["scale"].float())
        out[f"{prefix}_bias"] = stk(lambda bp: bias(bp).float())
    return out


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
             train: bool) -> torch.Tensor:
    """Inverted dropout from an explicit generator on x's device. The bits
    are torch's, not jax.random's: the two packages agree in distribution."""
    if not train or rate == 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _w(w, dtype):
    """int8 dicts pass through to `linear`; tensors are cast to the
    activation dtype (the f32 master copy is cast inside the forward, so its
    gradient arrives in f32)."""
    return w if isinstance(w, dict) else w.to(dtype)


def _mha(proj: dict, q_in, kv_in, num_heads: int, dtype, key_mask=None,
         is_causal: bool = False, reference: bool = False) -> torch.Tensor:
    """Projection + attention core of cross and self attention. key_mask:
    optional [B, S] (1 = attendable key), a right-padding prefix mask by the
    loader's contract, so the per-row lengths go along for the flash
    kernels."""
    B, T, _ = q_in.shape
    S = kv_in.shape[1]
    if "qkv" in proj:  # fused self-attention weights of the serving form
        d_model = q_in.shape[-1]
        bias = torch.cat([proj["q_bias"], proj["k_bias"], proj["v_bias"]]).to(dtype)
        q, k, v = linear(q_in, proj["qkv"], bias).chunk(3, dim=-1)
    else:
        d_model = (proj["q"]["w_int8"] if isinstance(proj["q"], dict) else proj["q"]).shape[1]
        q = linear(q_in, _w(proj["q"], dtype), proj["q_bias"].to(dtype))
        k = linear(kv_in, _w(proj["k"], dtype), proj["k_bias"].to(dtype))
        v = linear(kv_in, _w(proj["v"], dtype), proj["v_bias"].to(dtype))
    D = d_model // num_heads
    q = q.reshape(B, T, num_heads, D)
    k = k.reshape(B, S, num_heads, D)
    v = v.reshape(B, S, num_heads, D)
    mask = None
    kv_lengths = None
    if key_mask is not None:
        mask = key_mask[:, None, :].bool()
        kv_lengths = key_mask.sum(dim=-1).to(torch.int32)
    out = dot_product_attention(q, k, v, scale=D ** -0.5, mask=mask, is_causal=is_causal,
                                kv_lengths=kv_lengths, reference=reference)
    return linear(out.reshape(B, T, d_model), _w(proj["o"], dtype), proj["o_bias"].to(dtype))


def forward(params: dict, cfg: BridgeConfig, text_embeddings: torch.Tensor,
            vision_features: torch.Tensor, *, generator: Optional[torch.Generator] = None,
            train: bool = False, text_mask: Optional[torch.Tensor] = None,
            causal: bool = False, reference_attention: bool = False) -> torch.Tensor:
    """Enhanced text embeddings [B, T, language_dim] from text_embeddings
    [B, T, language_dim] and vision_features [B, S, vision_dim].

    Vision attends as global context (no mask). text_mask: optional [B, T]
    pad mask on the self-attention KEYS. causal: causal-mask the text self
    attention (TrainingConfig.bridge_causal). generator takes the place of
    the JAX function's `rng`: dropout runs only with train=True and a
    generator, and draws from it in the order cross, self, FFN activation,
    FFN output of each block."""
    dtype = text_embeddings.dtype
    x = text_embeddings
    vision = vision_features.to(dtype)
    eps = cfg.layer_norm_eps
    drop = lambda h: _dropout(h, cfg.dropout, generator, train)  # noqa: E731

    for b in range(cfg.num_blocks):
        bp = params["blocks"][str(b)]
        h = layer_norm(x, bp["ln_cross"]["scale"], bp["ln_cross"]["bias"], eps)
        x = x + drop(_mha(bp["cross"], h, vision, cfg.num_heads_cross, dtype,
                          reference=reference_attention))

        h = layer_norm(x, bp["ln_self"]["scale"], bp["ln_self"]["bias"], eps)
        x = x + drop(_mha(bp["self"], h, h, cfg.num_heads_self, dtype,
                          key_mask=text_mask, is_causal=causal,
                          reference=reference_attention))

        h = layer_norm(x, bp["ln_ffn"]["scale"], bp["ln_ffn"]["bias"], eps)
        h = linear(h, _w(bp["ffn"]["fc1"], dtype), bp["ffn"]["fc1_bias"].to(dtype))
        h = drop(gelu_exact(h))
        h = drop(linear(h, _w(bp["ffn"]["fc2"], dtype), bp["ffn"]["fc2_bias"].to(dtype)))
        x = x + h
    return x


def _stat(t: torch.Tensor) -> dict:
    f = t.float()
    return {"mean": f.mean(), "std": f.std(correction=0), "abs_max": f.abs().max(),
            "nan_count": torch.isnan(f).sum(), "inf_count": torch.isinf(f).sum()}


@torch.no_grad()
def debug_forward(params: dict, cfg: BridgeConfig, text_embeddings: torch.Tensor,
                  vision_features: torch.Tensor, *,
                  text_mask: Optional[torch.Tensor] = None):
    """Deterministic forward (no dropout) that also returns per-block
    activation statistics, reduced on the device: (output, stats) where
    stats["block_{b}"][stage] for stage in input / after_cross / after_self /
    after_ffn holds 0-dim tensors mean, std (population), abs_max, nan_count
    and inf_count. Attention runs through `_attention_reference` in the
    activation dtype, so f32 works on the card as well as bf16."""
    dtype = text_embeddings.dtype
    x = text_embeddings
    vision = vision_features.to(dtype)
    eps = cfg.layer_norm_eps
    stats = {}
    for b in range(cfg.num_blocks):
        bp = params["blocks"][str(b)]
        s = {"input": _stat(x)}
        h = layer_norm(x, bp["ln_cross"]["scale"], bp["ln_cross"]["bias"], eps)
        x = x + _mha(bp["cross"], h, vision, cfg.num_heads_cross, dtype, reference=True)
        s["after_cross"] = _stat(x)
        h = layer_norm(x, bp["ln_self"]["scale"], bp["ln_self"]["bias"], eps)
        x = x + _mha(bp["self"], h, h, cfg.num_heads_self, dtype, key_mask=text_mask,
                     reference=True)
        s["after_self"] = _stat(x)
        h = layer_norm(x, bp["ln_ffn"]["scale"], bp["ln_ffn"]["bias"], eps)
        h = linear(h, _w(bp["ffn"]["fc1"], dtype), bp["ffn"]["fc1_bias"].to(dtype))
        h = linear(gelu_exact(h), _w(bp["ffn"]["fc2"], dtype), bp["ffn"]["fc2_bias"].to(dtype))
        x = x + h
        s["after_ffn"] = _stat(x)
        stats[f"block_{b}"] = s
    return x, stats


def has_anomaly(stats: dict) -> bool:
    """True if any block's statistics count a NaN or an Inf (one host read
    of all the counts together)."""
    counts = [s[k] for block in stats.values() for s in block.values()
              for k in ("nan_count", "inf_count")]
    return bool(torch.stack(counts).sum() > 0)
