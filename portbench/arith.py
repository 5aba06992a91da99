"""The yardstick's arithmetic: the card's peaks, a bound from bytes and
operations, and the FLOPs and bytes of the port's work computed from the
configuration's shapes (never read from the program).

`bound` and `nbytes` are chip_smoke.py's; the stack step's bytes follow
scripts/decode_gemm_torch.py's count (weights, scales, the activations in and
out, each byte once), extended by the norms and the KV rows a step reads and
writes, and the head's follow scripts/head_torch.py's (table and scales)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
BF16_FLOPS = 989e12           # dense bf16 tensor rate, H100 SXM data sheet


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take for this work, and what sets it."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --- the decoder stack step (decode_kernels.fused_stack_step) --------------

def stack_weights(lm) -> dict:
    """Weight elements of one decoder layer by product."""
    h, d, f = lm.hidden_size, lm.head_dim, lm.intermediate_size
    return {"qkv": h * (lm.num_heads + 2 * lm.num_kv_heads) * d, "o": lm.num_heads * d * h,
            "gate_up": 2 * h * f, "down": f * h}


def stack_step_bytes(lm, batch: int, t: int, mlp_int4: bool = False,
                     group: int | None = None) -> int:
    """Bytes one stack step at position t must move, each once: the int8
    (or, with mlp_int4, int4 MLP) weights and their f32 scales, the four f32
    norms a layer, the K/V rows 0..t-1 read with their f32 scales and row t
    written, the bf16 activations in and out."""
    w = stack_weights(lm)
    h, f, d, kh = lm.hidden_size, lm.intermediate_size, lm.head_dim, lm.num_kv_heads
    attn = w["qkv"] + w["o"] + 4 * ((lm.num_heads + 2 * kh) * d + h)
    if mlp_int4:
        mlp = (w["gate_up"] + w["down"]) // 2
        mlp += 4 * (2 * f * (h // group if group else 1) + h * (f // group if group else 1))
    else:
        mlp = w["gate_up"] + w["down"] + 4 * (2 * f + h)
    norms = 4 * 4 * h
    kv_row = 2 * batch * kh * (d + 4)          # K and V, int8 values + f32 scale
    per_layer = attn + mlp + norms + kv_row * (t + 1)
    return lm.num_layers * per_layer + 2 * 2 * batch * h


def stack_step_flops(lm, batch: int, t: int) -> float:
    """Operations of one stack step: 2 per weight per row, and the
    attention over t + 1 rows (logits and values)."""
    w = sum(stack_weights(lm).values())
    attn = 2 * 2 * lm.num_heads * lm.head_dim * (t + 1)
    return float(lm.num_layers * batch * (2 * w + attn))


# --- model FLOPs, counted once ---------------------------------------------

def vit_flops(v, image_size: int) -> float:
    """Forward FLOPs of the ViT on one image."""
    h, f = v.hidden_size, v.hidden_size * v.mlp_ratio
    n = (image_size // v.patch_size) ** 2
    tokens = n + 1
    per_layer = 2 * tokens * (4 * h * h + 2 * h * f) + 2 * 2 * tokens * tokens * h
    return float(2 * n * v.patch_size ** 2 * v.num_channels * h + v.num_layers * per_layer)


def bridge_token_flops(b, text_tokens: int, vision_tokens: int, causal: bool) -> float:
    """Bridge forward FLOPs over `text_tokens` positions of one sequence,
    without the cross K/V of the vision tokens (`cross_kv_flops`)."""
    ld, f = b.language_dim, b.language_dim * b.ffn_mult
    proj = 2 * text_tokens * (ld * ld + ld * ld + 3 * ld * ld + ld * ld + 2 * ld * f)
    cross = 2 * 2 * text_tokens * vision_tokens * ld
    pairs = text_tokens * (text_tokens + 1) // 2 if causal else text_tokens * text_tokens
    return float(b.num_blocks * (proj + cross + 2 * 2 * pairs * ld))


def cross_kv_flops(b, vision_tokens: int) -> float:
    return float(b.num_blocks * 2 * 2 * vision_tokens * b.vision_dim * b.language_dim)


def decoder_flops(lm, tokens: int, causal_pairs: int) -> float:
    """Decoder forward FLOPs over `tokens` positions of one sequence whose
    attention covers `causal_pairs` (query, key) pairs in each layer."""
    w = sum(stack_weights(lm).values())
    return float(lm.num_layers * (2 * tokens * w + 2 * 2 * causal_pairs * lm.num_heads
                                  * lm.head_dim))


def head_flops(lm, tokens: int) -> float:
    return float(2 * tokens * lm.vocab_size * lm.hidden_size)


def caption_batch_flops(cfg, batch: int, new_tokens: int) -> float:
    """One caption batch: the encode, the cross K/V, then new_tokens decode
    steps of the bridge, the decoder and the head (position t attends to
    t + 1 rows)."""
    vt = cfg.num_vision_tokens
    pairs = new_tokens * (new_tokens + 1) // 2
    per_row = (vit_flops(cfg.vision, cfg.image_size) + cross_kv_flops(cfg.bridge, vt)
               + bridge_token_flops(cfg.bridge, new_tokens, vt, causal=True)
               + decoder_flops(cfg.lm, new_tokens, pairs) + head_flops(cfg.lm, new_tokens))
    return batch * per_row


def train_step_flops(cfg, lengths) -> float:
    """One bridge train step over captions of `lengths` tokens (each row's
    own, not the bucket it is padded to): the frozen ViT forward; the bridge
    forward and backward (3x its forward: activations and weights); the
    frozen decoder forward and its backward through the activations only
    (2x); the head and loss the same (2x). Recompute is not counted."""
    vt = cfg.num_vision_tokens
    total = 0.0
    for n in lengths:
        n = int(n)
        bridge = cross_kv_flops(cfg.bridge, vt) + bridge_token_flops(cfg.bridge, n, vt,
                                                                     causal=False)
        total += (vit_flops(cfg.vision, cfg.image_size) + 3 * bridge
                  + 2 * decoder_flops(cfg.lm, n, n * (n + 1) // 2) + 2 * head_flops(cfg.lm, n))
    return total
