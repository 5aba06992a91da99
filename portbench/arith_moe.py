"""The yardstick's arithmetic of a decoder with routed experts, from the
configuration's shapes (never read from the program): the stack step's bytes
and operations, the expert products' and the routing's alone, and a caption
batch's model FLOPs. `lm` is the port's Gemma2MoEConfig.

Bytes count what a step must move once. The experts' weights count only for
the experts some row routes to; under uniform routing of B rows, k of E
each, an expert is touched with probability 1 - (1 - k/E)^B, so a layer
reads E (1 - (1 - k/E)^B) experts (at B 64, k 8, E 64: 63.99 of 64). This
assumes uniform routing: a skewed router touches fewer experts a step (the
cell's seeded router does: PERF.md gives the probe's count), so the bound
then credits the expert products with more bytes than the traffic needs,
while the port's products read every expert regardless. The operations
count each row's k experts (what the routing asks for, not the rows a
kernel pads), the attention and the router."""

from __future__ import annotations

from portbench import arith


def experts_touched(lm, batch: int) -> float:
    """Expected experts a layer reads for `batch` rows under uniform routing."""
    e, k = lm.num_experts, lm.experts_per_token
    return e * (1.0 - (1.0 - k / e) ** batch)


def expert_bytes(lm) -> int:
    """One expert's int8 gate, up and down weights and their f32 scales."""
    h, f = lm.hidden_size, lm.moe_intermediate_size
    return 3 * h * f + 4 * (2 * f + h)


def attn_weights(lm) -> int:
    """Weight elements of one layer's q|k|v and o."""
    h, d = lm.hidden_size, lm.head_dim
    return h * (lm.num_heads + 2 * lm.num_kv_heads) * d + lm.num_heads * d * h


def moe_expert_bytes(lm, batch: int) -> float:
    """Bytes one step's expert products must move: the touched experts'
    weights and scales, each row's pre-FFN row in (bf16 hi + lo) and its
    output (f32), a layer each."""
    h = lm.hidden_size
    return lm.num_layers * (experts_touched(lm, batch) * expert_bytes(lm) + 2 * 2 * batch * h
                            + 4 * batch * h)


def moe_expert_flops(lm, batch: int) -> float:
    """Operations of one step's expert products: 2 per weight of each row's k experts."""
    h, f = lm.hidden_size, lm.moe_intermediate_size
    return float(lm.num_layers * batch * lm.experts_per_token * 2 * 3 * h * f)


def moe_route_bytes(lm, batch: int) -> float:
    """Bytes one step's routing must move: the f32 router, the rows in (bf16
    hi + lo) and each row's f32 weights out, a layer each."""
    h, e = lm.hidden_size, lm.num_experts
    return float(lm.num_layers * (4 * h * e + 2 * 2 * batch * h + 4 * batch * e))


def moe_route_flops(lm, batch: int) -> float:
    return float(lm.num_layers * batch * 2 * lm.hidden_size * lm.num_experts)


def stack_step_bytes(lm, batch: int, t: int) -> float:
    """Bytes one stack step at position t must move, each once: the int8
    attention weights and scales, the norms, the K/V rows 0..t-1 read with
    their scales and row t written, the bf16 activations in and out, the
    router, and the touched experts (`experts_touched`)."""
    h, d, kh = lm.hidden_size, lm.head_dim, lm.num_kv_heads
    attn = attn_weights(lm) + 4 * ((lm.num_heads + 2 * kh) * d + h)
    router = 4 * h * lm.num_experts
    norms = 4 * 4 * h
    kv_row = 2 * batch * kh * (d + 4)
    per_layer = attn + router + norms + kv_row * (t + 1)
    return (lm.num_layers * per_layer + experts_touched(lm, batch) * lm.num_layers
            * expert_bytes(lm) + 2 * 2 * batch * h)


def decoder_token_flops(lm, attended: int) -> float:
    """One position through the decoder attending to `attended` rows: its
    attention weights, router and k experts (2 per weight), and the
    attention's logits and values."""
    h, f = lm.hidden_size, lm.moe_intermediate_size
    w = attn_weights(lm) + h * lm.num_experts + lm.experts_per_token * 3 * h * f
    return float(lm.num_layers * (2 * w + 2 * 2 * lm.num_heads * lm.head_dim * attended))


def stack_step_flops(lm, batch: int, t: int) -> float:
    return batch * decoder_token_flops(lm, t + 1)


def caption_batch_flops(cfg, batch: int, new_tokens: int) -> float:
    """arith.caption_batch_flops with the routed decoder."""
    vt = cfg.num_vision_tokens
    decoder = sum(decoder_token_flops(cfg.lm, t + 1) for t in range(new_tokens))
    per_row = (arith.vit_flops(cfg.vision, cfg.image_size) + arith.cross_kv_flops(cfg.bridge, vt)
               + arith.bridge_token_flops(cfg.bridge, new_tokens, vt, causal=True)
               + decoder + arith.head_flops(cfg.lm, new_tokens))
    return batch * per_row


def work(lm, batch: int, new_tokens: int, batches: int) -> dict:
    """The bounds of a traced window of `batches` caption batches: the whole
    stack steps' (stack_bound_s), the expert products' and the routing's."""
    steps = sum(arith.bound(stack_step_bytes(lm, batch, t), stack_step_flops(lm, batch, t))
                ["bound_ms"] for t in range(new_tokens))
    experts = arith.bound(moe_expert_bytes(lm, batch), moe_expert_flops(lm, batch))["bound_ms"]
    route = arith.bound(moe_route_bytes(lm, batch), moe_route_flops(lm, batch))["bound_ms"]
    tokens = batches * new_tokens
    return {"stack_bound_s": batches * steps * 1e-3, "moe_expert_bound_s": tokens * experts * 1e-3,
            "moe_route_bound_s": tokens * route * 1e-3}
