"""Gemma-2 decoder (port of vlm_bridge_tpu.models.gemma2).

Ported: random `init`, `embed`, the int8 serving transformation
(`quantize_params` / `quantize_layer` / `quantize_embedding_part`, the
latter also to the int4 rows-packed table, "embedding4"), the KV
quantizer, the whole-stack decode step (`stack_decode_params`, with int8 or
int4 MLP weights, `StackedKVCache`, `decode_step_stacked`) over
ops.decode_kernels, the per-layer fused decode (`FusedKVCache`,
`decode_step_fused`: two calls a layer, `fused_attn_step` and
`fused_mlp_step`), the
per-layer cache path (`KVCache`, `prefill`, `decode_step`; bf16 or int8
cache, lockstep or ragged rows, sliding windows), and the full-sequence
forward (`forward_hidden` with per-layer recomputation,
`logits_from_hidden`, `forward`) over float or int8 weights: int8 dicts go
through ops.quant (`int8_matmul` by way of `linear`, `int8_mlp`,
`int8_matmul_t`, or `int4_matmul_t` for an int4 table). The caches are
updated in place.

A sparse decoder (configs.Gemma2MoEConfig) replaces each layer's MLP by
routed experts: the layer's "mlp" holds "router" [H, E] (f32, never
quantized) and "gate" / "up" [E, H, F], "down" [E, F, H], float or int8 dicts
with per-output-column scales [E, N] of each expert. `_mlp_block` runs them
in plain ops (a gather of each expert's rows and a weighted index_add_), so
training, exact mode and every CPU path take them; `stack_decode_params`
lays them out for the fused stack step, which routes and runs them in its
one C call (ops.decode_kernels). The per-layer fused decode refuses them.

Tensor parallelism (parallel.shard_params over a mesh with model > 1): a
float q / k / v / gate / up leaf may hold this rank's columns (whole heads)
and o / down its rows. The per-layer paths then read their head counts from
the shards' widths (`local_heads`), keep this rank's KV heads in their
caches, and sum the o and down products over the leaf's model group
(parallel.model_input / model_output: identity forward and summed gradient
at the input of a column-cut product, summed forward and identity gradient
after a row-cut one). The collective follows the leaf, so a tree with float
attention and int8 MLP dicts reduces the one and not the other, and a tree
that nothing cut reduces nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from vlm_bridge_tpu_torch.configs import Gemma2Config, num_experts
from vlm_bridge_tpu_torch.ops import decode_kernels, quant
from vlm_bridge_tpu_torch.ops.attention import decode_attention, dot_product_attention
from vlm_bridge_tpu_torch.ops.layers import (apply_rope, gelu_tanh, linear, rms_norm, rope_table,
                                             softcap)
from vlm_bridge_tpu_torch.ops.quant import is_quantized, quantize_int8
from vlm_bridge_tpu_torch.parallel.sharding import model_input, model_output
from vlm_bridge_tpu_torch.runtime.profiling import annotate


class KVCache(NamedTuple):
    """Preallocated per-layer decode cache, updated in place.

    dtype=torch.int8 stores K/V quantized per key vector (symmetric absmax
    over D, scales in k_scale/v_scale [L, B, Smax, KH] f32); the scales fold
    into the attention algebra (ops.attention.decode_attention), so no
    dequantized copy of the cache exists."""

    k: torch.Tensor  # [L, B, Smax, KH, D]
    v: torch.Tensor
    length: torch.Tensor  # [B] int32: valid positions per row (ragged prompts)
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(cfg: Gemma2Config, batch: int, max_len: int, dtype=torch.bfloat16,
              device=None, num_kv_heads: Optional[int] = None) -> "KVCache":
        """num_kv_heads: the KV heads this process holds (None: the
        config's; under tensor parallelism, `local_heads`)."""
        shape = (cfg.num_layers, batch, max_len, num_kv_heads or cfg.num_kv_heads, cfg.head_dim)

        def scale():
            if dtype != torch.int8:
                return None
            return torch.zeros(shape[:-1], dtype=torch.float32, device=device)

        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       length=torch.zeros(batch, dtype=torch.int32, device=device),
                       k_scale=scale(), v_scale=scale())

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def fused_cache_rows(n_tokens: int) -> int:
    """Cache rows the fused decode allocates for n_tokens (64-row rounded,
    as in the JAX package, so the sliding-window precondition is the same
    on both sides)."""
    return ((n_tokens + 63) // 64) * 64


def supports_fused_decode(params: dict, cfg: Gemma2Config, max_len: int) -> bool:
    """Fully int8 layers (fused qkv + o + mlp dicts, or int8 experts beside
    their router) and a cache that fits inside every sliding window (the
    kernels do not mask windows)."""
    if fused_cache_rows(max_len) > cfg.sliding_window:
        return False
    for lp in params["layers"].values():
        attn, mlp = lp["attn"], lp["mlp"]
        if not (is_quantized(attn.get("qkv")) and is_quantized(attn.get("o"))):
            return False
        if not all(is_quantized(mlp[k]) for k in ("gate", "up", "down")):
            return False
    return True


class FusedKVCache(NamedTuple):
    """Per-layer int8 decode caches of the per-layer fused decode
    (`decode_step_fused`): one tensor a layer, as in the JAX package, in this
    port's layout: K/V [B, KH, S, D] int8 (the JAX one is [B, S, KH*D]),
    per-vector scales [B, KH, S] f32 (JAX: [KH, B, S]), S =
    fused_cache_rows(max_len). Updated in place."""

    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    k_scale: Tuple[torch.Tensor, ...]
    v_scale: Tuple[torch.Tensor, ...]

    @staticmethod
    def zeros(cfg: Gemma2Config, batch: int, max_len: int, device=None) -> "FusedKVCache":
        shape = (batch, cfg.num_kv_heads, fused_cache_rows(max_len), cfg.head_dim)

        def per_layer(sh, dtype):
            return tuple(torch.zeros(sh, dtype=dtype, device=device)
                         for _ in range(cfg.num_layers))

        return FusedKVCache(k=per_layer(shape, torch.int8), v=per_layer(shape, torch.int8),
                            k_scale=per_layer(shape[:-1], torch.float32),
                            v_scale=per_layer(shape[:-1], torch.float32))


def rope_rows(cfg: Gemma2Config, n: int, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [n, head_dim] f32 of positions 0 .. n - 1, built on the device
    (no copy from the host) once for a decode loop: row t holds rope_table's
    values at position t, bit for bit (the same elementwise ops)."""
    return rope_table(torch.arange(n, device=device), cfg.head_dim, cfg.rope_theta)


def embed_normalizer(cfg: Gemma2Config, dtype: torch.dtype, device=None) -> torch.Tensor:
    """√H cast to the activation dtype, as the JAX package casts it before
    the multiply; filled on the device (no copy from the host)."""
    return torch.full((), cfg.hidden_size ** 0.5, dtype=dtype, device=device)


def decode_step_fused(params: dict, cfg: Gemma2Config, token_embeds: torch.Tensor,
                      cache: FusedKVCache, position: int, *,
                      rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      normalizer: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, FusedKVCache]:
    """Lockstep decode step at `position` through the per-layer fused calls:
    two a layer (ops.decode_kernels.fused_attn_step / fused_mlp_step) over
    fully int8 per-layer weights (`supports_fused_decode`). Semantics match
    decode_step(position=...) with an int8 cache; the calls round the
    residual stream to the activation dtype twice a layer.

    token_embeds: [B, 1, H] raw embeddings; rope: a decode loop's
    `rope_rows`, normalizer its `embed_normalizer` (None: built here, on the
    device). The four cache writes of a layer stay here: `fused_attn_step`
    hands back the new K/V and scales and leaves the cache untouched. Returns
    (final-normed hidden [B, 1, H], cache updated in place)."""
    if num_experts(cfg):
        raise ValueError("decode_step_fused runs dense MLPs: a sparse decoder's fused decode "
                         "is the stacked step (stack_decode_params, decode_step_stacked)")
    t = int(position)
    B = token_embeds.shape[0]
    KH, D = cfg.num_kv_heads, cfg.head_dim
    rope, normalizer = _step_constants(cfg, token_embeds, t, rope, normalizer)
    cos, sin = rope[0][t], rope[1][t]
    x = (token_embeds * normalizer)[:, 0].contiguous()
    for i in range(cfg.num_layers):
        lp = params["layers"][str(i)]
        x, k_new, v_new, k_sc, v_sc = decode_kernels.fused_attn_step(
            t, x, lp["attn"]["qkv"], lp["attn"]["o"], lp["input_norm"], lp["post_attn_norm"],
            cos, sin, cache.k[i], cache.v[i], cache.k_scale[i], cache.v_scale[i],
            num_heads=cfg.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=cfg.attn_scale,
            softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
        cache.k[i][:, :, t] = k_new.view(B, KH, D)
        cache.v[i][:, :, t] = v_new.view(B, KH, D)
        cache.k_scale[i][:, :, t] = k_sc.T
        cache.v_scale[i][:, :, t] = v_sc.T
        x = decode_kernels.fused_mlp_step(
            x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"],
            lp["pre_ffn_norm"], lp["post_ffn_norm"], eps=cfg.rms_norm_eps)
    hidden = rms_norm(x[:, None, :], params["final_norm"], cfg.rms_norm_eps)
    return hidden, cache


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


def stack_decode_params(params: dict, cfg: Gemma2Config, mlp_int4: bool = False,
                        mlp_int4_group: Optional[int] = 128) -> dict:
    """Layer-stack the int8 decoder weights in the layout of
    ops.decode_kernels.fused_stack_step (int8 layers only; weights in
    fragment order, decode_kernels.to_fragments; gate and up columns, and
    their scales, interleaved in runs of 32, decode_kernels.interleave_gate_up,
    so that the kernel's GeGLU runs inside the gate|up product: the values
    are the JAX package's, the order the port's own).

    mlp_int4=True re-quantizes the MLP weights to nibble-packed int4
    (quant.quantize_int4, group_size=mlp_int4_group; None: one scale per
    output channel) into wgu4 / gu_scale4 / wd4 / d_scale4 (packed fragment
    order, decode_kernels.to_fragments4). As in the JAX package the int4 grid
    is built from the int8 reconstruction (dequantize(w_int8)), so both
    packages hold the same nibbles and scales; float MLP weights pass
    straight through. The JAX function's `free_layers` (dropping each
    per-layer weight as it is stacked, so that a 9B stack converts within
    16 GB) is not ported: the card holds both copies."""
    lps = [params["layers"][str(i)] for i in range(cfg.num_layers)]
    frag, gate_up = decode_kernels.to_fragments, decode_kernels.interleave_gate_up

    def stk(get):
        return torch.stack([get(lp) for lp in lps]).contiguous()

    if num_experts(cfg) and mlp_int4:
        raise ValueError("mlp_int4: the stacked experts are served int8 only")

    mlp = lambda lp, k: lp["mlp"][k]  # noqa: E731
    out = {
        "wqkv": stk(lambda lp: frag(lp["attn"]["qkv"]["w_int8"])),
        "qkv_scale": stk(lambda lp: lp["attn"]["qkv"]["scale"].float()),
        "wo": stk(lambda lp: frag(lp["attn"]["o"]["w_int8"])),
        "o_scale": stk(lambda lp: lp["attn"]["o"]["scale"].float()),
        "norms": stk(lambda lp: torch.stack([
            lp["input_norm"], lp["post_attn_norm"],
            lp["pre_ffn_norm"], lp["post_ffn_norm"]]).float()),
    }
    if num_experts(cfg):
        E, F, H = cfg.num_experts, cfg.moe_intermediate_size, cfg.hidden_size

        def side_by_side(w):   # [E, K, N] -> [K, E N]: the experts' columns in turn
            return w.permute(1, 0, 2).reshape(w.shape[1], -1)

        out["router"] = stk(lambda lp: mlp(lp, "router").float())
        out["ewgu"] = stk(lambda lp: frag(gate_up(side_by_side(mlp(lp, "gate")["w_int8"]),
                                                  side_by_side(mlp(lp, "up")["w_int8"]))))
        out["egu_scale"] = stk(lambda lp: gate_up(mlp(lp, "gate")["scale"].reshape(E * F),
                                                  mlp(lp, "up")["scale"].reshape(E * F)).float())
        out["ewd"] = stk(lambda lp: frag(mlp(lp, "down")["w_int8"].reshape(E * F, H)))
        out["ed_scale"] = stk(lambda lp: mlp(lp, "down")["scale"].float())
        return out
    if not mlp_int4:
        out["wgu"] = stk(lambda lp: frag(gate_up(mlp(lp, "gate")["w_int8"],
                                                 mlp(lp, "up")["w_int8"])))
        out["gu_scale"] = stk(lambda lp: gate_up(mlp(lp, "gate")["scale"],
                                                 mlp(lp, "up")["scale"]).float())
        out["wd"] = stk(lambda lp: frag(mlp(lp, "down")["w_int8"]))
        out["d_scale"] = stk(lambda lp: mlp(lp, "down")["scale"].float())
        return out

    g = mlp_int4_group
    F, H = cfg.intermediate_size, cfg.hidden_size
    if g is not None and ((H // 2) % g or (F // 2) % g):
        raise ValueError(f"mlp_int4_group={g} must divide H/2={H // 2} and F/2={F // 2} (pass "
                         "mlp_int4_group=None for per-channel scales, or a dividing group size)")

    def q4(w):
        """(int4 values [K, N], scales [K/g or 1, N]) of one MLP weight."""
        wf = quant.dequantize(w, axis=0) if is_quantized(w) else w.float()
        q = quant.quantize_int4(wf, group_size=g)
        return (torch.cat(quant.unpack_int4(q["w_int4"]), dim=0),
                q["scale"] if g is not None else q["scale"][None])

    frag4 = decode_kernels.to_fragments4
    gu, gus, wd, ds = [], [], [], []
    for lp in lps:
        (gq, gs), (uq, us), (dq, dsc) = (q4(mlp(lp, k)) for k in ("gate", "up", "down"))
        gu.append(frag4(gate_up(gq, uq)))
        gus.append(gate_up(gs, us))
        wd.append(frag4(dq))
        ds.append(dsc)
    out["wgu4"], out["gu_scale4"] = torch.stack(gu).contiguous(), torch.stack(gus).contiguous()
    out["wd4"], out["d_scale4"] = torch.stack(wd).contiguous(), torch.stack(ds).contiguous()
    return out


def _step_constants(cfg: Gemma2Config, token_embeds: torch.Tensor, t: int, rope, normalizer):
    """A decode step's RoPE rows and normalizer: the loop's, or built here."""
    dev = token_embeds.device
    if rope is None:
        rope = rope_rows(cfg, t + 1, dev)
    if normalizer is None:
        normalizer = embed_normalizer(cfg, token_embeds.dtype, dev)
    return rope, normalizer


def decode_step_stacked(params: dict, cfg: Gemma2Config, stacked: dict,
                        token_embeds: torch.Tensor, cache: StackedKVCache, position: int, *,
                        rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                        normalizer: Optional[torch.Tensor] = None,
                        graphs: Optional[decode_kernels.StepGraphs] = None
                        ) -> Tuple[torch.Tensor, StackedKVCache]:
    """Lockstep decode step at `position` through the whole stack.

    token_embeds: [B, 1, H] raw (bridged) embeddings; rope: a decode loop's
    `rope_rows`, of which row `position` goes to the step; normalizer: its
    `embed_normalizer` (√H cast to the activation dtype before the multiply,
    as in the JAX package); either None: built here, on the device. graphs:
    a decode loop's StepGraphs for the stack step (the scaled embeddings go
    into its input buffer, and the step runs from its graph of this
    position). Returns (final-normed hidden [B, 1, H], cache updated in
    place). The span vlm.stack_step holds the call into the stack's kernels
    alone; the normalizer and the final norm stay outside it."""
    t = int(position)
    rope, normalizer = _step_constants(cfg, token_embeds, t, rope, normalizer)
    if graphs is None:
        x = (token_embeds * normalizer)[:, 0].contiguous()
    else:
        x = torch.mul(token_embeds[:, 0], normalizer, out=graphs.x)
    with annotate("stack_step"):
        x_out = decode_kernels.fused_stack_step(
            t, x, stacked, cache.k, cache.v, cache.k_scale, cache.v_scale,
            rope[0][t], rope[1][t],
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim, attn_scale=cfg.attn_scale,
            softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps,
            experts_per_token=getattr(cfg, "experts_per_token", 0),
            norm_topk_prob=getattr(cfg, "norm_topk_prob", True), graphs=graphs)
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

    def experts(fan_in, fan_out):
        return (torch.randn(cfg.num_experts, fan_in, fan_out, generator=generator,
                            device=device) * 0.02).to(dtype)

    def mlp():   # drawn after the layer's attention: the seeded init keeps its order
        if num_experts(cfg):
            f = cfg.moe_intermediate_size
            return {"router": dense(h, cfg.num_experts).float(), "gate": experts(h, f),
                    "up": experts(h, f), "down": experts(f, h)}
        return {"gate": dense(h, cfg.intermediate_size), "up": dense(h, cfg.intermediate_size),
                "down": dense(cfg.intermediate_size, h)}

    layers = {}
    for i in range(cfg.num_layers):
        layers[str(i)] = {
            "input_norm": zeros(h), "post_attn_norm": zeros(h),
            "pre_ffn_norm": zeros(h), "post_ffn_norm": zeros(h),
            "attn": {"q": dense(h, cfg.num_heads * hd), "k": dense(h, cfg.num_kv_heads * hd),
                     "v": dense(h, cfg.num_kv_heads * hd), "o": dense(cfg.num_heads * hd, h)},
            "mlp": mlp(),
        }
    emb = (torch.randn(cfg.vocab_size, h, generator=generator, device=device) * 0.02).to(dtype)
    return {"embedding": emb, "final_norm": zeros(h), "layers": layers}


def embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    """Raw (un-normalized) embedding lookup. An int8 or int4 table
    dequantizes only the gathered rows, in f32."""
    E = params["embedding"]
    if isinstance(E, dict):
        if "w_int4" in E:
            return quant.take_int4_rows(E, input_ids)
        return E["w_int8"][input_ids].float() * E["scale"][input_ids][..., None]
    return E[input_ids]


def _width(w) -> int:
    return (w["w_int8"] if isinstance(w, dict) else w).shape[-1]


def local_heads(lm: dict, cfg: Gemma2Config) -> Tuple[int, int]:
    """(query heads, KV heads) of this process's layers: the config's, or
    its share where parallel.shard_params cut q / k / v by whole heads."""
    attn = lm["layers"]["0"]["attn"] if "layers" in lm else {}
    if "q" not in attn:   # the fused int8 q|k|v or stacked weights: never cut
        return cfg.num_heads, cfg.num_kv_heads
    return _width(attn["q"]) // cfg.head_dim, _width(attn["k"]) // cfg.head_dim


def _qkv_proj(attn: dict, x: torch.Tensor, cfg: Gemma2Config):
    """Project to (q, k, v) heads; int8 params may carry a fused "qkv". The
    head counts are the projections' widths over head_dim (this rank's
    heads under tensor parallelism)."""
    B, T = x.shape[0], x.shape[1]
    D = cfg.head_dim
    if "qkv" in attn:
        H, KH = cfg.num_heads, cfg.num_kv_heads
        y = linear(x, attn["qkv"])
        q, k, v = y[..., :H * D], y[..., H * D:(H + KH) * D], y[..., (H + KH) * D:]
    else:
        x = model_input(x, attn["q"])
        q, k, v = linear(x, attn["q"]), linear(x, attn["k"]), linear(x, attn["v"])
    return q.reshape(B, T, -1, D), k.reshape(B, T, -1, D), v.reshape(B, T, -1, D)


def _out_proj(attn: dict, out: torch.Tensor) -> torch.Tensor:
    """The o projection of the heads' outputs [..., heads, D], summed over
    the model group where o holds this rank's rows."""
    out = linear(out.reshape(*out.shape[:-2], -1), attn["o"])
    return model_output(out, attn["o"])


def _attention_block(lp: dict, cfg: Gemma2Config, x: torch.Tensor, layer_idx: int, *,
                     cos, sin, attn_mask, positions, kv_lengths=None, return_kv: bool = False,
                     reference: bool = False):
    """positions=None means "queries are the trailing T of S positions", the
    convention the attention op and the flash kernels assume. kv_lengths:
    per-row valid key counts when attn_mask is a right-padding prefix mask
    (it lets padded training shapes take the flash kernels). return_kv=True
    also returns the rotated k and the raw v, for cache fills."""
    q, k, v = _qkv_proj(lp["attn"], x, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    window = cfg.sliding_window if cfg.layer_is_sliding(layer_idx) else None
    out = dot_product_attention(
        q, k, v, scale=cfg.attn_scale, mask=attn_mask, is_causal=True,
        logit_softcap=cfg.attn_logit_softcap, sliding_window=window,
        q_positions=positions, kv_positions=positions, kv_lengths=kv_lengths,
        reference=reference)
    out = _out_proj(lp["attn"], out)
    return (out, k, v) if return_kv else out


def _expert(mlp: dict, e: int, x: torch.Tensor) -> torch.Tensor:
    """Expert e's GeGLU MLP over rows x [n, H] (in x.dtype, as the dense one)."""
    gate, up, down = (mlp[k] for k in ("gate", "up", "down"))
    if is_quantized(gate):
        one = lambda wq: {"w_int8": wq["w_int8"][e], "scale": wq["scale"][e]}  # noqa: E731
        return quant.int8_mlp(x, one(gate), one(up), one(down))
    return linear(gelu_tanh(linear(x, gate[e])) * linear(x, up[e]), down[e])


def _moe_block(mlp: dict, x: torch.Tensor, cfg: Gemma2Config) -> torch.Tensor:
    """The routed feed-forward over rows x [..., H]: each row's k experts by
    the router's f32 logits (decode_kernels.moe_route), each expert run once
    over the rows routed to it, their outputs added into the rows with the
    rows' weights (index_add in f32); returned in x.dtype."""
    lead, H = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, H)
    weights, experts = decode_kernels.moe_route(xf.float() @ mlp["router"].float(),
                                                cfg.experts_per_token, cfg.norm_topk_prob)
    out = torch.zeros(xf.shape[0], H, dtype=torch.float32, device=x.device)
    for e in range(cfg.num_experts):
        rows, slot = (experts == e).nonzero(as_tuple=True)
        if rows.numel():
            y = _expert(mlp, e, xf[rows].contiguous())
            out = out.index_add(0, rows, y.float() * weights[rows, slot, None])
    return out.to(x.dtype).reshape(*lead, H)


def _mlp_block(lp: dict, x: torch.Tensor, cfg: Optional[Gemma2Config] = None) -> torch.Tensor:
    mlp = lp["mlp"]
    if "router" in mlp:
        return _moe_block(mlp, x, cfg)
    if is_quantized(mlp["gate"]):
        lead = x.shape[:-1]
        y = quant.int8_mlp(x.reshape(-1, x.shape[-1]).contiguous(), mlp["gate"], mlp["up"],
                           mlp["down"])
        return y.reshape(*lead, y.shape[-1])
    x = model_input(x, mlp["gate"])
    gate = gelu_tanh(linear(x, mlp["gate"]))
    up = linear(x, mlp["up"])
    return model_output(linear(gate * up, mlp["down"]), mlp["down"])


def _layer(lp: dict, cfg: Gemma2Config, x: torch.Tensor, layer_idx: int, cos, sin,
           attn_mask, positions, kv_lengths=None, reference: bool = False, *,
           return_kv: bool = False):
    eps = cfg.rms_norm_eps
    h = rms_norm(x, lp["input_norm"], eps)
    h = _attention_block(lp, cfg, h, layer_idx, cos=cos, sin=sin, attn_mask=attn_mask,
                         positions=positions, kv_lengths=kv_lengths, return_kv=return_kv,
                         reference=reference)
    if return_kv:
        h, k, v = h
    x = x + rms_norm(h, lp["post_attn_norm"], eps)
    h = rms_norm(x, lp["pre_ffn_norm"], eps)
    h = _mlp_block(lp, h, cfg)
    x = x + rms_norm(h, lp["post_ffn_norm"], eps)
    return (x, k, v) if return_kv else x


def forward_hidden(params: dict, cfg: Gemma2Config, inputs_embeds: torch.Tensor, *,
                   attn_mask: Optional[torch.Tensor] = None,
                   positions: Optional[torch.Tensor] = None,
                   remat: bool = False, reference_attention: bool = False) -> torch.Tensor:
    """Full-sequence forward from embeddings to final-norm hidden states.

    inputs_embeds: [B, T, H] RAW embeddings (the sqrt-hidden normalizer is
    applied here, cast to the activation dtype first). attn_mask: [B, T]
    with 1 = real token; pads are masked from keys. remat=True recomputes
    each layer in the backward (torch.utils.checkpoint) instead of keeping
    its activations. reference_attention=True runs every layer's attention
    through `_attention_reference` (exact-mode generation asks for it).
    Returns hidden [B, T, H]."""
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
                kv_lengths, reference_attention)
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
        mm = quant.int4_matmul_t if "w_int4" in E else quant.int8_matmul_t
        logits = mm(hidden.reshape(B * T, H).contiguous(), E).reshape(B, T, -1)
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
    """Quantize the tied embedding per `parts`: "embedding" int8 per vocab
    row, "embedding4" the int4 rows-packed table (scale groups of 128 where
    H/2 holds whole ones, else one scale per row)."""
    if "embedding4" in parts and "embedding" in parts:
        raise ValueError("embedding and embedding4 are mutually exclusive")
    if "embedding4" in parts:
        h = emb.shape[1]
        return quant.quantize_int4_rows(emb, group_size=128 if (h // 2) % 128 == 0 else None)
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
    if "mlp" not in parts:
        out["mlp"] = lp["mlp"]
    elif "router" in lp["mlp"]:
        # each expert per output column ([E, K, N]: over K); the router stays f32
        out["mlp"] = {k: v.float() if k == "router" else quantize_int8(v, axis=1)
                      for k, v in lp["mlp"].items()}
    else:
        out["mlp"] = {k: quantize_int8(v, axis=0) for k, v in lp["mlp"].items()}
    return out


def quantize_params(params: dict, parts: Tuple[str, ...] = ("embedding", "mlp", "attn")) -> dict:
    """Int8 weight-only quantization of the frozen decoder for serving
    ("embedding4": the table at 4 bits)."""
    unknown = set(parts) - {"embedding", "embedding4", "mlp", "attn"}
    if unknown:
        raise ValueError(f"unknown quantize parts: {sorted(unknown)} "
                         f"(valid: embedding, embedding4, mlp, attn)")
    return {
        "embedding": quantize_embedding_part(params["embedding"], parts),
        "final_norm": params["final_norm"],
        "layers": {name: quantize_layer(lp, parts) for name, lp in params["layers"].items()},
    }


# ---------------------------------------------------------------------------
# KV-cache prefill + per-layer decode
# ---------------------------------------------------------------------------


def prefill(params: dict, cfg: Gemma2Config, inputs_embeds: torch.Tensor, cache: KVCache, *,
            attn_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt through the decoder, filling the cache in place.

    Returns (hidden [B, T, H], cache with its lengths set). Prompts occupy
    positions [0, T); right padding goes through attn_mask: pad K/V are
    written to the cache, but the per-row length = attn_mask.sum() keeps them
    unattendable, and each row's next decode position continues from its own
    true length."""
    B, T, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    positions = torch.arange(T, device=dev)[None, :].expand(B, T)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    normalizer = torch.tensor(cfg.hidden_size ** 0.5, dtype=inputs_embeds.dtype, device=dev)
    x = inputs_embeds * normalizer

    key_mask = kv_lengths = None
    if attn_mask is not None:
        key_mask = attn_mask[:, None, :].bool()
        kv_lengths = attn_mask.sum(dim=-1).to(torch.int32)

    for i in range(cfg.num_layers):
        # the layer wiring of forward_hidden, also handing back each layer's
        # rotated K and raw V for the cache
        x, k, v = _layer(params["layers"][str(i)], cfg, x, i, cos, sin, key_mask, None,
                         kv_lengths, return_kv=True)
        if cache.quantized:
            cache.k[i, :, :T], cache.k_scale[i, :, :T] = quantize_kv(k)
            cache.v[i, :, :T], cache.v_scale[i, :, :T] = quantize_kv(v)
        else:
            cache.k[i, :, :T] = k.to(cache.k.dtype)
            cache.v[i, :, :T] = v.to(cache.v.dtype)

    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    lengths = (kv_lengths if kv_lengths is not None
               else torch.full((B,), T, dtype=torch.int32, device=dev))
    return hidden, cache._replace(length=lengths)


def decode_step(params: dict, cfg: Gemma2Config, token_embeds: torch.Tensor, cache: KVCache, *,
                position: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """One decode step, layer by layer. token_embeds: [B, 1, H] raw embedding
    of the new token.

    Returns (hidden [B, 1, H], cache with its lengths advanced; K/V written
    in place). Each row's new token sits at its OWN position cache.length[b]
    (rows may be ragged after a padded prefill), written with one indexed
    store per layer.

    position: optional int shared by every row (the no-prompt generation
    loop, where all rows decode in lockstep): the write becomes a slice
    store and no per-row index is read. cache.length must equal position in
    every row; after a ragged prefill call decode_step without position=."""
    B = token_embeds.shape[0]
    dev = token_embeds.device
    uniform = position is not None
    if uniform:
        pos = int(position)
        positions = torch.tensor([[pos]], device=dev)
        new_len = torch.full((B,), pos + 1, dtype=torch.int32, device=dev)
    else:
        positions = cache.length.long()[:, None]  # [B, 1]
        new_len = cache.length + 1
        rows = torch.arange(B, device=dev)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    normalizer = torch.tensor(cfg.hidden_size ** 0.5, dtype=token_embeds.dtype, device=dev)
    x = token_embeds * normalizer
    window_start = torch.clamp(new_len - cfg.sliding_window, min=0)

    def write(buf, val, layer):
        # val: [B, ...] per-row payload (trailing dims match buf[3:])
        if uniform:
            buf[layer, :, pos] = val.to(buf.dtype)
        else:
            buf[layer, rows, positions[:, 0]] = val.to(buf.dtype)

    for i in range(cfg.num_layers):
        lp = params["layers"][str(i)]
        h = rms_norm(x, lp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv_proj(lp["attn"], h, cfg)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

        if cache.quantized:
            kq, k_sc = quantize_kv(k[:, 0])
            vq, v_sc = quantize_kv(v[:, 0])
            write(cache.k, kq, i)
            write(cache.v, vq, i)
            write(cache.k_scale, k_sc, i)
            write(cache.v_scale, v_sc, i)
        else:
            write(cache.k, k[:, 0], i)
            write(cache.v, v[:, 0], i)

        attn = decode_attention(
            q, cache.k[i], cache.v[i], new_len,
            scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcap,
            window_start=window_start if cfg.layer_is_sliding(i) else None,
            k_scale=None if cache.k_scale is None else cache.k_scale[i],
            v_scale=None if cache.v_scale is None else cache.v_scale[i])
        h = _out_proj(lp["attn"], attn)
        x = x + rms_norm(h, lp["post_attn_norm"], cfg.rms_norm_eps)
        h = rms_norm(x, lp["pre_ffn_norm"], cfg.rms_norm_eps)
        h = _mlp_block(lp, h, cfg)
        x = x + rms_norm(h, lp["post_ffn_norm"], cfg.rms_norm_eps)

    hidden = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return hidden, cache._replace(length=new_len)
