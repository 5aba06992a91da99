"""Batched caption generation (port of vlm_bridge_tpu.inference.generate).

Fast mode:
The image is encoded once and each bridge block's cross-attention K/V are
computed once; then a Python loop over preallocated caches runs, per token:
embed the last token -> both bridge blocks (causal self cache) -> every
Gemma layer against the KV cache -> the head (greedy argmax, or f32 logits
and ops.sampling.sample_token). The caches are updated in place.

Two decode paths, chosen by `_fused_decode_available` as in the JAX package:
- fused: int8 LM layers, int8 KV cache (kv_quant) and cache rows inside the
  sliding window -> one call per token through the whole decoder stack
  (ops.decode_kernels.fused_stack_step; with gen.mlp_int4 its MLP stage
  reads int4 weights) and, with an int8 bridge, one through the bridge
  (fused_bridge_step);
- per layer (the JAX package's jnp path; `force_jnp` pins it): float or
  int8 weights, bf16 or int8 cache, any window. Int8 weights run
  ops.quant's int8_matmul / int8_mlp / int8_ffn.
On either path an int8 table's head is int8_matmul_t or, greedy,
int8_matmul_t_argmax; an int4 table's (--quantize embedding4) is
int4_matmul_t or int4_matmul_t_argmax. On CUDA tensors all of these launch
the port's kernels.

gen.mlp_int4 serves only the fused path and raises anywhere else: nothing
serves int8 MLP weights under the int4 label.

With gen.early_stop the loop ends once every row has emitted EOS, but it
learns that two steps late (`_AllDone`): each step's flag is copied to a
pinned host buffer behind an event, and the host waits only for the event
of the step before the last one it queued. The extra steps write pads to
rows that are done, so the tokens are those of early_stop=False.

Spans (runtime.profiling.annotate; a flag check when nothing records):
each position of the fast loop runs in vlm.token, and inside it the bridge
in vlm.bridge_step, the fused stack's call in vlm.stack_step
(gemma2.decode_step_stacked), the head in vlm.head and the sampler in
vlm.sampler.

Exact mode (gen.exact, the reference-parity decode): a fixed [B, L] token
buffer re-run in full at every step, the `position < t` mask on the bridge
and the LM, the bridge causal or not as the checkpoint was trained
(gen.bridge_causal), no KV cache, f32 activations unless a dtype is given.
Every attention of it runs `_attention_reference` by request (the flash
kernels take bf16 only). Samples come from the same generator stream, one
draw a token, that fast mode uses.

Under a mesh (parallel.auto_mesh, one process per place): every rank passes
the global batch, decodes its data block's rows, and the tokens and lengths
are gathered over the data group in block order, so every rank returns the
global result. With model == 1 each rank runs the single-device program,
fused path included; with model > 1 (an LM cut by parallel.shard_params)
the per-layer path serves, the ViT, the bridge and the head replicated, and
the ranks of one data block decode the same ids: the all-reduce hands them
the same bits, and their samplers are seeded per data block
(Mesh.rank_seed).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch

from vlm_bridge_tpu_torch.configs import BridgeConfig, VLMConfig
from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
from vlm_bridge_tpu_torch.ops import decode_kernels, quant
from vlm_bridge_tpu_torch.ops.attention import decode_attention
from vlm_bridge_tpu_torch.ops.layers import gelu_exact, layer_norm, linear
from vlm_bridge_tpu_torch.ops.sampling import sample_token
from vlm_bridge_tpu_torch.parallel import batch_sharding, distributed
from vlm_bridge_tpu_torch.runtime.profiling import annotate


@dataclass(frozen=True)
class GenerationConfig:
    max_length: int = 50          # max new tokens
    temperature: float = 0.7
    top_p: float = 0.9
    greedy: bool = False
    exact: bool = False           # reference-parity mode: full re-forward per token
    topk_window: int = 128
    bypass_bridge: bool = False   # A/B debugging: feed raw Gemma embeddings,
                                  # skipping the bridge
    early_stop: bool = False      # stop once every row has emitted EOS
    kv_quant: bool = False        # int8 Gemma KV cache and int8 cross cache
    force_jnp: bool = False       # pin the per-layer decode path (the JAX
                                  # package's jnp path) where the fused stack
                                  # step would serve
    bridge_causal: bool = False   # exact mode only: causal bridge self-attention
    mlp_int4: bool = False        # fused stack decode only: the Gemma MLP
                                  # weights re-quantized to int4 when stacking
    mlp_int4_group: Optional[int] = 128  # rows of the contraction a scale
                                  # covers (None: one per output channel)


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
            h = quant.int8_ffn(h.reshape(B, ld), fp["fc1"], fp["fc1_bias"], fp["fc2"],
                               fp["fc2_bias"]).reshape(B, 1, ld)
        else:
            h = linear(h, fp["fc1"].to(dtype), fp["fc1_bias"].to(dtype))
            h = linear(gelu_exact(h), fp["fc2"].to(dtype), fp["fc2_bias"].to(dtype))
        x = x + h
    return x, cache


class _AllDone:
    """Whether every row has emitted EOS, read LAG steps late so that the
    decode loop never waits for the step it just queued. push(t, done) after
    step t copies done.all() into a host buffer (pinned, non_blocking,
    behind an event on CUDA); seen(t) at the top of step t reads step
    t - LAG's flag, waiting at most for that step, while step t - 1 keeps
    the device busy."""

    LAG = 2

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.flags = [torch.zeros((), dtype=torch.bool, pin_memory=self.cuda)
                      for _ in range(self.LAG)]
        self.events = [torch.cuda.Event() for _ in range(self.LAG)] if self.cuda else None

    def push(self, t: int, done: torch.Tensor) -> None:
        slot = t % self.LAG
        self.flags[slot].copy_(done.all(), non_blocking=True)
        if self.cuda:
            self.events[slot].record()

    def seen(self, t: int) -> bool:
        if t < self.LAG:
            return False
        slot = (t - self.LAG) % self.LAG
        if self.cuda:
            self.events[slot].synchronize()
        return bool(self.flags[slot])


def _fused_decode_available(params, cfg: VLMConfig, gen: GenerationConfig) -> bool:
    """Whether the whole-stack decode step serves this call: int8 KV cache,
    fully int8 layers (or weights stacked ahead of time) and cache rows that
    fit every sliding window. gen.force_jnp, or VLM_BRIDGE_DEBUG_FORCE_JNP
    set in the environment (read at call time), pins the per-layer path."""
    lm = params["lm"]
    if gen.force_jnp or os.environ.get("VLM_BRIDGE_DEBUG_FORCE_JNP"):
        if "layers" not in lm:
            raise ValueError("force_jnp requested but params carry only pre-stacked decode "
                             "weights (stacked_decode): the per-layer path needs per-layer "
                             "weights")
        return False
    if not gen.kv_quant:
        return False
    if "stacked_decode" in lm:
        return gemma2.fused_cache_rows(gen.max_length + 1) <= cfg.lm.sliding_window
    return gemma2.supports_fused_decode(lm, cfg.lm, gen.max_length + 1)


@torch.no_grad()
def _generate_fast(params, cfg: VLMConfig, vision: torch.Tensor, gen: GenerationConfig,
                   activation_dtype, generator: Optional[torch.Generator],
                   use_fused: bool, use_fused_bridge: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    B = vision.shape[0]
    L = gen.max_length + 1  # BOS + generated
    lm_cfg, br_cfg = cfg.lm, cfg.bridge
    dev = vision.device
    vision = vision.to(activation_dtype)

    def cast(p):
        if isinstance(p, dict):
            return {k: cast(v) for k, v in p.items()}
        return p.to(activation_dtype) if (p.dim() >= 2 and p.is_floating_point()) else p

    lm = params["lm"]
    if not gen.bypass_bridge:
        # the (possibly f32 master) bridge weights are cast once, not per token
        bridge_params = cast(params["bridge"])
        bridge_cache = _build_cross_cache(bridge_params, br_cfg, vision, L, activation_dtype,
                                          kv_quant=gen.kv_quant)
        if use_fused_bridge:
            bst = bridge.stack_bridge_decode_params(bridge_params, br_cfg)
    if use_fused:
        stacked = lm.get("stacked_decode")
        if stacked is None:
            stacked = gemma2.stack_decode_params(lm, lm_cfg, mlp_int4=gen.mlp_int4,
                                                 mlp_int4_group=gen.mlp_int4_group)
        if gen.mlp_int4 != ("wgu4" in stacked):
            raise ValueError(f"mlp_int4={gen.mlp_int4} but the pre-stacked decode weights "
                             f"{'carry' if 'wgu4' in stacked else 'do not carry'} int4 MLP "
                             "fields: restack with the same setting")
        kv = gemma2.StackedKVCache.zeros(lm_cfg, B, L, device=dev)
    else:
        kv = gemma2.KVCache.zeros(lm_cfg, B, L, device=dev,
                                  dtype=torch.int8 if gen.kv_quant else activation_dtype,
                                  num_kv_heads=gemma2.local_heads(lm, lm_cfg)[1])
    table = lm["embedding"]
    argmax_head = None
    if gen.greedy and isinstance(table, dict):
        argmax_head = (quant.int4_matmul_t_argmax if "w_int4" in table
                       else quant.int8_matmul_t_argmax)

    bos = torch.full((B,), lm_cfg.bos_token_id, dtype=torch.int32, device=dev)
    toks = torch.full((B, gen.max_length), lm_cfg.pad_token_id, dtype=torch.int32, device=dev)
    tok, done = bos, torch.zeros(B, dtype=torch.bool, device=dev)
    all_done = _AllDone(dev) if gen.early_stop else None
    for t in range(gen.max_length):
        with annotate("token"):
            if all_done is not None and all_done.seen(t):
                break
            emb = gemma2.embed(lm, tok.long()[:, None]).to(activation_dtype)
            if gen.bypass_bridge:
                bridged = emb
            elif use_fused_bridge:
                with annotate("bridge_step"):
                    x = decode_kernels.fused_bridge_step(
                        t, emb[:, 0].contiguous(), bst, bridge_cache.cross_k,
                        bridge_cache.cross_k_scale, bridge_cache.cross_v,
                        bridge_cache.cross_v_scale, bridge_cache.self_k, bridge_cache.self_v,
                        num_heads_cross=br_cfg.num_heads_cross,
                        num_heads_self=br_cfg.num_heads_self, eps=br_cfg.layer_norm_eps)
                bridged = x[:, None, :]
            else:
                with annotate("bridge_step"):
                    bridged, bridge_cache = _bridge_decode_step(bridge_params, br_cfg,
                                                                bridge_cache, emb, t)
            if use_fused:
                hidden, kv = gemma2.decode_step_stacked(lm, lm_cfg, stacked, bridged, kv, t)
            else:
                hidden, kv = gemma2.decode_step(lm, lm_cfg, bridged, kv, position=t)
            if argmax_head is not None:
                # the argmax is taken inside the int8 / int4 head: the [B, V] logits
                # are never written (the final softcap is monotonic)
                with annotate("head"):
                    nxt = argmax_head(hidden[:, 0].contiguous(), table)
            else:
                with annotate("head"):
                    logits = gemma2.logits_from_hidden(lm, lm_cfg, hidden)[:, 0]
                # one generator, advanced token by token: the same seed gives the
                # same tokens on one device
                with annotate("sampler"):
                    nxt = sample_token(generator, logits, temperature=gen.temperature,
                                       top_p=gen.top_p, greedy=gen.greedy,
                                       topk_window=gen.topk_window)
            nxt = torch.where(done, torch.full_like(nxt, lm_cfg.pad_token_id), nxt)
            done = done | (nxt == lm_cfg.eos_token_id)
            toks[:, t] = nxt
            tok = nxt
            if all_done is not None:
                all_done.push(t, done)
    tokens = torch.cat([bos[:, None], toks], dim=1)
    return tokens, _eos_lengths(tokens, lm_cfg.eos_token_id)


@torch.no_grad()
def _generate_exact(params, cfg: VLMConfig, vision: torch.Tensor, gen: GenerationConfig,
                    activation_dtype, generator: Optional[torch.Generator]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's _generate_exact: step t re-runs the bridge and the
    LM over the whole buffer under the `position < t` mask and samples from
    position t - 1's logits."""
    B = vision.shape[0]
    L = gen.max_length + 1
    lm_cfg, dev = cfg.lm, vision.device
    vision = vision.to(activation_dtype)
    tokens = torch.full((B, L), lm_cfg.pad_token_id, dtype=torch.int32, device=dev)
    tokens[:, 0] = lm_cfg.bos_token_id
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    positions = torch.arange(L, device=dev)[None, :]
    for t in range(1, L):
        mask = (positions < t).int().expand(B, L)
        if gen.bypass_bridge:
            bridged = gemma2.embed(params["lm"], tokens.long())
        else:
            bridged = full_model.bridge_text(
                params, cfg, tokens.long(), vision, attn_mask=mask, bridge_pad_mask=True,
                bridge_causal=gen.bridge_causal, reference_attention=True)
        hidden = gemma2.forward_hidden(params["lm"], lm_cfg, bridged.to(activation_dtype),
                                       attn_mask=mask, remat=False, reference_attention=True)
        logits = gemma2.logits_from_hidden(params["lm"], lm_cfg, hidden[:, t - 1:t])[:, 0]
        nxt = sample_token(generator, logits, temperature=gen.temperature, top_p=gen.top_p,
                           greedy=gen.greedy, topk_window=gen.topk_window)
        nxt = torch.where(done, torch.full_like(nxt, lm_cfg.pad_token_id), nxt)
        done = done | (nxt == lm_cfg.eos_token_id)
        tokens[:, t] = nxt
    return tokens, _eos_lengths(tokens, lm_cfg.eos_token_id)


def generate_tokens(params, cfg: VLMConfig, *, pixel_values: Optional[torch.Tensor] = None,
                    vision_features: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    gen: GenerationConfig = GenerationConfig(),
                    activation_dtype=None, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generate caption tokens.

    Returns (tokens [B, max_length+1] int32 incl. BOS, lengths [B] = index
    of the first EOS or the full length). Rows that emitted EOS are padded
    with pad_token_id afterwards. Runs on the device of the inputs.
    generator: the sampling stream, a torch.Generator on that device (None:
    torch's global generator); greedy decoding draws nothing. mesh: a
    ("data", "model") mesh (parallel.auto_mesh): the global batch, the same
    on every rank, must divide its data axis; each rank decodes its data
    block's rows and returns the gathered global tokens and lengths. Seed
    `generator` with mesh.rank_seed for sampling."""
    if mesh is None:
        return _generate_local(params, cfg, pixel_values, vision_features, generator, gen,
                               activation_dtype, fused_ok=True)
    x = pixel_values if vision_features is None else vision_features
    if x.shape[0] % mesh.data:
        raise ValueError(f"generation batch {x.shape[0]} must divide the mesh 'data' axis "
                         f"({mesh.data}); pad with data.preprocess.pad_to_batch")
    rows = batch_sharding(mesh, x.shape[0])
    toks, lens = _generate_local(
        params, cfg, None if pixel_values is None else pixel_values[rows],
        None if vision_features is None else vision_features[rows], generator, gen,
        activation_dtype, fused_ok=mesh.model == 1)
    return (distributed.all_gather_rows(toks, mesh.data_group),
            distributed.all_gather_rows(lens, mesh.data_group))


def _generate_local(params, cfg: VLMConfig, pixel_values, vision_features, generator, gen,
                    activation_dtype, *, fused_ok: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """generate_tokens on this process's rows; fused_ok False (an LM cut
    over a model axis) keeps the fused steps from dispatching."""
    activation_dtype = resolve_activation_dtype(activation_dtype, gen)
    if gen.exact:
        if "layers" not in params["lm"]:
            raise ValueError("exact mode re-runs the LM layer by layer: params['lm'] needs its "
                             "per-layer weights, not only stacked_decode")
        if gen.mlp_int4:
            raise ValueError("mlp_int4 serves only the fused stack decode, not exact mode")
        if vision_features is None:
            vision_features = full_model.encode_image(params, cfg, pixel_values,
                                                      reference_attention=True)
        return _generate_exact(params, cfg, vision_features, gen, activation_dtype, generator)
    use_fused = fused_ok and _fused_decode_available(params, cfg, gen)
    if gen.mlp_int4 and not use_fused:
        raise ValueError(
            "mlp_int4 serves only the fused stack decode, which cannot dispatch here "
            f"(kv_quant={gen.kv_quant}, force_jnp={gen.force_jnp}; it needs fully int8 LM "
            f"layers and cache rows {gemma2.fused_cache_rows(gen.max_length + 1)} within "
            f"sliding_window={cfg.lm.sliding_window})")
    use_fused_bridge = (use_fused and not gen.bypass_bridge
                        and bridge.supports_fused_decode(params["bridge"]))
    if "layers" not in params["lm"] and not use_fused:
        raise ValueError(
            "params['lm'] carries only pre-stacked decode weights (stacked_decode), which "
            "serve only the fused stack decode, but that path cannot dispatch here "
            f"(kv_quant={gen.kv_quant}, cache rows "
            f"{gemma2.fused_cache_rows(gen.max_length + 1)} must fit "
            f"sliding_window={cfg.lm.sliding_window}). Rebuild the params with per-layer "
            "weights or use the fused serving recipe (int8 layers + int8 KV).")
    if vision_features is None:
        vision_features = full_model.encode_image(params, cfg, pixel_values)
    return _generate_fast(params, cfg, vision_features, gen, activation_dtype, generator,
                          use_fused, use_fused_bridge)
