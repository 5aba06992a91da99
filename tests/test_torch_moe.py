"""The port's decoder with routed experts (configs.Gemma2MoEConfig) on the
CPU, at the tiny preset (8 query heads over one KV head, 8 experts of 64, 2
a token) with seeded random weights, held to the benchmark's plain
reference (portbench/reference/moe.py, float32 torch, nothing of the port):
the full-sequence forward, the fused stack step's plain version through the
int8 cache, prefill then a cached decode step, the routing's tie rule and
renormalization by hand, captions through the fused decode loop, a dense
stack unchanged, and the experts' shares adding up to the whole layer."""

import dataclasses

import pytest
import torch

from portbench.reference import model as ref_model
from portbench.reference import moe as ref_moe
from vlm_bridge_tpu_torch.configs import (BridgeConfig, DinoV2Config, Gemma2Config,
                                          Gemma2MoEConfig, VLMConfig, num_experts)
from vlm_bridge_tpu_torch.models import full_model, gemma2
from vlm_bridge_tpu_torch.ops import decode_kernels as dk

CFG = Gemma2MoEConfig.tiny_test()


def _ref_cfg(cfg) -> tuple:
    """The reference's "lm" and "moe" blocks of a config."""
    lm = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(Gemma2Config)}
    moe = {k: getattr(cfg, k) for k in ("num_experts", "experts_per_token",
                                        "moe_intermediate_size", "norm_topk_prob", "full_every")}
    return lm, moe


def _params(seed=0, dtype=torch.float32, cfg=CFG):
    return gemma2.init(cfg, generator=torch.Generator().manual_seed(seed), dtype=dtype)


def _ref_decoder(p, x, forms, kv8, cfg=CFG):
    lm, moe = _ref_cfg(cfg)
    return ref_moe.decoder(p, lm, moe, x, lambda i: p["layers"][str(i)]["mlp"], forms=forms,
                           kv8=kv8)


def test_the_preset_and_the_dense_config():
    assert CFG.num_heads // CFG.num_kv_heads == 8 and num_experts(CFG) == 8
    assert [CFG.layer_is_sliding(i) for i in range(4)] == [True, True, True, False]
    mellum = Gemma2MoEConfig.mellum2_12b()
    assert [i for i in range(28) if not mellum.layer_is_sliding(i)] == list(range(3, 28, 4))
    assert num_experts(Gemma2Config.tiny_test()) == 0
    # the base class keeps its fields: the parity test with the JAX package holds
    assert not {"num_experts", "full_every"} & {f.name for f in dataclasses.fields(Gemma2Config)}


def test_forward_hidden_matches_the_reference():
    """Float weights, f32 on both sides, the same operations: to f32 rounding
    (1e-5 of the largest value; the two sum the same terms in another order)."""
    p = _params()
    x = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(1)) * 0.05
    got = gemma2.forward_hidden(p, CFG, x)
    want = _ref_decoder(p, x, {}, False)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _serving(seed=0):
    p = _params(seed, torch.bfloat16)
    return p, gemma2.quantize_params(p, parts=("embedding", "mlp", "attn"))


def test_stacked_plain_step_through_the_int8_cache_matches_the_reference():
    """The fused stack step's plain version, position by position through the
    int8 cache, against the reference's full forward with int8 weights and
    cache: to f32 rounding (1e-5; the routing reads h's bf16 hi + lo halves,
    16 bits, which moves no choice at these margins)."""
    raw, q = _serving()
    st = gemma2.stack_decode_params(q, CFG)
    assert {"router", "ewgu", "egu_scale", "ewd", "ed_scale"} <= set(st)
    assert not {"wgu", "wd", "wgu4"} & set(st)
    B, T = 3, 6
    xs = torch.randn(B, T, 64, generator=torch.Generator().manual_seed(2)) * 0.05
    kv = gemma2.StackedKVCache.zeros(CFG, B, T)
    got = torch.cat([gemma2.decode_step_stacked(q, CFG, st, xs[:, t:t + 1], kv, t)[0]
                     for t in range(T)], dim=1)
    want = _ref_decoder(raw, xs, {"attn": "int8", "mlp": "int8"}, True)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    lm, _ = _ref_cfg(CFG)
    logits = gemma2.logits_from_hidden(q, CFG, got[:, -1:])
    ref_logits = ref_model.logits(lm, ref_model.table(raw, {"table": "int8"}), want[:, -1:])
    assert float((logits - ref_logits).abs().max()) <= 1e-4


def test_prefill_then_a_cached_step_matches_the_reference():
    """Prefill of a prompt (int8 cache), then one decode step: the last
    position's logits against the reference's full forward. The prefill
    attends through the prompt's float K/V where the reference reads them
    int8 at every layer, so the two differ by the cache's rounding: 2e-2 of
    the largest logit."""
    raw, q = _serving(3)
    B, T = 2, 5
    xs = torch.randn(B, T + 1, 64, generator=torch.Generator().manual_seed(4)) * 0.05
    cache = gemma2.KVCache.zeros(CFG, B, T + 1, dtype=torch.int8)
    _, cache = gemma2.prefill(q, CFG, xs[:, :T], cache)
    hidden, cache = gemma2.decode_step(q, CFG, xs[:, T:], cache, position=T)
    lm, _ = _ref_cfg(CFG)
    tab = ref_model.table(raw, {"table": "int8"})
    want = ref_model.logits(lm, tab, _ref_decoder(raw, xs, {"attn": "int8", "mlp": "int8"},
                                                  True)[:, -1:])
    got = gemma2.logits_from_hidden(q, CFG, hidden)
    assert float((got - want).abs().max()) <= 2e-2 * float(want.abs().max())


def test_routing_tie_rule_and_renormalization_by_hand():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0], [0.0, 0.0, 9.0, 1.0]])
    w, e = dk.moe_route(logits, 2, True)
    assert e.tolist() == [[1, 2], [0, 1], [2, 3]]    # ties to the lower index
    p = torch.softmax(logits, dim=-1)
    sel = p.gather(1, e)
    assert torch.allclose(w, sel / sel.sum(1, keepdim=True))
    assert torch.allclose(w[:2], torch.full((2, 2), 0.5))
    w_raw, _ = dk.moe_route(logits, 2, False)
    assert torch.allclose(w_raw, sel)
    dense = dk.moe_dense_weights(w, e, 4)
    assert dense.tolist()[1] == [0.5, 0.5, 0.0, 0.0]
    assert torch.allclose(dense.sum(1), torch.ones(3))


def _vlm(lm=CFG) -> VLMConfig:
    return VLMConfig(vision=DinoV2Config.tiny_test(), lm=lm, bridge=BridgeConfig.tiny_test(),
                     image_size=70)


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_captions_through_the_fused_decode_loop(greedy):
    """generate_tokens on a sparse VLMConfig takes the fused stack step
    (routing counted by its counters: every row to k experts, every layer,
    every token) and gives the same tokens for the same seed."""
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens

    cfg = _vlm()
    params = full_model.init(cfg, generator=torch.Generator().manual_seed(5),
                             frozen_dtype=torch.float32)
    params["lm"] = gemma2.quantize_params(params["lm"])
    assert gemma2.supports_fused_decode(params["lm"], CFG, 9)
    vision = torch.randn(3, cfg.num_vision_tokens, 32, generator=torch.Generator().manual_seed(6))
    gen = GenerationConfig(max_length=8, greedy=greedy, kv_quant=True)
    runs = []
    for _ in range(2):
        dk.moe_counters(reset=True)
        toks, lens = generate_tokens(params, cfg, vision_features=vision, gen=gen,
                                     generator=torch.Generator().manual_seed(7))
        counts = dk.moe_counters(reset=True)
        assert counts["rows"].shape == (4, 8)
        assert counts["rows"].sum(1).tolist() == [3 * 2 * 8] * 4
        # the routing log: at each of the 8 positions, layer and row, 2 experts
        # whose weights add to one
        log = dk.moe_route_log()[:8]
        assert log.shape[1:] == (4, 3, 8)
        assert ((log > 0).sum(-1) == 2).all()
        assert torch.allclose(log.sum(-1), torch.ones(8, 4, 3))
        runs.append(toks)
    assert torch.equal(runs[0], runs[1])
    assert toks.shape == (3, 9) and (toks[:, 0] == CFG.bos_token_id).all()
    assert ((toks >= 0) & (toks < CFG.vocab_size)).all()


def test_a_dense_stack_is_unchanged():
    """A dense stacked dict carries today's fields, its step ignores the
    routing arguments, and it agrees with the dense reference."""
    cfg = dataclasses.replace(Gemma2Config.tiny_test(), sliding_window=64)
    raw = _params(8, torch.bfloat16, cfg)
    q = gemma2.quantize_params(raw, parts=("embedding", "mlp", "attn"))
    st = gemma2.stack_decode_params(q, cfg)
    assert set(st) == {"wqkv", "qkv_scale", "wo", "o_scale", "norms", "wgu", "gu_scale", "wd",
                       "d_scale"}
    B = 2
    x = torch.randn(B, 64, generator=torch.Generator().manual_seed(9)) * 0.05
    cos, sin = (a[0] for a in gemma2.rope_rows(cfg, 1))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              attn_scale=cfg.attn_scale, softcap=50.0, eps=cfg.rms_norm_eps)
    a = dk.fused_stack_step(0, x, st, *gemma2.StackedKVCache.zeros(cfg, B, 1), cos, sin, **kw)
    b = dk.fused_stack_step(0, x, st, *gemma2.StackedKVCache.zeros(cfg, B, 1), cos, sin,
                            experts_per_token=8, norm_topk_prob=False, **kw)
    assert torch.equal(a, b)
    lm = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(Gemma2Config)}
    # the step takes the embeddings scaled by sqrt(H) = 8, the reference scales them itself
    want = ref_model.decoder(raw, lm, x[:, None] / 8, forms={"attn": "int8", "mlp": "int8"},
                             kv8=True)
    got = gemma2.rms_norm(a[:, None], q["final_norm"], cfg.rms_norm_eps)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_experts_shares_add_up_to_the_whole_layer():
    """Experts cut into shares (as expert parallelism holds them: each share
    its own experts, the routing over all of them) each give their experts'
    weighted part for the rows routed to them; the parts add up to the
    uncut reference's whole routed feed-forward."""
    p = _params(10)
    mlp = p["layers"]["0"]["mlp"]
    y = torch.randn(11, 64, generator=torch.Generator().manual_seed(11))
    _, moe = _ref_cfg(CFG)
    whole = ref_moe.moe_ffn(y, mlp, moe)
    assert torch.allclose(gemma2._mlp_block(p["layers"]["0"], y, CFG), whole, atol=1e-5)
    w, e = dk.moe_route(y @ mlp["router"], CFG.experts_per_token, CFG.norm_topk_prob)
    parts = []
    for share in (range(0, 3), range(3, 5), range(5, 8)):
        part = torch.zeros_like(y)
        for x in share:
            rows, slot = (e == x).nonzero(as_tuple=True)
            part.index_add_(0, rows, gemma2._expert(mlp, x, y[rows]) * w[rows, slot, None])
        parts.append(part)
    assert torch.allclose(sum(parts), whole, atol=1e-5)
    assert all(float(pt.abs().max()) > 0 for pt in parts)


def test_the_per_layer_fused_decode_refuses_experts():
    with pytest.raises(ValueError, match="decode_step_stacked"):
        gemma2.decode_step_fused({}, CFG, torch.zeros(1, 1, 64), None, 0)
