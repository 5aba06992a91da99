"""The routed experts of the fused stack step on the card: the step with
experts (csrc/stack_step.cu: moe_route_kernel, moe_expert_kernel) against
its plain version at a small width and at Mellum2-12B's widths over two
layers, a second call's bits, the routing counters against the plain
version's; the stack's attention at 8, 4 and 2 query heads a KV head of 128
against the plain version; and the decode session's graphs against the
eager fused loop, token for token. These need an NVIDIA GPU with nvcc
(sm_90a) and skip elsewhere; run them on the card with

    python -m pytest --noconftest tests/test_torch_moe_cuda.py -q -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 3e-2  # x max|ref|: bf16 activations, another f32 summation order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = float((got.detach().float() - want.detach().float()).abs().max())
    assert err <= TOL * float(want.float().abs().max()), err


def _same_routing(klog, plog, k):
    """The kernel's routing log [L, B, E] of a position against the plain
    version's: k experts a row whose weights add to one, and, in the rows
    whose experts agree (all but a near-tie's), the same weights to 2e-3 (the
    rows h the routing reads differ by the products' bf16 rounding)."""
    assert ((klog > 0).sum(-1) == k).all()
    assert torch.allclose(klog.sum(-1), torch.ones_like(klog[..., 0]), atol=1e-5)
    agree = ((klog > 0) == (plog > 0)).all(-1)
    assert int((~agree).sum()) <= max(1, agree.numel() // 20), agree
    assert (klog - plog)[agree].abs().max() <= 2e-3


def _moe_cfg(**kw):
    from vlm_bridge_tpu_torch.configs import Gemma2MoEConfig

    base = dict(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                num_heads=8, num_kv_heads=1, head_dim=128, query_pre_attn_scalar=128.0,
                sliding_window=128, num_experts=8, experts_per_token=2,
                moe_intermediate_size=64, full_every=4)
    return Gemma2MoEConfig(**{**base, **kw})


def _run_steps(cfg, dev, B, T, seed=0):
    """T steps of the kernel and of the plain version from the same inputs
    and the same cache rows before t (the kernel's: a K/V code that rounds
    the other way would move a routing near-tie, which says nothing of the
    step): [(kernel out, a second call's, plain out, both counters, both
    routing logs at t)], and the caches."""
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    g = torch.Generator(device=dev).manual_seed(seed)
    q = gemma2.quantize_params(gemma2.init(cfg, generator=g, device=dev))
    st = gemma2.stack_decode_params(q, cfg)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              attn_scale=cfg.attn_scale, softcap=50.0, eps=1e-6,
              experts_per_token=cfg.experts_per_token, norm_topk_prob=cfg.norm_topk_prob)
    ck, cp = (gemma2.StackedKVCache.zeros(cfg, B, T, device=dev) for _ in range(2))
    dk.moe_counters(reset=True)
    outs = []
    for t in range(T):
        x = torch.randn(B, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)
        cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev),
                                                          cfg.head_dim, cfg.rope_theta))
        n = dk.fused_stack_step.moe_calls
        got = dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw)
        assert dk.fused_stack_step.moe_calls == n + 1
        kernel_counts = dk.moe_counters(reset=True)
        kernel_log = dk.moe_route_log()[t].clone()
        # a second call from the same cache rows (row t is rewritten with the same values)
        again = dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw)
        dk.moe_counters(reset=True)
        for a, b in zip(cp, ck):
            a[:, :, :, :t].copy_(b[:, :, :, :t])
        want = dk.fused_stack_step_plain(t, x, st, *cp, cos, sin, **kw)
        plain_counts = dk.moe_counters(reset=True)
        plain_log = dk.moe_route_log()[t].clone()
        outs.append((got, again, want, kernel_counts, plain_counts, kernel_log, plain_log))
    return outs, ck, cp


@pytest.mark.parametrize("B", [1, 5, 64])
def test_moe_stack_step_kernel_matches_plain(dev, B):
    outs, ck, cp = _run_steps(_moe_cfg(), dev, B, 4)
    for got, again, want, kc, pc, klog, plog in outs:
        _close(got, want)
        assert torch.equal(got, again)
        assert kc["rows"].sum() == B * 2 * 2
        # routing near-ties aside, the kernel routes as the plain version
        assert (kc["rows"] - pc["rows"]).abs().sum() <= 2
        _same_routing(klog, plog, 2)
    same = (ck.k.int() - cp.k.int()).abs() <= 1
    assert same.float().mean() > 0.99


def test_moe_stack_step_at_mellum2_widths(dev):
    """Two layers of Mellum2-12B-A2.5B: hidden 2304, 32 query over 4 KV heads
    of 128, 64 experts of 896, 8 a row, batch 64."""
    from vlm_bridge_tpu_torch.configs import Gemma2MoEConfig

    cfg = Gemma2MoEConfig.mellum2_12b()
    cfg = _moe_cfg(**{k: getattr(cfg, k) for k in (
        "hidden_size", "num_heads", "num_kv_heads", "head_dim", "query_pre_attn_scalar",
        "rope_theta", "num_experts", "experts_per_token", "moe_intermediate_size")})
    outs, _, _ = _run_steps(cfg, dev, 64, 3)
    for got, again, want, kc, pc, klog, plog in outs:
        _close(got, want)
        assert torch.equal(got, again)
        assert int(kc["rows"].sum()) == 2 * 64 * 8
        _same_routing(klog, plog, 8)


@pytest.mark.parametrize("nh,kh", [(8, 1), (16, 4), (8, 4)], ids=["G8", "G4", "G2"])
def test_stack_attention_at_head_width_128(dev, nh, kh):
    """A dense stack at D 128 with G = 8 (the new instantiation), 4 and 2."""
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    cfg = Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                       num_heads=nh, num_kv_heads=kh, head_dim=128, query_pre_attn_scalar=128.0,
                       sliding_window=128)
    g = torch.Generator(device=dev).manual_seed(1)
    st = gemma2.stack_decode_params(gemma2.quantize_params(
        gemma2.init(cfg, generator=g, device=dev)), cfg)
    kw = dict(num_heads=nh, num_kv_heads=kh, head_dim=128, attn_scale=cfg.attn_scale,
              softcap=50.0, eps=1e-6)
    ck, cp = (gemma2.StackedKVCache.zeros(cfg, 3, 70, device=dev) for _ in range(2))
    for t in (0, 1, 2, 65):
        x = torch.randn(3, 256, generator=g, device=dev).to(torch.bfloat16)
        cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), 128))
        got = dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw)
        want = dk.fused_stack_step_plain(t, x, st, *cp, cos, sin, **kw)
        _close(got, want)
        assert torch.equal(got, dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw))
    with pytest.raises(ValueError, match="head layout"):
        cfg16 = dict(kw, num_heads=16, num_kv_heads=1)
        dk.fused_stack_step(0, x, st, *ck, cos, sin, **cfg16)


def test_session_graphs_give_the_eager_tokens(dev, monkeypatch):
    """Greedy captions of a sparse decoder through the decode session (graphs
    captured by the first batch, replayed by the next) equal the eager fused
    loop's; every timed call of the step after the first batch is a replay."""
    from vlm_bridge_tpu_torch.configs import BridgeConfig, DinoV2Config, VLMConfig
    from vlm_bridge_tpu_torch.inference import generate as TG
    from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    monkeypatch.setattr(TG, "_SESSIONS", type(TG._SESSIONS)())
    cfg = VLMConfig(vision=DinoV2Config(hidden_size=128, num_layers=1, num_heads=2, mlp_ratio=2,
                                        patch_size=14, image_size=70),
                    lm=_moe_cfg(), image_size=70,
                    bridge=BridgeConfig(vision_dim=128, language_dim=256, num_blocks=2,
                                        num_heads_cross=4, num_heads_self=4, ffn_mult=2,
                                        dropout=0.0))
    new = 6
    gen = TG.GenerationConfig(max_length=new, greedy=True, kv_quant=True)
    g = torch.Generator(device=dev).manual_seed(11)
    params = full_model.init(cfg, generator=g, device=dev)
    params["lm"] = gemma2.quantize_params(params["lm"])
    params["bridge"] = bridge.quantize_decode_params(params["bridge"])
    params = prestack_decode_params(params, cfg, gen)
    assert "router" in params["lm"]["stacked_decode"]
    before = (dk.fused_stack_step.captures, dk.fused_stack_step.replays)
    for i in range(3):
        vision = torch.randn(5, 26, 128, generator=g, device=dev).to(torch.bfloat16)
        want = TG._generate_local(params, cfg, None, vision, None, gen, None, fused_ok=True,
                                  session_ok=False)[0]
        got, _ = TG.generate_tokens(params, cfg, vision_features=vision, gen=gen)
        assert torch.equal(got, want), (i, got, want)
    assert (dk.fused_stack_step.captures - before[0],
            dk.fused_stack_step.replays - before[1]) == (new, 2 * new)
    session = next(iter(TG._SESSIONS.values()))
    counts = dk.moe_counters(session.stack)
    assert int(counts["rows"].sum()) == 3 * new * 5 * 2 * 2
