"""The decode session (inference/generate._DecodeSession) and the fused
steps' per-position CUDA graphs (ops/decode_kernels.StepGraphs).

On the CPU: the session's RoPE rows are rope_table's bit for bit, its
normalizer keeps the cast to the activation dtype, sessions are keyed by the
weights and the decode shape, bounded in number and freed with the weights,
and the plain path builds no session and captures nothing.

On the card (`cuda`, skipped elsewhere), at tiny widths of two decoder
shapes: three batches of different vision features decode to the same
tokens through the graphs as through the eager fused steps (greedy, and
sampled from one generator seed; int8 and int4 MLP weights), each position
is captured once and then only replayed, a cross cache left stale would
show, dropping the params frees the session, and the wrappers refuse with
graphs what they refuse without. Run them on the card with

    python -m pytest --noconftest tests/test_torch_decode_graphs.py -q -m cuda
"""

from __future__ import annotations

import dataclasses
import gc
import weakref
from collections import OrderedDict

import pytest
import torch

from vlm_bridge_tpu_torch.configs import BridgeConfig, DinoV2Config, Gemma2Config, VLMConfig
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
from vlm_bridge_tpu_torch.ops import decode_kernels as dk
from vlm_bridge_tpu_torch.ops.layers import rope_table
from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

NEW = 6
BATCH = 4
# (num_heads, num_kv_heads, head_dim): four query heads a KV head, as
# Mistral-7B; two a KV head over two KV heads, as InternLM2-1.8B
SHAPES = {"gqa4": (4, 1, 128), "gqa2": (4, 2, 64)}


def _cfg(shape: str = "gqa2") -> VLMConfig:
    nh, kh, d = SHAPES[shape]
    return VLMConfig(
        vision=DinoV2Config(hidden_size=128, num_layers=1, num_heads=2, mlp_ratio=2,
                            patch_size=14, image_size=70),
        lm=Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=nh, num_kv_heads=kh, head_dim=d,
                        query_pre_attn_scalar=float(d), sliding_window=128),
        bridge=BridgeConfig(vision_dim=128, language_dim=256, num_blocks=2, num_heads_cross=4,
                            num_heads_self=4, ffn_mult=2, dropout=0.0),
        image_size=70)


def _serving_params(cfg: VLMConfig, dev, seed: int, gen=None) -> dict:
    """int8 decoder and bridge as the serving recipe holds them; with
    `gen`, the decoder stacked once (prestack_decode_params)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    params = full_model.init(cfg, generator=g, device=dev)
    params["lm"] = gemma2.quantize_params(params["lm"])
    params["bridge"] = bridge.quantize_decode_params(params["bridge"])
    return params if gen is None else prestack_decode_params(params, cfg, gen)


def _vision(cfg: VLMConfig, dev, seed: int, batch: int = BATCH) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(batch, 26, cfg.bridge.vision_dim, generator=g, device=dev).to(
        torch.bfloat16)


@pytest.fixture
def sessions(monkeypatch):
    """An empty session cache for the test."""
    monkeypatch.setattr(TG, "_SESSIONS", OrderedDict())
    return TG._SESSIONS


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim,theta", [(64, 10000.0), (128, 1e6), (256, 10000.0)])
def test_rope_rows_are_rope_table_at_every_position(head_dim, theta):
    lm = dataclasses.replace(_cfg().lm, head_dim=head_dim, rope_theta=theta)
    cos, sin = gemma2.rope_rows(lm, 65)
    assert cos.shape == sin.shape == (65, head_dim) and cos.dtype == torch.float32
    for t in range(65):
        c, s = rope_table(torch.tensor([t]), head_dim, theta)
        assert torch.equal(cos[t], c[0]) and torch.equal(sin[t], s[0])


@pytest.mark.parametrize("hidden", [256, 2048, 4096])
def test_normalizer_keeps_its_cast_to_the_activation_dtype(hidden):
    lm = dataclasses.replace(_cfg().lm, hidden_size=hidden)
    for dtype in (torch.bfloat16, torch.float32):
        n = gemma2.embed_normalizer(lm, dtype)
        assert n.dtype == dtype and n.shape == ()
        assert torch.equal(n, torch.tensor(hidden ** 0.5, dtype=dtype))
    # the bf16 cast rounds √H (2048: 45.25, not 45.2548...)
    if hidden == 2048:
        assert float(gemma2.embed_normalizer(lm, torch.bfloat16)) == 45.25


@pytest.mark.parametrize("step", ["stacked", "per_layer_fused"])
def test_decode_steps_take_the_loops_rows_or_build_the_same(step):
    """decode_step_stacked and decode_step_fused with the loop's rows and
    normalizer give the bits of the same step building its own."""
    cfg = _cfg()
    gen = TG.GenerationConfig(max_length=NEW, kv_quant=True)
    params = _serving_params(cfg, "cpu", 3, gen if step == "stacked" else None)
    lm = params["lm"]
    if step == "stacked":
        def run(cache, t, **kw):
            return gemma2.decode_step_stacked(lm, cfg.lm, lm["stacked_decode"], x, cache, t, **kw)
        zeros = gemma2.StackedKVCache.zeros
    else:
        def run(cache, t, **kw):
            return gemma2.decode_step_fused(lm, cfg.lm, x, cache, t, **kw)
        zeros = gemma2.FusedKVCache.zeros
    x = torch.randn(2, 1, 256, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    rope = gemma2.rope_rows(cfg.lm, NEW + 1)
    norm = gemma2.embed_normalizer(cfg.lm, x.dtype)
    own, given = zeros(cfg.lm, 2, NEW + 1), zeros(cfg.lm, 2, NEW + 1)
    for t in range(3):
        h1, _ = run(own, t)
        h2, _ = run(given, t, rope=rope, normalizer=norm)
        assert torch.equal(h1, h2)
    flat = (lambda c: list(c)) if step == "stacked" else (lambda c: [a for f in c for a in f])
    assert all(torch.equal(a, b) for a, b in zip(flat(own), flat(given)))


@pytest.mark.parametrize("prestacked", [True, False], ids=["prestacked", "per_layer"])
def test_sessions_are_keyed_by_weights_and_shape_and_bounded(sessions, prestacked):
    cfg = _cfg()
    gen = TG.GenerationConfig(max_length=NEW, kv_quant=True)
    params = _serving_params(cfg, "cpu", 4, gen if prestacked else None)
    vision = _vision(cfg, "cpu", 0)

    def get(p=params, v=vision, g=gen, dtype=torch.bfloat16):
        return TG._decode_session(p, cfg, g, p["bridge"], v, dtype, True)

    first = get()
    assert get() is first and len(sessions) == 1
    assert first.stack.x.shape == (BATCH, 256) and first.bridge.x.shape == (BATCH, 256)
    assert (first.stacked is None) == prestacked
    assert first.bridge_cache.cross_k.shape == (2, BATCH, 4, 26, 64)
    # another batch size, length, dtype or set of weights is another session
    assert get(v=_vision(cfg, "cpu", 0, batch=3)) is not first
    assert get(g=dataclasses.replace(gen, max_length=NEW - 1)) is not first
    assert get(dtype=torch.float32) is not first
    assert len(sessions) == 4
    # the layers are stacked once for every shape
    assert all((s.stacked is None) if prestacked else (s.stacked is first.stacked)
               for s in sessions.values())
    other = _serving_params(cfg, "cpu", 5, gen if prestacked else None)
    newest = get(p=other)
    # bounded: the least recently used went
    assert len(sessions) == TG._MAX_SESSIONS == 4 and first not in sessions.values()
    assert newest in sessions.values() and get(p=other) is newest


def test_dropping_the_params_frees_the_session(sessions):
    cfg = _cfg()
    gen = TG.GenerationConfig(max_length=NEW, kv_quant=True)
    params = _serving_params(cfg, "cpu", 6, gen)
    keep = _serving_params(cfg, "cpu", 7, gen)
    vision = _vision(cfg, "cpu", 1)
    ref = weakref.ref(TG._decode_session(params, cfg, gen, params["bridge"], vision,
                                         torch.bfloat16, True))
    kept = TG._decode_session(keep, cfg, gen, keep["bridge"], vision, torch.bfloat16, True)
    assert len(sessions) == 2
    del params
    gc.collect()
    assert ref() is None and list(sessions.values()) == [kept]


def test_the_plain_path_builds_no_session_and_captures_nothing(sessions):
    cfg = _cfg()
    gen = TG.GenerationConfig(max_length=NEW, greedy=True, kv_quant=True)
    params = _serving_params(cfg, "cpu", 8, gen)
    counts = [(f.launches, f.captures, f.replays)
              for f in (dk.fused_stack_step, dk.fused_bridge_step)]
    toks, _ = TG.generate_tokens(params, cfg, vision_features=_vision(cfg, "cpu", 2), gen=gen)
    assert toks.shape == (BATCH, NEW + 1) and not sessions
    assert counts == [(f.launches, f.captures, f.replays)
                      for f in (dk.fused_stack_step, dk.fused_bridge_step)]


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _eager(params, cfg, vision, gen, generator):
    return TG._generate_local(params, cfg, None, vision, generator, gen, None, fused_ok=True,
                              session_ok=False)[0]


def _counts():
    return [(f.captures, f.replays) for f in (dk.fused_stack_step, dk.fused_bridge_step)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("mlp4", [False, True], ids=["mlp8", "mlp4"])
def test_graphs_give_the_eager_tokens_and_capture_each_position_once(dev, sessions, shape,
                                                                      sampled, mlp4):
    cfg = _cfg(shape)
    gen = TG.GenerationConfig(max_length=NEW, greedy=not sampled, kv_quant=True,
                              mlp_int4=mlp4, mlp_int4_group=128)
    params = _serving_params(cfg, dev, 11, gen)
    assert ("wgu4" in params["lm"]["stacked_decode"]) == mlp4
    visions = [_vision(cfg, dev, 20 + i) for i in range(3)]
    g_eager = torch.Generator(device=dev).manual_seed(99)
    g_graph = torch.Generator(device=dev).manual_seed(99)
    before = _counts()
    for i, vision in enumerate(visions):
        want = _eager(params, cfg, vision, gen, g_eager)
        got, _ = TG.generate_tokens(params, cfg, vision_features=vision, generator=g_graph,
                                    gen=gen)
        assert torch.equal(got, want), (i, got, want)
        # a new tensor each batch: the session's buffers serve the next one
        assert got.data_ptr() != next(iter(sessions.values())).toks.data_ptr()
        (sc, sr), (bc, br) = (tuple(a - b for a, b in zip(n, o))
                              for n, o in zip(_counts(), before))
        assert (sc, bc) == (NEW, NEW) and (sr, br) == (NEW * i, NEW * i)
    session = next(iter(sessions.values()))
    assert session.stack.positions == session.bridge.positions == list(range(NEW))


@pytest.mark.cuda
def test_a_stale_cross_cache_would_show(dev, sessions, monkeypatch):
    """The batches' tokens differ, and a session that kept the first batch's
    cross K/V gives the second batch other tokens than the eager path."""
    cfg = _cfg("gqa4")
    gen = TG.GenerationConfig(max_length=NEW, greedy=True, kv_quant=True)
    params = _serving_params(cfg, dev, 12, gen)
    visions = [_vision(cfg, dev, 30 + i) for i in range(2)]
    want = [_eager(params, cfg, v, gen, None) for v in visions]
    assert not torch.equal(want[0], want[1])
    real, seen = TG._DecodeSession.begin, []

    def stale(self, cross):
        seen.append(cross)
        real(self, seen[0])

    monkeypatch.setattr(TG._DecodeSession, "begin", stale)
    got = [TG.generate_tokens(params, cfg, vision_features=v, gen=gen)[0] for v in visions]
    assert torch.equal(got[0], want[0]) and not torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_dropping_the_params_frees_the_session_and_its_graphs(dev, sessions):
    cfg = _cfg("gqa2")
    gen = TG.GenerationConfig(max_length=NEW, greedy=True, kv_quant=True)
    params = _serving_params(cfg, dev, 13, gen)
    TG.generate_tokens(params, cfg, vision_features=_vision(cfg, dev, 3), gen=gen)
    session = next(iter(sessions.values()))
    refs = [weakref.ref(session), weakref.ref(session.stack), weakref.ref(session.bridge)]
    assert session.stack.positions == list(range(NEW))
    del session, params
    gc.collect()
    assert not sessions and all(r() is None for r in refs)


@pytest.mark.cuda
def test_wrappers_refuse_with_graphs_what_they_refuse_without(dev):
    """Validation runs before a capture: an unsupported head layout or head
    width raises, and nothing is captured."""
    cfg = Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=1,
                       num_heads=8, num_kv_heads=1, head_dim=64, query_pre_attn_scalar=64.0,
                       sliding_window=128)
    g = torch.Generator(device=dev).manual_seed(82)
    st = gemma2.stack_decode_params(gemma2.quantize_params(gemma2.init(cfg, generator=g,
                                                                       device=dev)), cfg)
    c = gemma2.StackedKVCache.zeros(cfg, 2, 8, device=dev)
    graphs = dk.StepGraphs(torch.zeros(2, 256, device=dev, dtype=torch.bfloat16))
    one = torch.ones(64, device=dev)
    before = _counts()
    with pytest.raises(ValueError, match="head layout"):
        dk.fused_stack_step(0, graphs.x, st, *c, one, one * 0, num_heads=8, num_kv_heads=1,
                            head_dim=64, attn_scale=0.125, softcap=50.0, eps=1e-6,
                            graphs=graphs)
    bc = BridgeConfig(vision_dim=64, language_dim=192, num_blocks=1, num_heads_cross=2,
                      num_heads_self=2, ffn_mult=2)
    bq = bridge.quantize_decode_params(bridge.init(bc, generator=g, device=dev))
    cache = TG._build_cross_cache(bq, bc, torch.zeros(2, 5, 64, device=dev,
                                                      dtype=torch.bfloat16),
                                  4, torch.bfloat16, kv_quant=True)
    bgraphs = dk.StepGraphs(torch.zeros(2, 192, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head widths"):
        dk.fused_bridge_step(0, bgraphs.x, bridge.stack_bridge_decode_params(bq, bc),
                             cache.cross_k, cache.cross_k_scale, cache.cross_v,
                             cache.cross_v_scale, cache.self_k, cache.self_v,
                             num_heads_cross=2, num_heads_self=2, eps=1e-5, graphs=bgraphs)
    assert _counts() == before and graphs.positions == bgraphs.positions == []
