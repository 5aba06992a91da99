"""PyTorch port, the per-layer decode path and the sampled slice as a whole,
against the JAX package on tiny presets at f32 (CPU: every int8 function
runs its plain version here and its jnp fallback there).

- gemma2.KVCache / prefill / decode_step against the JAX functions: float
  and int8 weights, f32 and int8 caches, a padded prefill followed by ragged
  per-row steps, lockstep steps from an empty cache, with a sliding window of
  4 that binds. Hidden states within HIDDEN_TOL x max|ref| (f32 algebra in
  another summation order; an int8 cache adds a code on a rounding tie).
- generate_tokens: greedy ids of the per-layer int8 path IDENTICAL to the
  JAX package's generate_tokens(greedy=True, force_jnp=True) on weights
  carried across by from_jax, for kv_quant and bypass_bridge on and off and
  for a window that binds; sampled runs repeat under one seed.
- inference.robust and the CLI's sampling flags.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import Gemma2Config, VLMConfig
from vlm_bridge_tpu.inference import generate as JG
from vlm_bridge_tpu.inference import robust as JR
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.inference import robust as TR
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import decode_kernels as tdk
from vlm_bridge_tpu_torch.ops import quant as tq
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

HIDDEN_TOL = 2e-4
MAX_NEW = 8


# ---------------------------------------------------------------------------
# gemma2.KVCache / prefill / decode_step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm_setup():
    cfg = dataclasses.replace(Gemma2Config.tiny_test(), sliding_window=4)
    assert cfg.layer_is_sliding(0) != cfg.layer_is_sliding(1)
    params = jg.init(jax.random.key(1), cfg, dtype=jnp.float32)
    trees = {"float": jax.tree.map(np.array, params),
             "int8": jax.tree.map(np.array, jg.quantize_params(params))}
    rng = np.random.default_rng(2)
    B, T = 3, 6
    embeds = rng.normal(0, 1, (B, T + 4, cfg.hidden_size)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([6, 3, 5])[:, None]).astype(np.int32)
    return cfg, trees, embeds, mask, T


def _close(got, want, tol=HIDDEN_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * float(np.abs(want).max())


def _caches_agree(ct, cj, quantized):
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
    assert ct.length.dtype == torch.int32
    if quantized:
        for a, b in ((ct.k, cj.k), (ct.v, cj.v)):
            diff = np.abs(a.numpy().astype(np.int32) - np.asarray(b).astype(np.int32))
            assert diff.max() <= 1 and (diff == 0).mean() > 0.999
        _close(ct.k_scale, cj.k_scale, 1e-6)
        _close(ct.v_scale, cj.v_scale, 1e-6)
    else:
        _close(ct.k, cj.k)
        _close(ct.v, cj.v)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("weights", ["float", "int8"])
def test_prefill_then_ragged_decode_matches_jax(lm_setup, weights, cache):
    """A right-padded prompt (lengths 6, 3, 5), then four steps in which
    every row writes at its own length: rows past the window of 4 on the
    sliding layer from the first step on."""
    cfg, trees, embeds, mask, T = lm_setup
    pj, pt = trees[weights], from_jax(trees[weights])
    quantized = cache == "int8"
    cj = jg.KVCache.zeros(cfg, 3, T + 4, dtype=jnp.int8 if quantized else jnp.float32)
    ct = tg.KVCache.zeros(P(cfg), 3, T + 4, dtype=torch.int8 if quantized else torch.float32)
    assert ct.quantized == cj.quantized == quantized
    assert tuple(ct.k.shape) == tuple(cj.k.shape)
    hj, cj = jg.prefill(pj, cfg, jnp.asarray(embeds[:, :T]), cj, attn_mask=jnp.asarray(mask))
    with torch.no_grad():
        ht, ct = tg.prefill(pt, P(cfg), torch.from_numpy(embeds[:, :T]), ct,
                            attn_mask=torch.from_numpy(mask))
    _close(ht, hj)
    _caches_agree(ct, cj, quantized)
    for s in range(4):
        e = embeds[:, T + s: T + s + 1]
        hj, cj = jg.decode_step(pj, cfg, jnp.asarray(e), cj)
        with torch.no_grad():
            ht, ct = tg.decode_step(pt, P(cfg), torch.from_numpy(e), ct)
        _close(ht, hj)
    assert ct.length.tolist() == [10, 7, 9]
    _caches_agree(ct, cj, quantized)


@pytest.mark.parametrize("cache", ["f32", "int8"])
@pytest.mark.parametrize("weights", ["float", "int8"])
def test_lockstep_decode_matches_jax(lm_setup, weights, cache):
    """position=t from an empty cache, seven steps: the window of 4 binds from
    t = 4 on. With an f32 cache a prefill without a mask gives the same last
    hidden state and the same cache as the steps (with an int8 cache the
    steps attend quantized keys and the prefill does not)."""
    cfg, trees, embeds, _, _ = lm_setup
    pj, pt = trees[weights], from_jax(trees[weights])
    quantized = cache == "int8"
    cj = jg.KVCache.zeros(cfg, 3, 8, dtype=jnp.int8 if quantized else jnp.float32)
    ct = tg.KVCache.zeros(P(cfg), 3, 8, dtype=torch.int8 if quantized else torch.float32)
    for t in range(7):
        e = embeds[:, t: t + 1]
        hj, cj = jg.decode_step(pj, cfg, jnp.asarray(e), cj, position=jnp.int32(t))
        with torch.no_grad():
            ht, ct = tg.decode_step(pt, P(cfg), torch.from_numpy(e), ct, position=t)
        _close(ht, hj)
    assert ct.length.tolist() == [7, 7, 7]
    _caches_agree(ct, cj, quantized)
    c2 = tg.KVCache.zeros(P(cfg), 3, 8, dtype=torch.int8 if quantized else torch.float32)
    with torch.no_grad():
        h2, c2 = tg.prefill(pt, P(cfg), torch.from_numpy(embeds[:, :7]), c2)
    assert c2.length.tolist() == [7, 7, 7]
    if not quantized:
        _close(h2[:, -1:], hj)
        _close(c2.k[:, :, :7], np.asarray(cj.k)[:, :, :7])


def test_logits_from_hidden_and_mlp_on_int8_weights_match_jax(lm_setup):
    cfg, trees, embeds, _, _ = lm_setup
    pj, pt = trees["int8"], from_jax(trees["int8"])
    h = embeds[:, :2]
    want = jg.logits_from_hidden(pj, cfg, jnp.asarray(h))
    got = tg.logits_from_hidden(pt, P(cfg), torch.from_numpy(h))
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)
    assert float(got.abs().max()) <= cfg.final_logit_softcap
    lp_j, lp_t = pj["layers"]["0"], pt["layers"]["0"]
    _close(tg._mlp_block(lp_t, torch.from_numpy(h)), jg._mlp_block(lp_j, jnp.asarray(h)), 1e-5)


# ---------------------------------------------------------------------------
# the slice as a whole: generate_tokens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_setup():
    base = VLMConfig.tiny_test()
    cfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, sliding_window=128))

    @jax.jit
    def build(key):
        p = jfm.init(key, cfg, frozen_dtype=jnp.float32)
        return p, {**p, "lm": jg.quantize_params(p["lm"]),
                   "bridge": jb.quantize_decode_params(p["bridge"])}

    f, q = (jax.tree.map(np.array, t) for t in build(jax.random.key(3)))
    # EOS made a slightly stronger copy of token 13, so that some rows end early
    E = q["lm"]["embedding"]
    E["w_int8"][cfg.lm.eos_token_id] = E["w_int8"][13]
    E["scale"][cfg.lm.eos_token_id] = E["scale"][13] * 1.05
    pixels = np.random.default_rng(0).normal(
        0, 1, (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return cfg, {"float": f, "int8": q}, pixels


def _window(cfg, window):
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, sliding_window=window))


def _port(cfg, params, pixels, generator=None, **kw):
    gen = TG.GenerationConfig(max_length=MAX_NEW, **kw)
    toks, lens = TG.generate_tokens(params, P(cfg), pixel_values=torch.from_numpy(pixels),
                                    generator=generator, gen=gen,
                                    activation_dtype=torch.float32)
    return toks.numpy(), lens.numpy()


GREEDY_CASES = [
    # weights, kv_quant, bypass_bridge, sliding window
    ("int8", False, False, 128), ("int8", True, False, 128),
    ("int8", False, True, 128), ("int8", True, True, 128),
    ("int8", False, False, 4), ("int8", True, False, 4),
    ("float", False, False, 128),
]


@pytest.mark.parametrize("weights,kv_quant,bypass,window", GREEDY_CASES,
                         ids=[f"{w}-kvq{int(k)}-bypass{int(b)}-win{n}"
                              for w, k, b, n in GREEDY_CASES])
def test_per_layer_greedy_ids_identical_to_jax(slice_setup, weights, kv_quant, bypass, window):
    cfg, trees, pixels = slice_setup
    cfg = _window(cfg, window)
    kw = dict(greedy=True, force_jnp=True, kv_quant=kv_quant, bypass_bridge=bypass)
    want_t, want_l = JG.generate_tokens(
        trees[weights], cfg, pixel_values=jnp.asarray(pixels),
        gen=JG.GenerationConfig(max_length=MAX_NEW, **kw), activation_dtype=jnp.float32)
    counted = (tdk.fused_stack_step, tdk.fused_bridge_step, tq.int8_matmul, tq.int8_mlp,
               tq.int8_ffn, tq.int8_matmul_t, tq.int8_matmul_t_argmax)
    before = [fn.launches for fn in counted]
    got_t, got_l = _port(cfg, from_jax(trees[weights]), pixels, **kw)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))
    assert got_t.dtype == np.int32 and (got_t[:, 0] == cfg.lm.bos_token_id).all()
    assert [fn.launches for fn in counted] == before   # CPU tensors launch nothing


def test_dispatch_follows_the_jax_package(slice_setup):
    """kv_quant with int8 layers and a cache inside the window takes the fused
    stack step; no kv_quant, force_jnp, float layers or a window of 4 take
    the per-layer path; stacking ahead of time happens only for the former."""
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    cfg, trees, _ = slice_setup
    q, f = from_jax(trees["int8"]), from_jax(trees["float"])
    G = TG.GenerationConfig
    avail = TG._fused_decode_available
    assert avail(q, P(cfg), G(max_length=MAX_NEW, kv_quant=True))
    assert not avail(q, P(cfg), G(max_length=MAX_NEW, kv_quant=False))
    assert not avail(q, P(cfg), G(max_length=MAX_NEW, kv_quant=True, force_jnp=True))
    assert not avail(f, P(cfg), G(max_length=MAX_NEW, kv_quant=True))
    assert not avail(q, P(_window(cfg, 4)), G(max_length=MAX_NEW, kv_quant=True))
    for gen, conf in ((G(max_length=MAX_NEW, kv_quant=False), cfg),
                      (G(max_length=MAX_NEW, kv_quant=True, force_jnp=True), cfg),
                      (G(max_length=MAX_NEW, kv_quant=True), _window(cfg, 4))):
        assert prestack_decode_params(q, P(conf), gen) is q
    assert "stacked_decode" in prestack_decode_params(
        q, P(cfg), G(max_length=MAX_NEW, kv_quant=True))["lm"]
    # the defaults are the JAX package's
    shared = {f.name for f in dataclasses.fields(JG.GenerationConfig)}
    assert {f.name for f in dataclasses.fields(G)} == shared
    assert dataclasses.asdict(G()) == dataclasses.asdict(JG.GenerationConfig())


def test_debug_force_jnp_variable_pins_the_per_layer_path(slice_setup, monkeypatch):
    """VLM_BRIDGE_DEBUG_FORCE_JNP does what force_jnp does, in both packages:
    the per-layer path serves int8 layers with the int8 KV cache (ids equal
    to the JAX package's under the same variable), the per-layer dicts are
    kept rather than stacked, and pre-stacked weights raise."""
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    cfg, trees, pixels = slice_setup
    q = from_jax(trees["int8"])
    gen = TG.GenerationConfig(max_length=MAX_NEW, kv_quant=True)
    stacked = prestack_decode_params(q, P(cfg), gen)
    assert "stacked_decode" in stacked["lm"] and "layers" not in stacked["lm"]
    assert TG._fused_decode_available(q, P(cfg), gen)

    monkeypatch.setenv("VLM_BRIDGE_DEBUG_FORCE_JNP", "1")
    assert not TG._fused_decode_available(q, P(cfg), gen)
    assert prestack_decode_params(q, P(cfg), gen) is q
    for avail, conf in ((TG._fused_decode_available, P(cfg)),
                        (JG._fused_decode_available, cfg)):
        with pytest.raises(ValueError, match="pre-stacked"):
            avail({**stacked, "lm": {"stacked_decode": stacked["lm"]["stacked_decode"]}}, conf,
                  gen)
    served = []
    real = TG._generate_fast
    monkeypatch.setattr(TG, "_generate_fast",
                        lambda *a: served.append(a[-2:]) or real(*a))
    want_t, want_l = JG.generate_tokens(
        trees["int8"], cfg, pixel_values=jnp.asarray(pixels),
        gen=JG.GenerationConfig(max_length=MAX_NEW, greedy=True, kv_quant=True),
        activation_dtype=jnp.float32)
    got_t, got_l = _port(cfg, q, pixels, greedy=True, kv_quant=True)
    assert served == [(False, False)]   # (use_fused, use_fused_bridge)
    np.testing.assert_array_equal(got_t, np.asarray(want_t))
    np.testing.assert_array_equal(got_l, np.asarray(want_l))


SAMPLED_CASES = [("int8", False, False), ("int8", True, False), ("int8", False, True),
                 ("float", False, False)]


@pytest.mark.parametrize("weights,kv_quant,bypass", SAMPLED_CASES,
                         ids=[f"{w}-kvq{int(k)}-bypass{int(b)}" for w, k, b in SAMPLED_CASES])
def test_sampled_runs_repeat_under_one_seed(slice_setup, weights, kv_quant, bypass):
    """kv_quant=True with int8 layers is the fused stack with the sampled
    head; the others are the per-layer path."""
    cfg, trees, pixels = slice_setup
    params = from_jax(trees[weights])
    kw = dict(kv_quant=kv_quant, bypass_bridge=bypass, temperature=1.0, top_p=0.95)

    def run(seed):
        return _port(cfg, params, pixels, torch.Generator().manual_seed(seed), **kw)

    (a, la), (b, lb), (c, _) = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(la, lb)
    assert not np.array_equal(a, c)
    assert a.shape == (4, MAX_NEW + 1) and ((a >= 0) & (a < cfg.lm.vocab_size)).all()
    assert (a[:, 0] == cfg.lm.bos_token_id).all()
    np.testing.assert_array_equal(
        la, TG._eos_lengths(torch.from_numpy(a), cfg.lm.eos_token_id).numpy())
    greedy, _ = _port(cfg, params, pixels, greedy=True, kv_quant=kv_quant,
                      bypass_bridge=bypass)
    assert not np.array_equal(a, greedy)


# ---------------------------------------------------------------------------
# inference.robust and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("caption", ["", "one", "a cat on a mat", "the the the the end",
                                     "a a a b a a a", "x y x y x y"])
def test_is_degenerate_equals_jax(caption):
    assert TR.is_degenerate(caption) == JR.is_degenerate(caption)
    assert TR.is_degenerate(caption, min_words=1, max_repeat=3) == \
        JR.is_degenerate(caption, min_words=1, max_repeat=3)


def test_robust_sweep(slice_setup):
    from vlm_bridge_tpu_torch.data.tokenizer import get_tokenizer

    cfg, trees, pixels = slice_setup
    assert [(n, dataclasses.asdict(g)) for n, g in TR.DEFAULT_STRATEGIES] == \
        [(n, dataclasses.asdict(g)) for n, g in JR.DEFAULT_STRATEGIES]
    params = from_jax(trees["int8"])
    tok = get_tokenizer(None)
    px = torch.from_numpy(pixels[:1])
    kw = dict(max_length=4, activation_dtype=torch.float32)
    out = TR.generate_caption_robust(params, P(cfg), px, tok, **kw)
    assert list(out["results"]) == [n for n, _ in TR.DEFAULT_STRATEGIES]
    assert not any(c.startswith("ERROR:") for c in out["results"].values())
    assert out["chosen"] in out["results"] and out["caption"] == out["results"][out["chosen"]]
    again = TR.generate_caption_robust(params, P(cfg), px, tok, **kw)
    assert again == out     # the default generator is seeded
    other = TR.generate_caption_robust(params, P(cfg), px, tok,
                                       generator=torch.Generator().manual_seed(1), **kw)
    assert other["results"]["greedy"] == out["results"]["greedy"]
    # a strategy that fails is kept as a result, and the sweep goes on
    bad = (("exact", TG.GenerationConfig(exact=True)), ("greedy", TG.GenerationConfig(greedy=True)))
    res = TR.generate_caption_robust(params, P(cfg), px, tok, strategies=bad, **kw)
    assert res["results"]["exact"].startswith("ERROR:") and res["chosen"] == "greedy"
    ids = np.array([[2, 72, 105, 1, 0]])
    assert TR.decode_captions(tok, ids, np.array([3])) == JR.decode_captions(tok, ids,
                                                                             np.array([3]))


@pytest.mark.parametrize("quantize", [None, "embedding,mlp,attn,bridge"],
                         ids=["float", "int8"])
def test_caption_cli_sampling_flags(tmp_path, quantize):
    from PIL import Image

    from vlm_bridge_tpu_torch.inference import caption

    rng = np.random.default_rng(1)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    base = [str(tmp_path), "--preset", "tiny_wide", "--device", "cpu", "--max-length", "4",
            "--dtype", "f32"] + (["--quantize", quantize] if quantize else [])

    def run(name, *extra):
        out = tmp_path / name
        assert caption.main(base + ["--output", str(out), *extra]) == 0
        return [json.loads(s)["caption"] for s in out.read_text().splitlines()]

    sample = ("--sample", "--temperature", "1.0", "--top-p", "0.95")
    a, b, c = run("a", *sample), run("b", *sample), run("c", "--greedy")
    assert a == b and len(a) == 2
    assert run("d") == c     # greedy is the default
