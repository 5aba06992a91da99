"""PyTorch port, exact-mode generation, the bridge's debug forward and the
early-stop repair, held to the JAX package on the tiny preset in f32 (JAX
params carried over by params.from_jax, inputs from numpy seeds):

- exact mode's greedy ids equal the JAX generate_tokens(exact=True)'s, with
  and without bridge_causal and bypass_bridge, and its first token equals the
  port's fast mode's (prefix length 1: the cached decode is exact there);
- exact mode asks for `_attention_reference` by name; without the request an
  f32 call of a flash head dim takes the flash function as before;
- `debug_forward`'s per-block statistics equal the JAX function's (1e-5
  relative), `has_anomaly` flags NaN weights, `num_params` counts alike;
- early_stop: tokens and lengths equal early_stop=False's (greedy and
  sampled, per-layer and fused paths) and, greedy, the JAX package's; the
  loop ends early once every row is done.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import VLMConfig
from vlm_bridge_tpu.inference import generate as JG
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.models import bridge as tb
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import attention as tatt
from vlm_bridge_tpu_torch.ops import flash_attention as tfa
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

N = 6


@pytest.fixture(scope="module")
def setup():
    cfg = VLMConfig.tiny_test()
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: jfm.init(k, cfg, frozen_dtype=jnp.float32))(jax.random.key(1)))
    pixels = np.random.default_rng(0).normal(
        0, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return cfg, params, from_jax(params), pixels


def _jax_ids(cfg, params, pixels, activation_dtype=None, **kw):
    gen = JG.GenerationConfig(greedy=True, **{"max_length": N, **kw})
    toks, lens = JG.generate_tokens(params, cfg, pixel_values=jnp.asarray(pixels), gen=gen,
                                    activation_dtype=activation_dtype)
    return np.asarray(toks), np.asarray(lens)


def _port_ids(cfg, tparams, pixels, generator=None, **kw):
    gen = TG.GenerationConfig(greedy=True, **{"max_length": N, **kw})
    toks, lens = TG.generate_tokens(tparams, P(cfg), pixel_values=torch.from_numpy(pixels),
                                    gen=gen, generator=generator)
    return toks.numpy(), lens.numpy()


@pytest.mark.parametrize("bridge_causal,bypass", [(False, False), (True, False), (False, True)],
                         ids=["plain", "bridge_causal", "bypass_bridge"])
def test_exact_greedy_ids_equal_jax(setup, bridge_causal, bypass):
    """exact implies f32 activations in both packages (no dtype given)."""
    cfg, params, tparams, pixels = setup
    kw = dict(exact=True, bridge_causal=bridge_causal, bypass_bridge=bypass)
    want = _jax_ids(cfg, params, pixels, **kw)
    got = _port_ids(cfg, tparams, pixels, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[0].shape == (3, N + 1)
    # the first generated token of exact mode is the fast (cached) decode's
    toks_fast, _ = TG.generate_tokens(
        tparams, P(cfg), pixel_values=torch.from_numpy(pixels),
        gen=TG.GenerationConfig(max_length=1, greedy=True, bypass_bridge=bypass),
        activation_dtype=torch.float32)
    np.testing.assert_array_equal(got[0][:, 1], toks_fast.numpy()[:, 1])


def test_exact_mode_requests_the_reference_attention(setup, monkeypatch):
    """The request names `_attention_reference` whatever the shape: a call of
    a head dim the flash kernels take reaches the flash function without it
    and never with it, and exact mode makes the request (here the bridge's
    self-attention at head dim 64, whose prefix mask qualifies it)."""
    cfg, _, tparams, pixels = setup
    calls = []
    real = tfa.flash_attention
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    q, k, v = (torch.randn(2, 5, 4, 64, generator=torch.Generator().manual_seed(i))
               for i in range(3))
    out_ref = tatt.dot_product_attention(q, k, v, reference=True)
    assert not calls
    out_flash = tatt.dot_product_attention(q, k, v)
    assert len(calls) == 1
    torch.testing.assert_close(out_ref, tatt._attention_reference(q, k, v, scale=64 ** -0.5),
                               rtol=0, atol=0)
    torch.testing.assert_close(out_ref, out_flash, rtol=1e-5, atol=1e-5)

    wide = dataclasses.replace(P(cfg), bridge=dataclasses.replace(P(cfg).bridge,
                                                                  num_heads_self=1))
    params = {**tparams, "bridge": tb.init(wide.bridge, generator=torch.Generator().manual_seed(0))}
    calls.clear()
    toks, _ = TG.generate_tokens(params, wide, pixel_values=torch.from_numpy(pixels[:1]),
                                 gen=TG.GenerationConfig(max_length=2, greedy=True, exact=True))
    assert not calls and toks.shape == (1, 3)
    ids = toks.long()
    mask = torch.ones_like(ids, dtype=torch.int32)
    vision = torch.randn(1, 5, wide.bridge.vision_dim)
    from vlm_bridge_tpu_torch.models import full_model as tfm

    a = tfm.bridge_text(params, wide, ids, vision, attn_mask=mask, reference_attention=True)
    assert not calls
    b = tfm.bridge_text(params, wide, ids, vision, attn_mask=mask)
    assert [s[-1] for s in calls] == [64] * wide.bridge.num_blocks
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "text_mask"])
def test_debug_forward_stats_equal_jax(masked):
    jcfg = VLMConfig.tiny_test().bridge
    jparams = jax.tree.map(np.asarray, jb.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)
    B, T, S = 2, 6, 5
    text = rng.normal(0, 1, (B, T, jcfg.language_dim)).astype(np.float32)
    vision = rng.normal(0, 1, (B, S, jcfg.vision_dim)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([[6], [3]])).astype(np.int32) if masked else None
    j_out, j_stats = jb.debug_forward(
        jparams, jcfg, jnp.asarray(text), jnp.asarray(vision),
        text_mask=None if mask is None else jnp.asarray(mask))
    tparams = from_jax(jparams)
    t_out, t_stats = tb.debug_forward(
        tparams, P(jcfg), torch.from_numpy(text), torch.from_numpy(vision),
        text_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-5)
    assert set(t_stats) == set(j_stats) == {f"block_{b}" for b in range(jcfg.num_blocks)}
    for blk, stages in j_stats.items():
        assert set(t_stats[blk]) == set(stages) == {"input", "after_cross", "after_self",
                                                     "after_ffn"}
        for stage, vals in stages.items():
            assert set(t_stats[blk][stage]) == set(vals)
            for name, v in vals.items():
                np.testing.assert_allclose(float(t_stats[blk][stage][name]), float(v),
                                           rtol=1e-5, atol=1e-6, err_msg=f"{blk}/{stage}/{name}")
    # the debug forward is the plain eval forward
    ref = tb.forward(tparams, P(jcfg), torch.from_numpy(text), torch.from_numpy(vision),
                     text_mask=None if mask is None else torch.from_numpy(mask))
    torch.testing.assert_close(t_out, ref, rtol=1e-6, atol=1e-6)
    assert not tb.has_anomaly(t_stats) and not jb.has_anomaly(j_stats)
    bad = jax.tree.map(lambda p: np.full_like(p, np.nan), jparams)
    _, jbad = jb.debug_forward(bad, jcfg, jnp.asarray(text), jnp.asarray(vision))
    _, tbad = tb.debug_forward(from_jax(bad), P(jcfg), torch.from_numpy(text),
                               torch.from_numpy(vision))
    assert tb.has_anomaly(tbad) and jb.has_anomaly(jbad)
    assert tb.num_params(tparams) == jb.num_params(jparams)


# ---------------------------------------------------------------------------
# early stop, read two steps late
# ---------------------------------------------------------------------------


def _eos_and_rows(toks: np.ndarray, greedy: bool):
    """A token for EOS and the rows that all emit it: the token of row 0
    that most rows emit (greedy rows decode independently of the batch).
    Sampling draws for the whole batch at once, so there it is row 0 alone."""
    if not greedy:
        return int(toks[0, 1]), [0]
    best = max(np.unique(toks[0, 1:]),
               key=lambda c: sum(bool((row[1:] == c).any()) for row in toks))
    return int(best), [i for i, row in enumerate(toks) if (row[1:] == best).any()]


def _with_eos(cfg, eos):
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, eos_token_id=eos))


@pytest.mark.parametrize("path", ["per_layer_greedy", "per_layer_sampled", "fused_greedy"])
def test_early_stop_tokens_equal_and_loop_ends_early(setup, monkeypatch, path):
    cfg, params, tparams, pixels = setup
    n = 12
    kw = dict(max_length=n, greedy=path.endswith("greedy"), temperature=0.5, top_p=0.95)
    if path.startswith("fused"):
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, sliding_window=128))
        params = {**params, "lm": jax.tree.map(np.asarray, jg.quantize_params(params["lm"])),
                  "bridge": jax.tree.map(np.asarray, jb.quantize_decode_params(params["bridge"]))}
        tparams = from_jax(params)
        kw["kv_quant"] = True

    def run(c, early_stop):
        gen = TG.GenerationConfig(early_stop=early_stop, **kw)
        g = torch.Generator().manual_seed(7)
        toks, lens = TG.generate_tokens(tparams, P(c), pixel_values=torch.from_numpy(pixels),
                                        gen=gen, generator=g, activation_dtype=torch.float32)
        return toks.numpy(), lens.numpy()

    eos, rows = _eos_and_rows(run(cfg, False)[0], kw["greedy"])
    cfg, pixels = _with_eos(cfg, eos), pixels[rows]
    step_name = "decode_step_stacked" if path.startswith("fused") else "decode_step"
    steps = []
    real = getattr(tg, step_name)
    monkeypatch.setattr(tg, step_name, lambda *a, **k: steps.append(1) or real(*a, **k))
    off = run(cfg, False)
    n_off = len(steps)
    steps.clear()
    on = run(cfg, True)
    np.testing.assert_array_equal(on[0], off[0])
    np.testing.assert_array_equal(on[1], off[1])
    assert n_off == n and int(on[1].max()) < n - 2
    # the last EOS is token max(lens), made by step max(lens) - 1; the loop
    # reads that step's flag at the top of step max(lens) + 1 and stops there
    assert len(steps) == int(on[1].max()) + 1
    if kw["greedy"]:
        jkw = dict(kw, kv_quant=kw.get("kv_quant", False), force_jnp=True)
        for early_stop in (False, True):
            want = _jax_ids(cfg, params, pixels, activation_dtype=jnp.float32,
                            early_stop=early_stop,
                            **{k: v for k, v in jkw.items() if k != "greedy"})
            np.testing.assert_array_equal(on[0], want[0])
            np.testing.assert_array_equal(on[1], want[1])


def test_all_done_flag_reads_two_steps_late():
    flag = TG._AllDone(torch.device("cpu"))
    seen = []
    for t in range(6):
        seen.append(flag.seen(t))
        flag.push(t, torch.tensor([t >= 1, t >= 2]))
    assert seen == [False, False, False, False, True, True]
