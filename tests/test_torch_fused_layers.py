"""PyTorch port, the per-layer fused decode: the plain versions of
`fused_attn_step` and `fused_mlp_step` (what the wrappers run on CPU tensors)
against the JAX package's Pallas kernels in interpret mode, and
`gemma2.decode_step_fused` against the JAX `decode_step_fused`, the port's own
per-layer `decode_step` with an int8 cache and the stacked path's greedy ids.

The plain versions round where the Pallas kernels cast (h, q, p * v_scale, the
attention output and the MLP hidden to bf16), so on the same inputs the two
differ by f32 summation order and by the few values that fall on the other
side of a bf16 rounding: 2e-3 of the output's largest value, where the JAX
package's own tests allow 2e-2 to 3e-2 against its jnp path.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import Gemma2Config, VLMConfig
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu.ops import decode_kernels as jdk
from vlm_bridge_tpu.ops.layers import rope_table as j_rope_table
from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import decode_kernels as tdk
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

KERNEL_TOL = 2e-3   # x max|ref|, plain version against the interpret-mode kernel


def _to_torch(tree):
    return from_jax(jax.tree.map(np.asarray, tree))


def _cfg():
    # tiny widths, a real GQA ratio, and a window that never binds
    # (tests/test_decode_kernels.py)
    return dataclasses.replace(Gemma2Config.tiny_test(), sliding_window=128)


@functools.partial(jax.jit, static_argnums=1)
def _params_jit(key, cfg):
    return jg.quantize_params(jg.init(key, cfg, dtype=jnp.float32))


def _params(cfg, seed, rng):
    qj = _params_jit(jax.random.key(seed), cfg)
    for lp in qj["layers"].values():   # norms away from their zero init
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lp[k] = jnp.asarray(rng.normal(0, 0.2, lp[k].shape), jnp.float32)
    return qj


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a, np.float32 if dtype else None))
    return t.to(dtype) if dtype else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_step_plain_matches_the_pallas_kernel(monkeypatch, dtype):
    monkeypatch.setattr(jdk, "INTERPRET", True)
    cfg = _cfg()
    rng = np.random.default_rng(1)
    qj = _params(cfg, 0, rng)
    lj, lt = qj["layers"]["0"], _to_torch(qj)["layers"]["0"]
    x = jnp.asarray(rng.normal(0, 1, (8, cfg.hidden_size)), dtype)
    want = jdk.fused_mlp_step(x, lj["mlp"]["gate"], lj["mlp"]["up"], lj["mlp"]["down"],
                              lj["pre_ffn_norm"], lj["post_ffn_norm"], eps=cfg.rms_norm_eps)
    xt = _t(x, torch.bfloat16) if dtype == "bfloat16" else _t(x)
    got = tdk.fused_mlp_step(xt, lt["mlp"]["gate"], lt["mlp"]["up"], lt["mlp"]["down"],
                             lt["pre_ffn_norm"], lt["post_ffn_norm"], eps=cfg.rms_norm_eps)
    assert got.dtype == xt.dtype
    want = np.asarray(want, np.float32)
    # bf16 x: the output is rounded to bf16 on both sides, one step of its largest value
    tol = KERNEL_TOL if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * np.abs(want).max())


def _attn_case(cfg, rng, B, S, t):
    """History rows s < t of random codes and realistic scales in the JAX
    layout ([B, S, KH*D], scales [KH, B, S]); rows at and beyond t stay zero,
    as the decode loop leaves them."""
    KH, D = cfg.num_kv_heads, cfg.head_dim
    kc = np.zeros((B, S, KH * D), np.int8)
    vc = np.zeros((B, S, KH * D), np.int8)
    ks = np.zeros((KH, B, S), np.float32)
    vs = np.zeros((KH, B, S), np.float32)
    kc[:, :t] = rng.integers(-127, 128, (B, t, KH * D), dtype=np.int8)
    vc[:, :t] = rng.integers(-127, 128, (B, t, KH * D), dtype=np.int8)
    ks[:, :, :t] = rng.uniform(0.01, 0.03, (KH, B, t))
    vs[:, :, :t] = rng.uniform(0.01, 0.03, (KH, B, t))
    return kc, vc, ks, vs


def _port_cache(kc, vc, ks, vs, KH, D):
    """JAX layout -> the port's: K/V [B, KH, S, D], scales [B, KH, S]."""
    B, S, _ = kc.shape
    return (torch.from_numpy(kc.reshape(B, S, KH, D).transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(vc.reshape(B, S, KH, D).transpose(0, 2, 1, 3).copy()),
            torch.from_numpy(ks.transpose(1, 0, 2).copy()),
            torch.from_numpy(vs.transpose(1, 0, 2).copy()))


@pytest.mark.parametrize("t", [0, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attn_step_plain_matches_the_pallas_kernel(monkeypatch, dtype, t):
    monkeypatch.setattr(jdk, "INTERPRET", True)
    cfg = _cfg()
    rng = np.random.default_rng(2 + t)
    qj = _params(cfg, 1, rng)
    lj, lt = qj["layers"]["1"], _to_torch(qj)["layers"]["1"]
    B, S, KH, D = 4, 64, cfg.num_kv_heads, cfg.head_dim
    kc, vc, ks, vs = _attn_case(cfg, rng, B, S, t)
    x = jnp.asarray(rng.normal(0, 1, (B, cfg.hidden_size)), dtype)
    cos, sin = j_rope_table(jnp.asarray([t]), D, cfg.rope_theta)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=cfg.attn_scale,
              softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
    want = jdk.fused_attn_step(jnp.int32(t), x, lj["attn"]["qkv"], lj["attn"]["o"],
                               lj["input_norm"], lj["post_attn_norm"], cos, sin,
                               jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks),
                               jnp.asarray(vs), **kw)
    xt = _t(x, torch.bfloat16) if dtype == "bfloat16" else _t(x)
    cache_t = _port_cache(kc, vc, ks, vs, KH, D)
    before = [c.clone() for c in cache_t]
    got = tdk.fused_attn_step(t, xt, lt["attn"]["qkv"], lt["attn"]["o"], lt["input_norm"],
                              lt["post_attn_norm"], _t(cos[0]), _t(sin[0]), *cache_t, **kw)
    assert all(torch.equal(a, b) for a, b in zip(cache_t, before))   # read, never written
    x_want = np.asarray(want[0], np.float32)
    tol = KERNEL_TOL if dtype == "float32" else 2.0 ** -7
    assert got[0].dtype == xt.dtype
    np.testing.assert_allclose(got[0].float().numpy(), x_want, rtol=0,
                               atol=tol * np.abs(x_want).max())
    for i in (1, 2):   # the new K / V codes: a value on a rounding boundary may land one away
        a, b = got[i].numpy().astype(np.int32), np.asarray(want[i]).astype(np.int32)
        assert a.shape == (B, KH * D) and np.abs(a - b).max() <= 1 and (a == b).mean() > 0.99
    for i in (3, 4):   # scales [KH, B]
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5)


def test_fused_attn_step_soft_cap_binds_and_history_beyond_t_is_not_read():
    """Plain version alone: logits far beyond the cap stay finite and bounded,
    and whatever the cache holds at rows >= t changes nothing."""
    cfg = _cfg()
    rng = np.random.default_rng(9)
    lt = _to_torch(_params(cfg, 2, rng))["layers"]["0"]
    B, S, t, KH, D = 3, 64, 6, cfg.num_kv_heads, cfg.head_dim
    kc, vc, ks, vs = _attn_case(cfg, rng, B, S, t)
    ks[:, :, :t] *= 400.0     # history logits of several hundred against a cap of 50
    cache = _port_cache(kc, vc, ks, vs, KH, D)
    x = _t(rng.normal(0, 1, (B, cfg.hidden_size)).astype(np.float32))
    cos, sin = (a[0] for a in tdk_rope(t, D, cfg.rope_theta))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=cfg.attn_scale,
              softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
    args = (lt["attn"]["qkv"], lt["attn"]["o"], lt["input_norm"], lt["post_attn_norm"], cos, sin)
    base = tdk.fused_attn_step(t, x, *args, *cache, **kw)
    assert bool(torch.isfinite(base[0]).all())
    dirty = [c.clone() for c in cache]
    dirty[0][:, :, t:] = 127
    dirty[1][:, :, t:] = -127
    dirty[2][:, :, t:] = float("nan")
    dirty[3][:, :, t:] = float("inf")
    again = tdk.fused_attn_step(t, x, *args, *dirty, **kw)
    assert all(torch.equal(a, b) for a, b in zip(base, again))


def tdk_rope(t, D, theta):
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    return rope_table(torch.tensor([t]), D, theta)


def test_fused_kv_cache_zeros_shapes_and_device():
    cfg = P(_cfg())
    c = tg.FusedKVCache.zeros(cfg, 3, 51, device=torch.device("cpu"))
    assert len(c.k) == len(c.v) == len(c.k_scale) == len(c.v_scale) == cfg.num_layers
    for k, v, ksc, vsc in zip(*c):
        assert k.shape == v.shape == (3, cfg.num_kv_heads, 64, cfg.head_dim)
        assert k.dtype == v.dtype == torch.int8
        assert ksc.shape == vsc.shape == (3, cfg.num_kv_heads, 64)
        assert ksc.dtype == torch.float32 and k.device.type == "cpu"
        assert not k.any() and not ksc.any()
    assert c.k[0].data_ptr() != c.k[1].data_ptr()   # one tensor a layer, as in JAX
    assert tg.FusedKVCache.zeros(cfg, 1, 64).k[0].shape[2] == 64
    assert tg.FusedKVCache.zeros(cfg, 1, 65).k[0].shape[2] == 128


def test_decode_step_fused_matches_jax_and_the_per_layer_path(monkeypatch):
    """Three lockstep steps, f32 embeddings: against the JAX decode_step_fused
    (Pallas kernels in interpret mode) the hidden state stays within 2e-3 of
    its largest value (the JAX test allows 3e-2 against the jnp path), the
    cache codes within 1 in over 99 %, the scales within 1e-3 relative;
    against the port's own decode_step with an int8 KVCache (f32 between the
    ops, no bf16 rounding) within 1e-2."""
    monkeypatch.setattr(jdk, "INTERPRET", True)
    cfg = _cfg()
    rng = np.random.default_rng(3)
    qj = _params(cfg, 3, rng)
    qt = _to_torch(qj)
    B, L, KH, D = 4, 16, cfg.num_kv_heads, cfg.head_dim
    c_jax = jg.FusedKVCache.zeros(cfg, B, L)
    c_port = tg.FusedKVCache.zeros(P(cfg), B, L)
    c_layer = tg.KVCache.zeros(P(cfg), B, L, dtype=torch.int8)
    jax_step = jax.jit(lambda tok, c, t: jg.decode_step_fused(qj, cfg, tok, c, t))
    steps = 3
    for t in range(steps):
        tok = rng.normal(0, 1, (B, 1, cfg.hidden_size)).astype(np.float32)
        h_jax, c_jax = jax_step(jnp.asarray(tok), c_jax, jnp.int32(t))
        h_port, c_port = tg.decode_step_fused(qt, P(cfg), torch.from_numpy(tok), c_port, t)
        h_layer, c_layer = tg.decode_step(qt, P(cfg), torch.from_numpy(tok), c_layer, position=t)
        h_jax = np.asarray(h_jax)
        assert h_port.shape == (B, 1, cfg.hidden_size)
        scale = np.abs(h_jax).max()
        np.testing.assert_allclose(h_port.numpy(), h_jax, rtol=0, atol=KERNEL_TOL * scale,
                                   err_msg=f"vs the JAX fused step, step {t}")
        np.testing.assert_allclose(h_port.numpy(), h_layer.numpy(), rtol=0, atol=1e-2 * scale,
                                   err_msg=f"vs the port's per-layer path, step {t}")
    for i in range(cfg.num_layers):
        # JAX [B, S, KH*D] and [KH, B, S]; port [B, KH, S, D] and [B, KH, S]
        want_k = np.asarray(c_jax.k[i])[:, :steps].reshape(B, steps, KH, D).transpose(0, 2, 1, 3)
        got_k = c_port.k[i].numpy()[:, :, :steps]
        assert (np.abs(want_k.astype(np.int32) - got_k.astype(np.int32)) <= 1).mean() > 0.99
        np.testing.assert_allclose(c_port.v_scale[i].numpy()[:, :, :steps],
                                   np.asarray(c_jax.v_scale[i])[:, :, :steps].transpose(1, 0, 2),
                                   rtol=1e-3)
        assert not c_port.k[i][:, :, steps:].any()
        # the port's two caches hold the same rows: [L, B, Smax, KH, D] against [B, KH, S, D]
        layer_k = c_layer.k[i, :, :steps].permute(0, 2, 1, 3).numpy().astype(np.int32)
        assert (np.abs(layer_k - got_k.astype(np.int32)) <= 1).mean() > 0.99


def test_decode_step_fused_wrappers_route_cpu_tensors_to_the_plain_versions(monkeypatch):
    from vlm_bridge_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    cfg = _cfg()
    rng = np.random.default_rng(4)
    qt = _to_torch(_params(cfg, 4, rng))
    wrappers = (tdk.fused_attn_step, tdk.fused_mlp_step)
    before = [fn.launches for fn in wrappers]
    tok = torch.from_numpy(rng.normal(0, 1, (2, 1, cfg.hidden_size)).astype(np.float32))
    h, _ = tg.decode_step_fused(qt, P(cfg), tok, tg.FusedKVCache.zeros(P(cfg), 2, 8), 0)
    monkeypatch.setattr(tdk, "fused_attn_step", tdk.fused_attn_step_plain)
    monkeypatch.setattr(tdk, "fused_mlp_step", tdk.fused_mlp_step_plain)
    h_plain, _ = tg.decode_step_fused(qt, P(cfg), tok, tg.FusedKVCache.zeros(P(cfg), 2, 8), 0)
    assert torch.equal(h, h_plain)
    assert [fn.launches for fn in wrappers] == before


def test_greedy_loop_over_decode_step_fused_gives_the_stacked_path_ids():
    """Six greedy tokens at f32: bridge step -> decode_step_fused -> argmax
    head, against generate_tokens on the stacked path (kv_quant, int8 layers)
    from the same weights."""
    from vlm_bridge_tpu_torch.inference import generate as TG
    from vlm_bridge_tpu_torch.models import bridge as tb
    from vlm_bridge_tpu_torch.ops import quant

    base = VLMConfig.tiny_test()
    cfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, sliding_window=128))
    pj = jax.jit(lambda k: jfm.init(k, cfg, frozen_dtype=jnp.float32))(jax.random.key(5))
    pt = _to_torch(pj)
    pt["lm"] = tg.quantize_params(pt["lm"])
    pt["bridge"] = tb.quantize_decode_params(pt["bridge"])
    pcfg = P(cfg)
    rng = np.random.default_rng(5)
    vision = torch.from_numpy(rng.normal(0, 1, (3, pcfg.num_vision_tokens,
                                                pcfg.bridge.vision_dim)).astype(np.float32))
    N = 6
    gen = GenerationConfig(max_length=N, greedy=True, kv_quant=True)
    want, _ = generate_tokens(pt, pcfg, vision_features=vision, gen=gen,
                              activation_dtype=torch.float32)

    lm, B = pt["lm"], vision.shape[0]
    bcache = TG._build_cross_cache(pt["bridge"], pcfg.bridge, vision, N + 1, torch.float32,
                                   kv_quant=True)
    bst = tb.stack_bridge_decode_params(pt["bridge"], pcfg.bridge)
    kv = tg.FusedKVCache.zeros(pcfg.lm, B, N + 1)
    tok = torch.full((B,), pcfg.lm.bos_token_id, dtype=torch.int32)
    got = [tok]
    for t in range(N):
        emb = tg.embed(lm, tok.long()[:, None]).float()
        x = tdk.fused_bridge_step(t, emb[:, 0].contiguous(), bst, bcache.cross_k,
                                  bcache.cross_k_scale, bcache.cross_v, bcache.cross_v_scale,
                                  bcache.self_k, bcache.self_v,
                                  num_heads_cross=pcfg.bridge.num_heads_cross,
                                  num_heads_self=pcfg.bridge.num_heads_self,
                                  eps=pcfg.bridge.layer_norm_eps)
        hidden, kv = tg.decode_step_fused(lm, pcfg.lm, x[:, None, :], kv, t)
        tok = quant.int8_matmul_t_argmax(hidden[:, 0].contiguous(), lm["embedding"])
        got.append(tok)
    np.testing.assert_array_equal(torch.stack(got, dim=1).numpy(), want.numpy())


def test_prepare_fused_layers_fragments_map_back_to_the_int8_weights():
    """tools/loading.prepare_fused_layers: every layer's qkv / o / down dict
    gains "w_frag", whose from_fragments is its w_int8, and the gate dict the
    gate|up product's "gu_frag" / "gu_scale", whose split_gate_up gives gate
    and up; the int8 weights and scales stay the same tensors, the input tree
    is left as it was."""
    from vlm_bridge_tpu_torch.tools.loading import prepare_fused_layers

    cfg = _cfg()
    lm = _to_torch(_params(cfg, 6, np.random.default_rng(6)))
    prepared = prepare_fused_layers(lm)
    assert set(prepared) == set(lm) and prepared["embedding"] is lm["embedding"]
    for i in range(cfg.num_layers):
        raw, lp = lm["layers"][str(i)], prepared["layers"][str(i)]
        for part, name in (("attn", "qkv"), ("attn", "o"), ("mlp", "down")):
            wq = lp[part][name]
            assert "w_frag" not in raw[part][name]
            assert wq["w_int8"] is raw[part][name]["w_int8"]
            assert wq["scale"] is raw[part][name]["scale"]
            assert torch.equal(tdk.from_fragments(wq["w_frag"]), wq["w_int8"])
        gate, up = lp["mlp"]["gate"], lp["mlp"]["up"]
        g8, u8 = tdk.split_gate_up(tdk.from_fragments(gate["gu_frag"]))
        assert torch.equal(g8, gate["w_int8"]) and torch.equal(u8, up["w_int8"])
        gs, us = tdk.split_gate_up(gate["gu_scale"])
        assert torch.equal(gs, gate["scale"]) and torch.equal(us, up["scale"])
        assert up is raw["mlp"]["up"] and lp["input_norm"] is raw["input_norm"]


@pytest.mark.parametrize("t", [0, 5])
def test_plain_versions_on_prepared_dicts_match_the_pallas_kernels(monkeypatch, t):
    """The plain versions read w_int8 / scale: on prepared dicts they give
    what they give on the raw ones, bit for bit, and so stay within
    KERNEL_TOL of the JAX fused_attn_step / fused_mlp_step (interpret mode);
    three steps of decode_step_fused on the prepared tree equal the raw
    tree's."""
    from vlm_bridge_tpu_torch.tools.loading import prepare_fused_layers

    monkeypatch.setattr(jdk, "INTERPRET", True)
    cfg = _cfg()
    rng = np.random.default_rng(7 + t)
    qj = _params(cfg, 7, rng)
    qt = _to_torch(qj)
    prepared = prepare_fused_layers(qt)
    lj, lt, lp = qj["layers"]["1"], qt["layers"]["1"], prepared["layers"]["1"]
    B, S, KH, D = 4, 64, cfg.num_kv_heads, cfg.head_dim
    kc, vc, ks, vs = _attn_case(cfg, rng, B, S, t)
    x = jnp.asarray(rng.normal(0, 1, (B, cfg.hidden_size)), jnp.float32)
    cos, sin = j_rope_table(jnp.asarray([t]), D, cfg.rope_theta)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=cfg.attn_scale,
              softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
    want = jdk.fused_attn_step(jnp.int32(t), x, lj["attn"]["qkv"], lj["attn"]["o"],
                               lj["input_norm"], lj["post_attn_norm"], cos, sin,
                               jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ks),
                               jnp.asarray(vs), **kw)
    cache_t = _port_cache(kc, vc, ks, vs, KH, D)
    rest = (_t(cos[0]), _t(sin[0]), *cache_t)
    got = tdk.fused_attn_step(t, _t(x), lp["attn"]["qkv"], lp["attn"]["o"], lp["input_norm"],
                              lp["post_attn_norm"], *rest, **kw)
    raw = tdk.fused_attn_step(t, _t(x), lt["attn"]["qkv"], lt["attn"]["o"], lt["input_norm"],
                              lt["post_attn_norm"], *rest, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, raw))
    x_want = np.asarray(want[0], np.float32)
    np.testing.assert_allclose(got[0].numpy(), x_want, rtol=0,
                               atol=KERNEL_TOL * np.abs(x_want).max())
    want = np.asarray(jdk.fused_mlp_step(x, lj["mlp"]["gate"], lj["mlp"]["up"],
                                         lj["mlp"]["down"], lj["pre_ffn_norm"],
                                         lj["post_ffn_norm"], eps=cfg.rms_norm_eps), np.float32)
    got = tdk.fused_mlp_step(_t(x), lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"],
                             lp["pre_ffn_norm"], lp["post_ffn_norm"], eps=cfg.rms_norm_eps)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=KERNEL_TOL * np.abs(want).max())
    c_raw, c_prep = (tg.FusedKVCache.zeros(P(cfg), B, 16) for _ in range(2))
    for step in range(3):
        tok = torch.from_numpy(rng.normal(0, 1, (B, 1, cfg.hidden_size)).astype(np.float32))
        h_raw, c_raw = tg.decode_step_fused(qt, P(cfg), tok, c_raw, step)
        h_prep, c_prep = tg.decode_step_fused(prepared, P(cfg), tok, c_prep, step)
        assert torch.equal(h_raw, h_prep)
