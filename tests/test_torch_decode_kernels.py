"""PyTorch port, decode kernels: the plain versions of fused_stack_step and
fused_bridge_step (what the wrappers run on CPU tensors) against the JAX
package over three decode steps, on the same numpy-seeded inputs:

- against the jnp int8 path (gemma2.decode_step with an int8 cache;
  generate._bridge_decode_step) at atol 1e-3 x max|ref|: both are f32;
- against the Pallas kernels in interpret mode (decode_step_stacked,
  _bridge_decode_step_fused) at 5e-3 x max|ref|: those round the matmul
  operands to bf16 in their bodies.
"""

import dataclasses
import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import BridgeConfig, Gemma2Config
from vlm_bridge_tpu.inference import generate as JG
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu.ops import decode_kernels as jdk
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.models import bridge as tb
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import decode_kernels as tdk
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

STEPS = 3


def _to_torch(tree):
    return from_jax(jax.tree.map(np.asarray, tree))


@functools.partial(jax.jit, static_argnums=1)
def _lm_params_jit(key, cfg):
    return jg.quantize_params(jg.init(key, cfg, dtype=jnp.float32))


def _lm_params(cfg, seed):
    # jitted: one compile instead of op-by-op dispatch of every init op
    return _lm_params_jit(jax.random.key(seed), cfg)


def _lm_cfg():
    # tiny widths, a real GQA ratio, and a window that never binds
    return dataclasses.replace(Gemma2Config.tiny_test(), sliding_window=128)


def test_fused_stack_step_plain_matches_jax(monkeypatch):
    cfg = _lm_cfg()
    qj = _lm_params(cfg, 0)
    stacked_j = jg.stack_decode_params(qj, cfg)
    qt = _to_torch(qj)
    stacked_t = tg.stack_decode_params(qt, P(cfg))
    B, L = 4, 16
    rng = np.random.default_rng(2)
    c_jnp = jg.KVCache.zeros(cfg, B, L, jnp.int8)
    c_pallas = jg.StackedKVCache.zeros(cfg, B, L)
    c_port = tg.StackedKVCache.zeros(P(cfg), B, L)
    monkeypatch.setattr(jdk, "INTERPRET", True)
    # one compile for all steps (position traced)
    pallas_step = jax.jit(lambda tok, c, t: jg.decode_step_stacked(qj, cfg, stacked_j, tok, c, t))
    jnp_step = jax.jit(lambda tok, c, t: jg.decode_step(qj, cfg, tok, c, position=t))
    for t in range(STEPS):
        tok = rng.normal(0, 1, (B, 1, cfg.hidden_size)).astype(np.float32)
        h_jnp, c_jnp = jnp_step(jnp.asarray(tok), c_jnp, jnp.int32(t))
        h_pal, c_pallas = pallas_step(jnp.asarray(tok), c_pallas, jnp.int32(t))
        h_port, c_port = tg.decode_step_stacked(qt, P(cfg), stacked_t, torch.from_numpy(tok),
                                                c_port, t)
        scale = float(np.abs(np.asarray(h_jnp)).max())
        np.testing.assert_allclose(h_port.numpy(), np.asarray(h_jnp), atol=1e-3 * scale,
                                   rtol=0, err_msg=f"vs jnp int8 path, step {t}")
        np.testing.assert_allclose(h_port.numpy(), np.asarray(h_pal), atol=5e-3 * scale,
                                   rtol=0, err_msg=f"vs interpret kernel, step {t}")
    # caches: jnp [L, B, S, KH, D] vs port [L, B, KH, S, D]; scales likewise
    old = np.asarray(c_jnp.k)[:, :, :STEPS].astype(np.int32)
    new = c_port.k.numpy()[:, :, :, :STEPS].transpose(0, 1, 3, 2, 4).astype(np.int32)
    assert (np.abs(old - new) <= 1).mean() >= 0.99
    np.testing.assert_allclose(
        c_port.v_scale.numpy()[:, :, :, :STEPS].transpose(0, 1, 3, 2),
        np.asarray(c_jnp.v_scale)[:, :, :STEPS], rtol=1e-4)
    assert (c_port.k.numpy()[:, :, :, STEPS:] == 0).all()


def test_fused_stack_step_wrapper_routes_cpu_to_plain():
    cfg = _lm_cfg()
    qt = _to_torch(_lm_params(cfg, 0))
    stacked = tg.stack_decode_params(qt, P(cfg))
    x = torch.from_numpy(np.random.default_rng(3).normal(0, 1, (2, cfg.hidden_size))
                         .astype(np.float32))
    cos, sin = torch.ones(cfg.head_dim), torch.zeros(cfg.head_dim)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              attn_scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
    outs = []
    for fn in (tdk.fused_stack_step, tdk.fused_stack_step_plain):
        c = tg.StackedKVCache.zeros(P(cfg), 2, 8)
        outs.append((fn(0, x, stacked, *c, cos, sin, **kw), c))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[0][1].k, outs[1][1].k, rtol=0, atol=0)


def _bridge_setup():
    cfg = BridgeConfig(vision_dim=32, language_dim=64, num_heads_cross=2,
                       num_heads_self=4, num_blocks=2, ffn_mult=4)
    pj = jax.jit(lambda k: jb.init(k, cfg, dtype=jnp.float32))(jax.random.key(0))
    qj = jax.jit(jb.quantize_decode_params)(pj)
    return cfg, pj, qj, _to_torch(qj)


def test_fused_bridge_step_plain_matches_jax(monkeypatch):
    cfg, _, qj, qt = _bridge_setup()
    bst_j = jb.stack_bridge_decode_params(qj, cfg)
    bst_t = tb.stack_bridge_decode_params(qt, P(cfg))
    B, Sv, L = 3, 5, 16
    Hs, Ds = cfg.num_heads_self, cfg.language_dim // cfg.num_heads_self
    rng = np.random.default_rng(4)
    vision = rng.normal(0, 1, (B, Sv, cfg.vision_dim)).astype(np.float32)
    c_jnp = JG._build_cross_cache(qj, cfg, jnp.asarray(vision), L, jnp.float32, kv_quant=True)
    # the Pallas kernel's head-major layout (as tests/test_decode_kernels.py)
    c_pal = c_jnp._replace(
        cross_k=jnp.transpose(c_jnp.cross_k, (0, 3, 1, 2, 4)),
        cross_v=jnp.transpose(c_jnp.cross_v, (0, 3, 1, 2, 4)),
        cross_k_scale=jnp.transpose(c_jnp.cross_k_scale, (0, 3, 1, 2)),
        cross_v_scale=jnp.transpose(c_jnp.cross_v_scale, (0, 3, 1, 2)),
        self_k=jnp.zeros((cfg.num_blocks, Hs, B, 64, Ds), jnp.float32),
        self_v=jnp.zeros((cfg.num_blocks, Hs, B, 64, Ds), jnp.float32))
    c_port = TG._build_cross_cache(qt, P(cfg), torch.from_numpy(vision), L, torch.float32,
                                   kv_quant=True)
    np.testing.assert_array_equal(c_port.cross_k.numpy(),
                                  np.asarray(c_jnp.cross_k).transpose(0, 1, 3, 2, 4))
    monkeypatch.setattr(jdk, "INTERPRET", True)
    pallas_step = jax.jit(lambda e, c, t: JG._bridge_decode_step_fused(bst_j, cfg, c, e, t))
    jnp_step = jax.jit(lambda e, c, t: JG._bridge_decode_step(qj, cfg, c, e, t))
    for t in range(STEPS):
        emb = rng.normal(0, 1, (B, 1, cfg.language_dim)).astype(np.float32)
        x_jnp, c_jnp = jnp_step(jnp.asarray(emb), c_jnp, jnp.int32(t))
        x_pal, c_pal = pallas_step(jnp.asarray(emb), c_pal, jnp.int32(t))
        x_port = tdk.fused_bridge_step(
            t, torch.from_numpy(emb[:, 0]), bst_t, c_port.cross_k, c_port.cross_k_scale,
            c_port.cross_v, c_port.cross_v_scale, c_port.self_k, c_port.self_v,
            num_heads_cross=cfg.num_heads_cross, num_heads_self=cfg.num_heads_self,
            eps=cfg.layer_norm_eps)
        scale = float(np.abs(np.asarray(x_jnp)).max())
        np.testing.assert_allclose(x_port.numpy(), np.asarray(x_jnp)[:, 0], atol=1e-3 * scale,
                                   rtol=0, err_msg=f"vs jnp bridge path, step {t}")
        np.testing.assert_allclose(x_port.numpy(), np.asarray(x_pal)[:, 0], atol=5e-3 * scale,
                                   rtol=0, err_msg=f"vs interpret kernel, step {t}")
    # self caches: jnp [nb, B, L, Hs, Ds] vs port [nb, B, Hs, L, Ds]
    np.testing.assert_allclose(c_port.self_k.numpy()[:, :, :, :STEPS],
                               np.asarray(c_jnp.self_k)[:, :, :STEPS].transpose(0, 1, 3, 2, 4),
                               atol=1e-4)


@pytest.mark.parametrize("quantized_bridge", [False, True])
def test_bridge_decode_step_plain_path_matches_jax(quantized_bridge):
    """The port's dict-params bridge path (used when the bridge is not
    int8) against the JAX jnp path."""
    cfg, pj, qj, _ = _bridge_setup()
    pj = qj if quantized_bridge else pj
    pt = _to_torch(pj)
    B, Sv, L = 2, 5, 8
    rng = np.random.default_rng(5)
    vision = rng.normal(0, 1, (B, Sv, cfg.vision_dim)).astype(np.float32)
    c_j = JG._build_cross_cache(pj, cfg, jnp.asarray(vision), L, jnp.float32, kv_quant=True)
    c_t = TG._build_cross_cache(pt, P(cfg), torch.from_numpy(vision), L, torch.float32,
                                kv_quant=True)
    jnp_step = jax.jit(lambda e, c, t: JG._bridge_decode_step(pj, cfg, c, e, t))
    for t in range(STEPS):
        emb = rng.normal(0, 1, (B, 1, cfg.language_dim)).astype(np.float32)
        x_j, c_j = jnp_step(jnp.asarray(emb), c_j, jnp.int32(t))
        x_t, c_t = TG._bridge_decode_step(pt, P(cfg), c_t, torch.from_numpy(emb), t)
        scale = float(np.abs(np.asarray(x_j)).max())
        np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-4 * scale, rtol=0)
