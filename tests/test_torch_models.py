"""PyTorch port, models: DINOv2 forward (with the position-embedding resize),
the serving transformations of Gemma-2 and the bridge, the embedding
lookup and the seeded init, each against the JAX package on the tiny
presets, with JAX params carried over by params.from_jax."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import BridgeConfig, DinoV2Config, Gemma2Config, VLMConfig
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import dinov2 as jd
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu_torch.models import bridge as tb
from vlm_bridge_tpu_torch.models import dinov2 as td
from vlm_bridge_tpu_torch.models import full_model as tfm
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import decode_kernels as tdk
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("image_px", [42, 98])
def test_dinov2_forward_resized_grid(image_px):
    """Grid 3 (down) and 7 (up) against the native 5: the bicubic resize
    must be jax.image's (A = -0.5)."""
    cfg = DinoV2Config.tiny_test()
    pj = jax.jit(lambda k: jd.init(k, cfg, dtype=jnp.float32))(jax.random.key(0))
    px = np.random.default_rng(0).normal(0, 1, (2, image_px, image_px, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jd.forward(p, cfg, x))(pj, jnp.asarray(px))
    got = td.forward(from_jax(_np_tree(pj)), P(cfg), torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    grid = image_px // cfg.patch_size
    np.testing.assert_allclose(
        td.interpolate_pos_embed(torch.from_numpy(np.array(pj["pos_embed"])), P(cfg), grid).numpy(),
        np.asarray(jd.interpolate_pos_embed(pj["pos_embed"], cfg, grid)), atol=1e-6)


def test_dinov2_rejects_non_square():
    cfg = DinoV2Config.tiny_test()
    params = td.init(P(cfg), generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    with pytest.raises(ValueError, match="square"):
        td.forward(params, P(cfg), torch.zeros(1, 42, 56, 3))


def test_gemma2_quantize_stack_embed():
    cfg = Gemma2Config.tiny_test()
    pj = jax.jit(lambda k: jg.init(k, cfg, dtype=jnp.float32))(jax.random.key(1))
    qj = jax.jit(jg.quantize_params)(pj)
    qt = tg.quantize_params(from_jax(_np_tree(pj)))
    for name in ("0", "3"):
        for sub, key in (("attn", "qkv"), ("attn", "o"), ("mlp", "gate"), ("mlp", "down")):
            np.testing.assert_array_equal(qt["layers"][name][sub][key]["w_int8"].numpy(),
                                          np.asarray(qj["layers"][name][sub][key]["w_int8"]))
    np.testing.assert_array_equal(qt["embedding"]["w_int8"].numpy(),
                                  np.asarray(qj["embedding"]["w_int8"]))
    ids = np.array([[2, 5, 511], [0, 1, 7]])
    for p_t, p_j in ((qt, qj), (from_jax(_np_tree(pj)), pj)):
        np.testing.assert_allclose(tg.embed(p_t, torch.from_numpy(ids)).numpy(),
                                   np.asarray(jg.embed(p_j, jnp.asarray(ids))), atol=1e-6)
    st = tg.stack_decode_params(qt, P(cfg))
    H, F, QHD = cfg.hidden_size, cfg.intermediate_size, cfg.num_heads * cfg.head_dim
    NQKV = QHD + 2 * cfg.num_kv_heads * cfg.head_dim
    assert st["wqkv"].shape == (cfg.num_layers, NQKV // 64, H // 32, 128, 16)
    gu = tdk.from_fragments(st["wgu"][2])
    assert gu.shape == (H, 2 * F)
    np.testing.assert_array_equal(gu[:, F:].numpy(),
                                  np.asarray(qj["layers"]["2"]["mlp"]["up"]["w_int8"]))
    assert not tg.supports_fused_decode(qt, P(cfg), 51)  # tiny window (8) binds
    assert tg.fused_cache_rows(51) == 64


def test_fragment_order_round_trips_and_matches_mma_layout():
    w = torch.arange(64 * 128, dtype=torch.int32).reshape(64, 128)
    wf = tdk.to_fragments(w)
    assert wf.shape == (2, 2, 128, 16)
    assert torch.equal(tdk.from_fragments(wf), w)
    # lane 9 (g = 2, t = 1) of warp 2 of columns 64..127, rows 32..63: its
    # wgmma A fragment of the k16 step at row 32 first, for columns
    # 64 + 16 * 2 + (2, 10) and rows 32 + (2, 3, 10, 11)
    assert wf[1, 1, 2 * 32 + 9, :8].tolist() == [
        w[r, n].item() for r, n in ((34, 98), (35, 98), (34, 106), (35, 106),
                                    (42, 98), (43, 98), (42, 106), (43, 106))]
    with pytest.raises(ValueError, match="N of 64"):
        tdk.to_fragments(w[:, :96])


def _wgmma_a_lane_values(w: np.ndarray, steps: int) -> np.ndarray:
    """The wgmma A fragments of W^T written out from the PTX rule for
    m64nNk16 with A in registers (each warp w of the warpgroup holds rows
    16 w .. 16 w + 15; lane l, g = l // 4, t = l % 4, holds registers a0..a3 =
    (row g, k 2t | 2t+1), (row g + 8, k 2t | 2t+1), (row g, k 2t+8 | 2t+9),
    (row g + 8, k 2t+8 | 2t+9)), where A's row is a weight column and its k a
    weight row: [N/64, K/(16 steps), 128 lanes, steps, 8 values]."""
    K, N = w.shape
    out = np.zeros((N // 64, K // (16 * steps), 128, steps, 8), dtype=w.dtype)
    for c in range(N // 64):
        for r in range(K // (16 * steps)):
            for lane in range(128):
                warp, g, t = lane // 32, lane % 32 // 4, lane % 4
                cols = (64 * c + 16 * warp + g, 64 * c + 16 * warp + g + 8)
                for s in range(steps):
                    k0 = 16 * (steps * r + s)
                    vals = []
                    for kk, col in ((2 * t, cols[0]), (2 * t, cols[1]),
                                    (2 * t + 8, cols[0]), (2 * t + 8, cols[1])):
                        vals += [w[k0 + kk, col], w[k0 + kk + 1, col]]
                    out[c, r, lane, s] = vals
    return out


@pytest.mark.parametrize("bits", [8, 4])
def test_fragment_bytes_follow_the_wgmma_register_rule(bits):
    """to_fragments / to_fragments4 against the lane bytes built from the
    wgmma A-fragment rule alone: int8, a lane's 16 bytes are two k16 steps;
    int4, its bytes hold four k16 steps, steps 0 and 1 in the low nibbles and
    2 and 3 in the high ones."""
    rng = np.random.default_rng(15)
    if bits == 8:
        w = rng.integers(-127, 128, (64, 128)).astype(np.int8)
        want = _wgmma_a_lane_values(w, 2).reshape(2, 2, 128, 16)
        np.testing.assert_array_equal(tdk.to_fragments(torch.from_numpy(w)).numpy(), want)
    else:
        w = rng.integers(-8, 8, (128, 128)).astype(np.int8)
        vals = _wgmma_a_lane_values(w, 4)                  # [2, 2, 128, 4 steps, 8]
        lo = vals[:, :, :, :2].reshape(2, 2, 128, 16).astype(np.int32)
        hi = vals[:, :, :, 2:].reshape(2, 2, 128, 16).astype(np.int32)
        want = ((lo & 0xF) | (hi << 4)).astype(np.int8)
        np.testing.assert_array_equal(tdk.to_fragments4(torch.from_numpy(w)).numpy(), want)


def test_bridge_quantize_and_stack():
    cfg = BridgeConfig.tiny_test()
    pj = jax.jit(lambda k: jb.init(k, cfg, dtype=jnp.float32))(jax.random.key(2))
    qj = jax.jit(jb.quantize_decode_params)(pj)
    qt = tb.quantize_decode_params(from_jax(_np_tree(pj)))
    assert tb.supports_fused_decode(qt) and not tb.supports_fused_decode(from_jax(_np_tree(pj)))
    np.testing.assert_array_equal(qt["blocks"]["1"]["self"]["qkv"]["w_int8"].numpy(),
                                  np.asarray(qj["blocks"]["1"]["self"]["qkv"]["w_int8"]))
    st = tb.stack_bridge_decode_params(qt, P(cfg))
    ld, F = cfg.language_dim, cfg.language_dim * cfg.ffn_mult
    assert tdk.from_fragments(st["wqkv"][0]).shape == (ld, 3 * ld)
    np.testing.assert_array_equal(tdk.from_fragments(st["fc2"][1]).numpy(),
                                  np.asarray(qj["blocks"]["1"]["ffn"]["fc2"]["w_int8"]))
    assert st["lns"].shape == (cfg.num_blocks, 6, ld)
    assert st["qkv_bias"].shape == (cfg.num_blocks, 3 * ld)


def test_seeded_init_matches_jax_shapes_and_distributions():
    cfg = VLMConfig.tiny_test()
    gen = torch.Generator().manual_seed(0)
    pt = tfm.init(P(cfg), generator=gen, frozen_dtype=torch.float32)
    pj = jax.eval_shape(lambda k: jfm.init(k, cfg, frozen_dtype=jnp.float32), jax.random.key(0))
    flat_t = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pt)[0]}
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(pj)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        assert tuple(flat_t[k].shape) == v.shape, k
    fc1 = pt["bridge"]["blocks"]["0"]["ffn"]["fc1"]
    bound = (6.0 / sum(fc1.shape)) ** 0.5
    assert fc1.abs().max() <= bound and fc1.abs().max() > 0.9 * bound
    emb = pt["lm"]["embedding"]
    assert abs(float(emb.std()) - 0.02) < 2e-3
    # the same seed gives the same weights
    again = tfm.init(P(cfg), generator=torch.Generator().manual_seed(0), frozen_dtype=torch.float32)
    assert torch.equal(again["lm"]["embedding"], emb)


def test_encode_image_and_bf16_from_jax():
    cfg = VLMConfig.tiny_test()
    pj = jax.jit(lambda k: jfm.init(k, cfg))(jax.random.key(3))  # bf16 frozen towers
    pt = from_jax(_np_tree(pj))
    assert pt["vision"]["pos_embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(pt["vision"]["pos_embed"].float().numpy(),
                                  np.asarray(pj["vision"]["pos_embed"], np.float32))
    px = np.random.default_rng(1).normal(0, 1, (2, 70, 70, 3)).astype(np.float32)
    want = jax.jit(lambda p, x: jfm.encode_image(p, cfg, x))(
        jax.tree.map(lambda a: a.astype(jnp.float32), pj), jnp.asarray(px))
    got = tfm.encode_image({k: jax.tree.map(lambda a: a.float(), v) for k, v in pt.items()},
                           cfg, torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
