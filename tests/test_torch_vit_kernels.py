"""PyTorch port, the kernel-routed DINOv2 encode: the plain versions of
`tiled_matmul` and `layer_norm_fast` (what the wrappers run on CPU tensors)
against the JAX package's Pallas kernels in interpret mode, `layer_norm`'s
dispatch, `dinov2.forward` with the projections routed through
`tiled_matmul` against the JAX forward with VLM_BRIDGE_VIT_MM=pallas, the int8
vision tower (`quantize_vision_params`, bit for bit, and its forward), the
SwiGLU FFN, and `--quantize vision` through the caption CLI. Inputs come from
numpy seeds; JAX params cross through params.from_jax.
"""

import dataclasses
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import DinoV2Config
from vlm_bridge_tpu.models import dinov2 as jd
from vlm_bridge_tpu.ops import matmul_kernels as jmk
from vlm_bridge_tpu.ops import norm_kernels as jnk
from vlm_bridge_tpu_torch.models import dinov2 as td
from vlm_bridge_tpu_torch.ops import layers as tl
from vlm_bridge_tpu_torch.ops import matmul_kernels as tmk
from vlm_bridge_tpu_torch.ops import norm_kernels as tnk
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

BF16_STEP = 2.0 ** -7   # one bf16 step of the largest value of a row


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _rows_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= tol * np.abs(want).max(axis=-1)).all(), float(
        (diff / np.abs(want).max(axis=-1)).max())


@pytest.mark.parametrize("M,K,N,bias,gelu,f32", [
    pytest.param(257, 64, 96, False, False, False, id="257-64-96-False-False"),    # ragged rows
    pytest.param(512, 128, 256, False, False, False, id="512-128-256-False-False"),  # whole blocks
    # ragged rows and columns
    pytest.param(520, 64, 136, False, False, False, id="520-64-136-False-False"),
    pytest.param(320, 64, 160, True, True, False, id="320-64-160-True-True"),  # bias + exact GELU
    # the CUDA kernel's edges: a K tail (72 = 64 + 8); a last row tile of 64 rows
    # (192 = 128 + 64, the small twin of 16448 = 128 x 128 + 64); N beyond a
    # 128-column tile by 8 (264 = 2 x 128 + 8); GELU without a bias; f32 out with
    # bias and GELU
    (256, 72, 128, True, False, False),
    (192, 256, 256, True, False, False),
    (384, 128, 264, True, False, False),
    (300, 128, 192, False, True, False),
    (640, 512, 320, True, True, True),
])
def test_tiled_matmul_plain_matches_the_pallas_kernel(monkeypatch, M, K, N, bias, gelu, f32):
    """bf16 in on both sides; each rounds one f32 sum, taken in another order,
    to the output type, so a bf16 value may land one bf16 step away (f32 out:
    the summation order alone, 1e-5 of the row's largest value)."""
    monkeypatch.setattr(jmk, "INTERPRET", True)
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(M, K)), jnp.bfloat16)
    b = jnp.asarray(rng.normal(size=(K, N)), jnp.bfloat16)
    bs = jnp.asarray(rng.normal(size=(N,)), jnp.float32) if bias else None
    want = jmk.tiled_matmul(a, b, bs, block_m=128, block_n=128, gelu=gelu,
                            out_dtype=jnp.float32 if f32 else None)
    got = tmk.tiled_matmul(_bf16(a), _bf16(b), None if bs is None else torch.from_numpy(
        np.array(bs)), gelu=gelu, out_dtype=torch.float32 if f32 else None)
    assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert tuple(got.shape) == (M, N)
    _rows_close(got.float().numpy(), want, 1e-5 if f32 else BF16_STEP)
    f32_out = tmk.tiled_matmul_plain(_bf16(a), _bf16(b), out_dtype=torch.float32)
    assert f32_out.dtype == torch.float32


def test_vit_mm_mode_reads_the_variable_at_call_time(monkeypatch):
    monkeypatch.delenv("VLM_BRIDGE_VIT_MM", raising=False)
    assert tmk.vit_mm_mode() == "matmul"
    for value, mode in (("kernel", "kernel"), ("pallas", "kernel"), ("xla", "matmul"),
                        ("1", "matmul")):
        monkeypatch.setenv("VLM_BRIDGE_VIT_MM", value)
        assert tmk.vit_mm_mode() == mode


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", BF16_STEP)])
def test_layer_norm_fast_plain_matches_the_pallas_kernel(monkeypatch, dtype, tol):
    monkeypatch.setattr(jnk, "INTERPRET", True)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(3.0, 2.0, size=(300, 256)), dtype)
    scale = rng.normal(1.0, 0.2, size=(256,)).astype(np.float32)
    bias = rng.normal(0.0, 0.2, size=(256,)).astype(np.float32)
    want = jnk.layer_norm_fast(x, jnp.asarray(scale), jnp.asarray(bias), 1e-6)
    xt = _bf16(x) if dtype == "bfloat16" else torch.from_numpy(np.asarray(x))
    got = tnk.layer_norm_fast(xt, torch.from_numpy(scale), torch.from_numpy(bias), 1e-6)
    assert got.dtype == xt.dtype
    _rows_close(got.float().numpy(), want, tol)


def test_layer_norm_fast_gradients_match_jax(monkeypatch):
    """x, scale and bias gradients of sum(y * w) against jax.grad through the
    JAX custom_vjp (f32: 1e-5 of each gradient's largest value)."""
    monkeypatch.setattr(jnk, "INTERPRET", True)
    rng = np.random.default_rng(2)
    x = rng.normal(1.0, 2.0, size=(64, 128)).astype(np.float32)
    scale = rng.normal(1.0, 0.2, size=(128,)).astype(np.float32)
    bias = rng.normal(0.0, 0.2, size=(128,)).astype(np.float32)
    w = rng.normal(size=(64, 128)).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(jnk.layer_norm_fast(*a, 1e-6) * w), argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias)]
    (tnk.layer_norm_fast(*leaves, 1e-6) * torch.from_numpy(w)).sum().backward()
    for got, ref in zip(leaves, want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("rows,H,env,goes", [
    (1024, 128, "1", True),
    (1023, 128, "1", False),    # too few rows
    (1024, 96, "1", False),     # H no multiple of 128
    (1024, 128, None, False),   # variable unset: the pivot form
])
def test_layer_norm_dispatches_by_the_three_conditions(monkeypatch, rows, H, env, goes):
    calls = []
    real = tnk.layer_norm_fast
    monkeypatch.setattr(tnk, "layer_norm_fast",
                        lambda x2, *a: calls.append(tuple(x2.shape)) or real(x2, *a))
    if env is None:
        monkeypatch.delenv("VLM_BRIDGE_LN_KERNEL", raising=False)
    else:
        monkeypatch.setenv("VLM_BRIDGE_LN_KERNEL", env)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(2.0, 1.0, size=(rows // 4, 4, H)).astype(np.float32)) \
        if rows % 4 == 0 else torch.from_numpy(rng.normal(2.0, 1.0, size=(rows, H))
                                               .astype(np.float32))
    scale = torch.from_numpy(rng.normal(1.0, 0.1, size=(H,)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0.0, 0.1, size=(H,)).astype(np.float32))
    got = tl.layer_norm(x, scale, bias, 1e-6)
    assert calls == ([(rows, H)] if goes else [])
    assert got.shape == x.shape
    # either form is LayerNorm: they agree to f32 rounding
    want = torch.nn.functional.layer_norm(x, (H,), scale, bias, 1e-6)
    assert float((got - want).abs().max()) <= 1e-5


def _wide_cfg(**kw):
    """Tiny depth, a width the LayerNorm dispatch takes (128) and head dim 64."""
    return DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, mlp_ratio=2, patch_size=14,
                        image_size=70, **kw)


def _vit_case(cfg, batch, seed):
    pj = jax.jit(lambda k: jd.init(k, cfg, dtype=jnp.float32))(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    # the biases away from their zero init
    for lp in pj["layers"].values():
        for sub, key in (("attn", "qkv_bias"), ("attn", "o_bias"), ("mlp", "fc1_bias"),
                         ("mlp", "fc2_bias"), ("mlp", "win_bias"), ("mlp", "wout_bias")):
            if key in lp[sub]:
                lp[sub][key] = jnp.asarray(rng.normal(0, 0.1, lp[sub][key].shape), jnp.float32)
        lp["norm1"]["bias"] = jnp.asarray(rng.normal(0, 0.1, lp["norm1"]["bias"].shape),
                                          jnp.float32)
    px = rng.normal(0, 1, (batch, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return pj, px


def test_dinov2_forward_through_tiled_matmul_matches_jax(monkeypatch):
    """Both variables set on both sides: the JAX forward takes its Pallas
    matmul in interpret mode (its LayerNorm kernel dispatches on a TPU only);
    the port takes the plain versions of both kernels, 40 x 26 = 1040 rows.
    f32 throughout: 1e-4 of the features' largest value."""
    cfg = _wide_cfg()
    pj, px = _vit_case(cfg, 40, 4)
    monkeypatch.setattr(jmk, "INTERPRET", True)
    monkeypatch.setenv("VLM_BRIDGE_VIT_MM", "pallas")
    monkeypatch.setenv("VLM_BRIDGE_LN_KERNEL", "1")
    want = np.asarray(jax.jit(lambda p, x: jd.forward(p, cfg, x))(pj, jnp.asarray(px)))
    seen = {"mm": 0, "ln": 0}
    real_mm, real_ln = tmk.tiled_matmul, tnk.layer_norm_fast

    def spy_mm(a, b, bias=None, **kw):
        assert a.dim() == 2 and bias is not None and bias.dtype == torch.float32
        seen["mm"] += 1
        return real_mm(a, b, bias, **kw)

    def spy_ln(*a):
        seen["ln"] += 1
        return real_ln(*a)

    monkeypatch.setattr(tmk, "tiled_matmul", spy_mm)
    monkeypatch.setattr(tnk, "layer_norm_fast", spy_ln)
    pt = from_jax(_np_tree(pj))
    monkeypatch.setenv("VLM_BRIDGE_VIT_MM", "kernel")
    got = td.forward(pt, P(cfg), torch.from_numpy(px))
    assert seen == {"mm": 4 * cfg.num_layers, "ln": 2 * cfg.num_layers + 1}
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # int8 dicts stay with `linear`; the default routing launches neither
    seen.update(mm=0, ln=0)
    td.forward(td.quantize_vision_params(pt), P(cfg), torch.from_numpy(px[:2]))
    assert seen == {"mm": 0, "ln": 0}   # 52 rows: under the LayerNorm gate as well
    monkeypatch.delenv("VLM_BRIDGE_VIT_MM")
    monkeypatch.delenv("VLM_BRIDGE_LN_KERNEL")
    base = td.forward(pt, P(cfg), torch.from_numpy(px))
    assert seen == {"mm": 0, "ln": 0}
    np.testing.assert_allclose(base.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu_mlp", "swiglu_ffn"])
def test_quantize_vision_params_bit_for_bit_and_forward(swiglu):
    cfg = dataclasses.replace(DinoV2Config.tiny_test(), use_swiglu_ffn=swiglu)
    pj, px = _vit_case(cfg, 2, 5)
    qj = jd.quantize_vision_params(pj)   # op by op: XLA's fused form rounds the scales' division
    qt = td.quantize_vision_params(from_jax(_np_tree(pj)))
    quantized = ("win", "wout") if swiglu else ("fc1", "fc2")
    for name, lj in qj["layers"].items():
        lt = qt["layers"][name]
        for sub, key in (("attn", "qkv"), ("attn", "o"), *(("mlp", k) for k in quantized)):
            assert set(lt[sub][key]) == {"w_int8", "scale"}
            np.testing.assert_array_equal(lt[sub][key]["w_int8"].numpy(),
                                          np.asarray(lj[sub][key]["w_int8"]))
            np.testing.assert_array_equal(lt[sub][key]["scale"].numpy(),
                                          np.asarray(lj[sub][key]["scale"]))
        floats = {k for sub in ("attn", "mlp") for k, v in lt[sub].items()
                  if not isinstance(v, dict)}
        assert floats == {k for sub in ("attn", "mlp") for k, v in lj[sub].items()
                          if not isinstance(v, dict)}
        assert all(not isinstance(lt[k], dict) or "w_int8" not in lt[k]
                   for k in ("norm1", "norm2", "layerscale1", "layerscale2"))
    for key in ("patch_embed", "cls_token", "pos_embed", "final_norm"):
        assert jax.tree.structure(_np_tree(qj[key])) == jax.tree.structure(
            jax.tree.map(lambda a: a.numpy(), qt[key]))
    # the quantized tree crosses from_jax as it is, and both forwards agree (f32: 1e-4)
    want = np.asarray(jax.jit(lambda p, x: jd.forward(p, cfg, x))(qj, jnp.asarray(px)))
    for tree in (qt, from_jax(_np_tree(qj))):
        got = td.forward(tree, P(cfg), torch.from_numpy(px))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # int8 noise against the float tower stays small
    base = td.forward(from_jax(_np_tree(pj)), P(cfg), torch.from_numpy(px))
    assert float((got - base).abs().max()) <= 0.05 * float(base.abs().max())


def test_swiglu_forward_and_init_match_jax():
    cfg = dataclasses.replace(DinoV2Config.tiny_test(), use_swiglu_ffn=True)
    pj, px = _vit_case(cfg, 2, 6)
    want = np.asarray(jax.jit(lambda p, x: jd.forward(p, cfg, x))(pj, jnp.asarray(px)))
    got = td.forward(from_jax(_np_tree(pj)), P(cfg), torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    pt = td.init(P(cfg), generator=torch.Generator().manual_seed(0), dtype=torch.float32)
    shapes_j = jax.tree.map(lambda a: tuple(a.shape), _np_tree(pj))
    shapes_t = jax.tree.map(lambda a: tuple(a.shape), pt)
    assert shapes_t == shapes_j
    assert pt["layers"]["0"]["mlp"]["win"].shape == (cfg.hidden_size, 2 * cfg.swiglu_hidden)


def test_caption_cli_quantize_vision(tmp_path, monkeypatch):
    """`vlm-caption-torch --quantize vision,...` on the CPU: the tower's
    projections reach int8_matmul (its plain version here), and the captions
    are those of the float tower's run or differ only by int8 noise in ids."""
    from PIL import Image

    from vlm_bridge_tpu_torch.inference import caption
    from vlm_bridge_tpu_torch.ops import quant

    rng = np.random.default_rng(7)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    calls = []
    real = quant.int8_matmul_plain
    monkeypatch.setattr(quant, "int8_matmul_plain",
                        lambda x, wq: calls.append(tuple(x.shape)) or real(x, wq))
    out = tmp_path / "out.jsonl"
    argv = [str(tmp_path), "--preset", "tiny_wide", "--device", "cpu", "--max-length", "4",
            "--dtype", "f32", "--greedy", "--output", str(out)]
    assert caption.main(argv + ["--quantize", "vision"]) == 0
    rows = [json.loads(s) for s in out.read_text().splitlines()]
    assert len(rows) == 2 and all(isinstance(r["caption"], str) for r in rows)
    from vlm_bridge_tpu_torch.tools.loading import PRESETS

    vcfg = PRESETS["tiny_wide"]().vision
    tokens = (PRESETS["tiny_wide"]().image_size // vcfg.patch_size) ** 2 + 1
    assert calls.count((2 * tokens, vcfg.hidden_size)) >= 3 * vcfg.num_layers  # qkv, o, fc1
    assert len(calls) == 4 * vcfg.num_layers
    with pytest.raises(ValueError, match="unknown quantize parts"):
        caption.main(argv + ["--quantize", "vision,nope"])
