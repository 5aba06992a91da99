"""PyTorch port, the whole serving slice: JAX params carried over by
params.from_jax, then pixels -> encode -> greedy int8 decode in both
packages on the tiny preset (with a window that never binds) at f32.

The port (its kernels' plain versions on CPU) must give greedy ids and
lengths IDENTICAL to JAX generate_tokens(force_jnp=True), with and without
early_stop, and agree on the first two tokens with the JAX Pallas decode
kernels run in interpret mode (the bar tests/test_decode_kernels.py sets
between the JAX fused and jnp paths)."""

import dataclasses
import json

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
from vlm_bridge_tpu.ops import decode_kernels as jdk
from vlm_bridge_tpu.ops import quant as jq
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

MAX_NEW = 8


@pytest.fixture(scope="module")
def slice_setup():
    base = VLMConfig.tiny_test()
    cfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, sliding_window=128))

    @jax.jit
    def build(key):
        p = jfm.init(key, cfg, frozen_dtype=jnp.float32)
        return {**p, "lm": jg.quantize_params(p["lm"]),
                "bridge": jb.quantize_decode_params(p["bridge"])}

    q = jax.tree.map(np.array, build(jax.random.key(3)))
    # EOS made a slightly stronger copy of token 13, which row 0 emits from
    # step 3 on: row 0 ends early (pad afterwards), the others run to the end
    E = q["lm"]["embedding"]
    E["w_int8"][cfg.lm.eos_token_id] = E["w_int8"][13]
    E["scale"][cfg.lm.eos_token_id] = E["scale"][13] * 1.05
    pixels = np.random.default_rng(0).normal(
        0, 1, (4, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return cfg, q, from_jax(q), pixels


def _port(cfg, qt, pixels, **kw):
    gen = TG.GenerationConfig(max_length=MAX_NEW, greedy=True, kv_quant=True, **kw)
    toks, lens = TG.generate_tokens(qt, P(cfg), pixel_values=torch.from_numpy(pixels), gen=gen,
                                    activation_dtype=torch.float32)
    return toks.numpy(), lens.numpy()


def _jax(cfg, q, pixels, **kw):
    gen = JG.GenerationConfig(max_length=MAX_NEW, greedy=True, kv_quant=True, **kw)
    toks, lens = JG.generate_tokens(q, cfg, pixel_values=jnp.asarray(pixels), gen=gen,
                                    activation_dtype=jnp.float32)
    return np.asarray(toks), np.asarray(lens)


@pytest.mark.parametrize("rows,early_stop", [(4, False), (4, True), (1, True)])
def test_greedy_ids_identical_to_jax(slice_setup, rows, early_stop):
    """rows=1 ends every row early, so early_stop leaves the loop early."""
    cfg, q, qt, pixels = slice_setup
    pixels = pixels[:rows]
    want = _jax(cfg, q, pixels, force_jnp=True, early_stop=early_stop)
    got = _port(cfg, qt, pixels, early_stop=early_stop)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32
    assert got[1][0] == 3 and (got[0][0, 4:] == cfg.lm.pad_token_id).all()


def test_first_tokens_match_jax_interpret_kernels(slice_setup, monkeypatch):
    cfg, q, qt, pixels = slice_setup
    monkeypatch.setattr(jdk, "INTERPRET", True)
    monkeypatch.setattr(jq, "INTERPRET", True)
    want, _ = _jax(cfg, q, pixels)
    got, _ = _port(cfg, qt, pixels)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    assert ((got >= 0) & (got < cfg.lm.vocab_size)).all()


def test_force_plain_and_unported_modes_raise(slice_setup):
    """The package has no switch to its plain versions (a CPU tensor is what
    selects them); modes that are not ported raise, and so does a path that
    needs per-layer weights when only stacked ones are there."""
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    cfg, q, qt, pixels = slice_setup
    assert not hasattr(TG.GenerationConfig(), "force_plain")
    px = torch.from_numpy(pixels[:1])
    for gen in (TG.GenerationConfig(greedy=True, kv_quant=True, exact=True),
                TG.GenerationConfig(greedy=True, kv_quant=True, mlp_int4=True),
                TG.GenerationConfig(greedy=True, kv_quant=True, bridge_causal=True)):
        with pytest.raises(NotImplementedError):
            TG.generate_tokens(qt, P(cfg), pixel_values=px, gen=gen)
    fused = TG.GenerationConfig(max_length=MAX_NEW, greedy=True, kv_quant=True)
    stacked = prestack_decode_params(qt, P(cfg), fused)
    assert "layers" not in stacked["lm"] and "layers" in qt["lm"]
    np.testing.assert_array_equal(
        TG.generate_tokens(stacked, P(cfg), pixel_values=px, gen=fused,
                           activation_dtype=torch.float32)[0].numpy(),
        _port(cfg, qt, pixels[:1])[0])
    for gen in (dataclasses.replace(fused, force_jnp=True),
                dataclasses.replace(fused, kv_quant=False)):
        with pytest.raises(ValueError, match="per-layer weights"):
            TG.generate_tokens(stacked, P(cfg), pixel_values=px, gen=gen)


def test_caption_cli_on_cpu(tmp_path, capsys):
    from PIL import Image

    from vlm_bridge_tpu_torch.inference import caption

    rng = np.random.default_rng(1)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (50 + 10 * i, 80, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    out = tmp_path / "caps.jsonl"
    rc = caption.main([str(tmp_path), "--preset", "tiny_wide", "--device", "cpu",
                       "--quantize", "embedding,mlp,attn,bridge", "--max-length", "5",
                       "--batch-size", "2", "--output", str(out)])
    assert rc == 0
    lines = [json.loads(s) for s in out.read_text().splitlines()]
    assert [r["image"].rsplit("/", 1)[-1] for r in lines] == ["img0.png", "img1.png", "img2.png"]
    assert all(isinstance(r["caption"], str) for r in lines)
    assert "captions/s on cpu" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="not ported yet"):
        caption.main([str(tmp_path), "--device", "cpu", "--checkpoint", "x"])
