"""PyTorch port, ops: each port function against its JAX counterpart on the
same numpy-seeded inputs (CPU, f32). Plain ops agree to atol 1e-5; int8
codes agree exactly; the greedy head agrees id for id with the JAX Pallas
kernel run in interpret mode."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.ops import attention as ja
from vlm_bridge_tpu.ops import layers as jl
from vlm_bridge_tpu.ops import quant as jq
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu_torch.ops import attention as ta
from vlm_bridge_tpu_torch.ops import layers as tl
from vlm_bridge_tpu_torch.ops import quant as tq
from vlm_bridge_tpu_torch.models import gemma2 as tg

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("int8", [False, True])
def test_linear(int8):
    r = _rng(0)
    x = r.normal(0, 1, (3, 5, 24)).astype(np.float32)
    w = r.normal(0, 0.1, (24, 40)).astype(np.float32)
    b = r.normal(0, 0.1, (40,)).astype(np.float32)
    if int8:
        wj = jq.quantize_int8(jnp.asarray(w), axis=0)
        wt = {k: _t(v) for k, v in wj.items()}
    else:
        wj, wt = jnp.asarray(w), _t(w)
    _close(tl.linear(_t(x), wt, _t(b)), jl.linear(jnp.asarray(x), wj, jnp.asarray(b)))


def test_norms_activations_softcap():
    r = _rng(1)
    x = (r.normal(0, 1, (4, 7, 48)) + 3.0).astype(np.float32)
    s, b = r.normal(1, 0.1, (48,)).astype(np.float32), r.normal(0, 0.1, (48,)).astype(np.float32)
    _close(tl.layer_norm(_t(x), _t(s), _t(b), 1e-5),
           jl.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 1e-5))
    _close(tl.rms_norm(_t(x), _t(b), 1e-6), jl.rms_norm(jnp.asarray(x), jnp.asarray(b), 1e-6))
    _close(tl.gelu_tanh(_t(x - 3)), jl.gelu_tanh(jnp.asarray(x - 3)))
    _close(tl.gelu_exact(_t(x - 3)), jl.gelu_exact(jnp.asarray(x - 3)))
    _close(tl.softcap(_t(10 * x), 30.0), jl.softcap(jnp.asarray(10 * x), 30.0), atol=1e-4)


def test_rope():
    r = _rng(2)
    pos = np.array([[0, 3, 17, 50]])
    x = r.normal(0, 1, (1, 4, 3, 16)).astype(np.float32)
    cj, sj = jl.rope_table(jnp.asarray(pos), 16)
    ct, st = tl.rope_table(_t(pos), 16)
    _close(ct, cj)
    _close(st, sj)
    _close(tl.apply_rope(_t(x), ct, st), jl.apply_rope(jnp.asarray(x), cj, sj))


@pytest.mark.parametrize("causal,softcap,window,masked", [
    (False, None, None, False), (True, 50.0, None, False),
    (True, None, 4, False), (False, None, None, True)])
def test_dot_product_attention(causal, softcap, window, masked):
    r = _rng(3)
    q = r.normal(0, 1, (2, 6, 4, 8)).astype(np.float32)
    k = r.normal(0, 1, (2, 6, 2, 8)).astype(np.float32)
    v = r.normal(0, 1, (2, 6, 2, 8)).astype(np.float32)
    mask = (np.arange(6)[None, None, :] < np.array([6, 4])[:, None, None]) if masked else None
    kw = dict(scale=0.3, is_causal=causal, logit_softcap=softcap, sliding_window=window)
    got = ta.dot_product_attention(_t(q), _t(k), _t(v), mask=None if mask is None else _t(mask), **kw)
    want = ja.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    mask=None if mask is None else jnp.asarray(mask), **kw)
    _close(got, want)


@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention(quantized):
    r = _rng(4)
    B, S, H, KH, D = 3, 10, 4, 2, 8
    q = r.normal(0, 1, (B, 1, H, D)).astype(np.float32)
    k = r.normal(0, 1, (B, S, KH, D)).astype(np.float32)
    v = r.normal(0, 1, (B, S, KH, D)).astype(np.float32)
    kw = dict(scale=0.25, logit_softcap=50.0)
    lens = np.array([3, 7, 10], np.int32)
    if quantized:
        kq, ks = jg.quantize_kv(jnp.asarray(k))
        vq, vs = jg.quantize_kv(jnp.asarray(v))
        want = ja.decode_attention(jnp.asarray(q), kq, vq, jnp.asarray(lens), k_scale=ks,
                                   v_scale=vs, **kw)
        got = ta.decode_attention(_t(q), _t(kq), _t(vq), _t(lens), k_scale=_t(ks),
                                  v_scale=_t(vs), **kw)
    else:
        want = ja.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(lens), window_start=jnp.asarray([0, 2, 5]), **kw)
        got = ta.decode_attention(_t(q), _t(k), _t(v), _t(lens),
                                  window_start=torch.tensor([0, 2, 5]), **kw)
    _close(got, want)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_codes_exact(axis):
    w = _rng(5).normal(0, 0.05, (64, 96)).astype(np.float32)
    wj = jq.quantize_int8(jnp.asarray(w), axis=axis)
    wt = tq.quantize_int8(_t(w), axis=axis)
    np.testing.assert_array_equal(wt["w_int8"].numpy(), np.asarray(wj["w_int8"]))
    _close(wt["scale"], wj["scale"], atol=0)
    _close(tq.dequantize(wt, axis=axis), jq.dequantize(wj, axis=axis))
    assert tq.is_quantized(wt) and not tq.is_quantized(_t(w))


def test_quantize_kv_codes_exact():
    x = _rng(6).normal(0, 2, (3, 5, 2, 16)).astype(np.float32)
    cj, sj = jg.quantize_kv(jnp.asarray(x))
    ct, st = tg.quantize_kv(_t(x))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    _close(st, sj, atol=0)


def test_int8_matmul_t():
    r = _rng(7)
    x = r.normal(0, 1, (5, 64)).astype(np.float32)
    wj = jq.quantize_int8(jnp.asarray(r.normal(0, 0.05, (300, 64)), jnp.float32), axis=1)
    wt = {k: _t(v) for k, v in wj.items()}
    want = jq.int8_matmul_t(jnp.asarray(x), wj)
    _close(tq.int8_matmul_t_plain(_t(x), wt, chunk=128), want, atol=1e-4)
    _close(tq.int8_matmul_t(_t(x), wt), want, atol=1e-4)   # CPU: the plain version


def _head_inputs(V=1000, H=128, M=6):
    """bf16-exact activations (the kernels round x to bf16), a tie planted
    at rows 700 and 900 of the table (same int8 row and scale, the winner for
    batch row 1), and an all-NaN batch row 3."""
    r = _rng(8)
    x = np.array(jnp.asarray(r.normal(0, 1, (M, H)), jnp.bfloat16).astype(jnp.float32))
    w = r.normal(0, 0.05, (V, H)).astype(np.float32)
    w[700] = w[900] = np.sign(x[1]) * 0.2
    x[3] = np.nan
    return x, jq.quantize_int8(jnp.asarray(w), axis=1)


def test_int8_matmul_t_argmax_matches_interpret_kernel(monkeypatch):
    x, wj = _head_inputs()
    monkeypatch.setattr(jq, "INTERPRET", True)
    want = np.asarray(jq.int8_matmul_t_argmax(jnp.asarray(x), wj))
    wt = {k: _t(v) for k, v in wj.items()}
    got = tq.int8_matmul_t_argmax(_t(x), wt).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 700 and got[3] == 0
    assert got.dtype == np.int32


def test_argmax_plain_block_nan_rule():
    """A vocab block holding a NaN never wins, even where a later block's
    max is smaller (the TPU kernel's rule, at the port's block size)."""
    x = np.zeros((1, 64), np.float32)
    x[0, 0] = 1.0
    w = np.zeros((3 * tq.ARGMAX_BLOCK_V, 64), np.float32)
    w[5, 0], w[2 * tq.ARGMAX_BLOCK_V + 1, 0] = 1.0, 0.5
    wt = tq.quantize_int8(_t(w), axis=1)
    assert tq.int8_matmul_t_argmax(_t(x), wt).tolist() == [5]
    wt["scale"][7] = float("nan")
    assert tq.int8_matmul_t_argmax(_t(x), wt).tolist() == [2 * tq.ARGMAX_BLOCK_V + 1]


def test_preprocess_matches_jax():
    from PIL import Image

    from vlm_bridge_tpu.data import preprocess as jp
    from vlm_bridge_tpu_torch.data import preprocess as tp

    img = Image.fromarray(_rng(9).integers(0, 256, (40, 60, 3), dtype=np.uint8))
    crop_t = tp.host_resize_crop(img, crop=28, edge=32)
    np.testing.assert_array_equal(crop_t, jp.host_resize_crop(img, crop=28, edge=32))
    px = np.stack([crop_t, crop_t[::-1]])
    _close(tp.normalize_on_device(_t(px), dtype=torch.float32),
           jp.normalize_on_device(jnp.asarray(px), dtype=jnp.float32))
    np.testing.assert_array_equal(tp.pad_to_batch(px, 5), jp.pad_to_batch(px, 5))


def test_preprocess_numpy_matches_jax():
    """The host-only path: resize, crop and normalise a few seeded PIL images
    of other sizes and modes, equal to the JAX package's in f32."""
    from PIL import Image

    from vlm_bridge_tpu.data import preprocess as jp
    from vlm_bridge_tpu_torch.data import preprocess as tp

    rng = _rng(10)
    images = [Image.fromarray(rng.integers(0, 256, (300, 260, 3), dtype=np.uint8)),
              Image.fromarray(rng.integers(0, 256, (240, 410, 3), dtype=np.uint8)),
              Image.fromarray(rng.integers(0, 256, (256, 256), dtype=np.uint8))]
    got = tp.preprocess_numpy(images)
    assert got.dtype == np.float32 and got.shape == (3, tp.CROP_SIZE, tp.CROP_SIZE, 3)
    np.testing.assert_array_equal(got, jp.preprocess_numpy(images))
