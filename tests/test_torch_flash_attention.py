"""PyTorch port, flash attention: the plain forward and backward (what the
CUDA kernels are held to on the card) against the JAX package's Pallas
kernels run in interpret mode; the autograd function on CPU tensors against
jax.grad of the jnp reference; and the shape gate of dot_product_attention.
Inputs are f32 from numpy seeds, so the rounding points the two sides share
(p and ds cast to the inputs' dtype) are exact here."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.ops import flash_attention as jfa
from vlm_bridge_tpu.ops.attention import _attention_reference as jax_reference
from vlm_bridge_tpu_torch.ops import attention as tattn
from vlm_bridge_tpu_torch.ops import cuda_lib
from vlm_bridge_tpu_torch.ops import flash_attention as tfa

NEG_INF = -2.3819763e38

CASES = [
    # name, (B, T, S, H, KH, D), kwargs, kv_lengths
    ("mha", (1, 128, 128, 2, 2, 64), {}, None),
    ("gqa_causal", (2, 128, 128, 4, 2, 64), dict(is_causal=True), None),
    ("softcap", (1, 128, 128, 2, 2, 64), dict(is_causal=True, logit_softcap=50.0), None),
    ("window", (1, 256, 256, 2, 1, 64),
     dict(is_causal=True, logit_softcap=30.0, sliding_window=48), None),
    ("cross", (2, 96, 160, 2, 2, 64), {}, None),
    ("unaligned", (1, 100, 130, 2, 2, 64), dict(is_causal=True), None),
    ("ragged_bidir", (3, 128, 128, 4, 2, 64), {}, [128, 70, 9]),
    ("ragged_sliding", (3, 128, 128, 4, 2, 64),
     dict(is_causal=True, logit_softcap=50.0, sliding_window=48), [128, 70, 9]),
    ("zero_length_row", (3, 64, 64, 2, 2, 64), dict(is_causal=True, logit_softcap=50.0),
     [64, 0, 17]),
]
IDS = [c[0] for c in CASES]


def _mk(B, T, S, H, KH, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, T, H, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, KH, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, KH, D)).astype(np.float32),
            rng.normal(0, 1, (B, T, H, D)).astype(np.float32))


def _full(kwargs):
    out = dict(is_causal=False, logit_softcap=None, sliding_window=None)
    out.update(kwargs)
    return out


def _keep_rows(shape, lens):
    """Query rows a caller reads: all without lengths, t < length with them
    (a padded query row that a window leaves no key is 0 in the port and
    unspecified in the Pallas kernel)."""
    B, T = shape[0], shape[1]
    if lens is None:
        return np.ones((B, T), bool)
    return np.arange(T)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("name,shape,kwargs,lens", CASES, ids=IDS)
def test_plain_versions_match_pallas_interpret(name, shape, kwargs, lens, monkeypatch):
    """flash_attention_plain and flash_attention_bwd_plain against _flash_fwd
    and _flash_bwd in the Pallas interpreter: out atol 2e-5, lse atol 1e-4,
    gradients atol 5e-5 / rtol 5e-4 (f32 sums in another order)."""
    monkeypatch.setattr(jfa, "INTERPRET", True)
    B, T, S, H, KH, D = shape
    q, k, v, dout = _mk(*shape)
    kw = _full(kwargs)
    scale = D ** -0.5
    keep = _keep_rows(shape, lens)
    dout = dout * keep[:, :, None, None]
    kv = np.full((B,), S, np.int32) if lens is None else np.asarray(lens, np.int32)
    q_offset = S - T if kw["is_causal"] else 0
    static = (scale, kw["is_causal"], kw["logit_softcap"], kw["sliding_window"], q_offset, 64, 128)
    jq, jk, jv, jdo, jkv = (jnp.asarray(a) for a in (q, k, v, dout, kv))
    want_out, want_lse = jfa._flash_fwd(jq, jk, jv, jkv, *static)
    want_dq, want_dk, want_dv = jfa._flash_bwd(jq, jk, jv, jkv, want_out, want_lse, jdo, *static)
    want_lse = np.asarray(want_lse)[:, :T, 0].reshape(B, H, T)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    tkv = torch.from_numpy(kv)
    tkw = dict(scale=scale, **kw)
    got_out, got_lse = tfa.flash_attention_plain(tq, tk, tv, tkv, **tkw)
    got = tfa.flash_attention_bwd_plain(tq, tk, tv, tkv, got_out, got_lse, tdo, **tkw)
    assert got_out.shape == (B, T, H, D) and got_lse.shape == (B, H, T)
    assert got_lse.dtype == torch.float32

    np.testing.assert_allclose(got_out.numpy()[keep], np.asarray(want_out)[keep],
                               atol=2e-5, rtol=2e-4)
    keep_h = np.broadcast_to(keep[:, None, :], (B, H, T))
    np.testing.assert_allclose(got_lse.numpy()[keep_h], want_lse[keep_h], atol=1e-4, rtol=1e-6)
    for gname, a, b in zip(("dq", "dk", "dv"), got, (want_dq, want_dk, want_dv)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-4,
                                   err_msg=f"{name}:{gname}")
    if lens is not None and 0 in lens:
        b0 = lens.index(0)  # empty support: out 0, lse the fill value, no gradient
        assert float(got_out[b0].abs().max()) == 0.0
        assert float(np.abs(np.asarray(want_out)[b0]).max()) == 0.0
        assert torch.all(got_lse[b0] == NEG_INF) and np.all(want_lse[b0] == np.float32(NEG_INF))
        assert all(float(g[b0].abs().max()) == 0.0 for g in got)


@pytest.mark.parametrize("name,shape,kwargs,lens", CASES, ids=IDS)
def test_autograd_function_matches_jax_grad_of_reference(name, shape, kwargs, lens, monkeypatch):
    """flash_attention on CPU tensors (the plain versions behind the autograd
    function) against the jnp reference and its jax.grad, over the rows a
    caller reads."""
    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    B, T, S, H, KH, D = shape
    q, k, v, w = _mk(*shape, seed=1)
    kw = _full(kwargs)
    scale = D ** -0.5
    keep = _keep_rows(shape, lens)
    if lens is not None:
        keep = keep & (np.asarray(lens) > 0)[:, None]
    w = w * keep[:, :, None, None]
    dense = None
    if lens is not None:
        dense = (jnp.arange(S)[None, :] < jnp.asarray(lens)[:, None])[:, None, :]

    def ref_loss(q, k, v):
        o = jax_reference(q, k, v, scale=scale, mask=dense, q_positions=None,
                          kv_positions=None, **kw)
        return jnp.sum(jnp.sin(o) * w), o
    (_, want_o), want_g = jax.value_and_grad(ref_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    before = [fn.launches for fn in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                                     tfa.flash_attention_bwd_dkv)]
    out = tfa.flash_attention(tq, tk, tv, scale=scale, **kw,
                              kv_lengths=None if lens is None else torch.tensor(lens))
    got_g = torch.autograd.grad((torch.sin(out) * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert [fn.launches for fn in (tfa.flash_attention_fwd, tfa.flash_attention_bwd_dq,
                                   tfa.flash_attention_bwd_dkv)] == before
    np.testing.assert_allclose(out.detach().numpy()[keep], np.asarray(want_o)[keep],
                               atol=2e-5, rtol=2e-4)
    for gname, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=5e-4,
                                   err_msg=f"{name}:{gname}")


def test_kv_lengths_clamp_and_only_needed_gradients():
    q, k, v, _ = _mk(2, 8, 8, 2, 2, 64, seed=2)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    a = tfa.flash_attention(tq, tk, tv, scale=0.125, kv_lengths=torch.tensor([100, 5]))
    b = tfa.flash_attention(tq, tk, tv, scale=0.125, kv_lengths=torch.tensor([8, 5]))
    assert torch.equal(a, b)
    # only q asks for a gradient: the dk/dv half is not computed
    tq.requires_grad_(True)
    out = tfa.flash_attention(tq, tk, tv, scale=0.125)
    (dq,) = torch.autograd.grad(out.sum(), tq)
    assert dq.shape == tq.shape and tk.grad is None


def _spy(monkeypatch):
    calls = []
    real_ref, real_flash = tattn._attention_reference, tfa.flash_attention
    monkeypatch.setattr(tattn, "_attention_reference",
                        lambda *a, **k: calls.append("reference") or real_ref(*a, **k))
    monkeypatch.setattr(tfa, "flash_attention",
                        lambda *a, **k: calls.append("flash") or real_flash(*a, **k))
    return calls


def test_gate_is_by_shape(monkeypatch):
    """Head dims the kernels are not built for, a dense mask without
    lengths, and explicit positions take _attention_reference; a supported
    call takes the flash function, whose wrappers on CPU tensors use the
    plain versions and never build."""
    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    calls = _spy(monkeypatch)
    g = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g)  # noqa: E731

    # the bridge's cross attention at the default widths: 2304 / 8 = 288
    tattn.dot_product_attention(mk(1, 4, 2, 288), mk(1, 6, 2, 288), mk(1, 6, 2, 288))
    assert calls == ["reference"]
    calls.clear()
    q, k, v = mk(2, 6, 2, 64), mk(2, 6, 2, 64), mk(2, 6, 2, 64)
    dense = torch.rand(2, 1, 6, 6, generator=g) > 0.3
    dense[..., 0] = True
    tattn.dot_product_attention(q, k, v, mask=dense)
    assert calls == ["reference"]
    calls.clear()
    pos = torch.arange(6)
    tattn.dot_product_attention(q, k, v, is_causal=True, q_positions=pos, kv_positions=pos)
    assert calls == ["reference"]
    calls.clear()
    lens = torch.tensor([6, 3])
    prefix = (torch.arange(6)[None, :] < lens[:, None])[:, None, :]
    got = tattn.dot_product_attention(q, k, v, mask=prefix, kv_lengths=lens, is_causal=True,
                                      logit_softcap=50.0, sliding_window=4)
    assert calls == ["flash"]
    want = tattn._attention_reference(q, k, v, scale=64 ** -0.5, mask=prefix, is_causal=True,
                                      logit_softcap=50.0, sliding_window=4)
    keep = (torch.arange(6)[None, :] < lens[:, None])
    torch.testing.assert_close(got[keep], want[keep], atol=2e-5, rtol=2e-4)
    calls.clear()
    tattn.dot_product_attention(q, k, v)   # no mask at all: supported
    assert calls == ["flash"]
    for D in (64, 128, 256):
        assert tattn.flash_supported(mk(1, 2, 1, D), mask=None, q_positions=None,
                                     kv_positions=None, kv_lengths=None)
    assert not tattn.flash_supported(mk(1, 2, 1, 32), mask=None, q_positions=None,
                                     kv_positions=None, kv_lengths=None)


def test_cpu_backward_runs_the_plain_version_once(monkeypatch):
    """On CPU tensors the autograd function's backward takes dq, dk and dv
    from one call of the plain backward."""
    calls = []
    real = tfa.flash_attention_bwd_plain
    monkeypatch.setattr(tfa, "flash_attention_bwd_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q, k, v, _ = _mk(2, 8, 8, 2, 2, 64, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tfa.flash_attention(*leaves, scale=0.125, is_causal=True)
    grads = torch.autograd.grad(out.sum(), leaves)
    assert calls == [1] and all(g.shape == t.shape for g, t in zip(grads, leaves))
