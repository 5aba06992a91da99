"""PyTorch port, the bridge train step: each ported module that the step
runs (Gemma-2 forward with and without recomputation, the bridge forward,
label shifting, the chunked loss, the schedules, dropout) and the step as a
whole (a 4-step trajectory of make_train_step, and make_eval_step) against
the JAX package on tiny presets in f32, inputs from numpy seeds, JAX params
carried over by params.from_jax. Dropout bits cannot be shared between the
packages, so the parity runs use dropout 0."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu import configs as jcfg
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu.training import train_step as jts
from vlm_bridge_tpu_torch import configs as tcfg
from vlm_bridge_tpu_torch.models import bridge as tb
from vlm_bridge_tpu_torch.models import full_model as tfm
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import cuda_lib
from vlm_bridge_tpu_torch.params.from_jax import bridge_from_jax, from_jax
from vlm_bridge_tpu_torch.training import train_step as tts


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mask(lens, T):
    return (np.arange(T)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)


def _both(jax_cls, torch_cls, **changes):
    """The same tiny config for both packages."""
    return (dataclasses.replace(jax_cls.tiny_test(), **changes),
            dataclasses.replace(torch_cls.tiny_test(), **changes))


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_gemma2_forward_hidden_and_grad(remat, head_dim):
    """head_dim 16 takes _attention_reference, 64 the flash function's plain
    versions; both must give the JAX hidden states and the JAX gradient with
    respect to the embeddings, with and without per-layer recomputation."""
    cj, ct = _both(jcfg.Gemma2Config, tcfg.Gemma2Config, head_dim=head_dim,
                   query_pre_attn_scalar=float(head_dim))
    pj = jax.jit(lambda k: jg.init(k, cj, dtype=jnp.float32))(jax.random.key(0))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (3, 12, cj.hidden_size)).astype(np.float32)
    w = rng.normal(0, 1, (3, 12, cj.hidden_size)).astype(np.float32)
    mask = _mask([12, 7, 1], 12)
    # padded query rows carry no weight: where a sliding window leaves such a
    # row no key at all, the flash kernels give 0 and the reference a uniform
    # average, and a training loss reads neither
    w = w * mask[:, :, None]

    def jloss(e):
        h = jg.forward_hidden(pj, cj, e, attn_mask=jnp.asarray(mask), remat=remat)
        return (h * w).sum(), h
    (_, want_h), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))

    pt = from_jax(_np_tree(pj))
    xt = torch.from_numpy(x).requires_grad_(True)
    got_h = tg.forward_hidden(pt, ct, xt, attn_mask=torch.from_numpy(mask), remat=remat)
    (got_g,) = torch.autograd.grad((got_h * torch.from_numpy(w)).sum(), xt)
    # real rows only: a padded query row's output is arbitrary in both
    real = mask.astype(bool)
    np.testing.assert_allclose(got_h.detach().numpy()[real], np.asarray(want_h)[real],
                               atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=2e-3, rtol=1e-3)
    assert all(p.grad is None for p in tts.tree_leaves(pt))


def test_gemma2_logits_and_int8_mlp_gate():
    cj, ct = _both(jcfg.Gemma2Config, tcfg.Gemma2Config)
    pj = jax.jit(lambda k: jg.init(k, cj, dtype=jnp.float32))(jax.random.key(1))
    ids = np.random.default_rng(1).integers(3, cj.vocab_size, (2, 9)).astype(np.int32)
    want = jg.forward(pj, cj, input_ids=jnp.asarray(ids))
    pt = from_jax(_np_tree(pj))
    got = tg.forward(pt, ct, input_ids=torch.from_numpy(ids).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-4)
    # the int8 table goes through the plain int8_matmul_t
    qj = jax.jit(lambda p: jg.quantize_params(p, ("embedding",)))(pj)
    qt = tg.quantize_params(pt, ("embedding",))
    hid = np.random.default_rng(2).normal(0, 1, (2, 5, cj.hidden_size)).astype(np.float32)
    np.testing.assert_allclose(
        tg.logits_from_hidden(qt, ct, torch.from_numpy(hid)).numpy(),
        np.asarray(jg.logits_from_hidden(qj, cj, jnp.asarray(hid))), atol=2e-4, rtol=1e-4)
    # the int8 MLP kernel is not ported: it raises, it does not fall to a plain product
    q_mlp = tg.quantize_params(pt, ("mlp",))
    with pytest.raises(NotImplementedError, match="int8_mlp"):
        tg.forward_hidden(q_mlp, ct, torch.from_numpy(hid))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("self_heads", [4, 1])
def test_bridge_forward(causal, masked, self_heads):
    """self_heads 1 gives a self-attention head dim of 64 (the flash
    function's plain versions); 4 gives 16 (_attention_reference)."""
    cj, ct = _both(jcfg.BridgeConfig, tcfg.BridgeConfig, num_heads_self=self_heads)
    pj = jax.jit(lambda k: jb.init(k, cj))(jax.random.key(2))
    rng = np.random.default_rng(3)
    text = rng.normal(0, 1, (3, 10, cj.language_dim)).astype(np.float32)
    vis = rng.normal(0, 1, (3, 6, cj.vision_dim)).astype(np.float32)
    lens = [10, 4, 1]
    mask = _mask(lens, 10) if masked else None
    want = jb.forward(pj, cj, jnp.asarray(text), jnp.asarray(vis), causal=causal,
                      text_mask=None if mask is None else jnp.asarray(mask))
    pt = bridge_from_jax(_np_tree(pj))
    got = tb.forward(pt, ct, torch.from_numpy(text), torch.from_numpy(vis), causal=causal,
                     text_mask=None if mask is None else torch.from_numpy(mask))
    real = _mask(lens, 10).astype(bool) if masked else np.ones((3, 10), bool)
    np.testing.assert_allclose(got.detach().numpy()[real], np.asarray(want)[real],
                               atol=1e-4, rtol=1e-4)
    # train=True without a generator, and a generator with train=False, are deterministic
    g = torch.Generator().manual_seed(0)
    same = tb.forward(pt, ct, torch.from_numpy(text), torch.from_numpy(vis), causal=causal,
                      text_mask=None if mask is None else torch.from_numpy(mask),
                      generator=g, train=False)
    assert torch.equal(same, got)


def test_bridge_dropout_rate_and_scaling():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = tb._dropout(x, 0.1, g, True)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005      # 1e5 draws: sigma 0.00095
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert tb._dropout(x, 0.1, g, False) is x
    assert tb._dropout(x, 0.0, g, True) is x
    assert tb._dropout(x, 0.1, None, True) is x
    # the same seed gives the same mask; the generator advances between calls
    a = tb._dropout(x, 0.1, torch.Generator().manual_seed(5), True)
    g5 = torch.Generator().manual_seed(5)
    b, c = tb._dropout(x, 0.1, g5, True), tb._dropout(x, 0.1, g5, True)
    assert torch.equal(a, b) and not torch.equal(b, c)
    # in the forward: train=True with a generator changes the output, mean preserved roughly
    cfg = tcfg.BridgeConfig.tiny_test()
    p = tb.init(cfg, generator=torch.Generator().manual_seed(1))
    t, v = torch.randn(2, 5, cfg.language_dim), torch.randn(2, 3, cfg.vision_dim)
    off = tb.forward(p, cfg, t, v)
    on = tb.forward(p, cfg, t, v, generator=torch.Generator().manual_seed(2), train=True)
    assert not torch.allclose(on, off)


@pytest.mark.parametrize("mask_pad", [True, False])
def test_shift_labels(mask_pad):
    ids = np.random.default_rng(4).integers(3, 100, (3, 8)).astype(np.int32)
    mask = _mask([8, 5, 1], 8)
    want = jfm.shift_labels(jnp.asarray(ids), jnp.asarray(mask), mask_pad=mask_pad)
    got = tfm.shift_labels(torch.from_numpy(ids), torch.from_numpy(mask), mask_pad=mask_pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("chunk", [4, 5, 16])
@pytest.mark.parametrize("remat", [False, True])
def test_chunked_ce_loss(chunk, remat):
    """Against the port's own full-logits loss and against JAX, value and
    gradient; chunk 5 leaves a ragged last chunk, chunk 16 a single one."""
    cj, ct = _both(jcfg.Gemma2Config, tcfg.Gemma2Config)
    pj = jax.jit(lambda k: jg.init(k, cj, dtype=jnp.float32))(jax.random.key(3))
    rng = np.random.default_rng(5)
    hid = rng.normal(0, 1, (2, 12, cj.hidden_size)).astype(np.float32)
    labels = rng.integers(0, cj.vocab_size, (2, 12)).astype(np.int32)
    labels[0, 9:] = -100
    labels[1, 3] = -100

    def jloss(h):
        return jfm.chunked_ce_loss(pj, cj, h, jnp.asarray(labels), chunk=chunk, remat=remat)
    (want, want_aux), want_g = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(hid))

    pt = from_jax(_np_tree(pj))
    ht = torch.from_numpy(hid).requires_grad_(True)
    lt = torch.from_numpy(labels)
    got, aux = tfm.chunked_ce_loss(pt, ct, ht, lt, chunk=chunk, remat=remat)
    (got_g,) = torch.autograd.grad(got, ht)
    full, full_aux = tfm._full_logits_loss(tg.logits_from_hidden(pt, ct, ht), lt)
    assert int(aux["token_count"]) == int(full_aux["token_count"]) == int(want_aux["token_count"])
    np.testing.assert_allclose(float(got), float(full), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-6, rtol=1e-4)
    # no valid label: the count clamps at 1 and the loss is 0
    none, aux0 = tfm.chunked_ce_loss(pt, ct, ht, torch.full_like(lt, -100), chunk=chunk)
    assert float(none) == 0.0 and int(aux0["token_count"]) == 1


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("accum", [1, 3])
def test_make_schedule(kind, accum):
    kw = dict(num_epochs=3, scheduler_type=kind, gradient_accumulation_steps=accum)
    js = jts.make_schedule(jcfg.TrainingConfig(**kw), 10)
    ts = tts.make_schedule(tcfg.TrainingConfig(**kw), 10)
    total = 3 * 10 // accum
    for count in (0, 1, total // 2, total - 1, total, total + 7):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=2e-6, err_msg=str(count))
    off = tts.make_schedule(tcfg.TrainingConfig(use_scheduler=False, **kw), 10)
    assert off(0) == off(total) == tcfg.TrainingConfig().learning_rate
    with pytest.raises(ValueError, match="scheduler_type"):
        tts.make_schedule(tcfg.TrainingConfig(scheduler_type="step"), 10)


def _batches(cfg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lens = rng.integers(2, 13, 4)
        lens[0] = 12
        out.append({
            "pixel_values": rng.integers(0, 256, (4, cfg.image_size, cfg.image_size, 3)
                                         ).astype(np.uint8),
            "input_ids": rng.integers(3, cfg.lm.vocab_size, (4, 12)).astype(np.int32),
            "attn_mask": _mask(lens, 12),
        })
    return out


def _leaf_names(tree, prefix=""):
    """Paths of a nested dict's leaves in tree_leaves' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _tiny_vlm(module, flash_dims):
    """VLMConfig.tiny_test(); flash_dims makes Gemma's head dim and the
    bridge's self-attention head dim 64, so the step goes through the flash
    function (its plain versions on the CPU) as it does at full width."""
    cfg = module.VLMConfig.tiny_test()
    if not flash_dims:
        return cfg
    return dataclasses.replace(
        cfg, lm=dataclasses.replace(cfg.lm, head_dim=64, query_pre_attn_scalar=64.0),
        bridge=dataclasses.replace(cfg.bridge, num_heads_self=1))


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("flash_dims", [False, True])
def test_train_step_trajectory(accum, flash_dims, monkeypatch):
    """The step as a whole: 4 steps of make_train_step on the same batches
    and the same initial parameters. Loss rtol 1e-4; gradient norm rtol 2e-3
    (f32 sums in another order through 4 decoder layers); the final bridge
    parameters within 1e-6 for at least 99.5 % of each tensor's elements and
    within 1e-4 for all (an update moves an element by about lr = 1e-3).
    1e-6 cannot hold for every element: Adam divides by sqrt(v) + 1e-8, so
    where a gradient is itself of the order of its f32 summation noise the
    step follows the noise."""
    # a CPU step must never reach for the kernels' build
    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    kw = dict(learning_rate=1e-3, min_lr=1e-4, num_epochs=1,
              gradient_accumulation_steps=accum, loss_chunk_size=5)
    cj, ct = _tiny_vlm(jcfg, flash_dims), _tiny_vlm(tcfg, flash_dims)
    cj = dataclasses.replace(cj, bridge=dataclasses.replace(cj.bridge, dropout=0.0))
    ct = dataclasses.replace(ct, bridge=dataclasses.replace(ct.bridge, dropout=0.0))
    tj, tt = jcfg.TrainingConfig(**kw), tcfg.TrainingConfig(**kw)
    pj = jax.jit(lambda k: jfm.init(k, cj, frozen_dtype=jnp.float32))(jax.random.key(7))
    pn = _np_tree(pj)
    batches = _batches(cj, 4, seed=11)

    state_j, opt_j = jts.init_train_state(pj, tj, steps_per_epoch=4)
    step_j = jts.make_train_step(cj, tj, opt_j, jts.make_schedule(tj, 4),
                                 activation_dtype=jnp.float32)
    frozen_j = jts.split_frozen(pj)
    want = []
    for b in batches:
        state_j, m = step_j(state_j, frozen_j, jax.tree.map(jnp.asarray, b), jax.random.key(0))
        want.append({k: float(v) for k, v in m.items()})

    frozen_t = from_jax(tts.split_frozen(pn))
    params_t = {**frozen_t, "bridge": bridge_from_jax(pn["bridge"])}
    before = [p.detach().clone() for p in tts.tree_leaves(params_t["bridge"])]
    state_t, opt_t = tts.init_train_state(params_t, tt, steps_per_epoch=4)
    step_t = tts.make_train_step(ct, tt, opt_t, tts.make_schedule(tt, 4),
                                 activation_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    for i, b in enumerate(batches):
        tb_ = {k: torch.from_numpy(v) for k, v in b.items()}
        state_t, m = step_t(state_t, frozen_t, tb_, gen)
        assert set(m) == {"loss", "grad_norm_before_clip", "learning_rate", "token_count"}
        np.testing.assert_allclose(float(m["loss"]), want[i]["loss"], rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm_before_clip"]),
                                   want[i]["grad_norm_before_clip"], rtol=2e-3)
        np.testing.assert_allclose(float(m["learning_rate"]), want[i]["learning_rate"],
                                   rtol=2e-6)
        assert int(m["token_count"]) == int(want[i]["token_count"])
    assert state_t.step == 4 == int(state_j.step)

    after_t = tts.tree_leaves(state_t.bridge_params)
    leaves_j = tts.tree_leaves(_np_tree(state_j.bridge_params))
    names = _leaf_names(state_t.bridge_params)
    moved = 0.0
    for name, got, wantp, was in zip(names, after_t, leaves_j, before):
        moved = max(moved, float((got.detach() - was).abs().max()))
        if name.endswith("k_bias"):
            # a softmax does not see a bias on its keys: the true gradient is 0, what
            # arrives is rounding noise, and Adam normalises noise to a step of its own
            assert float((got.detach() - was).abs().max()) < 1e-3
            continue
        diff = np.abs(got.detach().numpy() - wantp)
        assert (diff <= 1e-6).mean() >= 0.995, (name, float((diff <= 1e-6).mean()))
        assert diff.max() <= 1e-4, (name, float(diff.max()))
    assert moved > 1e-4   # the parameters did move (4 or 2 updates of about lr each)
    assert all(p.grad is None and not p.requires_grad for p in tts.tree_leaves(frozen_t))


def test_eval_step_and_state():
    cj, ct = jcfg.VLMConfig.tiny_test(), tcfg.VLMConfig.tiny_test()
    tj, tt = jcfg.TrainingConfig(), tcfg.TrainingConfig()
    pj = jax.jit(lambda k: jfm.init(k, cj, frozen_dtype=jnp.float32))(jax.random.key(8))
    pn = _np_tree(pj)
    batch = _batches(cj, 1, seed=12)[0]
    want = jts.make_eval_step(cj, tj, activation_dtype=jnp.float32)(
        jts.split_frozen(pj), pj["bridge"], jax.tree.map(jnp.asarray, batch))
    frozen_t = from_jax(tts.split_frozen(pn))
    bridge_t = bridge_from_jax(pn["bridge"])
    got = tts.make_eval_step(ct, tt, activation_dtype=torch.float32)(
        frozen_t, bridge_t, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == {"loss", "token_count", "avg_sequence_length"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    assert int(got["token_count"]) == int(want["token_count"])
    np.testing.assert_allclose(float(got["avg_sequence_length"]),
                               float(want["avg_sequence_length"]), rtol=1e-6)
    assert not got["loss"].requires_grad
    # from_jax: frozen subtrees without grad, the bridge f32 with grad
    assert all(not p.requires_grad for p in tts.tree_leaves(frozen_t))
    assert all(p.requires_grad and p.dtype == torch.float32 for p in tts.tree_leaves(bridge_t))
    assert set(tts.split_frozen({**frozen_t, "bridge": bridge_t})) == {"vision", "lm"}
    merged = tfm.merge_trainable({**frozen_t, "bridge": None}, bridge_t)
    assert tfm.trainable_params(merged) is bridge_t


def test_clip_matches_optax_rule():
    """Below the limit the gradient passes unscaled; at or above it is
    scaled to exactly the limit (no epsilon in the denominator)."""
    tc = tcfg.TrainingConfig(gradient_clip_val=0.3, learning_rate=1.0, use_scheduler=False,
                             weight_decay=0.0)
    for norm, scale in ((0.2, 1.0), (3.0, 0.1)):
        p = torch.zeros(4, requires_grad=True)
        opt = tts.make_optimizer(tc, 10)
        st = opt.init({"w": p})
        g = torch.tensor([norm, 0.0, 0.0, 0.0])
        opt.update([g], st, [p])
        # first Adam step: m^/(sqrt(v^) + eps) = sign(g) where g != 0, whatever the scale,
        # so read the clipped gradient from the first moment instead
        m = st["adamw"].state[p]["exp_avg"]
        np.testing.assert_allclose(float(m[0]), 0.1 * norm * scale, rtol=1e-6)
        assert st["count"] == 1
