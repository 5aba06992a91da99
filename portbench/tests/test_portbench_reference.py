"""The plain reference against the port's plain path at the tiny size, in
float32 on the CPU: the same seeded tree through both."""

from __future__ import annotations

import pytest
import torch

from portbench import spec, traffic, weights
from portbench.reference import check, model, quant
from portbench.tests import tiny

CFG = spec.vlm_config(tiny.CFG_FILE)
PORT = tiny.TINY_PORT
DEV = torch.device("cpu")


def f32(tree):
    return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}


@pytest.fixture(scope="module")
def raw():
    return weights.make(CFG, 11, DEV, 0.1)


def test_the_tree_is_the_ports(raw):
    """The harness's seeded tree has full_model.init's leaves: paths,
    shapes and dtypes."""
    from vlm_bridge_tpu_torch.models import full_model

    want = full_model.init(CFG, generator=torch.Generator().manual_seed(0))

    def shapes(tree):
        return {p: (tuple(t.shape), t.dtype) for p, t in check.leaf_paths(tree)}

    assert shapes(raw) == shapes(want)


def close(a, b, tol):
    err = float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
    assert err < tol, err


def test_vit_against_port(raw):
    from vlm_bridge_tpu_torch.models import dinov2

    pix = traffic.image_pool(3, 1, 2, 70, DEV)[0]
    x = traffic.normalize(pix, torch.float32)
    got = model.vit(raw["vision"], PORT["vision"], x, 70)
    want = dinov2.forward(f32(raw["vision"]), CFG.vision, x)
    close(got, want, 1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_bridge_against_port(raw, causal):
    from vlm_bridge_tpu_torch.models import bridge

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 64, generator=g)
    vision = torch.randn(2, 26, 32, generator=g)
    mask = torch.tensor([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    key_mask = None if causal else mask
    got = model.bridge(raw["bridge"], PORT["bridge"], x, vision, causal=causal,
                       key_mask=key_mask)
    want = bridge.forward(raw["bridge"], CFG.bridge, x, vision, causal=causal,
                          text_mask=key_mask)
    close(got, want, 1e-5)


def test_decoder_and_head_against_port(raw):
    from vlm_bridge_tpu_torch.models import gemma2

    lm = f32(raw["lm"])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 7, 64, generator=g) * 0.02
    mask = torch.tensor([[1] * 7, [1] * 5 + [0] * 2])
    got = model.decoder(raw["lm"], PORT["lm"], x, forms={}, key_mask=mask)
    want = gemma2.forward_hidden(lm, CFG.lm, x, attn_mask=mask)
    close(got[0], want[0], 1e-5)
    close(got[1, :5], want[1, :5], 1e-5)
    close(model.logits(PORT["lm"], lm["embedding"], got),
          gemma2.logits_from_hidden(lm, CFG.lm, got), 1e-5)


def test_quantizers_against_port():
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import quant as pq

    g = torch.Generator().manual_seed(2)
    w = (torch.randn(256, 96, generator=g) * 0.02).to(torch.bfloat16)
    assert torch.equal(quant.int8(w, 0), pq.dequantize(pq.quantize_int8(w, axis=0)))
    assert torch.equal(quant.int8(w, 1), pq.dequantize(pq.quantize_int8(w, axis=1), axis=1))
    assert torch.equal(quant.int4(w, 64), pq.dequantize_int4(pq.quantize_int4(w, group_size=64)))
    assert torch.equal(quant.int4(w, None), pq.dequantize_int4(pq.quantize_int4(w)))
    i8 = pq.dequantize(pq.quantize_int8(w, axis=0))
    assert torch.equal(quant.weight(w, "int4g128_of_int8"),
                       pq.dequantize_int4(pq.quantize_int4(i8, group_size=128)))
    t = (torch.randn(40, 512, generator=g) * 0.02).to(torch.bfloat16)
    assert torch.equal(quant.weight(t, "int4_rows"),
                       pq.dequantize_int4_rows(gemma2.quantize_embedding_part(t, ("embedding4",))))
    k = torch.randn(3, 5, 2, 16, generator=g)
    q, s = gemma2.quantize_kv(k)
    assert torch.equal(quant.kv8(k), q.float() * s[..., None])


def test_train_loss_and_gradients_against_port(raw):
    """Without dropout, the reference's loss and bridge gradients are the
    port's full forward's in f32."""
    from vlm_bridge_tpu_torch.models import full_model

    batch = traffic.train_pool(4, 1, 3, 12, 4, 70, 512, DEV)[0]
    br = {k: v for k, v in f32(raw["bridge"]).items()}
    leaves = check.leaf_paths(br)
    params = [p.clone().requires_grad_(True) for _, p in leaves]
    it = iter(params)

    def rebuild(node):
        return {k: rebuild(v) if isinstance(v, dict) else next(it) for k, v in sorted(node.items())}

    tree = rebuild(br)
    loss = check.train_loss(raw, PORT, tree, batch, dropout=None)
    grads = torch.autograd.grad(loss, params)
    full = {"vision": f32(raw["vision"]), "lm": f32(raw["lm"]), "bridge": tree}
    ids, mask = batch["input_ids"], batch["attn_mask"]
    labels = full_model.shift_labels(ids, mask)
    pix = traffic.normalize(batch["pixel_values"], torch.float32)
    want, _ = full_model.forward(full, CFG, pix, ids, mask, labels=labels, remat_lm=False)
    want_grads = torch.autograd.grad(want, params)
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    assert check.worst_leaf_error(grads, want_grads) < 1e-4


def test_gaps():
    ref = torch.tensor([[[3.0, 1.0, 0.5, -1.0], [0.0, 2.0, 1.9, 1.0]]])
    tokens = torch.tensor([[9, 0, 2]])
    valid = torch.ones(1, 2, dtype=torch.bool)
    assert check.served_gap(ref, tokens, valid, None) == pytest.approx(0.1)
    assert check.served_gap(ref, tokens, torch.tensor([[True, False]]), None) == 0.0
    # a control that picks token 3 at position 0 and token 1 at position 1
    ctl = torch.tensor([[[0.0, 0.0, 0.0, 1.0], [0.0, 5.0, 0.0, 0.0]]])
    assert check.control_gap(ref, ctl, valid, None) == pytest.approx(4.0)
    # sampling: a window of 2 keeps the top two (top-p 0.99 at temperature 1)
    s = {"temperature": 1.0, "top_p": 0.99, "topk_window": 2}
    assert check.served_gap(ref, torch.tensor([[9, 1, 3]]), valid, s) == pytest.approx(0.9)
    eos = torch.tensor([[2, 5, 1, 0, 0]])
    assert check.chosen_positions(eos, eos=1).tolist() == [[True, True, False, False]]


def test_worst_leaf_and_moving_leaves():
    assert check.worst_leaf([1.1, 2.0, 0.0], [1.0, 2.0, 1e-9]) == pytest.approx(0.1)
    assert check.moving_leaves([1.0, 2.0, 1e-9]) == [True, True, False]
    a, b = [torch.ones(4), torch.zeros(2)], [torch.ones(4) * 1.5, torch.zeros(2)]
    assert check.worst_leaf_error(a, b) == pytest.approx(1.0 / 3.0)
