"""The yardstick's FLOP and byte counts against counts made by hand at tiny
shapes."""

from __future__ import annotations

import pytest

from portbench import arith, spec
from portbench.tests import tiny

CFG = spec.vlm_config(tiny.CFG_FILE)


def test_bound_and_nbytes():
    import torch

    b = arith.bound(3.35e9, 1.0)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == pytest.approx(1.0)
    b = arith.bound(1.0, 989e9)
    assert b["bound_by"] == "operations" and b["bound_ms"] == pytest.approx(1.0)
    assert arith.nbytes(torch.zeros(3, 4), torch.zeros(5, dtype=torch.int8)) == 53


def test_stack_step_bytes_by_hand():
    # tiny: H 64, F 128, 4 layers, 4 heads / 2 kv heads of 16
    B, t = 4, 5
    qkv, o, gu, down = 64 * (4 + 4) * 16, 64 * 64, 2 * 64 * 128, 128 * 64
    scales = 4 * ((4 + 4) * 16 + 64) + 4 * (2 * 128 + 64)
    norms = 4 * 4 * 64
    kv = 2 * B * 2 * (16 + 4) * (t + 1)
    want = 4 * (qkv + o + gu + down + scales + norms + kv) + 2 * 2 * B * 64
    assert arith.stack_step_bytes(CFG.lm, B, t) == want
    # int4 MLP in groups of 32: half the MLP bytes, a scale a group
    g = 32
    scales4 = 4 * ((4 + 4) * 16 + 64) + 4 * (2 * 128 * (64 // g) + 64 * (128 // g))
    want4 = 4 * (qkv + o + (gu + down) // 2 + scales4 + norms + kv) + 2 * 2 * B * 64
    assert arith.stack_step_bytes(CFG.lm, B, t, True, g) == want4


def test_stack_step_flops_by_hand():
    B, t = 4, 5
    weights = 64 * 128 + 64 * 64 + 2 * 64 * 128 + 128 * 64
    attn = 2 * 2 * 4 * 16 * (t + 1)
    assert arith.stack_step_flops(CFG.lm, B, t) == 4 * B * (2 * weights + attn)


def test_model_flops_by_hand():
    v = CFG.vision    # hidden 32, 2 layers, mlp x2, patch 14 on 70 px: 25 patches
    n, tok = 25, 26
    layer = 2 * tok * (4 * 32 * 32 + 2 * 32 * 64) + 4 * tok * tok * 32
    assert arith.vit_flops(v, 70) == 2 * n * 14 * 14 * 3 * 32 + 2 * layer
    b = CFG.bridge    # ld 64, vd 32, ffn 128, 2 blocks
    assert arith.cross_kv_flops(b, tok) == 2 * 4 * tok * 32 * 64
    T = 3
    proj = 2 * T * (6 * 64 * 64 + 2 * 64 * 128)
    assert arith.bridge_token_flops(b, T, tok, causal=True) == 2 * (
        proj + 4 * T * tok * 64 + 4 * 6 * 64)
    assert arith.bridge_token_flops(b, T, tok, causal=False) == 2 * (
        proj + 4 * T * tok * 64 + 4 * 9 * 64)
    w = 64 * 128 + 64 * 64 + 2 * 64 * 128 + 128 * 64
    assert arith.decoder_flops(CFG.lm, T, 6) == 4 * (2 * T * w + 4 * 6 * 4 * 16)
    assert arith.head_flops(CFG.lm, T) == 2 * T * 512 * 64
    batch = arith.caption_batch_flops(CFG, 2, T)
    assert batch == 2 * (arith.vit_flops(v, 70) + arith.cross_kv_flops(b, tok)
                         + arith.bridge_token_flops(b, T, tok, True)
                         + arith.decoder_flops(CFG.lm, T, 6) + arith.head_flops(CFG.lm, T))
    step = arith.train_step_flops(CFG, [T, T])
    assert step == 2 * (arith.vit_flops(v, 70)
                        + 3 * (arith.cross_kv_flops(b, tok)
                               + arith.bridge_token_flops(b, T, tok, False))
                        + 2 * arith.decoder_flops(CFG.lm, T, 6) + 2 * arith.head_flops(CFG.lm, T))
    # ragged captions count their own tokens, not the bucket's
    short = arith.train_step_flops(CFG, [T, 2])
    assert short == arith.train_step_flops(CFG, [T]) + arith.train_step_flops(CFG, [2]) < step


def test_published_sizes_give_the_known_counts():
    """Mistral-7B's stack step moves ~7.1 GB a token (2.12 ms at 3.35 TB/s)
    and a caption batch of 64 x 50 is ~59.5 TFLOP."""
    m = spec.vlm_config(spec.config("dinov2l-bridge-mistral7b"))
    gb = sum(arith.stack_step_bytes(m.lm, 64, t) for t in range(50)) / 50 / 1e9
    assert 7.0 < gb < 7.2
    assert 59e12 < arith.caption_batch_flops(m, 64, 50) < 60e12
    assert 65e12 < arith.train_step_flops(m, [256] * 8) < 67e12
