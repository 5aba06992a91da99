"""PyTorch port kernels on the card: each CUDA kernel against its plain
version at small widths. These need an NVIDIA GPU with nvcc (sm_90a) and
skip elsewhere; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 3e-2  # x max|ref|: bf16 activations, different f32 summation order


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL * float(want.float().abs().max()), err


def test_stack_step_kernel_matches_plain(dev):
    from vlm_bridge_tpu.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    cfg = Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=64, query_pre_attn_scalar=64.0,
                       sliding_window=128)
    g = torch.Generator(device=dev).manual_seed(0)
    q = gemma2.quantize_params(gemma2.init(cfg, generator=g, device=dev))
    st = gemma2.stack_decode_params(q, cfg)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=64, attn_scale=cfg.attn_scale,
              softcap=50.0, eps=1e-6)
    ck, cp = (gemma2.StackedKVCache.zeros(cfg, 5, 8, device=dev) for _ in range(2))
    for t in range(4):
        x = torch.randn(5, 256, generator=g, device=dev).to(torch.bfloat16)
        cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), 64))
        n = dk.fused_stack_step.launches
        got = dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw)
        want = dk.fused_stack_step_plain(t, x, st, *cp, cos, sin, **kw)
        assert dk.fused_stack_step.launches == n + 1
        _close(got, want)
        assert ((ck.k[:, :, :, t].int() - cp.k[:, :, :, t].int()).abs() <= 1).float().mean() > 0.99


def test_bridge_step_kernel_matches_plain(dev):
    from vlm_bridge_tpu.configs import BridgeConfig
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    cfg = BridgeConfig(vision_dim=64, language_dim=256, num_blocks=2, num_heads_cross=2,
                       num_heads_self=4, ffn_mult=2)
    g = torch.Generator(device=dev).manual_seed(1)
    bq = bridge.quantize_decode_params(bridge.init(cfg, generator=g, device=dev))
    bst = bridge.stack_bridge_decode_params(bq, cfg)
    vision = torch.randn(3, 17, 64, generator=g, device=dev).to(torch.bfloat16)
    ck, cp = (_build_cross_cache(bq, cfg, vision, 6, torch.bfloat16, kv_quant=True)
              for _ in range(2))
    kw = dict(num_heads_cross=2, num_heads_self=4, eps=1e-5)
    for t in range(3):
        x = torch.randn(3, 256, generator=g, device=dev).to(torch.bfloat16)
        got = dk.fused_bridge_step(t, x, bst, ck.cross_k, ck.cross_k_scale, ck.cross_v,
                                   ck.cross_v_scale, ck.self_k, ck.self_v, **kw)
        want = dk.fused_bridge_step_plain(t, x, bst, cp.cross_k, cp.cross_k_scale, cp.cross_v,
                                          cp.cross_v_scale, cp.self_k, cp.self_v, **kw)
        _close(got, want)


def test_argmax_kernel_ties_and_nan(dev):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(70, 128, generator=g, device=dev).to(torch.bfloat16)
    table = quant.quantize_int8(torch.randn(1000, 128, generator=g, device=dev) * 0.05, axis=1)
    for v in (300, 900):
        table["w_int8"][v] = (torch.sign(x[1].float()) * 127).to(torch.int8)
        table["scale"][v] = 0.05
    x[3] = float("nan")
    got = quant.int8_matmul_t_argmax(x, table)
    assert torch.equal(got, quant.int8_matmul_t_argmax_plain(x, table))
    assert int(got[1]) == 300 and int(got[3]) == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from vlm_bridge_tpu_torch.ops import quant

    table = quant.quantize_int8(torch.randn(256, 128, device=dev), axis=1)
    with pytest.raises(ValueError, match="bfloat16"):
        quant.int8_matmul_t_argmax(torch.randn(4, 128, device=dev), table)
    with pytest.raises(ValueError, match="multiple of 64"):
        quant.int8_matmul_t_argmax(
            torch.randn(4, 96, device=dev).to(torch.bfloat16),
            quant.quantize_int8(torch.randn(256, 96, device=dev), axis=1))
