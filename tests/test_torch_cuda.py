"""PyTorch port kernels on the card: each CUDA kernel against its plain
version at small widths (the decode steps, with int8 and with int4 MLP
weights, at batch 1 / 3 / 64 / 65 and past a 64-row cache tile, and their
GEMM core alone, the greedy and sampled heads, the three flash-attention kernels with their
autograd function and shape gate, on views and contiguous tensors, the four int8 linear functions with
`linear`'s dispatch, and the int4 heads and `int4_mlp`), the orchestrator's
tiny run reaching the flash kernels, and exact mode on f32 tensors asking for
the reference attention.
These need an NVIDIA GPU with nvcc (sm_90a) and
skip elsewhere; run them on the card with

    python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda
"""

import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = 3e-2  # x max|ref|: bf16 activations, different f32 summation order
# the flash kernels, row by row (chip_smoke.py holds them to the same limits)
FLASH_TOL, FLASH_FLOOR, LSE_TOL = 1.6e-2, 1e-2, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _close(got, want):
    err = float((got.detach().float() - want.detach().float()).abs().max())
    assert err <= TOL * float(want.float().abs().max()), err


def test_stack_step_kernel_matches_plain(dev):
    from vlm_bridge_tpu_torch.configs import Gemma2Config
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
    from vlm_bridge_tpu_torch.configs import BridgeConfig
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


FLASH_CASES = [
    # name, (B, T, S, H, KH, D), kwargs, lens (q_mul in kwargs: q is randn times it)
    ("gqa_causal_softcap_d256", (2, 100, 100, 4, 2, 256),
     dict(is_causal=True, logit_softcap=50.0, sliding_window=4096), [100, 37]),
    ("bidir_d128", (2, 96, 96, 3, 3, 128), {}, [96, 5]),
    ("vit_d64", (2, 257, 257, 4, 4, 64), {}, None),
    ("window_t_ne_s", (2, 64, 200, 4, 2, 64),
     dict(is_causal=True, logit_softcap=30.0, sliding_window=48), None),
    ("empty_row", (3, 70, 70, 2, 1, 128), dict(is_causal=True), [70, 0, 9]),
    # logits with standard deviation 2 against a cap of 2: tanh and 1 - tanh^2 bind
    ("softcap_binds", (2, 100, 100, 4, 2, 128),
     dict(is_causal=True, logit_softcap=2.0, q_mul=2.0), [100, 61]),
]


def _flash_inputs(dev, shape, lens, seed):
    B, T, S, H, KH, D = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)  # noqa: E731
    kv = torch.tensor([S] * B if lens is None else lens, dtype=torch.int32, device=dev)
    return mk(B, T, H, D), mk(B, S, KH, D), mk(B, S, KH, D), mk(B, T, H, D), kv


@pytest.mark.parametrize("name,shape,kwargs,lens", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_kernels_match_plain(dev, name, shape, kwargs, lens):
    """Forward, dq and dk/dv kernels against their plain versions on the same
    bf16 inputs, row by row: FLASH_TOL x the row's max|ref| (two bf16 steps;
    outputs are rounded to bf16, p and ds at another scale than in the plain
    version), rows of pure rounding noise against FLASH_FLOOR x the tensor's
    max|ref|; lse LSE_TOL absolute."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    q, k, v, do, kv = _flash_inputs(dev, shape, lens, seed=3)
    kw = dict(scale=shape[-1] ** -0.5, is_causal=False, logit_softcap=None, sliding_window=None)
    kw.update(kwargs)
    q = (q.float() * kw.pop("q_mul", 1.0)).to(torch.bfloat16)
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in counted]
    out_p, lse_p = fa.flash_attention_plain(q, k, v, kv, **kw)
    want = fa.flash_attention_bwd_plain(q, k, v, kv, out_p, lse_p, do, **kw)
    out, lse = fa.flash_attention_fwd(q, k, v, kv, **kw)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, kv, out_p, lse_p, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv, out_p, lse_p, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [n + 1 for n in before]
    # the dq kernel's delta: the same f32 sum in another order
    torch.testing.assert_close(delta, fa._delta(out_p, do), rtol=1e-5, atol=1e-5)
    for got, ref in ((out, out_p), (dq, want[0]), (dk, want[1]), (dv, want[2])):
        diff = (got.float() - ref.float()).abs().amax(dim=-1)
        scale = ref.float().abs().amax(dim=-1)
        scale = torch.maximum(scale, FLASH_FLOOR * scale.max()).clamp_min(1e-30)
        assert float((diff / scale).max()) <= FLASH_TOL
    full = lse_p > -1e38
    assert float((lse[full] - lse_p[full]).abs().max()) <= LSE_TOL
    assert torch.equal(lse[~full], lse_p[~full])
    if lens is not None and 0 in lens:
        b0 = lens.index(0)
        assert all(float(t[b0].float().abs().max()) == 0.0 for t in (out, dq, dk, dv))


def test_flash_autograd_function_and_gate_on_the_card(dev):
    """dot_product_attention on bf16 CUDA tensors launches the three kernels
    through the autograd function and agrees with the plain versions; f32
    tensors of a supported shape raise (the kernels take bf16, and nothing
    gives way to the plain version on the card); head dim 288 takes the
    reference path."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.ops.attention import dot_product_attention

    q, k, v, do, kv = _flash_inputs(dev, (2, 50, 50, 4, 2, 128), [50, 20], seed=4)
    mask = (torch.arange(50, device=dev)[None, :] < kv[:, None])[:, None, :]
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)

    def run():
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = dot_product_attention(*leaves, mask=mask, kv_lengths=kv, is_causal=True,
                                    logit_softcap=50.0)
        return out, torch.autograd.grad(out, leaves, do)

    before = [fn.launches for fn in counted]
    out, grads = run()
    assert [fn.launches for fn in counted] == [n + 1 for n in before]
    kw = dict(scale=128 ** -0.5, is_causal=True, logit_softcap=50.0, sliding_window=None)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, kv, **kw)
    grads_p = fa.flash_attention_bwd_plain(q, k, v, kv, out_p, lse_p, do, **kw)
    for got, ref in ((out, out_p), *zip(grads, grads_p)):
        _close(got, ref)
    with pytest.raises(ValueError, match="bfloat16"):
        dot_product_attention(q.float(), k.float(), v.float(), mask=mask, kv_lengths=kv)
    wide = torch.randn(1, 4, 2, 288, device=dev).to(torch.bfloat16)
    dot_product_attention(wide, wide, wide)
    assert [fn.launches for fn in counted] == [n + 1 for n in before]


def test_flash_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    q, k, v, _, kv = _flash_inputs(dev, (1, 8, 8, 2, 2, 64), None, seed=5)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_fwd(q.float(), k.float(), v.float(), kv, scale=0.125)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q[..., :32].contiguous(), k[..., :32].contiguous(),
                               v[..., :32].contiguous(), kv, scale=0.125)
    # the forward reads views in place, but its tensor maps need D contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, kv,
                               scale=0.125)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_fwd(q, k, v, kv.long(), scale=0.125)
    # the backward kernels read views in place too, but need D contiguous
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_bwd_dq(q.transpose(2, 3).contiguous().transpose(2, 3), k, v, kv,
                                  q, torch.zeros(1, 2, 8, device=dev), q, scale=0.125)


def _fused_views(dev, B, T, H, KH, D, seed, pad=0):
    """q [B, T, H, D] and k, v [B, T, KH, D] as column views of one fused
    [B, T + pad, (H + 2 KH) D] projection, as dinov2._attention and the bridge's
    serving form hand them over; batch b's v is scaled by b + 1 (q and k are
    not: lse is held to LSE_TOL absolute, under three f32 steps once |lse|
    passes 16), and the pad rows past T hold NaN (a kernel that read them
    would show it)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fused = torch.randn(B, T + pad, (H + 2 * KH) * D, generator=g, device=dev)
    fused[..., (H + KH) * D:] *= torch.arange(1, B + 1, device=dev)[:, None, None]
    fused[:, T:] = float("nan")
    fused = fused.to(torch.bfloat16)[:, :T]
    q = fused[..., :H * D].reshape(B, T, H, D)
    k = fused[..., H * D:(H + KH) * D].reshape(B, T, KH, D)
    v = fused[..., (H + KH) * D:].reshape(B, T, KH, D)
    return q, k, v


FWD_VIEW_CASES = [
    # name, (B, T, H, KH, D), kwargs, lens
    ("d64_vit_tail", (3, 257, 4, 4, 64), {}, None),
    ("d128_gqa_causal_ragged", (2, 200, 4, 2, 128), dict(is_causal=True, logit_softcap=50.0),
     [200, 77]),
    ("d256_gqa_window", (2, 150, 4, 2, 256),
     dict(is_causal=True, logit_softcap=50.0, sliding_window=64), [150, 150]),
    # more work units than the card has SMs: each persistent block walks several
    ("d64_many_units", (8, 257, 16, 16, 64), {}, None),
    ("d128_many_units", (8, 256, 18, 18, 128), {}, [256, 200, 100, 256, 7, 256, 64, 129]),
    ("d256_many_units", (8, 256, 8, 4, 256), dict(is_causal=True, logit_softcap=50.0),
     [256, 200, 100, 256, 7, 256, 64, 129]),
    # G = 1 under a binding window with kv_lens so short that late row tiles
    # see no key: a unit's two items are neighbouring row tiles, one of them
    # (or both) empty, and no warpgroup may wait for a tile its unit never loads
    ("d128_g1_window_short_lens", (3, 256, 4, 4, 128), dict(sliding_window=64), [256, 10, 70]),
    ("d128_g1_causal_window_short_lens", (3, 256, 4, 4, 128),
     dict(is_causal=True, sliding_window=64), [256, 10, 70]),
    ("d64_g1_window_short_lens", (3, 512, 4, 4, 64), dict(sliding_window=32), [512, 10, 70]),
]


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("name,shape,kwargs,lens", FWD_VIEW_CASES,
                         ids=[c[0] for c in FWD_VIEW_CASES])
def test_flash_fwd_kernel_reads_views_in_place(dev, name, shape, kwargs, lens, layout):
    """The forward at D 64 / 128 / 256 on column views of a fused projection
    (NaN in the rows past T) and on contiguous copies, against the plain
    version row by row; both layouts and repeated calls give the same bits.
    B = 3 with T = 257:
    each batch's v scaled differently, so reading a neighbour batch's rows,
    or the NaN rows past T, would show."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    B, T, H, KH, D = shape
    q, k, v = _fused_views(dev, B, T, H, KH, D, seed=6, pad=9)
    if layout == "contiguous":
        q, k, v = (t.contiguous() for t in (q, k, v))
    else:
        assert not q.is_contiguous() and q.stride(1) == (H + 2 * KH) * D
    kv = torch.tensor([T] * B if lens is None else lens, dtype=torch.int32, device=dev)
    kw = dict(scale=D ** -0.5, is_causal=False, logit_softcap=None, sliding_window=None)
    kw.update(kwargs)
    before = fa.flash_attention_fwd.launches
    out, lse = fa.flash_attention_fwd(q, k, v, kv, **kw)
    out_p, lse_p = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                            kv, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_fwd.launches == before + 1
    assert out.is_contiguous() and bool(torch.isfinite(out).all())
    diff = (out.float() - out_p.float()).abs().amax(dim=-1)
    scale = out_p.float().abs().amax(dim=-1)
    scale = torch.maximum(scale, FLASH_FLOOR * scale.max()).clamp_min(1e-30)
    assert float((diff / scale).max()) <= FLASH_TOL
    assert float((lse - lse_p).abs().max()) <= LSE_TOL
    if layout == "views":
        out_c, lse_c = fa.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                              kv, **kw)
        assert torch.equal(out, out_c) and torch.equal(lse, lse_c)
    # every call gives the same bits (a block walks several units; a warpgroup
    # with no item in one must not run ahead of the other)
    for _ in range(5):
        again, lse_again = fa.flash_attention_fwd(q, k, v, kv, **kw)
        assert torch.equal(again, out) and torch.equal(lse_again, lse)


def test_flash_fwd_refuses_strides_off_16_bytes(dev):
    """A row or head stride that is not a multiple of 16 bytes cannot be a
    tensor map's stride: the wrapper raises before the kernel is called."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(7)
    kv = torch.full((2,), 8, dtype=torch.int32, device=dev)
    k = torch.randn(2, 8, 2, 64, generator=g, device=dev).to(torch.bfloat16)
    odd_head = torch.randn(2, 8, 2, 68, generator=g, device=dev).to(torch.bfloat16)[..., :64]
    odd_row = torch.randn(2, 8, 2 * 64 + 4, generator=g, device=dev).to(torch.bfloat16)
    odd_row = odd_row[..., :128].reshape(2, 8, 2, 64)
    before = fa.flash_attention_fwd.launches
    for q in (odd_head, odd_row):
        with pytest.raises(ValueError, match="16 bytes"):
            fa.flash_attention_fwd(q, k, k, kv, scale=0.125)
    with pytest.raises(ValueError, match="16 bytes"):
        fa.flash_attention_fwd(k, odd_head, k, kv, scale=0.125)
    assert fa.flash_attention_fwd.launches == before


def _rows_within(got, ref):
    """Worst row error of got against ref [..., D], in units of the row's scale
    (FLASH_TOL x the row's max|ref|, not under FLASH_FLOOR x the tensor's)."""
    diff = (got.float() - ref.float()).abs().amax(dim=-1)
    scale = ref.float().abs().amax(dim=-1)
    scale = torch.maximum(scale, FLASH_FLOOR * scale.max()).clamp_min(1e-30)
    return float((diff / scale).max())


@pytest.mark.parametrize("layout", ["views", "contiguous"])
@pytest.mark.parametrize("name,shape,kwargs,lens", FWD_VIEW_CASES,
                         ids=[c[0] for c in FWD_VIEW_CASES])
def test_flash_bwd_kernels_read_views_in_place(dev, name, shape, kwargs, lens, layout):
    """dq (with its delta) and dk / dv at D 64 / 128 / 256 on column views of
    fused tensors (q, k, v of one projection; out and dout of another; NaN in
    the rows past T) and on contiguous copies, against the plain backward row
    by row: many units a call, G = 1 under a window past short kv_lens, the
    D 256 column split. Both layouts and repeated calls give the same bits."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    B, T, H, KH, D = shape
    q, k, v = _fused_views(dev, B, T, H, KH, D, seed=11, pad=9)
    g = torch.Generator(device=dev).manual_seed(12)
    kv = torch.tensor([T] * B if lens is None else lens, dtype=torch.int32, device=dev)
    kw = dict(scale=D ** -0.5, is_causal=False, logit_softcap=None, sliding_window=None)
    kw.update(kwargs)
    out_p, lse_p = fa.flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                            kv, **kw)
    od = torch.randn(B, T + 9, 2 * H * D, generator=g, device=dev)
    od[:, T:] = float("nan")
    od = od.to(torch.bfloat16)[:, :T]
    od[..., :H * D] = out_p.reshape(B, T, H * D)
    out, do = od[..., :H * D].reshape(B, T, H, D), od[..., H * D:].reshape(B, T, H, D)
    if layout == "contiguous":
        q, k, v, out, do = (t.contiguous() for t in (q, k, v, out, do))
    else:
        assert not (q.is_contiguous() or out.is_contiguous() or do.is_contiguous())
    want = fa.flash_attention_bwd_plain(q.contiguous(), k.contiguous(), v.contiguous(), kv,
                                        out.contiguous(), lse_p, do.contiguous(), **kw)
    counted = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in counted]
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, kv, out, lse_p, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv, out, lse_p, do, delta=delta, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [n + 1 for n in before]
    torch.testing.assert_close(delta, fa._delta(out.contiguous(), do.contiguous()),
                               rtol=1e-5, atol=1e-5)
    for got, ref in ((dq, want[0]), (dk, want[1]), (dv, want[2])):
        assert got.is_contiguous() and bool(torch.isfinite(got).all())
        assert _rows_within(got, ref) <= FLASH_TOL
    if layout == "views":
        cq, ck, cv, co, cd = (t.contiguous() for t in (q, k, v, out, do))
        dq_c, delta_c = fa.flash_attention_bwd_dq(cq, ck, cv, kv, co, lse_p, cd, **kw)
        dk_c, dv_c = fa.flash_attention_bwd_dkv(cq, ck, cv, kv, co, lse_p, cd, delta=delta_c,
                                                **kw)
        assert torch.equal(dq, dq_c) and torch.equal(delta, delta_c)
        assert torch.equal(dk, dk_c) and torch.equal(dv, dv_c)
    # every call gives the same bits (no atomics; the G heads summed in one order)
    for _ in range(3):
        dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, kv, out, lse_p, do, **kw)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, kv, out, lse_p, do, delta=delta2, **kw)
        assert torch.equal(dq2, dq) and torch.equal(delta2, delta)
        assert torch.equal(dk2, dk) and torch.equal(dv2, dv)


def test_flash_kernels_run_from_a_fresh_thread(dev):
    """Each flash wrapper called first thing on a new thread (as PyTorch's
    autograd thread calls the backward): the tensor maps are encoded with the
    tensors' device made current, and the results equal the main thread's."""
    import threading

    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    q, k, v, do, kv = _flash_inputs(dev, (2, 50, 50, 4, 2, 128), [50, 20], seed=14)
    kw = dict(scale=128 ** -0.5, is_causal=True, logit_softcap=50.0, sliding_window=None)

    def run():
        out, lse = fa.flash_attention_fwd(q, k, v, kv, **kw)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, kv, out, lse, do, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv, out, lse, do, delta=delta, **kw)
        torch.cuda.synchronize()
        return out, dq, dk, dv

    got = []
    th = threading.Thread(target=lambda: got.append(run()))
    th.start()
    th.join()
    assert len(got) == 1
    for a, b in zip(got[0], run()):
        assert torch.equal(a, b)


def test_flash_bwd_refuses_strides_off_16_bytes(dev):
    """The backward wrappers raise before any launch on a q, k, v, out or
    dout whose row or head stride is not a multiple of 16 bytes."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(13)
    kv = torch.full((2,), 8, dtype=torch.int32, device=dev)
    t = torch.randn(2, 8, 2, 64, generator=g, device=dev).to(torch.bfloat16)
    lse = torch.zeros(2, 2, 8, device=dev)
    odd_head = torch.randn(2, 8, 2, 68, generator=g, device=dev).to(torch.bfloat16)[..., :64]
    odd_row = torch.randn(2, 8, 2 * 64 + 4, generator=g, device=dev).to(torch.bfloat16)
    odd_row = odd_row[..., :128].reshape(2, 8, 2, 64)
    counted = (fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in counted]
    for odd in (odd_head, odd_row):
        for at in range(5):   # q, k, v, out, dout
            args = [t, t, t, t, t]
            args[at] = odd
            q, k, v, out, do = args
            with pytest.raises(ValueError, match="16 bytes"):
                fa.flash_attention_bwd_dq(q, k, v, kv, out, lse, do, scale=0.125)
            if at != 3:   # the dk/dv kernel does not read out when it gets a delta
                with pytest.raises(ValueError, match="16 bytes"):
                    fa.flash_attention_bwd_dkv(q, k, v, kv, out, lse, do, scale=0.125,
                                               delta=lse)
    assert [fn.launches for fn in counted] == before


def test_vit_attention_hands_views_to_the_kernel(dev, monkeypatch):
    """dinov2's attention hands the forward kernel q, k and v as views of its
    fused projection: the pointers the C entry gets are one row's q, k and v
    columns, h elements apart, with the fused row's stride 3 h. No copy is
    made before the kernel."""
    from vlm_bridge_tpu_torch.configs import DinoV2Config
    from vlm_bridge_tpu_torch.models import dinov2
    from vlm_bridge_tpu_torch.ops import cuda_lib
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    cfg = DinoV2Config(hidden_size=256, num_layers=1, num_heads=4, image_size=224)
    g = torch.Generator(device=dev).manual_seed(8)
    params = dinov2.init(cfg, generator=g, device=dev)
    px = torch.randn(2, 224, 224, 3, generator=g, device=dev).to(torch.bfloat16)
    calls, real = [], cuda_lib.call
    monkeypatch.setattr(cuda_lib, "call", lambda name, *a: calls.append((name, a)) or real(name, *a))
    before = fa.flash_attention_fwd.launches
    dinov2.forward(params, cfg, px)
    assert fa.flash_attention_fwd.launches == before + cfg.num_layers
    fwd = [a for name, a in calls if name == "vbt_flash_attention_fwd"]
    assert len(fwd) == cfg.num_layers
    h, T = cfg.hidden_size, 1 + (224 // cfg.patch_size) ** 2
    q_ptr, k_ptr, v_ptr = fwd[0][:3]
    assert k_ptr - q_ptr == v_ptr - k_ptr == h * 2
    assert fwd[0][-9:] == (T * 3 * h, 3 * h, cfg.head_dim) * 3


def test_head_product_keeps_the_f32_accumulator(dev):
    """logits_from_hidden on bf16 CUDA tensors: the product's f32 sums are
    the logits (error against an f32 product of the same bf16 values at f32
    rounding level, where a bf16-rounded product would be off by up to
    2^-9 of each logit), and the gradient reaches the hidden states."""
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2

    cfg = Gemma2Config(vocab_size=4096, hidden_size=256, final_logit_softcap=None)
    g = torch.Generator(device=dev).manual_seed(6)
    table = torch.randn(4096, 256, generator=g, device=dev).to(torch.bfloat16)
    hidden = torch.randn(2, 24, 256, generator=g, device=dev).to(torch.bfloat16)
    hidden.requires_grad_(True)
    got = gemma2.logits_from_hidden({"embedding": table}, cfg, hidden)
    want = hidden.detach().float() @ table.float().T
    assert got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-3          # logits up to ~60 in size
    w = torch.randn(got.shape, generator=g, device=dev)
    (dh,) = torch.autograd.grad((got * w).sum(), hidden)
    _close(dh, w.to(torch.bfloat16).float() @ table.float())
    capped = gemma2.logits_from_hidden(
        {"embedding": table}, Gemma2Config(vocab_size=4096, hidden_size=256), hidden)
    assert float(capped.abs().max()) <= 30.0


# the heads (csrc/tied_head.cu), greedy and sampled: batch 1 / 3 / 64 / 65 / 130 (one to
# three 64-row batch tiles), vocab sizes off the 128-row unit and the 256-row
# pair, one int8 stage of 128 columns (H 128), 18 (H 2304), and two of which
# the last reaches half past H (H 192: the table box clipped and x's second
# box wholly past H, both read as zeros); int4 (H a multiple of 128) per
# channel, in groups of 64 and of 128
HEAD_M = [1, 3, 64, 65, 130]
HEAD_VH = [(1000, 128), (2037, 2304), (1000, 192)]
HEAD4 = [(v, h, grp) for v, h in HEAD_VH for grp in (None, 64, 128)
         if h % 128 == 0 and (h // 2) % (grp or 1) == 0]


# ---------------------------------------------------------------------------
# int8_matmul / int8_mlp / int8_ffn / int8_matmul_t
# ---------------------------------------------------------------------------

# Kernel against plain version on the same bf16 x: both accumulate in f32 and
# round the result (and the hidden) to bf16, in another summation order, so a
# value may land one bf16 step (2^-8 relative) away; held row by row to
# I8_TOL = two steps of the row's max|ref|. The f32 logits carry no output
# rounding: LOGIT_TOL x the row's max|ref|.
I8_TOL, LOGIT_TOL = 2.0 ** -7, 1e-5

I8_SHAPES = [
    # M, H, F: rows, hidden, FFN width
    (5, 80, 208),        # one ragged row tile, ragged K chunk, ragged column tile
    (64, 256, 1024),     # the decode batch, whole tiles
    (130, 144, 80),      # three row tiles, the last ragged
]


def _i8_case(dev, M, H, F, seed=10):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q = lambda i, o: quant.quantize_int8(mk(i, o) * 0.05, axis=0)  # noqa: E731
    return {"x": mk(M, H).to(torch.bfloat16), "gate": q(H, F), "up": q(H, F), "down": q(F, H),
            "b1": mk(F) * 0.1, "b2": mk(H) * 0.1}


def _rows_close(got, want, tol):
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    assert float((diff / scale).max()) <= tol, float((diff / scale).max())


@pytest.mark.parametrize("M,H,F", I8_SHAPES, ids=[f"M{m}_H{h}_F{f}" for m, h, f in I8_SHAPES])
def test_int8_linear_kernels_match_plain(dev, M, H, F):
    from vlm_bridge_tpu_torch.ops import quant

    c = _i8_case(dev, M, H, F)
    x = c["x"]
    runs = (
        (quant.int8_matmul, quant.int8_matmul_plain, (x, c["gate"])),
        (quant.int8_mlp, quant.int8_mlp_plain, (x, c["gate"], c["up"], c["down"])),
        (quant.int8_ffn, quant.int8_ffn_plain, (x, c["gate"], c["b1"], c["down"], c["b2"])),
    )
    for fn, plain, args in runs:
        n = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n + 1 and got.dtype == torch.bfloat16
        _rows_close(got, plain(*args), I8_TOL)
        assert torch.equal(got, fn(*args))    # fixed-order reduce: the same bits again


def _sampled_head_checks(head, plain, entry, x, table, group, tol):
    """One call of a sampled head against its plain version (one launch, the
    f32 logits row by row within tol), the same bits from a second call, and
    its C entry into a sentinel-filled buffer that runs past the logits by the
    rest of the last 64-row batch tile and a 128-row vocab unit: the logits
    land in front, and nothing past row M (nor past V in the last row) is
    written."""
    from vlm_bridge_tpu_torch.ops import cuda_lib

    (M, H), V = x.shape, table["scale"].shape[-1]
    n = head.launches
    got = head(x, table)
    torch.cuda.synchronize()
    assert head.launches == n + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, V)
    _rows_close(got, plain(x, table), tol)
    assert torch.equal(got.view(torch.int32), head(x, table).view(torch.int32))
    sentinel = -12345.0
    buf = torch.full((-(-M // 64) * 64 * V + 128,), sentinel, device=x.device)
    int8 = entry == "vbt_int8_matmul_t"
    w = table["w_int8"] if int8 else table["w_int4"]
    extra = () if int8 else (group or 0,)
    cuda_lib.call(entry, *(cuda_lib.ptr(t) for t in (x, w, table["scale"], buf)), M, V, H, *extra)
    torch.cuda.synchronize()
    assert torch.equal(buf[:M * V].view(torch.int32), got.view(-1).view(torch.int32))
    assert bool((buf[M * V:] == sentinel).all())


# The sampled heads (csrc/tied_head.cu: the greedy heads' kernel with the logits
# epilogue): their first cases, then the greedy heads' grid, HEAD_M x HEAD_VH
# (int8) and x HEAD4 (int4)
I8_LOGITS = [(5, 1000, 128), (64, 4096, 256), (70, 130, 64)] + [
    (m, v, h) for v, h in HEAD_VH for m in HEAD_M]


@pytest.mark.parametrize("M,V,H", I8_LOGITS, ids=[f"M{m}_V{v}_H{h}" for m, v, h in I8_LOGITS])
def test_int8_matmul_t_kernel_matches_plain(dev, M, V, H):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(M, H, generator=g, device=dev).to(torch.bfloat16)
    table = quant.quantize_int8(torch.randn(V, H, generator=g, device=dev) * 0.05, axis=1)
    _sampled_head_checks(quant.int8_matmul_t, quant.int8_matmul_t_plain, "vbt_int8_matmul_t",
                         x, table, None, LOGIT_TOL)


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """f32 x on the card raises (nothing gives way to the plain version
    there); so do widths the loads cannot align and an f64 bias."""
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.ops import quant

    c = _i8_case(dev, 4, 64, 128)
    xf = c["x"].float()
    for call in (lambda: quant.int8_matmul(xf, c["gate"]),
                 lambda: quant.int8_mlp(xf, c["gate"], c["up"], c["down"]),
                 lambda: quant.int8_ffn(xf, c["gate"], c["b1"], c["down"], c["b2"]),
                 lambda: quant.int8_matmul_t(xf, quant.quantize_int8(
                     torch.randn(256, 64, device=dev), axis=1))):
        with pytest.raises(ValueError, match="bfloat16"):
            call()
    odd = quant.quantize_int8(torch.randn(64, 72, device=dev), axis=0)   # 72 % 16 != 0
    with pytest.raises(ValueError, match="multiple"):
        quant.int8_matmul(c["x"], odd)
    with pytest.raises(ValueError, match="float32"):
        quant.int8_ffn(c["x"], c["gate"], c["b1"].double(), c["down"], c["b2"])
    # an int8 table under f32 hidden states on the card raises too
    cfg = Gemma2Config(vocab_size=256, hidden_size=64)
    table = quant.quantize_int8(torch.randn(256, 64, device=dev), axis=1)
    with pytest.raises(ValueError, match="bfloat16"):
        gemma2.logits_from_hidden({"embedding": table}, cfg, xf[None])


def test_linear_on_a_cuda_dict_launches_the_kernel(dev):
    from vlm_bridge_tpu_torch.ops import quant
    from vlm_bridge_tpu_torch.ops.layers import linear

    c = _i8_case(dev, 6, 64, 128)
    x = c["x"].reshape(2, 3, 64)
    n = quant.int8_matmul.launches
    got = linear(x, c["gate"], c["b1"])
    assert quant.int8_matmul.launches == n + 1
    assert tuple(got.shape) == (2, 3, 128) and got.dtype == torch.bfloat16
    want = quant.int8_matmul_plain(c["x"], c["gate"]) + c["b1"].to(torch.bfloat16)
    _rows_close(got.reshape(6, 128), want, I8_TOL)
    with pytest.raises(ValueError, match="bfloat16"):
        linear(x.float(), c["gate"])


def test_per_layer_decode_step_runs_the_kernels(dev):
    """gemma2.decode_step and logits_from_hidden on int8 dicts on the card:
    one int8_matmul for qkv and one for o per layer, one int8_mlp per layer,
    one int8_matmul_t; hidden states agree with the same step through the
    plain versions."""
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import quant

    cfg = Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=64, query_pre_attn_scalar=64.0,
                       sliding_window=4)
    g = torch.Generator(device=dev).manual_seed(12)
    q = gemma2.quantize_params(gemma2.init(cfg, generator=g, device=dev))
    counted = (quant.int8_matmul, quant.int8_mlp, quant.int8_matmul_t)
    names = ("int8_matmul", "int8_mlp", "int8_matmul_t")
    ck, cp = (gemma2.KVCache.zeros(cfg, 5, 8, device=dev) for _ in range(2))
    with torch.no_grad():
        for t in range(6):
            e = (torch.randn(5, 1, 256, generator=g, device=dev) * 0.02).to(torch.bfloat16)
            before = [fn.launches for fn in counted]
            hk, ck = gemma2.decode_step(q, cfg, e, ck, position=t)
            lk = gemma2.logits_from_hidden(q, cfg, hk)
            assert [fn.launches - n for fn, n in zip(counted, before)] == [6, 3, 1]
            saved = [getattr(quant, n) for n in names]
            try:
                for n in names:
                    setattr(quant, n, getattr(quant, n + "_plain"))
                hp, cp = gemma2.decode_step(q, cfg, e, cp, position=t)
                lp = gemma2.logits_from_hidden(q, cfg, hp)
            finally:
                for n, fn in zip(names, saved):
                    setattr(quant, n, fn)
            _close(hk, hp)
            _close(lk, lp)


# ---------------------------------------------------------------------------
# int4: the two heads, int4_mlp and the stack step's int4 MLP stage
# ---------------------------------------------------------------------------

# group partials are scaled in f32 in another order than the plain version's
# dequantize-then-multiply: a few f32 steps of the row's largest logit
LOGIT4_TOL = 2e-5
I4_ROWS = [(5, 1000, 128, None), (64, 4096, 256, 128), (70, 130, 256, 64), (64, 777, 512, 128)]


def _i4_table(dev, V, H, group, seed=20):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    return g, quant.quantize_int4_rows(torch.randn(V, H, generator=g, device=dev) * 0.05,
                                       group_size=group)


I4_LOGITS = I4_ROWS + [(m, v, h, grp) for v, h, grp in HEAD4 for m in HEAD_M]


@pytest.mark.parametrize("M,V,H,group", I4_LOGITS,
                         ids=[f"M{m}_V{v}_H{h}_g{g}" for m, v, h, g in I4_LOGITS])
def test_int4_matmul_t_kernel_matches_plain(dev, M, V, H, group):
    from vlm_bridge_tpu_torch.ops import quant

    g, table = _i4_table(dev, V, H, group)
    x = torch.randn(M, H, generator=g, device=dev).to(torch.bfloat16)
    _sampled_head_checks(quant.int4_matmul_t, quant.int4_matmul_t_plain, "vbt_int4_matmul_t",
                         x, table, group, LOGIT4_TOL)


@pytest.mark.parametrize("group", [None, 64])
def test_int4_argmax_kernel_ties_and_nan(dev, group):
    from vlm_bridge_tpu_torch.ops import quant

    g, table = _i4_table(dev, 1000, 128, group, seed=21)
    x = torch.randn(70, 128, generator=g, device=dev).to(torch.bfloat16)
    # two equal vocab rows in different blocks, aligned with row 1: the first wins
    row = (torch.sign(x[1].float()) * 7).to(torch.int8)
    packed = quant._pack_nibbles(row[:64], row[64:])
    for v in (300, 900):
        table["w_int4"][v] = packed
        if group is None:
            table["scale"][v] = 0.05
        else:
            table["scale"][:, v] = 0.05
    x[3] = float("nan")
    n = quant.int4_matmul_t_argmax.launches
    got = quant.int4_matmul_t_argmax(x, table)
    torch.cuda.synchronize()
    assert quant.int4_matmul_t_argmax.launches == n + 1
    want = quant.int4_matmul_t_argmax_plain(x, table)
    # a near-tie of two logits may fall either way between two f32 summation orders
    y = quant.int4_matmul_t_plain(x, table)
    rows = torch.arange(70, device=dev)
    differ = got != want
    differ[3] = False
    gap = (y[rows, want.long()] - y[rows, got.long()]).abs()
    assert not bool(differ.any()) or float(gap[differ].max()) <= LOGIT4_TOL * float(y[differ].abs().max())
    assert int(got[1]) == 300 and int(got[3]) == 0 and int(want[3]) == 0


def _ids_match(got, want, y, tol=LOGIT4_TOL):
    """ids equal the plain version's except where the two ids' plain logits lie
    within tol x the row's largest: a near-tie may fall either way between two
    f32 summation orders."""
    rows = torch.arange(y.shape[0], device=y.device)
    differ = got != want
    gap = (y[rows, want.long()] - y[rows, got.long()]).abs()
    lim = tol * y.nan_to_num(nan=0.0).abs().amax(dim=-1)
    assert bool((gap[differ] <= lim[differ]).all()), int(differ.sum())


@pytest.mark.parametrize("M", HEAD_M)
@pytest.mark.parametrize("V,H", HEAD_VH, ids=[f"V{v}_H{h}" for v, h in HEAD_VH])
def test_int8_head_kernel_matches_plain(dev, M, V, H):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(30 + M)
    x = torch.randn(M, H, generator=g, device=dev).to(torch.bfloat16)
    table = quant.quantize_int8(torch.randn(V, H, generator=g, device=dev) * 0.05, axis=1)
    n = quant.int8_matmul_t_argmax.launches
    got = quant.int8_matmul_t_argmax(x, table)
    torch.cuda.synchronize()
    assert quant.int8_matmul_t_argmax.launches == n + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (M,)
    _ids_match(got, quant.int8_matmul_t_argmax_plain(x, table), quant.int8_matmul_t_plain(x, table))
    assert torch.equal(got, quant.int8_matmul_t_argmax(x, table))   # a second call, the same ids


@pytest.mark.parametrize("M", HEAD_M)
@pytest.mark.parametrize("V,H,group", HEAD4, ids=[f"V{v}_H{h}_g{grp}" for v, h, grp in HEAD4])
def test_int4_head_kernel_matches_plain(dev, M, V, H, group):
    from vlm_bridge_tpu_torch.ops import quant

    g, table = _i4_table(dev, V, H, group, seed=40 + M)
    x = torch.randn(M, H, generator=g, device=dev).to(torch.bfloat16)
    n = quant.int4_matmul_t_argmax.launches
    got = quant.int4_matmul_t_argmax(x, table)
    torch.cuda.synchronize()
    assert quant.int4_matmul_t_argmax.launches == n + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (M,)
    _ids_match(got, quant.int4_matmul_t_argmax_plain(x, table), quant.int4_matmul_t_plain(x, table))
    assert torch.equal(got, quant.int4_matmul_t_argmax(x, table))


HEAD_RULES = [("int8", None), ("int4", None), ("int4", 64), ("int4", 128)]


@pytest.mark.parametrize("kind,group", HEAD_RULES, ids=[f"{k}_g{grp}" for k, grp in HEAD_RULES])
def test_head_kernels_ties_and_nan_across_units(dev, kind, group):
    """V 2037, H 2304, 70 rows (two batch tiles: 32 units, one a block).
    Row 1: equal winners at 400 and 1300 (units 3 and 10) -> 400. Row 2: equal
    winners at 130 and 140 (one 64-row tile) -> 130. Row 3 all NaN -> 0. Row 4:
    its best row 520 lies in unit 4, where a scale of row 600 is NaN (in
    groups: one group's of the low half): unit 4 never wins, and the next
    best, 1700, does. The sampled head on the same inputs: NaN in row 3 and in
    column 600 (every group's fold carries it), nowhere else, as in the plain
    version, which it matches elsewhere within LOGIT_TOL / LOGIT4_TOL."""
    from vlm_bridge_tpu_torch.ops import quant

    V, H = 2037, 2304
    g = torch.Generator(device=dev).manual_seed(50)
    x = torch.randn(70, H, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(V, H, generator=g, device=dev) * 0.05
    if kind == "int8":
        table = quant.quantize_int8(w, axis=1)
        top, put = 127, lambda v, r: table["w_int8"].__setitem__(v, r)
        scale = table["scale"]
    else:
        table = quant.quantize_int4_rows(w, group_size=group)
        top = 7
        put = lambda v, r: table["w_int4"].__setitem__(v, quant._pack_nibbles(r[:H // 2], r[H // 2:]))  # noqa: E731
        scale = table["scale"] if group is None else table["scale"].T   # [V] or [V, H/g]
    for r, plants in ((1, ((400, 0.05), (1300, 0.05))), (2, ((130, 0.05), (140, 0.05))),
                      (4, ((520, 0.06), (1700, 0.05)))):
        row = (torch.sign(x[r].float()) * top).to(torch.int8)
        for v, sc in plants:
            put(v, row)
            scale[v] = sc
    if group is None:
        scale[600] = float("nan")
    else:
        scale[600, 3] = float("nan")
    x[3] = float("nan")
    want = (quant.int8_matmul_t_argmax_plain if kind == "int8" else
            quant.int4_matmul_t_argmax_plain)(x, table)
    head = quant.int8_matmul_t_argmax if kind == "int8" else quant.int4_matmul_t_argmax
    got = head(x, table)
    torch.cuda.synchronize()
    assert [int(got[r]) for r in (1, 2, 3, 4)] == [400, 130, 0, 1700]
    assert [int(want[r]) for r in (1, 2, 3, 4)] == [400, 130, 0, 1700]
    y = (quant.int8_matmul_t_plain if kind == "int8" else quant.int4_matmul_t_plain)(x, table)
    keep = torch.ones(70, dtype=torch.bool, device=dev)
    keep[3] = False
    _ids_match(got[keep], want[keep], y[keep].nan_to_num(nan=float("-inf")))
    assert torch.equal(got, head(x, table))
    logits = (quant.int8_matmul_t if kind == "int8" else quant.int4_matmul_t)(x, table)
    nan = torch.zeros(70, V, dtype=torch.bool, device=dev)
    nan[3], nan[:, 600] = True, True
    assert torch.equal(torch.isnan(logits), nan) and torch.equal(torch.isnan(y), nan)
    cols = torch.ones(V, dtype=torch.bool, device=dev)
    cols[600] = False
    _rows_close(logits[keep][:, cols], y[keep][:, cols],
                LOGIT_TOL if kind == "int8" else LOGIT4_TOL)


def test_head_kernels_run_from_a_fresh_thread(dev):
    """The C entries bind the tensors' device before encoding their tensor maps."""
    import threading

    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(60)
    x = torch.randn(5, 256, generator=g, device=dev).to(torch.bfloat16)
    t8 = quant.quantize_int8(torch.randn(700, 256, generator=g, device=dev), axis=1)
    t4 = quant.quantize_int4_rows(torch.randn(700, 256, generator=g, device=dev), group_size=64)
    heads = (quant.int8_matmul_t_argmax, quant.int4_matmul_t_argmax, quant.int8_matmul_t,
             quant.int4_matmul_t)
    tables = (t8, t4, t8, t4)
    want = [head(x, t) for head, t in zip(heads, tables)]
    got = []
    th = threading.Thread(target=lambda: got.extend(head(x, t) for head, t in zip(heads, tables)))
    th.start()
    th.join()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and len(got) == 4


# M, H, F, block_f, group: rows 1 / 5 / 64 / 65 / 128 / 130 (one, two, three
# 64-row tiles), Gemma-2-2B's MLP at full width (gate | up unsplit: 144 column
# tiles; down split over a cluster), down over 8 stages in 8 slices (H 256),
# block_f 128 (a half of 64 packed rows), per channel and groups of 64 / 128
I4_MLP = [(5, 128, 512, 256, None), (64, 256, 1024, 512, 128), (130, 128, 256, 128, 64),
          (64, 512, 1024, 512, None), (1, 256, 1024, 256, None), (1, 2304, 9216, 512, 128),
          (64, 2304, 9216, 512, None), (64, 2304, 9216, 512, 128), (65, 256, 1024, 512, 64),
          (128, 512, 1024, 128, 64), (128, 256, 1024, 128, None), (130, 2304, 9216, 512, 128)]


def _i4_mlp_case(dev, M, H, F, block_f, group, seed=22):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q = lambda i, o: quant.quantize_int4(mk(i, o) * 0.05, group_size=group)  # noqa: E731
    return (mk(M, H).to(torch.bfloat16), q(H, F), q(H, F),
            quant.repack_down_blockwise(q(F, H), block_f=block_f))


@pytest.mark.parametrize("M,H,F,block_f,group", I4_MLP,
                         ids=[f"M{m}_H{h}_F{f}_b{b}_g{g}" for m, h, f, b, g in I4_MLP])
def test_int4_mlp_kernel_matches_plain(dev, M, H, F, block_f, group):
    from vlm_bridge_tpu_torch.ops import quant

    args = _i4_mlp_case(dev, M, H, F, block_f, group)
    n = quant.int4_mlp.launches
    got = quant.int4_mlp(*args, block_f=block_f)
    torch.cuda.synchronize()
    assert quant.int4_mlp.launches == n + 1 and got.dtype == torch.bfloat16
    _rows_close(got, quant.int4_mlp_plain(*args, block_f=block_f), I8_TOL)
    assert torch.equal(got, quant.int4_mlp(*args, block_f=block_f))   # fixed-order reduce


def _i4_splits(dev, M, H, F, group):
    """The slices of int4_mlp's two products on this card."""
    from vlm_bridge_tpu_torch.ops import quant

    sms = quant._sms(dev)
    slots = quant._cluster_slots(dev, "int4" if group is None else "int4_grouped")
    return (quant.int4_split(M, F, H // 2, dual=True, sms=sms, clusters=slots),
            quant.int4_split(M, H, F // 2, dual=False, sms=sms, clusters=slots))


def test_int4_mlp_cases_cover_split_1_and_8(dev):
    """I4_MLP holds a product run unsplit and one split over a cluster of 8."""
    splits = {s for M, H, F, _, group in I4_MLP for s in _i4_splits(dev, M, H, F, group)}
    assert {1, 8} <= splits, splits


def test_int4_mlp_runs_from_a_fresh_thread(dev):
    """int4_mlp called first thing on a new thread (per channel and in groups)
    gives the main thread's bits: its C entry binds the device before
    encoding the tensor maps."""
    import threading

    from vlm_bridge_tpu_torch.ops import quant

    cases = [_i4_mlp_case(dev, 64, 256, 1024, 512, group, seed=97) for group in (None, 64)]

    def run():
        out = [quant.int4_mlp(*c, block_f=512) for c in cases]
        torch.cuda.synchronize()
        return out

    got = []
    th = threading.Thread(target=lambda: got.append(run()))
    th.start()
    th.join()
    assert len(got) == 1, "the thread raised"
    assert all(torch.equal(a, b) for a, b in zip(got[0], run()))


def test_int4_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from vlm_bridge_tpu_torch.ops import quant

    x, gate, up, down = _i4_mlp_case(dev, 4, 128, 256, 128, None)
    with pytest.raises(ValueError, match="bfloat16"):
        quant.int4_mlp(x.float(), gate, up, down, block_f=128)
    with pytest.raises(ValueError, match="repack_down_blockwise"):
        quant.int4_mlp(x, gate, up, {**down, "packing": "global"}, block_f=128)
    with pytest.raises(ValueError, match="group_size"):
        quant.int4_mlp(x, gate, {**up, "group_size": 64}, down, block_f=128)
    narrow = _i4_mlp_case(dev, 4, 64, 128, 64, None)       # H/2 = 32 is no whole stage
    with pytest.raises(ValueError, match="multiples"):
        quant.int4_mlp(*narrow, block_f=64)
    table = quant.quantize_int4_rows(torch.randn(256, 128, device=dev))
    for head in (quant.int4_matmul_t, quant.int4_matmul_t_argmax):
        with pytest.raises(ValueError, match="bfloat16"):
            head(torch.randn(4, 128, device=dev), table)
        with pytest.raises(ValueError, match="multiple of 128"):
            head(torch.randn(4, 64, device=dev).to(torch.bfloat16),
                 quant.quantize_int4_rows(torch.randn(256, 64, device=dev)))


@pytest.mark.parametrize("group", [None, 32, 128])
def test_stack_step_int4_mlp_kernel_matches_plain(dev, group):
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    cfg = Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=64, query_pre_attn_scalar=64.0,
                       sliding_window=128)
    g = torch.Generator(device=dev).manual_seed(23)
    q = gemma2.quantize_params(gemma2.init(cfg, generator=g, device=dev))
    st = gemma2.stack_decode_params(q, cfg, mlp_int4=True, mlp_int4_group=group)
    assert "wgu" not in st and st["gu_scale4"].shape[1] == (1 if group is None else 256 // group)
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
        # f32 inside on both sides: far closer than the bf16 tolerance above
        assert float((got.float() - want.float()).abs().max()) <= \
            2.0 ** -7 * float(want.float().abs().max())
    with pytest.raises(ValueError, match="neither"):
        dk.fused_stack_step(0, x, {k: v for k, v in st.items() if k not in ("wgu4",)},
                            *ck, cos, sin, **kw)
    # scales of 0 (a group, a column): the kernel weighs them 1e-30, the plain version 0
    st["gu_scale4"][0, 0, :64] = 0.0
    st["d_scale4"][1, -1] = 0.0
    st["d_scale4"][2, :, 5] = 0.0
    ck, cp = (gemma2.StackedKVCache.zeros(cfg, 5, 8, device=dev) for _ in range(2))
    got = dk.fused_stack_step(0, x, st, *ck, cos, sin, **kw)
    want = dk.fused_stack_step_plain(0, x, st, *cp, cos, sin, **kw)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, want)


# ---------------------------------------------------------------------------
# The fused steps' GEMM core (csrc/decode_gemm.cuh): alone, and the two steps
# at batch 1 / 3 / 64 / 65, at t = 0 and past one 64-row cache tile
# ---------------------------------------------------------------------------

# f32 accumulation of the same products in another order, and split K slices
# added by atomics: each output row within GEMM_TOL of its largest value
GEMM_TOL = 1e-5
# K, N: one tile; a partial tile; 324 units over the SMs, so runs of K slices
# start and end inside tiles and inside scale groups
GEMM_SHAPES = [(128, 64), (384, 448), (2304, 2304)]


def _gemm_case(dev, M, K, N, seed):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    g = torch.Generator(device=dev).manual_seed(seed)
    a2 = dk.split_halves(torch.randn(M, K, generator=g, device=dev))
    w = torch.randint(-127, 128, (K, N), generator=g, device=dev, dtype=torch.int8)
    return g, a2, w


def _rows_near(got, want, tol):
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    assert float((diff / scale).max()) <= tol, float((diff / scale).max())


@pytest.mark.parametrize("M", [1, 3, 64, 65])
@pytest.mark.parametrize("K,N", GEMM_SHAPES, ids=[f"K{k}_N{n}" for k, n in GEMM_SHAPES])
def test_decode_gemm_kernel_matches_plain(dev, M, K, N):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    g, a2, w = _gemm_case(dev, M, K, N, seed=30 + M)
    wf = dk.to_fragments(w)
    scale = torch.rand(N, generator=g, device=dev) * 0.01
    bias = torch.randn(N, generator=g, device=dev)
    n = dk.decode_gemm.launches
    got = dk.decode_gemm(a2, wf, scale, bias)
    assert dk.decode_gemm.launches == n + 1
    _rows_near(got, dk.decode_gemm_plain(a2, wf, scale, bias), GEMM_TOL)
    _rows_near(dk.decode_gemm(a2, wf, scale), dk.decode_gemm_plain(a2, wf, scale), GEMM_TOL)


@pytest.mark.parametrize("M", [1, 3, 64, 65])
@pytest.mark.parametrize("K,N", GEMM_SHAPES, ids=[f"K{k}_N{n}" for k, n in GEMM_SHAPES])
@pytest.mark.parametrize("group", [None, 32, 64, 128])
def test_decode_gemm4_kernel_matches_plain(dev, M, K, N, group):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    g, a2, w = _gemm_case(dev, M, K, N, seed=40 + M)
    gs = K if group is None else group
    if K % gs:
        pytest.skip(f"K {K} holds no whole group of {gs}")
    wf4 = dk.to_fragments4((w // 16).clamp(-8, 7))
    scale = torch.rand(K // gs, N, generator=g, device=dev) * 0.01 + 1e-3
    scale[0, :5] = 0.0   # a scale of 0 weighs 1e-30 in the kernel, 0 in the plain version
    n = dk.decode_gemm4.launches
    got = dk.decode_gemm4(a2, wf4, scale)
    assert dk.decode_gemm4.launches == n + 1
    assert bool(torch.isfinite(got).all())
    _rows_near(got, dk.decode_gemm4_plain(a2, wf4, scale), GEMM_TOL)


def _stack_case(dev, B, mlp4, group, seed):
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2

    cfg = Gemma2Config(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=3,
                       num_heads=4, num_kv_heads=2, head_dim=64, query_pre_attn_scalar=64.0,
                       sliding_window=128)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = gemma2.quantize_params(gemma2.init(cfg, generator=g, device=dev))
    st = gemma2.stack_decode_params(q, cfg, mlp_int4=mlp4, mlp_int4_group=group)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=64, attn_scale=cfg.attn_scale,
              softcap=50.0, eps=1e-6)
    # 80 tokens: a 128-row cache, so t = 70 lies past the first 64-row tile
    caches = [gemma2.StackedKVCache.zeros(cfg, B, 80, device=dev) for _ in range(2)]
    for c in caches:   # the same history on both sides
        gc = torch.Generator(device=dev).manual_seed(seed + 1)
        c.k.copy_(torch.randint(-127, 128, c.k.shape, generator=gc, device=dev,
                                dtype=torch.int8))
        c.v.copy_(torch.randint(-127, 128, c.v.shape, generator=gc, device=dev,
                                dtype=torch.int8))
        c.k_scale.copy_(0.02 + 0.01 * torch.rand(c.k_scale.shape, generator=gc, device=dev))
        c.v_scale.copy_(0.02 + 0.01 * torch.rand(c.v_scale.shape, generator=gc, device=dev))
    return g, st, kw, caches


STACK_FORMS = [(False, None), (True, 128), (True, None)]   # int8; int4 group 128; per channel


@pytest.mark.parametrize("B", [1, 3, 64, 65])
@pytest.mark.parametrize("t", [0, 70])
@pytest.mark.parametrize("mlp4,group", STACK_FORMS, ids=["int8", "int4_g128", "int4_channel"])
def test_stack_step_kernel_at_batch_and_position(dev, B, t, mlp4, group):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    g, st, kw, (ck, cp) = _stack_case(dev, B, mlp4, group, seed=50 + B)
    x = torch.randn(B, 256, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), 64))
    got = dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw)
    want = dk.fused_stack_step_plain(t, x, st, *cp, cos, sin, **kw)
    _close(got, want)
    assert ((ck.k[:, :, :, t].int() - cp.k[:, :, :, t].int()).abs() <= 1).float().mean() > 0.99
    assert torch.equal(ck.k[:, :, :, :t], cp.k[:, :, :, :t])   # history untouched


def _bridge_case(dev, B, seed):
    from vlm_bridge_tpu_torch.configs import BridgeConfig
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge

    cfg = BridgeConfig(vision_dim=64, language_dim=256, num_blocks=2, num_heads_cross=2,
                       num_heads_self=4, ffn_mult=2)
    g = torch.Generator(device=dev).manual_seed(seed)
    bq = bridge.quantize_decode_params(bridge.init(cfg, generator=g, device=dev))
    bst = bridge.stack_bridge_decode_params(bq, cfg)
    vision = torch.randn(B, 17, 64, generator=g, device=dev).to(torch.bfloat16)
    caches = [_build_cross_cache(bq, cfg, vision, 80, torch.bfloat16, kv_quant=True)
              for _ in range(2)]
    hist = torch.randn(caches[0].self_k.shape, generator=g, device=dev).to(torch.bfloat16)
    for c in caches:
        c.self_k.copy_(hist)
        c.self_v.copy_(hist.flip(-1))
    kw = dict(num_heads_cross=2, num_heads_self=4, eps=1e-5)
    return g, bst, kw, caches


def _bridge_args(c):
    return c.cross_k, c.cross_k_scale, c.cross_v, c.cross_v_scale, c.self_k, c.self_v


@pytest.mark.parametrize("B", [1, 3, 64, 65])
@pytest.mark.parametrize("t", [0, 70])
def test_bridge_step_kernel_at_batch_and_position(dev, B, t):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    g, bst, kw, (ck, cp) = _bridge_case(dev, B, seed=60 + B)
    x = torch.randn(B, 256, generator=g, device=dev).to(torch.bfloat16)
    got = dk.fused_bridge_step(t, x, bst, *_bridge_args(ck), **kw)
    want = dk.fused_bridge_step_plain(t, x, bst, *_bridge_args(cp), **kw)
    _close(got, want)
    _close(ck.self_k[:, :, :, t], cp.self_k[:, :, :, t])


def test_decode_steps_run_from_a_fresh_thread(dev):
    """Each wrapper of the GEMM core called first thing on a new thread: the
    tensor maps are encoded with the tensors' device made current, and the
    results agree with the main thread's (split sums are added by atomics, in
    an order that may differ)."""
    import threading

    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    g, a2, w = _gemm_case(dev, 64, 384, 448, seed=70)
    wf, wf4 = dk.to_fragments(w), dk.to_fragments4((w // 16).clamp(-8, 7))
    scale = torch.rand(448, generator=g, device=dev) * 0.01
    scale4 = torch.rand(6, 448, generator=g, device=dev) * 0.01
    _, st, skw, stack_caches = _stack_case(dev, 64, False, None, seed=71)
    _, bst, bkw, bridge_caches = _bridge_case(dev, 64, seed=72)
    xs = torch.randn(64, 256, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([5], device=dev), 64))

    def run():
        out = [dk.decode_gemm(a2, wf, scale), dk.decode_gemm4(a2, wf4, scale4),
               dk.fused_stack_step(5, xs, st, *stack_caches[0], cos, sin, **skw),
               dk.fused_bridge_step(5, xs, bst, *_bridge_args(bridge_caches[0]), **bkw)]
        torch.cuda.synchronize()
        return out

    got = []
    th = threading.Thread(target=lambda: got.append(run()))
    th.start()
    th.join()
    assert len(got) == 1, "the thread raised"
    want = run()
    _rows_near(got[0][0], want[0], GEMM_TOL)
    _rows_near(got[0][1], want[1], GEMM_TOL)
    _close(got[0][2], want[2])
    _close(got[0][3], want[3])


# ---------------------------------------------------------------------------
# The ViT's kernels (tiled matmul, LayerNorm) and the per-layer fused decode
# ---------------------------------------------------------------------------

BF16_STEP = 2.0 ** -7  # one bf16 step of a row's largest value (chip_smoke.py: I8_TOL)


def _rows_close(got, want, tol=BF16_STEP):
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    assert float((diff / scale).max()) <= tol, float((diff / scale).max())


MM_CASES = [  # M, K, N, bias, gelu, out_dtype
    (257, 64, 96, False, False, None),        # ragged rows
    (512, 128, 256, False, False, None),      # whole tiles
    (520, 64, 136, True, False, None),        # ragged rows and columns
    (320, 64, 160, True, True, None),         # bias + GELU
    (1100, 4096, 1024, True, False, torch.float32),   # a deep contraction, f32 out
    (16448, 1024, 1024, True, False, None),   # the ViT's o projection at batch 64
    (256, 72, 128, True, False, None),        # a K tail: 72 = 64 + 8
    (192, 256, 256, True, False, None),       # a last row tile of 64 (16448 = 128 x 128 + 64)
    (384, 128, 264, True, False, None),       # N beyond a tile by 8: 264 = 2 x 128 + 8
    (300, 128, 192, False, True, None),       # GELU without a bias
    (640, 512, 320, True, True, torch.float32),   # f32 out with bias and GELU
]


@pytest.mark.parametrize("M,K,N,bias,gelu,out_dtype", MM_CASES,
                         ids=[f"M{c[0]}_K{c[1]}_N{c[2]}" for c in MM_CASES])
def test_tiled_matmul_kernel_matches_plain(dev, M, K, N, bias, gelu, out_dtype):
    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk

    g = torch.Generator(device=dev).manual_seed(31)
    a = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    b = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    bs = torch.randn(N, generator=g, device=dev) if bias else None
    n, nb = mk.tiled_matmul.launches, mk.tiled_matmul.bias_launches
    got = mk.tiled_matmul(a, b, bs, gelu=gelu, out_dtype=out_dtype)
    want = mk.tiled_matmul_plain(a, b, bs, gelu=gelu, out_dtype=out_dtype)
    assert got.dtype == (out_dtype or torch.bfloat16) and got.shape == (M, N)
    assert (mk.tiled_matmul.launches, mk.tiled_matmul.bias_launches) == (n + 1, nb + int(bias))
    # both round one f32 sum, taken in another order, to the output type
    _rows_close(got, want, BF16_STEP if out_dtype is None else 1e-5)
    assert torch.equal(got, mk.tiled_matmul(a, b, bs, gelu=gelu, out_dtype=out_dtype))


def test_tiled_matmul_refuses_what_the_kernel_does_not_take(dev):
    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk

    a = torch.randn(64, 64, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        mk.tiled_matmul(a.half(), a.half())
    with pytest.raises(ValueError, match="bfloat16"):
        mk.tiled_matmul(a, a)
    bf = a.to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        mk.tiled_matmul(bf[:, :60].contiguous(), bf[:60].contiguous())
    with pytest.raises(ValueError, match="float32"):
        mk.tiled_matmul(bf, bf, torch.zeros(64, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("rows,H,dtype", [(1030, 1024, torch.bfloat16),
                                          (2048, 2304, torch.float32),
                                          (7, 136, torch.bfloat16)])
def test_layer_norm_kernel_matches_plain_and_backward(dev, rows, H, dtype):
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk

    g = torch.Generator(device=dev).manual_seed(32)
    x = (torch.randn(rows, H, generator=g, device=dev) * 3 + 5).to(dtype)
    scale = torch.randn(H, generator=g, device=dev)
    bias = torch.randn(H, generator=g, device=dev)
    n = nk.layer_norm_fast.launches
    got = nk.layer_norm_fast(x, scale, bias, 1e-6)
    want = nk.layer_norm_fast_plain(x, scale, bias, 1e-6)
    assert nk.layer_norm_fast.launches == n + 1 and got.dtype == dtype
    _rows_close(got, want, BF16_STEP if dtype == torch.bfloat16 else 1e-5)
    # the backward through the Function (plain closed form) against autograd of the plain version
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    ref = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
    dy = torch.randn(rows, H, generator=g, device=dev).to(dtype)
    nk.layer_norm_fast(*leaves, 1e-6).backward(dy)
    nk.layer_norm_fast_plain(*ref, 1e-6).backward(dy)
    for a, b in zip(leaves, ref):
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4   # x's gradient is rounded to bf16
        assert float((a.grad.float() - b.grad.float()).abs().max()) <= \
            tol * float(b.grad.float().abs().max())


def test_layer_norm_refuses_f16_and_dispatches_by_the_variable(dev, monkeypatch):
    from vlm_bridge_tpu_torch.ops import layers
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk

    x = torch.randn(1024, 128, device=dev)
    ones, zeros = torch.ones(128, device=dev), torch.zeros(128, device=dev)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        nk.layer_norm_fast(x.half(), ones, zeros, 1e-6)
    n = nk.layer_norm_fast.launches
    monkeypatch.delenv("VLM_BRIDGE_LN_KERNEL", raising=False)
    base = layers.layer_norm(x, ones, zeros, 1e-6)
    assert nk.layer_norm_fast.launches == n
    monkeypatch.setenv("VLM_BRIDGE_LN_KERNEL", "1")
    fast = layers.layer_norm(x.reshape(4, 256, 128), ones, zeros, 1e-6)
    assert nk.layer_norm_fast.launches == n + 1
    assert float((fast.reshape(1024, 128) - base).abs().max()) <= 1e-5
    layers.layer_norm(x[:1023], ones, zeros, 1e-6)
    assert nk.layer_norm_fast.launches == n + 1


def _layer_case(dev, seed, H=256, F=512, NH=4, KH=2, D=64, L=3):
    from vlm_bridge_tpu_torch.configs import Gemma2Config
    from vlm_bridge_tpu_torch.models import gemma2

    cfg = Gemma2Config(vocab_size=512, hidden_size=H, intermediate_size=F, num_layers=L,
                       num_heads=NH, num_kv_heads=KH, head_dim=D, query_pre_attn_scalar=float(D),
                       sliding_window=128)
    g = torch.Generator(device=dev).manual_seed(seed)
    p = gemma2.init(cfg, generator=g, device=dev)
    for lp in p["layers"].values():   # norms away from their zero init
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lp[k] = (torch.randn(H, generator=g, device=dev) * 0.1).to(lp[k].dtype)
    return cfg, gemma2.quantize_params(p), g


@pytest.mark.parametrize("t", [0, 1, 37])
def test_fused_attn_step_kernel_matches_plain(dev, t):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    cfg, q, g = _layer_case(dev, 33)
    lp = q["layers"]["1"]
    B, KH, D, S = 5, cfg.num_kv_heads, cfg.head_dim, 64
    kc = torch.randint(-127, 128, (B, KH, S, D), generator=g, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, KH, S, D), generator=g, device=dev, dtype=torch.int8)
    ks = 0.02 + 0.01 * torch.rand(B, KH, S, generator=g, device=dev)
    vs = 0.02 + 0.01 * torch.rand(B, KH, S, generator=g, device=dev)
    # rows at and beyond t hold anything: they must not be read
    ks[:, :, t:] = float("nan")
    vs[:, :, t:] = float("inf")
    x = torch.randn(B, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), D))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=cfg.attn_scale,
              softcap=50.0, eps=1e-6)
    args = (t, x, lp["attn"]["qkv"], lp["attn"]["o"], lp["input_norm"],
            lp["post_attn_norm"], cos, sin, kc, vc, ks, vs)
    before = [c.clone() for c in (kc, vc)]
    n = dk.fused_attn_step.launches
    got = dk.fused_attn_step(*args, **kw)
    want = dk.fused_attn_step_plain(*args, **kw)
    assert dk.fused_attn_step.launches == n + 1
    assert torch.equal(kc, before[0]) and torch.equal(vc, before[1])   # the cache is only read
    assert bool(torch.isfinite(got[0].float()).all())
    _rows_close(got[0], want[0], 2 * BF16_STEP)
    for i in (1, 2):   # int8 codes: a value on a rounding boundary may land one code away
        assert got[i].shape == (B, KH * D) and got[i].dtype == torch.int8
        assert ((got[i].int() - want[i].int()).abs() <= 1).all()
        assert (got[i] == want[i]).float().mean() > 0.99
    for i in (3, 4):
        assert got[i].shape == (KH, B)
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=0)


def test_fused_mlp_step_kernel_matches_plain(dev):
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    cfg, q, g = _layer_case(dev, 34)
    lp = q["layers"]["2"]
    x = torch.randn(6, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)
    args = (x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"], lp["pre_ffn_norm"],
            lp["post_ffn_norm"])
    n = dk.fused_mlp_step.launches
    got = dk.fused_mlp_step(*args, eps=1e-6)
    assert dk.fused_mlp_step.launches == n + 1
    _rows_close(got, dk.fused_mlp_step_plain(*args, eps=1e-6), 2 * BF16_STEP)
    with pytest.raises(ValueError, match="bfloat16"):
        dk.fused_mlp_step(x.float(), *args[1:], eps=1e-6)
    with pytest.raises(ValueError, match="post_norm: expected torch.bfloat16"):
        dk.fused_mlp_step(x, *args[1:5], lp["post_ffn_norm"].float(), eps=1e-6)


def test_decode_step_fused_runs_the_kernels(dev):
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    cfg, q, g = _layer_case(dev, 35)
    B = 4
    ck, cp = (gemma2.FusedKVCache.zeros(cfg, B, 16, device=dev) for _ in range(2))
    assert ck.k[0].shape == (B, cfg.num_kv_heads, 64, cfg.head_dim) and ck.k[0].is_cuda
    for t in range(3):
        tok = torch.randn(B, 1, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)
        n = (dk.fused_attn_step.launches, dk.fused_mlp_step.launches)
        h_k, ck = gemma2.decode_step_fused(q, cfg, tok, ck, t)
        assert (dk.fused_attn_step.launches, dk.fused_mlp_step.launches) == \
            (n[0] + cfg.num_layers, n[1] + cfg.num_layers)
        real = (dk.fused_attn_step, dk.fused_mlp_step)
        dk.fused_attn_step, dk.fused_mlp_step = dk.fused_attn_step_plain, dk.fused_mlp_step_plain
        try:
            h_p, cp = gemma2.decode_step_fused(q, cfg, tok, cp, t)
        finally:
            dk.fused_attn_step, dk.fused_mlp_step = real
        _close(h_k, h_p)
    for i in range(cfg.num_layers):
        assert ((ck.k[i][:, :, :3].int() - cp.k[i][:, :, :3].int()).abs() <= 1).float().mean() > 0.99
        torch.testing.assert_close(ck.v_scale[i][:, :, :3], cp.v_scale[i][:, :, :3], rtol=2e-2,
                                   atol=0)
        assert (ck.k[i][:, :, 3:] == 0).all()


def test_vit_routes_through_the_kernels(dev, monkeypatch):
    from vlm_bridge_tpu_torch.configs import DinoV2Config
    from vlm_bridge_tpu_torch.models import dinov2
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk
    from vlm_bridge_tpu_torch.ops import quant

    cfg = DinoV2Config(hidden_size=256, num_layers=2, num_heads=4, image_size=224)
    assert cfg.head_dim == 64
    g = torch.Generator(device=dev).manual_seed(36)
    params = dinov2.init(cfg, generator=g, device=dev)
    px = torch.randn(5, 224, 224, 3, generator=g, device=dev).to(torch.bfloat16)
    monkeypatch.delenv("VLM_BRIDGE_VIT_MM", raising=False)
    monkeypatch.delenv("VLM_BRIDGE_LN_KERNEL", raising=False)
    counts = lambda: (mk.tiled_matmul.bias_launches, nk.layer_norm_fast.launches,  # noqa: E731
                      fa.flash_attention_fwd.launches, quant.int8_matmul.launches)
    n0 = counts()
    base = dinov2.forward(params, cfg, px)
    n1 = counts()
    assert tuple(b - a for a, b in zip(n0, n1)) == (0, 0, cfg.num_layers, 0)
    monkeypatch.setenv("VLM_BRIDGE_VIT_MM", "kernel")
    monkeypatch.setenv("VLM_BRIDGE_LN_KERNEL", "1")
    routed = dinov2.forward(params, cfg, px)
    n2 = counts()
    assert tuple(b - a for a, b in zip(n1, n2)) == (4 * cfg.num_layers, 2 * cfg.num_layers + 1,
                                                    cfg.num_layers, 0)
    _close(routed, base)
    quantized = dinov2.forward(dinov2.quantize_vision_params(params), cfg, px)
    n3 = counts()
    assert tuple(b - a for a, b in zip(n2, n3)) == (0, 2 * cfg.num_layers + 1, cfg.num_layers,
                                                    4 * cfg.num_layers)
    err = float((quantized.float() - base.float()).abs().max() / base.float().abs().max())
    assert err <= 0.1, err


# ---------------------------------------------------------------------------
# The int8 product kernel (csrc/int8_linear.cu: TMA + wgmma over the [in, out]
# weights) at odd shapes, and the fused steps at Gemma-2-27B's widths
# ---------------------------------------------------------------------------

# rows: one to two 64-row decode tiles (M <= 128, the contraction split over a
# cluster), then the tower's form (256-row tiles, 300: a ragged last one);
# widths: (K, N) of int8_matmul and (H, F) of int8_mlp / int8_ffn, off whole
# tiles (K % 64 != 0, N % 128 != 0) or whole
I8MM_M = [1, 3, 64, 65, 130, 300]
I8MM_WIDTHS = [((2312, 2320), (2320, 1040)), ((256, 1024), (256, 1024))]


@pytest.mark.parametrize("M", I8MM_M)
@pytest.mark.parametrize("mm,ffn", I8MM_WIDTHS, ids=["ragged", "whole"])
def test_int8_product_kernel_at_odd_shapes(dev, M, mm, ffn):
    """int8_matmul, int8_mlp and int8_ffn against their plain versions, row by
    row to I8_TOL, and the same bits on a second call (the slices of a split
    contraction are added in rank order)."""
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(80 + M)
    mk = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q = lambda i, o: quant.quantize_int8(mk(i, o) * 0.05, axis=0)  # noqa: E731
    (K, N), (H, F) = mm, ffn
    xm, xh = mk(M, K).to(torch.bfloat16), mk(M, H).to(torch.bfloat16)
    gate, up, down = q(H, F), q(H, F), q(F, H)
    runs = ((quant.int8_matmul, quant.int8_matmul_plain, (xm, q(K, N))),
            (quant.int8_mlp, quant.int8_mlp_plain, (xh, gate, up, down)),
            (quant.int8_ffn, quant.int8_ffn_plain, (xh, gate, mk(F) * 0.1, down, mk(H) * 0.1)))
    for fn, plain, args in runs:
        n = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        assert fn.launches == n + 1 and got.dtype == torch.bfloat16
        _rows_close(got, plain(*args), I8_TOL)
        assert torch.equal(got, fn(*args))


@pytest.mark.parametrize("B", [1, 3, 64, 65])
def test_fused_layer_steps_at_batch(dev, B):
    """fused_attn_step and fused_mlp_step, whose four products are the int8
    product kernel's, at batch 1 / 3 / 64 / 65 against their plain versions;
    the same bits on a second call."""
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    cfg, q, g = _layer_case(dev, 90 + B)
    lp = q["layers"]["0"]
    KH, D, S, t = cfg.num_kv_heads, cfg.head_dim, 64, 9
    kc = torch.randint(-127, 128, (B, KH, S, D), generator=g, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, KH, S, D), generator=g, device=dev, dtype=torch.int8)
    ks = 0.02 + 0.01 * torch.rand(B, KH, S, generator=g, device=dev)
    vs = 0.02 + 0.01 * torch.rand(B, KH, S, generator=g, device=dev)
    x = torch.randn(B, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), D))
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=cfg.attn_scale,
              softcap=50.0, eps=1e-6)
    args = (t, x, lp["attn"]["qkv"], lp["attn"]["o"], lp["input_norm"], lp["post_attn_norm"],
            cos, sin, kc, vc, ks, vs)
    got = dk.fused_attn_step(*args, **kw)
    _rows_close(got[0], dk.fused_attn_step_plain(*args, **kw)[0], 2 * BF16_STEP)
    assert all(torch.equal(a, b) for a, b in zip(got, dk.fused_attn_step(*args, **kw)))
    margs = (x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"], lp["pre_ffn_norm"],
             lp["post_ffn_norm"])
    got = dk.fused_mlp_step(*margs, eps=1e-6)
    _rows_close(got, dk.fused_mlp_step_plain(*margs, eps=1e-6), 2 * BF16_STEP)
    assert torch.equal(got, dk.fused_mlp_step(*margs, eps=1e-6))


def test_int8_product_kernel_runs_from_a_fresh_thread(dev):
    """The int8 linear functions and fused_mlp_step called first thing on a
    new thread give the main thread's bits."""
    import threading

    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops import quant

    c = _i8_case(dev, 64, 256, 1024, seed=95)
    cfg, q, g = _layer_case(dev, 96)
    lp = q["layers"]["1"]
    xl = torch.randn(64, cfg.hidden_size, generator=g, device=dev).to(torch.bfloat16)

    def run():
        out = [quant.int8_matmul(c["x"], c["gate"]),
               quant.int8_mlp(c["x"], c["gate"], c["up"], c["down"]),
               quant.int8_ffn(c["x"], c["gate"], c["b1"], c["down"], c["b2"]),
               dk.fused_mlp_step(xl, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"],
                                 lp["pre_ffn_norm"], lp["post_ffn_norm"], eps=1e-6)]
        torch.cuda.synchronize()
        return out

    got = []
    th = threading.Thread(target=lambda: got.append(run()))
    th.start()
    th.join()
    assert len(got) == 1, "the thread raised"
    assert all(torch.equal(a, b) for a, b in zip(got[0], run()))


def _gemma27(dev, seed, B):
    """Gemma-2-27B's and its bridge's widths (hidden 4608, F 36864, 32 / 16
    heads of 128, query_pre_attn_scalar 144; bridge cross heads of 576, self
    of 128, F 18432) at two layers, a 1000-row table and 17 vision tokens."""
    import dataclasses

    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.models import bridge, gemma2

    full = VLMConfig.gemma2_27b()
    lm = dataclasses.replace(full.lm, num_layers=2, vocab_size=1000)
    bc = dataclasses.replace(full.bridge, num_blocks=2)
    g = torch.Generator(device=dev).manual_seed(seed)
    lq = gemma2.quantize_params(gemma2.init(lm, generator=g, device=dev))
    for lp in lq["layers"].values():   # norms away from their zero init
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lp[k] = (torch.randn(lm.hidden_size, generator=g, device=dev) * 0.1).to(lp[k].dtype)
    bq = bridge.quantize_decode_params(bridge.init(bc, generator=g, device=dev))
    x = (torch.randn(B, lm.hidden_size, generator=g, device=dev) * 0.02
         * lm.hidden_size ** 0.5).to(torch.bfloat16)
    return lm, bc, lq, bq, g, x


@pytest.mark.parametrize("mlp4", [False, True], ids=["int8", "int4_g128"])
def test_stack_step_at_gemma2_27b_widths(dev, mlp4):
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm, _, lq, _, g, x = _gemma27(dev, 100 + mlp4, 64)
    assert gemma2.supports_fused_decode(lq, lm, 51)
    st = gemma2.stack_decode_params(lq, lm, mlp_int4=mlp4, mlp_int4_group=128 if mlp4 else None)
    caches = [gemma2.StackedKVCache.zeros(lm, 64, 51, device=dev) for _ in range(2)]
    t = 20
    for c in caches:
        gc = torch.Generator(device=dev).manual_seed(7)
        c.k[:, :, :, :t] = torch.randint(-127, 128, c.k[:, :, :, :t].shape, generator=gc,
                                         device=dev, dtype=torch.int8)
        c.k_scale[..., :t] = 0.02 + 0.01 * torch.rand(c.k_scale[..., :t].shape, generator=gc,
                                                      device=dev)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev),
                                                      lm.head_dim, lm.rope_theta))
    kw = dict(num_heads=lm.num_heads, num_kv_heads=lm.num_kv_heads, head_dim=lm.head_dim,
              attn_scale=lm.attn_scale, softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps)
    got = dk.fused_stack_step(t, x, st, *caches[0], cos, sin, **kw)
    want = dk.fused_stack_step_plain(t, x, st, *caches[1], cos, sin, **kw)
    _close(got, want)
    diff = (caches[0].k[:, :, :, t].int() - caches[1].k[:, :, :, t].int()).abs()
    assert (diff <= 1).float().mean() > 0.99


def test_bridge_step_at_gemma2_27b_widths(dev):
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    _, bc, _, bq, g, x = _gemma27(dev, 102, 64)
    bst = bridge.stack_bridge_decode_params(bq, bc)
    vision = torch.randn(64, 17, bc.vision_dim, generator=g, device=dev).to(torch.bfloat16)
    ck, cp = (_build_cross_cache(bq, bc, vision, 51, torch.bfloat16, kv_quant=True)
              for _ in range(2))
    kw = dict(num_heads_cross=bc.num_heads_cross, num_heads_self=bc.num_heads_self,
              eps=bc.layer_norm_eps)
    xb = (x.float() * 0.1).to(torch.bfloat16)
    got = dk.fused_bridge_step(3, xb, bst, *_bridge_args(ck), **kw)
    want = dk.fused_bridge_step_plain(3, xb, bst, *_bridge_args(cp), **kw)
    _close(got, want)
    _close(ck.self_k[:, :, :, 3], cp.self_k[:, :, :, 3])


def test_layer_steps_norm_and_head_at_gemma2_27b_widths(dev):
    """fused_attn_step, fused_mlp_step, layer_norm_fast (rows of 4608, the
    wide kernel) and the greedy head (H 4608) against their plain versions."""
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk
    from vlm_bridge_tpu_torch.ops import quant
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm, _, lq, _, g, x = _gemma27(dev, 103, 64)
    lp = lq["layers"]["1"]
    B, KH, D, S, t = 64, lm.num_kv_heads, lm.head_dim, 64, 20
    kc = torch.randint(-127, 128, (B, KH, S, D), generator=g, device=dev, dtype=torch.int8)
    vc = torch.randint(-127, 128, (B, KH, S, D), generator=g, device=dev, dtype=torch.int8)
    ks = 0.02 + 0.01 * torch.rand(B, KH, S, generator=g, device=dev)
    vs = 0.02 + 0.01 * torch.rand(B, KH, S, generator=g, device=dev)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), D,
                                                      lm.rope_theta))
    kw = dict(num_heads=lm.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=lm.attn_scale,
              softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps)
    args = (t, x, lp["attn"]["qkv"], lp["attn"]["o"], lp["input_norm"], lp["post_attn_norm"],
            cos, sin, kc, vc, ks, vs)
    _rows_close(dk.fused_attn_step(*args, **kw)[0], dk.fused_attn_step_plain(*args, **kw)[0],
                2 * BF16_STEP)
    margs = (x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"], lp["pre_ffn_norm"],
             lp["post_ffn_norm"])
    _rows_close(dk.fused_mlp_step(*margs, eps=lm.rms_norm_eps),
                dk.fused_mlp_step_plain(*margs, eps=lm.rms_norm_eps), 2 * BF16_STEP)
    rows = (torch.randn(1030, lm.hidden_size, generator=g, device=dev) * 3 + 5).to(torch.bfloat16)
    scale, bias = (torch.randn(lm.hidden_size, generator=g, device=dev) for _ in range(2))
    _rows_close(nk.layer_norm_fast(rows, scale, bias, 1e-6),
                nk.layer_norm_fast_plain(rows, scale, bias, 1e-6), BF16_STEP)
    table = lq["embedding"]
    _ids_match(quant.int8_matmul_t_argmax(x, table), quant.int8_matmul_t_argmax_plain(x, table),
               quant.int8_matmul_t_plain(x, table))


def _wide_tiny_config():
    """Tiny widths whose every attention has head dim 64, so the ViT, the
    bridge self-attention and Gemma-2 reach the flash kernels on the card."""
    from vlm_bridge_tpu_torch.configs import BridgeConfig, DinoV2Config, Gemma2Config, VLMConfig

    return VLMConfig(
        vision=DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, mlp_ratio=2,
                            patch_size=14, image_size=70),
        lm=Gemma2Config(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                        num_heads=2, num_kv_heads=1, head_dim=64, query_pre_attn_scalar=64.0,
                        sliding_window=128),
        # cross attention at head dim 32 takes the reference path, as the
        # default preset's (288) does
        bridge=BridgeConfig(vision_dim=128, language_dim=128, num_blocks=2, num_heads_cross=4,
                            num_heads_self=2, ffn_mult=2, dropout=0.0),
        image_size=70)


def test_orchestrator_tiny_run_reaches_the_flash_kernels(dev, tmp_path):
    """execute_full_training on the card (bf16 activations): the train steps
    launch all three flash kernels, validation and its sample captions launch
    the forward; the slots and the event file are written."""
    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.runtime.tb_writer import read_scalars
    from vlm_bridge_tpu_torch.tools.memorize import build_memorization_dataset
    from vlm_bridge_tpu_torch.training import orchestrator

    build_memorization_dataset(tmp_path / "data", train_repeats=2)
    tc = TrainingConfig(data_dir=str(tmp_path / "data"), batch_size=4, num_epochs=1,
                        max_steps_per_epoch=3, log_every_n_steps=1, num_validation_samples=2,
                        max_text_len=32, pad_to_buckets=(32,), num_workers=2,
                        checkpoint_dir=str(tmp_path / "ckpt"), log_dir=str(tmp_path / "logs"))
    cfg = _wide_tiny_config()
    tc.model_config = lambda: cfg
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    ctx = orchestrator.prepare_environment(tc, device="cuda")
    phases = {}

    def counting(name, fn):
        def run(*a, **kw):
            before = [c.launches for c in counted]
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            got = [c.launches - b for c, b in zip(counted, before)]
            phases[name] = [x + y for x, y in zip(phases.get(name, [0, 0, 0]), got)]
            return out
        return run

    ctx.train_step = counting("train", ctx.train_step)
    ctx.eval_step = counting("eval", ctx.eval_step)
    real_generate = orchestrator.generate_tokens
    orchestrator.generate_tokens = counting("samples", real_generate)
    try:
        res = orchestrator.execute_full_training(tc, ctx=ctx)
    finally:
        orchestrator.generate_tokens = real_generate
    per_step = [cfg.lm.num_layers * 2 + cfg.bridge.num_blocks + cfg.vision.num_layers,
                cfg.lm.num_layers + cfg.bridge.num_blocks, cfg.lm.num_layers + cfg.bridge.num_blocks]
    assert phases["train"] == [3 * n for n in per_step]
    assert phases["eval"][0] > 0 and phases["eval"][1:] == [0, 0]
    assert phases["samples"][0] > 0 and phases["samples"][1:] == [0, 0]
    assert res["epochs_run"] == 1 and ctx.state.step == 3
    for slot in ("latest", "best", "best_weights_only"):
        assert (tmp_path / "ckpt" / slot / "meta.json").exists()
    (events,) = list((tmp_path / "logs").glob("events.out.tfevents.*"))
    losses = [v for _, v in read_scalars(events)["train/loss"]]
    assert len(losses) == 3 and all(v == v for v in losses)


def test_exact_mode_on_f32_cuda_requests_the_reference_attention(dev):
    """f32 on the card: the flash kernels refuse it, so exact mode names
    `_attention_reference` itself (the encode included: its pixels are f32);
    the same f32 call without the request still raises, and nothing is
    launched."""
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.models import full_model
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.ops.attention import _attention_reference, dot_product_attention

    cfg = _wide_tiny_config()
    g = torch.Generator(device=dev).manual_seed(0)
    params = full_model.init(cfg, generator=g, frozen_dtype=torch.float32, device=dev)
    pixels = torch.randn(2, 70, 70, 3, generator=g, device=dev)
    before = fa.flash_attention_fwd.launches
    gen = GenerationConfig(max_length=4, greedy=True, exact=True)
    toks, lens = generate_tokens(params, cfg, pixel_values=pixels, gen=gen)
    vision = full_model.encode_image(params, cfg, pixels, reference_attention=True)
    again, _ = generate_tokens(params, cfg, vision_features=vision, gen=gen)
    assert toks.shape == (2, 5) and torch.equal(toks, again)
    assert fa.flash_attention_fwd.launches == before
    q = torch.randn(2, 5, 2, 64, generator=g, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        dot_product_attention(q, q, q)
    torch.testing.assert_close(dot_product_attention(q, q, q, reference=True),
                               _attention_reference(q, q, q, scale=64 ** -0.5),
                               rtol=0, atol=0)
    # the exact first token is the cached fast decode's (f32 per-layer path)
    fast, _ = generate_tokens(params, cfg, vision_features=vision, activation_dtype=torch.float32,
                              gen=GenerationConfig(max_length=1, greedy=True))
    assert fa.flash_attention_fwd.launches == before
    assert torch.equal(fast[:, 1], toks[:, 1])
