"""PyTorch port kernels on the card: each CUDA kernel against its plain
version at small widths (the decode steps, the greedy head, the three
flash-attention kernels with their autograd function and shape gate, and
the four int8 linear functions with `linear`'s dispatch).
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
    dq = fa.flash_attention_bwd_dq(q, k, v, kv, out_p, lse_p, do, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, kv, out_p, lse_p, do, **kw)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [n + 1 for n in before]
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
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, kv,
                               scale=0.125)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention_fwd(q, k, v, kv.long(), scale=0.125)


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


@pytest.mark.parametrize("M,V,H", [(5, 1000, 128), (64, 4096, 256), (70, 130, 64)])
def test_int8_matmul_t_kernel_matches_plain(dev, M, V, H):
    from vlm_bridge_tpu_torch.ops import quant

    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(M, H, generator=g, device=dev).to(torch.bfloat16)
    table = quant.quantize_int8(torch.randn(V, H, generator=g, device=dev) * 0.05, axis=1)
    n = quant.int8_matmul_t.launches
    got = quant.int8_matmul_t(x, table)
    torch.cuda.synchronize()
    assert quant.int8_matmul_t.launches == n + 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, V)
    _rows_close(got, quant.int8_matmul_t_plain(x, table), LOGIT_TOL)


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
