"""Run the PyTorch port once on one GPU: the int8 greedy caption-serving path
and the bridge train step, every kernel held against its plain version.

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the CUDA kernels from vlm_bridge_tpu_torch/csrc (one nvcc per
   source, sm_90a) and prints what ptxas reports for the flash kernels.
3. One phase per kernel: the kernel and its plain PyTorch version on the
   same seeded inputs at the main paths' shapes, their max abs error
   against the stated tolerance, both times, the least time the card could
   take (bytes over 3.35 TB/s or operations over the tensor-core peak,
   whichever is larger) and, where one PyTorch call computes the same
   function, that call's time. The three flash-attention kernels also run
   at the ViT shape, with a binding window and T != S, with an empty row,
   and with logits several times the soft-cap.
4. The serving path: VLMConfig.default() at full width, seeded random
   weights made on the device, --quantize embedding,mlp,attn,bridge with the
   int8 KV cache; 64 seeded uint8 images -> normalize_on_device ->
   generate_tokens (greedy, 50 tokens, no early stop). Checks that every
   decode kernel ran on every step, that the ids and lengths are well
   formed, and that each row's first token equals the plain path's.
5. The train path: the same model in bf16 with the f32 bridge, 8 seeded
   images x 256 tokens with ragged lengths, TrainingConfig() defaults. The
   first step's loss and bridge gradients through the kernels against the
   plain versions on the card (same dropout masks), one warm-up step, 5
   timed steps and one eval step. Checks finite losses, that the bridge
   moved, that no frozen tensor got a gradient, and that the three flash
   kernels were launched as often as the configuration implies.
6. Prints a JSON line of per-kernel results, then, as the last line,
   {"ok": true, "device": {...}}. Any failure raises (exit code != 0).
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import torch

SEED = 0
BATCH = 64
NEW_TOKENS = 50
HIDDEN_TOL = 3e-2  # x max|ref|: the bf16/int8 noise the JAX kernel tests allow
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 5
# Flash kernels against their plain versions, both on bf16 inputs: outputs
# are rounded to bf16 (2^-9 relative) and p / ds are rounded to bf16 at
# another scale (the kernel before the final normalisation, the plain
# version after the row's true maximum). Each row of D values is held to
# FLASH_TOL x its own max|ref| (a causal row late in the sequence is far
# smaller than the first): two bf16 steps of the row's largest value, where
# one step (2^-7) is what the cases show. Rows that are nothing but
# rounding noise (dq of a causal row that sees one key is exactly 0) are
# held to FLASH_FLOOR x the tensor's max|ref| instead. lse is f32 on both
# sides and differs by summation order, __expf and tanhf: 1.4e-6 measured.
FLASH_TOL, FLASH_FLOOR, LSE_TOL = 1.6e-2, 1e-2, 1e-5
# Whole step, kernels against plain versions with the same dropout masks:
# 28 attention calls whose bf16 roundings differ as above. Ten times what
# the step shows (1.9e-5, 1.95e-4, 1 - 0.999977).
LOSS_RTOL, GNORM_RTOL, GRAD_COS_MIN = 2e-4, 2e-3, 0.9998
HBM_BYTES_PER_S, BF16_FLOPS = 3.35e12, 989e12  # H100 SXM data sheet


def bound(bytes_moved: float, flops: float) -> dict:
    """The least time the card could take for this work, and what sets it."""
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown (nvidia-smi unavailable)"


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got.float() - want.float()).abs().max())
    tol = HIDDEN_TOL * float(want.float().abs().max())
    print(f"[{name}] max_abs_err={err:.6g} tol={tol:.6g}")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} above {tol}")
    return err


def phase_argmax_head(params, dev, gen):
    from vlm_bridge_tpu_torch.ops import quant

    E = params["lm"]["embedding"]
    V, H = E["w_int8"].shape
    x = (torch.randn(BATCH, H, generator=gen, device=dev)).to(torch.bfloat16)
    # planted tie: vocab rows 1000 and 200000 (different blocks) equal and,
    # aligned with row 5, the winners; row 7 all NaN -> id 0
    table = {"w_int8": E["w_int8"].clone(), "scale": E["scale"].clone()}
    row = (torch.sign(x[5].float()) * 127).to(torch.int8)
    for v in (1000, 200000):
        table["w_int8"][v] = row
        table["scale"][v] = 0.05
    x[7] = float("nan")
    got = quant.int8_matmul_t_argmax(x, table)
    want = quant.int8_matmul_t_argmax_plain(x, table)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    print(f"[int8_matmul_t_argmax] ids differing={mism} (tolerance 0); "
          f"tie row -> {int(got[5])}, NaN row -> {int(got[7])}")
    if mism or int(got[5]) != 1000 or int(got[7]) != 0:
        raise AssertionError("argmax head disagrees with its plain version")
    ms = time_ms(lambda: quant.int8_matmul_t_argmax(x, table), 20)
    plain_ms = time_ms(lambda: quant.int8_matmul_t_argmax_plain(x, table), 3)
    # table, scales and x read once, ids written; 2 M V H multiply-adds on bf16 tensor cores
    bd = bound(nbytes(table["w_int8"], table["scale"], x, got), 2.0 * BATCH * V * H)
    print(f"[int8_matmul_t_argmax] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    # no single PyTorch call computes an argmax over a dequantized product
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def phase_stack(params, cfg, dev, gen, t=20):
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm = cfg.lm
    stacked = params["lm"]["stacked_decode"]
    S = gemma2.fused_cache_rows(NEW_TOKENS + 1)
    cache = gemma2.StackedKVCache.zeros(lm, BATCH, NEW_TOKENS + 1, device=dev)
    # history rows 0..t-1: random int8 codes with realistic per-vector scales
    cache.k[:, :, :, :t] = torch.randint(-127, 128, cache.k[:, :, :, :t].shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    cache.v[:, :, :, :t] = torch.randint(-127, 128, cache.v[:, :, :, :t].shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    cache.k_scale[..., :t] = 0.02 + 0.01 * torch.rand(cache.k_scale[..., :t].shape,
                                                      generator=gen, device=dev)
    cache.v_scale[..., :t] = 0.02 + 0.01 * torch.rand(cache.v_scale[..., :t].shape,
                                                      generator=gen, device=dev)
    x = (torch.randn(BATCH, lm.hidden_size, generator=gen, device=dev) * 0.02
         * lm.hidden_size ** 0.5).to(torch.bfloat16)
    cos, sin = rope_table(torch.tensor([t], device=dev), lm.head_dim, lm.rope_theta)
    cos, sin = cos[0].contiguous(), sin[0].contiguous()
    kw = dict(num_heads=lm.num_heads, num_kv_heads=lm.num_kv_heads, head_dim=lm.head_dim,
              attn_scale=lm.attn_scale, softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps)
    ck = [c.clone() for c in cache]
    cp = [c.clone() for c in cache]
    got = dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw)
    want = dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw)
    torch.cuda.synchronize()
    err = check_close("fused_stack_step", got, want)
    codes = (ck[0][:, :, :, t].int() - cp[0][:, :, :, t].int()).abs()
    share = float((codes <= 1).float().mean())
    print(f"[fused_stack_step] new K codes within 1: {share:.6f} (need >= 0.99)")
    if share < 0.99:
        raise AssertionError("stack step K cache row disagrees")
    ms = time_ms(lambda: dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw), 10)
    plain_ms = time_ms(lambda: dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw), 3)
    # every stacked weight once, the t + 1 live cache rows, x in and out;
    # 2 flops per int8 weight and batch row (the attention's share is small)
    weights = [w for w in stacked.values()]
    live = sum(nbytes(c) for c in cache) * (t + 1) // S
    n_w = sum(stacked[k].numel() for k in ("wqkv", "wo", "wgu", "wd"))
    bd = bound(nbytes(*weights) + live + 2 * nbytes(x), 2.0 * BATCH * n_w)
    print(f"[fused_stack_step] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (S={S}, t={t}), "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def phase_bridge(params, cfg, dev, gen, t=20):
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    bc = cfg.bridge
    bp = params["bridge"]
    bst = bridge.stack_bridge_decode_params(bp, bc)
    vision = torch.randn(BATCH, cfg.num_vision_tokens, bc.vision_dim, generator=gen,
                         device=dev).to(torch.bfloat16)
    cache = _build_cross_cache(bp, bc, vision, NEW_TOKENS + 1, torch.bfloat16, kv_quant=True)
    cache.self_k[:, :, :, :t] = torch.randn(cache.self_k[:, :, :, :t].shape, generator=gen,
                                            device=dev).to(torch.bfloat16)
    cache.self_v[:, :, :, :t] = torch.randn(cache.self_v[:, :, :, :t].shape, generator=gen,
                                            device=dev).to(torch.bfloat16)
    x = (torch.randn(BATCH, bc.language_dim, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    kw = dict(num_heads_cross=bc.num_heads_cross, num_heads_self=bc.num_heads_self,
              eps=bc.layer_norm_eps)
    cross = (cache.cross_k, cache.cross_k_scale, cache.cross_v, cache.cross_v_scale)
    sk, sv = cache.self_k.clone(), cache.self_v.clone()
    pk, pv = cache.self_k.clone(), cache.self_v.clone()
    got = dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw)
    want = dk.fused_bridge_step_plain(t, x, bst, *cross, pk, pv, **kw)
    torch.cuda.synchronize()
    err = check_close("fused_bridge_step", got, want)
    check_close("fused_bridge_step self K row t", sk[:, :, :, t], pk[:, :, :, t])
    ms = time_ms(lambda: dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw), 10)
    plain_ms = time_ms(lambda: dk.fused_bridge_step_plain(t, x, bst, *cross, pk, pv, **kw), 3)
    # every stacked weight and the cross cache once, the t + 1 live self rows, x in and out
    live = nbytes(sk, sv) * (t + 1) // sk.shape[3]
    n_w = sum(bst[k].numel() for k in ("wq", "wo_c", "wqkv", "wo_s", "fc1", "fc2"))
    bd = bound(nbytes(*bst.values(), *cross) + live + 2 * nbytes(x), 2.0 * BATCH * n_w)
    print(f"[fused_bridge_step] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


class FlashCase(NamedTuple):
    name: str
    B: int
    T: int
    S: int
    H: int
    KH: int
    D: int
    causal: bool
    cap: Optional[float]
    window: Optional[int]
    lens: Optional[str]   # "ragged": lengths in [S/4, S] with one full row; "zero" also empties one
    q_mul: float = 1.0    # q is randn times this: logits have this standard deviation


FLASH_CASES = (
    FlashCase("gemma", 8, 256, 256, 8, 4, 256, True, 50.0, 4096, "ragged"),
    FlashCase("bridge_self", 8, 256, 256, 18, 18, 128, False, None, None, "ragged"),
    FlashCase("vit", 8, 257, 257, 16, 16, 64, False, None, None, None),
    FlashCase("window_t_ne_s", 8, 256, 512, 8, 4, 256, True, 50.0, 128, None),
    FlashCase("empty_row", 8, 256, 256, 8, 4, 256, True, 50.0, 4096, "zero"),
    # randn logits stay under a tenth of Gemma's cap, where tanh is the identity
    # to 0.3 %; here they reach three times the cap and 1 - tanh^2 spans 0.01 to 1
    FlashCase("softcap_binds", 8, 256, 256, 8, 4, 256, True, 2.0, 4096, "ragged", 2.0),
)
MAIN_PATH_CASES = ("gemma", "bridge_self")  # the shapes the train step gives the kernels


def flash_case_inputs(case, dev, gen):
    B, T, S, H, KH, D = case.B, case.T, case.S, case.H, case.KH, case.D

    def mk(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(torch.bfloat16)

    q, k, v, dout = mk(B, T, H, D, mul=case.q_mul), mk(B, S, KH, D), mk(B, S, KH, D), mk(B, T, H, D)
    if case.lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    else:
        lens = torch.randint(S // 4, S + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
        lens[0] = S
        if case.lens == "zero":
            lens[3] = 0
    return q, k, v, dout, lens


def attended_pairs(case, lens) -> int:
    """(query, key) pairs the mask lets through, summed over the batch."""
    kpos = torch.arange(case.S, device=lens.device)
    qpos = torch.arange(case.T, device=lens.device) + ((case.S - case.T) if case.causal else 0)
    m = (kpos[None, None, :] < lens[:, None, None]).expand(case.B, case.T, case.S)
    if case.causal:
        m = m & (kpos[None, :] <= qpos[:, None])
    if case.window is not None:
        m = m & (kpos[None, :] > qpos[:, None] - case.window)
    return int(m.sum())


def row_err(name, got, want, failures) -> float:
    """Max abs error of got against want [..., D], held row by row: a row's
    error against FLASH_TOL x the row's own max|ref| (not under FLASH_FLOOR x
    the tensor's). Misses are gathered in `failures`."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    ref = want.float().abs().amax(dim=-1)
    scale = torch.maximum(ref, FLASH_FLOOR * ref.max()).clamp_min(1e-30)
    err, worst = float(diff.max()), float((diff / scale).max())
    print(f"[{name}] max_abs_err={err:.6g} worst row error / row scale={worst:.6g} "
          f"(limit {FLASH_TOL})")
    if not worst <= FLASH_TOL:
        failures.append(f"{name}: row error {worst} x its scale, above {FLASH_TOL}")
    return err


def phase_flash(dev, gen):
    """The three flash kernels against their plain versions at every case;
    times, bounds and the library yardstick at the main path's two shapes
    and at the ViT shape."""
    import torch.nn.functional as F

    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    names = ("flash_attention_fwd", "flash_attention_bwd_dq", "flash_attention_bwd_dkv")
    res = {n: {"max_abs_err": 0.0, "by_shape": {}} for n in names}
    failures = []
    for case in FLASH_CASES:
        cname, B, T, S, H, KH, D = case[:7]
        cap = case.cap
        q, k, v, dout, lens = flash_case_inputs(case, dev, gen)
        kw = dict(scale=D ** -0.5, is_causal=case.causal, logit_softcap=cap,
                  sliding_window=case.window)
        out_p, lse_p = fa.flash_attention_plain(q, k, v, lens, **kw)
        dq_p, dk_p, dv_p = fa.flash_attention_bwd_plain(q, k, v, lens, out_p, lse_p, dout, **kw)
        out, lse = fa.flash_attention_fwd(q, k, v, lens, **kw)
        # the backward kernels get the plain forward's out and lse: each kernel
        # is held to its plain version on the same inputs
        dq = fa.flash_attention_bwd_dq(q, k, v, lens, out_p, lse_p, dout, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lens, out_p, lse_p, dout, **kw)
        torch.cuda.synchronize()
        tag = f"{cname} B{B} T{T} S{S} H{H} KH{KH} D{D}"
        errs = {
            names[0]: row_err(f"{names[0]} out, {tag}", out, out_p, failures),
            names[1]: row_err(f"{names[1]} dq, {tag}", dq, dq_p, failures),
            names[2]: max(row_err(f"{names[2]} dk, {tag}", dk, dk_p, failures),
                          row_err(f"{names[2]} dv, {tag}", dv, dv_p, failures)),
        }
        full = lse_p > -1e38
        lse_err = float((lse[full] - lse_p[full]).abs().max()) if bool(full.any()) else 0.0
        print(f"[{names[0]} lse, {tag}] max_abs_err={lse_err:.6g} (limit {LSE_TOL})")
        if not lse_err <= LSE_TOL:
            failures.append(f"{tag}: lse error {lse_err} above {LSE_TOL}")
        if not torch.equal(lse[~full], lse_p[~full]):
            failures.append(f"{tag}: rows with empty support disagree on lse")
        if case.lens == "zero":
            if any(float(x[3].float().abs().max()) != 0.0 for x in (out, dq, dk, dv)):
                failures.append(f"{tag}: the empty row's out, dq, dk and dv must be 0")
        if cap is not None:
            # how far this case's logits go into the cap (1 = the cap itself)
            reach = float((q.float().reshape(B, T, KH, H // KH, D).permute(0, 2, 3, 1, 4)
                           @ k.float().permute(0, 2, 3, 1)[:, :, None]).abs().max()
                          * kw["scale"] / cap)
            print(f"[{tag}] largest |logit| / soft-cap = {reach:.3f}")
            if case.name == "softcap_binds" and reach < 2.0:
                failures.append(f"{tag}: logits reach only {reach} x the cap")
        for n in names:
            res[n]["max_abs_err"] = max(res[n]["max_abs_err"], errs[n])

        library_ms = None
        if cap is None and cname in ("bridge_self", "vit"):
            # scaled_dot_product_attention computes the same function where there is
            # no soft-cap; a yardstick only, the port never calls it
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, scale=D ** -0.5)
            row_err(f"scaled_dot_product_attention vs plain, {tag}",
                    sdpa().transpose(1, 2), out_p, failures)
            library_ms = time_ms(sdpa, 20)
        if cname not in MAIN_PATH_CASES and library_ms is None:
            continue
        pairs = attended_pairs(case, lens)
        delta = fa._delta(out_p, dout)
        io_bwd = nbytes(q, k, v, dout, lse_p, delta, lens)
        runs = {
            names[0]: (lambda: fa.flash_attention_fwd(q, k, v, lens, **kw),
                       lambda: fa.flash_attention_plain(q, k, v, lens, **kw),
                       bound(nbytes(q, k, v, lens, out, lse), 4.0 * D * pairs * H), library_ms),
            names[1]: (lambda: fa.flash_attention_bwd_dq(q, k, v, lens, out_p, lse_p, dout,
                                                         delta=delta, **kw),
                       lambda: fa.flash_attention_bwd_plain(q, k, v, lens, out_p, lse_p, dout,
                                                            **kw),
                       bound(io_bwd + nbytes(dq), 6.0 * D * pairs * H), None),
            names[2]: (lambda: fa.flash_attention_bwd_dkv(q, k, v, lens, out_p, lse_p, dout,
                                                          delta=delta, **kw),
                       lambda: fa.flash_attention_bwd_plain(q, k, v, lens, out_p, lse_p, dout,
                                                            **kw),
                       bound(io_bwd + nbytes(dk, dv), 8.0 * D * pairs * H), None),
        }
        for n, (kernel, plain, bd, lib) in runs.items():
            ms, plain_ms = time_ms(kernel, 50), time_ms(plain, 5)
            print(f"[{n}] {cname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}")
            res[n]["by_shape"][cname] = {"ms": ms, "plain_ms": plain_ms, **bd, "library_ms": lib}
    if failures:
        raise AssertionError("flash kernels disagree with their plain versions:\n  "
                             + "\n  ".join(failures))
    for n in names:
        # the headline numbers are the Gemma shape's: 26 of the step's 28 attentions
        res[n].update(res[n]["by_shape"]["gemma"])
    return res


def expected_flash_launches(cfg, tc) -> dict:
    """Launches of one train step: each Gemma layer's forward runs twice
    under per-layer recomputation, each bridge block's self attention once;
    every attention has one dq and one dk/dv launch."""
    attn = cfg.lm.num_layers + cfg.bridge.num_blocks
    fwd = cfg.lm.num_layers * (2 if tc.remat_lm else 1) + cfg.bridge.num_blocks
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": attn,
            "flash_attention_bwd_dkv": attn}


def build_model(dev, gen):
    """VLMConfig.default() with seeded random weights made on the device:
    bf16 frozen towers, f32 bridge."""
    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.models import full_model

    cfg = VLMConfig.default()
    with torch.no_grad():
        params = full_model.init(cfg, generator=gen, device=dev)
    return cfg, params


def build_train_case(params, cfg, dev):
    """The train path's inputs and step functions: TrainingConfig() defaults,
    TRAIN_BATCH seeded uint8 images x TRAIN_SEQ ids with ragged lengths."""
    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.training import train_step as ts

    tc = TrainingConfig()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    lens = torch.randint(TRAIN_SEQ // 4, TRAIN_SEQ + 1, (TRAIN_BATCH,), generator=g, device=dev)
    lens[0] = TRAIN_SEQ
    batch = {
        "pixel_values": torch.randint(0, 256, (TRAIN_BATCH, cfg.image_size, cfg.image_size, 3),
                                      generator=g, device=dev, dtype=torch.uint8),
        "input_ids": torch.randint(3, cfg.lm.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                                   device=dev),
        "attn_mask": (torch.arange(TRAIN_SEQ, device=dev)[None, :] < lens[:, None]).int(),
    }
    steps_per_epoch = max(1, 41880 // TRAIN_BATCH)  # GroundCap's epoch; sets the schedule's horizon
    state, opt = ts.init_train_state(params, tc, steps_per_epoch)
    schedule = ts.make_schedule(tc, steps_per_epoch)
    return {"tc": tc, "batch": batch, "lens": lens, "frozen": ts.split_frozen(params),
            "state": state, "opt": opt,
            "train_step": ts.make_train_step(cfg, tc, opt, schedule),
            "eval_step": ts.make_eval_step(cfg, tc)}


@contextlib.contextmanager
def plain_flash(fa):
    """Within this block the flash module's three wrappers are its plain
    versions: the reference a whole step is compared with on the card."""
    saved = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    fa.flash_attention_fwd = fa.flash_attention_plain
    fa.flash_attention_bwd_dq = (
        lambda *a, delta=None, **kw: fa.flash_attention_bwd_plain(*a, **kw)[0])
    fa.flash_attention_bwd_dkv = (
        lambda *a, delta=None, **kw: fa.flash_attention_bwd_plain(*a, **kw)[1:])
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = saved


def run_train(params, cfg, dev, card):
    """The bridge train step at full width: kernels against plain versions on
    step 0, then a warm-up step, TRAIN_STEPS timed steps and one eval step.
    Returns the flash kernels' launch counts of one step."""
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.training import train_step as ts

    case = build_train_case(params, cfg, dev)
    tc, batch, lens, frozen, state = (case[k] for k in ("tc", "batch", "lens", "frozen", "state"))
    train_step, eval_step = case["train_step"], case["eval_step"]
    if (TRAIN_BATCH, cfg.bridge.dropout, tc.remat_lm, tc.loss_chunk_size, tc.gradient_clip_val,
            tc.scheduler_type) != (tc.batch_size, 0.1, True, 128, 0.3, "cosine"):
        raise AssertionError("the train path is meant to run the TrainingConfig() defaults")
    for head_dim in (cfg.lm.head_dim, cfg.bridge.language_dim // cfg.bridge.num_heads_self):
        if head_dim not in fa.HEAD_DIMS:
            raise AssertionError(f"the flash kernels are not built for head dim {head_dim}")
    leaves = ts.tree_leaves(state.bridge_params)
    start = [p.detach().clone() for p in leaves]
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    drop = torch.Generator(device=dev)

    # step 0 twice without an update: through the kernels, then through their
    # plain versions, the dropout generator reseeded so both see the same masks
    def grads_of(plain: bool):
        drop.manual_seed(SEED + 3)
        if plain:
            with plain_flash(fa):
                return ts.loss_and_grads(cfg, tc, frozen, state.bridge_params, batch, drop)
        return ts.loss_and_grads(cfg, tc, frozen, state.bridge_params, batch, drop)

    for fn in counters:
        fn.launches = 0
    loss_k, _, grads_k = grads_of(plain=False)
    torch.cuda.synchronize()
    if any(fn.launches == 0 for fn in counters):
        raise AssertionError("the kernel path of the step launched no flash kernel")
    before = [fn.launches for fn in counters]
    loss_p, _, grads_p = grads_of(plain=True)
    torch.cuda.synchronize()
    if [fn.launches for fn in counters] != before:
        raise AssertionError("the plain path of the step launched a flash kernel")
    flat_k = torch.cat([x.flatten() for x in grads_k]).double()
    flat_p = torch.cat([x.flatten() for x in grads_p]).double()
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    norm_err = abs(float(flat_k.norm()) - float(flat_p.norm())) / float(flat_p.norm())
    cos = float(torch.dot(flat_k, flat_p) / (flat_k.norm() * flat_p.norm()))
    print(f"[train step 0, kernels vs plain] loss {float(loss_k):.6f} vs {float(loss_p):.6f} "
          f"(rel {loss_err:.3g}, limit {LOSS_RTOL}); grad norm rel err {norm_err:.3g} "
          f"(limit {GNORM_RTOL}); cosine of the gradients {cos:.6f} (at least {GRAD_COS_MIN})")
    if not (loss_err <= LOSS_RTOL and norm_err <= GNORM_RTOL and cos >= GRAD_COS_MIN):
        raise AssertionError("the kernel path of the train step disagrees with the plain path")
    del grads_k, grads_p, flat_k, flat_p

    drop.manual_seed(SEED + 4)
    state, metrics = train_step(state, frozen, batch, drop)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rows = []
    launches = None
    for i in range(TRAIN_STEPS):
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        state, metrics = train_step(state, frozen, batch, drop)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = {fn.__name__: fn.launches for fn in counters}
        rows.append((float(metrics["loss"]), float(metrics["grad_norm_before_clip"]),
                     float(metrics["learning_rate"]), int(metrics["token_count"]), ms))
        print(f"[train] step {state.step - 1}: loss {rows[-1][0]:.4f} grad_norm {rows[-1][1]:.4f} "
              f"lr {rows[-1][2]:.6g} tokens {rows[-1][3]} {ms:.2f} ms "
              f"{TRAIN_BATCH / ms * 1e3:.2f} samples/s")
        want = expected_flash_launches(cfg, tc)
        if launches != want:
            raise AssertionError(f"flash launches of a step {launches}, expected {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    mean_ms = sum(r[4] for r in rows) / len(rows)
    print(f"train path: batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, {TRAIN_STEPS} steps, mean "
          f"{mean_ms:.2f} ms/step = {TRAIN_BATCH / mean_ms * 1e3:.2f} samples/s, peak memory "
          f"{peak:.2f} GiB, on {card}")
    print(f"train path launches per step: {launches}")
    if not all(math.isfinite(r[0]) and math.isfinite(r[1]) for r in rows):
        raise AssertionError("a training loss or gradient norm is not finite")
    expected_tokens = int((lens - 1).sum())
    if any(r[3] != expected_tokens for r in rows):
        raise AssertionError(f"token_count {rows[0][3]}, expected {expected_tokens}")
    moved = max(float((p.detach() - s0).abs().max()) for p, s0 in zip(leaves, start))
    print(f"[train] largest bridge parameter change after {state.step} steps: {moved:.3g}")
    if not moved > 0:
        raise AssertionError("the bridge parameters did not move")
    if any(p.grad is not None or p.requires_grad for p in ts.tree_leaves(frozen)):
        raise AssertionError("a frozen tensor requires or holds a gradient")

    ev = eval_step(frozen, state.bridge_params, batch)
    torch.cuda.synchronize()
    print(f"[eval] loss {float(ev['loss']):.4f} tokens {int(ev['token_count'])} "
          f"avg_sequence_length {float(ev['avg_sequence_length']):.2f}")
    if not math.isfinite(float(ev["loss"])) or int(ev["token_count"]) != expected_tokens:
        raise AssertionError("the eval step's loss or token count is off")
    # random weights: the loss sits near ln(vocab) with or without dropout
    if abs(float(ev["loss"]) - math.log(cfg.lm.vocab_size)) > 1.0:
        raise AssertionError(f"eval loss {float(ev['loss'])} far from ln(vocab)")
    return launches


def run_serve(params, cfg, dev, card, gcfg):
    """The int8 greedy serving path; returns the decode kernels' launch counts."""
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
    from vlm_bridge_tpu_torch.inference.generate import (
        GenerationConfig, _eos_lengths, generate_tokens)
    from vlm_bridge_tpu_torch.ops import decode_kernels, quant

    pix_gen = torch.Generator(device=dev)
    pix_gen.manual_seed(SEED + 1)
    pixels_u8 = torch.randint(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3),
                              generator=pix_gen, device=dev, dtype=torch.uint8)
    pixels = normalize_on_device(pixels_u8, dtype=torch.bfloat16)
    # warm-up (cuBLAS handles, allocator) on 2 tokens, then the counted run
    generate_tokens(params, cfg, pixel_values=pixels,
                    gen=GenerationConfig(max_length=2, greedy=True, kv_quant=True))
    torch.cuda.synchronize()
    counters = (decode_kernels.fused_stack_step, decode_kernels.fused_bridge_step,
                quant.int8_matmul_t_argmax)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    toks, lens = generate_tokens(params, cfg, pixel_values=pixels, gen=gcfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        if n != NEW_TOKENS:
            raise AssertionError(f"{name} launched {n} times, expected {NEW_TOKENS}")

    toks_c, lens_c = toks.cpu(), lens.cpu()
    if tuple(toks_c.shape) != (BATCH, NEW_TOKENS + 1):
        raise AssertionError(f"tokens shape {tuple(toks_c.shape)}")
    if not ((toks_c >= 0) & (toks_c < cfg.lm.vocab_size)).all():
        raise AssertionError("token ids out of range")
    if not (toks_c[:, 0] == cfg.lm.bos_token_id).all():
        raise AssertionError("first column is not BOS")
    if not torch.equal(lens_c, _eos_lengths(toks_c, cfg.lm.eos_token_id)):
        raise AssertionError("lengths disagree with the first EOS")
    print(f"main path: {BATCH} captions x {NEW_TOKENS} tokens in {dt:.3f} s = "
          f"{BATCH / dt:.2f} captions/s (encode + decode) on {card}")

    t0 = time.perf_counter()
    ref, _ = generate_tokens(params, cfg, pixel_values=pixels,
                             gen=GenerationConfig(max_length=NEW_TOKENS, greedy=True,
                                                  kv_quant=True, force_plain=True))
    torch.cuda.synchronize()
    ref = ref.cpu()
    first_eq = bool((ref[:, 1] == toks_c[:, 1]).all())
    share = float((ref[:, 1:] == toks_c[:, 1:]).float().mean())
    print(f"plain path: {BATCH / (time.perf_counter() - t0):.2f} captions/s; first tokens "
          f"equal in every row: {first_eq}; share of all tokens equal: {share:.4f}")
    if not first_eq:
        raise AssertionError("first generated tokens differ from the plain path")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card (name, power limit): {card}", flush=True)

    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig
    from vlm_bridge_tpu_torch.models import bridge, gemma2
    from vlm_bridge_tpu_torch.ops import cuda_lib
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain references run full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if cuda_lib.build_seconds is not None else 'not needed'})", flush=True)
    log = cuda_lib.build_log.splitlines()
    for i, line in enumerate(log):  # ptxas -v: registers, shared memory and spills per kernel
        if "Compiling entry function" in line and "fa_" in line:
            mangled = line.split("'")[1]   # ...fa_fwd_kernelILi256ELi64EEvNS_8FaParamsE
            name = mangled[mangled.index("fa_"):].split("Ev")[0]
            print(f"ptxas: {name} |",
                  " ".join(x.strip() for x in log[i + 1:i + 4] if "bytes" in x or "registers" in x))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    results, launches = {}, {}

    t0 = time.perf_counter()
    cfg, params = build_model(dev, gen)
    torch.cuda.synchronize()
    print(f"init: {time.perf_counter() - t0:.1f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    # the int8 serving recipe, quantized from the same weights
    t0 = time.perf_counter()
    with torch.no_grad():
        served = dict(params)
        served["lm"] = gemma2.quantize_params(params["lm"], ("embedding", "mlp", "attn"))
        served["bridge"] = bridge.quantize_decode_params(params["bridge"])
    gcfg = GenerationConfig(max_length=NEW_TOKENS, greedy=True, kv_quant=True, early_stop=False)
    served = prestack_decode_params(served, cfg, gcfg)
    if "stacked_decode" not in served["lm"]:
        raise AssertionError("the int8 stack decode does not serve VLMConfig.default()")
    torch.cuda.synchronize()
    print(f"quantize + stack: {time.perf_counter() - t0:.1f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    with torch.no_grad():
        results["int8_matmul_t_argmax"] = phase_argmax_head(served, dev, gen)
        results["fused_stack_step"] = phase_stack(served, cfg, dev, gen)
        results["fused_bridge_step"] = phase_bridge(served, cfg, dev, gen)
        launches.update(run_serve(served, cfg, dev, card, gcfg))
    del served
    torch.cuda.empty_cache()

    flash_gen = torch.Generator(device=dev)
    flash_gen.manual_seed(SEED + 5)
    with torch.no_grad():
        results.update(phase_flash(dev, flash_gen))
    launches.update(run_train(params, cfg, dev, card))

    fa_src, fa_py = "flash_attention.cu", "vlm_bridge_tpu/ops/flash_attention.py"
    sources = {"int8_matmul_t_argmax": ("int8_argmax.cu", "vlm_bridge_tpu/ops/quant.py:169"),
               "fused_stack_step": ("stack_step.cu", "vlm_bridge_tpu/ops/decode_kernels.py:707"),
               "fused_bridge_step": ("bridge_step.cu",
                                     "vlm_bridge_tpu/ops/decode_kernels.py:1228"),
               "flash_attention_fwd": (fa_src, f"{fa_py}:194"),
               "flash_attention_bwd_dq": (fa_src, f"{fa_py}:358"),
               "flash_attention_bwd_dkv": (fa_src, f"{fa_py}:382")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"vlm_bridge_tpu_torch/csrc/{src}", "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
