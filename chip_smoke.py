"""Run the PyTorch port once on one GPU: the int8 greedy caption-serving path,
the kernel-routed vision encode and the int8 vision tower, the sampled
per-layer int8 decode path, the per-layer fused decode, the int4 serving
recipe through the batched eval harness and the bridge train step, every
kernel held against its plain version.

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the CUDA kernels from vlm_bridge_tpu_torch/csrc (one nvcc per
   source, sm_90a) and prints what ptxas reports (registers, spills) for the
   flash kernels, the int8 product kernels and the wgmma kernels
   (tiled_matmul's, the flash forward's, dq's and dk/dv's three
   instantiations each, D 64 / 128 / 256, the fused decode steps' GEMM
   core's three: int8, int4, int4 with groups of an odd multiple of 32 rows,
   and the tied heads' six: int8, int4 per row, int4 in groups, each with the
   greedy heads' argmax and the sampled heads' logits epilogue); fails if
   ptxas serialised a wgmma pipeline, if a wgmma kernel spills, or if an
   instantiation is missing. The fused steps and the four heads print their
   time beside their earlier mma.sync / wmma kernels' on the same card
   (DECODE_STEP_MMA_SYNC_MS, HEAD_MMA_SYNC_MS).
3. One phase per kernel: the kernel and its plain PyTorch version on the
   same seeded inputs at the main paths' shapes, their max abs error
   against the stated tolerance, both times (device time: the host queues
   the runs behind a spin kernel), the least time the card could take (bytes
   over 3.35 TB/s or operations over the tensor-core peak, whichever is
   larger) and, where one PyTorch call computes the same function, that
   call's time. The int8 linear kernels walk through the layers' weights,
   call after call, so that none finds its weights in the L2. The three
   flash-attention kernels also run at the ViT shape (B 8, and the encode's
   own B 64 with q, k and v column views of one fused projection), with a
   binding window and T != S, with an empty row, with logits several times
   the soft-cap, and with GQA, T != S and a tail tile past T; the forward's
   yardstick is scaled_dot_product_attention without a mask where the case
   has no lengths, and the backward kernels' is SDPA's backward at the
   bridge-self shape (the pair's time includes the dq kernel's delta). The
   backward kernels get q, k, v and dout as the case gives them, and two calls
   of each must give the same bits.
4. The serving path: VLMConfig.default() at full width, seeded random
   weights made on the device, --quantize embedding,mlp,attn,bridge with the
   int8 KV cache; 64 seeded uint8 images -> normalize_on_device ->
   generate_tokens (greedy, 50 tokens, no early stop). Checks that every
   decode kernel ran on every step, that the ids and lengths are well
   formed, and that the first generated token of every row equals the plain
   path's (every decode kernel's plain version behind the same encoder).
   Then the same fused stack with the sampled head, 50 tokens, timed.
4a. The vision encode's kernels: `tiled_matmul` at the ViT's four projection
   shapes (16448 rows; with bias, fc1 with GELU; one without a bias; TFLOP/s
   beside its earlier mma.sync form's and the library call's; the kernel's
   ragged edges: rows, columns and depth beyond a tile, f32 out) and
   `layer_norm_fast` (16448 x 1024 bf16, 2048 x 2304 f32)
   against their plain versions and torch.addmm / F.layer_norm; the
   projection probe (all 24 layers' four projections, bias-free, kernel
   against torch.matmul; one counted pass: 96 launches). Then dinov2.forward
   on the 64 images: default routing, `_attention_reference` swapped in for
   the flash kernel, and both VLM_BRIDGE_VIT_MM=kernel and
   VLM_BRIDGE_LN_KERNEL=1 (launches 96 / 49 / 24); the serving batch again
   with the plain attention in the ViT and with both variables set, each
   against the default routing's (two correct bf16 encoders: the first step's
   logits are held, and a row's first token may differ only where the top two
   logits are a near-tie); the int8 vision tower (quantize_vision_params: 96
   int8_matmul launches at M = 16448).
4b. The sampled per-layer path: the same int8 weights as per-layer dicts (not
   stacked), bf16 KV cache, temperature 0.7, top-p 0.9, a seeded CUDA
   generator, 64 x 50 tokens. Checks the four int8 kernels' launch counts
   (60 / 26 / 2 / 1 a token), that the fused path's kernels stay idle, that a
   second run with the same seed repeats token for token, and, greedy over a
   few tokens, that the first step's logits agree with the plain path's
   (both paths round to bf16 between ops, so a near-tie may flip a row's
   token: it prints how many rows agree); a short profiled window gives the
   launches per token and the device's busy share.
4b'. The per-layer fused decode: `fused_attn_step` (t = 0, and t = 20 with
   planted large logits) and `fused_mlp_step` against their plain versions,
   each timed call on another layer's weights; then 50 greedy tokens at
   batch 64 through fused_bridge_step -> gemma2.decode_step_fused ->
   int8_matmul_t_argmax (launches 1300 / 1300), the first tokens against the
   same loop on the plain versions, ms a token beside the stack step's.
4b''. One fused token step at VLMConfig.gemma2_27b()'s widths, two decoder
   layers: fused_bridge_step -> the stack step -> the greedy head over the
   256000-row table, against the plain versions (rows within HIDDEN_TOL,
   greedy ids equal but for near-ties of the plain logits).
4c. The int4 recipe: the table re-quantized to the int4 rows-packed layout
   and the stack rebuilt with int4 MLP weights. Phases for the two int4
   heads, `int4_mlp` (per channel and in groups of 128) and the stack step
   with int4 MLP weights against their plain versions; the int4-against-int8
   MLP probe (26 layers x 20 tokens, the three variants in turns); then
   `vlm-eval-torch` itself (inference.evaluate.main) over a synthetic split
   written with numpy alone (a manifest and the pixel cache's two files, so
   no image is decoded), --quantize embedding4,mlp,attn,bridge --kv-int8
   --mlp-int4 --no-early-stop, batch 64 x 50 tokens, 5 batches, and once
   more with --sample over 2 batches. Checks the launch counts (stack step
   and int4 head 50 a batch, the int8 heads 0), that BLEU / CIDEr are
   finite, and that one batch's first tokens equal the plain path's.
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
import dataclasses
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple, Optional, Tuple, Union

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
# The int8 linear kernels against their plain versions on the same bf16 x:
# both accumulate in f32 and round the result (int8_mlp / int8_ffn also the
# hidden) to bf16, in another summation order, so a value may land one bf16
# step away. Each output row is held to I8_TOL = one bf16 step (2^-7) of its
# own max|ref|. int8_matmul_t writes f32 logits with no rounding: LOGIT_TOL x
# the row's max|ref| covers the summation order.
I8_TOL, LOGIT_TOL = 2.0 ** -7, 1e-5
# The int4 heads add each scale group's partial sum times its f32 scale (18
# folds a logit at H = 2304) where the plain version multiplies by weights
# dequantized in f32: a few more f32 roundings a logit than the int8 head.
LOGIT4_TOL = 2e-5
EVAL_BATCHES, EVAL_SAMPLED_BATCHES = 5, 2   # batches of the int4 path through vlm-eval-torch
PROBE_TOKENS, PROBE_REPS, PROBE_BLOCK_F, INT4_GROUP = 20, 3, 512, 128
GREEDY_CHECK_TOKENS, PROFILE_TOKENS = 6, 5
# The per-layer fused steps against their plain versions: both round h, q,
# p * v_scale, the attention output and the MLP hidden to bf16 at the same
# places, over f32 sums taken in another order, so a few of those values land
# one bf16 step away and the output row, itself rounded to bf16, moves by up
# to two steps of its largest value. New K / V codes: equal up to 1, and
# equal outright in at least CODES_EQUAL_MIN of them; scales to SCALE_RTOL.
LAYER_TOL, CODES_EQUAL_MIN, SCALE_RTOL = 2.0 ** -6, 0.99, 1e-6
# Two encoders that differ in where bf16 roundings fall (kernel-routed against
# default, flash against plain attention): features within FEATURE_TOL x their
# largest value. The int8 tower against the float one: int8 noise of 96
# projections, INT8_TOWER_TOL.
FEATURE_TOL, INT8_TOWER_TOL = 3e-2, 2.5e-1
ENCODE_REPS = 3
# tiled_matmul's earlier (mma.sync) form on the same card, PERF.md rows 8 and 9: each
# projection with its bias at 16448 rows, o without one, and the projection probe
TILED_MATMUL_MMA_SYNC_MS = {"qkv": 0.4026, "o": 0.1449, "fc1": 0.5610, "fc2": 0.4733,
                            "o without bias": 0.1408, "probe": 37.753}
# the fused decode steps before their GEMM core moved to wgmma + TMA (the
# mma.sync kernels), on the same card, PERF.md rows 5, 5' and 7
DECODE_STEP_MMA_SYNC_MS = {"fused_stack_step": 4.1980, "fused_stack_step[mlp_int4]": 4.3400,
                           "fused_bridge_step": 0.5808}
# the heads' earlier (wmma / mma.sync tile) kernels on the same card, PERF.md rows
# 12-15 (int4 in groups of 128)
HEAD_MMA_SYNC_MS = {"int8_matmul_t_argmax": 0.6438, "int4_matmul_t_argmax": 0.5884,
                    "int8_matmul_t": 0.6303, "int4_matmul_t": 0.5704}
# the int8 linear kernels' earlier (cp.async + mma.sync, split-K through device
# memory) product on the same card, PERF.md rows 4, 6, 11, 16 and 17
I8_MMA_SYNC_MS = {"gemma_qkv": 0.0155, "gemma_o": 0.0126, "bridge_self_qkv": 0.0193,
                  "int8_mlp": 0.0749, "int8_ffn": 0.0477, "fused_attn_step": 0.0556,
                  "fused_mlp_step": 0.0891, "qkv": 0.5277, "o": 0.1884, "fc1": 0.7004,
                  "fc2": 0.5966}
# int4_mlp's earlier (cp.async + mma.sync, split-K through device memory and a
# second epilogue kernel) form on the same card, PERF.md row 18
INT4_MLP_MMA_SYNC_MS = {"per_channel": 0.0728, f"group{INT4_GROUP}": 0.0925}
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


PTXAS_TAGS = ("fa_", "i8mm_kernel", "decode_gemm_kernel", "tied_head_kernel",
              "tiled_matmul_kernel", "layer_norm_kernel", "layer_norm_wide", "ls_attn_kernel")


# the wgmma kernels: each instantiation must not spill
SPILL_CHECKED = ("tiled_matmul_kernel", "fa_fwd_sm90_kernel", "fa_bwd_dq_sm90_kernel",
                 "fa_bwd_dkv_sm90_kernel", "decode_gemm_kernel", "tied_head_kernel",
                 "i8mm_kernel")
FLASH_INSTANCES = tuple(f"{k}ILi{d}E" for k in SPILL_CHECKED[1:4] for d in (64, 128, 256))
# the fused steps' GEMM core (csrc/decode_gemm.cuh): int8, and int4 with waits
# every stage or every half stage (groups of an odd multiple of 32 rows)
GEMM_INSTANCES = ("decode_gemm_kernelILb0ELi4E", "decode_gemm_kernelILb1ELi4E",
                  "decode_gemm_kernelILb1ELi2E")
# the tied heads (csrc/tied_head.cu): int8, int4 per row, int4 in groups, each
# greedy (argmax) and sampled (logits)
HEAD_INSTANCES = tuple(f"tied_head_kernelILb{i4}ELb{gr}ELb{lg}E"
                       for i4, gr in ((0, 0), (1, 0), (1, 1)) for lg in (0, 1))
# the int8 product kernel (csrc/int8_linear.cu): the decode form (one consumer
# warpgroup, 64 rows) and the tower's (two warpgroups of 128 rows); its int4
# path (int4_mlp), per channel and in groups, with the GeGLU and the scale
# epilogue
I8MM_INSTANCES = ("i8mm_kernelILi1ELi1E", "i8mm_kernelILi2ELi2E") + tuple(
    f"i8mm_kernelILi1ELi1ELi{epi}ELb1ELb{gr}E" for gr in (0, 1) for epi in (1, 2))
REQUIRED = FLASH_INSTANCES + GEMM_INSTANCES + HEAD_INSTANCES + I8MM_INSTANCES


def ptxas_report(build_log: str, tags=PTXAS_TAGS) -> list:
    """Print what ptxas -v said of the kernels named by `tags` (registers,
    shared memory, spills). Raise if ptxas serialised a kernel's wgmma
    instructions (tiled_matmul_kernel, the three flash kernels, the decode
    GEMM core and the tied heads are the wgmma kernels: a serialised
    pipeline runs them at a fraction of their rate and still agrees with the
    plain version), or if the build lacks one of REQUIRED: the three
    instantiations (D 64 / 128 / 256) of the flash forward, dq and dk/dv, the
    GEMM core's three and the tied heads' six. Returns the instantiations
    of the wgmma kernels that spill."""
    log = build_log.splitlines()
    serial = [x.strip() for x in log if "wgmma" in x and "serialized" in x]
    if serial:
        raise AssertionError("ptxas serialised wgmma:\n" + "\n".join(serial))
    spills, seen = [], []
    for i, line in enumerate(log):
        tag = next((t for t in tags if t in line), None)
        if "Compiling entry function" in line and tag:
            mangled = line.split("'")[1]   # ...fa_fwd_sm90_kernelILi256EEEv14CUtensorMap_st...
            name = mangled[mangled.index(tag):].split("Ev")[0].split("EPK")[0]
            info = [x.strip() for x in log[i + 1:i + 4] if "bytes" in x or "registers" in x]
            print(f"ptxas: {name} |", " ".join(info))
            seen.append(name)
            if any(k in name for k in SPILL_CHECKED) and any(
                    int(n) for x in info for n in re.findall(r"(\d+) bytes spill", x)):
                spills.append(name)
    missing = [k for k in REQUIRED if not any(k in n for n in seen)]
    if missing:
        raise AssertionError(f"ptxas reported no {missing}: a wgmma kernel is not built")
    return spills


def time_ms(fn, iters: int, spin_cycles: int = 20_000_000) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up. The
    device first spins for some 10 ms (spin_cycles), so the host has queued
    the runs by the time they start: the events then bracket device work, not
    the host's issuing (a wrapper of a 10 us kernel takes longer to call than
    the kernel to run)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(spin_cycles)
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
    print(f"[int8_matmul_t_argmax] kernel {ms:.4f} ms (the wmma tile kernel: "
          f"{HEAD_MMA_SYNC_MS['int8_matmul_t_argmax']}), plain {plain_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    # no single PyTorch call computes an argmax over a dequantized product
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def phase_stack(params, cfg, dev, gen, t=20, name="fused_stack_step"):
    """The stack step against its plain version, on int8 or int4 MLP weights
    (whichever `params` carries stacked)."""
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
    err = check_close(name, got, want)
    codes = (ck[0][:, :, :, t].int() - cp[0][:, :, :, t].int()).abs()
    share = float((codes <= 1).float().mean())
    print(f"[{name}] new K codes within 1: {share:.6f} (need >= 0.99)")
    if share < 0.99:
        raise AssertionError("stack step K cache row disagrees")
    ms = time_ms(lambda: dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw), 10)
    plain_ms = time_ms(lambda: dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw), 3)
    # every stacked weight once, the t + 1 live cache rows, x in and out;
    # 2 flops per weight and batch row (the attention's share is small); a
    # byte of an int4 field holds two weights
    weights = [w for w in stacked.values()]
    live = sum(nbytes(c) for c in cache) * (t + 1) // S
    n_w = sum(stacked[k].numel() * (2 if k.endswith("4") else 1)
              for k in ("wqkv", "wo", "wgu", "wd", "wgu4", "wd4") if k in stacked)
    bd = bound(nbytes(*weights) + live + 2 * nbytes(x), 2.0 * BATCH * n_w)
    print(f"[{name}] kernel {ms:.4f} ms (mma.sync core: {DECODE_STEP_MMA_SYNC_MS[name]:.4f}), "
          f"plain {plain_ms:.4f} ms (S={S}, t={t}), bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']}")
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
    print(f"[fused_bridge_step] kernel {ms:.4f} ms (mma.sync core: "
          f"{DECODE_STEP_MMA_SYNC_MS['fused_bridge_step']:.4f}), plain {plain_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None}


def rows_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> float:
    """Max abs error; every row held to tol x its own max|ref|."""
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1).clamp_min(1e-30)
    err, worst = float(diff.max()), float((diff / scale).max())
    print(f"[{name}] max_abs_err={err:.6g} worst row error / row max={worst:.6g} (limit {tol:.3g})")
    if not worst <= tol:
        raise AssertionError(f"{name}: row error {worst} x the row's max, above {tol}")
    return err


def same_bits(name: str, got: torch.Tensor, again: torch.Tensor) -> None:
    """A second call of a kernel whose sums run in one fixed order gives the same bits."""
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{name}: a second call gave other bits")
    print(f"[{name}] a second call: the same bits")


def cycle(items):
    """A closure's next argument set, round robin: successive timed calls read
    other layers' weights, as the decode loop does, so none finds its weights
    in the 50 MB L2."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % len(items)
        return items[state["i"]]

    return nxt


def phase_int8_linear(params, cfg, dev, gen):
    """int8_matmul, int8_mlp and int8_ffn at the shapes the per-layer decode
    gives them (M = BATCH rows of bf16), on the model's own weights."""
    from vlm_bridge_tpu_torch.ops import quant

    layers = [params["lm"]["layers"][str(i)] for i in range(cfg.lm.num_layers)]
    blocks = [params["bridge"]["blocks"][str(b)] for b in range(cfg.bridge.num_blocks)]

    def x_of(width, mul=1.0):
        return (torch.randn(BATCH, width, generator=gen, device=dev) * mul).to(torch.bfloat16)

    def wbytes(*qs):
        return sum(nbytes(q["w_int8"], q["scale"]) for q in qs)

    def n_w(*qs):
        return sum(q["w_int8"].numel() for q in qs)

    res = {}
    # ---- int8_matmul: Gemma's fused qkv and o, the bridge's fused self qkv
    mm_shapes = {"gemma_qkv": [lp["attn"]["qkv"] for lp in layers],
                 "gemma_o": [lp["attn"]["o"] for lp in layers],
                 "bridge_self_qkv": [bp["self"]["qkv"] for bp in blocks]}
    by_shape, worst = {}, 0.0
    for sname, ws in mm_shapes.items():
        I, O = ws[0]["w_int8"].shape
        x = x_of(I)
        got, want = quant.int8_matmul(x, ws[0]), quant.int8_matmul_plain(x, ws[0])
        torch.cuda.synchronize()
        worst = max(worst, rows_close(f"int8_matmul {sname} {I}x{O}", got, want, I8_TOL))
        nxt = cycle(ws)
        ms = time_ms(lambda: quant.int8_matmul(x, nxt()), 52)
        plain_ms = time_ms(lambda: quant.int8_matmul_plain(x, nxt()), 4)
        wd = (ws[0]["w_int8"].float() * ws[0]["scale"]).to(torch.bfloat16)
        deq_ms = time_ms(lambda: torch.matmul(x, wd), 50)
        del wd
        bd = bound(wbytes(ws[0]) + nbytes(x, got), 2.0 * BATCH * n_w(ws[0]))
        split = quant._split(BATCH, O, I, False, dev)
        print(f"[int8_matmul] {sname} {I}x{O}: kernel {ms:.4f} ms (the mma.sync kernel: "
              f"{I8_MMA_SYNC_MS[sname]}; contraction in {split} slices), plain {plain_ms:.4f} ms, "
              f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; torch.matmul on a "
              f"bf16 copy made beforehand {deq_ms:.4f} ms (not the same function)")
        by_shape[sname] = {"ms": ms, "plain_ms": plain_ms, **bd, "dequantized_matmul_ms": deq_ms}
    # the headline numbers are the fused qkv's: 26 of a token's 60 calls
    res["int8_matmul"] = {"max_abs_err": worst, **{k: by_shape["gemma_qkv"][k] for k in
                                                   ("ms", "plain_ms", "bound_ms", "bound_by")},
                          "library_ms": None, "by_shape": by_shape}

    # ---- int8_mlp: Gemma's GeGLU MLP
    mlps = [(lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"]) for lp in layers]
    x = x_of(cfg.lm.hidden_size)
    got, want = quant.int8_mlp(x, *mlps[0]), quant.int8_mlp_plain(x, *mlps[0])
    torch.cuda.synchronize()
    err = rows_close("int8_mlp", got, want, I8_TOL)
    nxt = cycle(mlps)
    ms = time_ms(lambda: quant.int8_mlp(x, *nxt()), 52)
    plain_ms = time_ms(lambda: quant.int8_mlp_plain(x, *nxt()), 4)
    bd = bound(wbytes(*mlps[0]) + nbytes(x, got), 2.0 * BATCH * n_w(*mlps[0]))
    print(f"[int8_mlp] kernel {ms:.4f} ms (the mma.sync kernel: {I8_MMA_SYNC_MS['int8_mlp']}), "
          f"plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    res["int8_mlp"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                       "library_ms": None}

    # ---- int8_ffn: the bridge's biased FFN
    ffns = [(bp["ffn"]["fc1"], bp["ffn"]["fc1_bias"], bp["ffn"]["fc2"], bp["ffn"]["fc2_bias"])
            for bp in blocks]
    x = x_of(cfg.bridge.language_dim)
    got, want = quant.int8_ffn(x, *ffns[0]), quant.int8_ffn_plain(x, *ffns[0])
    torch.cuda.synchronize()
    err = rows_close("int8_ffn", got, want, I8_TOL)
    nxt = cycle(ffns)
    ms = time_ms(lambda: quant.int8_ffn(x, *nxt()), 50)
    plain_ms = time_ms(lambda: quant.int8_ffn_plain(x, *nxt()), 4)
    f = ffns[0]
    bd = bound(wbytes(f[0], f[2]) + nbytes(f[1], f[3], x, got), 2.0 * BATCH * n_w(f[0], f[2]))
    print(f"[int8_ffn] kernel {ms:.4f} ms (the mma.sync kernel: {I8_MMA_SYNC_MS['int8_ffn']}), "
          f"plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    res["int8_ffn"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                       "library_ms": None}
    return res


def phase_logits_head(params, dev, gen):
    from vlm_bridge_tpu_torch.ops import quant

    E = params["lm"]["embedding"]
    V, H = E["w_int8"].shape
    x = torch.randn(BATCH, H, generator=gen, device=dev).to(torch.bfloat16)
    got, want = quant.int8_matmul_t(x, E), quant.int8_matmul_t_plain(x, E)
    torch.cuda.synchronize()
    err = rows_close("int8_matmul_t", got, want, LOGIT_TOL)
    same_bits("int8_matmul_t", got, quant.int8_matmul_t(x, E))
    ms = time_ms(lambda: quant.int8_matmul_t(x, E), 50)
    plain_ms = time_ms(lambda: quant.int8_matmul_t_plain(x, E), 3)
    # table, scales and x read once, the f32 logits written once
    bd = bound(nbytes(E["w_int8"], E["scale"], x, got), 2.0 * BATCH * V * H)
    print(f"[int8_matmul_t] kernel {ms:.4f} ms (the wmma tile kernel: "
          f"{HEAD_MMA_SYNC_MS['int8_matmul_t']}), plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
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
    # "ragged": lengths in [S/4, S] with one full row; "zero" also empties one; or the lengths
    lens: Union[None, str, Tuple[int, ...]]
    q_mul: float = 1.0    # q is randn times this: logits have this standard deviation
    views: bool = False   # q, k, v as column views of one fused [B, T, (H + 2 KH) D] projection


FLASH_CASES = (
    FlashCase("gemma", 8, 256, 256, 8, 4, 256, True, 50.0, 4096, "ragged"),
    FlashCase("bridge_self", 8, 256, 256, 18, 18, 128, False, None, None, "ragged"),
    FlashCase("vit", 8, 257, 257, 16, 16, 64, False, None, None, None),
    FlashCase("window_t_ne_s", 8, 256, 512, 8, 4, 256, True, 50.0, 128, None),
    FlashCase("empty_row", 8, 256, 256, 8, 4, 256, True, 50.0, 4096, "zero"),
    # randn logits stay under a tenth of Gemma's cap, where tanh is the identity
    # to 0.3 %; here they reach three times the cap and 1 - tanh^2 spans 0.01 to 1
    FlashCase("softcap_binds", 8, 256, 256, 8, 4, 256, True, 2.0, 4096, "ragged", 2.0),
    # the encode's own call: 64 images, q, k and v as dinov2._attention hands them over
    FlashCase("vit_encode", 64, 257, 257, 16, 16, 64, False, None, None, None, views=True),
    # GQA (G = 4), T != S, B > 1, a tail tile of 36 rows past T, a binding window
    FlashCase("gqa_tail", 3, 100, 300, 8, 2, 128, True, 30.0, 160, "ragged"),
    # G = 1 (the two items of a unit are neighbouring row tiles) under a window
    # that binds, with kv_lens so short that late row tiles see no key at all
    FlashCase("window_g1", 3, 256, 256, 4, 4, 128, False, None, 64, (256, 10, 70)),
    FlashCase("window_g1_causal", 3, 256, 256, 4, 4, 128, True, None, 64, (256, 10, 70)),
    FlashCase("window_g1_d64", 3, 512, 512, 4, 4, 64, False, None, 32, (512, 10, 70)),
)
MAIN_PATH_CASES = ("gemma", "bridge_self")  # the shapes the train step gives the kernels
LIBRARY_CASES = ("bridge_self", "vit", "vit_encode")   # no soft-cap: SDPA computes the same
FWD_ONLY_CASES = ("vit_encode",)   # the frozen ViT: no backward on the main path


def flash_case_inputs(case, dev, gen):
    B, T, S, H, KH, D = case.B, case.T, case.S, case.H, case.KH, case.D

    def mk(*shape, mul=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * mul).to(torch.bfloat16)

    if case.views:
        fused = mk(B, T, (H + 2 * KH) * D)
        q, k, v = (fused[..., :H * D].reshape(B, T, H, D),
                   fused[..., H * D:(H + KH) * D].reshape(B, S, KH, D),
                   fused[..., (H + KH) * D:].reshape(B, S, KH, D))
        dout = mk(B, T, 2 * H * D)[..., H * D:].reshape(B, T, H, D)
    else:
        q, k, v, dout = (mk(B, T, H, D, mul=case.q_mul), mk(B, S, KH, D), mk(B, S, KH, D),
                         mk(B, T, H, D))
    if case.lens is None:
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
    elif isinstance(case.lens, tuple):
        lens = torch.tensor(case.lens, dtype=torch.int32, device=dev)
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
    """The three flash kernels against their plain versions at every case,
    each on q, k, v (and dout) as the case gives them, views included, as the
    autograd function hands them over; two calls of each give the same bits;
    times, bounds and the library yardstick at the main path's two shapes and
    at the ViT's two, and scaled_dot_product_attention's backward at the
    bridge-self shape against the dq + dk/dv pair, delta included."""
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
        # is held to its plain version on the same inputs; dk/dv gets the dq
        # kernel's delta, as in the autograd function
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, lens, out_p, lse_p, dout, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lens, out_p, lse_p, dout, delta=delta,
                                            **kw)
        torch.cuda.synchronize()
        tag = f"{cname} B{B} T{T} S{S} H{H} KH{KH} D{D}{' views' if case.views else ''}"
        errs = {
            names[0]: row_err(f"{names[0]} out, {tag}", out, out_p, failures),
            names[1]: row_err(f"{names[1]} dq, {tag}", dq, dq_p, failures),
            names[2]: max(row_err(f"{names[2]} dk, {tag}", dk, dk_p, failures),
                          row_err(f"{names[2]} dv, {tag}", dv, dv_p, failures)),
        }
        full = lse_p > -1e38
        lse_err = float((lse[full] - lse_p[full]).abs().max()) if bool(full.any()) else 0.0
        print(f"[{names[0]} lse, {tag}] max_abs_err={lse_err:.6g} (limit {LSE_TOL}); "
              f"rows with empty support: {int((~full).sum())}")
        if not lse_err <= LSE_TOL:
            failures.append(f"{tag}: lse error {lse_err} above {LSE_TOL}")
        if not torch.equal(lse[~full], lse_p[~full]):
            failures.append(f"{tag}: rows with empty support disagree on lse")
        out2, lse2 = fa.flash_attention_fwd(q, k, v, lens, **kw)
        if not (torch.equal(out2, out) and torch.equal(lse2, lse)):
            failures.append(f"{tag}: two calls of the forward give different bits")
        dq2, delta2 = fa.flash_attention_bwd_dq(q, k, v, lens, out_p, lse_p, dout, **kw)
        if not (torch.equal(dq2, dq) and torch.equal(delta2, delta)):
            failures.append(f"{tag}: two calls of dq give different bits")
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, lens, out_p, lse_p, dout, delta=delta2,
                                              **kw)
        if not (torch.equal(dk2, dk) and torch.equal(dv2, dv)):
            failures.append(f"{tag}: two calls of dk/dv give different bits")
        delta_p = fa._delta(out_p, dout)
        delta_err = float((delta - delta_p).abs().max())
        if not delta_err <= LSE_TOL * max(1.0, float(delta_p.abs().max())):
            failures.append(f"{tag}: the dq kernel's delta is {delta_err} off _delta's")
        empty_out = out[~full.transpose(1, 2)]
        if empty_out.numel() and float(empty_out.float().abs().max()) != 0.0:
            failures.append(f"{tag}: rows with empty support must give out = 0")
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

        library_ms = library_bwd_ms = None
        if cname in LIBRARY_CASES:
            # scaled_dot_product_attention computes the same function where there is
            # no soft-cap; a yardstick only, the port never calls it. A mask only where
            # the case has lengths: with none it keeps SDPA off its fastest backends
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = None
            if case.lens is not None:
                mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, scale=D ** -0.5)
            row_err(f"scaled_dot_product_attention vs plain, {tag}",
                    sdpa().transpose(1, 2), out_p, failures)
            library_ms = time_ms(sdpa, 20)
            if cname == "bridge_self":
                # its backward (dq, dk and dv in one call) on the masked call: the
                # yardstick of the two backward kernels together
                leaves = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
                dot = dout.transpose(1, 2)
                with torch.enable_grad():
                    o = F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=D ** -0.5)
                    grads = torch.autograd.grad(o, leaves, dot, retain_graph=True)
                    row_err(f"scaled_dot_product_attention backward dq vs plain, {tag}",
                            grads[0].transpose(1, 2), dq_p, failures)
                    library_bwd_ms = time_ms(
                        lambda: torch.autograd.grad(o, leaves, dot, retain_graph=True), 20)
                print(f"[scaled_dot_product_attention backward] {cname}: {library_bwd_ms:.4f} ms "
                      f"for dq, dk and dv together")
        if cname not in MAIN_PATH_CASES and library_ms is None:
            continue
        pairs = attended_pairs(case, lens)
        # each input read once, each output written once: q, k, v, dout, lse, lens and
        # delta (the dq kernel writes it and also reads out; dk/dv reads it)
        io_bwd = nbytes(q, k, v, dout, lse_p, lens, delta)
        runs = {
            names[0]: (lambda: fa.flash_attention_fwd(q, k, v, lens, **kw),
                       lambda: fa.flash_attention_plain(q, k, v, lens, **kw),
                       bound(nbytes(q, k, v, lens, out, lse), 4.0 * D * pairs * H), library_ms),
            names[1]: (lambda: fa.flash_attention_bwd_dq(q, k, v, lens, out_p, lse_p, dout, **kw),
                       lambda: fa.flash_attention_bwd_plain(q, k, v, lens, out_p, lse_p, dout,
                                                            **kw),
                       bound(io_bwd + nbytes(out_p, dq), 6.0 * D * pairs * H), None),
            names[2]: (lambda: fa.flash_attention_bwd_dkv(q, k, v, lens, out_p, lse_p, dout,
                                                          delta=delta, **kw),
                       lambda: fa.flash_attention_bwd_plain(q, k, v, lens, out_p, lse_p, dout,
                                                            **kw),
                       bound(io_bwd + nbytes(dk, dv), 8.0 * D * pairs * H), None),
        }
        for n, (kernel, plain, bd, lib) in runs.items():
            if cname in FWD_ONLY_CASES and n != names[0]:
                continue
            ms, plain_ms = time_ms(kernel, 50), time_ms(plain, 5)
            print(f"[{n}] {cname}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, library "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}")
            res[n]["by_shape"][cname] = {"ms": ms, "plain_ms": plain_ms, **bd, "library_ms": lib}
        if library_bwd_ms is not None:
            # no one library call computes dq alone or dk, dv alone: SDPA's backward
            # is held against the two kernels together, on both kernels' entries
            # (the dq kernel's time includes delta, which SDPA's backward computes too)
            pair_ms = sum(res[n]["by_shape"][cname]["ms"] for n in names[1:])
            print(f"[flash backward pair] {cname}: dq + dk/dv kernels {pair_ms:.4f} ms, "
                  f"scaled_dot_product_attention backward {library_bwd_ms:.4f} ms")
            for n in names[1:]:
                res[n]["by_shape"][cname].update(pair_ms=pair_ms, library_pair_ms=library_bwd_ms)
    if failures:
        raise AssertionError("flash kernels disagree with their plain versions:\n  "
                             + "\n  ".join(failures))
    for n in names:
        # the headline numbers are the Gemma shape's: 26 of the step's 28 attentions
        res[n].update(res[n]["by_shape"]["gemma"])
    return res


def expected_flash_launches(cfg, tc) -> dict:
    """Launches of one train step: each Gemma layer's forward runs twice
    under per-layer recomputation, each bridge block's self attention once,
    and each layer of the frozen ViT once, forward only; every attention
    with a gradient has one dq and one dk/dv launch."""
    attn = cfg.lm.num_layers + cfg.bridge.num_blocks
    fwd = (cfg.lm.num_layers * (2 if tc.remat_lm else 1) + cfg.bridge.num_blocks
           + cfg.vision.num_layers)
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
    fa.flash_attention_bwd_dq = (   # (dq, delta) from (q, k, v, kv_lens, out, lse, dout)
        lambda *a, **kw: (fa.flash_attention_bwd_plain(*a, **kw)[0], fa._delta(a[4], a[6])))
    fa.flash_attention_bwd_dkv = (
        lambda *a, delta=None, **kw: fa.flash_attention_bwd_plain(*a, **kw)[1:])
    try:
        yield
    finally:
        fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv = saved


DECODE_KERNELS = {"decode_kernels": ("fused_stack_step", "fused_bridge_step", "fused_attn_step",
                                     "fused_mlp_step"),
                  "quant": ("int8_matmul_t_argmax", "int8_matmul", "int8_mlp", "int8_ffn",
                            "int8_matmul_t", "int4_matmul_t_argmax", "int4_matmul_t",
                            "int4_mlp")}


def decode_modules() -> dict:
    from vlm_bridge_tpu_torch.ops import decode_kernels, quant

    return {"decode_kernels": decode_kernels, "quant": quant}


def decode_wrappers() -> dict:
    """name -> wrapper of every decode kernel (each carries .launches)."""
    mods = decode_modules()
    return {n: getattr(mods[m], n) for m, names in DECODE_KERNELS.items() for n in names}


@contextlib.contextmanager
def plain_decode():
    """Within this block every decode kernel's wrapper is its plain version:
    the reference a whole generation is compared with on the card. The
    package itself has no such switch."""
    mods, saved = decode_modules(), decode_wrappers()
    for m, names in DECODE_KERNELS.items():
        for n in names:
            setattr(mods[m], n, getattr(mods[m], n + "_plain"))
    try:
        yield
    finally:
        for m, names in DECODE_KERNELS.items():
            for n in names:
                setattr(mods[m], n, saved[n])


@contextlib.contextmanager
def record_decode_hidden(step_name="decode_step"):
    """Within this block gemma2.decode_step (or decode_step_stacked) keeps a
    copy of the final hidden states it returns; yields the list (one [B, H]
    tensor per token)."""
    from vlm_bridge_tpu_torch.models import gemma2

    step, seen = getattr(gemma2, step_name), []

    def recording(*args, **kwargs):
        hidden, cache = step(*args, **kwargs)
        seen.append(hidden[:, 0].clone())
        return hidden, cache

    setattr(gemma2, step_name, recording)
    try:
        yield seen
    finally:
        setattr(gemma2, step_name, step)


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
    """The int8 greedy serving path; returns the decode kernels' launch
    counts, the counted run's captions per second and (ids on the CPU, the
    first step's final hidden states) of that run."""
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.ops import decode_kernels, quant
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    pixels = seeded_pixels(cfg, dev)
    # warm-up (cuBLAS handles, allocator) on 2 tokens, then the counted run
    generate_tokens(params, cfg, pixel_values=pixels,
                    gen=GenerationConfig(max_length=2, greedy=True, kv_quant=True))
    torch.cuda.synchronize()
    counters = (decode_kernels.fused_stack_step, decode_kernels.fused_bridge_step,
                quant.int8_matmul_t_argmax)
    for fn in counters:
        fn.launches = 0
    fa.flash_attention_fwd.launches = 0
    t0 = time.perf_counter()
    with record_decode_hidden("decode_step_stacked") as hidden_k:
        toks, lens = generate_tokens(params, cfg, pixel_values=pixels, gen=gcfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"main path launches: {launches}; the encode's flash_attention_fwd "
          f"{fa.flash_attention_fwd.launches}")
    for name, n in launches.items():
        if n != NEW_TOKENS:
            raise AssertionError(f"{name} launched {n} times, expected {NEW_TOKENS}")
    if fa.flash_attention_fwd.launches != cfg.vision.num_layers:
        raise AssertionError("the ViT did not reach the flash kernel once a layer")

    toks_c = check_tokens(toks, lens, cfg, NEW_TOKENS)
    rate = BATCH / dt
    print(f"main path: {BATCH} captions x {NEW_TOKENS} tokens in {dt:.3f} s = "
          f"{rate:.2f} captions/s (encode + decode) on {card}")

    # the plain path: every decode kernel's plain version behind the same
    # encoder (f32 inside on both sides), so every first token is to be equal
    t0 = time.perf_counter()
    with plain_decode():
        ref, _ = generate_tokens(params, cfg, pixel_values=pixels, gen=gcfg)
    torch.cuda.synchronize()
    if any(fn.launches != NEW_TOKENS for fn in counters):
        raise AssertionError("the plain path launched a decode kernel")
    ref = ref.cpu()
    first_eq = bool((ref[:, 1] == toks_c[:, 1]).all())
    share = float((ref[:, 1:] == toks_c[:, 1:]).float().mean())
    print(f"plain path: {BATCH / (time.perf_counter() - t0):.2f} captions/s; first tokens "
          f"equal in every row: {first_eq}; share of all tokens equal: {share:.4f}")
    if not first_eq:
        raise AssertionError("first generated tokens differ from the plain path")

    # the same fused stack with the sampled head: f32 logits, soft-cap, top-p
    wrappers = decode_wrappers()
    sampled = GenerationConfig(max_length=NEW_TOKENS, kv_quant=True)

    def run_sampled(n_tokens):
        sgen = torch.Generator(device=dev)
        sgen.manual_seed(SEED + 6)
        out = generate_tokens(params, cfg, pixel_values=pixels, generator=sgen,
                              gen=dataclasses.replace(sampled, max_length=n_tokens))
        torch.cuda.synchronize()
        return out

    run_sampled(2)  # warm-up of the sampler's ops
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks, lens = run_sampled(NEW_TOKENS)
    dt = time.perf_counter() - t0
    check_tokens(toks, lens, cfg, NEW_TOKENS)
    got = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    want = dict.fromkeys(("fused_stack_step", "fused_bridge_step", "int8_matmul_t"), NEW_TOKENS)
    print(f"fused stack + sampled head: launches {got}; {BATCH} captions x {NEW_TOKENS} tokens "
          f"in {dt:.3f} s = {BATCH / dt:.2f} captions/s (temperature 0.7, top-p 0.9, int8 KV "
          f"cache) on {card}")
    if got != want:
        raise AssertionError(f"fused sampled path launches {got}, expected {want}")
    return launches, rate, (toks_c, hidden_k[0])


def run_sample(params, cfg, dev, card):
    """The sampled per-layer int8 path (per-layer dicts, bf16 KV cache);
    returns the four int8 kernels' launch counts of the counted run."""
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens

    pixels = seeded_pixels(cfg, dev)
    gcfg = GenerationConfig(max_length=NEW_TOKENS, temperature=0.7, top_p=0.9, topk_window=128,
                            greedy=False, kv_quant=False, early_stop=False)
    wrappers = decode_wrappers()

    def sampled(n_tokens=NEW_TOKENS, seed=SEED + 7):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        out = generate_tokens(params, cfg, pixel_values=pixels, generator=g,
                              gen=dataclasses.replace(gcfg, max_length=n_tokens))
        torch.cuda.synchronize()
        return out

    sampled(2)  # warm-up
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks, lens = sampled()
    dt = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items()}
    print(f"sampled per-layer path launches: {launches}")
    per_token = {"int8_matmul": 2 * cfg.lm.num_layers + 4 * cfg.bridge.num_blocks,
                 "int8_mlp": cfg.lm.num_layers, "int8_ffn": cfg.bridge.num_blocks,
                 "int8_matmul_t": 1, "fused_stack_step": 0, "fused_bridge_step": 0,
                 "int8_matmul_t_argmax": 0}
    for name, n in per_token.items():
        if launches[name] != n * NEW_TOKENS:
            raise AssertionError(f"{name} launched {launches[name]} times, expected "
                                 f"{n} x {NEW_TOKENS}")
    toks_c = check_tokens(toks, lens, cfg, NEW_TOKENS)
    print(f"sampled per-layer path: {BATCH} captions x {NEW_TOKENS} tokens in {dt:.3f} s = "
          f"{BATCH / dt:.2f} captions/s (encode + decode; temperature 0.7, top-p 0.9, "
          f"bf16 KV cache) on {card}")
    again, _ = sampled()
    other, _ = sampled(seed=SEED + 8)
    same = bool(torch.equal(again.cpu(), toks_c))
    print(f"same seed, same tokens: {same}; another seed differs: "
          f"{not torch.equal(other.cpu(), toks_c)}")
    if not same or torch.equal(other.cpu(), toks_c):
        raise AssertionError("sampling does not follow its seed")

    # greedy over a few tokens: kernels against their plain versions. Both
    # paths round every projection's output to bf16 (the activation dtype
    # between the layers' ops), so f32 sums taken in another order flip a
    # rounding here and there and the paths drift apart by bf16 steps: with
    # random weights, whose top logits are near-ties, a row's argmax may then
    # differ. What is held is the first step's logits, path against path.
    from vlm_bridge_tpu_torch.ops import quant

    ggen = dataclasses.replace(gcfg, greedy=True, max_length=GREEDY_CHECK_TOKENS)
    with record_decode_hidden() as hidden_k:
        got, _ = generate_tokens(params, cfg, pixel_values=pixels, gen=ggen)
    before = {n: fn.launches for n, fn in wrappers.items()}
    with plain_decode(), record_decode_hidden() as hidden_p:
        ref, _ = generate_tokens(params, cfg, pixel_values=pixels, gen=ggen)
    torch.cuda.synchronize()
    if {n: fn.launches for n, fn in wrappers.items()} != before:
        raise AssertionError("the plain per-layer path launched a kernel")
    hold_first_step(f"per-layer greedy, {GREEDY_CHECK_TOKENS} tokens, kernels vs plain versions",
                    got.cpu(), ref.cpu(),
                    quant.int8_matmul_t_plain(hidden_k[0], params["lm"]["embedding"]),
                    quant.int8_matmul_t_plain(hidden_p[0], params["lm"]["embedding"]))

    decode_profile(lambda: sampled(PROFILE_TOKENS), lambda: sampled(2 * PROFILE_TOKENS), card)
    return {n: launches[n] for n in ("int8_matmul", "int8_mlp", "int8_ffn", "int8_matmul_t")}


def hold_first_step(name, got, ref, logits_k, logits_p):
    """Kernels' path against plain path: prints how many first tokens and what
    share of all tokens (got, ref: [B, 1 + n] on the CPU) are equal, and holds
    the first step's logits, path against path, to HIDDEN_TOL x their largest
    value; a row whose first token differs must be a near-tie of the plain
    path's logits."""
    rows_eq = int((got[:, 1] == ref[:, 1]).sum())
    share = float((got[:, 1:] == ref[:, 1:]).float().mean())
    err = float((logits_k - logits_p).abs().max())
    tol = HIDDEN_TOL * float(logits_p.abs().max())
    top2 = torch.topk(logits_p, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    differ = (got[:, 1] != ref[:, 1]).to(gap.device)
    print(f"{name}: first tokens equal in {rows_eq} of {BATCH} rows; share of all tokens equal: "
          f"{share:.4f}; first-step logits max_abs_err={err:.6g} tol={tol:.6g}; smallest top-2 "
          f"gap of the plain path's logits {float(gap.min()):.6g}, largest gap in a row that "
          f"differs {float(gap[differ].max()) if bool(differ.any()) else 0.0:.6g}")
    for r in differ.nonzero().flatten().tolist():
        print(f"  row {r}: first token {int(got[r, 1])} against {int(ref[r, 1])}; top-2 logit "
              f"margin of the reference {float(gap[r]):.6g}")
    if not err <= tol:
        raise AssertionError(f"{name}: first-step logits differ from the plain path")
    if bool(differ.any()) and float(gap[differ].max()) > 2 * err + 1e-3:
        raise AssertionError(f"{name}: a first token differs where the plain path's logits "
                             "are no near-tie")


def decode_profile(short, long, card):
    """Kernel launches and device-busy time per token of the sampled path:
    two profiled generations of PROFILE_TOKENS and twice as many tokens;
    their difference leaves the encode and the set-up out."""
    from torch.profiler import ProfilerActivity, profile

    def window(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            wall = (time.perf_counter() - t0) * 1e3
        rows = [(e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                if e.self_device_time_total > 0
                and e.device_type == torch.autograd.DeviceType.CUDA]
        return wall, sum(r[0] for r in rows), sum(r[1] for r in rows)

    w1, b1, n1 = window(short)
    w2, b2, n2 = window(long)
    if n2 <= n1:
        print("sampled per-layer path profile: the profiler recorded no device time")
        return
    wall, busy, n = ((b - a) / PROFILE_TOKENS for a, b in ((w1, w2), (b1, b2), (n1, n2)))
    print(f"sampled per-layer path, per token (torch profiler on, which slows the host): "
          f"{n:.0f} kernel launches, device busy {busy:.3f} ms of {wall:.3f} ms = "
          f"{100 * busy / wall:.1f} % (on {card})")


@contextlib.contextmanager
def vit_routing(mm: bool = False, ln: bool = False):
    """Within this block VLM_BRIDGE_VIT_MM and VLM_BRIDGE_LN_KERNEL are set
    (or unset) as asked; restored afterwards."""
    import os

    names = {"VLM_BRIDGE_VIT_MM": "kernel" if mm else None,
             "VLM_BRIDGE_LN_KERNEL": "1" if ln else None}
    saved = {k: os.environ.get(k) for k in names}
    try:
        for k, v in names.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def plain_vit_attention():
    """Within this block the ViT's attention is `_attention_reference`, as it
    was before the encoder was routed through dot_product_attention: the
    other side of the flash A/B. The package has no such switch."""
    from vlm_bridge_tpu_torch.models import dinov2
    from vlm_bridge_tpu_torch.ops.attention import _attention_reference

    saved = dinov2.dot_product_attention
    dinov2.dot_product_attention = lambda q, k, v, *, scale: _attention_reference(
        q, k, v, scale=scale)
    try:
        yield
    finally:
        dinov2.dot_product_attention = saved


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest abs difference over the reference's largest abs value."""
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def vit_projections(params, cfg):
    """name -> ([K, N] weights of every layer, their biases, gelu) for the
    ViT's four projections."""
    layers = [params["vision"]["layers"][str(i)] for i in range(cfg.vision.num_layers)]
    return {"qkv": ([lp["attn"]["qkv"] for lp in layers],
                    [lp["attn"]["qkv_bias"] for lp in layers], False),
            "o": ([lp["attn"]["o"] for lp in layers],
                  [lp["attn"]["o_bias"] for lp in layers], False),
            "fc1": ([lp["mlp"]["fc1"] for lp in layers],
                    [lp["mlp"]["fc1_bias"] for lp in layers], True),
            "fc2": ([lp["mlp"]["fc2"] for lp in layers],
                    [lp["mlp"]["fc2_bias"] for lp in layers], False)}


def phase_tiled_matmul(params, cfg, dev, gen, card):
    """tiled_matmul at the rows a batch of BATCH images gives the ViT
    (BATCH x 257), on the model's own weights with seeded non-zero biases:
    the four projections with a bias (fc1 with GELU), the o projection without
    one, a ragged case; then the projection probe. Returns the result rows
    of `tiled_matmul` and `tiled_matmul[bias]` and the launches of the probe's
    one counted pass."""
    import torch.nn.functional as F

    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk

    M = BATCH * cfg.num_vision_tokens
    projs = vit_projections(params, cfg)
    xs = {}

    def x_of(K):
        if K not in xs:
            xs[K] = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        return xs[K]

    def run_case(name, pname, ws, bias, gelu):
        K, N = ws[0].shape
        x = x_of(K)
        got = mk.tiled_matmul(x, ws[0], bias, gelu=gelu)
        want = mk.tiled_matmul_plain(x, ws[0], bias, gelu=gelu)
        torch.cuda.synchronize()
        err = rows_close(f"{name} {M}x{K}x{N}", got, want, I8_TOL)
        nxt = cycle(ws)
        ms = time_ms(lambda: mk.tiled_matmul(x, nxt(), bias, gelu=gelu), 20)
        plain_ms = time_ms(lambda: mk.tiled_matmul_plain(x, nxt(), bias, gelu=gelu), 3)
        if bias is None:
            lib = lambda: torch.matmul(x, nxt())  # noqa: E731
        else:
            b16 = bias.to(torch.bfloat16)
            lib = ((lambda: F.gelu(torch.addmm(b16, x, nxt()))) if gelu
                   else (lambda: torch.addmm(b16, x, nxt())))
        library_ms = time_ms(lib, 20)
        flops = 2.0 * M * K * N
        bd = bound(nbytes(x, ws[0], got) + (0 if bias is None else nbytes(bias)), flops)
        earlier = TILED_MATMUL_MMA_SYNC_MS[pname if bias is not None else pname + " without bias"]
        print(f"[{name}] {pname} {K} -> {N}: kernel {ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s "
              f"(the mma.sync form, PERF.md: {earlier:.4f} ms = {flops / earlier / 1e9:.1f}), "
              f"plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}, "
              f"{'torch.matmul' if bias is None else 'torch.addmm' + (' + F.gelu' if gelu else '')}"
              f" {library_ms:.4f} ms = {flops / library_ms / 1e9:.1f} TFLOP/s (on {card})")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                "library_ms": library_ms}

    by_shape = {}
    for pname, (ws, _, gelu) in projs.items():
        # the model's biases are zeros at init: seeded ones, f32 as _proj passes them
        bias = torch.randn(ws[0].shape[1], generator=gen, device=dev) * 0.5
        by_shape[pname] = run_case("tiled_matmul[bias]", pname, ws, bias, gelu)
    no_bias = run_case("tiled_matmul", "o", projs["o"][0], None, False)

    # the kernel's edges: rows and columns ragged by 8 (520 x 136); a K tail (72 = 64 + 8);
    # a last row tile of 64 rows (192 = 128 + 64, as 16448 = 128 x 128 + 64); N beyond a
    # tile by 8 (264 = 2 x 128 + 8); GELU without a bias; f32 out with bias and GELU
    for M_, K_, N_, has_bias, gelu, out_dtype in ((520, 64, 136, False, False, None),
                                                 (520, 64, 136, True, True, None),
                                                 (256, 72, 128, True, False, None),
                                                 (192, 256, 256, True, False, None),
                                                 (384, 128, 264, True, False, None),
                                                 (300, 128, 192, False, True, None),
                                                 (640, 512, 320, True, True, torch.float32)):
        a = torch.randn(M_, K_, generator=gen, device=dev).to(torch.bfloat16)
        b = (torch.randn(K_, N_, generator=gen, device=dev) * K_ ** -0.5).to(torch.bfloat16)
        bs = torch.randn(N_, generator=gen, device=dev) if has_bias else None
        rows_close(f"tiled_matmul ragged {M_}x{K_}x{N_} bias={has_bias} gelu={gelu} "
                   f"out={out_dtype or torch.bfloat16}",
                   mk.tiled_matmul(a, b, bs, gelu=gelu, out_dtype=out_dtype),
                   mk.tiled_matmul_plain(a, b, bs, gelu=gelu, out_dtype=out_dtype),
                   LOGIT_TOL if out_dtype == torch.float32 else I8_TOL)

    # the projection probe: every layer's four projections, bias-free, in layer order
    x1, x4 = x_of(cfg.vision.hidden_size), x_of(cfg.vision.hidden_size * cfg.vision.mlp_ratio)

    def segment(mm):
        def run():
            for i in range(cfg.vision.num_layers):
                for pname in ("qkv", "o", "fc1", "fc2"):
                    mm(x4 if pname == "fc2" else x1, projs[pname][0][i])
        return run

    times = {"tiled_matmul": [], "torch.matmul": []}
    for _ in range(ENCODE_REPS):
        times["tiled_matmul"].append(time_ms(segment(mk.tiled_matmul), 1))
        times["torch.matmul"].append(time_ms(segment(torch.matmul), 1))
    # One counted pass of the probe, untimed: the counts set to 0 just before it and read
    # just after. No model path reaches the bias-free call site (every projection of the ViT
    # carries a bias, here as in the JAX package), so this pass through the public function
    # is the run that drives it.
    mk.tiled_matmul.launches = mk.tiled_matmul.bias_launches = 0
    segment(mk.tiled_matmul)()
    torch.cuda.synchronize()
    probe_launches = mk.tiled_matmul.launches - mk.tiled_matmul.bias_launches
    if (probe_launches, mk.tiled_matmul.bias_launches) != (4 * cfg.vision.num_layers, 0):
        raise AssertionError(f"the projection probe launched {probe_launches} bias-free and "
                             f"{mk.tiled_matmul.bias_launches} biased products")
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    flops = 2.0 * M * sum(w[0].numel() for w, _, _ in projs.values()) * cfg.vision.num_layers
    print(f"projection probe, {cfg.vision.num_layers} layers x 4 bias-free projections at {M} "
          f"rows, median of {ENCODE_REPS}: tiled_matmul {med['tiled_matmul']:.3f} ms = "
          f"{flops / med['tiled_matmul'] / 1e9:.1f} TFLOP/s (the mma.sync form, PERF.md: "
          f"{TILED_MATMUL_MMA_SYNC_MS['probe']:.3f} ms), torch.matmul "
          f"{med['torch.matmul']:.3f} ms = {flops / med['torch.matmul'] / 1e9:.1f} TFLOP/s "
          f"(on {card})")
    # the headline numbers of the biased kernel are fc1's: bias and GELU both in the epilogue
    biased = {**by_shape["fc1"], "max_abs_err": max(r["max_abs_err"] for r in by_shape.values()),
              "by_shape": by_shape, "probe_ms": med}
    return {"tiled_matmul": no_bias, "tiled_matmul[bias]": biased}, probe_launches


def phase_layer_norm(cfg, dev, gen, card):
    """layer_norm_fast at the ViT's shape (bf16) and the bridge's training
    shape (f32) against its plain version, F.layer_norm and the eager pivot
    form of ops.layers.layer_norm (what the default routing runs)."""
    import torch.nn.functional as F

    from vlm_bridge_tpu_torch.ops import layers
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk

    shapes = {"vit": (BATCH * cfg.num_vision_tokens, cfg.vision.hidden_size, torch.bfloat16,
                      cfg.vision.layer_norm_eps),
              "bridge_train": (TRAIN_BATCH * TRAIN_SEQ, cfg.bridge.language_dim, torch.float32,
                               cfg.bridge.layer_norm_eps)}
    by_shape = {}
    for sname, (rows, H, dtype, eps) in shapes.items():
        x = (torch.randn(rows, H, generator=gen, device=dev) * 2 + 1).to(dtype)
        scale = 1 + 0.2 * torch.randn(H, generator=gen, device=dev)
        bias = 0.2 * torch.randn(H, generator=gen, device=dev)
        got, want = nk.layer_norm_fast(x, scale, bias, eps), nk.layer_norm_fast_plain(x, scale,
                                                                                     bias, eps)
        torch.cuda.synchronize()
        err = rows_close(f"layer_norm_fast {sname} {rows}x{H} {dtype}", got, want,
                         I8_TOL if dtype == torch.bfloat16 else LOGIT_TOL)
        sd, bd_ = scale.to(dtype), bias.to(dtype)
        with vit_routing():
            pivot = layers.layer_norm(x, scale, bias, eps)
            rows_close(f"eager pivot form vs plain, {sname}", pivot, want,
                       I8_TOL if dtype == torch.bfloat16 else LOGIT_TOL)
            pivot_ms = time_ms(lambda: layers.layer_norm(x, scale, bias, eps), 10)
        ms = time_ms(lambda: nk.layer_norm_fast(x, scale, bias, eps), 50)
        plain_ms = time_ms(lambda: nk.layer_norm_fast_plain(x, scale, bias, eps), 5)
        library_ms = time_ms(lambda: F.layer_norm(x, (H,), sd, bd_, eps), 50)
        bd = bound(nbytes(x, got, scale, bias), 8.0 * rows * H)
        print(f"[layer_norm_fast] {sname} {rows}x{H} {dtype}: kernel {ms:.4f} ms = "
              f"{nbytes(x, got) / ms / 1e9:.3f} TB/s, plain {plain_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}, F.layer_norm {library_ms:.4f} ms, "
              f"the eager pivot form {pivot_ms:.4f} ms (on {card})")
        by_shape[sname] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                           "library_ms": library_ms, "pivot_form_ms": pivot_ms}
    return {**by_shape["vit"], "by_shape": by_shape}


def time_encode(params, cfg, pixels) -> float:
    from vlm_bridge_tpu_torch.models import full_model

    return time_ms(lambda: full_model.encode_image(params, cfg, pixels), ENCODE_REPS)


def run_vit_kernels(params, served, cfg, dev, card, gcfg, default_run):
    """The vision encode of BATCH images through dinov2.forward: default
    routing, plain attention swapped in for the flash kernel, both kernel
    variables set (counted), the serving batch with both set, the int8 tower.
    default_run: (ids, first-step hidden) of the default routing's serving
    batch. Returns the launches of one kernel-routed encode."""
    from vlm_bridge_tpu_torch.inference.generate import generate_tokens
    from vlm_bridge_tpu_torch.models import dinov2, full_model
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk
    from vlm_bridge_tpu_torch.ops import quant

    pixels = seeded_pixels(cfg, dev)
    L = cfg.vision.num_layers

    def counts():
        return {"tiled_matmul[bias]": mk.tiled_matmul.bias_launches,
                "tiled_matmul": mk.tiled_matmul.launches - mk.tiled_matmul.bias_launches,
                "layer_norm_fast": nk.layer_norm_fast.launches,
                "flash_attention_fwd": fa.flash_attention_fwd.launches,
                "int8_matmul": quant.int8_matmul.launches}

    def counted(p):
        mk.tiled_matmul.launches = mk.tiled_matmul.bias_launches = 0
        nk.layer_norm_fast.launches = fa.flash_attention_fwd.launches = 0
        quant.int8_matmul.launches = 0
        out = full_model.encode_image(p, cfg, pixels)
        torch.cuda.synchronize()
        return out, counts()

    base, n_base = counted(params)
    if n_base != {"tiled_matmul[bias]": 0, "tiled_matmul": 0, "layer_norm_fast": 0,
                  "flash_attention_fwd": L, "int8_matmul": 0}:
        raise AssertionError(f"default routing of the encode launched {n_base}")
    ms = {"default": time_encode(params, cfg, pixels)}
    with plain_vit_attention():
        plain_attn, n_plain = counted(params)
        ms["plain_attention"] = time_encode(params, cfg, pixels)
    if n_plain["flash_attention_fwd"]:
        raise AssertionError("the plain-attention encode launched the flash kernel")
    with vit_routing(mm=True, ln=True):
        routed, n_routed = counted(params)
        ms["kernels"] = time_encode(params, cfg, pixels)
    want = {"tiled_matmul[bias]": 4 * L, "tiled_matmul": 0, "layer_norm_fast": 2 * L + 1,
            "flash_attention_fwd": L, "int8_matmul": 0}
    print(f"kernel-routed encode launches: {n_routed}")
    if n_routed != want:
        raise AssertionError(f"kernel-routed encode launched {n_routed}, expected {want}")
    ms["default_again"] = time_encode(params, cfg, pixels)
    errs = {"kernels vs default": rel_err(routed, base),
            "flash vs plain attention": rel_err(base, plain_attn)}
    print(f"vision encode, {BATCH} images, mean of {ENCODE_REPS}: default routing "
          f"{ms['default']:.2f} ms (again {ms['default_again']:.2f}), with _attention_reference "
          f"in place of the flash kernel {ms['plain_attention']:.2f} ms, with tiled_matmul and "
          f"layer_norm_fast {ms['kernels']:.2f} ms; features' relative error "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (limit {FEATURE_TOL}) on {card}")
    if not all(torch.isfinite(t.float()).all() for t in (base, routed, plain_attn)):
        raise AssertionError("vision features are not finite")
    if not all(v <= FEATURE_TOL for v in errs.values()):
        raise AssertionError(f"vision features disagree: {errs}")

    # The serving batch behind another encoder, against the default routing's: the ViT with
    # the plain attention, then with both variables set. Two correct bf16 encoders round at
    # other places (features above), so all 64 first tokens cannot be promised: what is held
    # is the first step's logits (HIDDEN_TOL x their largest value) and that a row whose
    # first token differs is a near-tie (top-2 margin within twice the logits' error).
    ids0, hidden0 = default_run
    table = served["lm"]["embedding"]
    logits0 = quant.int8_matmul_t_plain(hidden0, table)

    def serve(name):
        with record_decode_hidden("decode_step_stacked") as hidden_k:
            t0 = time.perf_counter()
            toks, lens = generate_tokens(served, cfg, pixel_values=pixels, gen=gcfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        toks_c = check_tokens(toks, lens, cfg, NEW_TOKENS)
        print(f"main path with {name}: {BATCH} captions x {NEW_TOKENS} tokens in {dt:.3f} s = "
              f"{BATCH / dt:.2f} captions/s (encode + decode) on {card}")
        hold_first_step(f"serving batch, {name} against the default routing", toks_c, ids0,
                        quant.int8_matmul_t_plain(hidden_k[0], table), logits0)

    with plain_vit_attention():
        serve("the plain attention in the ViT")
    with vit_routing(mm=True, ln=True):
        serve("the ViT's kernels")

    # the int8 tower
    vq = dinov2.quantize_vision_params(params["vision"])
    pq = {**params, "vision": vq}

    def layer_bytes(vision):
        return sum(nbytes(*(t for t in _leaves(lp))) for lp in vision["layers"].values())

    qfeat, n_q = counted(pq)
    want_q = {"tiled_matmul[bias]": 0, "tiled_matmul": 0, "layer_norm_fast": 0,
              "flash_attention_fwd": L, "int8_matmul": 4 * L}
    if n_q != want_q:
        raise AssertionError(f"int8 tower launched {n_q}, expected {want_q}")
    ms_q = time_encode(pq, cfg, pixels)
    err_q = rel_err(qfeat, base)
    print(f"int8 vision tower: encode {ms_q:.2f} ms against {ms['default']:.2f} for the float "
          f"tower, {4 * L} int8_matmul launches at M = {BATCH * cfg.num_vision_tokens}; "
          f"features' relative error against the float tower {err_q:.3g} (limit "
          f"{INT8_TOWER_TOL}); layers {layer_bytes(vq) / 1e9:.4f} GB against "
          f"{layer_bytes(params['vision']) / 1e9:.4f} GB on {card}")
    if not err_q <= INT8_TOWER_TOL or not torch.isfinite(qfeat.float()).all():
        raise AssertionError("the int8 tower's features are off")
    # the serving batch behind the int8 tower (--quantize ...,vision), host clock; its
    # features carry the int8 noise above, so its tokens are checked for form only
    t0 = time.perf_counter()
    toks, lens = generate_tokens({**served, "vision": vq}, cfg, pixel_values=pixels, gen=gcfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_tokens(toks, lens, cfg, NEW_TOKENS)
    print(f"main path with the int8 vision tower: {BATCH} captions x {NEW_TOKENS} tokens in "
          f"{dt:.3f} s = {BATCH / dt:.2f} captions/s (encode + decode) on {card}")
    # int8_matmul at these rows: the tower's form, 65 row tiles of 256 (the last one 64 rows
    # deep), the contraction in one slice
    M = BATCH * cfg.num_vision_tokens
    x_gen = torch.Generator(device=dev)
    x_gen.manual_seed(SEED + 13)
    for pname, (ws, _, _) in vit_projections(pq, cfg).items():
        K, N = ws[0]["w_int8"].shape
        x = torch.randn(M, K, generator=x_gen, device=dev).to(torch.bfloat16)
        got, want = quant.int8_matmul(x, ws[0]), quant.int8_matmul_plain(x, ws[0])
        torch.cuda.synchronize()
        rows_close(f"int8_matmul vision {pname} {M}x{K}x{N}", got, want, I8_TOL)
        nxt = cycle(ws)
        k_ms = time_ms(lambda: quant.int8_matmul(x, nxt()), 10)
        wb = (ws[0]["w_int8"].float() * ws[0]["scale"]).to(torch.bfloat16)
        l_ms = time_ms(lambda: torch.matmul(x, wb), 10)
        # x, the weights and their scales read once, y written once; 2 M K N on the tensor cores
        bd = bound(nbytes(x, ws[0]["w_int8"], ws[0]["scale"], got), 2.0 * M * K * N)
        print(f"[int8_matmul] vision {pname} {M}x{K}x{N}: kernel {k_ms:.4f} ms = "
              f"{2.0 * M * K * N / k_ms / 1e9:.1f} TFLOP/s (the mma.sync kernel: "
              f"{I8_MMA_SYNC_MS[pname]}), bound {bd['bound_ms']:.4f} ms by "
              f"{bd['bound_by']}; torch.matmul on a bf16 copy {l_ms:.4f} ms (not the same "
              f"function)")
    return n_routed


def phase_gemma2_27b_step(dev, gen, card):
    """One fused token step at VLMConfig.gemma2_27b()'s widths (hidden 4608,
    F 36864, 32 / 16 heads of 128, query_pre_attn_scalar 144; the bridge's
    cross heads of 576 and self heads of 128, F 18432, 257 vision tokens),
    depth cut to two decoder layers and the bridge's two blocks, seeded random
    weights, the int8 recipe: fused_bridge_step -> decode_step_stacked (the
    stack step) -> int8_matmul_t_argmax over the 256000-row table, against the
    same step through the plain versions. The rows leaving the bridge and the
    stack are held to HIDDEN_TOL x their largest value and the greedy ids must
    be equal, a row whose id differs only where the plain logits' top two
    are a near-tie."""
    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge, gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops import quant

    full = VLMConfig.gemma2_27b()
    lm, bc = dataclasses.replace(full.lm, num_layers=2), full.bridge
    lq = gemma2.quantize_params(gemma2.init(lm, generator=gen, device=dev))
    for lp in lq["layers"].values():   # norms away from their zero init
        for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lp[k] = (torch.randn(lm.hidden_size, generator=gen, device=dev) * 0.1).to(lp[k].dtype)
    if not gemma2.supports_fused_decode(lq, lm, NEW_TOKENS + 1):
        raise AssertionError("the fused decode does not serve Gemma-2-27B's widths")
    stacked = gemma2.stack_decode_params(lq, lm)
    bq = bridge.quantize_decode_params(bridge.init(bc, generator=gen, device=dev))
    bst = bridge.stack_bridge_decode_params(bq, bc)
    vision = torch.randn(BATCH, full.num_vision_tokens, bc.vision_dim, generator=gen,
                         device=dev).to(torch.bfloat16)
    tok = torch.randint(0, lm.vocab_size, (BATCH,), generator=gen, device=dev)
    table = lq["embedding"]

    def step():
        bcache = _build_cross_cache(bq, bc, vision, NEW_TOKENS + 1, torch.bfloat16, kv_quant=True)
        kv = gemma2.StackedKVCache.zeros(lm, BATCH, NEW_TOKENS + 1, device=dev)
        emb = gemma2.embed(lq, tok[:, None]).to(torch.bfloat16)
        x = dk.fused_bridge_step(0, emb[:, 0].contiguous(), bst, bcache.cross_k,
                                 bcache.cross_k_scale, bcache.cross_v, bcache.cross_v_scale,
                                 bcache.self_k, bcache.self_v, num_heads_cross=bc.num_heads_cross,
                                 num_heads_self=bc.num_heads_self, eps=bc.layer_norm_eps)
        hidden, _ = gemma2.decode_step_stacked(lq, lm, stacked, x[:, None, :], kv, 0)
        h = hidden[:, 0].contiguous()
        ids = quant.int8_matmul_t_argmax(h, table)
        torch.cuda.synchronize()
        return x, h, ids

    wrappers = decode_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    x_k, h_k, ids_k = step()
    got = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    want = {"fused_bridge_step": 1, "fused_stack_step": 1, "int8_matmul_t_argmax": 1}
    if got != want:
        raise AssertionError(f"the 27B-width step launched {got}, expected {want}")
    with plain_decode():
        x_p, h_p, ids_p = step()
    err_b = check_close("gemma2_27b fused_bridge_step", x_k, x_p)
    err_s = check_close("gemma2_27b stack step (final-normed hidden)", h_k, h_p)
    logits_k, logits_p = quant.int8_matmul_t_plain(h_k, table), quant.int8_matmul_t_plain(h_p, table)
    ids = torch.stack([ids_k.cpu(), ids_p.cpu()], dim=0)
    hold_first_step("gemma2_27b greedy ids, kernels vs plain versions",
                    torch.stack([ids[0], ids[0]], dim=1), torch.stack([ids[1], ids[1]], dim=1),
                    logits_k, logits_p)
    print(f"[gemma2_27b] hidden {lm.hidden_size}, F {lm.intermediate_size}, heads "
          f"{lm.num_heads}/{lm.num_kv_heads} x {lm.head_dim}, bridge cross D "
          f"{bc.language_dim // bc.num_heads_cross}, self D {bc.language_dim // bc.num_heads_self}: "
          f"launches {got}; ids equal in {int((ids_k == ids_p).sum())} of {BATCH} rows on {card}")
    return {"bridge_max_abs_err": err_b, "stack_max_abs_err": err_s,
            "ids_equal": int((ids_k == ids_p).sum())}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_fused_layer(per_layer, cfg, dev, gen, card, t=20):
    """fused_attn_step (t = 0 and t) and fused_mlp_step against their plain
    versions at M = BATCH on the model's own per-layer int8 weights; every
    timed call reads another layer's weights and cache."""
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm = cfg.lm
    L, KH, D = lm.num_layers, lm.num_kv_heads, lm.head_dim
    layers = [per_layer["lm"]["layers"][str(i)] for i in range(L)]
    cache = gemma2.FusedKVCache.zeros(lm, BATCH, NEW_TOKENS + 1, device=dev)
    S = cache.k[0].shape[2]
    for i in range(L):   # history rows 0..t-1: random codes, realistic scales
        for c in (cache.k[i], cache.v[i]):
            c[:, :, :t] = torch.randint(-127, 128, c[:, :, :t].shape, generator=gen, device=dev,
                                        dtype=torch.int8)
        for c in (cache.k_scale[i], cache.v_scale[i]):
            c[:, :, :t] = 0.02 + 0.01 * torch.rand(c[:, :, :t].shape, generator=gen, device=dev)
        # planted: two history rows whose logits go far beyond the soft-cap
        cache.k_scale[i][:, :, 3:5] *= 300.0
    x = (torch.randn(BATCH, lm.hidden_size, generator=gen, device=dev) * 0.02
         * lm.hidden_size ** 0.5).to(torch.bfloat16)
    kw = dict(num_heads=lm.num_heads, num_kv_heads=KH, head_dim=D, attn_scale=lm.attn_scale,
              softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps)

    def attn_args(i, pos):
        cos, sin = rope_table(torch.tensor([pos], device=dev), D, lm.rope_theta)
        lp = layers[i]
        return (pos, x, lp["attn"]["qkv"], lp["attn"]["o"], lp["input_norm"],
                lp["post_attn_norm"], cos[0].contiguous(), sin[0].contiguous(),
                cache.k[i], cache.v[i], cache.k_scale[i], cache.v_scale[i])

    res = {}
    worst = 0.0
    for pos in (0, t):
        args = attn_args(0, pos)
        got, want = dk.fused_attn_step(*args, **kw), dk.fused_attn_step_plain(*args, **kw)
        torch.cuda.synchronize()
        worst = max(worst, rows_close(f"fused_attn_step t={pos} x_out", got[0], want[0],
                                      LAYER_TOL))
        for name, a, b in (("k_new", got[1], want[1]), ("v_new", got[2], want[2])):
            off = (a.int() - b.int()).abs()
            equal = float((off == 0).float().mean())
            print(f"[fused_attn_step t={pos}] {name} codes equal {equal:.6f} (need >= "
                  f"{CODES_EQUAL_MIN}), largest difference {int(off.max())} (at most 1)")
            if int(off.max()) > 1 or equal < CODES_EQUAL_MIN:
                raise AssertionError(f"fused_attn_step t={pos}: {name} codes disagree")
        for name, a, b in (("k_scale", got[3], want[3]), ("v_scale", got[4], want[4])):
            r = float(((a - b).abs() / b).max())
            print(f"[fused_attn_step t={pos}] {name} largest relative error {r:.3g} "
                  f"(limit {SCALE_RTOL})")
            if not r <= SCALE_RTOL:
                raise AssertionError(f"fused_attn_step t={pos}: {name} disagrees")
    if t:
        q_reach = float(cache.k_scale[0][:, :, 3:5].max()) * 127 * lm.attn_scale
        print(f"[fused_attn_step t={t}] planted history rows reach logits of the order of "
              f"{q_reach:.0f} x |q| against a soft-cap of {lm.attn_logit_softcap}")
    arg_sets = [attn_args(i, t) for i in range(L)]
    nxt = cycle(arg_sets)
    ms = time_ms(lambda: dk.fused_attn_step(*nxt(), **kw), 2 * L)
    plain_ms = time_ms(lambda: dk.fused_attn_step_plain(*nxt(), **kw), 4)
    lp = layers[0]
    live = (nbytes(cache.k[0], cache.v[0], cache.k_scale[0], cache.v_scale[0]) * t) // S
    n_w = lp["attn"]["qkv"]["w_int8"].numel() + lp["attn"]["o"]["w_int8"].numel()
    bd = bound(nbytes(*_leaves(lp["attn"]), lp["input_norm"], lp["post_attn_norm"]) + live
               + 2 * nbytes(x) + 2 * BATCH * KH * (D + 4), 2.0 * BATCH * n_w)
    print(f"[fused_attn_step] t={t}: kernel {ms:.4f} ms (with the mma.sync product: "
          f"{I8_MMA_SYNC_MS['fused_attn_step']}), plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (on {card})")
    res["fused_attn_step"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bd,
                              "library_ms": None}

    def mlp_args(i):
        lp = layers[i]
        return (x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"], lp["pre_ffn_norm"],
                lp["post_ffn_norm"])

    got = dk.fused_mlp_step(*mlp_args(0), eps=lm.rms_norm_eps)
    want = dk.fused_mlp_step_plain(*mlp_args(0), eps=lm.rms_norm_eps)
    torch.cuda.synchronize()
    err = rows_close("fused_mlp_step", got, want, LAYER_TOL)
    nxt = cycle([mlp_args(i) for i in range(L)])
    ms = time_ms(lambda: dk.fused_mlp_step(*nxt(), eps=lm.rms_norm_eps), 2 * L)
    plain_ms = time_ms(lambda: dk.fused_mlp_step_plain(*nxt(), eps=lm.rms_norm_eps), 4)
    n_w = sum(lp["mlp"][k]["w_int8"].numel() for k in ("gate", "up", "down"))
    bd = bound(nbytes(*_leaves(lp["mlp"]), lp["pre_ffn_norm"], lp["post_ffn_norm"])
               + 2 * nbytes(x), 2.0 * BATCH * n_w)
    print(f"[fused_mlp_step] kernel {ms:.4f} ms (with the mma.sync product: "
          f"{I8_MMA_SYNC_MS['fused_mlp_step']}), plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']} (on {card})")
    res["fused_mlp_step"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                             "library_ms": None}
    return res


def run_fused_layers(per_layer, cfg, dev, card, stacked_ids, stack_step_ms):
    """50 greedy tokens at batch BATCH through fused_bridge_step ->
    gemma2.decode_step_fused -> int8_matmul_t_argmax, from the per-layer int8
    weights. Returns the two layer kernels' launch counts."""
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops import quant

    lm, bc = cfg.lm, cfg.bridge
    lmp = per_layer["lm"]
    if not gemma2.supports_fused_decode(lmp, lm, NEW_TOKENS + 1):
        raise AssertionError("the per-layer fused decode does not serve VLMConfig.default()")
    vision = full_model.encode_image(per_layer, cfg, seeded_pixels(cfg, dev))
    bst = bridge.stack_bridge_decode_params(per_layer["bridge"], bc)

    def loop(n_tokens):
        """(ids [B, 1 + n], first step's final hidden [B, H], seconds of the
        token loop); the module attributes are looked up at call time, so
        plain_decode() swaps them."""
        bcache = _build_cross_cache(per_layer["bridge"], bc, vision, NEW_TOKENS + 1,
                                    torch.bfloat16, kv_quant=True)
        kv = gemma2.FusedKVCache.zeros(lm, BATCH, NEW_TOKENS + 1, device=dev)
        tok = torch.full((BATCH,), lm.bos_token_id, dtype=torch.int32, device=dev)
        ids, first = [tok], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_tokens):
            emb = gemma2.embed(lmp, tok.long()[:, None]).to(torch.bfloat16)
            x = dk.fused_bridge_step(t, emb[:, 0].contiguous(), bst, bcache.cross_k,
                                     bcache.cross_k_scale, bcache.cross_v, bcache.cross_v_scale,
                                     bcache.self_k, bcache.self_v,
                                     num_heads_cross=bc.num_heads_cross,
                                     num_heads_self=bc.num_heads_self, eps=bc.layer_norm_eps)
            hidden, kv = gemma2.decode_step_fused(lmp, lm, x[:, None, :], kv, t)
            if first is None:
                first = hidden[:, 0].clone()
            tok = quant.int8_matmul_t_argmax(hidden[:, 0].contiguous(), lmp["embedding"])
            ids.append(tok)
        torch.cuda.synchronize()
        return torch.stack(ids, dim=1), first, time.perf_counter() - t0

    wrappers = decode_wrappers()
    with torch.no_grad():
        loop(2)  # warm-up
        for fn in wrappers.values():
            fn.launches = 0
        toks, _, dt = loop(NEW_TOKENS)
        got = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
        want = {"fused_attn_step": lm.num_layers * NEW_TOKENS,
                "fused_mlp_step": lm.num_layers * NEW_TOKENS, "fused_bridge_step": NEW_TOKENS,
                "int8_matmul_t_argmax": NEW_TOKENS}
        print(f"per-layer fused decode launches: {got}")
        if got != want:
            raise AssertionError(f"per-layer fused decode launched {got}, expected {want}")
        toks_c = toks.cpu()
        if not ((toks_c >= 0) & (toks_c < lm.vocab_size)).all():
            raise AssertionError("token ids out of range")
        share = float((toks_c[:, 1:] == stacked_ids[:, 1:]).float().mean())
        first_eq = int((toks_c[:, 1] == stacked_ids[:, 1]).sum())
        print(f"per-layer fused decode: {BATCH} rows x {NEW_TOKENS} tokens in {dt:.3f} s = "
              f"{dt / NEW_TOKENS * 1e3:.3f} ms a token (bridge step, {lm.num_layers} x 2 layer "
              f"calls, {4 * lm.num_layers} cache writes, head; host clock) against "
              f"{stack_step_ms:.4f} ms of device time for the stack step alone; ids equal to "
              f"the stacked path's: first tokens {first_eq} of {BATCH}, all tokens {share:.4f} "
              f"(printed, not required: the residual is bf16 between the calls here and f32 "
              f"there) on {card}")
        ids_k, hidden_k, _ = loop(GREEDY_CHECK_TOKENS)
        before = {n: fn.launches for n, fn in wrappers.items()}
        with plain_decode():
            ids_p, hidden_p, _ = loop(GREEDY_CHECK_TOKENS)
        if {n: fn.launches for n, fn in wrappers.items()} != before:
            raise AssertionError("the plain per-layer fused loop launched a kernel")
        hold_first_step(f"per-layer fused decode, {GREEDY_CHECK_TOKENS} tokens, kernels vs plain "
                        "versions", ids_k.cpu(), ids_p.cpu(),
                        quant.int8_matmul_t_plain(hidden_k, lmp["embedding"]),
                        quant.int8_matmul_t_plain(hidden_p, lmp["embedding"]))
    return {"fused_attn_step": got["fused_attn_step"], "fused_mlp_step": got["fused_mlp_step"]}


def phase_int4_heads(table, dev, gen):
    """int4_matmul_t_argmax and int4_matmul_t on the model's int4 table
    against their plain versions; returns both result rows."""
    from vlm_bridge_tpu_torch.ops import quant

    V, H2 = table["w_int4"].shape
    H = 2 * H2
    x = torch.randn(BATCH, H, generator=gen, device=dev).to(torch.bfloat16)
    # planted tie: vocab rows 1000 and 200000 (different blocks) equal and,
    # aligned with row 5, the winners; row 7 all NaN -> id 0
    tied = {"w_int4": table["w_int4"].clone(), "scale": table["scale"].clone()}
    row = (torch.sign(x[5].float()) * 7).to(torch.int8)
    for v in (1000, 200000):
        tied["w_int4"][v] = quant._pack_nibbles(row[:H2], row[H2:])
        tied["scale"][..., v] = 0.05
    x[7] = float("nan")
    got = quant.int4_matmul_t_argmax(x, tied)
    want = quant.int4_matmul_t_argmax_plain(x, tied)
    y = quant.int4_matmul_t_plain(x, tied)
    torch.cuda.synchronize()
    # ids are equal except where the plain logits' top two lie closer than the
    # logits' own tolerance: either may win between two f32 summation orders
    differ = got != want
    top2 = torch.topk(y.nan_to_num(nan=float("-inf")), 2, dim=-1).values
    gap, lim = top2[:, 0] - top2[:, 1], LOGIT4_TOL * y.abs().nan_to_num(nan=0.0).amax(dim=-1)
    bad = int((differ & ~(gap <= lim)).sum())
    print(f"[int4_matmul_t_argmax] ids differing={int(differ.sum())}, of them outside a near-tie "
          f"(top-2 gap above {LOGIT4_TOL:g} x the row's max logit)={bad} (tolerance 0); "
          f"tie row -> {int(got[5])}, NaN row -> {int(got[7])}")
    if bad or int(got[5]) != 1000 or int(got[7]) != 0:
        raise AssertionError("int4 argmax head disagrees with its plain version")
    ms = time_ms(lambda: quant.int4_matmul_t_argmax(x, tied), 20)
    plain_ms = time_ms(lambda: quant.int4_matmul_t_argmax_plain(x, tied), 3)
    bd = bound(nbytes(tied["w_int4"], tied["scale"], x, got), 2.0 * BATCH * V * H)
    print(f"[int4_matmul_t_argmax] kernel {ms:.4f} ms (the mma.sync tile kernel: "
          f"{HEAD_MMA_SYNC_MS['int4_matmul_t_argmax']}), plain {plain_ms:.4f} ms, "
          f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    res = {"int4_matmul_t_argmax": {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, **bd,
                                    "library_ms": None}}
    del tied, y

    x = torch.randn(BATCH, H, generator=gen, device=dev).to(torch.bfloat16)
    got, want = quant.int4_matmul_t(x, table), quant.int4_matmul_t_plain(x, table)
    torch.cuda.synchronize()
    err = rows_close("int4_matmul_t", got, want, LOGIT4_TOL)
    same_bits("int4_matmul_t", got, quant.int4_matmul_t(x, table))
    ms = time_ms(lambda: quant.int4_matmul_t(x, table), 50)
    plain_ms = time_ms(lambda: quant.int4_matmul_t_plain(x, table), 3)
    bd = bound(nbytes(table["w_int4"], table["scale"], x, got), 2.0 * BATCH * V * H)
    print(f"[int4_matmul_t] kernel {ms:.4f} ms (the mma.sync tile kernel: "
          f"{HEAD_MMA_SYNC_MS['int4_matmul_t']}), plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    res["int4_matmul_t"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                            "library_ms": None}
    return res


def phase_int4_mlp(params, per_layer, cfg, dev, gen, card):
    """int4_mlp, per channel and in groups of INT4_GROUP, against its plain
    version at M = BATCH on every layer's own MLP weights (the first layer's
    twice: the same bits); then the probe:
    PROBE_TOKENS passes over all layers for int4_mlp (both schemes) and
    int8_mlp in turns, device ms per token. Returns (result row, launches
    of the probe)."""
    from vlm_bridge_tpu_torch.ops import quant

    L = cfg.lm.num_layers
    floats = [params["lm"]["layers"][str(i)]["mlp"] for i in range(L)]
    mlps8 = [tuple(per_layer["lm"]["layers"][str(i)]["mlp"][k] for k in ("gate", "up", "down"))
             for i in range(L)]

    def q4(group):
        return [(quant.quantize_int4(m["gate"], group_size=group),
                 quant.quantize_int4(m["up"], group_size=group),
                 quant.repack_down_blockwise(quant.quantize_int4(m["down"], group_size=group),
                                             block_f=PROBE_BLOCK_F)) for m in floats]

    schemes = {"per_channel": q4(None), f"group{INT4_GROUP}": q4(INT4_GROUP)}
    x = torch.randn(BATCH, cfg.lm.hidden_size, generator=gen, device=dev).to(torch.bfloat16)
    m0 = floats[0]
    y32 = ((torch.nn.functional.gelu(x.float() @ m0["gate"].float(), approximate="tanh")
            * (x.float() @ m0["up"].float())) @ m0["down"].float())
    by_scheme, worst = {}, 0.0
    for sname, ws in schemes.items():
        for li, w in enumerate(ws):
            got = quant.int4_mlp(x, *w, block_f=PROBE_BLOCK_F)
            want = quant.int4_mlp_plain(x, *w, block_f=PROBE_BLOCK_F)
            torch.cuda.synchronize()
            worst = max(worst, rows_close(f"int4_mlp {sname} layer {li}", got, want, I8_TOL))
        got = quant.int4_mlp(x, *ws[0], block_f=PROBE_BLOCK_F)
        same_bits(f"int4_mlp {sname}", got, quant.int4_mlp(x, *ws[0], block_f=PROBE_BLOCK_F))
        rel = float((got.float() - y32).norm() / y32.norm())
        nxt = cycle(ws)
        ms = time_ms(lambda: quant.int4_mlp(x, *nxt(), block_f=PROBE_BLOCK_F), 52)
        plain_ms = time_ms(lambda: quant.int4_mlp_plain(x, *nxt(), block_f=PROBE_BLOCK_F), 4)
        wb = sum(nbytes(q["w_int4"], q["scale"]) for q in ws[0])
        bd = bound(wb + nbytes(x, got), 2.0 * BATCH * 2 * sum(q["w_int4"].numel() for q in ws[0]))
        print(f"[int4_mlp] {sname}: kernel {ms:.4f} ms (the mma.sync kernel: "
              f"{INT4_MLP_MMA_SYNC_MS[sname]}), plain {plain_ms:.4f} ms, bound "
              f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; output against the float MLP: "
              f"relative error {rel:.4f}")
        by_scheme[sname] = {"ms": ms, "plain_ms": plain_ms, **bd, "rel_err_vs_float": rel}
    got8 = quant.int8_mlp(x, *mlps8[0])
    print(f"[int8_mlp] output against the float MLP: relative error "
          f"{float((got8.float() - y32).norm() / y32.norm()):.4f}")

    # the probe: every pass streams all layers' weights, as a decode step does
    def token_loop(fn, weights, **kw):
        def run():
            h = x
            for _ in range(PROBE_TOKENS):
                for w in weights:
                    h = (h + 0.01 * fn(h, *w, **kw)).to(torch.bfloat16)
            return h
        return run

    variants = {"int4_mlp per_channel": token_loop(quant.int4_mlp, schemes["per_channel"],
                                                   block_f=PROBE_BLOCK_F),
                f"int4_mlp group{INT4_GROUP}": token_loop(
                    quant.int4_mlp, schemes[f"group{INT4_GROUP}"], block_f=PROBE_BLOCK_F),
                "int8_mlp": token_loop(quant.int8_mlp, mlps8)}
    quant.int4_mlp.launches = 0
    times = {k: [] for k in variants}
    for _ in range(PROBE_REPS):
        for k, run in variants.items():
            # 520 wrapper calls and 1040 element-wise ops a run, ~45 ms of host
            # time: a spin of ~130 ms keeps the host ahead of the card (80M
            # cycles, ~45 ms, timed the host's issuing of the int4 runs)
            times[k].append(time_ms(run, 1, spin_cycles=250_000_000) / PROBE_TOKENS)
    probe_launches = quant.int4_mlp.launches
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"int4 MLP probe, {L} layers x {PROBE_TOKENS} tokens at M = {BATCH}, {PROBE_REPS} "
          f"turns, median device ms per token: "
          + ", ".join(f"{k} {v:.4f}" for k, v in med.items())
          + f"; int8 / int4 per_channel {med['int8_mlp'] / med['int4_mlp per_channel']:.3f}x, "
          f"int8 / int4 group{INT4_GROUP} "
          f"{med['int8_mlp'] / med[f'int4_mlp group{INT4_GROUP}']:.3f}x (on {card})")
    if not all(math.isfinite(v) and v > 0 for v in med.values()):
        raise AssertionError("the probe's times are not positive and finite")
    # the headline numbers are the default recipe's: groups of INT4_GROUP
    head = by_scheme[f"group{INT4_GROUP}"]
    row = {"max_abs_err": worst, **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
           "library_ms": None, "by_scheme": by_scheme,
           "probe_ms_per_token": med}
    return row, probe_launches


def write_synthetic_split(root, n: int, crop: int) -> None:
    """<root>/test: a captions.jsonl manifest of n samples and the pixel
    cache's two files (data/pixel_cache.py), written with numpy alone. The
    image files themselves are absent, which the cache's fingerprint
    records, so VLDataset attaches the memmap and decodes no image."""
    import numpy as np

    from vlm_bridge_tpu_torch.data import pixel_cache

    split = Path(root) / "test"
    split.mkdir(parents=True)
    samples = [{"image_path": f"images/{i:06d}.jpg", "original_id": i,
                "caption": f"a {('red', 'blue', 'green')[i % 3]} shape number {i} on a plain "
                           "background"} for i in range(n)]
    (split / "captions.jsonl").write_text("".join(json.dumps(r) + "\n" for r in samples))
    out = np.lib.format.open_memmap(split / pixel_cache.CACHE_NAME, mode="w+", dtype=np.uint8,
                                    shape=(n, crop, crop, 3))
    out[:] = np.random.default_rng(SEED + 10).integers(0, 256, size=out.shape, dtype=np.uint8)
    out.flush()
    del out
    (split / pixel_cache.META_NAME).write_text(json.dumps(
        {"n": n, "crop": crop,
         "fingerprint": pixel_cache.manifest_fingerprint(split, samples)}))


def run_eval_int4(cfg, dev, card):
    """The int4 serving recipe through the eval harness's own entry point
    (`vlm-eval-torch`): greedy over EVAL_BATCHES batches, then sampled over
    EVAL_SAMPLED_BATCHES. Returns the launch counts of the two runs."""
    from vlm_bridge_tpu_torch.inference import evaluate

    wrappers = decode_wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        n = EVAL_BATCHES * BATCH
        write_synthetic_split(tmp, n, cfg.image_size)
        out = Path(tmp) / "result.json"
        argv = ["--data-dir", tmp, "--split", "test", "--batch-size", str(BATCH),
                "--max-length", str(NEW_TOKENS), "--preset", "default", "--seed", str(SEED),
                "--quantize", "embedding4,mlp,attn,bridge", "--kv-int8", "--mlp-int4",
                "--no-early-stop", "--output", str(out)]
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc = evaluate.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        greedy = {k: fn.launches for k, fn in wrappers.items()}
        res = json.loads(out.read_text())
        print(f"int4 path launches ({EVAL_BATCHES} batches, greedy): "
              f"{ {k: v for k, v in greedy.items() if v} }")
        want = dict.fromkeys(("fused_stack_step", "fused_bridge_step", "int4_matmul_t_argmax"),
                             NEW_TOKENS * EVAL_BATCHES)
        if rc != 0 or {k: v for k, v in greedy.items() if v} != want:
            raise AssertionError(f"int4 path: rc {rc}, launches {greedy}, expected {want}")
        if res["num_samples"] != n or not res["pixel_cache"]:
            raise AssertionError(f"int4 path evaluated {res['num_samples']} of {n} samples, "
                                 f"pixel cache attached: {res['pixel_cache']}")
        m = res["metrics"]
        if not all(math.isfinite(m[k]) for k in ("bleu1", "bleu4", "cider_d")):
            raise AssertionError(f"int4 path metrics not finite: {m}")
        print(f"int4 path through vlm-eval-torch: {n} captions x {NEW_TOKENS} tokens, batch "
              f"{BATCH}: {res['captions_per_sec']:.2f} captions/s end to end in the steady state "
              f"(loader, encode, decode, detokenizing; first batch left out), "
              f"{res['captions_per_sec_incl_first_batch']:.2f} with it; the call took {wall:.1f} s "
              f"with init, quantize and stack; bleu1 {m['bleu1']:.4f} bleu4 {m['bleu4']:.4f} "
              f"cider_d {m['cider_d']:.4f} (random weights) on {card}")

        for fn in wrappers.values():
            fn.launches = 0
        rc = evaluate.main(argv + ["--sample", "--max-samples", str(EVAL_SAMPLED_BATCHES * BATCH)])
        torch.cuda.synchronize()
        sampled = {k: fn.launches for k, fn in wrappers.items()}
        res = json.loads(out.read_text())
        print(f"int4 path launches ({EVAL_SAMPLED_BATCHES} batches, --sample): "
              f"{ {k: v for k, v in sampled.items() if v} }; "
              f"{res['captions_per_sec']:.2f} captions/s end to end (one batch in the steady state)")
        want = dict.fromkeys(("fused_stack_step", "fused_bridge_step", "int4_matmul_t"),
                             NEW_TOKENS * EVAL_SAMPLED_BATCHES)
        if rc != 0 or {k: v for k, v in sampled.items() if v} != want \
                or res["num_samples"] != EVAL_SAMPLED_BATCHES * BATCH:
            raise AssertionError(f"int4 sampled path: rc {rc}, launches {sampled}, expected {want}")
    return {"fused_stack_step[mlp_int4]": greedy["fused_stack_step"],
            "int4_matmul_t_argmax": greedy["int4_matmul_t_argmax"],
            "int4_matmul_t": sampled["int4_matmul_t"]}


def run_generate_int4(served4, cfg, dev, card, gcfg4, int8_rate):
    """generate_tokens alone on the int4 recipe, timed beside the int8 figure
    of this call, and one batch against the plain path."""
    from vlm_bridge_tpu_torch.inference.generate import generate_tokens
    from vlm_bridge_tpu_torch.ops import quant

    pixels = seeded_pixels(cfg, dev)
    generate_tokens(served4, cfg, pixel_values=pixels,
                    gen=dataclasses.replace(gcfg4, max_length=2))
    torch.cuda.synchronize()
    wrappers = decode_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with record_decode_hidden("decode_step_stacked") as hidden_k:
        toks, lens = generate_tokens(served4, cfg, pixel_values=pixels, gen=gcfg4)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {k: fn.launches for k, fn in wrappers.items() if fn.launches}
    want = dict.fromkeys(("fused_stack_step", "fused_bridge_step", "int4_matmul_t_argmax"),
                         NEW_TOKENS)
    if got != want:
        raise AssertionError(f"int4 generate_tokens launches {got}, expected {want}")
    toks_c = check_tokens(toks, lens, cfg, NEW_TOKENS)
    print(f"int4 recipe, generate_tokens alone: {BATCH} captions x {NEW_TOKENS} tokens in "
          f"{dt:.3f} s = {BATCH / dt:.2f} captions/s (encode + decode) against {int8_rate:.2f} "
          f"for the int8 recipe in this call, on {card}")

    with plain_decode(), record_decode_hidden("decode_step_stacked") as hidden_p:
        ref, _ = generate_tokens(served4, cfg, pixel_values=pixels, gen=gcfg4)
    torch.cuda.synchronize()
    if {k: fn.launches for k, fn in wrappers.items() if fn.launches} != want:
        raise AssertionError("the plain int4 path launched a decode kernel")
    table = served4["lm"]["embedding"]
    hold_first_step("int4 recipe against its plain path", toks_c, ref.cpu(),
                    quant.int4_matmul_t_plain(hidden_k[0], table),
                    quant.int4_matmul_t_plain(hidden_p[0], table))


def seeded_pixels(cfg, dev):
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device

    pix_gen = torch.Generator(device=dev)
    pix_gen.manual_seed(SEED + 1)
    pixels_u8 = torch.randint(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3),
                              generator=pix_gen, device=dev, dtype=torch.uint8)
    return normalize_on_device(pixels_u8, dtype=torch.bfloat16)


def check_tokens(toks, lens, cfg, n_tokens):
    """Shape, id range, BOS column and lengths of a generation; returns the
    tokens on the CPU."""
    from vlm_bridge_tpu_torch.inference.generate import _eos_lengths

    toks_c, lens_c = toks.cpu(), lens.cpu()
    if tuple(toks_c.shape) != (BATCH, n_tokens + 1):
        raise AssertionError(f"tokens shape {tuple(toks_c.shape)}")
    if not ((toks_c >= 0) & (toks_c < cfg.lm.vocab_size)).all():
        raise AssertionError("token ids out of range")
    if not (toks_c[:, 0] == cfg.lm.bos_token_id).all():
        raise AssertionError("first column is not BOS")
    if not torch.equal(lens_c, _eos_lengths(toks_c, cfg.lm.eos_token_id)):
        raise AssertionError("lengths disagree with the first EOS")
    return toks_c


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
    spills = ptxas_report(cuda_lib.build_log)
    if spills:
        raise AssertionError(f"ptxas: {spills} spill")

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
        per_layer = dict(params)   # int8 per-layer dicts: what the per-layer path reads
        per_layer["lm"] = gemma2.quantize_params(params["lm"], ("embedding", "mlp", "attn"))
        per_layer["bridge"] = bridge.quantize_decode_params(params["bridge"])
    gcfg = GenerationConfig(max_length=NEW_TOKENS, greedy=True, kv_quant=True, early_stop=False)
    served = prestack_decode_params(per_layer, cfg, gcfg)
    if "stacked_decode" not in served["lm"]:
        raise AssertionError("the int8 stack decode does not serve VLMConfig.default()")
    torch.cuda.synchronize()
    print(f"quantize + stack: {time.perf_counter() - t0:.1f} s; allocated "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    with torch.no_grad():
        results["int8_matmul_t_argmax"] = phase_argmax_head(served, dev, gen)
        results["fused_stack_step"] = phase_stack(served, cfg, dev, gen)
        results["fused_bridge_step"] = phase_bridge(served, cfg, dev, gen)
        serve_launches, int8_rate, default_run = run_serve(served, cfg, dev, card, gcfg)
        launches.update(serve_launches)
        vit_gen = torch.Generator(device=dev)
        vit_gen.manual_seed(SEED + 12)
        mm_rows, launches["tiled_matmul"] = phase_tiled_matmul(params, cfg, dev, vit_gen, card)
        results.update(mm_rows)
        results["layer_norm_fast"] = phase_layer_norm(cfg, dev, vit_gen, card)
        vit_launches = run_vit_kernels(params, served, cfg, dev, card, gcfg, default_run)
        launches.update({k: vit_launches[k] for k in ("tiled_matmul[bias]", "layer_norm_fast")})
        # `launches` of the bias-free row is the probe's counted pass; the encode's own count
        # of that call site (0: run_vit_kernels requires it) stands beside it
        results["tiled_matmul"]["encode_launches"] = vit_launches["tiled_matmul"]
    stacked_ids = default_run[0]
    mlp8_bytes = nbytes(*(served["lm"]["stacked_decode"][k]
                          for k in ("wgu", "gu_scale", "wd", "d_scale")))
    del served
    torch.cuda.empty_cache()

    i8_gen = torch.Generator(device=dev)
    i8_gen.manual_seed(SEED + 9)
    with torch.no_grad():
        results.update(phase_int8_linear(per_layer, cfg, dev, i8_gen))
        results["int8_matmul_t"] = phase_logits_head(per_layer, dev, i8_gen)
        launches.update(run_sample(per_layer, cfg, dev, card))
        results.update(phase_fused_layer(per_layer, cfg, dev, i8_gen, card))
        launches.update(run_fused_layers(per_layer, cfg, dev, card, stacked_ids,
                                         results["fused_stack_step"]["ms"]))
    # the fused token step at Gemma-2-27B's widths (two layers), kernels against plain versions
    g27 = torch.Generator(device=dev)
    g27.manual_seed(SEED + 27)
    with torch.no_grad():
        phase_gemma2_27b_step(dev, g27, card)
    torch.cuda.empty_cache()

    # the int4 recipe, from the same weights: int4 table, int4 MLP weights in the stack
    i4_gen = torch.Generator(device=dev)
    i4_gen.manual_seed(SEED + 11)
    t0 = time.perf_counter()
    with torch.no_grad():
        per_layer4 = dict(per_layer)
        per_layer4["lm"] = {**per_layer["lm"], "embedding": gemma2.quantize_embedding_part(
            params["lm"]["embedding"], ("embedding4",))}
        gcfg4 = dataclasses.replace(gcfg, mlp_int4=True)
        served4 = prestack_decode_params(per_layer4, cfg, gcfg4)
        st4 = served4["lm"]["stacked_decode"]
        mlp4_bytes = nbytes(*(st4[k] for k in ("wgu4", "gu_scale4", "wd4", "d_scale4")))
        torch.cuda.synchronize()
        print(f"int4 table + int4 stack: {time.perf_counter() - t0:.1f} s; stacked MLP fields "
              f"{mlp4_bytes / 1e9:.4f} GB against {mlp8_bytes / 1e9:.4f} GB for the int8 stack "
              f"({mlp4_bytes / mlp8_bytes:.3f}x); table {nbytes(*served4['lm']['embedding'].values()) / 1e9:.4f}"
              f" GB against {nbytes(*per_layer['lm']['embedding'].values()) / 1e9:.4f} GB", flush=True)
        results.update(phase_int4_heads(served4["lm"]["embedding"], dev, i4_gen))
        results["fused_stack_step[mlp_int4]"] = phase_stack(served4, cfg, dev, i4_gen,
                                                            name="fused_stack_step[mlp_int4]")
        run_generate_int4(served4, cfg, dev, card, gcfg4, int8_rate)
        del served4, st4, per_layer4
        torch.cuda.empty_cache()
        results["int4_mlp"], launches["int4_mlp"] = phase_int4_mlp(params, per_layer, cfg, dev,
                                                                   i4_gen, card)
        torch.cuda.empty_cache()
        launches.update(run_eval_int4(cfg, dev, card))
    del per_layer
    torch.cuda.empty_cache()

    flash_gen = torch.Generator(device=dev)
    flash_gen.manual_seed(SEED + 5)
    with torch.no_grad():
        results.update(phase_flash(dev, flash_gen))
    launches.update(run_train(params, cfg, dev, card))

    fa_src, fa_py = "flash_bwd.cu", "vlm_bridge_tpu/ops/flash_attention.py"
    qpy = "vlm_bridge_tpu/ops/quant.py"
    sources = {"int8_matmul_t_argmax": ("tied_head.cu", f"{qpy}:169"),
               "int8_matmul": ("int8_linear.cu", f"{qpy}:74"),
               "int8_matmul_t": ("tied_head.cu", f"{qpy}:133"),
               "int8_mlp": ("int8_linear.cu", f"{qpy}:536"),
               "int8_ffn": ("int8_linear.cu", f"{qpy}:597"),
               "int4_matmul_t": ("tied_head.cu", f"{qpy}:426"),
               "int4_matmul_t_argmax": ("tied_head.cu", f"{qpy}:463"),
               "int4_mlp": ("int8_linear.cu", f"{qpy}:842"),
               "fused_stack_step": ("stack_step.cu", "vlm_bridge_tpu/ops/decode_kernels.py:707"),
               # the same wrapper and C entry with int4 MLP weights: the TPU
               # kernel's mlp4 stage (decode_kernels.py:579), here i4_gemm.cu
               "fused_stack_step[mlp_int4]": ("i4_gemm.cu",
                                              "vlm_bridge_tpu/ops/decode_kernels.py:707"),
               "fused_bridge_step": ("bridge_step.cu",
                                     "vlm_bridge_tpu/ops/decode_kernels.py:1228"),
               "fused_attn_step": ("layer_step.cu", "vlm_bridge_tpu/ops/decode_kernels.py:249"),
               "fused_mlp_step": ("layer_step.cu", "vlm_bridge_tpu/ops/decode_kernels.py:965"),
               # one kernel, both pallas_call sites of _tiled_matmul_jit (:68)
               "tiled_matmul": ("tiled_matmul.cu", "vlm_bridge_tpu/ops/matmul_kernels.py:104"),
               "tiled_matmul[bias]": ("tiled_matmul.cu",
                                      "vlm_bridge_tpu/ops/matmul_kernels.py:93"),
               "layer_norm_fast": ("layer_norm.cu", "vlm_bridge_tpu/ops/norm_kernels.py:46"),
               "flash_attention_fwd": ("flash_fwd.cu", f"{fa_py}:194"),
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
