"""Run the PyTorch port once on one GPU: the int8 greedy caption-serving path,
the kernel-routed vision encode and the int8 vision tower, the sampled
per-layer int8 decode path, the per-layer fused decode, the int4 serving
recipe through the batched eval harness, the bridge train step, the
trainer's entry point with its checkpoints served back, full-width HF
snapshots served, the debug and parity tools, the process group, and tensor
parallelism of the frozen Gemma over two processes sharing the card, every
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
   of each must give the same bits, as must two calls of the int8 and the
   int4 stack steps and of the bridge step at B 64, t 20 (their GEMM core
   sums its stream-K partials in one order).
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
4b'. The per-layer fused decode, on the per-layer int8 weights prepared once
   with their fragment forms (tools/loading.prepare_fused_layers: its extra
   device bytes and seconds): `fused_attn_step` (t = 0, and t = 20 with
   planted large logits) and `fused_mlp_step` against their plain versions,
   a second call's bits, the kernels a call (at most 4 and 3), each timed
   call on another layer's weights; then 50 greedy tokens at batch 64
   through fused_bridge_step -> gemma2.decode_step_fused ->
   int8_matmul_t_argmax (launches 1300 / 1300), the first tokens against the
   same loop on the plain versions, ms a token beside the stack step's, and
   the loop's device-busy share under torch.profiler.
4b''. One fused token step at VLMConfig.gemma2_27b()'s widths, two decoder
   layers: fused_bridge_step -> the stack step -> the greedy head over the
   256000-row table, against the plain versions (rows within HIDDEN_TOL,
   greedy ids equal but for near-ties of the plain logits).
4b'''. The stack step with routed experts at Mellum2-12B-A2.5B's widths (32
   query over 4 KV heads of 128, 64 experts of 896, 8 a row), two layers,
   B 64, against its plain version: the routing logs agree but for
   near-ties (weights within 1e-4), each row routed alike within
   MOE_ROW_TOL of its norm, a second call's bits, 1 + 6 L launches; the
   device ms, launches and bound of moe_route_kernel, both
   moe_expert_kernel launches and stack_attn_kernel at G 8, each a row of
   the `kernels` line.
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
5a. The trainer's entry point (training/orchestrator.py) on the same model:
   execute_full_training over train / val / test splits written with numpy
   (TrainingConfig() defaults, 3 steps, a val split of 16, 4 sample
   captions), then a resumed run to epoch 2 (starts at epoch 1, step 3, the
   restored bridge and AdamW state bit-equal to the saved ones; ends at step
   6). Checks the flash launches of the 6 train steps (6 x 78 / 28 / 28) and
   that eval steps and sample captions reach the forward, train/loss at every
   step in the log read back with read_scalars, the three slots with their
   meta.json, export_pth -> load_pth bit for bit; vlm-eval-torch --checkpoint
   <dir>/best with the int8 recipe over 3 batches of 64 x 50 (early stop on
   and off) against generate_tokens on the in-memory bridge (64 of 64 rows,
   every id); exact mode (f32, greedy, 4 x 16) against the fast per-layer
   path by the first step's logits and the near-tie rule, twice the same
   ids; debug_forward on the trained bridge without NaN or Inf. Prints the
   orchestrator's samples/s beside the bare step's, the epoch's device-busy
   share, slot save / load seconds, exact mode's ms a token and the
   captions/s served from the checkpoint.
5b. HF snapshots (params/hf_loader.py): seeded random f32 weights in the
   published naming (Gemma-2-2B as Gemma2ForCausalLM keys in three shards
   with model.safetensors.index.json, DINOv2-large as Dinov2Model keys at its
   native grid of 37; ~11.7 GB, written with struct + json after a check of
   the room free there, which fails the run if short), then load_from_args
   with --hf-vision-path, --hf-lm-path and the int8 recipe. Checks every
   unquantized leaf bit for bit against the source cast to bf16 (and
   pos_embed_interp_16 against the host's f32 bicubic), the served trees
   (per-layer and stacked) leaf for leaf against the same weights converted in
   memory, greedy serving 64 x 50 on the fused path (the decode kernels 50
   launches each; a second call's final hidden states bit-equal, drift 0, and
   the ids 64 of 64 against the in-memory conversion's) and on the per-layer
   int8 path id for id against the in-memory conversion (64 of 64 rows).
   Prints bytes written and read, seconds and GB/s, captions/s.
5c. vlm-debug-torch on one seeded image (30 traced steps, the strategy sweep,
   the bypass A/B: no NaN / Inf, every strategy answered), ms a traced step;
   vlm-parity-torch record on two seeded images from the snapshot and a .pth
   of the trained bridge, check of that transcript (2/2) and of one with a
   token changed (rc 1). The snapshot is deleted after.
5d. A process group of one over NCCL (parallel.init_multihost): the
   orchestrator's 2 steps and a validation epoch bit-equal to the same run
   without a group, the bridge gradients' all-reduce timed, vlm-eval-torch
   --mesh 1 id for id against the run without --mesh over 2 batches (the
   int8 recipe on the fused path), vlm-caption-torch --mesh 1 over 64 image
   files against the run without --mesh (the same JSONL, captions/s of
   each); the group destroyed; then entry()'s masked-CE forward once.
5e. Tensor parallelism of the frozen Gemma at VLMConfig.default(): two
   processes on the one card in a gloo group (NCCL takes one rank a card),
   the mesh (1, 2), bf16 LM weights cut by parallel.shard_params. Greedy
   64 x 50 on the per-layer path against the same seeded weights in this
   process: the two ranks' ids equal, the first step's logits within
   HIDDEN_TOL of their largest value and a differing first token only on a
   near-tie; captions/s of both and the all-reduce's ms a token; one train
   step at 8 x 256 (same dropout masks), loss within LOSS_RTOL.
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
# a row's error against its norm, where the kernel and the plain version route it
# alike: both read h as bf16 hi + lo, sum in f32 and round the row to bf16 (a
# dropped expert moves a row by some hundredths of its norm)
MOE_ROW_TOL = 1e-2
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
# the training entry point: train steps per epoch, the val split and the
# sample captions of TrainingConfig's validation, eval batches served from the
# checkpoint, exact mode's batch and tokens
ENTRY_STEPS, ENTRY_VAL, ENTRY_SAMPLES, ENTRY_EVAL_BATCHES = 3, 16, 4, 3
EXACT_BATCH, EXACT_TOKENS = 4, 16
# the HF snapshot: Gemma-2-2B's shards and the room asked for beyond the files' bytes;
# the debugger's traced steps, the parity tool's images and tokens; the orchestrator's
# steps and vlm-eval-torch's batches in the process group
HF_LM_SHARDS, HF_ROOM_MARGIN = 3, 2e9
DEBUG_STEPS, PARITY_TOKENS = 30, 20
DIST_STEPS, DIST_EVAL_BATCHES = 2, 2
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
# the fused steps with PR 9's GEMM core summing its stream-K partials by f32
# atomics, on the same card, PERF.md rows 5, 5' (groups of 128) and 7
DECODE_STEP_ATOMIC_MS = {"fused_stack_step": 2.5556, "fused_stack_step[mlp_int4]": 2.9475,
                         "fused_bridge_step": 0.4495}
# launches a fused step may make a layer (a bridge block), past its one
# first norm
STEP_LAUNCH_LIMITS = {"fused_stack_step": 6, "fused_bridge_step": 11}
# kernels a call of a per-layer step may launch
LAYER_STEP_LAUNCH_LIMITS = {"fused_attn_step": 4, "fused_mlp_step": 3}
# the per-layer steps on the int8 product kernel (its decode form) and their
# earlier row kernels, on the same card, PERF.md rows 4 and 6
LAYER_STEP_I8MM_MS = {"fused_attn_step": 0.0473, "fused_mlp_step": 0.0697}
# tokens of each of the two profiled windows of the per-layer fused loop
BUSY_TOKENS = 10
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
              "tiled_matmul_kernel", "layer_norm_kernel", "layer_norm_wide", "layer_attn_kernel",
              "moe_expert_kernel", "moe_route_kernel", "stack_attn_kernel")


# the wgmma kernels: each instantiation must not spill
SPILL_CHECKED = ("tiled_matmul_kernel", "fa_fwd_sm90_kernel", "fa_bwd_dq_sm90_kernel",
                 "fa_bwd_dkv_sm90_kernel", "decode_gemm_kernel", "tied_head_kernel",
                 "i8mm_kernel", "moe_expert_kernel")
FLASH_INSTANCES = tuple(f"{k}ILi{d}E" for k in SPILL_CHECKED[1:4] for d in (64, 128, 256))
# the fused steps' GEMM core (csrc/decode_gemm.cuh): int8 with hi + lo halves,
# int8 with one bf16 half (the per-layer steps), and int4 with waits every
# stage or every half stage (groups of an odd multiple of 32 rows)
GEMM_INSTANCES = ("decode_gemm_kernelILb0ELi4ELi2E", "decode_gemm_kernelILb0ELi4ELi1E",
                  "decode_gemm_kernelILb1ELi4ELi2E", "decode_gemm_kernelILb1ELi2ELi2E",
                  # the same core under the routed experts' name: gate|up, and down by expert
                  "moe_expert_kernelILb0E", "moe_expert_kernelILb1E")
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
    GEMM core's four (and its two under the experts' name) and the tied heads'
    six. Returns the instantiations of the wgmma kernels that spill."""
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


def step_launches(fn, calls: int = 1):
    """Kernels that one call of fn launches on the card, counted by
    torch.profiler over `calls` calls (None where it records no device
    activity; a window of short calls that do not queue behind a spin may
    come back without its first kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if calls > 1:   # the calls queue behind a spin, so that the window holds all of them
            torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if calls > 1:
        n -= 1   # the spin
    if n <= 0:
        return None
    return n if calls == 1 else n / calls


def check_step_launches(name: str, fn, per: int, limit: int) -> Optional[int]:
    """Print one step's launches, per layer (or block) past the first norm's
    one; fail above `limit` a layer."""
    n = step_launches(fn)
    if n is None:
        print(f"[{name}] launches of one step: not measured (the profiler recorded no kernel)")
        return None
    print(f"[{name}] launches of one step: {n}, {(n - 1) / per:.2f} a layer or block past the "
          f"first norm (limit {limit})")
    if n > 1 + limit * per:
        raise AssertionError(f"{name}: {n} launches a step, above {1 + limit * per}")
    return n


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
    # the GEMM core's split sums in one order: a second call (row t written
    # again) gives the same bits
    same_bits(f"{name} at B {BATCH}, t {t}",
              got, dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw))
    n_launch = check_step_launches(
        name, lambda: dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw),
        stacked["wqkv"].shape[0], STEP_LAUNCH_LIMITS["fused_stack_step"])
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
    print(f"[{name}] kernel {ms:.4f} ms (mma.sync core: {DECODE_STEP_MMA_SYNC_MS[name]:.4f}; "
          f"atomic stream-K sums, PRs 9-15: {DECODE_STEP_ATOMIC_MS[name]:.4f}), "
          f"plain {plain_ms:.4f} ms (S={S}, t={t}), bound {bd['bound_ms']:.4f} ms by "
          f"{bd['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None,
            "step_launches": n_launch}


def kernel_device_ms(fn, names, calls: int = 5) -> dict:
    """Mean device ms of one launch of each kernel whose name holds one of
    `names` (torch.profiler over `calls` calls of fn, queued behind a spin),
    and its launches a call; None where the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        times = [e.device_time_total for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
        out[name] = ({"ms": sum(times) / len(times) * 1e-3, "launches": len(times) / calls}
                     if times else None)
    return out


def phase_moe_stack(dev, gen, t=20):
    """The stack step with routed experts at Mellum2-12B-A2.5B's widths
    (hidden 2304, 32 query over 4 KV heads of 128: G 8; 64 experts of 896,
    8 a row), two layers, B 64, seeded random int8 weights, against its plain
    version: the routing logs must agree (k experts a row, weights within
    1e-4) but for near-ties, each row whose routing agrees within MOE_ROW_TOL
    of its norm, a second call's bits equal, and 1 + 6 L launches. Returns
    the step's row and one row for each of its kernels (moe_route_kernel,
    both moe_expert_kernel launches, stack_attn_kernel at G 8): device ms a
    launch, launches a step and the bound of the work each must do."""
    from vlm_bridge_tpu_torch.configs import Gemma2MoEConfig
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm = dataclasses.replace(Gemma2MoEConfig.mellum2_12b(), num_layers=2, vocab_size=512)
    L, H, E, F, k = 2, lm.hidden_size, lm.num_experts, lm.moe_intermediate_size, 8
    lq = gemma2.quantize_params(gemma2.init(lm, generator=gen, device=dev))
    for lp in lq["layers"].values():   # norms away from their zero init
        for n in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm"):
            lp[n] = (torch.randn(H, generator=gen, device=dev) * 0.1).to(lp[n].dtype)
    stacked = gemma2.stack_decode_params(lq, lm)
    cache = gemma2.StackedKVCache.zeros(lm, BATCH, NEW_TOKENS + 1, device=dev)
    cache.k[:, :, :, :t] = torch.randint(-127, 128, cache.k[:, :, :, :t].shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    cache.v[:, :, :, :t] = torch.randint(-127, 128, cache.v[:, :, :, :t].shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    cache.k_scale[..., :t] = 0.02 + 0.01 * torch.rand(cache.k_scale[..., :t].shape,
                                                      generator=gen, device=dev)
    cache.v_scale[..., :t] = 0.02 + 0.01 * torch.rand(cache.v_scale[..., :t].shape,
                                                      generator=gen, device=dev)
    x = (torch.randn(BATCH, H, generator=gen, device=dev) * 0.02 * H ** 0.5).to(torch.bfloat16)
    cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev),
                                                      lm.head_dim, lm.rope_theta))
    kw = dict(num_heads=lm.num_heads, num_kv_heads=lm.num_kv_heads, head_dim=lm.head_dim,
              attn_scale=lm.attn_scale, softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps,
              experts_per_token=k, norm_topk_prob=True)
    ck = [c.clone() for c in cache]
    cp = [c.clone() for c in cache]
    name = "fused_stack_step[moe]"
    got = dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw)
    klog = dk.moe_route_log()[t].clone()
    want = dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw)
    plog = dk.moe_route_log()[t].clone()
    torch.cuda.synchronize()
    if not (((klog > 0).sum(-1) == k).all() and ((plog > 0).sum(-1) == k).all()):
        raise AssertionError(f"{name}: a row routed to other than {k} experts")
    agree = ((klog > 0) == (plog > 0)).all(-1)               # [L, B]
    w_err = float((klog - plog)[agree].abs().max())
    rows = agree.all(0)
    rel = ((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1))[rows]
    err = float(rel.max())
    print(f"[{name}] routing agrees in {int(agree.sum())} of {agree.numel()} (layer, row) "
          f"(near-ties aside), weights within {w_err:.3g}; rows routed alike: "
          f"{int(rows.sum())} of {BATCH}, largest error {err:.4g} of the row's norm "
          f"(tol {MOE_ROW_TOL})")
    if int((~agree).sum()) > max(1, agree.numel() // 20) or w_err > 1e-4 or err > MOE_ROW_TOL:
        raise AssertionError(f"{name} disagrees with its plain version")
    same_bits(f"{name} at B {BATCH}, t {t}", got,
              dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw))

    def call():
        return dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw)

    n_launch = check_step_launches(name, call, L, STEP_LAUNCH_LIMITS["fused_stack_step"])
    ms = time_ms(call, 10)
    plain_ms = time_ms(lambda: dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw), 3)
    B, NH, KH, D = BATCH, lm.num_heads, lm.num_kv_heads, lm.head_dim
    live = sum(nbytes(c) for c in cache) * (t + 1) // cache.k.shape[3]
    n_w = sum(stacked[n].numel() for n in ("wqkv", "wo", "ewgu", "ewd"))
    rows_hl = 2 * 2 * B * H            # a product's rows in, bf16 hi + lo
    bounds = {   # (bytes, operations) of one launch of each kernel
        "moe_route_kernel": (4 * H * E + rows_hl + 4 * B * E * 3, 2.0 * B * H * E),
        "moe_expert_kernel<false>": (H * 2 * E * F + 4 * 2 * E * F + rows_hl + 2 * 2 * B * E * F,
                                     2.0 * B * H * 2 * E * F),
        "moe_expert_kernel<true>": (E * F * H + 4 * E * H + 2 * 2 * B * E * F + 4 * B * H,
                                    2.0 * B * E * F * H),
        "stack_attn_kernel": (live // L + 4 * B * (NH + 2 * KH) * D + 2 * 2 * B * NH * D,
                              4.0 * B * NH * D * (t + 1))}
    by_kernel = kernel_device_ms(call, list(bounds))   # the profiler's names are demangled
    rows_out = {}
    for label in bounds:
        bd = bound(*bounds[label])
        got_ms = by_kernel[label]
        rows_out[label] = {"ms": got_ms and got_ms["ms"], "launches": got_ms and got_ms["launches"],
                           **bd, "max_abs_err": None, "plain_ms": None, "library_ms": None}
        print(f"[{name}] {label}: "
              + (f"{got_ms['ms']:.4f} ms a launch, {got_ms['launches']:g} a step"
                 if got_ms else "not measured (the profiler recorded no such kernel)")
              + f", bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    bd = bound(nbytes(*stacked.values()) + live + 2 * nbytes(x), 2.0 * B * n_w)
    print(f"[{name}] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (L {L}, B {B}, S "
          f"{cache.k.shape[3]}, t {t}), bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} (all "
          f"{E} experts: the products read every expert)")
    rows_out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                      "library_ms": None, "launches": n_launch}
    return rows_out


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
    same_bits(f"fused_bridge_step at B {BATCH}, t {t}",
              got, dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw))
    n_launch = check_step_launches(
        "fused_bridge_step", lambda: dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw),
        bst["wq"].shape[0], STEP_LAUNCH_LIMITS["fused_bridge_step"])
    ms = time_ms(lambda: dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw), 10)
    plain_ms = time_ms(lambda: dk.fused_bridge_step_plain(t, x, bst, *cross, pk, pv, **kw), 3)
    # every stacked weight and the cross cache once, the t + 1 live self rows, x in and out
    live = nbytes(sk, sv) * (t + 1) // sk.shape[3]
    n_w = sum(bst[k].numel() for k in ("wq", "wo_c", "wqkv", "wo_s", "fc1", "fc2"))
    bd = bound(nbytes(*bst.values(), *cross) + live + 2 * nbytes(x), 2.0 * BATCH * n_w)
    name = "fused_bridge_step"
    print(f"[{name}] kernel {ms:.4f} ms (mma.sync core: {DECODE_STEP_MMA_SYNC_MS[name]:.4f}; "
          f"atomic stream-K sums, PRs 9-15: {DECODE_STEP_ATOMIC_MS[name]:.4f}), plain "
          f"{plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd, "library_ms": None,
            "step_launches": n_launch}


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


def build_train_case(params, cfg, dev, mesh=None):
    """The train path's inputs and step functions: TrainingConfig() defaults,
    TRAIN_BATCH seeded uint8 images x TRAIN_SEQ ids with ragged lengths.
    mesh: the steps' mesh (a model axis: the batch is every rank's)."""
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
            "train_step": ts.make_train_step(cfg, tc, opt, schedule, mesh=mesh),
            "eval_step": ts.make_eval_step(cfg, tc, mesh=mesh)}


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
    return launches, TRAIN_BATCH / mean_ms * 1e3


@contextlib.contextmanager
def counting_phases(counters, phases: dict, name: str, owner, attr: str):
    """Within this block owner.attr (a step or generate function) adds the
    launches of `counters` it makes to phases[name]."""
    fn = getattr(owner, attr)

    def run(*args, **kwargs):
        before = [c.launches for c in counters]
        out = fn(*args, **kwargs)
        got = [c.launches - b for c, b in zip(counters, before)]
        phases[name] = [a + b for a, b in zip(phases.get(name, [0] * len(counters)), got)]
        return out

    setattr(owner, attr, run)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def device_busy(fn):
    """(wall ms, device-busy ms, {kernel: device ms}) of fn() under
    torch.profiler, recording the card's activity only: recording the host's
    ops as well slows a launch-bound loop several times over."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA}
    return wall, sum(by.values()), by


def run_training_entry(params, cfg, dev, card, bare_rate):
    """The trainer's entry point at full width: execute_full_training on
    numpy-written train / val / test splits (TrainingConfig() defaults, 3
    steps, a val split of 16 and 4 sample captions), then a resumed run to
    epoch 2; the flash launches of the 6 train steps, the log, the three
    slots, .pth export; the best slot served by vlm-eval-torch --checkpoint
    against generate_tokens on the in-memory bridge (64 of 64 rows, every
    id); exact mode against the fast per-layer path and debug_forward on the
    trained bridge. `params` is the model run_train used (its f32 bridge is
    the master copy the orchestrator trains in place). Returns the flash
    kernels' launches in the 6 train steps."""
    import numpy as np

    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.data.loader import VLDataset
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
    from vlm_bridge_tpu_torch.inference import evaluate
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.params import torch_bridge
    from vlm_bridge_tpu_torch.runtime.tb_writer import read_scalars
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params
    from vlm_bridge_tpu_torch.training import orchestrator as orch
    from vlm_bridge_tpu_torch.training import train_step as ts

    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    def cpu_tree(tree):
        return ts.tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
    n_eval = ENTRY_EVAL_BATCHES * BATCH
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_synthetic_split(root, 4 * TRAIN_BATCH, cfg.image_size, "train", repeat=5)
        write_synthetic_split(root, ENTRY_VAL, cfg.image_size, "val", repeat=5)
        write_synthetic_split(root, n_eval, cfg.image_size, "test")
        tc = TrainingConfig(data_dir=str(root), checkpoint_dir=str(root / "ckpt"),
                            log_dir=str(root / "logs"), max_steps_per_epoch=ENTRY_STEPS,
                            num_epochs=1, log_every_n_steps=1,
                            num_validation_samples=ENTRY_SAMPLES)
        store_times = {"save": [], "load": []}
        phases = {}

        def train(tc, resume=False):
            ctx = orch.prepare_environment(tc, params=params)
            for op in ("save", "load"):
                fn = getattr(ctx.store, op)

                def timed(*a, _fn=fn, _op=op, **kw):
                    t0 = time.perf_counter()
                    out = _fn(*a, **kw)
                    store_times[_op].append(time.perf_counter() - t0)
                    return out
                setattr(ctx.store, op, timed)
            if resume:   # what execute_full_training will load, checked first
                orch.load_checkpoint(ctx, tc.resume_from_checkpoint)
            with counting_phases(counters, phases, "train", ctx, "train_step"), \
                    counting_phases(counters, phases, "eval", ctx, "eval_step"), \
                    counting_phases(counters, phases, "samples", orch, "generate_tokens"):
                for fn in counters:
                    fn.launches = 0
                res = orch.execute_full_training(tc, ctx=ctx)
                torch.cuda.synchronize()
            return ctx, res

        ctx, res = train(tc)
        if res["epochs_run"] != 1 or ctx.state.step != ENTRY_STEPS:
            raise AssertionError(f"first run: {res['epochs_run']} epochs, step {ctx.state.step}")
        saved_bridge = cpu_tree(ctx.state.bridge_params)
        saved_opt = cpu_tree(ctx.opt.state_dict(ctx.state.opt_state, ctx.state.bridge_params))
        del ctx, res
        torch.cuda.empty_cache()

        tc2 = dataclasses.replace(tc, num_epochs=2, resume_from_checkpoint="latest")
        ctx = orch.prepare_environment(tc2, params=params)
        orch.load_checkpoint(ctx, "latest")
        if (ctx.start_epoch, ctx.state.step) != (1, ENTRY_STEPS):
            raise AssertionError(f"resume starts at epoch {ctx.start_epoch}, step {ctx.state.step}")
        restored = ctx.opt.state_dict(ctx.state.opt_state, ctx.state.bridge_params)
        same = all(torch.equal(a.cpu(), b) for a, b in zip(ts.tree_leaves(restored),
                                                           ts.tree_leaves(saved_opt)))
        same &= all(torch.equal(a.detach().cpu(), b) for a, b in zip(
            ts.tree_leaves(ctx.state.bridge_params), ts.tree_leaves(saved_bridge)))
        print(f"[training entry] resumed at epoch {ctx.start_epoch}, step {ctx.state.step}; "
              f"bridge, AdamW moments, step and counts bit-equal to the saved ones: {same}")
        if not same:
            raise AssertionError("the restored optimizer state or bridge differs from the "
                                 "saved one")
        del ctx, restored
        busy = {}
        real_epoch = orch.run_training_epoch

        def profiled_epoch(ctx, epoch):
            out = [None]

            def go():
                out[0] = real_epoch(ctx, epoch)
            busy["wall"], busy["busy"], _ = device_busy(go)
            return out[0]
        orch.run_training_epoch = profiled_epoch
        try:
            ctx, res = train(tc2, resume=True)
        finally:
            orch.run_training_epoch = real_epoch
        if res["epochs_run"] != 1 or ctx.state.step != 2 * ENTRY_STEPS:
            raise AssertionError(f"resumed run: {res['epochs_run']} epochs, step {ctx.state.step}")

        per_step = expected_flash_launches(cfg, tc)
        want = [2 * ENTRY_STEPS * per_step[fn.__name__] for fn in counters]
        print(f"[training entry] flash launches (fwd, dq, dk/dv): train steps {phases['train']} "
              f"(expected {want}), eval steps {phases['eval']}, validation samples "
              f"{phases['samples']}")
        if phases["train"] != want or not phases["eval"][0] > 0 or not phases["samples"][0] > 0:
            raise AssertionError("the orchestrator's steps did not reach the flash kernels as "
                                 "the configuration implies")

        scalars = {}
        for f in sorted((root / "logs").glob("events.out.tfevents.*")):
            for tag, rows in read_scalars(f).items():
                scalars.setdefault(tag, []).extend(rows)
        losses = dict(scalars["train/loss"])
        if sorted(losses) != list(range(1, 2 * ENTRY_STEPS + 1)) or not all(
                math.isfinite(v) for v in losses.values()):
            raise AssertionError(f"train/loss in the log: {scalars['train/loss']}")
        for slot in ("latest", "best", "best_weights_only"):
            if not (root / "ckpt" / slot / "meta.json").exists():
                raise AssertionError(f"slot {slot} or its meta.json is missing")
        # the best slot holds the bridge of the epoch it names: epoch 0's (saved
        # after the first run) or, if epoch 1 improved, the one in memory now
        meta = json.loads((root / "ckpt" / "best" / "meta.json").read_text())
        if meta["epoch"] == 1:
            saved_bridge = cpu_tree(ctx.state.bridge_params)
        best, _ = ctx.store.load("best", template={"bridge_params": ctx.state.bridge_params})
        best_is_saved = all(torch.equal(a.cpu(), b) for a, b in zip(
            ts.tree_leaves(best["bridge_params"]), ts.tree_leaves(saved_bridge)))
        print(f"[training entry] best slot: {meta}")
        if meta["epoch"] not in (0, 1) or not best_is_saved:
            raise AssertionError(f"best slot: {meta}, equal to that epoch's bridge: "
                                 f"{best_is_saved}")
        ctx.store.export_pth("best", cfg.bridge, root / "bridge.pth")
        back = torch_bridge.load_pth(root / "bridge.pth", cfg.bridge, device=dev)
        pth_same = all(torch.equal(a, b) for a, b in zip(ts.tree_leaves(back),
                                                         ts.tree_leaves(best["bridge_params"])))
        sps = {k: [v for _, v in scalars[k]] for k in ("epoch/samples_per_sec",
                                                       "epoch/samples_per_sec_steady")}
        print(f"[training entry] train/loss at steps 1-{2 * ENTRY_STEPS}: "
              f"{[round(losses[k], 4) for k in sorted(losses)]}; slots latest / best / "
              f"best_weights_only with meta.json; export_pth -> load_pth bit for bit: {pth_same}")
        print(f"[training entry] orchestrator, batch {TRAIN_BATCH} x 256 tokens: "
              f"epoch/samples_per_sec {sps['epoch/samples_per_sec']} (epoch wall clock: "
              f"loader, {ENTRY_STEPS} steps, the loss fetch), samples_per_sec_steady "
              f"{sps['epoch/samples_per_sec_steady']} (fenced windows; the second epoch "
              f"ran under torch.profiler, the card's activity only), against the bare step's "
              f"{bare_rate:.2f} "
              f"samples/s in run_train; the resumed epoch under torch.profiler: device busy "
              f"{busy['busy']:.1f} ms of {busy['wall']:.1f} ms = "
              f"{100 * busy['busy'] / busy['wall']:.1f} %; slot save "
              f"{[round(t, 3) for t in store_times['save']]} s (each save of the two runs in "
              f"order: latest, then best and best_weights_only when the epoch improved), slot "
              f"load {[round(t, 3) for t in store_times['load']]} s (full, full, weights only), "
              f"on {card}")
        if not pth_same:
            raise AssertionError("export_pth -> load_pth does not give the best slot's bridge")

        # vlm-eval-torch --checkpoint <dir>/best against generate_tokens on the
        # bridge of that epoch as it was in memory, quantized the same way
        frozen = ctx.frozen
        del ctx, res, back
        torch.cuda.empty_cache()
        recorded = []
        real_generate = evaluate.generate_tokens

        def recording(*a, **kw):
            out = real_generate(*a, **kw)
            if not recorded:
                recorded.append(out[0].cpu())
            return out

        rates = {}
        evaluate.generate_tokens = recording
        try:
            for early_stop in ("--early-stop", "--no-early-stop"):
                out = root / f"eval{early_stop}.json"
                recorded.clear()
                rc = evaluate.main([
                    "--data-dir", tmp, "--split", "test", "--batch-size", str(BATCH),
                    "--max-length", str(NEW_TOKENS), "--preset", "default", "--seed", str(SEED),
                    "--checkpoint", str(root / "ckpt" / "best"),
                    "--quantize", "embedding,mlp,attn,bridge", "--kv-int8", early_stop,
                    "--output", str(out)])
                torch.cuda.synchronize()
                r = json.loads(out.read_text())
                if rc != 0 or r["num_samples"] != n_eval:
                    raise AssertionError(f"vlm-eval-torch --checkpoint: rc {rc}, {r}")
                rates[early_stop] = r["captions_per_sec"]
                ids_ckpt = recorded[0]
        finally:
            evaluate.generate_tokens = real_generate
        with torch.no_grad():
            trained = ts.tree_map(lambda t: t.to(dev), saved_bridge)
            served = {**frozen, "lm": gemma2.quantize_params(frozen["lm"],
                                                             ("embedding", "mlp", "attn")),
                      "bridge": bridge.quantize_decode_params(trained)}
            gcfg = GenerationConfig(max_length=NEW_TOKENS, greedy=True, kv_quant=True)
            served = prestack_decode_params(served, cfg, gcfg)
            ds = VLDataset(tmp, "test")
            pixels_u8 = torch.from_numpy(np.array(ds.pixels[:BATCH])).to(dev)
            ids_mem, _ = generate_tokens(served, cfg, gen=gcfg, pixel_values=normalize_on_device(
                pixels_u8, dtype=torch.bfloat16))
            ids_mem = ids_mem.cpu()
            del served
            torch.cuda.empty_cache()
        rows_eq = int((ids_ckpt == ids_mem).all(dim=1).sum())
        print(f"[training entry] vlm-eval-torch --checkpoint best (int8 recipe, {n_eval} "
              f"captions x {NEW_TOKENS} tokens, batch {BATCH}): "
              f"{rates['--early-stop']:.2f} captions/s with early stop, "
              f"{rates['--no-early-stop']:.2f} without (steady state, first batch left out); "
              f"ids equal to generate_tokens on the in-memory bridge in {rows_eq} of {BATCH} rows, "
              f"on {card}")
        if rows_eq != BATCH:
            raise AssertionError("the checkpoint served by vlm-eval-torch decodes other ids than "
                                 "the in-memory bridge")

        # exact mode (f32 activations, the reference attention by request) against
        # the fast per-layer path, and debug_forward, on the trained bridge
        with torch.no_grad():
            params_t = {**frozen, "bridge": trained}
            pix = normalize_on_device(pixels_u8[:EXACT_BATCH], dtype=torch.float32)
            exact = GenerationConfig(max_length=EXACT_TOKENS, greedy=True, exact=True)
            hidden_seen = []
            real_fh = gemma2.forward_hidden

            def recording_fh(*a, **kw):
                h = real_fh(*a, **kw)
                hidden_seen.append(h[:, 0].clone())
                return h
            gemma2.forward_hidden = recording_fh
            try:
                before = [fn.launches for fn in counters]
                t0 = time.perf_counter()
                toks_x, lens_x = generate_tokens(params_t, cfg, pixel_values=pix, gen=exact)
                torch.cuda.synchronize()
                exact_ms = (time.perf_counter() - t0) * 1e3 / EXACT_TOKENS
                toks_x2, _ = generate_tokens(params_t, cfg, pixel_values=pix, gen=exact)
            finally:
                gemma2.forward_hidden = real_fh
            if [fn.launches for fn in counters] != before:
                raise AssertionError("exact mode launched a flash kernel")
            logits_x = gemma2.logits_from_hidden(frozen["lm"], cfg.lm,
                                                 hidden_seen[0][:, None])[:, 0]
            fast = GenerationConfig(max_length=EXACT_TOKENS, greedy=True)
            with record_decode_hidden("decode_step") as hidden_f:
                toks_f, _ = generate_tokens(params_t, cfg, gen=fast, pixel_values=pix.to(
                    torch.bfloat16))
            logits_f = gemma2.logits_from_hidden(frozen["lm"], cfg.lm, hidden_f[0][:, None])[:, 0]
            print(f"[training entry] exact mode, batch {EXACT_BATCH} x {EXACT_TOKENS} tokens, "
                  f"f32: {exact_ms:.2f} ms a token on {card}; two calls give the same ids: "
                  f"{bool(torch.equal(toks_x, toks_x2))}")
            check_tokens(toks_x, lens_x, cfg, EXACT_TOKENS, rows=EXACT_BATCH)
            if not torch.equal(toks_x, toks_x2):
                raise AssertionError("exact mode gave other ids on a second call")
            hold_first_step("exact mode against the fast per-layer path", toks_x.cpu(),
                            toks_f.cpu(), logits_x.float(), logits_f.float())
            text = gemma2.embed(frozen["lm"], toks_x.long()).float()
            vision = full_model.encode_image(params_t, cfg, pix, reference_attention=True)
            _, stats = bridge.debug_forward(trained, cfg.bridge, text, vision)
            anomaly = bridge.has_anomaly(stats)
            print(f"[training entry] debug_forward on the trained bridge: has_anomaly {anomaly}; "
                  f"block_1 after_ffn mean {float(stats['block_1']['after_ffn']['mean']):.4g} "
                  f"std {float(stats['block_1']['after_ffn']['std']):.4g}; "
                  f"{bridge.num_params(trained):,} bridge parameters")
            if anomaly:
                raise AssertionError("debug_forward found a NaN or an Inf in the trained bridge")
    return {fn.__name__: n for fn, n in zip(counters, phases["train"])}


# ---------------------------------------------------------------------------
# HF snapshots, the diagnostic tools and the process group
# ---------------------------------------------------------------------------


def write_safetensors(path, tensors: dict) -> int:
    """CPU tensors (name -> tensor) as one .safetensors file: an 8-byte
    little-endian header length, the JSON header (dtype, shape, byte
    offsets), then the raw bytes in order. Returns the bytes written."""
    import os
    import struct

    names = {torch.float32: "F32", torch.bfloat16: "BF16", torch.float16: "F16"}
    header, at = {}, 0
    for name, t in tensors.items():
        size = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + size]}
        at += size
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for t in tensors.values():
            f.write(t.contiguous().reshape(-1).view(torch.uint8).numpy().data)
        f.flush()
        os.fsync(f.fileno())
    return 8 + len(head) + at


def hf_source(cfg, dev):
    """Seeded random f32 state dicts of the published Gemma2ForCausalLM and
    Dinov2Model naming at cfg's widths, drawn on the card, held on the host:
    weights N(0, 0.02), norms, biases and LayerScales N(0, 0.1)."""
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 15)

    def w(*shape, std=0.02):
        return (torch.randn(*shape, generator=g, device=dev) * std).cpu()

    lm, v = cfg.lm, cfg.vision
    H, hd, I = lm.hidden_size, lm.head_dim, lm.intermediate_size
    src_lm = {"model.embed_tokens.weight": w(lm.vocab_size, H)}
    for i in range(lm.num_layers):
        p = f"model.layers.{i}."
        for n in ("input_layernorm", "post_attention_layernorm", "pre_feedforward_layernorm",
                  "post_feedforward_layernorm"):
            src_lm[p + n + ".weight"] = w(H, std=0.1)
        src_lm[p + "self_attn.q_proj.weight"] = w(lm.num_heads * hd, H)
        src_lm[p + "self_attn.k_proj.weight"] = w(lm.num_kv_heads * hd, H)
        src_lm[p + "self_attn.v_proj.weight"] = w(lm.num_kv_heads * hd, H)
        src_lm[p + "self_attn.o_proj.weight"] = w(H, lm.num_heads * hd)
        src_lm[p + "mlp.gate_proj.weight"] = w(I, H)
        src_lm[p + "mlp.up_proj.weight"] = w(I, H)
        src_lm[p + "mlp.down_proj.weight"] = w(H, I)
    src_lm["model.norm.weight"] = w(H, std=0.1)
    h, P = v.hidden_size, v.patch_size
    src_v = {"embeddings.cls_token": w(1, 1, h), "embeddings.mask_token": w(1, h),
             "embeddings.position_embeddings": w(1, v.native_grid ** 2 + 1, h),
             "embeddings.patch_embeddings.projection.weight": w(h, v.num_channels, P, P),
             "embeddings.patch_embeddings.projection.bias": w(h, std=0.1)}
    for i in range(v.num_layers):
        p = f"encoder.layer.{i}."
        for n in ("norm1", "norm2"):
            src_v[p + n + ".weight"] = 1 + w(h, std=0.1)
            src_v[p + n + ".bias"] = w(h, std=0.1)
        for n in ("query", "key", "value"):
            src_v[p + f"attention.attention.{n}.weight"] = w(h, h)
            src_v[p + f"attention.attention.{n}.bias"] = w(h, std=0.1)
        src_v[p + "attention.output.dense.weight"] = w(h, h)
        src_v[p + "attention.output.dense.bias"] = w(h, std=0.1)
        src_v[p + "layer_scale1.lambda1"] = w(h, std=0.1)
        src_v[p + "mlp.fc1.weight"] = w(h * v.mlp_ratio, h)
        src_v[p + "mlp.fc1.bias"] = w(h * v.mlp_ratio, std=0.1)
        src_v[p + "mlp.fc2.weight"] = w(h, h * v.mlp_ratio)
        src_v[p + "mlp.fc2.bias"] = w(h, std=0.1)
        src_v[p + "layer_scale2.lambda1"] = w(h, std=0.1)
    src_v["layernorm.weight"] = 1 + w(h, std=0.1)
    src_v["layernorm.bias"] = w(h, std=0.1)
    return src_lm, src_v


def hf_expected(src_lm, src_v, cfg) -> dict:
    """Every float leaf of the served tree that --quantize
    embedding,mlp,attn,bridge leaves as it is (the LM's norms, the whole
    vision tower), path -> the source tensor cast to bf16, derived here from
    the published naming; pos_embed_interp_{grid} is HF's f32 bicubic
    (F.interpolate, A = -0.75) on the host, then cast."""
    def bf(t):
        return t.to(torch.bfloat16)

    want = {("lm", "final_norm"): bf(src_lm["model.norm.weight"])}
    norms = {"input_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
             "pre_ffn_norm": "pre_feedforward_layernorm",
             "post_ffn_norm": "post_feedforward_layernorm"}
    for i in range(cfg.lm.num_layers):
        for k, n in norms.items():
            want[("lm", "layers", str(i), k)] = bf(src_lm[f"model.layers.{i}.{n}.weight"])
    v, vc = src_v, cfg.vision
    pos = v["embeddings.position_embeddings"]
    grid, n, h = cfg.image_size // vc.patch_size, vc.native_grid, vc.hidden_size
    patch = torch.nn.functional.interpolate(
        pos[:, 1:].reshape(1, n, n, h).permute(0, 3, 1, 2), size=(grid, grid), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).reshape(1, grid * grid, h)
    want.update({
        ("vision", "patch_embed", "kernel"):
            bf(v["embeddings.patch_embeddings.projection.weight"].permute(2, 3, 1, 0)),
        ("vision", "patch_embed", "bias"): bf(v["embeddings.patch_embeddings.projection.bias"]),
        ("vision", "cls_token"): bf(v["embeddings.cls_token"]),
        ("vision", "pos_embed"): bf(pos),
        ("vision", f"pos_embed_interp_{grid}"): bf(torch.cat([pos[:, :1], patch], dim=1)),
        ("vision", "final_norm", "scale"): bf(v["layernorm.weight"]),
        ("vision", "final_norm", "bias"): bf(v["layernorm.bias"])})
    for i in range(vc.num_layers):
        p, a, L = f"encoder.layer.{i}.", f"encoder.layer.{i}.attention.attention.", (
            "vision", "layers", str(i))
        for k in ("norm1", "norm2"):
            want[L + (k, "scale")] = bf(v[p + k + ".weight"])
            want[L + (k, "bias")] = bf(v[p + k + ".bias"])
        want[L + ("attn", "qkv")] = bf(torch.cat(
            [v[a + k + ".weight"].t() for k in ("query", "key", "value")], dim=1))
        want[L + ("attn", "qkv_bias")] = bf(torch.cat(
            [v[a + k + ".bias"] for k in ("query", "key", "value")]))
        want[L + ("attn", "o")] = bf(v[p + "attention.output.dense.weight"].t())
        want[L + ("attn", "o_bias")] = bf(v[p + "attention.output.dense.bias"])
        for k in ("fc1", "fc2"):
            want[L + ("mlp", k)] = bf(v[p + f"mlp.{k}.weight"].t())
            want[L + ("mlp", k + "_bias")] = bf(v[p + f"mlp.{k}.bias"])
        want[L + ("layerscale1",)] = bf(v[p + "layer_scale1.lambda1"])
        want[L + ("layerscale2",)] = bf(v[p + "layer_scale2.lambda1"])
    return want


def float_leaves(tree, path=()):
    """(path, tensor) of every tensor leaf outside an int8 / int4 dict."""
    if isinstance(tree, dict):
        if "w_int8" in tree or "w_int4" in tree:
            return
        for k, v in tree.items():
            yield from float_leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def all_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from all_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def run_hf_snapshot(snap: Path, cfg, dev, card):
    """A full-width snapshot of seeded random weights in the published naming
    and dtype (Gemma-2-2B as Gemma2ForCausalLM keys in three f32 shards with
    an index, DINOv2-large as Dinov2Model keys in f32 at its native grid of
    37) written under `snap`, then load_from_args with --hf-vision-path,
    --hf-lm-path and the int8 recipe: the unquantized leaves bit for bit
    against the source cast to bf16, pos_embed_interp_16 against the host's
    f32 bicubic, the served trees leaf for leaf against the same weights
    converted in memory, greedy serving (64 x 50) on the fused path timed,
    called twice (the same final hidden states, bit for bit) and id for id
    against the in-memory conversion, and on the per-layer path id for id
    against it too. Returns the snapshot's two directories."""
    import argparse
    import shutil

    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
    from vlm_bridge_tpu_torch.params import hf_loader
    from vlm_bridge_tpu_torch.tools.loading import (add_model_args, load_from_args,
                                                    prestack_decode_params)

    src_lm, src_v = hf_source(cfg, dev)
    need = nbytes(*src_lm.values(), *src_v.values())
    free = shutil.disk_usage(snap).free
    print(f"[hf snapshot] {need / 1e9:.3f} GB of f32 tensors to write under {snap}, "
          f"{free / 1e9:.1f} GB free there", flush=True)
    if free < need + HF_ROOM_MARGIN:
        raise AssertionError(f"too little room for the snapshot: {free / 1e9:.1f} GB free, "
                             f"{(need + HF_ROOM_MARGIN) / 1e9:.1f} GB needed")
    lm_dir, v_dir = snap / "gemma-2-2b", snap / "dinov2-large"
    lm_dir.mkdir()
    v_dir.mkdir()
    t0 = time.perf_counter()
    written = write_safetensors(v_dir / "model.safetensors", src_v)
    per_shard, shard, shards = nbytes(*src_lm.values()) // HF_LM_SHARDS, [], []
    for name, t in src_lm.items():
        shard.append(name)
        if nbytes(*(src_lm[n] for n in shard)) >= per_shard and len(shards) < HF_LM_SHARDS - 1:
            shards.append(shard)
            shard = []
    shards.append(shard)
    weight_map = {}
    for k, names in enumerate(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        written += write_safetensors(lm_dir / fname, {n: src_lm[n] for n in names})
        weight_map.update(dict.fromkeys(names, fname))
    (lm_dir / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": nbytes(*src_lm.values())}, "weight_map": weight_map}))
    write_s = time.perf_counter() - t0
    read = sum(f.stat().st_size for d in (lm_dir, v_dir) for f in d.glob("*.safetensors"))

    ap = argparse.ArgumentParser()
    add_model_args(ap)
    args = ap.parse_args(["--preset", "default", "--seed", str(SEED), "--hf-vision-path",
                          str(v_dir), "--hf-lm-path", str(lm_dir), "--quantize",
                          "embedding,mlp,attn,bridge"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, loaded, _ = load_from_args(args)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    print(f"[hf snapshot] wrote {written:,} bytes in {len(shards)} Gemma shards + 1 DINOv2 "
          f"file in {write_s:.2f} s = {written / write_s / 1e9:.2f} GB/s; load_from_args "
          f"(seeded init, then the snapshots read, cast to bf16 on the host and placed, then "
          f"the int8 recipe) read {read:,} bytes in {load_s:.2f} s = "
          f"{read / load_s / 1e9:.2f} GB/s, on {card}", flush=True)

    want = hf_expected(src_lm, src_v, cfg)
    got = {("lm",) + p: t for p, t in float_leaves(loaded["lm"])}
    got.update({("vision",) + p: t for p, t in float_leaves(loaded["vision"])})
    if set(got) != set(want):
        raise AssertionError(f"unquantized leaves {sorted(set(got) ^ set(want))[:6]} are not "
                             "those expected")
    off = [p for p, t in got.items() if t.dtype != torch.bfloat16
           or not torch.equal(t.cpu(), want[p])]
    grid = cfg.image_size // cfg.vision.patch_size
    print(f"[hf snapshot] {len(got)} unquantized leaves (the LM's norms, the vision tower, "
          f"pos_embed_interp_{grid} from the host's f32 bicubic) bit for bit against the source "
          f"cast to bf16: {len(got) - len(off)} of {len(got)}")
    if off:
        raise AssertionError(f"leaves differ from the source: {off[:6]}")

    # the same weights converted in memory, served the same way
    with torch.no_grad():
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        mem = full_model.init(cfg, generator=g, device=dev)
        mem["vision"] = hf_loader.dinov2_from_state_dict(src_v, cfg.vision,
                                                         target_grids=(grid,), device=dev)
        mem["lm"] = gemma2.quantize_params(hf_loader.gemma2_from_state_dict(
            src_lm, cfg.lm, device=dev), parts=("embedding", "mlp", "attn"))
        mem["bridge"] = bridge.quantize_decode_params(mem["bridge"])
    del src_lm, src_v
    gcfg = GenerationConfig(max_length=NEW_TOKENS, greedy=True, kv_quant=True)
    loaded_st = prestack_decode_params(loaded, cfg, gcfg)
    mem_st = prestack_decode_params(mem, cfg, gcfg)
    for a_tree, b_tree, what in ((loaded, mem, "per-layer"), (loaded_st, mem_st, "stacked")):
        la, lb = list(all_leaves(a_tree)), list(all_leaves(b_tree))
        if [p for p, _ in la] != [p for p, _ in lb]:
            raise AssertionError(f"the loaded and the in-memory {what} trees differ in leaves")
        diff = [p for (p, a), (_, b) in zip(la, lb)
                if (a != b if not isinstance(a, torch.Tensor) else not torch.equal(a, b))]
        if diff:
            raise AssertionError(f"the loaded and the in-memory {what} trees differ at {diff[:6]}")
    del la, lb
    pixels = seeded_pixels(cfg, dev)
    wrappers = decode_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with record_decode_hidden("decode_step_stacked") as first:
        t0 = time.perf_counter()
        toks, lens = generate_tokens(loaded_st, cfg, pixel_values=pixels, gen=gcfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    toks_l = check_tokens(toks, lens, cfg, NEW_TOKENS)
    # the fused steps sum their stream-K partials in one order
    # (csrc/decode_gemm.cuh:product4): a second call on the same inputs
    # gives the same bits, and the in-memory conversion the same ids
    with record_decode_hidden("decode_step_stacked") as second:
        toks2, _ = generate_tokens(loaded_st, cfg, pixel_values=pixels, gen=gcfg)
    drift = max(float((a.float() - b.float()).abs().max()) for a, b in zip(first, second))
    same_rows = int((toks2.cpu() == toks_l).all(dim=1).sum())
    toks_mf, _ = generate_tokens(mem_st, cfg, pixel_values=pixels, gen=gcfg)
    mem_rows = int((toks_mf.cpu() == toks_l).all(dim=1).sum())
    print(f"[hf snapshot] greedy serving from the loaded snapshot, int8 recipe (fused stack), "
          f"{BATCH} x {NEW_TOKENS}: {BATCH / dt:.2f} captions/s (encode + decode) on {card}; "
          f"launches {launches}; a second call on the same inputs: largest final-hidden "
          f"difference {drift:.6g}, ids equal in {same_rows} of {BATCH} rows; ids equal to the "
          f"in-memory conversion's (fused path) in {mem_rows} of {BATCH} rows")
    if any(launches.get(n) != NEW_TOKENS for n in ("fused_stack_step", "fused_bridge_step",
                                                    "int8_matmul_t_argmax")):
        raise AssertionError("serving from the loaded snapshot did not run the decode kernels")
    if drift != 0 or same_rows != BATCH or mem_rows != BATCH:
        raise AssertionError("the fused path gave other bits or ids on the same inputs")
    del loaded_st, mem_st, first, second
    torch.cuda.empty_cache()
    # id for id on the per-layer path too: the int8 weights as per-layer dicts
    # with the bf16 KV cache (int8_matmul / int8_mlp / int8_ffn / the greedy
    # head), from the snapshot and from the in-memory conversion
    per_layer = GenerationConfig(max_length=NEW_TOKENS, greedy=True)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    toks_p, lens_p = generate_tokens(loaded, cfg, pixel_values=pixels, gen=per_layer)
    torch.cuda.synchronize()
    dt_p = time.perf_counter() - t0
    launches_p = {n: fn.launches for n, fn in wrappers.items() if fn.launches}
    toks_p = check_tokens(toks_p, lens_p, cfg, NEW_TOKENS)
    toks_m, _ = generate_tokens(mem, cfg, pixel_values=pixels, gen=per_layer)
    rows = int((toks_m.cpu() == toks_p).all(dim=1).sum())
    print(f"[hf snapshot] the per-layer int8 path, {BATCH} x {NEW_TOKENS}: "
          f"{BATCH / dt_p:.2f} captions/s, launches {launches_p}; ids equal to the in-memory "
          f"conversion's in {rows} of {BATCH} rows")
    if rows != BATCH or not all(launches_p.get(n) for n in ("int8_matmul", "int8_mlp",
                                                            "int8_matmul_t_argmax")):
        raise AssertionError("serving from the loaded snapshot is off")
    return v_dir, lm_dir


def run_debug_and_parity(v_dir: Path, lm_dir: Path, params, cfg, dev, card) -> None:
    """vlm-debug-torch on one seeded image at full width (DEBUG_STEPS traced
    steps, the strategy sweep, the bypass A/B), then vlm-parity-torch record
    on two seeded images from the snapshot and a .pth of the trained bridge
    (CheckpointStore.export_pth), check of that transcript (2/2), and check of
    a transcript with one token changed (refused, rc 1)."""
    import contextlib
    import io

    import numpy as np
    from PIL import Image

    from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore
    from vlm_bridge_tpu_torch.tools import debug_generation as dbg
    from vlm_bridge_tpu_torch.tools import parity

    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        rng = np.random.default_rng(SEED + 20)
        images = []
        for i, (hgt, wid) in enumerate(((240, 320), (300, 260))):
            images.append(work / f"seeded_{i}.png")
            Image.fromarray(rng.integers(0, 256, (hgt, wid, 3), np.uint8)).save(images[-1])

        traces, real = [], dbg.GenerationDebugger.debug_generation

        def timed(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = real(self, *a, **kw)
            torch.cuda.synchronize()
            traces.append((time.perf_counter() - t0, len(rep.steps)))
            return rep
        dbg.GenerationDebugger.debug_generation = timed
        try:
            rc = dbg.main(["--preset", "default", "--seed", str(SEED), "--image", str(images[0]),
                           "--max-length", str(DEBUG_STEPS), "--report", str(work / "r.json")])
        finally:
            dbg.GenerationDebugger.debug_generation = real
        rep = json.loads((work / "r.json").read_text())
        bad = sum(s["nan_count"] + s["inf_count"] for s in rep["steps"])
        print(f"[debug] vlm-debug-torch, VLMConfig.default(), one seeded image: rc {rc}, "
              f"{len(rep['steps'])} step traces, NaN + Inf logits {bad}, strategies "
              f"{sorted(rep['strategies'])}, bridge A/B {sorted(rep['bridge_ab'])}, issues "
              f"{rep['issues']}; the traced decode {1e3 * traces[0][0] / traces[0][1]:.2f} ms a "
              f"step (exact mode's f32 forward over the {DEBUG_STEPS + 1}-position buffer, the "
              f"image's encode included) on {card}")
        if (rc != 0 or len(rep["steps"]) != DEBUG_STEPS or bad or len(rep["strategies"]) != 5
                or any(c.startswith("ERROR") for c in rep["strategies"].values())
                or set(rep["bridge_ab"]) != {"with_bridge", "bypass_bridge"}):
            raise AssertionError("the generation debugger's report is off")

        CheckpointStore(work / "ckpt").save("best", bridge_params=params["bridge"])
        CheckpointStore(work / "ckpt").export_pth("best", cfg.bridge, work / "bridge.pth")
        files = ["--preset", "default", "--hf-vision-path", str(v_dir), "--hf-lm-path",
                 str(lm_dir), "--pth", str(work / "bridge.pth"), "--dtype", "f32",
                 "--max-length", str(PARITY_TOKENS)]
        transcript = work / "transcript.jsonl"

        def run(argv):
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = parity.main(argv)
            torch.cuda.synchronize()
            print("\n".join("[parity] " + line for line in out.getvalue().splitlines()))
            return rc, out.getvalue(), time.perf_counter() - t0

        rc, _, rec_s = run(["record", *map(str, images), "--output", str(transcript), *files])
        rows = [json.loads(line) for line in transcript.read_text().splitlines()]
        rc_ok, out_ok, chk_s = run(["check", "--transcript", str(transcript), "--data-dir", "/",
                                    *files])
        rows[1]["tokens"][2] = (rows[1]["tokens"][2] + 1) % cfg.lm.vocab_size
        transcript.write_text("".join(json.dumps(r) + "\n" for r in rows))
        rc_bad, out_bad, _ = run(["check", "--transcript", str(transcript), "--data-dir", "/",
                                  *files])
        print(f"[parity] record rc {rc} ({rec_s:.1f} s: f32 snapshot load + {len(rows)} exact "
              f"decodes of {PARITY_TOKENS} tokens), check rc {rc_ok} ({chk_s:.1f} s), the "
              f"transcript with one token changed rc {rc_bad}, on {card}")
        if (rc != 0 or rc_ok != 0 or f"{len(rows)}/{len(rows)} matched" not in out_ok
                or rc_bad != 1 or f"{len(rows) - 1}/{len(rows)} matched" not in out_bad):
            raise AssertionError("vlm-parity-torch record / check is off")


def run_distributed(params, cfg, dev, card, bare_rate) -> None:
    """A process group of one over NCCL on the card: the orchestrator's
    DIST_STEPS steps at batch 8 x 256 bit-equal to the same run without a
    group (losses, validation, the final bridge), vlm-eval-torch --mesh 1
    on DIST_EVAL_BATCHES batches id for id against the run without --mesh
    (the int8 recipe on the fused path: one summation order a kernel),
    vlm-caption-torch --mesh 1 over BATCH image files against the run
    without --mesh (the same JSONL, captions/s beside each other), and the
    gradients' all-reduce timed; the group is destroyed at the end. Then
    entry()'s forward once."""
    import torch.distributed as dist

    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.entry import entry
    from vlm_bridge_tpu_torch.inference import evaluate
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.parallel import init_multihost, process_info
    from vlm_bridge_tpu_torch.parallel.distributed import all_reduce_sum
    from vlm_bridge_tpu_torch.runtime.tb_writer import read_scalars
    from vlm_bridge_tpu_torch.training import orchestrator as orch
    from vlm_bridge_tpu_torch.training import train_step as ts

    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    leaves = ts.tree_leaves(params["bridge"])
    start = [p.detach().clone() for p in leaves]
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        write_synthetic_split(root, DIST_STEPS * TRAIN_BATCH, cfg.image_size, "train", repeat=5)
        write_synthetic_split(root, TRAIN_BATCH, cfg.image_size, "val", repeat=5)
        write_synthetic_split(root, DIST_EVAL_BATCHES * BATCH, cfg.image_size, "test")

        def train(name):
            with torch.no_grad():
                for p, s in zip(leaves, start):
                    p.copy_(s)
            tc = TrainingConfig(data_dir=str(root), checkpoint_dir=str(root / name / "ckpt"),
                                log_dir=str(root / name / "logs"), max_steps_per_epoch=DIST_STEPS,
                                num_epochs=1, log_every_n_steps=1,
                                num_validation_samples=ENTRY_SAMPLES)
            ctx = orch.prepare_environment(tc, params=params)
            for fn in counters:
                fn.launches = 0
            res = orch.execute_full_training(tc, ctx=ctx)
            torch.cuda.synchronize()
            (events,) = (root / name / "logs").glob("events.out.tfevents.*")
            scalars = read_scalars(events)
            return {"history": res["history"], "losses": scalars["train/loss"],
                    "steady": [v for _, v in scalars["epoch/samples_per_sec_steady"]],
                    "bridge": [p.detach().clone() for p in ts.tree_leaves(ctx.state.bridge_params)],
                    "launches": [fn.launches for fn in counters],
                    "distributed": ctx.mesh.distributed}

        plain = train("plain")
        port = _free_port()
        if not init_multihost(f"127.0.0.1:{port}", 1, 0):
            raise AssertionError("init_multihost did not join a group")
        try:
            print(f"[distributed] {process_info()}", flush=True)
            nccl = train("nccl")
            same_bridge = all(torch.equal(a, b) for a, b in zip(plain["bridge"], nccl["bridge"]))
            print(f"[distributed] orchestrator, {DIST_STEPS} steps of batch {TRAIN_BATCH} x 256 "
                  f"and a validation epoch, without a group and in an NCCL group of one: "
                  f"train/loss {plain['losses']} and {nccl['losses']}; history equal "
                  f"{plain['history'] == nccl['history']}; final bridge bit-equal {same_bridge}; "
                  f"flash launches {plain['launches']} and {nccl['launches']}")
            if (plain["distributed"] or not nccl["distributed"] or plain["losses"] != nccl["losses"]
                    or plain["history"] != nccl["history"] or not same_bridge
                    or plain["launches"] != nccl["launches"] or not all(plain["launches"])):
                raise AssertionError("the NCCL world-of-one run differs from the plain one")

            grads = [torch.randn_like(p) for p in leaves]
            all_reduce_sum(grads)
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            ev0.record()
            for _ in range(10):
                all_reduce_sum(grads)
            ev1.record()
            torch.cuda.synchronize()
            ar_ms = ev0.elapsed_time(ev1) / 10
            del grads
            print(f"[distributed] the bridge gradients' all-reduce ({nbytes(*leaves) / 1e9:.3f} "
                  f"GB of f32 through one flat buffer, NCCL, one rank): {ar_ms:.4f} ms a step; "
                  f"steady samples/s {nccl['steady']} in the group against {plain['steady']} "
                  f"without it and {bare_rate:.2f} for run_train's bare step, on {card}")

            recorded = {}
            real_generate = evaluate.generate_tokens

            def recording(*a, **kw):
                out = real_generate(*a, **kw)
                recorded.setdefault(key, []).append(out[0].cpu())
                return out
            evaluate.generate_tokens = recording
            results = {}
            try:
                for key in ("plain", "mesh"):
                    argv = ["--data-dir", tmp, "--split", "test", "--batch-size", str(BATCH),
                            "--max-length", str(NEW_TOKENS), "--preset", "default", "--seed",
                            str(SEED), "--quantize", "embedding,mlp,attn,bridge", "--kv-int8",
                            "--no-early-stop", "--output", str(root / f"{key}.json")]
                    if key == "mesh":
                        argv += ["--mesh", "1"]
                    if evaluate.main(argv) != 0:
                        raise AssertionError(f"vlm-eval-torch ({key}) failed")
                    results[key] = json.loads((root / f"{key}.json").read_text())
            finally:
                evaluate.generate_tokens = real_generate
            ids_eq = len(recorded["plain"]) == len(recorded["mesh"]) == DIST_EVAL_BATCHES and all(
                torch.equal(a, b) for a, b in zip(recorded["plain"], recorded["mesh"]))
            print(f"[distributed] vlm-eval-torch --mesh 1 in the group, {DIST_EVAL_BATCHES} "
                  f"batches of {BATCH} x {NEW_TOKENS} (the int8 recipe on the fused path): ids "
                  f"equal to the run without --mesh: {ids_eq}; metrics equal "
                  f"{results['plain']['metrics'] == results['mesh']['metrics']}; captions/s "
                  f"{results['mesh']['captions_per_sec']:.2f} against "
                  f"{results['plain']['captions_per_sec']:.2f}, on {card}")
            if not ids_eq or results["plain"]["metrics"] != results["mesh"]["metrics"]:
                raise AssertionError("vlm-eval-torch --mesh 1 decodes other ids")
            run_caption_mesh(root, card)
        finally:
            dist.destroy_process_group()
    fn, example = entry()
    with torch.no_grad():
        loss = float(fn(*example))
    torch.cuda.synchronize()
    print(f"[entry] entry()'s masked-CE forward, VLMConfig.default(), batch 8 x 256: loss "
          f"{loss:.4f}")
    if not math.isfinite(loss):
        raise AssertionError("entry()'s loss is not finite")
    del fn, example
    torch.cuda.empty_cache()


TP_RANKS, TP_TIMEOUT_S = 2, 900


def tp_serve_and_step(params, cfg, dev, mesh=None) -> dict:
    """What the tensor-parallel phase holds, on one side: greedy 64 x 50 on
    the per-layer path (bf16 weights and KV cache; a 2-token warm-up first),
    host seconds around it, the first step's logits (BOS through the bridge
    and the LM) and one train step's loss at TRAIN_BATCH x TRAIN_SEQ with
    seeded dropout."""
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.models import full_model

    pixels = seeded_pixels(cfg, dev)
    gcfg = GenerationConfig(max_length=NEW_TOKENS, greedy=True, early_stop=False)
    with torch.no_grad():
        generate_tokens(params, cfg, pixel_values=pixels,
                        gen=dataclasses.replace(gcfg, max_length=2), mesh=mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, lens = generate_tokens(params, cfg, pixel_values=pixels, gen=gcfg, mesh=mesh)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        bos = torch.full((BATCH, 1), cfg.lm.bos_token_id, dtype=torch.long, device=dev)
        logits = full_model.forward(params, cfg, pixels, bos, torch.ones_like(bos))[:, 0]
    toks = check_tokens(toks, lens, cfg, NEW_TOKENS)
    case = build_train_case(params, cfg, dev, mesh=mesh)
    drop = torch.Generator(device=dev)
    drop.manual_seed(SEED + 3)
    _, metrics = case["train_step"](case["state"], case["frozen"], case["batch"], drop)
    return {"tokens": toks, "seconds": seconds, "logits": logits.float().cpu(),
            "loss": float(metrics["loss"])}


def tp_worker(rank: int, port: int, out: Path) -> int:
    """One rank of run_tensor_parallel: the seeded model, its LM cut over the
    mesh (1, TP_RANKS) of a gloo group on the one card; tp_serve_and_step,
    then greedy decoding again with each all-reduce fenced and timed."""
    from vlm_bridge_tpu_torch.parallel import auto_mesh, distributed, init_multihost, shard_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_multihost(f"127.0.0.1:{port}", TP_RANKS, rank, device="cpu")   # gloo
    mesh = auto_mesh(1, TP_RANKS, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    cfg, params = build_model(dev, gen)
    t0 = time.perf_counter()
    params = shard_params(mesh, params, cfg=cfg)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    res = tp_serve_and_step(params, cfg, dev, mesh)

    # the all-reduces of one greedy run, each behind a synchronise so that its
    # host time is its own (the run is slower for it: its rate is not kept)
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens

    real, spent = distributed.all_reduce_f32, [0.0, 0]

    def timed(x, group):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = real(x, group)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t
        spent[1] += 1
        return y

    distributed.all_reduce_f32 = timed
    try:
        with torch.no_grad():
            generate_tokens(params, cfg, pixel_values=seeded_pixels(cfg, dev), mesh=mesh,
                            gen=GenerationConfig(max_length=NEW_TOKENS, greedy=True,
                                                 early_stop=False))
    finally:
        distributed.all_reduce_f32 = real
    res.update(shard_s=shard_s, all_reduce_s=spent[0], all_reduces=spent[1],
               gib=torch.cuda.max_memory_allocated() / 2**30)
    torch.save(res, out / f"tp_rank{rank}.pt")
    torch.distributed.destroy_process_group()
    return 0


def run_tensor_parallel(cfg, dev, card) -> None:
    """Tensor parallelism at full width: TP_RANKS processes on the one card
    (tp_worker) against the same seeded weights in this process."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    _, ref_params = build_model(dev, gen)
    ref = tp_serve_and_step(ref_params, cfg, dev)
    del ref_params
    torch.cuda.empty_cache()
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        logs = [open(out / f"log{r}.txt", "w") for r in range(TP_RANKS)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-rank",
                                   str(r), "--tp-port", str(port), "--tp-out", str(out)],
                                  stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(TP_RANKS)]
        try:
            rcs = [p.wait(timeout=TP_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        if any(rcs):
            tails = "\n".join((out / f"log{r}.txt").read_text()[-3000:] for r in range(TP_RANKS))
            raise AssertionError(f"tensor-parallel ranks exited with {rcs}:\n{tails}")
        ranks = [torch.load(out / f"tp_rank{r}.pt") for r in range(TP_RANKS)]
    tp = ranks[0]
    same_ranks = all(torch.equal(r["tokens"], tp["tokens"]) for r in ranks[1:])
    n_tok = NEW_TOKENS
    per_token = tp["all_reduce_s"] * 1e3 / n_tok
    loss_rel = abs(tp["loss"] - ref["loss"]) / abs(ref["loss"])
    print(f"[tensor parallel] VLMConfig.default(), mesh (1, {TP_RANKS}) over gloo, two processes "
          f"on one card, bf16 LM cut by shard_params ({tp['shard_s']:.2f} s with the broadcast; "
          f"peak {tp['gib']:.2f} GiB a rank): greedy {BATCH} x {n_tok} on the per-layer path "
          f"{BATCH / tp['seconds']:.2f} captions/s against {BATCH / ref['seconds']:.2f} in one "
          f"process; all-reduces {tp['all_reduces'] // n_tok} a token, {per_token:.4f} ms a "
          f"token fenced; ranks' ids equal {same_ranks}; one train step at {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: loss {tp['loss']:.6f} against {ref['loss']:.6f} (relative "
          f"{loss_rel:.3g}, limit {LOSS_RTOL}), on {card}")
    hold_first_step("[tensor parallel] against one process", tp["tokens"], ref["tokens"],
                    tp["logits"], ref["logits"])
    if not same_ranks:
        raise AssertionError("the tensor-parallel ranks decoded other ids")
    if not loss_rel <= LOSS_RTOL:
        raise AssertionError("the tensor-parallel train step's loss is off")


def run_caption_mesh(root: Path, card) -> None:
    """vlm-caption-torch over BATCH seeded image files (the int8 recipe, the
    fused path), without --mesh and with --mesh 1 in the caller's process
    group: the same JSONL; each run's captions/s as the CLI prints it
    (caption_images alone, model load left out)."""
    import io

    from PIL import Image

    from vlm_bridge_tpu_torch.inference import caption

    images = root / "caption_images"
    images.mkdir()
    g = torch.Generator().manual_seed(SEED + 16)
    for i in range(BATCH):
        Image.fromarray(torch.randint(0, 256, (256, 256, 3), generator=g, dtype=torch.uint8)
                        .numpy()).save(images / f"{i:03d}.png")
    rates, texts = {}, {}
    for key, extra in (("plain", []), ("mesh", ["--mesh", "1"])):
        out = root / f"captions_{key}.jsonl"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = caption.main([str(images), "--preset", "default", "--seed", str(SEED),
                               "--quantize", "embedding,mlp,attn,bridge", "--batch-size",
                               str(BATCH), "--max-length", str(NEW_TOKENS), "--output", str(out),
                               *extra])
        if rc != 0:
            raise AssertionError(f"vlm-caption-torch ({key}) failed")
        rates[key] = float(re.search(r"\(([\d.]+) captions/s", buf.getvalue()).group(1))
        texts[key] = out.read_text()
    same = texts["plain"] == texts["mesh"]
    print(f"[distributed] vlm-caption-torch --mesh 1 in the group, {BATCH} images x "
          f"{NEW_TOKENS} tokens (the int8 recipe, fused path): captions equal to the run without "
          f"--mesh: {same} ({len(texts['mesh'].splitlines())} lines); captions/s "
          f"{rates['mesh']:.2f} against {rates['plain']:.2f}, on {card}")
    if not same or len(texts["mesh"].splitlines()) != BATCH:
        raise AssertionError("vlm-caption-torch --mesh 1 wrote other captions")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


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
    print(f"{name}: first tokens equal in {rows_eq} of {got.shape[0]} rows; share of all tokens equal: "
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
    dinov2.dot_product_attention = lambda q, k, v, *, scale, reference=False: (
        _attention_reference(q, k, v, scale=scale))
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


def prepare_fused_layers_timed(lm_params, card):
    """tools/loading.prepare_fused_layers on the model's per-layer int8
    weights, once: prints the seconds it takes and the device bytes it adds."""
    from vlm_bridge_tpu_torch.tools.loading import prepare_fused_layers

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prepared = prepare_fused_layers(lm_params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    extra = sum(nbytes(lp["attn"]["qkv"]["w_frag"], lp["attn"]["o"]["w_frag"],
                       lp["mlp"]["gate"]["gu_frag"], lp["mlp"]["gate"]["gu_scale"],
                       lp["mlp"]["down"]["w_frag"]) for lp in prepared["layers"].values())
    print(f"prepare_fused_layers: {len(prepared['layers'])} layers, {extra / 1e9:.4f} GB more on "
          f"the device, {dt:.3f} s (host clock around work that ends in a synchronise; "
          f"on {card})")
    return prepared


def phase_fused_layer(per_layer, cfg, dev, gen, card, t=20):
    """fused_attn_step (t = 0 and t) and fused_mlp_step against their plain
    versions at M = BATCH on the model's own per-layer int8 weights (prepared
    with their fragment forms); a second call's bits; the kernels a call;
    every timed call reads another layer's weights and cache."""
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
    again = dk.fused_attn_step(*args, **kw)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"fused_attn_step t={t}: a second call gave other bits")
    print(f"[fused_attn_step t={t}] a second call: bit-equal")
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
    # what the kernels read: the fragment forms and the scales, not w_int8 as well
    qkv, o = lp["attn"]["qkv"], lp["attn"]["o"]
    n_w = qkv["w_frag"].numel() + o["w_frag"].numel()
    bd = bound(nbytes(qkv["w_frag"], qkv["scale"], o["w_frag"], o["scale"], lp["input_norm"],
                      lp["post_attn_norm"]) + live + 2 * nbytes(x) + 2 * BATCH * KH * (D + 4),
               2.0 * BATCH * n_w)
    a0 = attn_args(0, t)   # made outside the profiled call: RoPE's rows are kernels too
    launches = step_launches(lambda: dk.fused_attn_step(*a0, **kw), calls=20)
    print(f"[fused_attn_step] t={t}: kernel {ms:.4f} ms (on the int8 product kernel: "
          f"{LAYER_STEP_I8MM_MS['fused_attn_step']}; with the mma.sync product: "
          f"{I8_MMA_SYNC_MS['fused_attn_step']}), plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; kernels a call {launches} (at most "
          f"{LAYER_STEP_LAUNCH_LIMITS['fused_attn_step']}) (on {card})")
    if launches is not None and launches > LAYER_STEP_LAUNCH_LIMITS["fused_attn_step"]:
        raise AssertionError(f"fused_attn_step launched {launches} kernels a call")
    res["fused_attn_step"] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms, **bd,
                              "library_ms": None, "kernels_a_call": launches}

    def mlp_args(i):
        lp = layers[i]
        return (x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"], lp["pre_ffn_norm"],
                lp["post_ffn_norm"])

    got = dk.fused_mlp_step(*mlp_args(0), eps=lm.rms_norm_eps)
    want = dk.fused_mlp_step_plain(*mlp_args(0), eps=lm.rms_norm_eps)
    torch.cuda.synchronize()
    err = rows_close("fused_mlp_step", got, want, LAYER_TOL)
    if not torch.equal(got, dk.fused_mlp_step(*mlp_args(0), eps=lm.rms_norm_eps)):
        raise AssertionError("fused_mlp_step: a second call gave other bits")
    print("[fused_mlp_step] a second call: bit-equal")
    nxt = cycle([mlp_args(i) for i in range(L)])
    ms = time_ms(lambda: dk.fused_mlp_step(*nxt(), eps=lm.rms_norm_eps), 2 * L)
    plain_ms = time_ms(lambda: dk.fused_mlp_step_plain(*nxt(), eps=lm.rms_norm_eps), 4)
    gate, down = lp["mlp"]["gate"], lp["mlp"]["down"]
    n_w = gate["gu_frag"].numel() + down["w_frag"].numel()
    bd = bound(nbytes(gate["gu_frag"], gate["gu_scale"], down["w_frag"], down["scale"],
                      lp["pre_ffn_norm"], lp["post_ffn_norm"]) + 2 * nbytes(x),
               2.0 * BATCH * n_w)
    m0 = mlp_args(0)
    launches = step_launches(lambda: dk.fused_mlp_step(*m0, eps=lm.rms_norm_eps), calls=20)
    print(f"[fused_mlp_step] kernel {ms:.4f} ms (on the int8 product kernel: "
          f"{LAYER_STEP_I8MM_MS['fused_mlp_step']}; with the mma.sync product: "
          f"{I8_MMA_SYNC_MS['fused_mlp_step']}), plain {plain_ms:.4f} ms, bound "
          f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; kernels a call {launches} (at most "
          f"{LAYER_STEP_LAUNCH_LIMITS['fused_mlp_step']}) (on {card})")
    if launches is not None and launches > LAYER_STEP_LAUNCH_LIMITS["fused_mlp_step"]:
        raise AssertionError(f"fused_mlp_step launched {launches} kernels a call")
    res["fused_mlp_step"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bd,
                             "library_ms": None, "kernels_a_call": launches}
    return res


def run_fused_layers(per_layer, cfg, dev, card, stacked_ids, stack_step_ms):
    """50 greedy tokens at batch BATCH through fused_bridge_step ->
    gemma2.decode_step_fused -> int8_matmul_t_argmax, from the per-layer int8
    weights (prepared with their fragment forms); then the loop's device-busy
    share. Returns the two layer kernels' launch counts."""
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
        rope = gemma2.rope_rows(lm, n_tokens, dev)
        normalizer = gemma2.embed_normalizer(lm, torch.bfloat16, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(n_tokens):
            emb = gemma2.embed(lmp, tok.long()[:, None]).to(torch.bfloat16)
            x = dk.fused_bridge_step(t, emb[:, 0].contiguous(), bst, bcache.cross_k,
                                     bcache.cross_k_scale, bcache.cross_v, bcache.cross_v_scale,
                                     bcache.self_k, bcache.self_v,
                                     num_heads_cross=bc.num_heads_cross,
                                     num_heads_self=bc.num_heads_self, eps=bc.layer_norm_eps)
            hidden, kv = gemma2.decode_step_fused(lmp, lm, x[:, None, :], kv, t, rope=rope,
                                                  normalizer=normalizer)
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
        # device-busy share: two profiled windows of BUSY_TOKENS and twice as
        # many tokens, their difference a token (the cache set-up left out)
        (w1, b1, k1), (w2, b2, k2) = (device_busy(lambda n=n: loop(n))
                                      for n in (BUSY_TOKENS, 2 * BUSY_TOKENS))
        if b2 > b1:
            wall, busy = (w2 - w1) / BUSY_TOKENS, (b2 - b1) / BUSY_TOKENS
            parts = sorted(((k2.get(n, 0.0) - k1.get(n, 0.0)) / BUSY_TOKENS, n) for n in k2)
            print(f"per-layer fused decode, a token under torch.profiler (the card's activity "
                  f"only): device busy {busy:.4f} ms of {wall:.4f} ms = {100 * busy / wall:.1f} "
                  f"% (on {card}); by kernel, ms a token: " + "; ".join(
                      f"{n[:60]} {v:.4f}" for v, n in reversed(parts[-8:])))
        else:
            print("per-layer fused decode: the profiler recorded no device time")
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


def write_synthetic_split(root, n: int, crop: int, split: str = "test",
                          repeat: int = 1) -> None:
    """<root>/<split>: a captions.jsonl manifest of n samples and the pixel
    cache's two files (data/pixel_cache.py), written with numpy alone. The
    image files themselves are absent, which the cache's fingerprint
    records, so VLDataset attaches the memmap and decodes no image. Each
    caption is one sentence `repeat` times (5: ~240 bytes, the train path's
    256-token bucket)."""
    import numpy as np

    from vlm_bridge_tpu_torch.data import pixel_cache

    seed = SEED + 10 + ("test", "train", "val").index(split)
    split = Path(root) / split
    split.mkdir(parents=True)
    samples = [{"image_path": f"images/{i:06d}.jpg", "original_id": i,
                "caption": " ".join([f"a {('red', 'blue', 'green')[i % 3]} shape number {i} on "
                                     "a plain background"] * repeat)} for i in range(n)]
    (split / "captions.jsonl").write_text("".join(json.dumps(r) + "\n" for r in samples))
    out = np.lib.format.open_memmap(split / pixel_cache.CACHE_NAME, mode="w+", dtype=np.uint8,
                                    shape=(n, crop, crop, 3))
    out[:] = np.random.default_rng(seed).integers(0, 256, size=out.shape, dtype=np.uint8)
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


def check_tokens(toks, lens, cfg, n_tokens, rows=BATCH):
    """Shape, id range, BOS column and lengths of a generation; returns the
    tokens on the CPU."""
    from vlm_bridge_tpu_torch.inference.generate import _eos_lengths

    toks_c, lens_c = toks.cpu(), lens.cpu()
    if tuple(toks_c.shape) != (rows, n_tokens + 1):
        raise AssertionError(f"tokens shape {tuple(toks_c.shape)}")
    if not ((toks_c >= 0) & (toks_c < cfg.lm.vocab_size)).all():
        raise AssertionError("token ids out of range")
    if not (toks_c[:, 0] == cfg.lm.bos_token_id).all():
        raise AssertionError("first column is not BOS")
    if not torch.equal(lens_c, _eos_lengths(toks_c, cfg.lm.eos_token_id)):
        raise AssertionError("lengths disagree with the first EOS")
    return toks_c


def main() -> int:
    if "--tp-rank" in sys.argv:   # one rank of run_tensor_parallel
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return tp_worker(int(args["--tp-rank"]), int(args["--tp-port"]), Path(args["--tp-out"]))
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
        fused = {**per_layer, "lm": prepare_fused_layers_timed(per_layer["lm"], card)}
        results.update(phase_fused_layer(fused, cfg, dev, i8_gen, card))
        launches.update(run_fused_layers(fused, cfg, dev, card, stacked_ids,
                                         results["fused_stack_step"]["ms"]))
        del fused
        torch.cuda.empty_cache()
    # the fused token step at Gemma-2-27B's widths (two layers), kernels against plain versions
    g27 = torch.Generator(device=dev)
    g27.manual_seed(SEED + 27)
    with torch.no_grad():
        phase_gemma2_27b_step(dev, g27, card)
    torch.cuda.empty_cache()
    # the stack step with routed experts at Mellum2-12B-A2.5B's widths (two layers)
    gmoe = torch.Generator(device=dev)
    gmoe.manual_seed(SEED + 23)
    with torch.no_grad():
        moe_rows = phase_moe_stack(dev, gmoe)
    for name, row in moe_rows.items():
        launches[name] = row.pop("launches")
    results.update(moe_rows)
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
    train_launches, bare_rate = run_train(params, cfg, dev, card)
    launches.update(train_launches)
    # the entry point's 6 train steps, beside the bare step's count in `launches`
    for name, n in run_training_entry(params, cfg, dev, card, bare_rate).items():
        results[name]["entry_launches"] = n
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as snap:
        v_dir, lm_dir = run_hf_snapshot(Path(snap), cfg, dev, card)
        torch.cuda.empty_cache()
        run_debug_and_parity(v_dir, lm_dir, params, cfg, dev, card)
    torch.cuda.empty_cache()
    run_distributed(params, cfg, dev, card, bare_rate)
    del params
    torch.cuda.empty_cache()
    run_tensor_parallel(cfg, dev, card)

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
               # the same wrapper and C entry with routed experts (the JAX
               # package has no sparse decoder: the routing and expert kernels
               # replace no TPU kernel), and the stack's attention at G 8
               "fused_stack_step[moe]": ("stack_step.cu",
                                         "vlm_bridge_tpu/ops/decode_kernels.py:707"),
               "moe_route_kernel": ("stack_step.cu", None),
               "moe_expert_kernel<false>": ("decode_gemm.cuh", None),
               "moe_expert_kernel<true>": ("decode_gemm.cuh", None),
               "stack_attn_kernel": ("decode_gemm.cuh", None),
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
