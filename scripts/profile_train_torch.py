"""Where the PyTorch port's bridge train step spends its time on one GPU.

    python3 scripts/profile_train_torch.py [--steps 3] [--trace OUT.json]

Takes chip_smoke.py's train case (VLMConfig.default() with seeded random
weights on the card, bf16 frozen towers, f32 bridge, batch 8 x 256 tokens
with ragged lengths, TrainingConfig() defaults) and prints
1. the parts of a step timed alone with CUDA events (ViT encode, bridge
   forward, Gemma forward without gradient, the chunked loss forward +
   backward from a given hidden state, the optimizer update), and the whole
   step on the host clock around a synchronise;
2. a torch.profiler window over `--steps` steps: device time by kernel
   family (matrix products, the three flash kernels, elementwise and
   reductions, copies), the device's busy and idle share of the window, and
   the twenty largest kernels by name.
Every figure is printed beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the repository root: the train case and the timers)

BATCH = chip_smoke.TRAIN_BATCH


def event_ms(fn) -> float:
    return chip_smoke.time_ms(fn, 3)


def family(name: str) -> str:
    low = name.lower()
    if "fa_fwd" in low or "fa_bwd" in low:
        return "flash kernels"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma", "cublas", "gemv")):
        return "matrix products"
    if "memcpy" in low or "memset" in low:
        return "copies and memsets"
    if "reduce" in low or "softmax" in low:
        return "reductions"
    return "elementwise and other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("this script measures a GPU; torch.cuda.is_available() is False", file=sys.stderr)
        return 2

    from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
    from vlm_bridge_tpu_torch.training import train_step as ts

    card = chip_smoke.card_line()
    print(f"card (name, power limit): {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    cfg, params = chip_smoke.build_model(dev, gen)
    case = chip_smoke.build_train_case(params, cfg, dev)
    tc, batch, frozen, state, opt = (case[k] for k in ("tc", "batch", "frozen", "state", "opt"))
    step = case["train_step"]
    drop = torch.Generator(device=dev)
    drop.manual_seed(chip_smoke.SEED + 1)
    for _ in range(2):  # warm-up: kernel build, cuBLAS handles, allocator
        state, _ = step(state, frozen, batch, drop)
    torch.cuda.synchronize()

    # ---- 1. parts timed alone
    pixels = ts._prep_pixels(batch["pixel_values"], torch.bfloat16)
    ids, mask = batch["input_ids"], batch["attn_mask"]
    labels = full_model.shift_labels(ids, mask)
    bf16_bridge = ts.tree_map(lambda p: p.detach().to(torch.bfloat16), state.bridge_params)
    with torch.no_grad():
        vision = full_model.encode_image(params, cfg, pixels)
        embeds = gemma2.embed(params["lm"], ids)
        bridged = bridge.forward(bf16_bridge, cfg.bridge, embeds, vision, text_mask=mask)
        hidden = gemma2.forward_hidden(params["lm"], cfg.lm, bridged, attn_mask=mask)

    def loss_fwd_bwd():
        h = hidden.detach().requires_grad_(True)
        loss, _ = full_model.chunked_ce_loss(params["lm"], cfg.lm, h, labels,
                                             chunk=tc.loss_chunk_size, remat=tc.loss_remat)
        torch.autograd.grad(loss, h)

    def update_only():
        leaves = ts.tree_leaves(state.bridge_params)
        opt.update([torch.zeros_like(p) for p in leaves], state.opt_state, leaves)

    with torch.no_grad():
        parts = {
            "ViT encode (no gradient)": event_ms(
                lambda: full_model.encode_image(params, cfg, pixels)),
            "bridge forward (no gradient, no dropout)": event_ms(
                lambda: bridge.forward(bf16_bridge, cfg.bridge, embeds, vision, text_mask=mask)),
            "Gemma forward_hidden (no gradient)": event_ms(
                lambda: gemma2.forward_hidden(params["lm"], cfg.lm, bridged, attn_mask=mask)),
        }
    parts["chunked loss forward + backward (recomputed chunks)"] = event_ms(loss_fwd_bwd)
    parts["clip + AdamW update (zero gradients)"] = event_ms(update_only)
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, frozen, batch, drop)
    torch.cuda.synchronize()
    whole = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"\nparts of one step, each timed alone (CUDA events), on {card}:")
    for name, ms in parts.items():
        print(f"  {ms:9.3f} ms  {name}")
    print(f"  {whole:9.3f} ms  whole train step (host clock, {args.steps} steps) = "
          f"{BATCH / whole * 1e3:.2f} samples/s")

    # ---- 2. profiler window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, _ = step(state, frozen, batch, drop)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    # kernels only: host-side ranges (the optimizer's own annotation) carry their
    # kernels' time a second time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Optimizer.")]
    if not rows:
        print("the profiler recorded no device time; the CUDA-event figures above stand alone")
        return 0
    busy = sum(ms for _, ms, _ in rows)
    fams: dict = {}
    for name, ms, n in rows:
        f = fams.setdefault(family(name), [0.0, 0])
        f[0] += ms
        f[1] += n
    per_step = busy / args.steps
    print(f"\nprofiler window: {args.steps} steps in {window_ms:.2f} ms under the profiler; "
          f"device busy {per_step:.2f} ms a step = {100 * per_step / whole:.1f} % of the "
          f"{whole:.2f} ms step without the profiler, idle {100 * (1 - per_step / whole):.1f} % "
          f"(on {card})")
    print("device time per step by kernel family:")
    for f, (ms, n) in sorted(fams.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms / args.steps:9.3f} ms  {n // args.steps:6d} launches  {f}")
    print("largest kernels (device ms per step, launches per step, name):")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:20]:
        print(f"  {ms / args.steps:9.3f}  {n // args.steps:6d}  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
