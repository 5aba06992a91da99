"""The vision encode's A/B on one GPU, in one process: dinov2.forward on a
seeded batch of 64 images at VLMConfig.default() under five routings, in
turns, so that one kernel can be retimed without the whole of chip_smoke.py.

    python3 scripts/vit_ab_torch.py [--reps 5]

Routings: the default (torch.matmul, the eager pivot LayerNorm, the flash
attention kernel), `tiled_matmul` only (VLM_BRIDGE_VIT_MM=kernel),
`layer_norm_fast` only (VLM_BRIDGE_LN_KERNEL=1), both, and the default with
`_attention_reference` in place of the flash kernel. Prints each routing's
launches of one encode, its device ms (median of --reps, each the mean of 3
encodes queued behind a spin kernel) and its features' relative error
against the default routing, beside the card's name and power limit. The
model comes from chip_smoke.build_model (same seed, same weights).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("vit_ab_torch: torch.cuda.is_available() is False; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    from vlm_bridge_tpu_torch.models import full_model
    from vlm_bridge_tpu_torch.ops import flash_attention as fa
    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk

    card = cs.card_line()
    print(f"card (name, power limit): {card}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    cfg, params = cs.build_model(dev, gen)
    pixels = cs.seeded_pixels(cfg, dev)
    routings = {
        "default": contextlib.nullcontext,
        "tiled_matmul": lambda: cs.vit_routing(mm=True),
        "layer_norm_fast": lambda: cs.vit_routing(ln=True),
        "both": lambda: cs.vit_routing(mm=True, ln=True),
        "plain_attention": cs.plain_vit_attention,
    }
    counters = {"tiled_matmul": mk.tiled_matmul, "layer_norm_fast": nk.layer_norm_fast,
                "flash_attention_fwd": fa.flash_attention_fwd}
    feats, launches, times = {}, {}, {k: [] for k in routings}
    with torch.no_grad():
        for name, routing in routings.items():
            for fn in counters.values():
                fn.launches = 0
            with routing():
                feats[name] = full_model.encode_image(params, cfg, pixels)
            torch.cuda.synchronize()
            launches[name] = {k: fn.launches for k, fn in counters.items()}
        for _ in range(args.reps):   # in turns: a drift of the card's clocks hits every routing
            for name, routing in routings.items():
                with routing():
                    times[name].append(cs.time_encode(params, cfg, pixels))
    for name in routings:
        ts = sorted(times[name])
        print(f"{name}: launches {launches[name]}; encode of {cs.BATCH} images "
              f"{ts[len(ts) // 2]:.2f} ms (median of {args.reps}; {ts[0]:.2f} to {ts[-1]:.2f}); "
              f"features' relative error against the default routing "
              f"{cs.rel_err(feats[name], feats['default']):.3g} (on {card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
