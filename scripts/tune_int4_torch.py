"""Time the decoder stack step with int4 MLP weights against the int8 one on
one GPU, under the build-time constants of csrc/i4_gemm.cu.

    python3 scripts/tune_int4_torch.py
    VBT_NVCC_FLAGS="-DI4_MIN_BLOCKS=3 -DI4_BLOCKS_PER_SM=2" python3 scripts/tune_int4_torch.py

Builds VLMConfig.default() with seeded random weights, quantizes it to the
int8 recipe and stacks it three ways (int8 MLP, int4 MLP in groups of 128,
int4 MLP per channel); each stack step is held to its plain version and
timed at batch 64, position 20, as chip_smoke.py does (its phase, its timer,
its card line). The constants are compile-time choices: run the script once
per VBT_NVCC_FLAGS value, each in a process of its own.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_int4_torch: this script runs on a GPU only", file=sys.stderr)
        return 2
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig
    from vlm_bridge_tpu_torch.models import bridge, gemma2
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    flags = os.environ.get("VBT_NVCC_FLAGS", "") or "defaults"
    print(f"card (name, power limit): {cs.card_line()}; nvcc flags: {flags}")
    cfg, params = cs.build_model(dev, gen)
    with torch.no_grad():
        per_layer = dict(params)
        per_layer["lm"] = gemma2.quantize_params(params["lm"], ("embedding", "mlp", "attn"))
        per_layer["bridge"] = bridge.quantize_decode_params(params["bridge"])
        base = GenerationConfig(max_length=cs.NEW_TOKENS, greedy=True, kv_quant=True)
        times = {}
        for name, gcfg in (
                ("int8", base),
                ("int4 group128", dataclasses.replace(base, mlp_int4=True)),
                ("int4 per_channel", dataclasses.replace(base, mlp_int4=True,
                                                         mlp_int4_group=None))):
            served = prestack_decode_params(per_layer, cfg, gcfg)
            step_gen = torch.Generator(device=dev)
            step_gen.manual_seed(cs.SEED + 11)
            times[name] = cs.phase_stack(served, cfg, dev, step_gen,
                                         name=f"fused_stack_step {name}")["ms"]
            del served
            torch.cuda.empty_cache()
    print(f"stack step ms [{flags}]: " + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
