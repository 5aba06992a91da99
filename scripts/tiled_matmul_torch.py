"""csrc/tiled_matmul.cu alone on one GPU: chip_smoke.py's tiled_matmul phase
without the rest of chip_smoke.py.

    python3 scripts/tiled_matmul_torch.py

Builds the kernels and prints what ptxas reports for the wgmma kernel
(registers, spills; it fails on a serialised wgmma pipeline or a spill),
then runs chip_smoke.phase_tiled_matmul on VLMConfig.default()'s DINOv2
tower with seeded random weights (the vision tower alone is made): the four
projections at 64 x 257 = 16448 rows with seeded biases (fc1 with GELU) and
o without one, each against its plain version (one bf16 step of a row's
largest value), timed beside the library call (torch.addmm, + F.gelu for
fc1; torch.matmul without a bias) in TFLOP/s, the kernel's ragged edges, and
the projection probe (24 layers x 4 bias-free products against
torch.matmul), beside the card's name and power limit. VBT_NVCC_FLAGS adds
compiler flags, as for chip_smoke.py.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("tiled_matmul_torch: torch.cuda.is_available() is False; this script runs on a GPU "
              "only", file=sys.stderr)
        return 2
    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.models import dinov2
    from vlm_bridge_tpu_torch.ops import cuda_lib

    card = cs.card_line()
    print(f"card (name, power limit): {card}", flush=True)
    cuda_lib.lib()
    spills = cs.ptxas_report(cuda_lib.build_log, tags=("tiled_matmul_kernel",))
    if spills:
        raise AssertionError(f"ptxas: {spills} spill")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    cfg = VLMConfig.default()
    with torch.no_grad():
        params = {"vision": dinov2.init(cfg.vision, generator=gen, device=dev)}
        cs.phase_tiled_matmul(params, cfg, dev, gen, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
