"""FullModel assembly, serving slice (port of vlm_bridge_tpu.models.full_model):
frozen DINOv2 + Bridge-Lite + frozen Gemma-2 as one parameter tree. The
training forward and losses are not ported yet."""

from __future__ import annotations

import torch

from vlm_bridge_tpu.configs import VLMConfig
from vlm_bridge_tpu_torch.models import bridge as bridge_mod
from vlm_bridge_tpu_torch.models import dinov2 as dinov2_mod
from vlm_bridge_tpu_torch.models import gemma2 as gemma2_mod


def init(cfg: VLMConfig, *, generator: torch.Generator, frozen_dtype=torch.bfloat16,
         bridge_dtype=torch.float32, device=None) -> dict:
    """Random-init the full tree from one seeded generator on `device`."""
    return {
        "vision": dinov2_mod.init(cfg.vision, generator=generator, dtype=frozen_dtype,
                                  device=device),
        "lm": gemma2_mod.init(cfg.lm, generator=generator, dtype=frozen_dtype, device=device),
        "bridge": bridge_mod.init(cfg.bridge, generator=generator, dtype=bridge_dtype,
                                  device=device),
    }


@torch.no_grad()
def encode_image(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor) -> torch.Tensor:
    """Frozen vision forward. pixel_values: [B, H, W, C] normalized."""
    return dinov2_mod.forward(params["vision"], cfg.vision, pixel_values)
