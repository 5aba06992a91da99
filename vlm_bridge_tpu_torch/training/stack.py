"""The training stack's one setup path (port of vlm_bridge_tpu.training.stack):
init (or accept) the parameters on a device, split off the frozen towers,
make the bridge's f32 master copy and its optimizer, and build the train and
eval steps. The orchestrator adds the loaders and the logging.

What differs from the JAX package: there is no mesh, no sharding and no
`scan_layers` (a JAX compile lever); the device is an explicit
`torch.device`. HF snapshots are read by params/hf_loader.py, which is not
ported yet, so `tc.hf_vision_path` / `tc.hf_lm_path` raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from vlm_bridge_tpu_torch.configs import TrainingConfig, VLMConfig
from vlm_bridge_tpu_torch.models import full_model
from vlm_bridge_tpu_torch.tools.loading import resolve_device
from vlm_bridge_tpu_torch.training.train_step import (
    BridgeOptimizer, TrainState, init_train_state, make_eval_step, make_schedule,
    make_train_step, split_frozen)


@dataclass
class Stack:
    """The training stack (everything but the loaders and the logging)."""

    cfg: VLMConfig
    device: torch.device
    frozen: dict
    state: TrainState
    opt: BridgeOptimizer
    schedule: Any
    train_step: Any
    eval_step: Any
    activation_dtype: Any
    steps_per_epoch: int


def resolve_activation_dtype(tc: TrainingConfig):
    """bf16 under AMP (fp16 maps to bf16, as in the JAX package), else f32;
    from the reference-compatible use_amp / amp_dtype fields."""
    if tc.use_amp and tc.amp_dtype in ("bfloat16", "float16"):
        return torch.bfloat16
    return torch.float32


def init_params(tc: TrainingConfig, cfg: Optional[VLMConfig] = None, *,
                frozen_dtype=torch.bfloat16, device=None) -> dict:
    """Seeded random init (tc.seed) of the whole tree on `device` (None:
    the card; no fallback)."""
    if tc.hf_vision_path or tc.hf_lm_path:
        raise NotImplementedError("hf_vision_path / hf_lm_path: params/hf_loader.py is not "
                                  "ported yet")
    cfg = cfg or tc.model_config()
    device = resolve_device(device or "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(tc.seed)
    with torch.no_grad():
        return full_model.init(cfg, generator=gen, frozen_dtype=frozen_dtype, device=device)


def build_stack(tc: TrainingConfig, *, params: Optional[dict] = None, device=None,
                steps_per_epoch: int, activation_dtype=None,
                frozen_dtype=torch.bfloat16) -> Stack:
    """init -> frozen / trainable split -> TrainState -> steps. `params`
    given: used as they are (their device wins over `device`); an f32
    bridge keeps its storage as the master copy, so training updates it."""
    cfg = tc.model_config()
    if activation_dtype is None:
        activation_dtype = resolve_activation_dtype(tc)
    if params is None:
        params = init_params(tc, cfg, frozen_dtype=frozen_dtype, device=device)
    device = params["lm"]["final_norm"].device
    state, opt = init_train_state(params, tc, steps_per_epoch)
    schedule = make_schedule(tc, steps_per_epoch)
    return Stack(
        cfg=cfg, device=device, frozen=split_frozen(params), state=state, opt=opt,
        schedule=schedule,
        train_step=make_train_step(cfg, tc, opt, schedule, activation_dtype=activation_dtype),
        eval_step=make_eval_step(cfg, tc, activation_dtype=activation_dtype),
        activation_dtype=activation_dtype, steps_per_epoch=steps_per_epoch)
