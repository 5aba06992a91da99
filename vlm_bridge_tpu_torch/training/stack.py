"""The training stack's one setup path (port of vlm_bridge_tpu.training.stack):
init (or accept) the parameters on a device, load the HF snapshots of the
towers, build the ("data", "model") mesh over the process group, set every
rank's parameters to rank 0's, make the bridge's f32 master copy and its
optimizer, and build the train and eval steps. The orchestrator adds the
loaders and the logging.

What differs from the JAX package: the mesh is data-parallel only (a model
axis > 1 raises, parallel/sharding.py); there is no `scan_layers` (a JAX
compile lever); the device is an explicit `torch.device`, one per process.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from vlm_bridge_tpu_torch.configs import TrainingConfig, VLMConfig
from vlm_bridge_tpu_torch.models import full_model
from vlm_bridge_tpu_torch.parallel import Mesh, auto_mesh, distributed, shard_params
from vlm_bridge_tpu_torch.params.hf_loader import load_towers
from vlm_bridge_tpu_torch.tools.loading import resolve_device
from vlm_bridge_tpu_torch.training.train_step import (
    BridgeOptimizer, TrainState, init_train_state, make_eval_step, make_schedule,
    make_train_step, split_frozen)


@dataclass
class Stack:
    """The training stack (everything but the loaders and the logging)."""

    cfg: VLMConfig
    device: torch.device
    mesh: Mesh
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


def build_mesh(tc: TrainingConfig, device=None) -> Mesh:
    """("data", "model") mesh from tc.mesh_shape over the process group; -1
    fills the data axis with the group's processes. device: this process's
    (None: its card)."""
    ms = tuple(tc.mesh_shape or (-1,))
    model_ax = ms[1] if len(ms) > 1 else 1
    data_ax = ms[0] if ms[0] != -1 else distributed.world_size() // model_ax
    return auto_mesh(data=data_ax, model=model_ax,
                     device=None if device is None else resolve_device(device))


def init_params(tc: TrainingConfig, cfg: Optional[VLMConfig] = None, *,
                frozen_dtype=torch.bfloat16, device=None) -> dict:
    """Seeded random init (tc.seed) of the whole tree on `device` (None:
    the card; no fallback), then the HF snapshots tc.hf_vision_path /
    tc.hf_lm_path in place of the towers, in frozen_dtype."""
    cfg = cfg or tc.model_config()
    device = resolve_device(device or "cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(tc.seed)
    with torch.no_grad():
        params = full_model.init(cfg, generator=gen, frozen_dtype=frozen_dtype, device=device)
    return load_towers(params, cfg, vision_path=tc.hf_vision_path, lm_path=tc.hf_lm_path,
                       dtype=frozen_dtype, device=device)


def build_stack(tc: TrainingConfig, *, params: Optional[dict] = None, device=None,
                mesh: Optional[Mesh] = None, steps_per_epoch: int, activation_dtype=None,
                frozen_dtype=torch.bfloat16) -> Stack:
    """init -> mesh -> rank 0's bits everywhere -> frozen / trainable split
    -> TrainState -> steps. `params` given: used as they are (their device
    wins over `device`); an f32 bridge keeps its storage as the master copy,
    so training updates it. mesh None: build_mesh(tc)."""
    cfg = tc.model_config()
    if activation_dtype is None:
        activation_dtype = resolve_activation_dtype(tc)
    if params is None:
        params = init_params(tc, cfg, frozen_dtype=frozen_dtype, device=device)
    device = params["lm"]["final_norm"].device
    if mesh is None:
        mesh = build_mesh(tc, device)
    if tc.batch_size % mesh.data:
        raise ValueError(f"batch_size {tc.batch_size} does not split over data={mesh.data}")
    params = shard_params(mesh, params)
    state, opt = init_train_state(params, tc, steps_per_epoch)
    schedule = make_schedule(tc, steps_per_epoch)
    return Stack(
        cfg=cfg, device=device, mesh=mesh, frozen=split_frozen(params), state=state, opt=opt,
        schedule=schedule,
        train_step=make_train_step(cfg, tc, opt, schedule, activation_dtype=activation_dtype,
                                   mesh=mesh),
        eval_step=make_eval_step(cfg, tc, activation_dtype=activation_dtype, mesh=mesh),
        activation_dtype=activation_dtype, steps_per_epoch=steps_per_epoch)
