"""The ("data", "model") mesh and its placements (port of
vlm_bridge_tpu.parallel.sharding over torch.distributed).

One process per place of the mesh: global rank r is data block r // model
and model index r % model (the JAX mesh's devices reshaped to (data,
model)). Axes:
  "data"  the batch: each data block holds a contiguous block of every
          global batch's rows, and the bridge gradients, the loss and its
          token count are summed over the data group (the ranks of one
          model index) before the clip (training/train_step.py);
  "model" tensor parallelism of the frozen Gemma decoder, with explicit
          local shards and explicit collectives where GSPMD inserts them
          under the JAX rules: `shard_params` cuts exactly the leaves that
          the placements table (`param_shardings`) marks Shard, and the
          decoder (models/gemma2.py) reads its local head counts from the
          shards' widths and sums the row-cut products (o, down) over the
          model group (`model_input` / `model_output`, the Megatron pair).

The trainable bridge, the ViT, the tied embedding and every quantized leaf
are replicated: every rank starts from rank 0's bits (`shard_params`
broadcasts every tensor of the tree), and the same summed gradients keep
the AdamW updates equal on every rank.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from vlm_bridge_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """A ("data", "model") description over the process group: this
    process's `device` holds one place of it. data_group: the ranks of this
    model index (the data axis; the whole group when model is 1);
    model_group: the ranks of this data block (None when model is 1). Both
    are None without a process group."""

    data: int
    model: int
    device: torch.device
    rank: int = 0
    distributed: bool = False   # a process group exists: collectives run
    data_group: Any = field(default=None, compare=False, repr=False)
    model_group: Any = field(default=None, compare=False, repr=False)
    axis_names: Tuple[str, str] = field(default=("data", "model"), init=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def data_index(self) -> int:
        """This rank's data block: its rows of a global batch."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """This rank's place on the model axis: its shard of a cut leaf."""
        return self.rank % self.model

    def rank_seed(self, seed: int) -> int:
        """The seed of this data block's own random stream (dropout,
        sampling): block 0 keeps `seed`, so a group of one draws what one
        process does, and the ranks of one block (model > 1) draw the same
        stream, as their replicated bridge and caches need."""
        return seed + 1_000_003 * self.data_index


# (data, model, the group's world) -> (data groups, model groups): every
# rank creates every subgroup once, in one order, as dist.new_group requires
_SUBGROUPS: dict = {}


def _subgroups(data: int, model: int) -> tuple:
    """This rank's (data group, model group) of a data x model mesh."""
    key = (data, model, id(dist.group.WORLD))
    if key not in _SUBGROUPS:
        world = dist.group.WORLD
        data_groups = ([world] if model == 1 else
                       [dist.new_group([d * model + m for d in range(data)])
                        for m in range(model)])
        model_groups = ([None] if model == 1 else
                        [world] if data == 1 else
                        [dist.new_group([d * model + m for m in range(model)])
                         for d in range(data)])
        _SUBGROUPS[key] = (data_groups, model_groups)
    data_groups, model_groups = _SUBGROUPS[key]
    r = dist.get_rank()
    return data_groups[r % model if model > 1 else 0], model_groups[
        r // model if model > 1 and data > 1 else 0]


def auto_mesh(data: Optional[int] = None, model: int = 1, *, device=None) -> Mesh:
    """The mesh over the group's processes (one process without a group, so
    model > 1 needs a group of data x model processes). device: this
    process's device (None: its card; without one this raises, as
    tools/loading.resolve_device does: there is no fallback to the CPU, which
    a caller asks for with device="cpu")."""
    n = distributed.world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    if device is None:
        from vlm_bridge_tpu_torch.tools.loading import resolve_device

        device = resolve_device("cuda")
        device = torch.device(device.type, torch.cuda.current_device())
    groups = _subgroups(data, model) if distributed.is_initialized() else (None, None)
    return Mesh(data=data, model=model, device=torch.device(device),
                rank=distributed.rank(), distributed=distributed.is_initialized(),
                data_group=groups[0], model_group=groups[1])


def replicate(mesh: Mesh, tree):
    """Every tensor of a nested dict set to rank 0's bits, in place; the
    tree is returned. Other leaves (a quantized dict's metadata) pass."""
    if not mesh.distributed:
        return tree
    with torch.no_grad():
        for leaf in _tensors(tree):
            dist.broadcast(leaf, src=0)
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    elif isinstance(tree, torch.Tensor):
        yield tree


def batch_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's contiguous block of a global batch of `rows` rows (the
    same for the ranks of one data block)."""
    if rows % mesh.data:
        raise ValueError(f"a batch of {rows} rows does not split over data={mesh.data}")
    per = rows // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


# Path pattern -> placements (data axis, model axis) of the frozen LM under
# tensor parallelism. Paths are "/"-joined keys, e.g. "lm/layers/3/attn/q".
# First match wins; the default is replicated. The JAX rules' PartitionSpecs
# as DTensor placements: P(None, "model") is Shard(1) on the model axis.
_LM_TP_RULES: Tuple[Tuple[str, tuple], ...] = (
    (r"lm/layers/\d+/attn/[qkv]$", (Replicate(), Shard(1))),   # head-sharded
    (r"lm/layers/\d+/attn/o$", (Replicate(), Shard(0))),
    (r"lm/layers/\d+/mlp/(gate|up)$", (Replicate(), Shard(1))),
    (r"lm/layers/\d+/mlp/down$", (Replicate(), Shard(0))),
    # the JAX scan layout's stacked leaves (a leading [num_layers // 2] dim;
    # "tail" is one unstacked layer)
    (r"lm/layers_scan/[ab]/attn/[qkv]$", (Replicate(), Shard(2))),
    (r"lm/layers_scan/[ab]/attn/o$", (Replicate(), Shard(1))),
    (r"lm/layers_scan/[ab]/mlp/(gate|up)$", (Replicate(), Shard(2))),
    (r"lm/layers_scan/[ab]/mlp/down$", (Replicate(), Shard(1))),
    (r"lm/layers_scan/tail/attn/[qkv]$", (Replicate(), Shard(1))),
    (r"lm/layers_scan/tail/attn/o$", (Replicate(), Shard(0))),
    (r"lm/layers_scan/tail/mlp/(gate|up)$", (Replicate(), Shard(1))),
    (r"lm/layers_scan/tail/mlp/down$", (Replicate(), Shard(0))),
    (r"lm/embedding$", (Replicate(), Replicate())),          # replicated (tied head)
)
_REPLICATED = (Replicate(), Replicate())


def _spec_for_path(path: str, use_model_axis: bool) -> tuple:
    if use_model_axis:
        for pattern, placements in _LM_TP_RULES:
            if re.search(pattern, path):
                return placements
    return _REPLICATED


def param_shardings(mesh: Mesh, params, *, use_model_axis: Optional[bool] = None):
    """The placements of every leaf of a (full or partial) parameter tree, in
    its nesting. use_model_axis defaults to model > 1."""
    if use_model_axis is None:
        use_model_axis = mesh.model > 1

    def assign(node, path):
        if isinstance(node, dict):
            return {k: assign(v, f"{path}/{k}" if path else str(k)) for k, v in node.items()}
        return _spec_for_path(path, use_model_axis)

    return assign(params, "")


def shard_params(mesh: Mesh, params, *, cfg=None, **kw):
    """Place the parameters by the rules: rank 0's bits are broadcast to
    every rank, then, with model > 1, each leaf that the table marks Shard
    (the float q / k / v / o / gate / up / down of the frozen LM; quantized
    leaves stay replicated, as the JAX rules' patterns do not match them)
    is cut to this rank's block and tagged with the model group, which the
    decoder's collectives follow (model_input / model_output). cfg: the
    VLMConfig or its Gemma2Config, needed to cut by whole heads: model must
    divide num_kv_heads and intermediate_size (ValueError; the JAX package
    would pad). Returns a new tree; the input's tensors hold rank 0's bits."""
    placements = param_shardings(mesh, params, **kw)
    replicate(mesh, params)
    if not any(p != _REPLICATED for p in _leaves(placements)):
        return params
    lm = getattr(cfg, "lm", cfg)
    if lm is None:
        raise ValueError("tensor parallelism needs the model config (cfg=) to cut the LM by "
                         "whole heads")
    if lm.num_kv_heads % mesh.model or lm.intermediate_size % mesh.model:
        raise ValueError(f"model={mesh.model} must divide num_kv_heads={lm.num_kv_heads} and "
                         f"intermediate_size={lm.intermediate_size}")

    def cut(node, spec):
        """model_index's contiguous 1/model of a leaf along its Shard dim (a
        copy), tagged with the model group."""
        if isinstance(node, dict):
            return {k: cut(v, spec[k]) for k, v in node.items()}
        if spec == _REPLICATED or not isinstance(node, torch.Tensor):
            return node
        dim = spec[1].dim
        per = node.shape[dim] // mesh.model
        block = node.detach().narrow(dim, mesh.model_index * per, per).clone(
            memory_format=torch.contiguous_format).requires_grad_(node.requires_grad)
        block.model_group = mesh.model_group
        return block

    return cut(params, placements)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _model_group_of(w):
    """The model group a weight leaf is cut over (shard_params), or None: a
    replicated leaf, a quantized dict, or a mesh without a process group."""
    return getattr(w, "model_group", None) if isinstance(w, torch.Tensor) else None


class _ModelInput(torch.autograd.Function):
    """The input of a column-cut product: identity forward, the gradient
    summed over the model group (each rank's heads give a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce_f32(grad, ctx.group), None


class _ModelOutput(torch.autograd.Function):
    """The output of a row-cut product: the ranks' partial sums summed over
    the model group; identity backward."""

    @staticmethod
    def forward(ctx, y, group):
        return distributed.all_reduce_f32(y, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def model_input(x: torch.Tensor, w) -> torch.Tensor:
    """x as the input of a product by `w`: where w is cut over a model
    group, the backward sums the gradient over it; else x."""
    group = _model_group_of(w)
    return x if group is None else _ModelInput.apply(x, group)


def model_output(y: torch.Tensor, w) -> torch.Tensor:
    """y, the product by `w`: where w is cut over a model group (its rows),
    the sum of the ranks' partial products; else y."""
    group = _model_group_of(w)
    return y if group is None else _ModelOutput.apply(y, group)


def shard_batch(mesh: Mesh, batch: dict, dtypes: Optional[dict] = None) -> dict:
    """A host batch (every rank holds the whole global batch) -> this rank's
    block of rows of each array as a tensor on mesh.device (lists, such as
    the captions, are dropped). dtypes: {key: torch dtype} casts on the host."""
    dtypes = dtypes or {}
    cuda = mesh.device.type == "cuda"
    out = {}
    for k, v in batch.items():
        if isinstance(v, list):
            continue
        rows = batch_sharding(mesh, v.shape[0])
        t = torch.from_numpy(np.ascontiguousarray(v[rows]))
        if k in dtypes:
            t = t.to(dtypes[k])
        if cuda:
            t = t.pin_memory()
        out[k] = t.to(mesh.device, non_blocking=cuda)
    return out
