"""The ("data", "model") mesh and its placements (port of
vlm_bridge_tpu.parallel.sharding, data parallelism only).

Axes:
  "data"  the batch: each process holds a contiguous block of every global
          batch's rows on its card, and the bridge gradients are summed over
          the group before the clip (training/train_step.py);
  "model" tensor parallelism of the frozen Gemma decoder. It is not ported:
          a mesh with model > 1 raises NotImplementedError. The JAX rules'
          placements are kept as a table (`param_shardings`) that nothing
          executes while model is 1.

The trainable bridge is replicated: every rank starts from rank 0's bits
(`shard_params` broadcasts every tensor of the tree), and the same summed
gradients keep the AdamW updates equal on every rank.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from vlm_bridge_tpu_torch.parallel import distributed


@dataclass(frozen=True)
class Mesh:
    """A ("data", "model") description over the process group: this
    process's `device` holds one place of it."""

    data: int
    model: int
    device: torch.device
    rank: int = 0
    distributed: bool = False   # a process group exists: collectives run
    axis_names: Tuple[str, str] = field(default=("data", "model"), init=False)

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def rank_seed(self, seed: int) -> int:
        """The seed of this rank's own random stream (dropout, sampling):
        rank 0 keeps `seed`, so a group of one draws what one process does."""
        return seed + 1_000_003 * self.rank


def auto_mesh(data: Optional[int] = None, model: int = 1, *, device=None) -> Mesh:
    """The mesh over the group's processes (one process without a group).
    device: this process's device (None: its card when CUDA is there, else
    the CPU)."""
    if model > 1:
        raise NotImplementedError("tensor parallelism of the frozen LM is not ported")
    n = distributed.world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} processes")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if torch.cuda.is_available() else torch.device("cpu"))
    return Mesh(data=data, model=model, device=torch.device(device),
                rank=distributed.rank(), distributed=distributed.is_initialized())


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
    """This rank's contiguous block of a global batch of `rows` rows."""
    if rows % mesh.data:
        raise ValueError(f"a batch of {rows} rows does not split over data={mesh.data}")
    per = rows // mesh.data
    block = mesh.rank // mesh.model
    return slice(block * per, (block + 1) * per)


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


def shard_params(mesh: Mesh, params, **kw):
    """Place the parameters by the rules: with model 1 every leaf is
    replicated, so rank 0's bits are broadcast to every rank."""
    placements = param_shardings(mesh, params, **kw)
    if any(p != _REPLICATED for p in _leaves(placements)):
        raise NotImplementedError("tensor parallelism of the frozen LM is not ported")
    return replicate(mesh, params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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
