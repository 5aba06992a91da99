"""Turn a JAX-package parameter tree into this port's parameters.

The input is the JAX tree as nested dicts of numpy arrays (for example
`jax.tree.map(np.asarray, params)`); the output has the same keys with
torch tensors, so both packages compute the same function. Both store
linear weights [in, out], int8 weights as {"w_int8", "scale"} and the
DINOv2 patch kernel HWIO, so no array is re-laid out: an int8 LM
(per-layer `qkv`, `o`, `gate`, `up`, `down` dicts and the int8 table) and an
int8 bridge come across with the same integers and scales, and both
packages decode from them. bfloat16 arrays (numpy's ml_dtypes extension
type) are widened through f32 exactly.

`from_jax` gives frozen tensors (requires_grad False): the vision and lm
subtrees of a train step, or a whole tree for serving. `bridge_from_jax`
turns a JAX TrainState's `bridge_params` into the port's f32 master copy,
whose leaves require grad. `config_from_jax` turns one of the JAX package's
config dataclasses into the port's class of the same name.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def from_jax(tree, device=None):
    """Nested dicts of numpy arrays -> the same nesting of torch tensors."""
    if isinstance(tree, dict):
        if "stacked_decode" in tree:
            raise ValueError("stacked_decode holds the TPU kernel layout; convert the "
                             "per-layer tree and stack it with the port's "
                             "gemma2.stack_decode_params")
        return {k: from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def bridge_from_jax(tree, device=None):
    """A JAX TrainState's bridge parameters (nested dicts of numpy arrays)
    -> the port's trainable bridge: f32 leaves with requires_grad=True."""
    if isinstance(tree, dict):
        return {k: bridge_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device).float().requires_grad_(True)


def config_from_jax(cfg):
    """A config dataclass of the JAX package -> the port's class of the same
    name with the same field values (nested configs included)."""
    from vlm_bridge_tpu_torch import configs

    values = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(configs, type(cfg).__name__)(**{
        k: config_from_jax(v) if dataclasses.is_dataclass(v) else v for k, v in values.items()})
