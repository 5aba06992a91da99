"""Turn a JAX-package parameter tree into this port's parameters.

The input is the JAX tree as nested dicts of numpy arrays (for example
`jax.tree.map(np.asarray, params)`); the output has the same keys with
torch tensors, so both packages compute the same function. Both store
linear weights [in, out], int8 weights as {"w_int8", "scale"} and the
DINOv2 patch kernel HWIO, so no array is re-laid out: an int8 LM
(per-layer `qkv`, `o`, `gate`, `up`, `down` dicts and the int8 table) and an
int8 bridge come across with the same integers and scales, and both
packages decode from them. The int4 dicts come across the same way: a
rows-packed table {"w_int4", "scale"} and a `quantize_int4` weight, whose
"packing" string and "group_size" (an int or None) pass through unchanged.
bfloat16 arrays (numpy's ml_dtypes extension type) are widened through f32
exactly.

`from_jax` gives frozen tensors (requires_grad False): the vision and lm
subtrees of a train step, or a whole tree for serving. `bridge_from_jax`
turns a JAX TrainState's `bridge_params` into the port's f32 master copy,
whose leaves require grad, and `opt_state_from_jax` its optax state (the
clip -> AdamW chain, optionally inside MultiSteps) into the tree of
`BridgeOptimizer.state_dict`, so a JAX run's moments, step and accumulation
can be compared with the port's or trained on. `config_from_jax` turns one of
the JAX package's config dataclasses into the port's class of the same name.
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
    if tree is None or isinstance(tree, (str, bool, int, float)):
        return tree  # metadata of a quantized dict ("packing", "group_size")
    return _tensor(tree, device)


def bridge_from_jax(tree, device=None):
    """A JAX TrainState's bridge parameters (nested dicts of numpy arrays)
    -> the port's trainable bridge: f32 leaves with requires_grad=True."""
    if isinstance(tree, dict):
        return {k: bridge_from_jax(v, device) for k, v in tree.items()}
    return _tensor(tree, device).float().requires_grad_(True)


def _find(node, *fields):
    """The first node of an optax state (nested tuples / NamedTuples) that
    has all `fields`."""
    if all(hasattr(node, f) for f in fields):
        return node
    if isinstance(node, tuple):
        for child in node:
            found = _find(child, *fields)
            if found is not None:
                return found
    return None


def opt_state_from_jax(opt_state, device=None) -> dict:
    """A JAX TrainState's opt_state (numpy leaves or arrays) -> the tree
    that BridgeOptimizer.load_state_dict takes: the AdamW moments mu / nu,
    its step (the adam count), the schedule's count (optimizer steps) and,
    under MultiSteps, the mini step and the running mean of the gradients."""
    adam = _find(opt_state, "mu", "nu", "count")
    if adam is None:
        raise ValueError("no AdamW state (mu, nu, count) in this optax state")
    multi = _find(opt_state, "mini_step", "acc_grads")
    count = int(np.asarray(adam.count))
    out = {"mu": from_jax(adam.mu, device), "nu": from_jax(adam.nu, device),
           "adam_step": torch.tensor(float(count), dtype=torch.float32),
           "count": torch.tensor(count, dtype=torch.int64),
           "mini_step": torch.tensor(0 if multi is None else int(np.asarray(multi.mini_step)),
                                     dtype=torch.int64)}
    if multi is not None:
        out["acc"] = from_jax(multi.acc_grads, device)
    return out


def config_from_jax(cfg):
    """A config dataclass of the JAX package -> the port's class of the same
    name with the same field values (nested configs included)."""
    from vlm_bridge_tpu_torch import configs

    values = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return getattr(configs, type(cfg).__name__)(**{
        k: config_from_jax(v) if dataclasses.is_dataclass(v) else v for k, v in values.items()})
