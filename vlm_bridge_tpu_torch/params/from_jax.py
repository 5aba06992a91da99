"""Turn a JAX-package parameter tree into this port's parameters.

The input is the JAX tree as nested dicts of numpy arrays (for example
`jax.tree.map(np.asarray, params)`); the output has the same keys with
torch tensors, so both packages compute the same function. Both store
linear weights [in, out], int8 weights as {"w_int8", "scale"} and the
DINOv2 patch kernel HWIO, so no array is re-laid out. bfloat16 arrays
(numpy's ml_dtypes extension type) are widened through f32 exactly.
"""

from __future__ import annotations

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
