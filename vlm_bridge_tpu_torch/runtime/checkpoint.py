"""Checkpoint store in the reference's three-slot scheme (port of
vlm_bridge_tpu.runtime.checkpoint).

Slots (reference save_checkpoint, training_orchestrator.py:104-156):
  latest/            the full train state, written at every save
  best/              the full train state at the best validation loss
  best_weights_only/ the bridge parameters alone (the deploy artifact)

A slot holds one `torch.save` file per top-level subtree
(`bridge_params.pt`, `opt_state.pt`: nested dicts of CPU tensors, read back
with `torch.load(weights_only=True)`) and the counters in `meta.json`. A
slot is written to `<slot>.tmp` and replaces the old slot only once every
file of it is written, so a reader never sees half a slot. The frozen
towers are not stored: they come from their seeded init or their snapshots,
as the reference filters its state dict on "bridge_module".

`.pth` interop lives in params/torch_bridge.py; `export_pth` writes a
reference-loadable weights file from any slot.

Under a process group every rank calls `save`; rank 0 alone writes and
swaps, between two barriers, so no rank reads a half-swapped slot and none
races ahead (as the JAX store does around orbax).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from vlm_bridge_tpu_torch.parallel import distributed


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _fit(name: str, saved, template):
    """`saved` in the nesting of `template`, each leaf on its template
    leaf's device; raises where a key is missing or a leaf's shape or dtype
    differs."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or not set(template) <= set(saved):
            raise ValueError(f"restore of {name!r}: the slot lacks "
                             f"{sorted(set(template) - set(saved or {}))}")
        return {k: _fit(f"{name}/{k}", saved[k], v) for k, v in template.items()}
    if not isinstance(saved, torch.Tensor) or tuple(saved.shape) != tuple(template.shape) \
            or saved.dtype != template.dtype:
        got = (tuple(saved.shape), saved.dtype) if isinstance(saved, torch.Tensor) else saved
        raise ValueError(f"restore of {name!r}: leaf mismatch (template "
                         f"{tuple(template.shape)}/{template.dtype} vs restored {got})")
    return saved.to(template.device)


class CheckpointStore:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _slot(self, name: str) -> Path:
        return self.dir / name

    def save(self, slot: str, *, bridge_params, opt_state=None,
             meta: Optional[Dict[str, Any]] = None) -> None:
        """Write a slot: into `<slot>.tmp`, then swap it for the old slot.
        opt_state: BridgeOptimizer.state_dict's tree (None: weights only).
        Under a process group: call it on every rank; rank 0 writes."""
        distributed.barrier()
        if distributed.rank() == 0:
            tree = {"bridge_params": bridge_params}
            if opt_state is not None:
                tree["opt_state"] = opt_state
            path, tmp = self._slot(slot), self.dir / (slot + ".tmp")
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
            for key, sub in tree.items():
                torch.save(_to_cpu(sub), tmp / f"{key}.pt")
            (tmp / "meta.json").write_text(json.dumps(meta or {}, indent=2))
            if path.exists():
                shutil.rmtree(path)
            tmp.rename(path)
        distributed.barrier()

    def exists(self, slot: str) -> bool:
        return self._slot(slot).exists()

    def load(self, slot: str, *, template) -> Tuple[Any, Dict[str, Any]]:
        """Restore a slot. `template` ({"bridge_params": ..., "opt_state":
        ...}, a fresh state's trees) gives the structure, the shapes, the
        dtypes and the devices; a template of only some of the slot's
        subtrees reads only those (a weights-only load of a full slot). A
        leaf whose shape or dtype differs from the template's raises.
        template=None reads every subtree as saved, on the CPU."""
        path = self._slot(slot)
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint slot: {path}")
        keys = sorted(p.stem for p in path.glob("*.pt")) if template is None else list(template)
        restored = {}
        for key in keys:
            saved = self._read(path, key)
            restored[key] = saved if template is None else _fit(key, saved, template[key])
        meta_file = path / "meta.json"
        meta = json.loads(meta_file.read_text()) if meta_file.exists() else {}
        return restored, meta

    @staticmethod
    def _read(path: Path, key: str):
        f = path / f"{key}.pt"
        if not f.exists():
            raise ValueError(f"restore of {key!r}: slot {path} has no {f.name}")
        return torch.load(f, map_location="cpu", weights_only=True)

    def export_pth(self, slot: str, bridge_cfg, out_path: str | Path, *, template=None) -> None:
        """Slot -> reference-format .pth (weights only). template: optional
        {"bridge_params": ...} the weights are checked against."""
        from vlm_bridge_tpu_torch.params import torch_bridge

        if template is None:
            path = self._slot(slot)
            if not path.exists():
                raise FileNotFoundError(f"no checkpoint slot: {path}")
            params = self._read(path, "bridge_params")
        else:
            restored, _ = self.load(slot, template={"bridge_params": template["bridge_params"]})
            params = restored["bridge_params"]
        torch_bridge.save_pth(params, bridge_cfg, out_path)
