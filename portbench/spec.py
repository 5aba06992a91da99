"""Finding a cell's files by name: BENCHMARK.json at the checkout's root,
workloads/<cell>.json, configs/<config>.json, entries/<entry>.py and
metrics/<metric>.py. Nothing here names a cell, a configuration or a metric."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, here: Path = HERE) -> dict:
    """workloads/<name>.json: {"config", "entry", "traffic", "checks"}."""
    spec = load_json(here / "workloads" / f"{name}.json")
    spec["name"] = name
    return spec


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def load_module(path: Path, name: str):
    """A module from a file whose name may hold dots (metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def entry(name: str, here: Path = HERE):
    return load_module(here / "entries" / f"{name}.py", f"portbench_entry_{name}")


def metric_reader(name: str, here: Path = HERE):
    """metrics/<name>.py's `read(trace) -> float | None`."""
    return load_module(here / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metrics of `kind` ("end_to_end" or "per_layer") this cell reports:
    those that list it under "workloads"; a metric without that key goes
    with every cell that reports the end-to-end metric it moves (per-layer)
    or with every cell (end-to-end)."""
    e2e = {m["name"]: m for m in bench["end_to_end"]}

    def has_e2e(name):
        m = e2e[name]
        return "workloads" not in m or cell in m["workloads"]

    out = []
    for m in bench[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or has_e2e(m["moves"]):
            out.append(m)
    return out


def vlm_config(cfg: dict):
    """The port's VLMConfig from a configuration file's "port" block."""
    from vlm_bridge_tpu_torch.configs import BridgeConfig, DinoV2Config, Gemma2Config, VLMConfig

    p = cfg["port"]
    return VLMConfig(vision=DinoV2Config(**p["vision"]), lm=Gemma2Config(**p["lm"]),
                     bridge=BridgeConfig(**p["bridge"]), image_size=p["image_size"])
