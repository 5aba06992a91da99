"""The fused steps' graph counters over a benchmark caption cell on one GPU:
how many calls of ops/decode_kernels.fused_stack_step and fused_bridge_step
captured a position's CUDA graph and how many replayed one, during the
cell's set-up (its warm-up batches) and during an untraced window after it.

    python3 scripts/decode_graphs_torch.py --workload CELL --seed N [--seconds 20]

The cell is portbench's (`portbench/workloads/CELL.json`), set up as
`python3 -m portbench.run` sets it up. In a steady window every call is a
replay: calls = replays = batches x new tokens for each step, captures 0.
Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def counts() -> dict:
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    return {name: {k: getattr(fn, k) for k in ("launches", "captures", "replays")}
            for name, fn in (("stack", dk.fused_stack_step), ("bridge", dk.fused_bridge_step))}


def delta(after: dict, before: dict) -> dict:
    return {s: {k: after[s][k] - before[s][k] for k in after[s]} for s in after}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    import torch

    from portbench import run as runner, spec as specs

    runner.cache_env()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    spec = specs.workload(args.workload)
    cfg_file = specs.config(spec["config"])
    ctx = runner.Context(seed=args.seed, spec=spec, cfg_file=cfg_file,
                         vcfg=specs.vlm_config(cfg_file), device=dev)
    entry = specs.entry(spec["entry"]).Cell(ctx)
    start = counts()
    entry.setup()
    ready = counts()
    res = entry._timed(args.seconds, tail=False)
    torch.cuda.synchronize(dev)
    window = delta(counts(), ready)
    # the window's calls: every batch issued in it, each of new_tokens positions
    issued = res["attempted"] // spec["traffic"]["batch"]
    print(json.dumps({"cell": args.workload, "seed": args.seed, "setup": delta(ready, start),
                      "window": window, "batches_issued": issued,
                      "calls_expected": issued * spec["traffic"]["new_tokens"],
                      "all_replays": all(v["captures"] == 0 and v["replays"] == v["launches"]
                                         for v in window.values())}))


if __name__ == "__main__":
    main()
