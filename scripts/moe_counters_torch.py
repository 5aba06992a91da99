"""The routed experts' counters over a benchmark caption cell with experts on
one GPU: how the routing spread the rows over each layer's experts, and
how many row slots the expert products computed for them, over an untraced
window after the cell's set-up; and, from the routing log of the window's
last batch, how many experts each step touched.

    python3 scripts/moe_counters_torch.py --workload CELL --seed N [--seconds 20]

The cell is portbench's (`portbench/workloads/CELL.json`, an entry with
experts such as caption_moe), set up as `python3 -m portbench.run` sets it
up. The counter is the decode session's device tensor
(vlm_bridge_tpu_torch.ops.decode_kernels.moe_counters), read once the
window's tokens are on the host: rows routed to each (layer, expert), and the
largest and smallest expert load against the mean, the experts touched in
the window, the padding (row slots computed, `moe_slot_rows` a step, layer
and expert, that no row was routed to). The routing log
(decode_kernels.moe_route_log) gives the experts touched at each (position,
layer) of the last batch: their least and mean. It also reads the
stack step's calls in the window: every one a replay of a captured graph,
and every one with experts (`moe_calls`). Prints the card's name and power
limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    import torch

    from portbench import run as runner, spec as specs
    from portbench.entries import caption_moe
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    runner.cache_env()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    spec = specs.workload(args.workload)
    cfg_file = specs.config(spec["config"])
    ctx = runner.Context(seed=args.seed, spec=spec, cfg_file=cfg_file, vcfg=None, device=dev)
    entry = specs.entry(spec["entry"]).Cell(ctx)
    entry.setup()
    caption_moe.counters(reset=True)
    step = dk.fused_stack_step
    before = {k: getattr(step, k) for k in ("launches", "captures", "replays", "moe_calls")}
    res = entry._timed(args.seconds, tail=False)
    torch.cuda.synchronize(dev)
    calls = {k: getattr(step, k) - v for k, v in before.items()}
    got = caption_moe.counters()
    rows = got["rows"].double()
    L, E = rows.shape
    B = spec["traffic"]["batch"]
    slots = float(dk.moe_slot_rows(B) * E * L * calls["moe_calls"])
    mean = rows.mean(dim=1)
    log = caption_moe.route_log()[:spec["traffic"]["new_tokens"]]
    step_touched = (log > 0).any(dim=2).sum(dim=-1).double()   # [T, L]
    print(json.dumps({
        "cell": args.workload, "seed": args.seed,
        "batches_issued": res["attempted"] // spec["traffic"]["batch"],
        "stack_calls": calls,
        "all_replays": calls["captures"] == 0 and calls["replays"] == calls["launches"]
        == calls["moe_calls"],
        "rows_routed": int(rows.sum()), "row_slots_computed": int(slots),
        "pad_pct": 100.0 * (slots - float(rows.sum())) / slots,
        "experts_touched_per_layer": [int((r > 0).sum()) for r in rows],
        "experts_touched_a_step_min": int(step_touched.min()),
        "experts_touched_a_step_mean": float(step_touched.mean()),
        "load_max_over_mean_per_layer": [round(float(r.max() / m), 4) for r, m in zip(rows, mean)],
        "load_min_over_mean_per_layer": [round(float(r.min() / m), 4) for r, m in zip(rows, mean)],
        "load_max_over_mean": float((rows.max(dim=1).values / mean).max()),
        "load_min_over_mean": float((rows.min(dim=1).values / mean).min())}))


if __name__ == "__main__":
    main()
