"""Readings that set a cell's limits, on the card at the cell's own size:

    python3 -m portbench.control --workload CELL --seeds 11,12,13 --seconds 6 [--fault NAME]

For each seed it builds the cell, runs a short window at the cell's load
(long enough for the check's batches; training needs none), and prints one
JSON line with the program's compared numbers (the lower readings) and the
control's at the same positions (the reference in the precision below the
configuration's, as the workload file's "control" says: the upper
readings). With --fault, the named fault (portbench.faults) is planted under
the timed path and its numbers are read instead. The benchmark's own runs
never run this."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from portbench import faults
from portbench import run as runner


def readings(cell: str, seed: int, seconds: float, device, *, fault=None, control=True,
             spec=None, cfg_file=None) -> dict:
    import torch

    from portbench import spec as specs

    spec = spec or specs.workload(cell)
    cfg_file = cfg_file or specs.config(spec["config"])
    ctx = runner.Context(seed=seed, spec=spec, cfg_file=cfg_file,
                         vcfg=specs.vlm_config(cfg_file), device=device)
    table = faults.TRAINING if spec["entry"] == "train" else faults.SERVING
    plant = table[fault]() if fault else contextlib.nullcontext()
    t0 = time.perf_counter()
    with plant:
        entry = specs.entry(spec["entry"]).Cell(ctx)
        entry.setup()
        res = entry.window(seconds, False, tail=False)
    out = entry.check(spec.get("control") if control and not fault else None)
    out.update(seed=seed, fault=fault, failed=res["failed"], seconds=time.perf_counter() - t0)
    del entry
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma list")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    runner.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("the readings are taken on the card", file=sys.stderr)
        return 3
    rows = []
    for s in args.seeds.split(","):
        row = readings(args.workload, int(s), args.seconds, torch.device("cuda", 0),
                       fault=args.fault, control=not args.no_control)
        rows.append(row)
        print(json.dumps(row), flush=True)
    for key in ("numbers", "control"):
        names = sorted({n for r in rows for n in r.get(key, {})})
        summary = {n: {"max": max(r[key][n] for r in rows if n in r.get(key, {})),
                       "min": min(r[key][n] for r in rows if n in r.get(key, {}))} for n in names}
        print(json.dumps({"summary": key, "workload": args.workload, "fault": args.fault,
                          "seeds": len(rows), "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
