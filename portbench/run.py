"""Run one cell once on the card and print one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With --trace 0 the line holds the cell's end-to-end metrics (BENCHMARK.json's
`end_to_end` that apply to it), with --trace 1 its per-layer metrics, read by
metrics/<name>.py from a torch.profiler trace of a few batches or steps that
follow the same untraced window (the whole step's share of the peak is read
from that window, so the profiler's own cost stays out of it).
Every run checks what its timed path produced against the plain reference
(reference/) and prints each compared number beside its limit, on standard
error and last in the JSON line. The run refuses to measure without a card,
or with fewer cards than the cell asks for, and refuses to print a result if
JAX or the JAX package was loaded into the process."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "vlm_bridge_tpu")


def process_start() -> float:
    """The wall-clock time this process started (from /proc; where that
    is not readable, the time this module was first run)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
ROOT = Path(__file__).resolve().parent.parent


def cache_env() -> None:
    """Build and kernel caches at fixed places inside the checkout; no
    library that the port loads may bring JAX in."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (the whole name: vlm_bridge_tpu_torch is not vlm_bridge_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Context:
    seed: int
    spec: dict         # workloads/<cell>.json
    cfg_file: dict     # configs/<config>.json
    vcfg: object       # the port's VLMConfig
    device: object


def run(cell: str, seed: int, seconds: float, trace: bool, device, *, bench: dict,
        spec: dict | None = None, cfg_file: dict | None = None) -> dict:
    """One run of `cell` on `device`; returns the result line's object."""
    import torch

    from portbench import log
    from portbench import spec as specs

    spec = spec or specs.workload(cell)
    cfg_file = cfg_file or specs.config(spec["config"])
    ctx = Context(seed=seed, spec=spec, cfg_file=cfg_file, vcfg=specs.vlm_config(cfg_file),
                  device=device)
    entry = specs.entry(spec["entry"]).Cell(ctx)
    log(f"{time.time() - T_START:.1f} s after the process started: set-up begins")
    entry.setup()
    setup_s = time.time() - T_START
    res = entry.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    if trace:
        tr = res["trace"]
        for m in specs.cell_metrics(bench, cell, "per_layer"):
            value = specs.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**res["e2e"], "setup_s": setup_s}
        for m in specs.cell_metrics(bench, cell, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    checked = entry.check()
    checks = {}
    for name, lim in spec["checks"].items():
        value = checked["numbers"].get(name)
        checks[name] = {"value": value, "limit": lim["limit"]}
    correct = (res["attempted"] > 0 and res["failed"] == 0 and bool(checks)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = res["trace"].busy_s
        dev["window_s"] = res["trace"].window_s
        out["breakdown"] = res["trace"].breakdown
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    stdout = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        import torch

        from portbench import spec as specs

        bench = specs.benchmark()
        cells = {w["name"]: w for w in bench["workloads"]}
        if args.workload not in cells:
            print(f"unknown workload {args.workload!r}", file=sys.stderr)
            return 2
        chips = cells[args.workload]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no measurement: the cell needs {chips} CUDA device(s), this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        out = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda", 0), bench=bench)
        found = forbidden_modules()
        if found:
            print(f"refused: the process loaded {found}", file=sys.stderr)
            return 4
        for name, c in out["checks"].items():
            print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
        print(f"correct: {out['correct']}", file=sys.stderr)
    print(json.dumps(out), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
