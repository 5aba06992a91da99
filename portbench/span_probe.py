"""Read one cell by the port's own spans: set-up, an untraced window, then
the cell's traced batches or steps under the host-and-card profiler, read
by portbench.spans beside the benchmark's own readers on the same trace.
Prints one JSON line; correctness is not checked (portbench.run does that).

    python3 -m portbench.span_probe --workload <cell> --seed <n> [--seconds 20] [--out FILE]

A caption cell reports the decode loop's readings a token (`caption`), the
benchmark's range readers next to the device ms of the span around the same
call (`twins`), and the batch's ms untraced and traced. The train cell
reports the host's ms to issue a step with nothing recording (a clock around
each call, no synchronise until the last), launches and span times a step
under the profiler (`train`), and the step's ms untraced and traced. Both
give the host's cost of an annotate() call with nothing recording."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

from portbench import run as runner


def events_of(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def annotate_off_us(calls: int = 200_000) -> float:
    """Host µs of one `with annotate(...)` with nothing recording."""
    from vlm_bridge_tpu_torch.runtime.profiling import annotate

    t0 = time.perf_counter()
    for _ in range(calls):
        with annotate("token"):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def caption(entry, untimed: dict, bench: dict, cell: str) -> dict:
    import torch

    from portbench import spans, spec as specs, tracing, traffic

    n = entry.t["trace_batches"]
    entry.traced = True
    with tracing.ranges(entry._targets()), tracing.profile(entry.dev) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            t0 = time.perf_counter()
            done = entry._loop(lambda i: i < n)
            traffic.sync(entry.dev)
            traced_s = time.perf_counter() - t0
    entry.traced = False
    events = events_of(prof)
    work = entry.work(len(done))
    tr = tracing.parse(events, work)
    reads = {m["name"]: specs.metric_reader(m["name"])(tr)
             for m in specs.cell_metrics(bench, cell, "per_layer")}
    got = spans.caption_readings(spans.Events(events), work["tokens"])
    dev = got.get("span_device_ms", {})
    twins = {"bridge_step_ms": [reads.get("bridge_step_ms"), dev.get("vlm.bridge_step")],
             "stack_step_ms": [reads.get("stack_step_ms"), dev.get("vlm.stack_step")],
             "head_ms": [reads.get("head_ms"),
                         dev.get("vlm.head", 0.0) + dev.get("vlm.sampler", 0.0)]}
    rate = untimed["e2e"]["captions_per_s"]
    return {"tokens": work["tokens"], "caption": got, "twins": twins, "benchmark": reads,
            "batch_ms_untraced": 1e3 * entry.t["batch"] / rate,
            "batch_ms_traced": 1e3 * traced_s / len(done),
            "idle_pct": tracing.idle_pct(tr)}


def train(entry, untimed: dict) -> dict:
    import torch

    from portbench import spans, tracing, traffic

    k = entry.t["trace_steps"]
    host_ms = []
    for _ in range(2 * k):
        batch = traffic.to_device(entry.pool[entry.n % entry.t["pool"]], entry.dev)
        t0 = time.perf_counter()
        entry.state, _ = entry.step(entry.state, entry.frozen, batch, entry.drop)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        entry.n += 1
    traffic.sync(entry.dev)
    with tracing.profile(entry.dev) as prof:
        with torch.profiler.record_function(tracing.WINDOW):
            t0 = time.perf_counter()
            for _ in range(k):
                entry._one()
            traffic.sync(entry.dev)
            traced_s = time.perf_counter() - t0
    events = events_of(prof)
    rate = untimed["e2e"]["train_samples_per_s"]
    return {"host_step_ms": host_ms, "host_step_ms_median": statistics.median(host_ms),
            "train": spans.train_readings(spans.Events(events)),
            "step_ms_untraced": 1e3 * entry.t["batch"] / rate,
            "step_ms_traced": 1e3 * traced_s / k}


def probe(cell: str, seed: int, seconds: float, device, *, bench: dict,
          spec: dict | None = None, cfg_file: dict | None = None) -> dict:
    import torch

    from portbench import spec as specs

    spec = spec or specs.workload(cell)
    cfg_file = cfg_file or specs.config(spec["config"])
    ctx = runner.Context(seed=seed, spec=spec, cfg_file=cfg_file,
                         vcfg=specs.vlm_config(cfg_file), device=device)
    entry = specs.entry(spec["entry"]).Cell(ctx)
    entry.setup()
    untimed = entry.window(seconds, False, tail=False)
    out = {"cell": cell, "seed": seed, "annotate_off_us": annotate_off_us(),
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if spec["entry"] == "caption":
        out.update(caption(entry, untimed, bench, cell))
    else:
        out.update(train(entry, untimed))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.span_probe",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None, help="also write the line to this file")
    args = ap.parse_args(argv)
    runner.cache_env()
    import torch

    from portbench import spec as specs

    if not torch.cuda.is_available():
        print("no measurement: no CUDA device", file=sys.stderr)
        return 3
    out = probe(args.workload, args.seed, args.seconds, torch.device("cuda", 0),
                bench=specs.benchmark())
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
