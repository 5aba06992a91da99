"""The benchmark of the PyTorch / CUDA port (`vlm_bridge_tpu_torch`).

`python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell once on the card and prints one JSON line. Everything a cell
needs is found by name: `BENCHMARK.json` at the repository root lists the
cells and metrics, `workloads/<cell>.json` names the configuration, the entry
and the traffic, `configs/<config>.json` holds the model's sizes,
`entries/<entry>.py` drives the port, `metrics/<metric>.py` reads one
per-layer metric from the traced run. `reference/` is the plain PyTorch model
that decides `correct`; it imports nothing of the port.
"""

import sys
import time


def log(msg: str) -> None:
    """A line of progress on standard error (standard output holds the result)."""
    print(f"[portbench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)
