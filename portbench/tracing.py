"""The traced run: named ranges around the calls into each layer, opened from
the benchmark's own files, a torch.profiler window over them, and the
reading of its trace.

A kernel belongs to the range that was open on the host when its launch was
issued: the trace links each kernel to its launch by the correlation id, and
the launch lies inside the innermost `record_function` range on its thread.
The device is busy where a kernel, a copy or a memset runs; the window is
the outer range's length (or, where only the card was traced, the host
clock's reading around the traced work)."""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from bisect import bisect_left, bisect_right
from dataclasses import dataclass, field
from typing import Optional

import torch

from portbench.arith import BF16_FLOPS
from portbench.patch import patched

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@contextlib.contextmanager
def ranges(targets):
    """Within this block each (owner, attr, range name) of `targets` runs
    inside `torch.profiler.record_function(range name)`: the way
    chip_smoke.counting_phases wraps a function to count it."""
    def wrap(name):
        def make(fn):
            def run(*args, **kwargs):
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return run
        return make

    with contextlib.ExitStack() as stack:
        for owner, attr, name in targets:
            stack.enter_context(patched(owner, attr, wrap(name)))
        yield


@dataclass
class Trace:
    """What the metric readers read. kernels: (name, start_us, dur_us,
    range or None); busy_s / window_s: the device's busy seconds and the
    window's; work: the entry's counts of what the window held (batches,
    tokens, steps, bounds and FLOPs from portbench.arith)."""

    kernels: list
    busy_s: float
    window_s: float
    work: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    def range_seconds(self, *names) -> float:
        return sum(k[2] for k in self.kernels if k[3] in names) * 1e-6

    def kernel_seconds(self, pred) -> float:
        return sum(k[2] for k in self.kernels if pred(k[0])) * 1e-6


def idle_pct(trace: Trace) -> Optional[float]:
    """The share of the traced window in which no kernel, copy or memset ran
    on the device (the profiler's device activity against the window's
    length)."""
    if trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.window_s)


def mfu_pct(trace: Trace) -> Optional[float]:
    """The whole step's share of the card's bf16 peak: the model FLOPs of the
    untraced window's work, counted once from the shapes (portbench.arith),
    over the window's seconds (the entry's `flops_per_s`) against 989 TFLOP/s.
    The profiler's own cost stays out of it."""
    rate = trace.work.get("flops_per_s")
    return 100.0 * rate / BF16_FLOPS if rate else None


def profile(device, host: bool = True):
    """The profiler the traced window runs under: the card's activity, and
    with `host` the host's ops and the named ranges (which cost the host
    some microseconds an op)."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU] if host or device.type != "cuda" else []
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read(prof, work: dict, window_s: Optional[float] = None) -> Trace:
    """Export the profiler's trace to a temporary file, read it, delete it.
    window_s: the window's length on the host clock, where the trace holds
    no window range (a run that traced the card alone)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return parse(events, work, window_s)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, t, reach: int = 5000) -> Optional[str]:
    """The innermost of `spans` ((start, end, name) of one thread, sorted by
    start, nested as a call stack) that holds time t: the latest-starting
    one, looked for among the `reach` spans that start last before t."""
    i = bisect_right(spans, (t, float("inf"), "")) - 1
    for j in range(i, max(i - reach, -1), -1):
        a, b, name = spans[j]
        if a <= t <= b:
            return name
    return None


def parse(events: list, work: dict, window_s: Optional[float] = None) -> Trace:
    """A Trace from chrome-trace events (the profiler's `traceEvents`). The
    window is the WINDOW range; without one (the card traced alone), the
    span of the device's activity, and `window_s` its length."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev_x = [e for e in xs if e.get("cat") in DEVICE_CATS]
    windows = [e for e in xs if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if windows:
        win = windows[0]
        w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
        length = w1 - w0
    elif window_s is not None:
        win = {}
        length = window_s * 1e6
        w0 = min((float(e["ts"]) for e in dev_x), default=0.0)
        w1 = max((float(e["ts"]) + float(e["dur"]) for e in dev_x), default=w0 + length)
    else:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range and no window length")
    # the host's named ranges by thread, and each launch's thread and time
    spans = {}
    for e in xs:
        if e.get("cat") == "user_annotation" and e["name"] != WINDOW:
            spans.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))
    for v in spans.values():
        v.sort()
    launch = {}
    for e in xs:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in LAUNCH_CATS and corr is not None:
            launch[corr] = (e.get("tid"), float(e["ts"]))
    kernels, device = [], []
    for e in dev_x:
        a, d = float(e["ts"]), float(e["dur"])
        if a + d < w0 or a > w1:
            continue
        device.append((max(a, w0), min(a + d, w1)))
        if e["cat"] != "kernel":
            continue
        where = launch.get(e.get("args", {}).get("correlation"))
        rng = _innermost(spans.get(where[0], []), where[1]) if where else None
        kernels.append((e["name"], a, d, rng))
    busy = _union(device)
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in xs
                  if e.get("cat") in ("cpu_op", "user_annotation") and e["name"] != WINDOW
                  and e.get("tid") == win.get("tid"))
    trace = Trace(kernels=kernels, busy_s=sum(b - a for a, b in busy) * 1e-6,
                  window_s=length * 1e-6, work=work)
    trace.breakdown = breakdown(kernels, busy, (w0, w1), host)
    return trace


def short_name(name: str) -> str:
    """A kernel's name without "void", anonymous namespaces, template
    arguments and parameter list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    for cut in ("<", "("):
        if cut in name:
            name = name.split(cut)[0]
    return name.strip()[:120] or "unnamed"


def breakdown(kernels, busy, window, host) -> dict:
    """The ten device operations that took most time (seconds, by name), and
    the idle stretches' seconds summed by what the host was doing at their
    start (the innermost host op or range on the window's thread; where the
    host was between ops, or was not traced, the kernel the device waited
    for), the ten largest."""
    by = {}
    for name, _, d, _ in kernels:
        key = short_name(name)
        by[key] = by.get(key, 0.0) + d * 1e-6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    gaps, t = [], window[0]
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if window[1] > t:
        gaps.append((t, window[1]))
    starts = sorted((k[1], k[0]) for k in kernels)
    idle = {}
    for a, b in gaps:
        what = _innermost(host, a) if host else None
        if what is None:
            i = bisect_left(starts, (b - 1.0, ""))
            nxt = starts[i][1] if i < len(starts) else None
            what = "host between ops, before " + short_name(nxt) if nxt else "host between ops"
        idle[what] = idle.get(what, 0.0) + (b - a) * 1e-6
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps_by]}
