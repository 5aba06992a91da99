"""The port's own spans in a trace. The port opens a profiler range named
"vlm.<layer>" around the call into each of its layers
(vlm_bridge_tpu_torch/runtime/profiling.annotate): in the decode loop
vlm.token for each position and, inside it, vlm.bridge_step,
vlm.stack_step, vlm.head and vlm.sampler; in training vlm.train_step with
vlm.forward (vlm.encode in it), vlm.backward and vlm.optimizer.

`launches_per_token` reads the Trace that portbench.tracing.parse makes,
where each kernel carries the innermost range open on its launch's thread,
the benchmark's or the program's. The rest reads the profiler's raw events
(`Events`): each kernel and runtime call put down to the innermost program
span on its thread, the benchmark's ranges left aside. portbench.span_probe
runs a cell and prints those readings."""

from __future__ import annotations

from bisect import bisect_right
from typing import Optional

from portbench import tracing

TOKEN = "vlm.token"
# the spans the loop opens inside vlm.token
IN_TOKEN = ("vlm.bridge_step", "vlm.stack_step", "vlm.head", "vlm.sampler")
# the benchmark's own ranges around the loop's decode calls (entries/caption.py's
# _targets), opened inside the spans around the same calls
LOOP_RANGES = ("stack_step", "bridge_step", "head", "sampler")
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# runtime calls in which the host waits for the stream to drain
WAITS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")


def launches_per_token(trace) -> Optional[float]:
    """Kernels a token launched while vlm.token was open: those whose
    innermost range is vlm.token or a span in it, and those of the
    benchmark's ranges around the loop's decode calls, which the loop alone
    opens (inside vlm.token). One kernel a launch call. Nothing where no
    kernel ran directly in vlm.token (a program without the span)."""
    tokens = trace.work.get("tokens")
    if not tokens or not any(k[3] == TOKEN for k in trace.kernels):
        return None
    n = sum(1 for k in trace.kernels if k[3] == TOKEN or k[3] in IN_TOKEN or k[3] in LOOP_RANGES)
    return n / tokens


class Events:
    """The profiler's raw events (`traceEvents`) read by the program's spans.
    spans: thread -> [(start, end, name)] of its vlm.* ranges, by start;
    calls: (thread, start, dur, name) of the runtime calls; kernels: (name,
    start, dur, the innermost span holding its launch as (start, end, name)
    or None), a launch from a thread without spans (autograd's) put down to
    the window thread's innermost span at its time; busy: the device's busy
    intervals (kernels, copies, memsets), merged; window: the WINDOW range's
    (start, end) and thread."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        win = next((e for e in xs if e.get("cat") == "user_annotation"
                    and e["name"] == tracing.WINDOW), None)
        if win is None:
            raise RuntimeError(f"the trace holds no {tracing.WINDOW!r} range")
        self.tid = win.get("tid")
        self.window = (float(win["ts"]), float(win["ts"]) + float(win["dur"]))
        self.spans = {}
        for e in xs:
            if e.get("cat") == "user_annotation" and e["name"].startswith("vlm."):
                a = float(e["ts"])
                self.spans.setdefault(e.get("tid"), []).append((a, a + float(e["dur"]),
                                                                e["name"]))
        for v in self.spans.values():
            v.sort()
        self.calls, launch = [], {}
        for e in xs:
            if e.get("cat") in tracing.LAUNCH_CATS:
                self.calls.append((e.get("tid"), float(e["ts"]), float(e["dur"]), e["name"]))
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch[corr] = (e.get("tid"), float(e["ts"]))
        w0, w1 = self.window
        self.kernels, device = [], []
        for e in xs:
            if e.get("cat") not in tracing.DEVICE_CATS:
                continue
            a, d = float(e["ts"]), float(e["dur"])
            if a + d < w0 or a > w1:
                continue
            device.append((max(a, w0), min(a + d, w1)))
            if e["cat"] == "kernel":
                where = launch.get(e.get("args", {}).get("correlation"))
                span = None
                if where is not None:
                    tid = where[0] if where[0] in self.spans else self.tid
                    span = self.span_at(tid, where[1])
                self.kernels.append((e["name"], a, d, span))
        self.kernels.sort(key=lambda k: k[1])
        self.busy = tracing._union(device)

    def span_at(self, tid, t) -> Optional[tuple]:
        """The innermost program span open on thread `tid` at time t."""
        spans = self.spans.get(tid, [])
        for j in range(bisect_right(spans, (t, float("inf"), "")) - 1, -1, -1):
            a, b, _ = spans[j]
            if a <= t <= b:
                return spans[j]
        return None

    def outer(self, name: str) -> list:
        """(start, end) of the window thread's spans `name`, by start."""
        return [(a, b) for a, b, n in self.spans.get(self.tid, []) if n == name]

    def busy_within(self, a: float, b: float) -> float:
        return sum(max(0.0, min(b, y) - max(a, x)) for x, y in self.busy)

    def gaps(self) -> list:
        """The window's idle stretches on the device, (start, end)."""
        out, t = [], self.window[0]
        for a, b in self.busy:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out


def _in(intervals, t) -> bool:
    i = bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def caption_readings(ev: Events, tokens: int) -> dict:
    """The decode loop's readings a token, in ms unless named otherwise:
    launches_per_token (launch calls on the window's thread inside
    vlm.token), host_sync_ms (the host in WAITS there), host_calls_ms (every
    runtime call there, by name), token_idle_ms (device gaps that start while
    vlm.token is open) and idle_by_span_ms (every gap by the innermost span
    open at its start; "none" outside them), stack_gemm_ms / stack_attn_ms /
    stack_other_ms (device ms of the kernels launched in vlm.stack_step, by
    name), stack_gap_ms (per vlm.stack_step, the device idle between its
    first kernel's start and its last kernel's end), span_device_ms (device
    ms a token of the kernels by innermost span), span_host_ms (each span's
    mean host ms under the profiler)."""
    tok = ev.outer(TOKEN)
    if not tok or not tokens:
        return {}
    calls = [c for c in ev.calls if c[0] == ev.tid and _in(tok, c[1])]
    by_call = {}
    for _, _, d, name in calls:
        by_call[name] = by_call.get(name, 0.0) + d
    idle, in_token = {}, 0.0
    for a, b in ev.gaps():
        s = ev.span_at(ev.tid, a)
        key = s[2] if s else "none"
        idle[key] = idle.get(key, 0.0) + (b - a)
        if _in(tok, a):
            in_token += b - a
    stack = {"decode_gemm_kernel": 0.0, "stack_attn_kernel": 0.0, "other": 0.0}
    runs, device_by = {}, {}
    for name, a, d, span in ev.kernels:
        key = span[2] if span else "none"
        device_by[key] = device_by.get(key, 0.0) + d
        if key != "vlm.stack_step":
            continue
        part = next((p for p in stack if p in name), "other")
        stack[part] += d
        run = runs.setdefault(span, [a, a + d])
        run[0], run[1] = min(run[0], a), max(run[1], a + d)
    gap = sum((b - a) - ev.busy_within(a, b) for a, b in runs.values())
    host_by, count_by = {}, {}
    for a, b, name in ev.spans.get(ev.tid, []):
        host_by[name] = host_by.get(name, 0.0) + (b - a)
        count_by[name] = count_by.get(name, 0) + 1
    ms = 1e-3 / tokens
    return {
        "tokens_counted": len(tok),
        "launches_per_token": sum(1 for c in calls if c[3] in LAUNCHES) / tokens,
        "host_sync_ms": sum(by_call.get(n, 0.0) for n in WAITS) * ms,
        "host_calls_ms": {n: v * ms for n, v in sorted(by_call.items(), key=lambda kv: -kv[1])},
        "token_idle_ms": in_token * ms,
        "idle_by_span_ms": {n: v * ms for n, v in sorted(idle.items(), key=lambda kv: -kv[1])},
        "stack_gemm_ms": stack["decode_gemm_kernel"] * ms,
        "stack_attn_ms": stack["stack_attn_kernel"] * ms,
        "stack_other_ms": stack["other"] * ms,
        "stack_gap_ms": gap * ms,
        "span_device_ms": {n: v * ms for n, v in sorted(device_by.items())},
        "span_host_ms": {n: host_by[n] * 1e-3 / count_by[n] for n in sorted(host_by)},
    }


def train_readings(ev: Events) -> dict:
    """A train step's readings: steps (the window thread's vlm.train_step
    spans), launches_per_step (launch calls on any thread while one is open:
    autograd's thread issues the backward's), launches_by_thread (the window's
    thread and the others), span_host_ms (each span's mean host ms under the
    profiler) and span_device_ms (device ms a step by innermost span)."""
    steps = ev.outer("vlm.train_step")
    if not steps:
        return {}
    mine = others = 0
    for tid, a, _, name in ev.calls:
        if name in LAUNCHES and _in(steps, a):
            if tid == ev.tid:
                mine += 1
            else:
                others += 1
    host_by, count_by = {}, {}
    for a, b, name in ev.spans.get(ev.tid, []):
        host_by[name] = host_by.get(name, 0.0) + (b - a)
        count_by[name] = count_by.get(name, 0) + 1
    device_by = {}
    for _, _, d, span in ev.kernels:
        key = span[2] if span else "none"
        device_by[key] = device_by.get(key, 0.0) + d
    n = len(steps)
    return {
        "steps": n,
        "launches_per_step": (mine + others) / n,
        "launches_by_thread": {"window": mine / n, "other": others / n},
        "span_host_ms": {k: host_by[k] * 1e-3 / count_by[k] for k in sorted(host_by)},
        "span_device_ms": {k: v * 1e-3 / n for k, v in sorted(device_by.items())},
    }
