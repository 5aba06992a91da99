"""Profiling: a step timer with an optional torch.profiler window (port of
vlm_bridge_tpu.runtime.profiling).

    prof = StepProfiler(trace_dir="logs/trace", start_step=10, num_steps=5)
    for batch in loader:
        with prof.step():
            state, metrics = train_step(...)
    prof.summary()  # {"step_ms_p50": ..., "step_ms_mean": ...}

Steps [start_step, start_step + num_steps) run under torch.profiler (the
CPU and, where present, the CUDA activity), written to trace_dir as a Chrome
trace when the window closes; steps outside it pay one time.monotonic()
call. A loop that queues work on the device without waiting for it times
fenced windows instead (`add_window`): each window between two host reads
of the metrics adds its mean step time once.

The program's spans (`annotate`) sit at the call sites of its layers:
vlm.token, vlm.bridge_step, vlm.stack_step, vlm.head and vlm.sampler in
the decode loop, and vlm.train_step, vlm.forward (with vlm.encode),
vlm.backward and vlm.optimizer in training. They cost one flag check when
nothing records; under a torch.profiler (StepProfiler's window included)
they are ranges in its trace, on its clock beside the kernels and runtime
calls it records.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch


class StepProfiler:
    def __init__(self, *, trace_dir: Optional[str | Path] = None, start_step: int = 10,
                 num_steps: int = 5, warmup: int = 2):
        self.trace_dir = str(trace_dir) if trace_dir else None
        self.start_step = start_step
        self.num_steps = num_steps
        self.warmup = warmup          # first N steps excluded from timing stats
        self._step = 0
        self._prof = None
        self._times_ms: List[float] = []

    def _start_trace(self) -> None:
        Path(self.trace_dir).mkdir(parents=True, exist_ok=True)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def _stop_trace(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        prof.export_chrome_trace(str(Path(self.trace_dir) / f"trace_step{self.start_step}.json"))

    @contextlib.contextmanager
    def step(self, record_time: bool = True):
        """Wrap one training step; manages the trace window and the timing.
        record_time=False skips the per-step wall-time sample (for loops that
        feed fenced windows through add_window)."""
        if self.trace_dir and self._prof is None and self._step == self.start_step:
            self._start_trace()
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = (time.monotonic() - t0) * 1000
            if record_time and self._step >= self.warmup:
                self._times_ms.append(dt)
            self._step += 1
            if self._prof is not None and self._step >= self.start_step + self.num_steps:
                self._stop_trace()

    def add_window(self, steps: int, seconds: float) -> None:
        """Record a fenced window of `steps` steps taking `seconds` in all."""
        if steps > 0:
            self._times_ms.append(1000.0 * seconds / steps)

    def close(self) -> None:
        if self._prof is not None:
            self._stop_trace()

    def summary(self) -> Dict[str, float]:
        if not self._times_ms:
            return {}
        xs = sorted(self._times_ms)
        n = len(xs)
        return {
            "step_ms_mean": sum(xs) / n,
            "step_ms_p50": xs[n // 2],
            "step_ms_p90": xs[min(n - 1, int(n * 0.9))],
            "step_ms_min": xs[0],
            "step_ms_max": xs[-1],
            "steps_timed": float(n),
        }


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The program's span `name` around a call. Off (no torch.profiler
    recording) it is one shared null context: no range, no clock reading,
    no tensor touched. On, it is the profiler's range "vlm.<name>"."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function("vlm." + name)
    return _OFF
