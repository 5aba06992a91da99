"""The trace reading on a hand-made profiler trace: kernels attributed to
the range their launch was issued in, busy and idle time, the breakdown, and
each per-layer reader."""

from __future__ import annotations

import pytest

from portbench import spec, tracing


def X(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": args}


EVENTS = [
    X("user_annotation", tracing.WINDOW, 0, 1000),
    X("user_annotation", "encode", 10, 100),
    X("cpu_op", "aten::mm", 20, 10),
    X("cuda_runtime", "cudaLaunchKernel", 22, 2, correlation=1),
    X("user_annotation", "stack_step", 200, 50),
    X("cuda_runtime", "cudaLaunchKernelExC", 210, 2, correlation=2),
    X("cuda_runtime", "cudaLaunchKernel", 220, 2, correlation=3),
    X("cuda_runtime", "cudaLaunchKernel", 400, 2, correlation=4),
    X("kernel", "void (anonymous namespace)::fa_fwd_sm90_kernel<64>(P)", 100, 100, tid=7,
      correlation=1),
    X("kernel", "decode_gemm_kernel<false, 4, 2>", 300, 200, tid=7, correlation=2),
    X("kernel", "stack_attn_kernel", 500, 100, tid=7, correlation=3),
    X("kernel", "void at::native::vectorized_elementwise_kernel<4>(x)", 700, 50, tid=7,
      correlation=4),
    X("gpu_memcpy", "Memcpy HtoD", 40, 20, tid=7),
]


def test_parse_attributes_and_counts():
    tr = tracing.parse(EVENTS, {"batches": 2, "tokens": 4, "steps": 2, "stack_bound_s": 1.5e-4,
                                "flops_per_s": 989e12 * 0.25})
    assert tr.window_s == pytest.approx(1e-3)
    # device busy: 40-60, 100-200, 300-600, 700-750
    assert tr.busy_s == pytest.approx(470e-6)
    assert tr.range_seconds("encode") == pytest.approx(100e-6)
    assert tr.range_seconds("stack_step") == pytest.approx(300e-6)
    assert tr.range_seconds("bridge_step") == 0.0
    ops = dict(tr.breakdown["device_ops"])
    assert ops["decode_gemm_kernel"] == pytest.approx(200e-6)
    assert ops["fa_fwd_sm90_kernel"] == pytest.approx(100e-6)
    idle = dict(tr.breakdown["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(530e-6)
    assert idle["encode"] == pytest.approx(40e-6)           # 60-100, inside encode
    assert idle["stack_step"] == pytest.approx(100e-6)      # 200-300
    assert idle["host between ops, before fa_fwd_sm90_kernel"] == pytest.approx(40e-6)
    assert idle["host between ops"] == pytest.approx(250e-6)  # 750-1000
    reads = {m["name"]: spec.metric_reader(m["name"])(tr) for m in spec.benchmark()["per_layer"]}
    assert reads["encode_ms"] == pytest.approx(0.05)
    assert reads["stack_step_ms"] == pytest.approx(0.075)
    assert reads["stack_step_roofline_pct"] == pytest.approx(50.0)
    assert reads["bridge_step_ms"] is None and reads["head_ms"] is None
    assert reads["device_idle_pct.caption"] == pytest.approx(53.0)
    assert reads["mfu.caption"] == pytest.approx(25.0)
    assert reads["flash_ms.train"] == pytest.approx(0.05)
    assert reads["elementwise_ms.train"] == pytest.approx(0.025)


def test_parse_without_a_window_range():
    ev = [e for e in EVENTS if e["cat"] not in ("user_annotation", "cpu_op")]
    tr = tracing.parse(ev, {"steps": 1}, window_s=1e-3)
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(470e-6)
    assert all(k[3] is None for k in tr.kernels)
    assert any(name.startswith("host between ops, before ")
               for name, _ in tr.breakdown["idle_gaps"])


def test_ranges_wrap_and_keep_launch_counts():
    import types

    def fn(x):
        fn.launches += 1
        return x + 1

    fn.launches = 3
    mod = types.SimpleNamespace(f=fn)
    with tracing.ranges([(mod, "f", "r")]):
        assert mod.f is not fn
        assert mod.f(1) == 2
    assert mod.f is fn and fn.launches == 4
