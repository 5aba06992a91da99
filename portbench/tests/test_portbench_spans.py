"""The readers of the port's own spans (portbench.spans) on hand-made traces
of two decode tokens and two train steps, each value worked out by hand;
every reader of the benchmark's own ranges reading the same with the
program's spans around its ranges as without them; and the probe
(portbench.span_probe) through each entry at the tiny size on the CPU."""

from __future__ import annotations

import pytest

import torch

from portbench import span_probe, spans, spec, tracing
from portbench.tests import tiny
from portbench.tests.test_portbench_trace import X

NEW = ("launches_per_token",)


def R(name, ts, dur):
    return X("user_annotation", name, ts, dur)


def L(ts, corr, name="cudaLaunchKernel", tid=1):
    return X("cuda_runtime", name, ts, 2, tid=tid, correlation=corr)


def K(name, ts, dur, corr):
    return X("kernel", name, ts, dur, tid=7, correlation=corr)


GEMM, ATTN = "decode_gemm_kernel<true, 8, 2>", "stack_attn_kernel<128>"
EVENTS = [
    R(tracing.WINDOW, 0, 3000),
    R("encode", 10, 40), L(20, 1),
    # token 0
    R("vlm.token", 100, 500),
    R("vlm.bridge_step", 110, 40), R("bridge_step", 112, 36), L(120, 2, "cudaLaunchKernelExC"),
    L(160, 3),                                   # an eager op of the token
    X("cuda_runtime", "cudaMemcpyAsync", 170, 20, correlation=40),
    R("vlm.stack_step", 200, 100), R("stack_step", 202, 96),
    L(210, 4, "cudaLaunchKernelExC"), L(220, 5), L(230, 6, "cudaLaunchKernelExC"),
    R("vlm.head", 400, 50), R("head", 402, 46), L(410, 7),
    # token 1
    R("vlm.token", 700, 500),
    R("vlm.bridge_step", 710, 40), R("bridge_step", 712, 36), L(720, 8, "cudaLaunchKernelExC"),
    R("vlm.stack_step", 800, 100), R("stack_step", 802, 96),
    L(810, 9, "cudaLaunchKernelExC"), L(820, 10),
    R("vlm.head", 1000, 50), R("head", 1002, 46), L(1010, 11),
    L(1100, 12),                                 # the token's bookkeeping
    # after the loop
    L(1250, 13),
    K("fa_fwd_sm90_kernel", 30, 50, 1),
    K(GEMM, 1300, 40, 2),                        # the bridge's products on the same core
    K("elementwise_kernel", 1345, 5, 3),
    X("gpu_memcpy", "Memcpy HtoD", 1352, 3, tid=7),
    K(GEMM, 1360, 40, 4),
    K(ATTN, 1410, 20, 5),                        # 10 us idle before it
    K(GEMM, 1430, 30, 6),
    K("tied_head_kernel", 1470, 10, 7),
    K(GEMM, 1500, 40, 8),
    K(GEMM, 1550, 50, 9),
    K(ATTN, 1605, 15, 10),                       # 5 us idle before it
    K("tied_head_kernel", 1630, 10, 11),
    K("where_kernel", 1650, 5, 12),
    K("cat_kernel", 1700, 5, 13),
]
WORK = {"batches": 1, "tokens": 2, "steps": 1, "stack_bound_s": 1e-4, "flops_per_s": 1e12}


def _reads(events) -> dict:
    tr = tracing.parse(events, dict(WORK))
    return tr, {m["name"]: spec.metric_reader(m["name"])(tr)
                for m in spec.benchmark()["per_layer"]}


def test_launches_per_token_by_hand():
    _, reads = _reads(EVENTS)
    # kernels of launches 2-7 in token 0 and 8-12 in token 1 (not 1 nor 13)
    assert reads["launches_per_token"] == pytest.approx(11 / 2)
    assert reads["stack_step_ms"] == pytest.approx((40 + 20 + 30 + 50 + 15) * 1e-3 / 2)


def test_launches_per_token_reads_the_token_span():
    """Silent without vlm.token (a program without the span); the same
    without the spans nested in it, whose calls the benchmark's ranges hold."""
    no_token = [e for e in EVENTS if e["name"] != "vlm.token"]
    assert _reads(no_token)[1]["launches_per_token"] is None
    nested = [e for e in EVENTS if e["name"] not in spans.IN_TOKEN]
    assert _reads(nested)[1]["launches_per_token"] == pytest.approx(11 / 2)


def test_benchmark_readers_unmoved_by_the_program_spans():
    """The same trace without its vlm.* ranges (a program that opens none):
    every reader of the benchmark's ranges, busy_s and the window read the
    same, and the span readers read nothing."""
    bare = [e for e in EVENTS if not e["name"].startswith("vlm.")]
    with_spans, a = _reads(EVENTS)
    without, b = _reads(bare)
    assert with_spans.busy_s == without.busy_s and with_spans.window_s == without.window_s
    assert with_spans.breakdown["device_ops"] == without.breakdown["device_ops"]
    for name in a:
        if name in NEW:
            assert b[name] is None, name
        else:
            assert a[name] == b[name], name
    assert a["bridge_step_ms"] == pytest.approx(80e-3 / 2)
    assert a["head_ms"] == pytest.approx(20e-3 / 2)
    assert a["encode_ms"] == pytest.approx(50e-3)


# two tokens on the host's and the device's clocks together (microseconds)
RAW = [
    R(tracing.WINDOW, 0, 1000),
    R("vlm.token", 100, 300),
    L(110, 1), K("embed_kernel", 115, 5, 1),
    R("vlm.bridge_step", 120, 40), R("bridge_step", 121, 38),
    L(130, 2, "cudaLaunchKernelExC"), K(GEMM, 135, 20, 2),
    R("vlm.stack_step", 170, 80), R("stack_step", 171, 78),
    L(180, 3, "cudaLaunchKernelExC"), K(GEMM, 185, 30, 3),
    L(190, 4), K(ATTN, 225, 10, 4),
    L(200, 5, "cudaLaunchKernelExC"), K(GEMM, 235, 20, 5),
    X("cuda_runtime", "cudaMemcpyAsync", 255, 3),
    X("cuda_runtime", "cudaStreamSynchronize", 260, 40),
    R("vlm.head", 310, 30), R("head", 311, 28), L(320, 6), K("tied_head_kernel", 325, 10, 6),
    L(350, 7), K("where_kernel", 360, 5, 7),
    R("vlm.token", 500, 300),
    L(510, 8), K("embed_kernel", 515, 5, 8),
    R("vlm.stack_step", 520, 40), R("stack_step", 521, 38),
    L(530, 9, "cudaLaunchKernelExC"), K(GEMM, 540, 30, 9),
    L(850, 10), K("cat_kernel", 855, 5, 10),
]


def test_caption_readings_by_hand():
    got = spans.caption_readings(spans.Events(RAW), tokens=2)
    assert got["tokens_counted"] == 2
    assert got["launches_per_token"] == pytest.approx(9 / 2)
    assert got["host_sync_ms"] == pytest.approx(40e-3 / 2)
    assert got["host_calls_ms"]["cudaMemcpyAsync"] == pytest.approx(3e-3 / 2)
    # gaps starting in vlm.token: 120-135, 155-185, 215-225, 255-325, 335-360,
    # 365-515, 520-540, 570-855; not 0-115 nor 860-1000
    assert got["token_idle_ms"] == pytest.approx(605e-3 / 2)
    idle = {k: v * 2e3 for k, v in got["idle_by_span_ms"].items()}
    assert idle == pytest.approx({"none": 255, "vlm.bridge_step": 45, "vlm.stack_step": 30,
                                  "vlm.token": 505, "vlm.head": 25})
    assert got["stack_gemm_ms"] == pytest.approx(80e-3 / 2)
    assert got["stack_attn_ms"] == pytest.approx(10e-3 / 2)
    assert got["stack_other_ms"] == 0
    # 215-225 inside token 0's stack step; none in token 1's
    assert got["stack_gap_ms"] == pytest.approx(10e-3 / 2)
    dev = {k: v * 2e3 for k, v in got["span_device_ms"].items()}
    assert dev == pytest.approx({"vlm.token": 15, "vlm.bridge_step": 20, "vlm.stack_step": 90,
                                 "vlm.head": 10, "none": 5})
    assert got["span_host_ms"]["vlm.token"] == pytest.approx(0.3)
    # the benchmark's twin of the stack span reads the same kernels
    tr = tracing.parse(RAW, dict(WORK))
    assert spec.metric_reader("stack_step_ms")(tr) == pytest.approx(got["stack_gemm_ms"]
                                                                      + got["stack_attn_ms"])
    assert spans.launches_per_token(tr) == pytest.approx(9 / 2)


def test_caption_readings_without_the_spans():
    assert spans.caption_readings(spans.Events(
        [e for e in RAW if not e["name"].startswith("vlm.")]), tokens=2) == {}
    no_stack = spans.caption_readings(spans.Events(
        [e for e in RAW if e["name"] != "vlm.stack_step"]), tokens=2)
    assert no_stack["stack_gemm_ms"] == 0 and no_stack["stack_gap_ms"] == 0


TRAIN = [
    R(tracing.WINDOW, 0, 1000),
    R("vlm.train_step", 10, 390), R("vlm.forward", 20, 80), R("vlm.encode", 30, 30),
    L(40, 1), K("k1", 45, 5, 1), L(80, 2), K("k2", 85, 10, 2),
    R("vlm.backward", 110, 190),
    L(150, 3, tid=2), K("k3", 155, 20, 3), L(200, 4, tid=2), K("k4", 205, 20, 4),
    R("vlm.optimizer", 310, 80), L(320, 5), K("k5", 325, 5, 5),
    L(450, 6), K("k6", 455, 5, 6),
    R("vlm.train_step", 500, 400), R("vlm.forward", 510, 90), L(520, 7), K("k7", 525, 5, 7),
    L(950, 8, tid=3),
]


def test_train_readings_by_hand():
    got = spans.train_readings(spans.Events(TRAIN))
    assert got["steps"] == 2
    # 1, 2, 5 and autograd's 3, 4 in the first step; 7 in the second
    assert got["launches_per_step"] == pytest.approx(6 / 2)
    assert got["launches_by_thread"] == pytest.approx({"window": 2.0, "other": 1.0})
    assert got["span_host_ms"] == pytest.approx({"vlm.train_step": 0.395, "vlm.forward": 0.085,
                                                 "vlm.encode": 0.03, "vlm.backward": 0.19,
                                                 "vlm.optimizer": 0.08})
    # autograd's kernels go to the window thread's vlm.backward
    assert {k: v * 2e3 for k, v in got["span_device_ms"].items()} == pytest.approx(
        {"vlm.encode": 5, "vlm.forward": 15, "vlm.backward": 40, "vlm.optimizer": 5, "none": 5})


@pytest.mark.parametrize("cell", ["tiny-sampled", "tiny-train"])
def test_probe_runs_tiny(cell):
    spec_ = dict(tiny.CELLS[cell], name=cell)
    out = span_probe.probe(cell, 6, 0.5, torch.device("cpu"), bench=tiny.bench(), spec=spec_,
                           cfg_file=tiny.CFG_FILE)
    t = spec_["traffic"]
    assert out["annotate_off_us"] > 0
    if cell == "tiny-train":
        assert out["train"]["steps"] == t["trace_steps"]
        assert len(out["host_step_ms"]) == 2 * t["trace_steps"]
        assert set(out["train"]["span_host_ms"]) == {"vlm.train_step", "vlm.forward",
                                                      "vlm.encode", "vlm.backward",
                                                      "vlm.optimizer"}
    else:
        assert out["caption"]["tokens_counted"] == out["tokens"] == (t["trace_batches"]
                                                                      * t["new_tokens"])
        assert {"vlm.token", "vlm.stack_step", "vlm.head",
                "vlm.sampler"} <= set(out["caption"]["span_host_ms"])
