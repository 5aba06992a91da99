"""The port's program spans (runtime/profiling.annotate) at the tiny size on
the CPU: off, a span is one shared null context that opens no profiler
range, reads no clock and adds no tensor op; on, it is the profiler's range
"vlm.<name>", and captioning and the train step produce the same tokens and
losses as off, with the spans in the trace nested as the call sites place
them."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vlm_bridge_tpu_torch.configs import TrainingConfig, VLMConfig
from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
from vlm_bridge_tpu_torch.runtime import profiling
from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params
from vlm_bridge_tpu_torch.training import train_step as ts

NEW = 5
TRAIN_STEPS = 2


def _cfg() -> VLMConfig:
    base = VLMConfig.tiny_test()
    # a window past the caption's cache rows, so the fused stack decode serves
    return dataclasses.replace(base, lm=dataclasses.replace(base.lm, sliding_window=128))


@pytest.fixture(scope="module")
def serving():
    """int8 weights and bridge, stacked once, as the serving recipe holds
    them; the vision features of two images."""
    cfg = _cfg()
    params = full_model.init(cfg, generator=torch.Generator().manual_seed(5),
                             frozen_dtype=torch.float32)
    params["lm"] = gemma2.quantize_params(params["lm"])
    params["bridge"] = bridge.quantize_decode_params(params["bridge"])
    gen = GenerationConfig(max_length=NEW, greedy=True, kv_quant=True)
    params = prestack_decode_params(params, cfg, gen)
    assert "stacked_decode" in params["lm"]
    pixels = torch.randn(2, cfg.image_size, cfg.image_size, 3,
                         generator=torch.Generator().manual_seed(1))
    return cfg, params, full_model.encode_image(params, cfg, pixels)


def _generate(serving, greedy: bool):
    cfg, params, vision = serving
    gen = GenerationConfig(max_length=NEW, greedy=greedy, kv_quant=True, temperature=1.0,
                           top_p=0.95, topk_window=32)
    toks, _ = generate_tokens(params, cfg, vision_features=vision, gen=gen,
                              generator=torch.Generator().manual_seed(9),
                              activation_dtype=torch.float32)
    return toks


def _spans(prof, tmp_path) -> list:
    """(name, start, end) of the trace's vlm.* ranges, by name, then start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("vlm."))


def _inside(spans, outer, name) -> list:
    return [s for s in spans if s[0] == name and outer[1] <= s[1] and s[2] <= outer[2]]


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_off_is_one_null_context_with_no_range_clock_or_op(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for clock in ("perf_counter", "perf_counter_ns", "monotonic", "monotonic_ns"):
        monkeypatch.setattr(profiling.time, clock, refuse)
    a, b = profiling.annotate("token"), profiling.annotate("train_step")
    assert a is b
    with _CountOps() as mode:
        with profiling.annotate("stack_step"):
            pass
    assert mode.ops == []


def test_on_is_the_profilers_range_and_adds_no_op(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with _CountOps() as mode:
            with profiling.annotate("token"):
                with profiling.annotate("head"):
                    pass
                with profiling.annotate("head"):
                    pass
    # the range's own enter and exit, and no tensor op
    assert mode.ops and all(op.namespace == "profiler" for op in mode.ops)
    spans = _spans(prof, tmp_path)
    assert [s[0] for s in spans] == ["vlm.head", "vlm.head", "vlm.token"]
    assert len(_inside(spans, spans[2], "vlm.head")) == 2
    assert profiling.annotate("token") is profiling.annotate("head")


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_generate_spans_leave_tokens_and_nest(serving, greedy, monkeypatch, tmp_path):
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function",
                  lambda *a, **k: (_ for _ in ()).throw(AssertionError("entered while off")))
        off = _generate(serving, greedy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _generate(serving, greedy)
    assert torch.equal(off, traced)

    spans = _spans(prof, tmp_path)
    tokens = [s for s in spans if s[0] == "vlm.token"]
    assert len(tokens) == NEW
    inner = ["vlm.bridge_step", "vlm.stack_step", "vlm.head"] + ([] if greedy
                                                                 else ["vlm.sampler"])
    for tok in tokens:
        for name in inner:
            assert len(_inside(spans, tok, name)) == 1, (name, tok)
    assert {s[0] for s in spans} == {"vlm.token", *inner}


def _train_setup():
    cfg = _cfg()
    tc = TrainingConfig(batch_size=2, loss_chunk_size=8, learning_rate=1e-3, min_lr=1e-4,
                        num_epochs=1)
    params = full_model.init(cfg, generator=torch.Generator().manual_seed(3),
                             frozen_dtype=torch.float32)
    frozen = ts.split_frozen(params)
    state, opt = ts.init_train_state(params, tc, steps_per_epoch=10)
    step = ts.make_train_step(cfg, tc, opt, ts.make_schedule(tc, 10),
                              activation_dtype=torch.float32)
    g = torch.Generator().manual_seed(4)
    batch = {"pixel_values": torch.randint(0, 256, (2, cfg.image_size, cfg.image_size, 3),
                                           generator=g, dtype=torch.uint8),
             "input_ids": torch.randint(3, cfg.lm.vocab_size, (2, 12), generator=g),
             "attn_mask": torch.tensor([[1] * 12, [1] * 7 + [0] * 5])}
    return step, state, frozen, batch


def _train():
    step, state, frozen, batch = _train_setup()
    drop = torch.Generator().manual_seed(8)
    losses = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step(state, frozen, batch, drop)
        losses.append(metrics["loss"])
    return torch.stack(losses), ts.tree_leaves(state.bridge_params)


def test_train_step_spans_leave_losses_and_nest(tmp_path):
    off, off_leaves = _train()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced, traced_leaves = _train()
    assert torch.equal(off, traced)
    for a, b in zip(off_leaves, traced_leaves):
        assert torch.equal(a, b)

    spans = _spans(prof, tmp_path)
    steps = [s for s in spans if s[0] == "vlm.train_step"]
    assert len(steps) == TRAIN_STEPS
    for st in steps:
        for name in ("vlm.forward", "vlm.backward", "vlm.optimizer"):
            assert len(_inside(spans, st, name)) == 1, name
        (fwd,) = _inside(spans, st, "vlm.forward")
        assert len(_inside(spans, fwd, "vlm.encode")) == 1
    assert {s[0] for s in spans} == {"vlm.train_step", "vlm.forward", "vlm.encode",
                                     "vlm.backward", "vlm.optimizer"}


def test_step_profiler_trace_holds_the_train_step(tmp_path):
    step, state, frozen, batch = _train_setup()
    drop = torch.Generator().manual_seed(8)
    prof = profiling.StepProfiler(trace_dir=tmp_path / "trace", start_step=1, num_steps=1,
                                  warmup=0)
    for _ in range(3):
        with prof.step():
            state, _ = step(state, frozen, batch, drop)
    prof.close()
    events = json.loads((tmp_path / "trace" / "trace_step1.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert names.count("vlm.train_step") == 1
    assert {"vlm.forward", "vlm.backward", "vlm.optimizer"} <= set(names)
