"""The routed decoder's cell at a tiny size on the CPU (the port's plain
versions in place of its kernels): a whole window comes out correct, each
planted fault of the routing (portbench.faults_moe) and the serving faults
come out not correct, on several seeds; the reference's near-tie rule by
hand; arith_moe's counts by hand; the older readers unchanged on a trace
that holds the new kernels; and the cell's entries in
BENCHMARK.json fit the benchmark's."""

from __future__ import annotations

import copy

import pytest
import torch

from portbench import arith, arith_moe, control, faults, faults_moe, spec, tracing
from portbench import run as runner
from portbench.entries import caption_moe
from portbench.reference import moe as ref_moe
from portbench.tests import tiny

TINY_MOE_PORT = copy.deepcopy(tiny.TINY_PORT)
# 8 query heads over 1 KV head of 32; 16 experts of 64, 4 a token; full on every 4th layer
TINY_MOE_PORT["lm"].update(num_heads=8, num_kv_heads=1, head_dim=32, query_pre_attn_scalar=32.0)
TINY_MOE_PORT["moe"] = {"num_experts": 16, "experts_per_token": 4, "moe_intermediate_size": 64,
                        "norm_topk_prob": True, "full_every": 4, "router_std": 0.02}
CFG_FILE = {"name": "tiny-moe", "port": TINY_MOE_PORT}
CELL = "tiny-moe"
SPEC = copy.deepcopy(tiny.CAPTION)
SPEC.update(config="tiny-moe", entry="caption_moe")
# one image, so that the checked batches do not depend on how many the window held;
# the reference takes the program's experts within 0.03 of a row's logit spread of
# its k-th (at 0.01 a quarter of the seeds still swap an expert)
SPEC["traffic"].update(pool=1, route_margin=0.03)
# the geometric middles of the sound readings over seeds 1-10 (greedy_gap <= 0.002,
# greedy_gap_mean <= 8.9e-5, route_gap <= 7.9e-4) and the least a fault read on them (a
# dropped expert: 0.092, 4.6e-3, 0.028; top-7, weights left unrenormalized and a stale
# cache read route_gap >= 0.54)
SPEC["checks"] = {"greedy_gap": {"limit": 0.014}, "greedy_gap_mean": {"limit": 6e-4},
                  "route_gap": {"limit": 5e-3}}
SEED = 5
SEEDS = (1, 2, 3)
SPEC["control"] = {"forms": {"attn": "int4", "mlp": "int4", "table": "int4_rows",
                             "bridge": "int4"}}
CFG = caption_moe.moe_config(CFG_FILE)


MELLUM = "mellum2-caption-greedy-int8"
MELLUM_CONFIG = "dinov2l-bridge-mellum2-12b-a2.5b"
# the metrics the Mellum2 cell shares with the older caption cells
SHARED = ("captions_per_s", "batch_ms_p90", "encode_ms", "bridge_step_ms", "stack_step_ms",
          "stack_step_roofline_pct", "head_ms", "device_idle_pct.caption", "mfu.caption",
          "launches_per_token")


def bench() -> dict:
    """The benchmark with the Mellum2 cell's lists pointing at the tiny cell."""
    full = spec.benchmark()

    def retarget(m):
        m = dict(m)
        if "workloads" in m and MELLUM in m["workloads"]:
            m["workloads"] = [CELL]
        return m

    return {**full, "workloads": [{"name": CELL, "config": "tiny-moe", "traffic": CELL,
                                   "chips": 1, "why": "test"}],
            "end_to_end": [retarget(m) for m in full["end_to_end"]],
            "per_layer": [retarget(m) for m in full["per_layer"]]}


def run(seed: int = SEED, trace: bool = False) -> dict:
    return runner.run(CELL, seed, 10.0, trace, torch.device("cpu"), bench=bench(),
                      spec=dict(copy.deepcopy(SPEC), name=CELL), cfg_file=CFG_FILE)


@pytest.mark.parametrize("seed", SEEDS)
def test_the_cell_is_correct_on_each_seed(seed):
    out = run(seed)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_tiny_and_is_correct(trace):
    out = run(trace=trace)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    names = set(out["metrics"])
    listed = {m["name"] for m in spec.cell_metrics(bench(), CELL,
                                                   "per_layer" if trace else "end_to_end")}
    assert names <= listed
    if trace:
        # no kernel on the CPU: the whole step's share only (the padding counts the
        # slots of the calls that ran the kernels)
        assert names == {"mfu.caption"}
    else:
        assert names == listed


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", sorted(faults_moe.SERVING) + sorted(faults.SERVING))
def test_a_planted_fault_is_not_correct(fault, seed):
    table = {**faults.SERVING, **faults_moe.SERVING}
    with table[fault]():
        out = run(seed)
    assert out["correct"] is False, (fault, out["checks"])


@pytest.mark.parametrize("fault", sorted(faults_moe.SERVING))
def test_a_routing_fault_reads_above_the_route_limit(fault):
    """Top-7, unrenormalized weights and a dropped expert each move the
    routing itself past its limit, whatever the served tokens show."""
    with faults_moe.SERVING[fault]():
        out = run(SEEDS[0])
    c = out["checks"]["route_gap"]
    assert c["value"] > c["limit"], (fault, c)


def test_control_reads_far_above_the_program():
    r = control.readings(CELL, SEED, 4.0, torch.device("cpu"),
                         spec=dict(copy.deepcopy(SPEC), name=CELL), cfg_file=CFG_FILE)
    n = "greedy_gap"
    assert r["control"][n] > max(3 * r["numbers"][n], SPEC["checks"][n]["limit"]), r


def test_reference_routing_by_hand():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [0.0, 0.0, 0.0, 0.0]])
    w, e = ref_moe.route(logits, 2, True)
    assert e.tolist() == [[1, 2], [0, 1]]     # ties to the lower index
    assert torch.allclose(w, torch.full((2, 2), 0.5))
    w, _ = ref_moe.route(logits, 2, False)
    assert torch.allclose(w[1], torch.full((2,), 0.25))


def test_reference_follows_only_near_ties():
    """The reference takes another routing's experts where they lie within
    the margin of its k-th logit, with its own weights over them; not where
    one lies further below, nor where they are not k."""
    logits = torch.tensor([[4.0, 2.0, 1.99, -4.0]] * 3)   # std 3.46: margin 0.1 = 0.35
    follow = torch.tensor([[0.6, 0.0, 0.4, 0.0],           # swaps 2.0 for 1.99: taken
                           [0.6, 0.0, 0.0, 0.4],           # -4.0 is far below: refused
                           [1.0, 0.0, 0.0, 0.0]])          # one expert, not two: refused
    w, e = ref_moe.route(logits, 2, True, follow=follow, margin=0.1)
    assert e.tolist() == [[0, 2], [0, 1], [0, 1]]
    p = torch.softmax(logits[0], -1)
    assert torch.allclose(w[0], p[[0, 2]] / p[[0, 2]].sum())
    w0, e0 = ref_moe.route(logits, 2, True, follow=follow, margin=0.0)
    assert e0.tolist() == [[0, 1]] * 3
    assert [ref_moe.is_sliding({"full_every": 4}, i) for i in range(8)] == [
        True, True, True, False, True, True, True, False]


def test_arith_moe_by_hand():
    lm = CFG.lm   # H 64, 8 heads / 1 kv of 32, 4 layers, 16 experts of 64, k 4
    B, t = 4, 5
    touched = 16 * (1 - (1 - 4 / 16) ** B)
    assert arith_moe.experts_touched(lm, B) == pytest.approx(touched)
    expert = 3 * 64 * 64 + 4 * (2 * 64 + 64)
    attn = 64 * (8 + 2) * 32 + 8 * 32 * 64 + 4 * ((8 + 2) * 32 + 64)
    kv = 2 * B * 1 * (32 + 4) * (t + 1)
    want = 4 * (attn + 4 * 64 * 16 + 4 * 4 * 64 + kv) + touched * 4 * expert + 2 * 2 * B * 64
    assert arith_moe.stack_step_bytes(lm, B, t) == pytest.approx(want)
    w = 64 * (8 + 2) * 32 + 8 * 32 * 64 + 64 * 16 + 4 * 3 * 64 * 64
    per_row = 4 * (2 * w + 2 * 2 * 8 * 32 * (t + 1))
    assert arith_moe.stack_step_flops(lm, B, t) == B * per_row
    assert arith_moe.moe_expert_flops(lm, B) == 4 * B * 4 * 2 * 3 * 64 * 64
    assert arith_moe.moe_expert_bytes(lm, B) == pytest.approx(
        4 * (touched * expert + 4 * B * 64 + 4 * B * 64))
    assert arith_moe.moe_route_bytes(lm, B) == 4 * (4 * 64 * 16 + 4 * B * 64 + 4 * B * 16)
    assert arith_moe.moe_route_flops(lm, B) == 4 * B * 2 * 64 * 16
    batch = arith_moe.caption_batch_flops(CFG, 2, 3)
    dec = sum(arith_moe.decoder_token_flops(lm, n) for n in (1, 2, 3))
    assert batch == 2 * (arith.vit_flops(CFG.vision, 70) + arith.cross_kv_flops(CFG.bridge, 26)
                         + arith.bridge_token_flops(CFG.bridge, 3, 26, True) + dec
                         + arith.head_flops(lm, 3))


def test_published_sizes_give_the_expected_counts():
    """Mellum2-12B's stack step moves ~11.7 GB a token (3.5 ms at 3.35 TB/s),
    of which the experts ~95 %, and every expert is touched at batch 64."""
    cfg = caption_moe.moe_config(spec.config("dinov2l-bridge-mellum2-12b-a2.5b"))
    assert arith_moe.experts_touched(cfg.lm, 64) == pytest.approx(63.99, abs=0.01)
    gb = sum(arith_moe.stack_step_bytes(cfg.lm, 64, t) for t in range(50)) / 50 / 1e9
    assert 11.5 < gb < 11.9
    assert 0.94 < arith_moe.moe_expert_bytes(cfg.lm, 64) / (gb * 1e9) < 0.97


def test_mellum_entries_fit_the_benchmark():
    """The entries that add the Mellum2 cell to BENCHMARK.json: names, the
    cell's files and every reader are found as test_portbench_specs finds
    them, the cell joins each shared caption metric's list, and the
    configuration's published sizes are the routed decoder's the port runs."""
    from portbench.tests import test_portbench_specs as specs_test

    full = spec.benchmark()
    (cfg,) = [c for c in full["configs"] if c["name"] == MELLUM_CONFIG]
    (cell,) = [w for w in full["workloads"] if w["name"] == MELLUM]
    assert cell["config"] == MELLUM_CONFIG and cell["chips"] == 1
    for m in full["end_to_end"] + full["per_layer"]:
        assert (MELLUM in m.get("workloads", [])) == (
            m["name"] in SHARED or m["name"].startswith("moe_")), m["name"]
    specs_test.test_benchmark_keys_and_names()
    specs_test.test_cell_files_load(cell)
    for m in full["per_layer"]:
        specs_test.test_metric_reader_found(m)
    f = spec.load_json(spec.ROOT / cfg["file"])
    assert f["name"] == cfg["name"] and f["source"] == cfg["source"]
    vc = caption_moe.moe_config(f)
    lm = vc.lm
    assert (lm.hidden_size, lm.num_layers, lm.num_heads, lm.num_kv_heads, lm.head_dim,
            lm.vocab_size, lm.num_experts, lm.experts_per_token, lm.moe_intermediate_size) == (
        f["hidden_size"], f["num_hidden_layers"], f["num_attention_heads"],
        f["num_key_value_heads"], f["head_dim"], f["vocab_size"], f["num_experts"],
        f["num_experts_per_tok"], f["moe_intermediate_size"])
    assert f["reduced"] == cfg["reduced"] == []


def test_older_readers_unchanged_on_a_trace_with_the_new_kernels():
    """A trace holding the routing and expert kernels inside the stack_step
    range: the older readers read the range as before, the new ones their
    kernels by name."""
    kernels = [("decode_gemm_kernel<false, 4, 2>", 0.0, 10.0, "stack_step"),
               ("void (anonymous namespace)::moe_route_kernel(...)", 10.0, 2.0, "stack_step"),
               ("void (anonymous namespace)::moe_expert_kernel<false>(...)", 12.0, 30.0,
                "stack_step"),
               ("void (anonymous namespace)::moe_expert_kernel<true>(...)", 42.0, 20.0,
                "stack_step"),
               ("tied_head_kernel<false, false, false>", 62.0, 4.0, "head")]
    work = {"tokens": 2, "batches": 1, "stack_bound_s": 31e-6, "moe_expert_bound_s": 25e-6,
            "moe_route_bound_s": 0.2e-6, "moe_slots": 100, "moe_rows": 25}
    tr = tracing.Trace(kernels=kernels, busy_s=66e-6, window_s=70e-6, work=work)
    read = spec.metric_reader
    assert read("stack_step_ms")(tr) == pytest.approx(62e-6 / 2 * 1e3)
    assert read("stack_step_roofline_pct")(tr) == pytest.approx(50.0)
    assert read("head_ms")(tr) == pytest.approx(2e-3)
    assert read("moe_expert_ms")(tr) == pytest.approx(25e-3)
    assert read("moe_expert_roofline_pct")(tr) == pytest.approx(50.0)
    assert read("moe_route_ms")(tr) == pytest.approx(1e-3)
    assert read("moe_route_roofline_pct")(tr) == pytest.approx(10.0)
    assert read("moe_pad_pct")(tr) == pytest.approx(75.0)
    # a program without the experts: the new readers are silent
    plain = tracing.Trace(kernels=kernels[:1], busy_s=1e-5, window_s=2e-5,
                          work={"tokens": 2})
    assert all(read(n)(plain) is None for n in ("moe_expert_ms", "moe_expert_roofline_pct",
                                                "moe_route_ms", "moe_route_roofline_pct",
                                                "moe_pad_pct"))
