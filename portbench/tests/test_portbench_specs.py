"""The benchmark's files load and agree with each other: every cell, its
configuration, its entry and every per-layer metric is found by name."""

from __future__ import annotations

import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    f = spec.load_json(spec.ROOT / cfg["file"])
    assert f["name"] == cfg["name"] and f["source"] == cfg["source"]
    assert f["reduced"] == cfg["reduced"] == []
    vc = spec.vlm_config(f)
    lm = vc.lm
    # the published sizes the file names are the ones the port runs
    assert (lm.hidden_size, lm.intermediate_size, lm.num_layers, lm.num_heads,
            lm.num_kv_heads, lm.vocab_size, lm.rope_theta, lm.rms_norm_eps) == (
        f["hidden_size"], f["intermediate_size"], f["num_hidden_layers"],
        f["num_attention_heads"], f["num_key_value_heads"], f["vocab_size"], f["rope_theta"],
        f["rms_norm_eps"])
    assert lm.head_dim * lm.num_heads == lm.hidden_size
    assert lm.query_pre_attn_scalar == lm.head_dim
    assert (lm.bos_token_id, lm.eos_token_id) == (f["bos_token_id"], f["eos_token_id"])
    assert vc.bridge.language_dim == lm.hidden_size
    assert vc.bridge.language_dim // vc.bridge.num_heads_self == 128
    assert vc.num_vision_tokens == 257
    assert f["departures"] and f["assumed"]


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(cell):
    w = spec.workload(cell["name"])
    assert w["config"] == cell["config"] and cell["chips"] == 1
    assert any(c["name"] == w["config"] for c in BENCH["configs"])
    assert (spec.HERE / "entries" / f"{w['entry']}.py").exists()
    assert hasattr(spec.entry(w["entry"]), "Cell")
    assert w["checks"] and all(c["limit"] > 0 for c in w["checks"].values())
    e2e = spec.cell_metrics(BENCH, cell["name"], "end_to_end")
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert spec.cell_metrics(BENCH, cell["name"], "per_layer")


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_found(metric):
    assert callable(spec.metric_reader(metric["name"]))
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", [cell])


def test_a_new_file_is_found_by_name(tmp_path):
    """A later cell, configuration or metric is files only: the harness
    looks them up by name in the folders it is given."""
    for sub in ("workloads", "configs", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "workloads" / "new-cell.json").write_text(json.dumps(
        {"config": "new-config", "entry": "caption", "traffic": {}, "checks": {}}))
    (tmp_path / "configs" / "new-config.json").write_text(json.dumps({"name": "new-config"}))
    (tmp_path / "metrics" / "new.metric.py").write_text("def read(trace):\n    return 1.5\n")
    assert spec.workload("new-cell", tmp_path)["config"] == "new-config"
    assert spec.config("new-config", tmp_path)["name"] == "new-config"
    assert spec.metric_reader("new.metric", tmp_path)(None) == 1.5
