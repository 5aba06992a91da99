"""The port's generation debugger (vlm_bridge_tpu_torch.tools.debug_generation)
against the JAX package's, on shared weights (the JAX init carried over with
params/from_jax, f32 towers) at the tiny preset: the greedy trace's tokens
equal, its per-step statistics within f32 tolerance (rtol 1e-4, atol 1e-5
on logits of magnitude ~1), NaN detection, the bridge-bypass A/B, the
report's keys, and the `vlm-debug-torch` CLI on a synthetic image and on an
image file."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_bridge_tpu.configs import VLMConfig as JVLMConfig
from vlm_bridge_tpu.data.tokenizer import get_tokenizer as jget_tokenizer
from vlm_bridge_tpu.models import full_model as jfull
from vlm_bridge_tpu.tools import debug_generation as jdbg
from vlm_bridge_tpu_torch.data.tokenizer import get_tokenizer
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax, from_jax
from vlm_bridge_tpu_torch.tools import debug_generation as tdbg

STAT_TOL = dict(rtol=1e-4, atol=1e-5)
FLOAT_STATS = ("logit_mean", "logit_std", "logit_min", "logit_max", "embed_norm",
               "hidden_norm", "topp_tail_mass")
INT_STATS = ("step", "token", "token_text", "top5_ids", "nan_count", "inf_count",
             "extreme_count")


@pytest.fixture(scope="module")
def shared():
    jcfg = JVLMConfig.tiny_test()
    jparams = jfull.init(jax.random.key(0), jcfg, frozen_dtype=jnp.float32)
    tparams = from_jax(jax.tree.map(np.asarray, jparams))
    pixels = np.random.default_rng(0).normal(
        0, 1, (1, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    return jcfg, jparams, config_from_jax(jcfg), tparams, pixels


def _debuggers(shared, jparams=None, tparams=None):
    jcfg, jp, tcfg, tp, _ = shared
    return (jdbg.GenerationDebugger(jp if jparams is None else jparams, jcfg, jget_tokenizer(None)),
            tdbg.GenerationDebugger(tp if tparams is None else tparams, tcfg, get_tokenizer(None)))


def _compare_steps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in INT_STATS:
            assert getattr(g, k) == getattr(w, k), (g.step, k)
        for k in FLOAT_STATS:
            np.testing.assert_allclose(getattr(g, k), getattr(w, k), **STAT_TOL, err_msg=k)
        np.testing.assert_allclose(g.top5_probs, w.top5_probs, **STAT_TOL)


@pytest.mark.parametrize("bypass", [False, True], ids=["bridged", "bypass_bridge"])
def test_greedy_trace_equals_jax(shared, bypass):
    *_, pixels = shared
    jd, td = _debuggers(shared)
    want = jd.debug_generation(jnp.asarray(pixels), max_length=6, bypass_bridge=bypass)
    got = td.debug_generation(torch.from_numpy(pixels), max_length=6, bypass_bridge=bypass)
    assert got.tokens == want.tokens and got.caption == want.caption
    _compare_steps(got.steps, want.steps)
    assert got.issues == want.issues
    # true probabilities over the whole vocabulary: the top five sum below one
    assert all(0 < sum(s.top5_probs) < 1 for s in got.steps)


def test_nan_detection_equals_jax(shared):
    jcfg, jparams, tcfg, tparams, pixels = shared
    jbad = {**jparams, "lm": {**jparams["lm"],
                              "final_norm": jparams["lm"]["final_norm"].at[0].set(jnp.nan)}}
    tbad = {**tparams, "lm": {**tparams["lm"], "final_norm": tparams["lm"]["final_norm"].clone()}}
    tbad["lm"]["final_norm"][0] = float("nan")
    jd, td = _debuggers(shared, jbad, tbad)
    want = jd.debug_generation(jnp.asarray(pixels), max_length=3)
    got = td.debug_generation(torch.from_numpy(pixels), max_length=3)
    assert got.steps[0].nan_count == tcfg.lm.vocab_size
    assert [s.nan_count for s in got.steps] == [s.nan_count for s in want.steps]
    assert any("NaN logits" in i for i in got.issues)
    assert got.issues == want.issues


def test_detect_issues_equals_jax():
    mk = lambda **kw: tdbg.StepTrace(**{**dict(  # noqa: E731
        step=1, token=7, token_text="x", top5_ids=[1] * 5, top5_probs=[0.1] * 5,
        logit_mean=0.0, logit_std=1.0, logit_min=-1.0, logit_max=1.0, nan_count=0,
        inf_count=0, extreme_count=0, embed_norm=1.0, hidden_norm=1.0), **kw})
    steps = [mk(step=i, inf_count=int(i == 2), extreme_count=int(i == 3),
                topp_tail_mass=0.3 * (i == 4)) for i in range(1, 9)]
    jsteps = [jdbg.StepTrace(**dataclasses.asdict(s)) for s in steps]
    for kw in (dict(), dict(tail_t=1.0, tail_p=0.85, tail_defaulted=False)):
        got = tdbg.GenerationDebugger._detect_issues(steps, "a a a a a", **kw)
        assert got == jdbg.GenerationDebugger._detect_issues(jsteps, "a a a a a", **kw)
        assert any(i.startswith("repetition") for i in got)


def test_bypass_ab_and_report_keys(shared, tmp_path):
    from vlm_bridge_tpu.inference.robust import DEFAULT_STRATEGIES as JSTRATEGIES

    *_, pixels = shared
    jd, td = _debuggers(shared)
    # max_length 6: the JAX traces compiled for test_greedy_trace_equals_jax
    want = jd.compare_bridge_bypass(jnp.asarray(pixels), max_length=6)
    got = td.compare_bridge_bypass(torch.from_numpy(pixels), max_length=6)
    assert got == want and set(got) == {"with_bridge", "bypass_bridge"}

    report = td.full_report(torch.from_numpy(pixels), max_length=4,
                            save_path=str(tmp_path / "r.json"))
    data = json.loads((tmp_path / "r.json").read_text())
    # the JAX report's keys, from a report built without a decode
    jdata = json.loads(jdbg.DebugReport(
        caption="", tokens=[],
        steps=[jdbg.StepTrace(**dataclasses.asdict(report.steps[0]))]).to_json())
    assert set(data) == set(jdata)
    assert set(data["steps"][0]) == set(jdata["steps"][0])
    assert list(data["strategies"]) == [name for name, _ in JSTRATEGIES]
    assert not any(c.startswith("ERROR") for c in data["strategies"].values())
    assert data["bridge_ab"]["with_bridge"] == report.caption
    assert data["tokens"] == report.tokens and len(data["steps"]) == len(report.steps)


def test_debug_cli_synthetic_and_image_file(tmp_path, capsys):
    from PIL import Image

    report = tmp_path / "rep.json"
    rc = tdbg.main(["--preset", "tiny", "--device", "cpu", "--max-length", "3",
                    "--report", str(report)])
    assert rc == 0
    data = json.loads(report.read_text())
    assert data["strategies"] and data["bridge_ab"] and 1 <= len(data["steps"]) <= 3

    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(0, 256, (64, 80, 3), np.uint8)).save(img)
    rc = tdbg.main(["--preset", "tiny", "--device", "cpu", "--max-length", "2",
                    "--image", str(img), "--report", str(report)])
    assert rc == 0
    assert json.loads(report.read_text())["tokens"]
    assert "report written to" in capsys.readouterr().out
