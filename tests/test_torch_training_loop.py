"""PyTorch port, the training entry point on the CPU, held to the JAX package:

- a 2-epoch tiny run through the port's and the JAX `execute_full_training`
  on the same synthetic split and the same initial params (f32, dropout 0):
  per-step losses from each TensorBoard log within 1e-4 relative, the same
  early-stopping epoch, the same meta.json, and the bridge's updates and the
  AdamW moments (params.from_jax.opt_state_from_jax) within 1e-3;
- resume (JAX tests/test_training.py:100-131): a fresh context restored from
  `latest` starts at the next epoch and step with the bridge and the
  moments bit for bit, and trains on from there;
- the CLIs end to end, as the JAX package's scripts/smoke.sh drives them:
  vlm-data-torch synth -> vlm-training-torch --device cpu (gradient
  accumulation, validation, sample captions, the three slots, the event
  file) -> vlm-eval-torch --checkpoint (fast and --exact) ->
  vlm-caption-torch --checkpoint -> vlm-convert-torch, and --resume;
- `vlm-data-torch`'s subcommands (explore-dataset over a stand-in for the
  download); `StepProfiler`'s summary against the JAX one's, and its trace;
- the memorization proof (slow: ~3.5 min on one core): 8 of 8 captions token
  for token and BLEU-4 ~ 1.0.
"""

import dataclasses
import json
import math
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu import configs as jcfg
from vlm_bridge_tpu.data import groundcap as jgc
from vlm_bridge_tpu.runtime import tb_writer as jtbw
from vlm_bridge_tpu.training import orchestrator as jorch
from vlm_bridge_tpu_torch import configs as tcfg
from vlm_bridge_tpu_torch.params.from_jax import from_jax, opt_state_from_jax
from vlm_bridge_tpu_torch.runtime import tb_writer as ttbw
from vlm_bridge_tpu_torch.training import orchestrator as torch_orch
from vlm_bridge_tpu_torch.training import train_step as ts


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("gc")
    jgc.make_synthetic_dataset(d, num_samples=40, image_size=70)
    # the synthetic split is 32 train / 0 val / 8 test: give val some data
    shutil.rmtree(d / "val")
    shutil.copytree(d / "test", d / "val")
    return d


def _tc(cls, data_dir, tmp_path, name, **kw):
    base = dict(batch_size=4, num_epochs=3, data_dir=str(data_dir),
                checkpoint_dir=str(tmp_path / name / "ckpt"), log_dir=str(tmp_path / name / "logs"),
                model_preset="tiny_test", max_text_len=32, pad_to_buckets=(32,),
                num_workers=2, log_every_n_steps=1, max_steps_per_epoch=3,
                num_validation_samples=1, loss_chunk_size=16, learning_rate=1e-3,
                min_lr=1e-4, generate_samples_every_n_epochs=10 ** 6,
                early_stopping_patience=1, early_stopping_min_delta=10.0, mesh_shape=(1,))
    base.update(kw)
    tc = cls(**base)
    # dropout 0 (the packages draw different bits): the preset with the bridge's
    # dropout off, for both
    model = tc.model_config()
    tc.model_config = lambda: dataclasses.replace(
        model, bridge=dataclasses.replace(model.bridge, dropout=0.0))
    return tc


def _losses(read_scalars, log_dir):
    (events,) = list(log_dir.glob("events.out.tfevents.*"))
    return [v for _, v in read_scalars(events)["train/loss"]], read_scalars(events)


@pytest.fixture(scope="module")
def jax_params():
    """One f32 tiny tree as numpy arrays, for both packages (made by the
    port's seeded init: no JAX compile)."""
    from vlm_bridge_tpu_torch.models import full_model as tfm

    params = tfm.init(tcfg.VLMConfig.tiny_test(), generator=torch.Generator().manual_seed(4),
                      frozen_dtype=torch.float32)
    return ts.tree_map(lambda t: t.numpy(), params)


def test_two_epoch_run_equals_jax(data_dir, tmp_path, jax_params):
    """Patience 1 with min-delta 10: epoch 0 sets the best, epoch 1 does not
    improve by 10, so both stop after 2 of 3 epochs."""
    jtc = _tc(jcfg.TrainingConfig, data_dir, tmp_path, "jax")
    jres = jorch.execute_full_training(jtc, ctx=jorch.prepare_environment(
        jtc, params=jax.tree.map(jnp.asarray, jax_params), activation_dtype=jnp.float32))
    ttc = _tc(tcfg.TrainingConfig, data_dir, tmp_path, "port")
    tres = torch_orch.execute_full_training(ttc, ctx=torch_orch.prepare_environment(
        ttc, params=from_jax(jax_params), activation_dtype=torch.float32))

    assert tres["epochs_run"] == jres["epochs_run"] == 2
    got, t_scalars = _losses(ttbw.read_scalars, tmp_path / "port" / "logs")
    want, j_scalars = _losses(jtbw.read_scalars, tmp_path / "jax" / "logs")
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for tag in ("train/learning_rate", "train/grad_norm_before_clip", "val/loss",
                "epoch/train_loss", "val/perplexity", "val/avg_sequence_length",
                "val/token_diversity"):
        assert [s for s, _ in t_scalars[tag]] == [s for s, _ in j_scalars[tag]], tag
        np.testing.assert_allclose([v for _, v in t_scalars[tag]],
                                   [v for _, v in j_scalars[tag]], rtol=1e-4, err_msg=tag)
    for slot in ("latest", "best", "best_weights_only"):
        t_meta = json.loads((tmp_path / "port" / "ckpt" / slot / "meta.json").read_text())
        j_meta = json.loads((tmp_path / "jax" / "ckpt" / slot / "meta.json").read_text())
        assert set(t_meta) == set(j_meta)
        for k, v in j_meta.items():
            if isinstance(v, float):
                assert math.isclose(t_meta[k], v, rel_tol=1e-4), k
            else:
                assert t_meta[k] == v, k
    assert t_meta["epoch"] == 0 and t_meta["step"] == 3   # best: epoch 0
    assert json.loads((tmp_path / "port" / "ckpt" / "latest" / "meta.json").read_text())[
        "early_stop_counter"] == 1

    tctx, jctx = tres["ctx"], jres["ctx"]
    assert tctx.state.step == int(jctx.state.step) == 6
    jbridge = jax.tree.map(np.asarray, jctx.state.bridge_params)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(jbridge)]
    t_opt = tctx.opt.state_dict(tctx.state.opt_state, tctx.state.bridge_params)
    j_opt = opt_state_from_jax(jax.tree.map(np.asarray, jctx.state.opt_state))
    assert int(t_opt["count"]) == int(j_opt["count"]) == 6
    # what the 6 updates moved (AdamW's step is ~lr whatever the gradient's
    # size, so a coordinate with a tiny gradient moves as far as any) and the
    # moments: 1e-3 relative, or 1e-3 of the leaf's largest value where one
    # crosses zero
    init = ts.tree_leaves(from_jax(jax_params["bridge"]))
    moved = [[a.detach() - p0 for a, p0 in zip(ts.tree_leaves(tree), init)]
             for tree in (tctx.state.bridge_params, from_jax(jbridge))]
    pairs = [moved] + [[ts.tree_leaves(t_opt[k]), ts.tree_leaves(j_opt[k])] for k in ("mu", "nu")]
    for t_leaves, j_leaves in pairs:
        for path, a, b in zip(paths, t_leaves, j_leaves):
            a, b = a.numpy(), b.numpy()
            if path.endswith("['k_bias']"):
                # a key bias adds one constant to a query's logits, which the
                # softmax removes: its gradient is rounding noise in both
                # packages, and AdamW normalises noise to steps of its own
                assert np.abs(a).max() < 1e-4 and np.abs(b).max() < 1e-4, path
                continue
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3 * np.abs(b).max(),
                                       err_msg=path)


def test_resume_restores_counters_and_continues(data_dir, tmp_path, jax_params):
    def fresh():
        return from_jax(jax_params)

    kw = dict(early_stopping_min_delta=0.0, early_stopping_patience=3)
    tc1 = _tc(tcfg.TrainingConfig, data_dir, tmp_path, "a", num_epochs=1, **kw)
    r1 = torch_orch.execute_full_training(tc1, ctx=torch_orch.prepare_environment(
        tc1, params=fresh(), activation_dtype=torch.float32))
    ctx1 = r1["ctx"]
    step_after = ctx1.state.step
    assert step_after == 3

    tc2 = _tc(tcfg.TrainingConfig, data_dir, tmp_path, "a", num_epochs=2,
              resume_from_checkpoint="latest", **kw)
    ctx2 = torch_orch.prepare_environment(tc2, params=fresh(), activation_dtype=torch.float32)
    torch_orch.load_checkpoint(ctx2, "latest")
    assert ctx2.start_epoch == 1 and ctx2.state.step == step_after
    assert ctx2.best_val_loss == ctx1.best_val_loss and ctx2.early_stop_counter == 0
    for a, b in zip(ts.tree_leaves(ctx1.state.bridge_params),
                    ts.tree_leaves(ctx2.state.bridge_params)):
        assert torch.equal(a, b)
    s1 = ctx1.opt.state_dict(ctx1.state.opt_state, ctx1.state.bridge_params)
    s2 = ctx2.opt.state_dict(ctx2.state.opt_state, ctx2.state.bridge_params)
    for a, b in zip(ts.tree_leaves(s1), ts.tree_leaves(s2)):
        assert torch.equal(a, b)
    r2 = torch_orch.execute_full_training(tc2, ctx=ctx2)   # loads again, trains epoch 1
    assert r2["epochs_run"] == 1 and r2["history"][0]["epoch"] == 1
    assert ctx2.state.step == 6
    meta = json.loads((tmp_path / "a" / "ckpt" / "latest" / "meta.json").read_text())
    assert (meta["epoch"], meta["step"]) == (1, 6)


def test_init_params_are_the_serving_clis_towers():
    """`--checkpoint` serves a trained bridge over the frozen towers' seeded
    init: the trainer's init_params and the CLIs' load_from_args must make
    the same towers from the same seed. An HF path with no snapshot raises."""
    import argparse

    from vlm_bridge_tpu_torch.tools.loading import add_model_args, load_from_args
    from vlm_bridge_tpu_torch.training.stack import init_params

    tc = tcfg.TrainingConfig(model_preset="tiny_test", seed=3)
    trained = init_params(tc, device="cpu")
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    _, served, _ = load_from_args(ap.parse_args(["--preset", "tiny", "--seed", "3", "--device",
                                                 "cpu"]))
    for part in ("vision", "lm"):
        a, b = ts.tree_leaves(trained[part]), ts.tree_leaves(served[part])
        assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), part
    with pytest.raises(FileNotFoundError, match="no .safetensors files"):
        init_params(tcfg.TrainingConfig(model_preset="tiny_test", hf_lm_path="x"), device="cpu")


def test_simple_bleu4_equals_jax():
    for cand, ref in (("a b c d e", "a b c d e"), ("x y z w q", "a b c d e"),
                      ("a b c d x", "a b c d e"), ("", "a"), ("a b c d", "a b c d e f g")):
        assert torch_orch.simple_bleu4(cand, ref) == jorch.simple_bleu4(cand, ref)


def test_cli_flow_synth_train_eval_caption_convert(tmp_path, capsys):
    """The JAX package's scripts/smoke.sh, through the port's CLIs."""
    from vlm_bridge_tpu_torch.data import cli as data_cli
    from vlm_bridge_tpu_torch.inference import caption, evaluate
    from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore
    from vlm_bridge_tpu_torch.tools import convert
    from vlm_bridge_tpu_torch.tools.loading import add_model_args, load_from_args
    from vlm_bridge_tpu_torch.training import cli as train_cli

    data, ckpt, logs = tmp_path / "data", tmp_path / "ckpt", tmp_path / "logs"
    assert data_cli.main(["synth", "--output-dir", str(data), "--num-samples", "100",
                          "--image-size", "70"]) == 0
    assert data_cli.main(["stats", "--data-dir", str(data)]) == 0
    assert "train:" in capsys.readouterr().out
    cfg_path = tmp_path / "config.yaml"
    tc = tcfg.TrainingConfig(model_preset="tiny_test", data_dir=str(data), batch_size=2,
                             num_epochs=1, max_steps_per_epoch=4, gradient_accumulation_steps=2,
                             checkpoint_dir=str(ckpt), log_dir=str(logs), num_workers=2,
                             log_every_n_steps=1, num_validation_samples=2, bridge_causal=True)
    tc.to_yaml(cfg_path)
    if not torch.cuda.is_available():    # the card by default, no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(["--config", str(cfg_path)])
    assert train_cli.main(["--config", str(cfg_path), "--device", "cpu"]) == 0
    for slot in ("latest", "best", "best_weights_only"):
        assert (ckpt / slot / "meta.json").exists(), slot
    assert not (ckpt / "best_weights_only" / "opt_state.pt").exists()
    meta = json.loads((ckpt / "latest" / "meta.json").read_text())
    assert meta["step"] == 4 and meta["epoch"] == 0 and meta["bridge_causal"] is True
    (events,) = list(logs.glob("events.out.tfevents.*"))
    scalars = ttbw.read_scalars(events)
    assert [s for s, _ in scalars["train/loss"]] == [1, 2, 3, 4]
    assert all(math.isfinite(v) for _, v in scalars["train/loss"])
    assert "val/sample_bleu_avg" in scalars and "epoch/samples_per_sec" in scalars
    texts = [p for p in ttbw.read_events(events) if b"val/sample_1/text_summary" in p]
    assert texts

    # the trained bridge is what --checkpoint serves
    import argparse

    ap = argparse.ArgumentParser()
    add_model_args(ap)
    args = ap.parse_args(["--preset", "tiny", "--device", "cpu", "--checkpoint",
                          str(ckpt / "latest")])
    _, params, _ = load_from_args(args)
    saved, _ = CheckpointStore(ckpt).load("latest", template={"bridge_params": params["bridge"]})
    assert all(torch.equal(a, b) for a, b in zip(ts.tree_leaves(params["bridge"]),
                                                 ts.tree_leaves(saved["bridge_params"])))
    assert args._ckpt_meta == meta

    common = ["--preset", "tiny", "--device", "cpu", "--data-dir", str(data), "--split", "test",
              "--batch-size", "4", "--max-length", "8", "--max-samples", "8", "--checkpoint",
              str(ckpt / "latest")]
    assert evaluate.main(common + ["--output", str(tmp_path / "eval.json")]) == 0
    res = json.loads((tmp_path / "eval.json").read_text())
    assert res["num_samples"] == 8 and math.isfinite(res["metrics"]["bleu4"])
    capsys.readouterr()
    assert evaluate.main(common + ["--exact", "--max-samples", "4", "--output",
                                   str(tmp_path / "exact.json")]) == 0
    assert "exact mode uses the causal bridge mask" in capsys.readouterr().out
    assert json.loads((tmp_path / "exact.json").read_text())["num_samples"] == 4

    caps = tmp_path / "captions.jsonl"
    assert caption.main([str(data / "test" / "images"), "--preset", "tiny", "--device", "cpu",
                         "--batch-size", "4", "--max-length", "8", "--quantize",
                         "embedding,mlp,attn", "--checkpoint", str(ckpt / "latest"),
                         "--output", str(caps)]) == 0
    assert len(caps.read_text().splitlines()) == 18

    pth = tmp_path / "bridge.pth"
    assert convert.main(["slot-to-pth", str(ckpt), str(pth), "--slot", "latest", "--preset",
                         "tiny"]) == 0
    assert convert.main(["show", str(pth)]) == 0
    assert convert.main(["pth-to-slot", str(pth), str(tmp_path / "ckpt2"), "--preset",
                         "tiny"]) == 0
    back, _ = CheckpointStore(tmp_path / "ckpt2").load(
        "imported", template={"bridge_params": params["bridge"]})
    assert all(torch.equal(a, b) for a, b in zip(ts.tree_leaves(back["bridge_params"]),
                                                 ts.tree_leaves(saved["bridge_params"])))

    tc.num_epochs = 2
    tc.to_yaml(cfg_path)
    assert train_cli.main(["--config", str(cfg_path), "--device", "cpu", "--resume"]) == 0
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert json.loads((ckpt / "latest" / "meta.json").read_text())["step"] == 8


def test_step_profiler_summary_equals_jax_and_writes_a_trace(tmp_path):
    """The fenced windows' summary equals the JAX StepProfiler's on the same
    windows; a trace window writes a Chrome trace with the annotated region."""
    from vlm_bridge_tpu.runtime import profiling as jprof
    from vlm_bridge_tpu_torch.runtime import profiling as tprof

    windows = [(3, 0.9), (1, 0.2), (4, 0.5), (2, 0.31)]
    summaries = []
    for mod in (jprof, tprof):
        prof = mod.StepProfiler()
        for steps, seconds in windows:
            with prof.step(record_time=False):
                pass
            prof.add_window(steps, seconds)
        summaries.append(prof.summary())
    assert summaries[1] == summaries[0] and summaries[1]["steps_timed"] == 4.0
    prof = tprof.StepProfiler(trace_dir=tmp_path / "trace", start_step=1, num_steps=2, warmup=1)
    for _ in range(4):
        with prof.step(), tprof.annotate("bridge_step"):
            torch.ones(8) @ torch.ones(8)
    prof.close()
    trace = (tmp_path / "trace" / "trace_step1.json").read_text()
    assert "bridge_step" in trace and prof.summary()["steps_timed"] == 3.0


def test_vlm_data_torch_subcommands(tmp_path, monkeypatch, capsys):
    """synth writes the JAX package's files; precache builds every split's
    pixel cache; inspect-loader and stats read them; explore-dataset (which
    downloads GroundCap) is driven over an in-memory stand-in for the
    download, so no network is touched."""
    from vlm_bridge_tpu.data import cli as jcli
    from vlm_bridge_tpu_torch.data import cli, groundcap
    from vlm_bridge_tpu_torch.data.loader import VLDataset

    for mod, name in ((cli, "port"), (jcli, "jax")):
        assert mod.main(["synth", "--output-dir", str(tmp_path / name), "--num-samples", "12",
                         "--image-size", "64"]) == 0
    for split in ("train", "test"):
        a = (tmp_path / "port" / split / "captions.jsonl").read_text()
        assert a == (tmp_path / "jax" / split / "captions.jsonl").read_text()
    assert cli.main(["precache", "--data-dir", str(tmp_path / "port"), "--num-workers",
                     "2"]) == 0
    for split in ("train", "test"):
        assert VLDataset(tmp_path / "port", split).pixels is not None
    assert cli.main(["precache", "--data-dir", str(tmp_path / "port")]) == 0
    assert "cache fresh" in capsys.readouterr().out
    assert cli.main(["inspect-loader", "--data-dir", str(tmp_path / "port"), "--batch-size",
                     "2"]) == 0
    assert "batch 1: pixels (2, 224, 224, 3) uint8" in capsys.readouterr().out
    fake = {"train": [{"image": None, "caption": '<gdo id="1">a dog</gdo> runs'}]}
    monkeypatch.setattr(groundcap, "load_ground_cap", lambda cache_dir=None: fake)
    assert cli.main(["explore-dataset"]) == 0
    out = capsys.readouterr().out
    assert "splits: {'train': 1}" in out and "sample_caption_clean: a dog runs" in out


@pytest.mark.slow
def test_memorization_proof(tmp_path):
    from vlm_bridge_tpu_torch.tools import memorize

    out = tmp_path / "record.json"
    rc = memorize.main(["--device", "cpu", "--epochs", "50", "--workdir", str(tmp_path / "w"),
                        "--output", str(out)])
    record = json.loads(out.read_text())
    assert rc == 0, record["captions"]
    assert record["exact_matches"] == record["total"] == 8
    assert record["metrics"]["bleu4"] > 0.99
