"""Data-parallel captioning and tensor parallelism of the frozen Gemma in the
port (parallel/, generate_tokens(mesh=), vlm-caption-torch --mesh), on the
CPU over gloo, against the JAX package's meshes on its 8 CPU devices.

One tiny f32 tree made by the JAX package (and its copy with int8 MLP
weights, a mixed tree: float attention cut over the model axis, int8 MLP
replicated) goes to the workers (tests/torch_tp_worker.py) as npz files.
- 2 processes: the mesh (2, 1) gives JAX's data-mesh ids, refuses a batch
  that does not split, and `vlm-caption-torch --mesh 2` writes one
  process's JSONL; the mesh (1, 2) gives every rank the block JAX's
  NamedSharding gives that device, JAX's TP-mesh greedy ids token for token
  and its first-step logits within 1e-4 (float and mixed trees), and the
  train step's gradients, losses and bridge of one process and of JAX.
- 4 processes: the mesh (2, 2), whose data blocks hold unequal token counts:
  a sum over the whole group in place of the data group would count each
  block twice. Then `entry.dryrun_multiprocess(4)` on its (2, 2) mesh.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu import configs as jcfg
from vlm_bridge_tpu.inference import generate as JG
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu.parallel import sharding as jsh
from vlm_bridge_tpu.training import train_step as jts
from vlm_bridge_tpu_torch.params.from_jax import bridge_from_jax, from_jax
from vlm_bridge_tpu_torch.training import train_step as tts

from torch_tp_worker import MAX_NEW, STEPS, tiny_cfg, train_config

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)   # f32 sums in another order (test_torch_parallel.py)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROWS, T = 4, 16
LENGTHS = (16, 3, 12, 5)   # the (2, 2) mesh's data blocks hold 17 and 15 labels


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _names(tree, prefix=""):
    """Leaf paths in tree_leaves' order (sorted keys, depth first)."""
    if not isinstance(tree, dict):
        return [prefix]
    return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}/{k}" if prefix else k)]


def _jax_cfg():
    cfg = jcfg.VLMConfig.tiny_test()
    return dataclasses.replace(cfg, bridge=dataclasses.replace(cfg.bridge, dropout=0.0))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The JAX trees and the inputs, written for the workers."""
    root = tmp_path_factory.mktemp("tp")
    cfg = _jax_cfg()
    pj = jax.tree.map(np.asarray, jax.jit(
        lambda k: jfm.init(k, cfg, frozen_dtype=jnp.float32))(jax.random.key(5)))
    mixed = {**pj, "lm": jax.tree.map(np.asarray, jg.quantize_params(pj["lm"], ("mlp",)))}
    rng = np.random.default_rng(9)
    inputs = {
        "pixels": rng.normal(0, 1, (ROWS, cfg.image_size, cfg.image_size, 3)).astype(np.float32),
        "pixel_values": rng.integers(0, 256, (ROWS, cfg.image_size, cfg.image_size, 3),
                                     np.uint8),
        "input_ids": rng.integers(3, cfg.lm.vocab_size, (ROWS, T)).astype(np.int32),
        "attn_mask": (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.int32)}
    np.savez(root / "params.npz", **_flatten(pj))
    np.savez(root / "params_mlp.npz", **_flatten(mixed))
    np.savez(root / "inputs.npz", **inputs)
    images = root / "images"
    images.mkdir()
    from PIL import Image

    for i in range(5):   # a second batch of one image, padded to 4
        Image.fromarray(rng.integers(0, 256, (80, 90, 3), np.uint8)).save(images / f"{i}.png")
    return root, cfg, pj, mixed, inputs, images


def _launch(setup, n: int, name: str) -> Path:
    root, *_, images = setup
    out = root / name
    out.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_tp_worker.py"),
                               "--inputs", str(root), "--out", str(out), "--images", str(images)],
                              env={**env, "RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n, "\n".join(logs)[-6000:]
    return out


@pytest.fixture(scope="module")
def run2(setup):
    return _launch(setup, 2, "run2")


@pytest.fixture(scope="module")
def run4(setup):
    return _launch(setup, 4, "run4")


def _jax_generate(tree, cfg, pixels, mesh):
    gen = JG.GenerationConfig(max_length=MAX_NEW, greedy=True)
    toks, lens = JG.generate_tokens(jax.tree.map(jnp.asarray, tree) if mesh is None else tree,
                                    cfg, pixel_values=jnp.asarray(pixels), gen=gen,
                                    activation_dtype=jnp.float32, mesh=mesh)
    return np.asarray(toks), np.asarray(lens)


def test_generate_data_mesh_equals_jax_and_refuses_a_ragged_batch(setup, run2):
    _, cfg, pj, _, inputs, _ = setup
    mesh = jsh.auto_mesh(data=2, model=1, devices=jax.devices()[:2])
    want = _jax_generate(jsh.shard_params(mesh, pj), cfg, inputs["pixels"], mesh)
    for r in range(2):
        got = np.load(run2 / f"data_rank{r}.npz")
        np.testing.assert_array_equal(got["tokens"], want[0])   # every rank the global batch
        np.testing.assert_array_equal(got["lengths"], want[1])
        assert "must divide the mesh 'data' axis" in str(got["refused"])


def test_caption_cli_mesh_2_writes_one_process_captions(setup, run2, tmp_path):
    from vlm_bridge_tpu_torch.inference import caption

    *_, images = setup
    assert caption.main([str(images), "--preset", "tiny", "--device", "cpu", "--max-length",
                         str(MAX_NEW), "--batch-size", "4",
                         "--output", str(tmp_path / "one.jsonl")]) == 0
    want = (tmp_path / "one.jsonl").read_text()
    assert len(want.splitlines()) == 5
    assert (run2 / "captions_mesh.jsonl").read_text() == want


def test_shard_params_gives_each_rank_its_jax_shard(setup, run2):
    """(data 1, model 2): rank r holds what JAX's NamedSharding puts on
    device r, for every cut leaf of a layer."""
    _, cfg, pj, *_ = setup
    mesh = jsh.auto_mesh(data=1, model=2, devices=jax.devices()[:2])
    layer = jsh.shard_params(mesh, pj)["lm"]["layers"]["0"]
    for r in range(2):
        got = np.load(run2 / f"model_rank{r}.npz")
        for group, leaves in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))):
            for leaf in leaves:
                (shard,) = [s for s in layer[group][leaf].addressable_shards
                            if s.device == jax.devices()[r]]
                np.testing.assert_array_equal(got[f"shard/{group}/{leaf}"], np.asarray(shard.data),
                                              err_msg=f"{group}/{leaf} rank {r}")
                assert got[f"shard/{group}/{leaf}"].size * 2 == pj["lm"]["layers"]["0"][group][
                    leaf].size


@pytest.mark.parametrize("tree", ["params", "params_mlp"])
def test_tensor_parallel_ids_and_logits_equal_jax(setup, run2, tree):
    """Greedy ids token for token and the first step's logits (BOS through
    the bridge and the LM) against JAX's TP mesh, on both ranks; the mixed
    tree reduces its float attention and not its int8 MLP."""
    _, cfg, pj, mixed, inputs, _ = setup
    params = pj if tree == "params" else mixed
    mesh = jsh.auto_mesh(data=1, model=2, devices=jax.devices()[:2])
    sharded = jsh.shard_params(mesh, params)
    want = _jax_generate(sharded, cfg, inputs["pixels"], mesh)
    bos = jnp.full((ROWS, 1), cfg.lm.bos_token_id, jnp.int32)
    with mesh:
        logits = np.asarray(jfm.forward(sharded, cfg, jnp.asarray(inputs["pixels"]), bos,
                                        jnp.ones_like(bos)))[:, 0]
    for r in range(2):
        got = np.load(run2 / f"model_rank{r}.npz")
        np.testing.assert_array_equal(got[f"{tree}/tokens"], want[0])
        np.testing.assert_array_equal(got[f"{tree}/lengths"], want[1])
        np.testing.assert_allclose(got[f"{tree}/logits"], logits, **LOGIT_TOL)


def _one_process(pj, inputs):
    """The port's loss_and_grads and STEPS train steps in this process."""
    cfg, tc = tiny_cfg(), train_config()
    params = from_jax(pj)
    frozen = tts.split_frozen(params)
    state, opt = tts.init_train_state(params, tc, steps_per_epoch=10)
    batch = {k: torch.from_numpy(inputs[k]) for k in ("pixel_values", "input_ids", "attn_mask")}
    batch["input_ids"] = batch["input_ids"].long()
    loss, aux, grads = tts.loss_and_grads(cfg, tc, frozen, state.bridge_params, batch, None,
                                          torch.float32)
    step = tts.make_train_step(cfg, tc, opt, tts.make_schedule(tc, 10),
                               activation_dtype=torch.float32)
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, frozen, batch, None)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return loss, aux, grads, losses, norms, tts.tree_leaves(state.bridge_params)


def _jax_steps(pj, inputs):
    cfg = _jax_cfg()
    kw = dict(loss_chunk_size=8, learning_rate=1e-3, min_lr=1e-4, num_epochs=1)
    tc = jcfg.TrainingConfig(**kw)
    params = jax.tree.map(jnp.asarray, pj)
    state, opt = jts.init_train_state(params, tc, steps_per_epoch=10)
    step = jts.make_train_step(cfg, tc, opt, jts.make_schedule(tc, 10),
                               activation_dtype=jnp.float32)
    batch = {k: jnp.asarray(inputs[k]) for k in ("pixel_values", "input_ids", "attn_mask")}
    losses, norms = [], []
    for _ in range(STEPS):
        state, m = step(state, jts.split_frozen(params), batch, jax.random.key(0))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm_before_clip"]))
    return losses, norms, jax.tree.map(np.asarray, state.bridge_params)


def _check_train(setup, run, n):
    _, _, pj, _, inputs, _ = setup
    loss, aux, grads, losses, norms, bridge = _one_process(pj, inputs)
    j_losses, j_norms, j_bridge = _jax_steps(pj, inputs)
    init = tts.tree_leaves(bridge_from_jax(pj["bridge"]))
    names = _names(pj["bridge"])
    j_leaves = tts.tree_leaves(bridge_from_jax(j_bridge))
    ranks = [np.load(run / f"model_rank{r}.npz") for r in range(n)]
    for got in ranks:
        # the global batch's loss and gradients: one process's, to f32 reordering
        assert int(got["grads/token_count"]) == int(aux["token_count"]) == sum(LENGTHS) - ROWS
        np.testing.assert_allclose(got["grads/loss"], loss.detach().numpy(), **GRAD_TOL)
        for i, g in enumerate(grads):
            np.testing.assert_allclose(got[f"grads/g{i}"], g.numpy(), **GRAD_TOL,
                                       err_msg=f"grad {i}")
        np.testing.assert_allclose(got["train/losses"], losses, **GRAD_TOL)
        np.testing.assert_allclose(got["train/grad_norms"], norms, rtol=1e-5)
        # and JAX's: the losses and norms to test_two_epoch_run_equals_jax's
        # and test_train_step_trajectory's bounds; the bridge after the updates
        # to the trajectory's (within 1e-6 for 99.5 % of each tensor, 1e-4 for
        # all: where a gradient is of the order of its f32 summation noise,
        # AdamW's step follows the noise)
        np.testing.assert_allclose(got["train/losses"], j_losses, rtol=1e-4)
        np.testing.assert_allclose(got["train/grad_norms"], j_norms, rtol=2e-3)
        moved = 0.0
        for i, (name, p0, want, one) in enumerate(zip(names, init, j_leaves, bridge)):
            leaf = got[f"train/bridge{i}"]
            moved = max(moved, float(np.abs(leaf - p0.detach().numpy()).max()))
            if name.endswith("k_bias"):   # rounding noise in both packages
                assert np.abs(leaf - p0.detach().numpy()).max() < 1e-3, name
                continue
            for ref in (want, one):
                diff = np.abs(leaf - ref.detach().numpy())
                assert (diff <= 1e-6).mean() >= 0.995, (name, float((diff <= 1e-6).mean()))
                assert diff.max() <= 1e-4, (name, float(diff.max()))
        assert moved > 1e-4   # the updates did move the bridge
    for got in ranks[1:]:   # every rank applied the same update
        for i in range(len(init)):
            np.testing.assert_array_equal(got[f"train/bridge{i}"], ranks[0][f"train/bridge{i}"])


def test_tensor_parallel_train_steps_equal_one_process_and_jax(setup, run2):
    _check_train(setup, run2, 2)


def test_data_and_model_mesh_2x2_train_and_generate(setup, run4):
    """(2, 2): the loss, its token count and the gradients summed over the
    data group only; the greedy ids equal JAX's on one device."""
    _check_train(setup, run4, 4)
    _, cfg, pj, _, inputs, _ = setup
    want = _jax_generate(pj, cfg, inputs["pixels"], None)
    for r in range(4):
        got = np.load(run4 / f"model_rank{r}.npz")
        np.testing.assert_array_equal(got["params/tokens"], want[0])


def test_dryrun_multiprocess_4_on_a_2x2_mesh(monkeypatch):
    from vlm_bridge_tpu_torch.entry import dryrun_multiprocess

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    records = dryrun_multiprocess(4, timeout_s=300)
    assert len(records) == 4 and records[0]["mesh"] == [2, 2]
    assert len(records[0]["losses"]) == 5 and all(np.isfinite(records[0]["losses"]))
    assert len(records[0]["midsize_losses"]) == 2 and all(np.isfinite(records[0]["midsize_losses"]))
