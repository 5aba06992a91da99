"""Data parallelism of the port (vlm_bridge_tpu_torch.parallel and its
callers) on the CPU over gloo.

- auto_mesh's validation; param_shardings' table against the JAX
  `_spec_for_path` on every path of the tiny tree (and the scan layout's);
  shard_batch's blocks.
- One 2-process run (tests/torch_dp_worker.py, joined from the launcher's
  environment): two ranks holding unequal token counts give the loss and
  the bridge gradients of one process on the whole batch (rtol 1e-5, atol
  1e-7: f32 sums in another order), the mean of the ranks' own means does
  not; the orchestrator's 2 steps give equal losses and bridge bits on both
  ranks, and only rank 0 wrote slots and TensorBoard events;
  `vlm-eval-torch --mesh 2 --device cpu` gives the captions and metrics of
  one process.
- entry.dryrun_multiprocess(2).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from torch_dp_worker import make_batch, tiny_setup
from vlm_bridge_tpu_torch.parallel import (Mesh, auto_mesh, batch_sharding, param_shardings,
                                           shard_batch)
from vlm_bridge_tpu_torch.parallel.sharding import _spec_for_path

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = dict(rtol=1e-5, atol=1e-7)


def test_auto_mesh_validation():
    mesh = auto_mesh(device="cpu")
    assert (mesh.data, mesh.model, mesh.rank, mesh.distributed) == (1, 1, 0, False)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        auto_mesh(2, device="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism of the frozen LM"):
        auto_mesh(1, 2, device="cpu")


def _jax_placements(spec) -> tuple:
    """A JAX PartitionSpec over ("data", "model") as the port's placements."""
    model = [i for i, ax in enumerate(spec) if ax == "model"]
    data = [i for i, ax in enumerate(spec) if ax == "data"]
    return (Shard(data[0]) if data else Replicate(), Shard(model[0]) if model else Replicate())


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}" if prefix else k)
    else:
        yield prefix


def test_param_shardings_table_equals_jax_rules():
    import jax

    from vlm_bridge_tpu.configs import VLMConfig
    from vlm_bridge_tpu.models import full_model as jfull
    from vlm_bridge_tpu.parallel import sharding as jsh

    _, cfg, params = tiny_setup()
    jtree = jax.eval_shape(lambda: jfull.init(jax.random.key(0), VLMConfig.tiny_test()))
    paths = sorted(_paths(params))
    assert paths == sorted(_paths(jtree))
    scan = [f"lm/layers_scan/{g}/{m}" for g in ("a", "b", "tail")
            for m in ("attn/q", "attn/k", "attn/v", "attn/o", "mlp/gate", "mlp/up", "mlp/down",
                      "input_norm")]
    sharded = 0
    for path in paths + scan:
        for use in (True, False):
            want = _jax_placements(jsh._spec_for_path(path, use))
            assert _spec_for_path(path, use) == want, (path, use)
            sharded += want != (Replicate(), Replicate())
    # q, k, v, o, gate, up, down of every layer and of the scan layout's three groups
    assert sharded == 7 * cfg.lm.num_layers + 7 * 3
    mesh = Mesh(data=1, model=2, device=torch.device("cpu"))
    tree = param_shardings(mesh, params)
    assert tree["lm"]["layers"]["0"]["attn"]["q"] == (Replicate(), Shard(1))
    assert tree["lm"]["layers"]["1"]["mlp"]["down"] == (Replicate(), Shard(0))
    assert tree["bridge"]["blocks"]["0"]["cross"]["q"] == (Replicate(), Replicate())
    flat = param_shardings(auto_mesh(device="cpu"), params)
    assert {p for p in _leaves(flat)} == {(Replicate(), Replicate())}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_shard_batch_blocks():
    batch = {"x": np.arange(24).reshape(6, 4).astype(np.int32), "captions": ["a"] * 6}
    for rank, rows in ((0, [0, 1, 2]), (1, [3, 4, 5])):
        mesh = Mesh(data=2, model=1, device=torch.device("cpu"), rank=rank)
        assert batch_sharding(mesh, 6) == slice(rows[0], rows[-1] + 1)
        got = shard_batch(mesh, batch, dtypes={"x": torch.int64})
        assert set(got) == {"x"} and got["x"].dtype == torch.int64
        np.testing.assert_array_equal(got["x"].numpy(), batch["x"][rows])
    with pytest.raises(ValueError, match="does not split"):
        batch_sharding(Mesh(data=4, model=1, device=torch.device("cpu")), 6)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    """The 2-process run and the one-process references' inputs."""
    from vlm_bridge_tpu_torch.data.groundcap import make_synthetic_dataset

    root = tmp_path_factory.mktemp("dp")
    data = root / "data"
    # val: one image, a tail that does not split over two ranks
    assert make_synthetic_dataset(data, num_samples=80, image_size=70, seed=3)["val"] == 1
    out = root / "out"
    out.mkdir()
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dp_worker.py"),
                               "--out", str(out), "--data", str(data)],
                              env={**env, "RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)[-6000:]
    return data, out, logs


def test_two_ranks_with_unequal_token_counts_equal_one_process(dp_run):
    from vlm_bridge_tpu_torch.training.train_step import (init_train_state, loss_and_grads,
                                                           split_frozen)

    _, out, _ = dp_run
    r0, r1 = (np.load(out / f"grads_rank{r}.npz") for r in range(2))
    assert (int(r0["local_labels"]), int(r1["local_labels"])) == (17, 15)
    for k in r0.files:
        if k != "local_labels":
            np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)   # every rank the same

    tc, cfg, params = tiny_setup()
    state, _ = init_train_state(params, tc, 10)
    mesh = auto_mesh(device="cpu")
    whole = make_batch(cfg.image_size)
    kw = dict(dtypes={"input_ids": torch.int64})
    loss, aux, grads = loss_and_grads(cfg, tc, split_frozen(params), state.bridge_params,
                                      shard_batch(mesh, whole, **kw), None, torch.float32)
    assert int(r0["token_count"]) == int(aux["token_count"]) == 32
    np.testing.assert_allclose(r0["loss"], loss.numpy(), **GRAD_TOL)
    assert len(grads) == len(r0.files) - 3
    for i, g in enumerate(grads):
        np.testing.assert_allclose(r0[f"g{i}"], g.numpy(), **GRAD_TOL, err_msg=f"grad {i}")

    # the mean of the ranks' own means is another gradient: the test can tell
    halves = [loss_and_grads(cfg, tc, split_frozen(params), state.bridge_params,
                             shard_batch(mesh, {k: v[rows] for k, v in whole.items()}, **kw),
                             None, torch.float32)[2] for rows in (slice(0, 2), slice(2, 4))]
    mean_of_means = torch.cat([(a + b).reshape(-1) / 2 for a, b in zip(*halves)])
    exact = torch.cat([g.reshape(-1) for g in grads])
    assert float((mean_of_means - exact).abs().max()) > 100 * GRAD_TOL["rtol"] * float(
        exact.abs().max())


def test_orchestrator_ranks_agree_and_only_rank_0_writes(dp_run):
    _, out, _ = dp_run
    t0, t1 = (json.loads((out / f"train_rank{r}.json").read_text()) for r in range(2))
    assert t0["history"] == t1["history"] and t0["step"] == t1["step"] == 2
    assert np.isfinite(t0["history"][0]["train_loss"]) and np.isfinite(t0["history"][0]["val_loss"])
    assert t0["bridge_sha256"] == t1["bridge_sha256"]
    assert (t0["writer"], t1["writer"]) == ("SummaryWriter", "NullWriter")
    events = list((out / "logs").glob("events.out.tfevents.*"))
    assert len(events) == 1
    from vlm_bridge_tpu_torch.runtime.tb_writer import read_scalars

    assert len(read_scalars(events[0])["train/loss"]) == 2
    slots = sorted(p.name for p in (out / "ckpt").iterdir())
    assert slots == ["best", "best_weights_only", "latest"]   # no .tmp left by any rank


def test_eval_mesh_2_equals_one_process(dp_run, tmp_path):
    from vlm_bridge_tpu_torch.inference import evaluate

    data, out, _ = dp_run
    assert evaluate.main(["--data-dir", str(data), "--split", "test", "--preset", "tiny",
                          "--device", "cpu", "--batch-size", "4", "--max-length", "6",
                          "--output", str(tmp_path / "eval.json"),
                          "--dump-samples", str(tmp_path / "samples.jsonl")]) == 0
    want, got = (json.loads(p.read_text()) for p in (tmp_path / "eval.json", out / "eval.json"))
    assert got["metrics"] == want["metrics"] and got["num_samples"] == want["num_samples"]
    assert (out / "eval_samples.jsonl").read_text() == (tmp_path / "samples.jsonl").read_text()


def test_dryrun_multiprocess_2(monkeypatch):
    from vlm_bridge_tpu_torch.entry import dryrun_multiprocess

    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    records = dryrun_multiprocess(2, timeout_s=300)
    assert len(records) == 2 and len(records[0]["losses"]) == 5
    assert all(np.isfinite(records[0]["losses"]))
