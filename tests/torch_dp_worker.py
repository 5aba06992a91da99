"""One rank of the 2-process gloo run in tests/test_torch_parallel.py.

    MASTER_ADDR=127.0.0.1 MASTER_PORT=P WORLD_SIZE=2 RANK=r \\
        python tests/torch_dp_worker.py --out DIR --data DATA

Joins the group from the launcher's environment (init_multihost), then:
1. `grads`: loss_and_grads on this rank's rows of `make_batch()` (rows whose
   token counts differ between the ranks) -> DIR/grads_rank{r}.npz;
2. `orchestrator`: execute_full_training for 2 steps on DATA with shared
   checkpoint and log directories -> DIR/train_rank{r}.json;
3. `eval`: vlm-eval-torch --mesh 2 --device cpu on DATA's test split (rank
   0 writes DIR/eval.json and DIR/eval_samples.jsonl).
"""

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ROWS, T = 4, 16
LENGTHS = (16, 3, 12, 5)   # rank 0 holds 17 labels, rank 1 holds 15


def tiny_setup():
    """(tc, cfg, params): the tiny preset with a dropout-free bridge, f32 on
    the CPU, seeded (the same on every rank)."""
    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.training.stack import init_params

    tc = TrainingConfig(model_preset="tiny_test", loss_chunk_size=8, seed=7)
    cfg = tc.model_config()
    cfg = dataclasses.replace(cfg, bridge=dataclasses.replace(cfg.bridge, dropout=0.0))
    return tc, cfg, init_params(tc, cfg, frozen_dtype=torch.float32, device="cpu")


def make_batch(image_size: int) -> dict:
    rng = np.random.default_rng(11)
    return {"pixel_values": rng.integers(0, 256, (ROWS, image_size, image_size, 3), np.uint8),
            "input_ids": rng.integers(3, 512, (ROWS, T)).astype(np.int32),
            "attn_mask": (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.int32)}


def grads_case(out: Path, rank: int) -> None:
    from vlm_bridge_tpu_torch.parallel import auto_mesh, shard_batch, shard_params
    from vlm_bridge_tpu_torch.training.train_step import (init_train_state, loss_and_grads,
                                                           split_frozen)

    tc, cfg, params = tiny_setup()
    mesh = auto_mesh(device="cpu")
    params = shard_params(mesh, params)
    state, _ = init_train_state(params, tc, 10)
    batch = shard_batch(mesh, make_batch(cfg.image_size), dtypes={"input_ids": torch.int64})
    loss, aux, grads = loss_and_grads(cfg, tc, split_frozen(params), state.bridge_params, batch,
                                      None, torch.float32, mesh)
    np.savez(out / f"grads_rank{rank}.npz", loss=loss.numpy(),
             token_count=aux["token_count"].numpy(),
             local_labels=int(batch["attn_mask"][:, 1:].sum()),
             **{f"g{i}": g.numpy() for i, g in enumerate(grads)})


def orchestrator_case(out: Path, data: str, rank: int) -> None:
    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.training.orchestrator import execute_full_training
    from vlm_bridge_tpu_torch.training.train_step import tree_leaves

    tc = TrainingConfig(model_preset="tiny_test", data_dir=data, batch_size=4, num_epochs=1,
                        max_steps_per_epoch=2, checkpoint_dir=str(out / "ckpt"),
                        log_dir=str(out / "logs"), num_workers=0, log_every_n_steps=1,
                        num_validation_samples=3, max_text_len=32, loss_chunk_size=16)
    res = execute_full_training(tc, device="cpu")
    ctx = res["ctx"]
    bits = hashlib.sha256(b"".join(t.detach().numpy().tobytes()
                                   for t in tree_leaves(ctx.state.bridge_params))).hexdigest()
    (out / f"train_rank{rank}.json").write_text(json.dumps(
        {"history": res["history"], "step": ctx.state.step, "bridge_sha256": bits,
         "writer": type(ctx.writer).__name__}))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--data", required=True)
    args = ap.parse_args()
    torch.set_num_threads(2)
    out = Path(args.out)

    import torch.distributed as dist

    from vlm_bridge_tpu_torch.inference import evaluate
    from vlm_bridge_tpu_torch.parallel import init_multihost

    assert init_multihost(device="cpu")   # MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    rank = dist.get_rank()
    grads_case(out, rank)
    orchestrator_case(out, args.data, rank)
    rc = evaluate.main(["--data-dir", args.data, "--split", "test", "--preset", "tiny",
                        "--device", "cpu", "--batch-size", "4", "--max-length", "6",
                        "--mesh", "2", "--output", str(out / "eval.json"),
                        "--dump-samples", str(out / "eval_samples.jsonl")])
    dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
