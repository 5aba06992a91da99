"""Entry points of the port for compile checks and multi-process dry runs
(counterpart of the JAX package's `__graft_entry__.py`).

- `entry()`: the masked-CE training forward of `VLMConfig.default()`
  (frozen DINOv2-large + Bridge-Lite + frozen Gemma-2-2B, bf16) at batch
  8 x 256 on the card, with example inputs: `fn(*example_args)` is the loss.
- `dryrun_multiprocess(n)`: n CPU processes joined over gloo, at the tiny
  preset, drive the data-parallel training stack through the JAX dry run's
  phases 1-5 on a data-only mesh: three train steps, a checkpoint save and
  restore, two steps from the restored state, one validation batch, one
  generation. Each rank prints its losses; the parent checks that every
  rank saw the same. (The dry run's GSPMD phases, 6 and 7, have no
  counterpart: tensor parallelism is not ported.)

    python -m vlm_bridge_tpu_torch.entry --dryrun 2
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import torch


def entry(device="cuda"):
    """(fn, example_args): fn(params, pixels, input_ids, attn_mask) is the
    masked-CE loss of the flagship model at batch 8 x 256 (seeded random
    weights, bf16 towers; the bridge's f32 master copy cast to bf16 inside
    fn, as the train step does)."""
    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.models import full_model
    from vlm_bridge_tpu_torch.tools.loading import resolve_device
    from vlm_bridge_tpu_torch.training.train_step import tree_map

    dev = resolve_device(device)
    cfg = VLMConfig.default()
    B, L = 8, 256
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = full_model.init(cfg, generator=gen, device=dev)
    pixels = torch.zeros((B, cfg.image_size, cfg.image_size, 3), dtype=torch.bfloat16,
                         device=dev)
    input_ids = torch.ones((B, L), dtype=torch.int64, device=dev)
    attn_mask = torch.ones((B, L), dtype=torch.int32, device=dev)

    def fn(params, pixels, input_ids, attn_mask):
        labels = full_model.shift_labels(input_ids, attn_mask)
        p = {**params, "bridge": tree_map(lambda w: w.to(torch.bfloat16), params["bridge"])}
        loss, _ = full_model.forward(p, cfg, pixels, input_ids, attn_mask, labels=labels,
                                     remat_lm=True, loss_chunk=128)
        return loss

    return fn, (params, pixels, input_ids, attn_mask)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multiprocess(n: int = 2, *, timeout_s: float = 600.0) -> list:
    """Run the five phases in n CPU processes over gloo; returns each rank's
    record (losses, validation loss, generated ids) after checking that
    they are equal."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
           "PYTHONPATH": os.pathsep.join([str(root)] + [p for p in [os.environ.get(
               "PYTHONPATH")] if p])}
    port = _free_port()
    with tempfile.TemporaryDirectory() as d:
        procs = [subprocess.Popen([sys.executable, "-m", "vlm_bridge_tpu_torch.entry",
                                   "--rank", str(r), "--world", str(n), "--port", str(port),
                                   "--dir", d], env=env)
                 for r in range(n)]
        try:
            rcs = [p.wait(timeout=timeout_s) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            raise RuntimeError(f"dry-run ranks exited with {rcs}")
        records = [json.loads((Path(d) / f"rank{r}.json").read_text()) for r in range(n)]
    for r, rec in enumerate(records[1:], start=1):
        if rec != records[0]:
            raise AssertionError(f"rank {r} differs from rank 0: {rec} != {records[0]}")
    print(f"dry run over {n} processes: every rank saw losses {records[0]['losses']}")
    return records


def _dryrun_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    import numpy as np

    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.parallel import init_multihost, shard_batch
    from vlm_bridge_tpu_torch.parallel.distributed import all_gather_rows
    from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore
    from vlm_bridge_tpu_torch.training.stack import build_stack
    from vlm_bridge_tpu_torch.training.train_step import TrainState, tree_leaves

    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    tc = TrainingConfig(model_preset="tiny_test", batch_size=max(world, 2) * 2,
                        loss_chunk_size=16, max_text_len=16)
    stack = build_stack(tc, device="cpu", steps_per_epoch=10, activation_dtype=torch.float32,
                        frozen_dtype=torch.float32)
    cfg, frozen, state, mesh = stack.cfg, stack.frozen, stack.state, stack.mesh
    B, T = tc.batch_size, 16
    rng = np.random.default_rng(0)
    lengths = rng.integers(4, T + 1, B)   # ragged: the ranks hold different token counts
    batch = {"pixel_values": rng.integers(0, 256, (B, cfg.image_size, cfg.image_size, 3),
                                          np.uint8),
             "input_ids": rng.integers(3, cfg.lm.vocab_size, (B, T)).astype(np.int32),
             "attn_mask": (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)}
    dev_batch = shard_batch(mesh, batch, dtypes={"input_ids": torch.int64})
    drop = torch.Generator().manual_seed(1 + rank)
    losses = []

    # phase 1: three train steps
    for _ in range(3):
        state, metrics = stack.train_step(state, frozen, dev_batch, drop)
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses)), losses
    print(f"[rank {rank}] phase 1 OK: 3 train steps, losses {losses}", flush=True)

    # phase 2: checkpoint save (rank 0 writes, behind barriers) and restore
    store = CheckpointStore(Path(out_dir) / "ckpt")
    opt_tree = stack.opt.state_dict(state.opt_state, state.bridge_params)
    store.save("latest", bridge_params=state.bridge_params, opt_state=opt_tree,
               meta={"step": int(state.step)})
    restored, meta = store.load("latest", template={"bridge_params": state.bridge_params,
                                                    "opt_state": opt_tree})
    for a, b in zip(tree_leaves(restored["bridge_params"]), tree_leaves(state.bridge_params)):
        assert torch.equal(a, b.detach())
    with torch.no_grad():
        for p, saved in zip(tree_leaves(state.bridge_params),
                            tree_leaves(restored["bridge_params"])):
            p.copy_(saved)
    stack.opt.load_state_dict(state.opt_state, restored["opt_state"], state.bridge_params)
    state = TrainState(step=meta["step"], bridge_params=state.bridge_params,
                       opt_state=state.opt_state)
    print(f"[rank {rank}] phase 2 OK: checkpoint save / restore at step {state.step}", flush=True)

    # phase 3: two more steps from the restored state
    for _ in range(2):
        state, metrics = stack.train_step(state, frozen, dev_batch, drop)
        losses.append(float(metrics["loss"]))
    assert state.step == 5, state.step
    print(f"[rank {rank}] phase 3 OK: resumed to step {state.step}, losses {losses[3:]}",
          flush=True)

    # phase 4: one validation batch
    val_loss = float(stack.eval_step(frozen, state.bridge_params, dev_batch)["loss"])
    assert np.isfinite(val_loss)
    print(f"[rank {rank}] phase 4 OK: val loss {val_loss}", flush=True)

    # phase 5: one generation, each rank its rows, the ids gathered
    params = {**frozen, "bridge": state.bridge_params}
    pixels = normalize_on_device(dev_batch["pixel_values"], dtype=torch.float32)
    toks, lens = generate_tokens(params, cfg, pixel_values=pixels,
                                 gen=GenerationConfig(max_length=6, greedy=True),
                                 activation_dtype=torch.float32)
    toks, lens = all_gather_rows(toks), all_gather_rows(lens)
    assert tuple(toks.shape) == (B, 7) and bool((lens >= 1).all()), (toks.shape, lens)
    print(f"[rank {rank}] phase 5 OK: generated {tuple(toks.shape)}", flush=True)

    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(
        {"losses": losses, "val_loss": val_loss, "tokens": toks.tolist()}))
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="vlm_bridge_tpu_torch.entry")
    ap.add_argument("--dryrun", type=int, default=None, help="run the dry run over N processes")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _dryrun_rank(args.rank, args.world, args.port, args.dir)
        return 0
    dryrun_multiprocess(args.dryrun or 2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
