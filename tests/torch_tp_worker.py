"""One rank of the multi-process gloo runs in tests/test_torch_tensor_parallel.py.

    MASTER_ADDR=127.0.0.1 MASTER_PORT=P WORLD_SIZE=n RANK=r \\
        python tests/torch_tp_worker.py --inputs IN --out OUT [--images DIR]

IN/params.npz and IN/params_mlp.npz hold a tiny tree made by the JAX package
(f32; the second with int8 MLP weights), flattened to "/"-joined keys, and
IN/inputs.npz the pixels and the train batch. With 2 processes:
1. `data`: the mesh (2, 1): generate_tokens(mesh=) greedy ids of the pixels,
   a batch of 3 refused; `vlm-caption-torch --mesh 2` over DIR (rank 0
   writes OUT/captions_mesh.jsonl);
2. `model`: the mesh (1, 2): shard_params's local blocks of layer 0, and for
   the float and the mixed tree the greedy ids and the first step's logits;
   loss_and_grads and two train steps on the train batch.
With 4 processes, `model` on the mesh (2, 2). Each rank writes
OUT/{case}_rank{r}.npz.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

MAX_NEW = 6
STEPS = 2


def unflatten(npz) -> dict:
    tree = {}
    for key in npz.files:
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = npz[key]
    return tree


def tiny_cfg():
    """The tiny preset with a dropout-free bridge (both packages' tests use it)."""
    from vlm_bridge_tpu_torch.configs import VLMConfig

    cfg = VLMConfig.tiny_test()
    return dataclasses.replace(cfg, bridge=dataclasses.replace(cfg.bridge, dropout=0.0))


def train_config():
    from vlm_bridge_tpu_torch.configs import TrainingConfig

    return TrainingConfig(model_preset="tiny_test", loss_chunk_size=8, learning_rate=1e-3,
                          min_lr=1e-4, num_epochs=1)


def load_params(path: Path) -> dict:
    from vlm_bridge_tpu_torch.params.from_jax import from_jax

    return from_jax(unflatten(np.load(path)))


def data_case(inputs: Path, out: Path, images, rank: int) -> None:
    from vlm_bridge_tpu_torch.inference import caption
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.parallel import auto_mesh, shard_params

    cfg = tiny_cfg()
    mesh = auto_mesh(2, 1, device="cpu")
    params = shard_params(mesh, load_params(inputs / "params.npz"), cfg=cfg)
    pixels = torch.from_numpy(np.load(inputs / "inputs.npz")["pixels"])
    gen = GenerationConfig(max_length=MAX_NEW, greedy=True)
    toks, lens = generate_tokens(params, cfg, pixel_values=pixels, gen=gen,
                                 activation_dtype=torch.float32, mesh=mesh)
    try:
        generate_tokens(params, cfg, pixel_values=pixels[:3], gen=gen,
                        activation_dtype=torch.float32, mesh=mesh)
        refused = ""
    except ValueError as e:
        refused = str(e)
    np.savez(out / f"data_rank{rank}.npz", tokens=toks.numpy(), lengths=lens.numpy(),
             refused=refused)
    rc = caption.main([str(images), "--preset", "tiny", "--device", "cpu", "--max-length",
                       str(MAX_NEW), "--batch-size", "4", "--mesh", "2",
                       "--output", str(out / "captions_mesh.jsonl")])
    assert rc == 0, rc


def model_case(inputs: Path, out: Path, rank: int, world: int) -> None:
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.models import full_model
    from vlm_bridge_tpu_torch.parallel import auto_mesh, shard_batch, shard_params
    from vlm_bridge_tpu_torch.training import train_step as ts

    cfg, tc = tiny_cfg(), train_config()
    mesh = auto_mesh(world // 2, 2, device="cpu")
    arrays = np.load(inputs / "inputs.npz")
    pixels = torch.from_numpy(arrays["pixels"])
    bos = torch.full((pixels.shape[0], 1), cfg.lm.bos_token_id, dtype=torch.long)
    res = {}
    for name in ("params", "params_mlp"):
        params = shard_params(mesh, load_params(inputs / f"{name}.npz"), cfg=cfg)
        if name == "params":
            layer = params["lm"]["layers"]["0"]
            for group, leaves in (("attn", "qkvo"), ("mlp", ("gate", "up", "down"))):
                for leaf in leaves:
                    res[f"shard/{group}/{leaf}"] = layer[group][leaf].numpy()
        toks, lens = generate_tokens(params, cfg, pixel_values=pixels,
                                     gen=GenerationConfig(max_length=MAX_NEW, greedy=True),
                                     activation_dtype=torch.float32, mesh=mesh)
        with torch.no_grad():
            logits = full_model.forward(params, cfg, pixels, bos, torch.ones_like(bos))
        res[f"{name}/tokens"], res[f"{name}/lengths"] = toks.numpy(), lens.numpy()
        res[f"{name}/logits"] = logits[:, 0].numpy()

    params = shard_params(mesh, load_params(inputs / "params.npz"), cfg=cfg)
    frozen = ts.split_frozen(params)
    state, opt = ts.init_train_state(params, tc, steps_per_epoch=10)
    batch = shard_batch(mesh, {k: arrays[k] for k in ("pixel_values", "input_ids", "attn_mask")},
                        dtypes={"input_ids": torch.int64})
    loss, aux, grads = ts.loss_and_grads(cfg, tc, frozen, state.bridge_params, batch, None,
                                         torch.float32, mesh)
    res["grads/loss"], res["grads/token_count"] = loss.numpy(), aux["token_count"].numpy()
    res.update({f"grads/g{i}": g.numpy() for i, g in enumerate(grads)})
    step = ts.make_train_step(cfg, tc, opt, ts.make_schedule(tc, 10),
                              activation_dtype=torch.float32, mesh=mesh)
    losses, norms = [], []
    for _ in range(STEPS):
        state, metrics = step(state, frozen, batch, None)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm_before_clip"]))
    res["train/losses"], res["train/grad_norms"] = np.array(losses), np.array(norms)
    res.update({f"train/bridge{i}": p.detach().numpy()
                for i, p in enumerate(ts.tree_leaves(state.bridge_params))})
    np.savez(out / f"model_rank{rank}.npz", **res)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--images", default=None)
    args = ap.parse_args()
    torch.set_num_threads(2)

    import torch.distributed as dist

    from vlm_bridge_tpu_torch.parallel import init_multihost

    assert init_multihost(device="cpu")   # MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    rank, world = dist.get_rank(), dist.get_world_size()
    inputs, out = Path(args.inputs), Path(args.out)
    if world == 2:
        data_case(inputs, out, args.images, rank)
    model_case(inputs, out, rank, world)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
