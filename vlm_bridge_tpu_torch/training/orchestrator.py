"""Training orchestration: epoch loop, validation, early stopping, checkpoint
and resume, sample captions with BLEU, TensorBoard logging (port of
vlm_bridge_tpu.training.orchestrator).

The reference's metric tags, checkpoint slots (latest / best /
best_weights_only), early stopping (patience 3, min-delta 0.01 by default),
the `bridge_causal` meta field and the emergency checkpoint on
KeyboardInterrupt are kept. The loop keeps the JAX package's discipline: a
train step only queues work on the device; the metrics are read on the host
every `log_every_n_steps` steps, and the epoch's losses once at its end.

Data parallelism (one process per card, `parallel/`): every rank loads the
global batch with the same shuffle and keeps its block of rows; the train and
eval steps sum over the group (training/train_step.py), so losses and
decisions are the same on every rank. Only rank 0 writes TensorBoard events
(a NullWriter elsewhere, as JAX) and the checkpoint slots (the store's swap
runs on rank 0 behind barriers on every rank); validation samples pad their
batch to a multiple of the data axis and gather the ids.

What differs from the JAX package: an explicit torch.device per process;
the dropout stream is a torch.Generator on that device seeded from
(tc.seed + 1 + epoch) and, past rank 0, the rank; the optimizer state in a
checkpoint is BridgeOptimizer.state_dict's tree.
"""

from __future__ import annotations

import math
import time
from collections import Counter
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vlm_bridge_tpu_torch.configs import TrainingConfig, VLMConfig
from vlm_bridge_tpu_torch.data.loader import get_data_loaders
from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device, pad_to_batch
from vlm_bridge_tpu_torch.data.tokenizer import get_tokenizer
from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
from vlm_bridge_tpu_torch.parallel import Mesh, batch_sharding, distributed, shard_batch
from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore
from vlm_bridge_tpu_torch.runtime.profiling import StepProfiler
from vlm_bridge_tpu_torch.runtime.tb_writer import NullWriter, SummaryWriter
from vlm_bridge_tpu_torch.tools.loading import resolve_device
from vlm_bridge_tpu_torch.training.stack import build_mesh, build_stack
from vlm_bridge_tpu_torch.training.train_step import (BridgeOptimizer, TrainState, tree_leaves,
                                                       tree_map)


@dataclass
class TrainingContext:
    """Everything the loops need (reference TrainingContext,
    training_setup.py:99-115)."""

    tc: TrainingConfig
    cfg: VLMConfig
    device: torch.device
    mesh: Mesh
    frozen: dict
    state: TrainState
    opt: BridgeOptimizer
    schedule: Any
    train_loader: Any
    val_loader: Any
    tokenizer: Any
    writer: SummaryWriter
    store: CheckpointStore
    train_step: Any
    eval_step: Any
    start_epoch: int = 0
    best_val_loss: float = float("inf")
    early_stop_counter: int = 0
    activation_dtype: Any = torch.bfloat16


def prepare_environment(tc: TrainingConfig, *, params: Optional[dict] = None, tokenizer=None,
                        device=None, activation_dtype=None,
                        mesh: Optional[Mesh] = None) -> TrainingContext:
    """Build the full training context (reference prepare_environment,
    training_setup.py:118-188): model, loaders, optimizer, logging.

    device: where the model is made and trained (None: tc.device, else
    "cuda"; no fallback). params given: trained on the device they lie on,
    their f32 bridge updated in place. activation_dtype None derives from
    use_amp / amp_dtype (bf16 under AMP, else f32). mesh None:
    stack.build_mesh(tc) over the process group (one process without one)."""
    if params is not None:
        device = params["lm"]["final_norm"].device
    else:
        device = resolve_device(device or tc.device or "cuda")
    if mesh is None:
        mesh = build_mesh(tc, device)
    if tokenizer is None:
        tokenizer = get_tokenizer(tc.tokenizer_path)

    if tc.precache_pixels:
        # once per split: every epoch then streams a memmap in place of
        # decoding every JPEG again (reference data_loader.py:118)
        from vlm_bridge_tpu_torch.data.loader import VLDataset
        from vlm_bridge_tpu_torch.data.pixel_cache import build_pixel_cache

        for split in ("train", "val"):
            ds = VLDataset(tc.data_dir, split)
            if ds.pixels is None and len(ds):
                print(f"[data] building pixel cache for {split} ({len(ds)} images)...",
                      flush=True)
                build_pixel_cache(ds, num_workers=tc.num_workers)
        # every process builds what it misses (local disks); none attaches a
        # half-built view
        distributed.barrier()

    train_loader, val_loader, _ = get_data_loaders(
        tc.data_dir, batch_size=tc.batch_size, tokenizer=tokenizer,
        max_text_len=tc.max_text_len, buckets=tc.pad_to_buckets,
        num_workers=tc.num_workers, seed=tc.seed)
    steps_per_epoch = len(train_loader)
    if tc.max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, tc.max_steps_per_epoch)
    print(f"[data] train pixel source: "
          f"{'memmap cache' if train_loader.ds.pixels is not None else 'JPEG decode'}",
          flush=True)

    stack = build_stack(tc, params=params, device=device, mesh=mesh,
                        steps_per_epoch=steps_per_epoch, activation_dtype=activation_dtype)
    if mesh.rank == 0:
        writer = SummaryWriter(tc.log_dir)
        writer.add_text("config", "```\n" + "\n".join(
            f"{k}: {v}" for k, v in sorted(vars(tc).items())) + "\n```", 0)
    else:
        writer = NullWriter()
    return TrainingContext(
        tc=tc, cfg=stack.cfg, device=stack.device, mesh=stack.mesh, frozen=stack.frozen,
        state=stack.state,
        opt=stack.opt, schedule=stack.schedule, train_loader=train_loader,
        val_loader=val_loader, tokenizer=tokenizer, writer=writer,
        store=CheckpointStore(tc.checkpoint_dir), train_step=stack.train_step,
        eval_step=stack.eval_step, activation_dtype=stack.activation_dtype)


def _to_device(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of the loader's numpy arrays as tensors on its device
    (ids as int64)."""
    return shard_batch(mesh, {k: batch[k] for k in ("pixel_values", "input_ids", "attn_mask")},
                       dtypes={"input_ids": torch.int64})


def _pad_rows(batch: dict, rows: int) -> dict:
    """A partial batch padded to `rows` with rows that carry no token
    (attn_mask 0: no label, so the loss's sum and count are unchanged)."""
    n = batch["attn_mask"].shape[0]
    if n >= rows:
        return batch
    out = {k: pad_to_batch(batch[k], rows) for k in ("pixel_values", "input_ids")}
    out["attn_mask"] = np.concatenate(
        [batch["attn_mask"], np.zeros((rows - n,) + batch["attn_mask"].shape[1:],
                                      batch["attn_mask"].dtype)])
    return out


# ---------------------------------------------------------------------------
# Checkpoint save / load
# ---------------------------------------------------------------------------


def save_checkpoint(ctx: TrainingContext, epoch: int, val_loss: float, is_best: bool) -> None:
    meta = {
        "epoch": epoch,
        "step": int(ctx.state.step),
        "val_loss": float(val_loss),
        "best_val_loss": float(ctx.best_val_loss),
        "early_stop_counter": ctx.early_stop_counter,
        # serving needs to know which conditional was trained: exact-mode
        # eval of a causal-trained bridge must mask causally too
        "bridge_causal": bool(ctx.tc.bridge_causal),
    }
    bridge = ctx.state.bridge_params
    opt_state = ctx.opt.state_dict(ctx.state.opt_state, bridge)
    ctx.store.save("latest", bridge_params=bridge, opt_state=opt_state, meta=meta)
    if is_best:
        ctx.store.save("best", bridge_params=bridge, opt_state=opt_state, meta=meta)
        ctx.store.save("best_weights_only", bridge_params=bridge, meta=meta)


@torch.no_grad()
def load_checkpoint(ctx: TrainingContext, slot: str = "latest") -> None:
    """Restore the bridge, the optimizer state and the counters in place
    (reference load_checkpoint, training_orchestrator.py:159-193)."""
    bridge = ctx.state.bridge_params
    template = {"bridge_params": bridge,
                "opt_state": ctx.opt.state_dict(ctx.state.opt_state, bridge)}
    restored, meta = ctx.store.load(slot, template=template)
    for p, saved in zip(tree_leaves(bridge), tree_leaves(restored["bridge_params"])):
        p.copy_(saved)
    ctx.opt.load_state_dict(ctx.state.opt_state, restored["opt_state"], bridge)
    ctx.state = TrainState(step=int(meta.get("step", 0)), bridge_params=bridge,
                           opt_state=ctx.state.opt_state)
    ctx.start_epoch = meta.get("epoch", -1) + 1
    ctx.best_val_loss = meta.get("best_val_loss", float("inf"))
    ctx.early_stop_counter = meta.get("early_stop_counter", 0)


# ---------------------------------------------------------------------------
# Epoch loops
# ---------------------------------------------------------------------------


def run_training_epoch(ctx: TrainingContext, epoch: int) -> float:
    """The host reads the device only at the logging cadence (the metrics of
    that step: the fence of a timed window) and once at the epoch's end (all
    its losses together)."""
    tc = ctx.tc
    t_epoch = time.time()
    prof = StepProfiler(trace_dir=tc.profile_trace_dir if epoch == 0 else None,
                        start_step=tc.profile_start_step, num_steps=tc.profile_num_steps)
    drop = torch.Generator(device=ctx.device)
    drop.manual_seed(ctx.mesh.rank_seed(tc.seed + 1 + epoch))
    host_step = int(ctx.state.step)
    losses: List[torch.Tensor] = []  # device scalars, fetched once at the end
    n = 0
    # fenced windows between metric reads measure the steady rate; the first
    # window (kernel build, allocator warm-up) is left out
    t_fence, n_fence, fences = time.time(), 0, 0
    for batch_idx, batch in enumerate(ctx.train_loader):
        if tc.max_steps_per_epoch and batch_idx >= tc.max_steps_per_epoch:
            break
        dev_batch = _to_device(batch, ctx.mesh)
        with prof.step(record_time=False):
            ctx.state, metrics = ctx.train_step(ctx.state, ctx.frozen, dev_batch, drop)
        host_step += 1
        losses.append(metrics["loss"])
        n += 1
        if host_step % tc.log_every_n_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}  # the fence
            now = time.time()
            if fences > 0:
                prof.add_window(n - n_fence, now - t_fence)
            t_fence, n_fence, fences = now, n, fences + 1
            ctx.writer.add_scalar("train/loss", m["loss"], host_step)
            ctx.writer.add_scalar("train/learning_rate", m["learning_rate"], host_step)
            ctx.writer.add_scalar("train/grad_norm_before_clip", m["grad_norm_before_clip"],
                                  host_step)
    loss_vals = torch.stack(losses).float().tolist() if losses else []
    prof.close()
    avg = sum(loss_vals) / max(len(loss_vals), 1)
    dt = time.time() - t_epoch
    sps = n * tc.batch_size / max(dt, 1e-9)
    ctx.writer.add_scalar("epoch/train_loss", avg, epoch)
    summary = prof.summary()
    steady = (1000.0 * tc.batch_size / summary["step_ms_mean"]
              if "step_ms_mean" in summary else None)
    # epoch/samples_per_sec is the wall-clock rate (the first steps' kernel
    # build included); the steady rate has its own tag
    ctx.writer.add_scalar("epoch/samples_per_sec", sps, epoch)
    if steady is not None:
        ctx.writer.add_scalar("epoch/samples_per_sec_steady", steady, epoch)
    for k, v in summary.items():
        ctx.writer.add_scalar(f"perf/{k}", v, epoch)
    if steady is not None:
        ctx.writer.add_scalar("perf/samples_per_sec_steady", steady, epoch)
    print(f"[Train] epoch {epoch + 1}: loss {avg:.4f} ({n} steps, {sps:.2f} samples/s)")
    return avg


def run_validation_epoch(ctx: TrainingContext, epoch: int) -> float:
    tc = ctx.tc
    batch_losses: List[torch.Tensor] = []  # device scalars, one fetch at the end
    n = 0
    total_len, total_samples = 0.0, 0
    unique_tokens: set = set()
    total_tokens = 0
    data = ctx.mesh.data
    for batch in ctx.val_loader:
        # a tail batch that does not split over the ranks gets empty rows
        rows = -(-batch["attn_mask"].shape[0] // data) * data
        m = ctx.eval_step(ctx.frozen, ctx.state.bridge_params,
                          _to_device(_pad_rows(batch, rows), ctx.mesh))
        batch_losses.append(m["loss"])
        n += 1
        mask = batch["attn_mask"].astype(bool)
        total_len += batch["attn_mask"].sum()
        total_samples += batch["attn_mask"].shape[0]
        valid = batch["input_ids"][mask]
        unique_tokens.update(valid.tolist())
        total_tokens += valid.size
    if n == 0:
        # nan = "no validation happened": not a bad epoch for early stopping
        print("[Validation] WARNING: empty val loader — skipping validation")
        return float("nan")
    avg = float(sum(torch.stack(batch_losses).float().tolist())) / n
    ppl = math.exp(min(avg, 50.0))
    ctx.writer.add_scalar("val/loss", avg, epoch)
    ctx.writer.add_scalar("val/perplexity", ppl, epoch)
    ctx.writer.add_scalar("val/avg_sequence_length", total_len / max(total_samples, 1), epoch)
    ctx.writer.add_scalar("val/token_diversity", len(unique_tokens) / max(total_tokens, 1),
                          epoch)
    print(f"[Validation] epoch {epoch + 1}: loss {avg:.4f}, ppl {ppl:.2f}")

    if (epoch + 1) % tc.generate_samples_every_n_epochs == 0:
        generate_validation_samples(ctx, epoch)
    return avg


# ---------------------------------------------------------------------------
# Sample generation + BLEU
# ---------------------------------------------------------------------------


def simple_bleu4(candidate: str, reference: str) -> float:
    """Sentence BLEU-4 with brevity penalty and uniform n-gram weights
    (reference _calculate_simple_bleu4, core_training_loop.py:405-462)."""
    cand = candidate.lower().split()
    ref = reference.lower().split()
    if not cand or not ref:
        return 0.0
    log_precisions = []
    for order in range(1, 5):
        c_ngrams = Counter(tuple(cand[i:i + order]) for i in range(len(cand) - order + 1))
        r_ngrams = Counter(tuple(ref[i:i + order]) for i in range(len(ref) - order + 1))
        overlap = sum((c_ngrams & r_ngrams).values())
        total = max(sum(c_ngrams.values()), 1)
        if overlap == 0:
            return 0.0
        log_precisions.append(math.log(overlap / total))
    bp = 1.0 if len(cand) > len(ref) else math.exp(1 - len(ref) / max(len(cand), 1))
    return bp * math.exp(sum(log_precisions) / 4)


def generate_validation_samples(ctx: TrainingContext, epoch: int) -> None:
    """Caption the first val batch, log text + BLEU (reference
    _generate_validation_samples, core_training_loop.py:257-402). Sampling
    draws from a generator seeded with the epoch."""
    tc = ctx.tc
    batch = ctx.val_loader.first_batch()
    if batch is None:
        return
    k = min(tc.num_validation_samples, batch["pixel_values"].shape[0])
    params = {**ctx.frozen, "bridge": tree_map(lambda p: p.detach().to(ctx.activation_dtype),
                                               ctx.state.bridge_params)}
    # the sample batch padded to a multiple of the data axis; each rank
    # captions its rows and the ids are gathered in rank order
    data = ctx.mesh.data
    k_pad = -(-k // data) * data
    pixels_np = pad_to_batch(batch["pixel_values"][:k], k_pad)[batch_sharding(ctx.mesh, k_pad)]
    pixels = normalize_on_device(
        torch.from_numpy(np.ascontiguousarray(pixels_np)).to(ctx.device),
        dtype=ctx.activation_dtype)
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(ctx.mesh.rank_seed(epoch))
    toks, _ = generate_tokens(
        params, ctx.cfg, pixel_values=pixels, generator=gen,
        gen=GenerationConfig(max_length=50, temperature=0.7, top_p=0.9),
        activation_dtype=ctx.activation_dtype)
    if ctx.mesh.distributed:
        toks = distributed.all_gather_rows(toks)
    toks = toks.cpu().numpy()[:k]
    bleus, lens, all_words = [], [], []
    for i in range(k):
        text = ctx.tokenizer.decode(toks[i].tolist())
        ref_caption = batch["captions"][i]
        bleu = simple_bleu4(text, ref_caption)
        bleus.append(bleu)
        words = text.split()
        lens.append(len(words))
        all_words.extend(words)
        ctx.writer.add_text(
            f"val/sample_{i}",
            f"**generated:** {text}\n\n**reference:** {ref_caption}\n\n"
            f"**bleu4:** {bleu:.4f}", epoch)
    if bleus:
        ctx.writer.add_scalar("val/sample_bleu_avg", float(np.mean(bleus)), epoch)
        ctx.writer.add_scalar("val/sample_length_avg", float(np.mean(lens)), epoch)
        ctx.writer.add_scalar("val/sample_diversity",
                              len(set(all_words)) / max(len(all_words), 1), epoch)

    # the robust strategy sweep on the first sample (reference
    # core_training_loop.py:295-319); off by default
    if tc.validation_strategy_sweep and k > 0 and ctx.mesh.rank == 0:
        from vlm_bridge_tpu_torch.inference.robust import generate_caption_robust

        sweep_gen = torch.Generator(device=ctx.device)
        sweep_gen.manual_seed(epoch + 1)
        sweep = generate_caption_robust(params, ctx.cfg, pixels[:1], ctx.tokenizer,
                                        generator=sweep_gen, max_length=50,
                                        activation_dtype=ctx.activation_dtype)
        body = "\n\n".join(f"**{name}:** {cap}" for name, cap in sweep["results"].items())
        ctx.writer.add_text("val/strategy_sweep", body + f"\n\n**chosen:** {sweep['chosen']}",
                            epoch)


# ---------------------------------------------------------------------------
# Full training
# ---------------------------------------------------------------------------


def execute_full_training(tc: TrainingConfig, *, ctx: Optional[TrainingContext] = None,
                          device=None) -> Dict[str, Any]:
    """Epoch loop with resume, best tracking, early stopping and an
    emergency checkpoint on KeyboardInterrupt (reference
    execute_full_training, training_orchestrator.py:13-101). device: see
    prepare_environment (used only when ctx is None)."""
    if ctx is None:
        ctx = prepare_environment(tc, device=device)
    if tc.resume_from_checkpoint:
        load_checkpoint(ctx, tc.resume_from_checkpoint)
        print(f"resumed from epoch {ctx.start_epoch}")

    history: List[Dict[str, float]] = []
    epoch = ctx.start_epoch  # bound for the emergency-checkpoint path
    try:
        for epoch in range(ctx.start_epoch, tc.num_epochs):
            train_loss = run_training_epoch(ctx, epoch)
            val_loss = float("nan")
            if (epoch + 1) % tc.val_every_n_epochs == 0:
                val_loss = run_validation_epoch(ctx, epoch)
            if math.isfinite(val_loss):
                improved = val_loss < ctx.best_val_loss - tc.early_stopping_min_delta
                if improved:
                    ctx.best_val_loss = val_loss
                    ctx.early_stop_counter = 0
                else:
                    ctx.early_stop_counter += 1
            else:
                # no validation this epoch: neither an improvement nor a strike
                improved = False
            if (epoch + 1) % tc.save_every_n_epochs == 0:
                save_checkpoint(ctx, epoch, val_loss, improved)
            history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss})
            if tc.use_early_stopping and ctx.early_stop_counter >= tc.early_stopping_patience:
                print(f"early stopping at epoch {epoch + 1}")
                break
    except KeyboardInterrupt:
        print("interrupted — writing emergency checkpoint")
        save_checkpoint(ctx, epoch, float("nan"), False)
        raise
    finally:
        ctx.writer.flush()

    return {"history": history, "best_val_loss": ctx.best_val_loss,
            "epochs_run": len(history), "ctx": ctx}
