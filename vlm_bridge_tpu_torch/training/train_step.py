"""Training and evaluation steps (port of vlm_bridge_tpu.training.train_step).

Left-shifted CE (pad-masked), global-norm gradient clip 0.3, AdamW over the
bridge parameters only, cosine / linear / constant learning rate stepped per
optimizer step, and the gradient norm before the clip as a metric.

What differs from the JAX package, and why:
- the step runs eagerly; nothing is traced or donated. The bridge's f32
  master copy and the optimizer state are updated IN PLACE (the returned
  TrainState holds the same tensors), which saves a copy of both;
- `TrainState.step` is a host integer, so reading it costs no device sync;
- the optimizer arithmetic is optax's: `clip_by_global_norm` scales by
  max_norm / norm only when norm >= max_norm (no epsilon), AdamW is
  -lr (m^ / (sqrt(v^) + eps) + wd p) with the schedule read at the optimizer
  step count from 0, and accumulation is `optax.MultiSteps`: a running mean
  of k microbatch gradients, no update on the k - 1 steps between, one
  schedule step per k. torch.optim.AdamW does the update algebra; the clip
  and the accumulation are written here;
- dropout takes a torch.Generator on the batch's device in place of a key;
- data parallelism is explicit (`mesh`, parallel/sharding.py): each rank
  holds a block of the global batch's rows. The JAX loss is the global
  batch's nll sum over its global token count, so each rank divides its
  sum by the count all-reduced over the group (reduced before the forward),
  and the bridge gradients and the loss are summed over the group before the
  clip. The mean of per-rank means would be another number whenever the
  ranks hold different token counts. Under accumulation every microbatch
  is a global batch, as in JAX.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import torch

from vlm_bridge_tpu_torch.configs import TrainingConfig, VLMConfig
from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
from vlm_bridge_tpu_torch.models import full_model
from vlm_bridge_tpu_torch.parallel import distributed


class TrainState(NamedTuple):
    step: int              # global step, counts microbatches
    bridge_params: dict    # f32 master copy; leaves require grad
    opt_state: dict        # BridgeOptimizer.init's


def tree_leaves(tree) -> list:
    """Tensors of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def make_schedule(tc: TrainingConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate as a function of the OPTIMIZER step over the full run.
    steps_per_epoch counts microbatches; under gradient accumulation the
    schedule advances once per effective batch, so the horizon divides by k."""
    accum = max(1, tc.gradient_accumulation_steps)
    total = max(1, tc.num_epochs * steps_per_epoch // accum)
    lr, end = tc.learning_rate, tc.min_lr
    if not tc.use_scheduler or tc.scheduler_type == "constant":
        return lambda count: lr
    if tc.scheduler_type == "cosine":
        alpha = end / lr

        def cosine(count: int) -> float:
            frac = min(count, total) / total
            return lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)
        return cosine
    if tc.scheduler_type == "linear":
        return lambda count: (lr - end) * (1.0 - min(max(count, 0), total) / total) + end
    raise ValueError(f"unknown scheduler_type: {tc.scheduler_type}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors, f32, on their device."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t.float()) for t in tensors]))


class BridgeOptimizer:
    """clip(gradient_clip_val) -> AdamW(b1 .9, b2 .999, eps 1e-8, wd) with the
    schedule, wrapped in k-step accumulation when
    gradient_accumulation_steps > 1 (the JAX package's optax chain)."""

    def __init__(self, tc: TrainingConfig, steps_per_epoch: int):
        self.schedule = make_schedule(tc, steps_per_epoch)
        self.clip = tc.gradient_clip_val
        self.weight_decay = tc.weight_decay
        self.every_k = max(1, tc.gradient_accumulation_steps)

    def init(self, bridge_params: dict) -> dict:
        leaves = tree_leaves(bridge_params)
        adamw = torch.optim.AdamW(leaves, lr=self.schedule(0), betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=self.weight_decay)
        acc = [torch.zeros_like(p) for p in leaves] if self.every_k > 1 else None
        return {"adamw": adamw, "count": 0, "mini_step": 0, "acc": acc}

    @torch.no_grad()
    def update(self, grads, state: dict, leaves) -> None:
        """One microbatch's gradients: accumulate, and on every k-th call clip
        and apply AdamW to `leaves` in place."""
        if self.every_k > 1:
            acc, n = state["acc"], state["mini_step"]
            for a, g in zip(acc, grads):
                a.add_((g - a) / (n + 1))  # running mean, as optax.MultiSteps keeps it
            state["mini_step"] = (n + 1) % self.every_k
            if state["mini_step"] != 0:
                return
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
        norm = global_norm(grads)
        scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        adamw = state["adamw"]
        adamw.param_groups[0]["lr"] = self.schedule(state["count"])
        for p, g in zip(leaves, grads):
            p.grad = g * scale
        adamw.step()
        adamw.zero_grad(set_to_none=True)
        state["count"] += 1


    def state_dict(self, state: dict, bridge_params: dict) -> dict:
        """The optimizer state as a tree of tensors (for CheckpointStore):
        AdamW's moments "mu" / "nu" in the bridge tree's nesting (zeros before
        the first update), its step "adam_step", the schedule's "count", the
        accumulation's "mini_step" and, with k > 1, its running mean "acc".
        The moments are the live tensors, not copies."""
        adamw = state["adamw"]
        leaves = tree_leaves(bridge_params)

        def moment(key):
            return _unflatten(bridge_params, [
                adamw.state[p][key] if p in adamw.state else torch.zeros_like(p)
                for p in leaves])

        first = adamw.state.get(leaves[0], {})
        out = {"mu": moment("exp_avg"), "nu": moment("exp_avg_sq"),
               "adam_step": first.get("step", torch.zeros((), dtype=torch.float32)),
               "count": torch.tensor(state["count"], dtype=torch.int64),
               "mini_step": torch.tensor(state["mini_step"], dtype=torch.int64)}
        if state["acc"] is not None:
            out["acc"] = _unflatten(bridge_params, state["acc"])
        return out

    @torch.no_grad()
    def load_state_dict(self, state: dict, tree: dict, bridge_params: dict) -> None:
        """Set `state` (BridgeOptimizer.init's, over the same bridge leaves)
        from a state_dict tree, copying every tensor bit for bit."""
        adamw = state["adamw"]
        leaves = tree_leaves(bridge_params)
        mus, nus = tree_leaves(tree["mu"]), tree_leaves(tree["nu"])
        step = tree["adam_step"].detach().to("cpu", torch.float32)
        adamw.state.clear()
        if float(step) > 0:
            for p, mu, nu in zip(leaves, mus, nus):
                adamw.state[p] = {"step": step.clone(),
                                  "exp_avg": mu.detach().to(p.device, copy=True),
                                  "exp_avg_sq": nu.detach().to(p.device, copy=True)}
        state["count"] = int(tree["count"])
        state["mini_step"] = int(tree["mini_step"])
        if state["acc"] is not None:
            for a, saved in zip(state["acc"], tree_leaves(tree["acc"])):
                a.copy_(saved)


def _unflatten(like: dict, leaves: list) -> dict:
    """The inverse of tree_leaves: `leaves` in the nesting of `like`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def make_optimizer(tc: TrainingConfig, steps_per_epoch: int) -> BridgeOptimizer:
    return BridgeOptimizer(tc, steps_per_epoch)


def init_train_state(params: dict, tc: TrainingConfig,
                     steps_per_epoch: int) -> Tuple[TrainState, BridgeOptimizer]:
    """The bridge subtree becomes the f32 master copy (leaves that require
    grad; f32 leaves keep their storage)."""
    opt = make_optimizer(tc, steps_per_epoch)
    bridge = tree_map(lambda p: p.detach().float().requires_grad_(True),
                      full_model.trainable_params(params))
    return TrainState(step=0, bridge_params=bridge, opt_state=opt.init(bridge)), opt


def _prep_pixels(pixel_values: torch.Tensor, activation_dtype) -> torch.Tensor:
    if pixel_values.dtype == torch.uint8:
        return normalize_on_device(pixel_values, dtype=activation_dtype)
    return pixel_values.to(activation_dtype)


def _distributed(mesh) -> bool:
    return mesh is not None and mesh.distributed


def _loss(cfg: VLMConfig, tc: TrainingConfig, frozen: dict, bridge_params: dict, batch: dict,
          activation_dtype, mesh=None, **kw):
    pixels = _prep_pixels(batch["pixel_values"], activation_dtype)
    input_ids, attn_mask = batch["input_ids"], batch["attn_mask"]
    labels = full_model.shift_labels(input_ids, attn_mask, mask_pad=tc.mask_pad_loss)
    if _distributed(mesh):
        # the global batch's token count, the denominator of every rank's sum
        (kw["loss_denominator"],) = distributed.all_reduce_sum([(labels != -100).sum()])
    # the cast sits inside the differentiated function, so the gradient
    # arrives in f32 on the master copy
    params = {**frozen, "bridge": tree_map(lambda p: p.to(activation_dtype), bridge_params)}
    return full_model.forward(
        params, cfg, pixels, input_ids, attn_mask, labels=labels,
        mask_pad_loss=tc.mask_pad_loss, bridge_causal=tc.bridge_causal,
        loss_chunk=tc.loss_chunk_size, **kw)


def loss_and_grads(cfg: VLMConfig, tc: TrainingConfig, frozen: dict, bridge_params: dict,
                   batch: dict, generator, activation_dtype=torch.bfloat16, mesh=None):
    """Training loss, aux and the gradients of the bridge leaves (the order
    of `tree_leaves`); nothing is updated. With a distributed mesh, `batch`
    is this rank's block of rows and the loss and gradients returned are the
    global batch's, the same on every rank."""
    loss, aux = _loss(cfg, tc, frozen, bridge_params, batch, activation_dtype, mesh,
                      generator=generator, train=True, remat_lm=tc.remat_lm,
                      loss_remat=tc.loss_remat)
    grads = torch.autograd.grad(loss, tree_leaves(bridge_params))
    loss = loss.detach()
    if _distributed(mesh):
        *grads, loss = distributed.all_reduce_sum([*grads, loss.reshape(1)])
        loss = loss.reshape(())
    return loss, aux, grads


def make_train_step(cfg: VLMConfig, tc: TrainingConfig, opt: BridgeOptimizer, schedule, *,
                    activation_dtype=torch.bfloat16, mesh=None):
    """Build the train step: (state, frozen, batch, generator) -> (state, metrics).

    frozen: the vision and lm subtrees, requires_grad False. generator: the
    dropout source on the batch's device (it advances from step to step;
    None trains without dropout). The metrics are 0-dim tensors on the
    device, apart from the learning rate, so a step forces no sync. mesh:
    see loss_and_grads (the gradients are summed before the clip)."""

    def step_fn(state: TrainState, frozen: dict, batch: dict, generator):
        loss, aux, grads = loss_and_grads(cfg, tc, frozen, state.bridge_params, batch,
                                          generator, activation_dtype, mesh)
        grad_norm = global_norm(grads)
        opt.update(grads, state.opt_state, tree_leaves(state.bridge_params))
        metrics = {
            "loss": loss,
            "grad_norm_before_clip": grad_norm,
            # state.step counts microbatches; the schedule advances once per
            # optimizer step
            "learning_rate": schedule(state.step // max(1, tc.gradient_accumulation_steps)),
            "token_count": aux["token_count"],
        }
        return TrainState(state.step + 1, state.bridge_params, state.opt_state), metrics

    return step_fn


def make_eval_step(cfg: VLMConfig, tc: TrainingConfig, *, activation_dtype=torch.bfloat16,
                   mesh=None):
    """Validation step: loss, token count and mean sequence length (of this
    rank's rows; the loss and the count are the global batch's under a
    distributed mesh)."""

    @torch.no_grad()
    def step_fn(frozen: dict, bridge_params: dict, batch: dict):
        loss, aux = _loss(cfg, tc, frozen, bridge_params, batch, activation_dtype, mesh,
                          remat_lm=False)
        if _distributed(mesh):
            (loss,) = distributed.all_reduce_sum([loss])
        return {
            "loss": loss,
            "token_count": aux["token_count"],
            "avg_sequence_length": batch["attn_mask"].sum(dim=1).float().mean(),
        }

    return step_fn


def split_frozen(params: dict) -> dict:
    """The non-trainable subtree (vision + lm)."""
    return {k: v for k, v in params.items() if k != "bridge"}
