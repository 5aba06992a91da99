"""Bridge training: the port's train step (`training/train_step`) over
seeded batches of images and ragged captions padded to one bucket, steps
back to back as the orchestrator's steady loop runs them, each batch copied
from pinned host memory; no saves or validation in the window.

Set-up builds the one train step with its model and optimizer state and
drives it from the seed through its first steps on distinct batches; the
window goes on with the same object. The first three steps are what the
reference follows.

Traffic keys: bridge_gain (portbench.weights), batch, seq, shortest (the
shortest caption), pool (distinct batches, cycled), first_steps,
trace_steps, steps_per_epoch, training (the TrainingConfig fields both
sides take: learning_rate, min_lr, weight_decay, gradient_clip_val,
num_epochs, scheduler_type), adam (beta1, beta2, eps: torch.optim.AdamW's
defaults, which the port's optimizer sets)."""

from __future__ import annotations

import gc
import math
import time

import torch

from portbench import arith, log, tracing, traffic, weights
from portbench.reference import check as ref_check


def cosine_lrs(tr: dict, steps_per_epoch: int, n: int) -> list:
    """The cosine schedule's rates at optimizer counts 0..n-1."""
    total = max(1, tr["num_epochs"] * steps_per_epoch)
    lr, alpha = tr["learning_rate"], tr["min_lr"] / tr["learning_rate"]
    return [lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * min(c, total) / total))
                  + alpha) for c in range(n)]


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.spec["traffic"]
        self.dev = ctx.device
        self.cfg = ctx.vcfg

    def setup(self) -> None:
        from vlm_bridge_tpu_torch.configs import TrainingConfig
        from vlm_bridge_tpu_torch.training import train_step as ts

        t, seed, dev = self.t, self.ctx.seed, self.dev
        if t["training"].get("scheduler_type") != "cosine":
            raise ValueError("the reference follows the cosine schedule only")
        tc = TrainingConfig(batch_size=t["batch"], **t["training"])
        params = weights.make(self.cfg, seed, dev, t["bridge_gain"])
        self.frozen = ts.split_frozen(params)
        self.state, opt = ts.init_train_state(params, tc, t["steps_per_epoch"])
        del params
        log("weights made")
        schedule = ts.make_schedule(tc, t["steps_per_epoch"])
        self.step = ts.make_train_step(self.cfg, tc, opt, schedule)
        self.pool = traffic.train_pool(seed, t["pool"], t["batch"], t["seq"], t["shortest"],
                                       self.cfg.image_size, self.cfg.lm.vocab_size, dev)
        self.step_flops = [arith.train_step_flops(self.cfg, b["attn_mask"].sum(dim=1).tolist())
                           for b in self.pool]
        self.drop = torch.Generator(device=dev)
        self.drop.manual_seed(traffic.stream_seed(seed, 3))
        self.n = 0
        paths = ref_check.leaf_paths(self.state.bridge_params)
        start = [p.detach().clone() for _, p in paths]
        adamw = self.state.opt_state["adamw"]
        losses, grad = [], None
        for s in range(t["first_steps"]):
            losses.append(self._one())
            if s == 0:   # the clipped gradient the optimizer got: its first moment / (1 - b1)
                b1 = adamw.param_groups[0]["betas"][0]
                grad = [adamw.state[p]["exp_avg"] / (1.0 - b1) if p in adamw.state
                        else torch.zeros_like(p) for _, p in paths]
        change = [torch.linalg.vector_norm(p.detach() - s0) for (_, p), s0 in zip(paths, start)]
        del start
        log(f"first {t['first_steps']} steps done")
        self.readings = {"losses": [float(x) for x in losses], "grad_vec": grad,
                         "grad": [float(torch.linalg.vector_norm(g)) for g in grad],
                         "change": [float(x) for x in change]}
        traffic.sync(dev)

    def _one(self):
        """One step on the next batch of the pool; its loss (on the device)."""
        batch = traffic.to_device(self.pool[self.n % self.t["pool"]], self.dev)
        self.state, metrics = self.step(self.state, self.frozen, batch, self.drop)
        self.n += 1
        return metrics["loss"]

    def _flops(self, first: int, steps: int) -> float:
        """Model FLOPs of `steps` steps from the `first`-th on, over each
        row's own caption tokens (the pool is cycled)."""
        pool = self.t["pool"]
        return sum(self.step_flops[s % pool] for s in range(first, first + steps))

    def window(self, seconds: float, traced: bool, tail: bool = True) -> dict:
        """`seconds` of steps back to back, ending in a synchronise. traced:
        the same window, then trace_steps steps under the profiler; the
        step's share of the peak is read from the untraced window."""
        t = self.t
        first = self.n
        losses = []
        t_start = time.perf_counter()
        t_end = t_start + seconds
        while time.perf_counter() < t_end:
            losses.append(self._one())
        traffic.sync(self.dev)
        elapsed = time.perf_counter() - t_start
        res = {"e2e": {"train_samples_per_s": len(losses) * t["batch"] / elapsed},
               "attempted": len(losses) * t["batch"], "failed": self._failed(losses)}
        if not traced:
            return res
        rate = self._flops(first, len(losses)) / elapsed
        k = t["trace_steps"]
        traced_losses = []
        # the card alone: its readers go by kernel names, and the host's
        # trace would slow a step of ~8,000 launches by half
        with tracing.profile(self.dev, host=False) as prof:
            t0 = time.perf_counter()
            for _ in range(k):
                traced_losses.append(self._one())
            traffic.sync(self.dev)
            window_s = time.perf_counter() - t0
        return {"trace": tracing.read(prof, {"steps": k, "flops_per_s": rate}, window_s),
                "attempted": res["attempted"] + k * t["batch"],
                "failed": res["failed"] + self._failed(traced_losses)}

    def _failed(self, losses: list) -> int:
        if not losses:
            return 0
        bad = ~torch.isfinite(torch.stack(losses))
        return int(bad.sum()) * self.t["batch"]

    def free(self) -> None:
        self.state = self.frozen = self.step = None
        gc.collect()
        torch.cuda.empty_cache()

    def check(self, control: dict | None = None) -> dict:
        """loss_gap, grad_gap, grad_err, change_gap of the first steps
        against the reference; with `control` ({"fp8": true}) the control's
        too."""
        from portbench.reference import model

        self.free()
        t, seed = self.t, self.ctx.seed
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c = self.ctx.cfg_file["port"]
        raw = weights.make(self.cfg, seed, self.dev, t["bridge_gain"])
        batches = [traffic.to_device(self.pool[s], self.dev) for s in range(t["first_steps"])]
        opt = {**t["adam"], "weight_decay": t["training"]["weight_decay"],
               "clip": t["training"]["gradient_clip_val"],
               "lrs": cosine_lrs(t["training"], t["steps_per_epoch"], t["first_steps"])}

        def follow(lin):
            drop = torch.Generator(device=self.dev)
            drop.manual_seed(traffic.stream_seed(seed, 3))
            return ref_check.train_reference(raw, c, batches, drop, opt, lin=lin)

        ref = follow(model.matmul)
        out = {"numbers": ref_check.train_numbers(self.readings, ref)}
        if control is not None:
            low = follow(model.fp8_matmul if control.get("fp8") else model.matmul)
            out["control"] = ref_check.train_numbers(low, ref)
            out["leaves"] = [
                [".".join(p), n, e, c] for p, n, e, c in zip(
                    ref["paths"], ref["grad"],
                    ref_check.leaf_errors(self.readings["grad_vec"], ref["grad_vec"]),
                    ref_check.leaf_errors(low["grad_vec"], ref["grad_vec"]))]
        return out
