"""Captioning: a closed loop with one client that keeps one batch in flight
behind the one it reads, as the port's evaluate_split does. A batch is the
cell's uint8 images handed to the port on the host; its time runs from that
hand-over to its tokens being on the host. The port is driven through
`encode_image` and `generate_tokens(vision_features=...)` over weights
quantized and stacked as `vlm-eval-torch --quantize ...` serves them.

Traffic keys: bridge_gain (portbench.weights), batch, new_tokens, pool
(distinct image batches, cycled), quantize (the recipe's parts), kv_int8,
mlp_int4, mlp_int4_group, sampling (null: greedy; else temperature, top_p,
topk_window), greedy_every (in a sampled mix, every n-th batch is greedy,
from batch 0), trace_batches, check_batches (of each kind)."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import statistics
import time

import torch

from portbench import arith, log, tracing, traffic, weights
from portbench.reference import check as ref_check


def reference_forms(t: dict) -> dict:
    """How the recipe serves each weight group, in the reference's terms."""
    parts = set(t["quantize"])
    if t.get("mlp_int4") and t.get("mlp_int4_group") != 128:
        raise ValueError("the reference models int4 MLP weights in groups of 128")
    return {"attn": "int8" if "attn" in parts else None,
            "mlp": ("int4g128_of_int8" if t.get("mlp_int4") else "int8") if "mlp" in parts
            else None,
            "table": "int8" if "embedding" in parts else
            "int4_rows" if "embedding4" in parts else None,
            "bridge": "int8" if "bridge" in parts else None}


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.t = ctx.spec["traffic"]
        self.dev = ctx.device
        self.cfg = ctx.vcfg
        self.traced = False

    # --- set-up -----------------------------------------------------------
    def setup(self) -> None:
        from vlm_bridge_tpu_torch.inference.generate import GenerationConfig
        from vlm_bridge_tpu_torch.models import bridge, gemma2
        from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

        t, seed = self.t, self.ctx.seed
        s = t.get("sampling")
        self.gen = GenerationConfig(
            max_length=t["new_tokens"], greedy=s is None, kv_quant=t["kv_int8"],
            temperature=s["temperature"] if s else 0.7, top_p=s["top_p"] if s else 0.9,
            topk_window=s["topk_window"] if s else 128, mlp_int4=t.get("mlp_int4", False),
            mlp_int4_group=t.get("mlp_int4_group", 128))
        self.gen_greedy = dataclasses.replace(self.gen, greedy=True)
        with torch.no_grad():
            params = weights.make(self.cfg, seed, self.dev, t["bridge_gain"])
            log("weights made")
            parts = tuple(t["quantize"])
            lm_parts = tuple(p for p in parts if p not in ("bridge", "vision"))
            params["lm"] = gemma2.quantize_params(params["lm"], parts=lm_parts)
            if "bridge" in parts:
                params["bridge"] = bridge.quantize_decode_params(params["bridge"])
            self.params = prestack_decode_params(params, self.cfg, self.gen)
        log("weights quantized and stacked")
        if "stacked_decode" not in self.params["lm"]:
            raise RuntimeError("the recipe does not reach the fused stack decode")
        self.pool = traffic.image_pool(seed, t["pool"], t["batch"], self.cfg.image_size,
                                       self.dev)
        self.sgen = torch.Generator(device=self.dev)
        self.sgen.manual_seed(traffic.stream_seed(seed, 4))
        # every shape and kernel this traffic uses, once: both kinds of batch
        kinds = {self.is_greedy(i) for i in range(max(1, t.get("greedy_every") or 1))}
        for greedy in sorted(kinds):
            self._collect(self._issue(0, greedy))
        traffic.sync(self.dev)
        log("warmed up")

    def is_greedy(self, i: int) -> bool:
        every = self.t.get("greedy_every")
        return self.t.get("sampling") is None or (bool(every) and i % every == 0)

    # --- the timed path ---------------------------------------------------
    def _issue(self, i: int, greedy: bool):
        from vlm_bridge_tpu_torch.inference.generate import generate_tokens
        from vlm_bridge_tpu_torch.models import full_model

        t0 = time.perf_counter()
        pix = self.pool[i % self.t["pool"]].to(self.dev, non_blocking=True)
        pixels = traffic.normalize(pix, torch.bfloat16)
        rng = torch.profiler.record_function("encode") if self.traced else contextlib.nullcontext()
        with rng:
            vision = full_model.encode_image(self.params, self.cfg, pixels)
        toks, _ = generate_tokens(self.params, self.cfg, vision_features=vision,
                                  generator=self.sgen,
                                  gen=self.gen_greedy if greedy else self.gen)
        return i, greedy, t0, toks

    @staticmethod
    def _collect(issued):
        i, greedy, t0, toks = issued
        host = toks.cpu()   # the host fence of this batch
        return {"i": i, "greedy": greedy, "t_issue": t0, "t_done": time.perf_counter(),
                "tokens": host}

    def _loop(self, more) -> list:
        """Issue batch i while more(i) holds, each before reading the
        previous one; returns the batches' records in order."""
        done, pending, i = [], None, 0
        while True:
            new = None
            if more(i):
                new = self._issue(i, self.is_greedy(i))
                i += 1
            if pending is not None:
                done.append(self._collect(pending))
            pending = new
            if pending is None:
                return done

    def _targets(self):
        from vlm_bridge_tpu_torch.inference import generate
        from vlm_bridge_tpu_torch.models import gemma2
        from vlm_bridge_tpu_torch.ops import decode_kernels, quant

        return [(decode_kernels, "fused_stack_step", "stack_step"),
                (decode_kernels, "fused_bridge_step", "bridge_step"),
                (quant, "int8_matmul_t_argmax", "head"), (quant, "int4_matmul_t_argmax", "head"),
                (gemma2, "logits_from_hidden", "head"), (generate, "sample_token", "sampler")]

    def window(self, seconds: float, traced: bool, tail: bool = True) -> dict:
        """The timed window: `seconds` of batches. traced: the same window,
        then trace_batches batches under the profiler; the step's share of
        the peak is read from the untraced window, the rest from the trace.
        tail: refuse a window too short for the 90th percentile (the
        readings of portbench.control need none)."""
        res = self._timed(seconds, tail)
        if not traced:
            return res
        n = self.t["trace_batches"]
        self.traced = True
        with tracing.ranges(self._targets()), tracing.profile(self.dev) as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                done = self._loop(lambda i: i < n)
                traffic.sync(self.dev)
        self.traced = False
        self.done = self.done + done
        per_caption = arith.caption_batch_flops(self.cfg, 1, self.t["new_tokens"])
        work = {**self.work(len(done)),
                "flops_per_s": res["e2e"]["captions_per_s"] * per_caption}
        return {"trace": tracing.read(prof, work),
                "attempted": res["attempted"] + n * self.t["batch"],
                "failed": res["failed"] + self._failed(done)}

    def _timed(self, seconds: float, tail: bool) -> dict:
        """`seconds` of batches, untraced. A batch counts in captions_per_s
        by the share of its time that fell inside the window: the batches
        completed in it whole, the one in flight at its close pro rata (its
        share of the time from the previous completion to its own), all over
        the window's seconds."""
        t = self.t
        t_start = time.perf_counter()
        t_end = t_start + seconds
        done = self._loop(lambda i: time.perf_counter() < t_end)
        in_window = [r for r in done if r["t_done"] <= t_end]
        self.done = in_window
        if len(in_window) < (10 if tail else 1):
            raise RuntimeError(f"{len(in_window)} batches completed in the window: too few "
                               "for a percentile")
        lat = [(r["t_done"] - r["t_issue"]) * 1e3 for r in in_window]
        share = 0.0
        if len(done) > len(in_window):
            prev, nxt = in_window[-1]["t_done"], done[len(in_window)]["t_done"]
            share = (t_end - prev) / (nxt - prev)
        e2e = {"captions_per_s": (len(in_window) + share) * t["batch"] / (t_end - t_start),
               "batch_ms_p90": statistics.quantiles(lat, n=10)[8] if len(lat) > 1 else lat[0]}
        return {"e2e": e2e, "attempted": len(done) * t["batch"],
                "failed": self._failed(done), "batches": len(in_window)}

    def _failed(self, done: list) -> int:
        """Rows whose ids are out of the vocabulary or lack BOS."""
        lm = self.cfg.lm
        bad = 0
        for r in done:
            tok = r["tokens"]
            rows = ((tok < 0) | (tok >= lm.vocab_size)).any(dim=1) | (tok[:, 0] != lm.bos_token_id)
            bad += int(rows.sum())
        return bad

    def work(self, batches: int) -> dict:
        """What a traced window of `batches` batches held, from the shapes."""
        t, lm = self.t, self.cfg.lm
        group = t.get("mlp_int4_group") if t.get("mlp_int4") else None
        steps = [(arith.stack_step_bytes(lm, t["batch"], s, bool(t.get("mlp_int4")), group),
                  arith.stack_step_flops(lm, t["batch"], s)) for s in range(t["new_tokens"])]
        bound_s = sum(arith.bound(b, f)["bound_ms"] for b, f in steps) * 1e-3
        return {"batches": batches, "tokens": batches * t["new_tokens"],
                "stack_bound_s": batches * bound_s}

    # --- correctness --------------------------------------------------------
    def free(self) -> None:
        """Drop the program's state, so the reference's peak stays its own."""
        self.params = None
        gc.collect()
        torch.cuda.empty_cache()

    def check(self, control: dict | None = None) -> dict:
        """The compared numbers over a sample of the window's batches drawn
        from the seed: greedy_gap over greedy batches, window_gap over
        sampled ones. With `control` (weight forms, and "fp8": true to round
        every product's operands), the same positions read by the control."""
        from portbench.reference import model

        self.free()
        t, seed = self.t, self.ctx.seed
        rnd = random.Random(traffic.stream_seed(seed, 5))
        picks = []
        for greedy in (True, False):
            pool = [r for r in self.done if r["greedy"] == greedy]
            picks += rnd.sample(pool, min(t["check_batches"], len(pool)))
        c = self.ctx.cfg_file["port"]
        forms = reference_forms(t)
        lin = model.matmul
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        raw = weights.make(self.cfg, seed, self.dev, t["bridge_gain"])
        numbers, ctl, diag = {}, {}, []
        for r in picks:
            name = "greedy_gap" if r["greedy"] else "window_gap"
            sampling = None if r["greedy"] else t["sampling"]
            pix = self.pool[r["i"] % t["pool"]].to(self.dev)
            tok = r["tokens"].to(self.dev)
            valid = ref_check.chosen_positions(tok, self.cfg.lm.eos_token_id)
            ref = ref_check.caption_logits(raw, c, pix, tok, forms=forms, lin=lin)
            gap = ref_check.served_gap(ref, tok, valid, sampling)
            numbers[name] = max(numbers.get(name, 0.0), gap)
            top2 = torch.topk(ref, 2, dim=-1).values
            diag.append({"kind": name, "gap": gap,
                         "distinct_tokens_a_row": float(sum(len(set(row.tolist()))
                                                            for row in r["tokens"][:, 1:])
                                                        / tok.shape[0]),
                         "distinct_rows": len({tuple(row.tolist()) for row in r["tokens"]}),
                         "margin_median": float((top2[..., 0] - top2[..., 1]).median()),
                         "margins_under_0.1": float(((top2[..., 0] - top2[..., 1]) < 0.1)
                                                    .float().mean())})
            if control is not None:
                cforms = {**forms, **control.get("forms", {})}
                clin = model.fp8_matmul if control.get("fp8") else model.matmul
                low = ref_check.caption_logits(raw, c, pix, tok, forms=cforms, lin=clin)
                cg = ref_check.control_gap(ref, low, valid, sampling)
                ctl[name] = max(ctl.get(name, 0.0), cg)
                del low
            del ref
        out = {"numbers": numbers, "checked_batches": len(picks), "served": diag}
        if control is not None:
            out["control"] = ctl
        return out
