"""Captioning with a decoder of routed experts: entries/caption.py's closed
loop, traffic and check, over a Gemma2MoEConfig decoder built from the
configuration file's "port.lm" and "port.moe" blocks. The weights are
portbench.weights_moe's, quantized layer by layer as they are drawn (so the
bf16 experts of one layer live at a time) and stacked as the caption entry
serves them; the bounds and model FLOPs are portbench.arith_moe's; the
check holds the served tokens to reference/moe.py (greedy_gap, and its mean
over the checked positions, greedy_gap_mean) and the program's routing to
the reference's (route_gap: each batch's routing log, copied on the device
after its steps, against the reference's weights over the same prompts).
The reference takes the program's experts where the two differ only by a
near-tie (reference.moe.route's follow; traffic key "route_margin", in
standard deviations of a row's router logits);
and the traced window copies the program's routing counter
(decode_kernels.moe_counters: rows routed) and the row slots the products
computed (decode_kernels.moe_slot_rows for each call of the step with
experts) into the trace's work."""

from __future__ import annotations

import random

import torch

from portbench import arith_moe, log, tracing, traffic, weights_moe
from portbench.entries import caption
from portbench.reference import check as ref_check
from portbench.reference import moe as ref_moe


def moe_config(cfg_file: dict):
    """The port's VLMConfig with a Gemma2MoEConfig decoder."""
    from vlm_bridge_tpu_torch.configs import (BridgeConfig, DinoV2Config, Gemma2MoEConfig,
                                              VLMConfig)

    p = cfg_file["port"]
    moe = {k: v for k, v in p["moe"].items() if k != "router_std"}
    return VLMConfig(vision=DinoV2Config(**p["vision"]), lm=Gemma2MoEConfig(**p["lm"], **moe),
                     bridge=BridgeConfig(**p["bridge"]), image_size=p["image_size"])


def counters(reset: bool = False) -> dict:
    """The program's routing counters: the decode session's (the served
    path on the card), else those of the eager calls (the CPU)."""
    from vlm_bridge_tpu_torch.inference import generate
    from vlm_bridge_tpu_torch.ops import decode_kernels

    sessions = list(generate._SESSIONS.values())
    return decode_kernels.moe_counters(sessions[-1].stack if sessions else None, reset=reset)


def route_log():
    """The program's routing log on the device ([S, L, B, E]), the decode
    session's (the card) or the eager calls' (the CPU); None before any."""
    from vlm_bridge_tpu_torch.inference import generate
    from vlm_bridge_tpu_torch.ops import decode_kernels

    sessions = list(generate._SESSIONS.values())
    return decode_kernels.moe_route_log(sessions[-1].stack if sessions else None)


def follow(log: torch.Tensor, B: int, T: int) -> torch.Tensor:
    """A routing log [T, L, B, E] as reference.moe's follow, [L, B T, E]."""
    return log[:T].permute(1, 2, 0, 3).reshape(log.shape[1], B * T, -1)


def route_gap(prog: torch.Tensor, ref: list, valid: torch.Tensor) -> tuple:
    """(sum, count) over the chosen positions and the layers of how far a
    routing's weights lie from the reference's: sum over the experts of
    |w - w_reference| (0 where both route alike, up to 2). prog: [L, B T,
    E] (`follow` of a routing log, or another record); ref: reference.moe's
    record (L tensors [B T, E]); valid: [B, T]."""
    r = torch.stack(ref)
    gap = (prog.to(r.device) - r).abs().sum(-1)
    mask = valid.to(r.device).reshape(1, -1).expand_as(gap)
    return float(gap[mask].sum()), int(mask.sum())


class Cell(caption.Cell):
    def __init__(self, ctx):
        ctx.vcfg = moe_config(ctx.cfg_file)
        super().__init__(ctx)
        self.moe = ctx.cfg_file["port"]["moe"]

    def _issue(self, i: int, greedy: bool):
        """caption.Cell._issue, and a copy of the routing log its steps wrote,
        queued on the device behind them (no host synchronisation)."""
        issued = super()._issue(i, greedy)
        got = route_log()
        return (*issued, None if got is None else got[:self.t["new_tokens"]].clone())

    @staticmethod
    def _collect(issued):
        rec = caption.Cell._collect(issued[:4])
        rec["route"] = issued[4]
        return rec

    def setup(self) -> None:
        from vlm_bridge_tpu_torch.inference.generate import GenerationConfig
        from vlm_bridge_tpu_torch.models import bridge, gemma2
        from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

        t, seed = self.t, self.ctx.seed
        if t.get("sampling") is not None or t.get("mlp_int4"):
            raise ValueError("the routed decoder's cell is greedy, with int8 experts")
        self.gen = GenerationConfig(max_length=t["new_tokens"], greedy=True,
                                    kv_quant=t["kv_int8"])
        self.gen_greedy = self.gen
        parts = tuple(t["quantize"])
        lm_parts = tuple(p for p in parts if p not in ("bridge", "vision"))
        with torch.no_grad():
            params = weights_moe.make(self.cfg, self.moe, seed, self.dev, t["bridge_gain"],
                                      with_experts=False)
            lm = params["lm"]
            for i in range(self.cfg.lm.num_layers):
                lp = lm["layers"][str(i)]
                lp["mlp"] = weights_moe.experts(self.cfg, self.moe, seed, i, self.dev)
                lm["layers"][str(i)] = gemma2.quantize_layer(lp, lm_parts)
            lm["embedding"] = gemma2.quantize_embedding_part(lm["embedding"], lm_parts)
            log("weights made and quantized")
            if "bridge" in parts:
                params["bridge"] = bridge.quantize_decode_params(params["bridge"])
            self.params = prestack_decode_params(params, self.cfg, self.gen)
            del params, lm
        log("weights stacked")
        if "stacked_decode" not in self.params["lm"]:
            raise RuntimeError("the recipe does not reach the fused stack decode")
        self.pool = traffic.image_pool(seed, t["pool"], t["batch"], self.cfg.image_size,
                                       self.dev)
        self.sgen = torch.Generator(device=self.dev)
        self.sgen.manual_seed(traffic.stream_seed(seed, 4))
        self._collect(self._issue(0, True))
        traffic.sync(self.dev)
        log("warmed up")

    def window(self, seconds: float, traced: bool, tail: bool = True) -> dict:
        """caption.Cell.window, with the routed decoder's bounds and model
        FLOPs, and the routing counters of the traced batches."""
        res = self._timed(seconds, tail)
        if not traced:
            return res
        from vlm_bridge_tpu_torch.ops import decode_kernels

        n = self.t["trace_batches"]
        counters(reset=True)
        calls = getattr(decode_kernels.fused_stack_step, "moe_calls", 0)
        self.traced = True
        with tracing.ranges(self._targets()), tracing.profile(self.dev) as prof:
            with torch.profiler.record_function(tracing.WINDOW):
                done = self._loop(lambda i: i < n)
                traffic.sync(self.dev)
        self.traced = False
        self.done = self.done + done
        got = counters()
        per_caption = arith_moe.caption_batch_flops(self.cfg, 1, self.t["new_tokens"])
        work = {**self.work(len(done)),
                "flops_per_s": res["e2e"]["captions_per_s"] * per_caption}
        if got:
            lm = self.cfg.lm
            calls = decode_kernels.fused_stack_step.moe_calls - calls
            work.update(moe_rows=int(got["rows"].sum()),
                        moe_slots=calls * lm.num_layers * lm.num_experts
                        * decode_kernels.moe_slot_rows(self.t["batch"]),
                        moe_rows_max=int(got["rows"].max()), moe_rows_min=int(got["rows"].min()))
        return {"trace": tracing.read(prof, work),
                "attempted": res["attempted"] + n * self.t["batch"],
                "failed": res["failed"] + self._failed(done)}

    def work(self, batches: int) -> dict:
        t = self.t
        return {"batches": batches, "tokens": batches * t["new_tokens"],
                **arith_moe.work(self.cfg.lm, t["batch"], t["new_tokens"], batches)}

    def check(self, control: dict | None = None) -> dict:
        """caption.Cell.check's greedy_gap against reference/moe.py;
        greedy_gap_mean, the gap's mean over all the checked positions; and
        route_gap, `route_gap`'s mean over them and the layers (with
        `control`, the control's readings at the same positions: its routing
        against the reference's for route_gap)."""
        from portbench.reference import model

        self.free()
        t, seed = self.t, self.ctx.seed
        rnd = random.Random(traffic.stream_seed(seed, 5))
        picks = rnd.sample(self.done, min(t["check_batches"], len(self.done)))
        c = self.ctx.cfg_file["port"]
        forms = caption.reference_forms(t)
        raw = weights_moe.make(self.cfg, self.moe, seed, self.dev, t["bridge_gain"],
                               with_experts=False)

        def experts_of(i):
            return weights_moe.experts(self.cfg, self.moe, seed, i, self.dev)

        numbers, ctl, diag = {}, {}, []
        sums = {k: [0.0, 0] for k in ("numbers", "control", "route", "control_route")}

        def add(key, pair):
            sums[key][0] += pair[0]
            sums[key][1] += pair[1]

        for r in picks:
            pix = self.pool[r["i"] % t["pool"]].to(self.dev)
            tok = r["tokens"].to(self.dev)
            valid = ref_check.chosen_positions(tok, self.cfg.lm.eos_token_id)
            B, T = valid.shape
            # a log of other rows than the batch's (a batch the program did not
            # decode whole) routed none of them: it reads the largest gap, 2
            routed, log = [], r.get("route")
            whole = log is not None and log.shape[2] == B
            near = dict(follow=follow(log.to(self.dev), B, T) if whole else None,
                        margin=t["route_margin"])
            ref = ref_moe.caption_logits(raw, c, pix, tok, experts_of, forms=forms,
                                         record=routed, **near)
            gap = ref_check.served_gap(ref, tok, valid, None)
            numbers["greedy_gap"] = max(numbers.get("greedy_gap", 0.0), gap)
            add("numbers", ref_moe.mean_gap(ref, tok, valid))
            if whole:
                add("route", route_gap(near["follow"], routed, valid))
            elif log is not None:
                add("route", (2.0 * int(valid.sum()) * len(routed), int(valid.sum()) * len(routed)))
            top2 = torch.topk(ref, 2, dim=-1).values
            diag.append({"kind": "greedy_gap", "gap": gap,
                         "distinct_tokens_a_row": float(sum(len(set(row.tolist()))
                                                            for row in r["tokens"][:, 1:])
                                                        / tok.shape[0]),
                         "distinct_rows": len({tuple(row.tolist()) for row in r["tokens"]}),
                         "margin_median": float((top2[..., 0] - top2[..., 1]).median())})
            if control is not None:
                cforms = {**forms, **control.get("forms", {})}
                clin = model.fp8_matmul if control.get("fp8") else model.matmul
                low_routed = []
                low = ref_moe.caption_logits(raw, c, pix, tok, experts_of, forms=cforms,
                                             lin=clin, record=low_routed, **near)
                cg = ref_check.control_gap(ref, low, valid, None)
                ctl["greedy_gap"] = max(ctl.get("greedy_gap", 0.0), cg)
                add("control", ref_moe.control_mean_gap(ref, low, valid))
                add("control_route", route_gap(torch.stack(low_routed), routed, valid))
                del low, low_routed
            del ref, routed, near
        for key, out, name in (("numbers", numbers, "greedy_gap_mean"),
                               ("control", ctl, "greedy_gap_mean"),
                               ("route", numbers, "route_gap"),
                               ("control_route", ctl, "route_gap")):
            if sums[key][1]:
                out[name] = sums[key][0] / sums[key][1]
        out = {"numbers": numbers, "checked_batches": len(picks), "served": diag}
        if control is not None:
            out["control"] = ctl
        return out
