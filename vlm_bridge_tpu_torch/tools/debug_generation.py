"""Generation debugger (port of vlm_bridge_tpu.tools.debug_generation):
per-step logit and embedding forensics, issue detection, a strategy sweep,
the bridge-bypass A/B and a JSON report (reference debug_generation.py:51-402).

    vlm-debug-torch [--image IMG] [--max-length 30] [--report out.json] [model args]

- Each step is exact mode's forward: the fixed [1, L] token buffer re-run in
  full under the `position < t` mask, f32 activations, every attention
  through `_attention_reference` by request (the flash kernels take bf16
  only), as inference/generate.py's exact mode runs.
- The step's statistics are reduced on the device: the true top-5
  probabilities over the whole vocabulary (not a renormalisation over five:
  a flat 256k distribution must read ~4e-6, or the tool hides the failures
  it exists to find), the logits' moments, the NaN / Inf / |logit| > 50
  counts, the norms of the bridged embedding and of the final hidden state
  at position t - 1, and the top-p mass the windowed sampler would drop at
  the trace's T / p (0.7 / 0.9 for greedy traces). They and the next token
  cross to the host as one small tensor, one `.cpu()` a step; the [1, V]
  logits never do.
- The bypass A/B is `bypass_bridge=True` (raw Gemma embeddings).
- Draws come from a torch.Generator on the parameters' device (seeded with
  `seed`), not jax.random keys; greedy traces draw nothing.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from vlm_bridge_tpu_torch.configs import VLMConfig
from vlm_bridge_tpu_torch.inference.generate import generate_tokens
from vlm_bridge_tpu_torch.inference.robust import (DEFAULT_STRATEGIES, decode_captions,
                                                   is_degenerate)
from vlm_bridge_tpu_torch.models import full_model, gemma2
from vlm_bridge_tpu_torch.ops.sampling import sample_token, topp_window_tail_mass


@dataclass
class StepTrace:
    """Host-side record of one decode step (reference debug_generation.py:96-178)."""

    step: int
    token: int
    token_text: str
    top5_ids: List[int]
    top5_probs: List[float]
    logit_mean: float
    logit_std: float
    logit_min: float
    logit_max: float
    nan_count: int
    inf_count: int
    extreme_count: int          # |logit| > 50 (pre-sanitize)
    embed_norm: float           # bridged-embedding L2 norm at position t-1
    hidden_norm: float          # final-hidden L2 norm at position t-1
    topp_tail_mass: float = 0.0  # nucleus mass the topk_window would drop
                                 # at this trace's T/p settings (greedy
                                 # traces fall back to the sweep defaults
                                 # T=0.7/p=0.9)


@dataclass
class DebugReport:
    caption: str
    tokens: List[int]
    issues: List[str] = field(default_factory=list)
    steps: List[StepTrace] = field(default_factory=list)
    strategies: Dict[str, str] = field(default_factory=dict)
    bridge_ab: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(
            {
                "caption": self.caption,
                "tokens": self.tokens,
                "issues": self.issues,
                "steps": [asdict(s) for s in self.steps],
                "strategies": self.strategies,
                "bridge_ab": self.bridge_ab,
            },
            indent=2,
        )


# columns of the packed per-step record
_COLS = ("token", "top5_ids", "top5_probs", "logit_mean", "logit_std", "logit_min", "logit_max",
         "nan_count", "inf_count", "extreme_count", "embed_norm", "hidden_norm",
         "topp_tail_mass")
_WIDTH = {"top5_ids": 5, "top5_probs": 5}


@torch.no_grad()
def _debug_step(params, cfg: VLMConfig, tokens: torch.Tensor, t: int, vision: torch.Tensor,
                generator: Optional[torch.Generator], *, temperature: float, top_p: float,
                greedy: bool, bypass_bridge: bool) -> torch.Tensor:
    """One exact-mode decode step: writes token t into `tokens` ([B, L]
    int32, in place) and returns the step's record, [B, 21] f32 on the
    device (the columns of _COLS; ids and counts are exact in f32)."""
    B, L = tokens.shape
    sampling_trace = not greedy and temperature > 0.0
    tail_t = temperature if sampling_trace else 0.7
    tail_p = top_p if sampling_trace else 0.9
    mask = (torch.arange(L, device=tokens.device)[None, :] < t).int().expand(B, L)
    ids = tokens.long()
    if bypass_bridge:
        bridged = gemma2.embed(params["lm"], ids)
    else:
        bridged = full_model.bridge_text(params, cfg, ids, vision, attn_mask=mask,
                                         bridge_pad_mask=True, reference_attention=True)
    hidden = gemma2.forward_hidden(params["lm"], cfg.lm, bridged.float(), attn_mask=mask,
                                   remat=False, reference_attention=True)
    last_h, last_e = hidden[:, t - 1:t], bridged[:, t - 1:t]
    logits = gemma2.logits_from_hidden(params["lm"], cfg.lm, last_h)[:, 0]

    f = logits.float()
    finite = torch.where(torch.isfinite(f), f, torch.zeros_like(f))
    top5_vals, top5_ids = torch.topk(finite, 5, dim=-1)
    top5_probs = torch.exp(top5_vals - torch.logsumexp(finite, dim=-1, keepdim=True))
    nxt = sample_token(generator, logits, temperature=temperature, top_p=top_p, greedy=greedy)
    tokens[:, t] = nxt
    cols = [nxt.float()[:, None], top5_ids.float(), top5_probs,
            finite.mean(dim=-1, keepdim=True), finite.std(dim=-1, unbiased=False, keepdim=True),
            finite.amin(dim=-1, keepdim=True), finite.amax(dim=-1, keepdim=True),
            torch.isnan(f).sum(dim=-1, keepdim=True).float(),
            torch.isinf(f).sum(dim=-1, keepdim=True).float(),
            (finite.abs() > 50.0).sum(dim=-1, keepdim=True).float(),
            torch.linalg.vector_norm(last_e.float(), dim=-1),
            torch.linalg.vector_norm(last_h.float(), dim=-1),
            topp_window_tail_mass(logits, temperature=tail_t, top_p=tail_p)[:, None]]
    return torch.cat(cols, dim=-1)


def _unpack(row: np.ndarray) -> dict:
    out, at = {}, 0
    for name in _COLS:
        w = _WIDTH.get(name, 1)
        out[name] = row[at:at + w] if w > 1 else row[at]
        at += w
    return out


class GenerationDebugger:
    """Traced single-image generation with per-step forensics
    (reference GenerationDebugger, debug_generation.py:51-235)."""

    def __init__(self, params, cfg: VLMConfig, tokenizer):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = params["lm"]["final_norm"].device

    def _generator(self, generator: Optional[torch.Generator], seed: int = 0):
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        return generator

    def _encode(self, pixel_values) -> torch.Tensor:
        """The first image's vision features, encoded in the pixels' dtype
        through the reference attention as exact mode encodes, then f32."""
        pixel_values = torch.as_tensor(pixel_values, device=self.device)
        if pixel_values.dim() == 3:
            pixel_values = pixel_values[None]
        return full_model.encode_image(self.params, self.cfg, pixel_values[:1],
                                       reference_attention=True).float()

    # -- core trace -------------------------------------------------------

    def debug_generation(self, pixel_values, *, max_length: int = 30, temperature: float = 0.0,
                         top_p: float = 1.0, greedy: bool = True, bypass_bridge: bool = False,
                         generator: Optional[torch.Generator] = None) -> DebugReport:
        """Greedy-by-default traced decode of ONE image with per-step stats."""
        cfg = self.cfg
        generator = self._generator(generator)
        vision = self._encode(pixel_values)
        L = max_length + 1
        tokens = torch.full((1, L), cfg.lm.pad_token_id, dtype=torch.int32, device=self.device)
        tokens[:, 0] = cfg.lm.bos_token_id

        report = DebugReport(caption="", tokens=[])
        for t in range(1, L):
            rec = _debug_step(self.params, cfg, tokens, t, vision, generator,
                              temperature=temperature, top_p=top_p, greedy=greedy,
                              bypass_bridge=bypass_bridge)
            s = _unpack(rec[0].cpu().numpy())   # the step's one host fence
            tok = int(s["token"])
            report.steps.append(StepTrace(
                step=t, token=tok, token_text=self.tokenizer.decode([tok]),
                top5_ids=[int(i) for i in s["top5_ids"]],
                top5_probs=[float(p) for p in s["top5_probs"]],
                logit_mean=float(s["logit_mean"]), logit_std=float(s["logit_std"]),
                logit_min=float(s["logit_min"]), logit_max=float(s["logit_max"]),
                nan_count=int(s["nan_count"]), inf_count=int(s["inf_count"]),
                extreme_count=int(s["extreme_count"]), embed_norm=float(s["embed_norm"]),
                hidden_norm=float(s["hidden_norm"]), topp_tail_mass=float(s["topp_tail_mass"])))
            if tok == cfg.lm.eos_token_id:
                break

        ids = tokens[0].cpu().tolist()[: len(report.steps) + 1]
        report.tokens = ids
        report.caption = self.tokenizer.decode(ids)
        sampling_trace = not greedy and temperature > 0.0
        report.issues = self._detect_issues(
            report.steps, report.caption,
            tail_t=temperature if sampling_trace else 0.7,
            tail_p=top_p if sampling_trace else 0.9,
            tail_defaulted=not sampling_trace)
        return report

    # -- issue detection (reference debug_generation.py:180-235) ----------

    @staticmethod
    def _detect_issues(steps: List[StepTrace], caption: str, tail_t: float = 0.7,
                       tail_p: float = 0.9, tail_defaulted: bool = True) -> List[str]:
        issues: List[str] = []
        for s in steps:
            if s.nan_count:
                issues.append(f"step {s.step}: {s.nan_count} NaN logits")
            if s.inf_count:
                issues.append(f"step {s.step}: {s.inf_count} Inf logits")
            if s.extreme_count:
                issues.append(f"step {s.step}: {s.extreme_count} extreme logits (|x|>50)")
        clipped = [s for s in steps if s.topp_tail_mass > 0.05]
        if clipped:
            worst = max(s.topp_tail_mass for s in clipped)
            issues.append(
                f"topk_window clips the top-p nucleus on {len(clipped)} "
                f"step(s) (worst: {worst:.2f} of p={tail_p:g} unreachable "
                f"at T={tail_t:g}{' — sweep defaults; greedy trace' if tail_defaulted else ''}) "
                f"— use exact_topp for faithful sampling")
        toks = [s.token for s in steps]
        for n in (1, 2, 3):
            if len(toks) >= 4 * n and len(set(toks[-4 * n:])) <= n:
                issues.append(f"repetition: last {4 * n} tokens cycle through <= {n} distinct ids")
                break
        if is_degenerate(caption):
            issues.append("degenerate caption (empty/too short/looping)")
        return issues

    # -- strategy sweep (reference debug_generation.py:237-272) ------------

    def strategy_sweep(self, pixel_values, *, max_length: int = 30,
                       generator: Optional[torch.Generator] = None) -> Dict[str, str]:
        """Each of robust.DEFAULT_STRATEGIES through fast-mode generate_tokens
        on the same features, from one generator advanced strategy after
        strategy; a strategy's exception is its result."""
        generator = self._generator(generator)
        vision = self._encode(pixel_values)
        out: Dict[str, str] = {}
        for name, g in DEFAULT_STRATEGIES:
            gen = dataclasses.replace(g, max_length=max_length)
            try:
                toks, lens = generate_tokens(self.params, self.cfg, vision_features=vision,
                                             generator=generator, gen=gen)
                out[name] = decode_captions(self.tokenizer, toks.cpu().numpy(),
                                            lens.cpu().numpy())[0]
            except Exception as e:  # keep sweeping: a strategy's failure is a result
                out[name] = f"ERROR: {e}"
        return out

    # -- bridge-bypass A/B (reference debug_generation.py:274-325) ---------

    def compare_bridge_bypass(self, pixel_values, *, max_length: int = 30,
                              with_bridge_caption: Optional[str] = None) -> Dict[str, str]:
        """Greedy decode with and without the bridge. If the bypass output is
        fluent but the bridged one is degenerate, the bridge is the culprit.

        with_bridge_caption: reuse an already-traced greedy caption for the
        with-bridge leg (full_report passes its trace's result so the
        per-step decode is not repeated)."""
        out: Dict[str, str] = {}
        if with_bridge_caption is None:
            with_bridge_caption = self.debug_generation(
                pixel_values, max_length=max_length, greedy=True).caption
        out["with_bridge"] = with_bridge_caption
        out["bypass_bridge"] = self.debug_generation(
            pixel_values, max_length=max_length, greedy=True, bypass_bridge=True).caption
        return out

    # -- full report (reference debug_generation.py:389-402) ---------------

    def full_report(self, pixel_values, *, max_length: int = 30,
                    save_path: Optional[str] = None) -> DebugReport:
        report = self.debug_generation(pixel_values, max_length=max_length)
        report.strategies = self.strategy_sweep(pixel_values, max_length=max_length)
        report.bridge_ab = self.compare_bridge_bypass(
            pixel_values, max_length=max_length, with_bridge_caption=report.caption)
        if save_path:
            Path(save_path).write_text(report.to_json())
        return report


def main(argv=None) -> int:
    """`vlm-debug-torch` CLI: trace generation on an image (or synthetic noise)."""
    import argparse

    from vlm_bridge_tpu_torch.tools.loading import add_model_args, load_from_args

    ap = argparse.ArgumentParser(prog="vlm-debug-torch",
                                 description="generation debugger (PyTorch port)")
    ap.add_argument("--image", default=None, help="image path (synthetic if unset)")
    ap.add_argument("--max-length", type=int, default=30)
    ap.add_argument("--report", default="debug_generation_report.json")
    add_model_args(ap)
    args = ap.parse_args(argv)

    cfg, params, tokenizer = load_from_args(args)
    device = params["lm"]["final_norm"].device
    if args.image:
        from PIL import Image

        from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device

        with Image.open(args.image) as img:
            arr = np.array(img.convert("RGB").resize((cfg.image_size, cfg.image_size)))
        pixels = normalize_on_device(torch.from_numpy(arr)[None].to(device))
    else:
        pixels = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)).to(device)

    dbg = GenerationDebugger(params, cfg, tokenizer)
    report = dbg.full_report(pixels, max_length=args.max_length, save_path=args.report)
    print(f"caption: {report.caption!r}")
    print(f"issues: {report.issues or 'none'}")
    for name, cap in report.strategies.items():
        print(f"  [{name}] {cap!r}")
    for name, cap in report.bridge_ab.items():
        print(f"  [{name}] {cap!r}")
    print(f"report written to {args.report}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
