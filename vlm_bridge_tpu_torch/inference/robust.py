"""Multi-strategy robust caption generation (port of
vlm_bridge_tpu.inference.robust).

Run a list of named sampling strategies over the same image, collect every
result (or the error string), and pick the first non-degenerate caption. The
vision features are encoded once and every strategy reuses them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlm_bridge_tpu_torch.configs import VLMConfig
from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
from vlm_bridge_tpu_torch.models import full_model

# (name, GenerationConfig): conservative first; generate_caption_robust picks
# the first non-degenerate caption.
DEFAULT_STRATEGIES: Tuple[Tuple[str, GenerationConfig], ...] = (
    ("conservative", GenerationConfig(temperature=0.7, top_p=0.9)),
    ("greedy", GenerationConfig(greedy=True)),
    ("low_temp", GenerationConfig(temperature=0.3, top_p=0.95)),
    ("medium_temp", GenerationConfig(temperature=0.5, top_p=0.9)),
    ("high_temp", GenerationConfig(temperature=1.0, top_p=0.85)),
)


def decode_captions(tokenizer, tokens: np.ndarray, lengths: np.ndarray) -> List[str]:
    """Detokenize [B, L] id buffers up to each row's length (the tokenizer
    strips BOS/EOS/pad)."""
    return [tokenizer.decode([int(t) for t in row[: int(n)]])
            for row, n in zip(np.asarray(tokens), np.asarray(lengths))]


def is_degenerate(caption: str, *, min_words: int = 2, max_repeat: int = 4) -> bool:
    """Heuristic filter for failed generations: empty/too-short output or a
    single token looping."""
    words = caption.split()
    if len(words) < min_words:
        return True
    for i in range(len(words) - max_repeat + 1):
        if len(set(words[i: i + max_repeat])) == 1:
            return True
    return False


def generate_caption_robust(params, cfg: VLMConfig, pixel_values: torch.Tensor, tokenizer, *,
                            strategies: Sequence[Tuple[str, GenerationConfig]] = DEFAULT_STRATEGIES,
                            generator: Optional[torch.Generator] = None,
                            max_length: int = 50,
                            activation_dtype=None) -> Dict[str, object]:
    """Try each strategy; return all results + the first healthy caption.

    Returns {"results": {name: caption-or-error}, "chosen": name|None,
    "caption": str}. Every strategy result is kept so callers can inspect
    what failed and how. generator: the sampling stream, on the inputs'
    device, advanced strategy after strategy (None: one seeded with 0)."""
    if activation_dtype is None:
        activation_dtype = torch.bfloat16
    with torch.no_grad():
        vision = full_model.encode_image(params, cfg, pixel_values)
    if generator is None:
        generator = torch.Generator(device=vision.device)
        generator.manual_seed(0)

    results: Dict[str, str] = {}
    chosen = None
    caption = ""
    for name, gen in strategies:
        gen = dataclasses.replace(gen, max_length=max_length)
        try:
            toks, lens = generate_tokens(params, cfg, vision_features=vision,
                                         generator=generator, gen=gen,
                                         activation_dtype=activation_dtype)
            text = decode_captions(tokenizer, toks.cpu().numpy(), lens.cpu().numpy())[0]
            results[name] = text
            if chosen is None and not is_degenerate(text):
                chosen = name
                caption = text
        except Exception as e:  # keep sweeping: a strategy's failure is a result
            results[name] = f"ERROR: {e}"
    if chosen is None:
        # fall back to the longest non-error result
        candidates = [(n, c) for n, c in results.items() if not c.startswith("ERROR:")]
        if candidates:
            chosen, caption = max(candidates, key=lambda nc: len(nc[1]))
    return {"results": results, "chosen": chosen, "caption": caption}
