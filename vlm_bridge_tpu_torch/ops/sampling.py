"""Token sampling on the device: greedy / temperature / top-p (port of
vlm_bridge_tpu.ops.sampling).

- NaN logits -> zeros; Inf -> clamp to +/-100 (numerical-failure guards)
- temperature scaling before filtering
- nucleus (top-p) filtering that always keeps the top-1 token
- top-p is computed within the top `topk_window` logits (default 128), which
  covers p <= 0.95 nuclei in practice; `exact_topp=True` sorts the whole
  vocabulary.

Random draws come from an explicit `torch.Generator` on the logits' device.
Its stream is torch's, not jax.random's: the two packages agree on greedy
ids and on the set of tokens a draw can return, not on the draw.
"""

from __future__ import annotations

from typing import Optional

import torch


def sanitize_logits(logits: torch.Tensor) -> torch.Tensor:
    """Per row: a row containing any NaN becomes all-zero (a uniform
    distribution); a row containing any Inf is clamped to [-100, 100].
    Finite rows pass through unchanged."""
    has_nan = torch.isnan(logits).any(dim=-1, keepdim=True)
    logits = torch.where(has_nan, torch.zeros_like(logits), logits)
    has_inf = torch.isinf(logits).any(dim=-1, keepdim=True)
    return torch.where(has_inf, logits.clamp(-100.0, 100.0), logits)


def _categorical(generator: Optional[torch.Generator], logits: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(logits) ([B, K] -> [B] int64); -inf
    entries are never drawn."""
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor, *,
                 temperature: float = 0.7, top_p: Optional[float] = 0.9,
                 greedy: bool = False, topk_window: int = 128,
                 exact_topp: bool = False) -> torch.Tensor:
    """Sample next token ids from [B, V] logits. Returns [B] int32."""
    logits = sanitize_logits(logits.float())
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    if top_p is not None and top_p < 1.0:
        k = logits.shape[-1] if exact_topp else min(topk_window, logits.shape[-1])
        return _topp(generator, logits, top_p, k)
    return _categorical(generator, logits).to(torch.int32)


def topp_window_tail_mass(logits: torch.Tensor, *, temperature: float = 0.7,
                          top_p: float = 0.9, topk_window: int = 128) -> torch.Tensor:
    """Probability mass of the top-p nucleus that the windowed sampler drops:
    [B] f32 max(0, top_p - window_mass), where window_mass is the true
    (full-softmax) probability inside the window. 0 = the window covered the
    nucleus."""
    logits = sanitize_logits(logits.float()) / temperature
    vals, _ = torch.topk(logits, topk_window, dim=-1)
    window_mass = torch.exp(torch.logsumexp(vals, dim=-1) - torch.logsumexp(logits, dim=-1))
    return torch.clamp(top_p - window_mass, min=0.0)


def _topp(generator, logits: torch.Tensor, top_p: float, k: int) -> torch.Tensor:
    """Top-p restricted to the top-k logits (k = V is the exact nucleus):
    kept are the tokens whose PRECEDING cumulative mass is < top_p, and the
    top-1 token always."""
    vals, idx = torch.topk(logits, k, dim=-1)  # descending
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool), cum[:, :-1] < top_p],
                     dim=-1)
    filtered = torch.where(keep, vals, torch.full_like(vals, float("-inf")))
    choice = _categorical(generator, filtered)
    return idx.gather(1, choice[:, None])[:, 0].to(torch.int32)
