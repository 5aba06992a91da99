"""FullModel assembly (port of vlm_bridge_tpu.models.full_model): frozen
DINOv2 + trainable Bridge-Lite + frozen Gemma-2 as one parameter tree.

  vision = DINOv2(pixels)                  # frozen, no gradient
  embeds = Gemma2.embed(input_ids)         # raw, no gradient
  bridged = Bridge(embeds, vision)         # trainable
  hidden = Gemma2.forward_hidden(bridged)  # frozen, gradients flow THROUGH
  loss = shifted CE, chunked over the sequence

The CE loss never holds the full [B, T, vocab] f32 logits: each sequence
chunk is recomputed in the backward (torch.utils.checkpoint), and so is each
decoder layer (`remat_lm`). Frozen tensors carry requires_grad=False, so
autograd computes no weight gradient for them."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from vlm_bridge_tpu_torch.configs import VLMConfig
from vlm_bridge_tpu_torch.models import bridge as bridge_mod
from vlm_bridge_tpu_torch.models import dinov2 as dinov2_mod
from vlm_bridge_tpu_torch.models import gemma2 as gemma2_mod
from vlm_bridge_tpu_torch.runtime.profiling import annotate


def init(cfg: VLMConfig, *, generator: torch.Generator, frozen_dtype=torch.bfloat16,
         bridge_dtype=torch.float32, device=None) -> dict:
    """Random-init the full tree from one seeded generator on `device`."""
    return {
        "vision": dinov2_mod.init(cfg.vision, generator=generator, dtype=frozen_dtype,
                                  device=device),
        "lm": gemma2_mod.init(cfg.lm, generator=generator, dtype=frozen_dtype, device=device),
        "bridge": bridge_mod.init(cfg.bridge, generator=generator, dtype=bridge_dtype,
                                  device=device),
    }


@torch.no_grad()
def encode_image(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor, *,
                 reference_attention: bool = False) -> torch.Tensor:
    """Frozen vision forward. pixel_values: [B, H, W, C] normalized.
    reference_attention: see dinov2.forward."""
    return dinov2_mod.forward(params["vision"], cfg.vision, pixel_values,
                              reference_attention=reference_attention)


# the JAX package's jitted entry; eager here, the same function
encode_image_jit = encode_image


def bridge_text(params: dict, cfg: VLMConfig, input_ids: torch.Tensor,
                vision_features: torch.Tensor, *, attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, train: bool = False,
                bridge_pad_mask: bool = True, bridge_causal: bool = False,
                reference_attention: bool = False) -> torch.Tensor:
    """Embed text and run the bridge. Returns bridged embeddings [B, T, h].
    reference_attention: see bridge.forward."""
    with torch.no_grad():
        embeds = gemma2_mod.embed(params["lm"], input_ids)
    text_mask = attn_mask if (bridge_pad_mask and attn_mask is not None) else None
    return bridge_mod.forward(params["bridge"], cfg.bridge, embeds, vision_features,
                              generator=generator, train=train, text_mask=text_mask,
                              causal=bridge_causal, reference_attention=reference_attention)


def forward(params: dict, cfg: VLMConfig, pixel_values: torch.Tensor, input_ids: torch.Tensor,
            attn_mask: torch.Tensor, *, labels: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None, train: bool = False,
            mask_pad_loss: bool = True, bridge_pad_mask: bool = True,
            bridge_causal: bool = False, remat_lm: bool = True, loss_chunk: int = 128,
            loss_remat: bool = True, return_logits: bool = False,
            loss_denominator: Optional[torch.Tensor] = None):
    """Full forward. With `labels` returns (loss, aux); otherwise logits.

    labels: [B, T] target ids aligned per position (build them with
    `shift_labels`); -100 = ignore. mask_pad_loss is accepted as in the JAX
    package; the masking itself is in the labels. loss_denominator: the
    token count the summed loss is divided by (None: this batch's own); data
    parallelism passes the global batch's, so that the ranks' losses and
    gradients sum to the global batch's."""
    del mask_pad_loss
    with annotate("encode"):
        vision = encode_image(params, cfg, pixel_values)
    bridged = bridge_text(params, cfg, input_ids, vision, attn_mask=attn_mask,
                          generator=generator, train=train, bridge_pad_mask=bridge_pad_mask,
                          bridge_causal=bridge_causal)
    hidden = gemma2_mod.forward_hidden(params["lm"], cfg.lm, bridged, attn_mask=attn_mask,
                                       remat=remat_lm)
    if labels is None or return_logits:
        logits = gemma2_mod.logits_from_hidden(params["lm"], cfg.lm, hidden)
        if labels is None:
            return logits
        return _full_logits_loss(logits, labels, loss_denominator)
    return chunked_ce_loss(params["lm"], cfg.lm, hidden, labels, chunk=loss_chunk,
                           remat=loss_remat, denominator=loss_denominator)


def shift_labels(input_ids: torch.Tensor, attn_mask: torch.Tensor, *,
                 mask_pad: bool = True) -> torch.Tensor:
    """Next-token targets: labels[i] = input_ids[i + 1]; last position
    ignored. mask_pad=True also ignores positions whose target is padding."""
    B = input_ids.shape[0]
    last = torch.full((B, 1), -100, dtype=input_ids.dtype, device=input_ids.device)
    labels = torch.cat([input_ids[:, 1:], last], dim=1)
    if mask_pad:
        target_real = torch.cat([attn_mask[:, 1:], torch.zeros_like(attn_mask[:, :1])], dim=1)
        labels = torch.where(target_real > 0, labels, torch.full_like(labels, -100))
    return labels


def _nll_sum(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of lse - target logit over valid positions, their count)."""
    valid = labels != -100
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - tgt, torch.zeros_like(lse))
    return nll.sum(), valid.sum()


def _full_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                      denominator: Optional[torch.Tensor] = None):
    """CE from materialized logits (tests / tiny models)."""
    total, count = _nll_sum(logits.float(), labels)
    count = torch.clamp(count if denominator is None else denominator, min=1)
    return total / count, {"token_count": count}


def chunked_ce_loss(lm_params: dict, lm_cfg, hidden: torch.Tensor, labels: torch.Tensor, *,
                    chunk: int = 128, remat: bool = True,
                    denominator: Optional[torch.Tensor] = None):
    """Memory-efficient CE: sequence chunks, recomputed logits.

    hidden: [B, T, h]; labels: [B, T] with -100 ignored. With remat=True the
    [B, chunk, V] logits exist only for the moment of a chunk, forward and
    backward (one more logits product in the backward). denominator: the
    count the sum is divided by and reported as token_count (None: this
    batch's valid labels)."""
    T = hidden.shape[1]

    def one_chunk(h_c, y_c):
        return _nll_sum(gemma2_mod.logits_from_hidden(lm_params, lm_cfg, h_c), y_c)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for t0 in range(0, T, chunk):
        h_c, y_c = hidden[:, t0:t0 + chunk], labels[:, t0:t0 + chunk]
        if remat and torch.is_grad_enabled() and h_c.requires_grad:
            s, c = checkpoint(one_chunk, h_c, y_c, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            s, c = one_chunk(h_c, y_c)
        total = total + s
        count = count + c
    count = torch.clamp(count if denominator is None else denominator, min=1)
    return total / count, {"token_count": count}


def trainable_params(params: dict) -> dict:
    """The bridge subtree, the only trainable part."""
    return params["bridge"]


def merge_trainable(params: dict, bridge_params: dict) -> dict:
    out = dict(params)
    out["bridge"] = bridge_params
    return out
