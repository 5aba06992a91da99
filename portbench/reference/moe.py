"""The routed decoder in plain float32 torch: the decoder of reference/model.py
(its norms, RoPE and attention, imported) with every layer's MLP replaced by
routed experts as a configuration file's "port.moe" block gives them: router
logits y @ W_r in f32 from the pre-FFN-normed row y, p = softmax over all E,
the top k by p (ties to the lower index), weights p_sel / sum(p_sel) where
norm_topk_prob (else p_sel), and y = sum over the k experts of the weight
times down_e(gelu_tanh(gate_e y) * up_e y). Layer i attends through the
window unless (i + 1) % full_every == 0. The experts are served as `forms`
says for "mlp" (reference.quant.weight, per expert), the router is never
quantized. Imports nothing of the port.

Routing near-ties: where the checked program's routing (`follow`, its
routing log) differs from this one only by experts whose logits lie within
a margin of the k-th largest, this decoder takes the program's experts, as
the check takes the program's served tokens: both are right to within
rounding, and a swapped expert would otherwise move the row's later layers
and positions as far as a fault does.

Each layer's experts come from a callable (layer -> {"router", "gate",
"up", "down"}), so that at published widths one layer's experts are drawn,
used and dropped at a time (the whole decoder in f32 is some 48 GB)."""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from portbench.reference import model, quant


def route(logits: torch.Tensor, k: int, norm: bool, follow: torch.Tensor | None = None,
          margin: float = 0.0) -> tuple:
    """(weights [N, k], experts [N, k]) of router logits [N, E]. follow:
    another routing's weights [N, E] (zero where it does not route): a row
    takes its experts instead where they are k and none lies more than
    `margin` standard deviations of the row's logits below its k-th largest
    logit, i.e. where the two differ only by a near-tie that rounding may
    swap; the weights are this routing's own over the experts taken."""
    p = torch.softmax(logits.float(), dim=-1)
    experts = torch.sort(p, dim=-1, descending=True, stable=True).indices[:, :k]
    if follow is not None:
        on = follow > 0
        kth = logits.gather(-1, experts[:, -1:])
        near = logits >= kth - margin * logits.std(dim=-1, keepdim=True)
        take = (on.sum(-1) == k) & (near | ~on).all(-1)
        theirs = torch.sort(torch.where(on, p, -1.0), dim=-1, descending=True,
                            stable=True).indices[:, :k]
        experts = torch.where(take[:, None], theirs, experts)
    sel = p.gather(-1, experts)
    return (sel / sel.sum(dim=-1, keepdim=True) if norm else sel), experts


def expert_weights(ex: dict, e: int, form) -> tuple:
    """Expert e's (gate, up, down) as the recipe serves them, in f32."""
    return tuple(quant.weight(ex[n][e], form) for n in ("gate", "up", "down"))


def moe_ffn(y: torch.Tensor, ex: dict, moe: dict, form=None, lin=model.matmul,
            record: list | None = None, follow: torch.Tensor | None = None,
            margin: float = 0.0) -> torch.Tensor:
    """The routed feed-forward of rows y [N, H] (follow, margin: `route`'s);
    `record` (a list) gets the rows' weights of every expert, [N, E] (zero
    where a row does not route)."""
    w, idx = route(lin(y, ex["router"].float()), moe["experts_per_token"],
                   moe["norm_topk_prob"], follow, margin)
    if record is not None:
        record.append(torch.zeros(y.shape[0], moe["num_experts"], device=y.device)
                      .scatter_(1, idx, w))
    out = torch.zeros_like(y)
    for e in range(moe["num_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        g, u, d = expert_weights(ex, e, form)
        yr = y[rows]
        h = F.gelu(lin(yr, g), approximate="tanh") * lin(yr, u)
        out.index_add_(0, rows, lin(h, d) * w[rows, slot, None])
    return out


def is_sliding(moe: dict, i: int) -> bool:
    every = moe.get("full_every", 0)
    return (i + 1) % every != 0 if every else i % 2 == 0


def moe_layer(lp: dict, ex: dict, c: dict, moe: dict, i: int, x: torch.Tensor, *, forms: dict,
              kv8: bool = False, lin=model.matmul, record: list | None = None,
              follow: torch.Tensor | None = None, margin: float = 0.0) -> torch.Tensor:
    """One layer over x [B, T, hidden]: reference/model.py's attention
    sublayer, then the routed feed-forward."""
    B, T, _ = x.shape
    eps, d = c["rms_norm_eps"], c["head_dim"]
    nh, kh = c["num_heads"], c["num_kv_heads"]
    a = lp["attn"]
    y = model.rms_norm(x, lp["input_norm"], eps)
    q = lin(y, quant.weight(a["q"], forms.get("attn"))).reshape(B, T, nh, d)
    k = lin(y, quant.weight(a["k"], forms.get("attn"))).reshape(B, T, kh, d)
    v = lin(y, quant.weight(a["v"], forms.get("attn"))).reshape(B, T, kh, d)
    q, k = model.rope(q, c["rope_theta"]), model.rope(k, c["rope_theta"])
    if kv8:
        k, v = quant.kv8(k), quant.kv8(v)
    window = c["sliding_window"] if is_sliding(moe, i) else None
    o = model.attention(q, k, v, scale=c["query_pre_attn_scalar"] ** -0.5, causal=True,
                        softcap=c["attn_logit_softcap"], window=window)
    o = lin(o.reshape(B, T, nh * d), quant.weight(a["o"], forms.get("attn")))
    x = x + model.rms_norm(o, lp["post_attn_norm"], eps)
    y = model.rms_norm(x, lp["pre_ffn_norm"], eps)
    y = moe_ffn(y.reshape(B * T, -1), ex, moe, forms.get("mlp"), lin, record, follow, margin)
    y = y.reshape(B, T, -1)
    return x + model.rms_norm(y, lp["post_ffn_norm"], eps)


def decoder(lm: dict, c: dict, moe: dict, x: torch.Tensor, experts_of: Callable, *,
            forms: dict, kv8: bool = False, lin=model.matmul, record: list | None = None,
            follow: torch.Tensor | None = None, margin: float = 0.0) -> torch.Tensor:
    """Raw embeddings x [B, T, hidden] -> final-normed hidden states;
    experts_of(i): layer i's router and experts; `record` (a list) gets each
    layer's routing weights, [B T, E]; follow [L, B T, E] (with margin):
    each layer's `route` follow."""
    x = x * math.sqrt(c["hidden_size"])
    for i in range(c["num_layers"]):
        ex = experts_of(i)
        x = moe_layer(lm["layers"][str(i)], ex, c, moe, i, x, forms=forms, kv8=kv8, lin=lin,
                      record=record, follow=None if follow is None else follow[i],
                      margin=margin)
        del ex
    return model.rms_norm(x, lm["final_norm"], c["rms_norm_eps"])


@torch.no_grad()
def caption_logits(raw: dict, c: dict, pixels_u8: torch.Tensor, tokens: torch.Tensor,
                   experts_of: Callable, *, forms: dict, lin=model.matmul,
                   record: list | None = None, follow: torch.Tensor | None = None,
                   margin: float = 0.0) -> torch.Tensor:
    """reference.check.caption_logits with the routed decoder: logits
    [B, L, V] of the prompts (pixels, tokens[:, :L]) with the int8 KV and
    cross caches; c: a configuration file's "port" block (with "moe");
    record, follow, margin: `decoder`'s, over the B L rows."""
    from portbench.reference import check

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lm_c, br_c = c["lm"], c["bridge"]
    vision = model.vit(raw["vision"], c["vision"], check._normalize(pixels_u8), c["image_size"])
    tab = model.table(raw["lm"], forms)
    x = model.embed(tab, tokens[:, :-1])
    x = model.bridge(raw["bridge"], br_c, x, vision, form=forms.get("bridge"), cross_kv8=True,
                     causal=True, lin=lin)
    hidden = decoder(raw["lm"], lm_c, c["moe"], x, experts_of, forms=forms, kv8=True, lin=lin,
                     record=record, follow=follow, margin=margin)
    return model.logits(lm_c, tab, hidden, lin=lin)


def mean_gap(ref: torch.Tensor, tokens: torch.Tensor, valid: torch.Tensor) -> tuple:
    """(sum, count) over the chosen positions of how far the served token's
    logit lies below the reference's best (reference.check.served_gap's
    gap, summed instead of its widest): a routing near-tie moves a few
    positions, a fault of the routing moves every one."""
    got = ref.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    gap = torch.clamp(ref.amax(dim=-1) - got, min=0.0)
    return float(torch.where(valid, gap, torch.zeros_like(gap)).sum()), int(valid.sum())


def control_mean_gap(ref: torch.Tensor, ctl: torch.Tensor, valid: torch.Tensor) -> tuple:
    """`mean_gap` of the token the control puts first."""
    pick = ctl.argmax(dim=-1)
    gap = torch.clamp(ref.amax(dim=-1) - ref.gather(-1, pick[..., None])[..., 0], min=0.0)
    return float(torch.where(valid, gap, torch.zeros_like(gap)).sum()), int(valid.sum())
