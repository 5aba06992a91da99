"""The comparisons that decide `correct`, computed by the plain reference.

Serving: the reference runs once over each sampled prompt (its image, BOS
and the served tokens, teacher-forced) and reads, at every position whose
token the model chose (up to the row's first EOS), how far the served
token's logit lies below the reference's best (greedy rows), or below the
lowest logit of the reference's own sampling set (sampled rows: the top-p
set inside the top-`topk_window` window at the temperature). A control run
in a lower precision reads, at the same positions, the gap of the token it
would put first (greedy) or of the lowest token it would keep (sampled).

Training: the reference follows the first three steps (loss, bridge
gradients, clip, AdamW with the schedule's rates) from the same weights,
batches and dropout draws."""

from __future__ import annotations

import math
import statistics
from typing import Optional

import torch
import torch.nn.functional as F

from portbench.reference import model


def _normalize(pixels_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor((0.485, 0.456, 0.406), device=pixels_u8.device) * 255.0
    std = torch.tensor((0.229, 0.224, 0.225), device=pixels_u8.device) * 255.0
    return (pixels_u8.float() - mean) / std


def chosen_positions(tokens: torch.Tensor, eos: int) -> torch.Tensor:
    """[B, L] bool: position p predicts served token p + 1, and the model
    chose it (no EOS among tokens 1..p)."""
    served = tokens[:, 1:]
    eos_before = torch.cumsum((served == eos).int(), dim=1) - (served == eos).int()
    return eos_before == 0


@torch.no_grad()
def caption_logits(raw: dict, c: dict, pixels_u8: torch.Tensor, tokens: torch.Tensor, *,
                   forms: dict, lin=model.matmul) -> torch.Tensor:
    """Reference logits [B, L, V] of the prompts (pixels, tokens[:, :L]),
    decoded as the serving recipe `forms` holds the weights, with the int8
    KV and cross caches."""
    lm_c, br_c = c["lm"], c["bridge"]
    vision = model.vit(raw["vision"], c["vision"], _normalize(pixels_u8), c["image_size"])
    tab = model.table(raw["lm"], forms)
    ids = tokens[:, :-1]
    x = model.embed(tab, ids)
    x = model.bridge(raw["bridge"], br_c, x, vision, form=forms.get("bridge"), cross_kv8=True,
                     causal=True, lin=lin)
    hidden = model.decoder(raw["lm"], lm_c, x, forms=forms, kv8=True, lin=lin)
    return model.logits(lm_c, tab, hidden, lin=lin)


def kept_floor(lg: torch.Tensor, temperature: float, top_p: float, k: int):
    """(lowest logit, its token) of the set the sampler keeps: the top-p
    nucleus at `temperature` inside the top-k window, top-1 always kept."""
    vals, idx = torch.topk(lg / temperature, k, dim=-1)
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    keep = torch.cat([torch.ones_like(cum[..., :1], dtype=torch.bool), cum[..., :-1] < top_p],
                     dim=-1)
    last = keep.sum(dim=-1, keepdim=True) - 1
    return vals.gather(-1, last)[..., 0] * temperature, idx.gather(-1, last)[..., 0]


def served_gap(ref: torch.Tensor, tokens: torch.Tensor, valid: torch.Tensor,
               sampling: Optional[dict]) -> float:
    """Widest gap of a served token below the reference's best (greedy) or
    below the reference's kept set's floor (sampling: temperature, top_p,
    topk_window); 0 where the token lies inside."""
    tok = tokens[:, 1:].long()
    got = ref.gather(-1, tok[..., None])[..., 0]
    if sampling is None:
        top = ref.amax(dim=-1)
    else:
        top, _ = kept_floor(ref, sampling["temperature"], sampling["top_p"],
                            sampling["topk_window"])
    gap = torch.clamp(top - got, min=0.0)
    return float(torch.where(valid, gap, torch.zeros_like(gap)).max())


def control_gap(ref: torch.Tensor, ctl: torch.Tensor, valid: torch.Tensor,
                sampling: Optional[dict]) -> float:
    """The same gap for the token the control puts first (greedy), or for
    the lowest token the control would keep (sampling)."""
    if sampling is None:
        top = ref.amax(dim=-1)
        pick = ctl.argmax(dim=-1)
    else:
        args = (sampling["temperature"], sampling["top_p"], sampling["topk_window"])
        top, _ = kept_floor(ref, *args)
        _, pick = kept_floor(ctl, *args)
    got = ref.gather(-1, pick[..., None])[..., 0]
    gap = torch.clamp(top - got, min=0.0)
    return float(torch.where(valid, gap, torch.zeros_like(gap)).max())


# --- training -----------------------------------------------------------------

def leaf_paths(tree: dict, prefix=()) -> list:
    """(path, tensor) of a nested dict, in sorted-key order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaf_paths(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def train_loss(raw: dict, c: dict, bridge_p: dict, batch: dict, dropout: torch.Generator,
               lin=model.matmul) -> torch.Tensor:
    """The bridge's training loss on one batch: the frozen ViT, the bridge
    (non-causal self attention over the real tokens, dropout), the frozen
    decoder under the pad mask, the tied head and the soft-cap, then the
    next-token cross entropy over the positions whose target is real."""
    lm_c = c["lm"]
    with torch.no_grad():
        vision = model.vit(raw["vision"], c["vision"], _normalize(batch["pixel_values"]),
                           c["image_size"])
    ids, mask = batch["input_ids"], batch["attn_mask"]
    tab = raw["lm"]["embedding"].float()
    x = model.embed(tab, ids)
    x = model.bridge(bridge_p, c["bridge"], x, vision, key_mask=mask, dropout=dropout, lin=lin)
    hidden = model.decoder(raw["lm"], lm_c, x, forms={}, key_mask=mask, lin=lin, remat=True)
    labels = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1).long()
    real = torch.cat([mask[:, 1:], torch.zeros_like(mask[:, :1])], dim=1) > 0
    total = torch.zeros((), device=ids.device)
    for t0 in range(0, ids.shape[1], 64):
        lg = model.logits(lm_c, tab, hidden[:, t0:t0 + 64], lin=lin)
        nll = F.cross_entropy(lg.flatten(0, 1), labels[:, t0:t0 + 64].flatten(),
                              reduction="none")
        total = total + torch.where(real[:, t0:t0 + 64].flatten(), nll,
                                    torch.zeros_like(nll)).sum()
    return total / real.sum()


def train_reference(raw: dict, c: dict, batches: list, dropout: torch.Generator, opt: dict,
                    lin=model.matmul) -> dict:
    """Follow len(batches) steps: per step the loss, the gradients, the
    global-norm clip, AdamW (decoupled decay, bias-corrected moments) at
    opt["lrs"][step]. Returns the losses, each leaf's clipped first gradient
    (and its norm), raw first gradient norm and change norm after the last
    step."""
    leaves = leaf_paths(raw["bridge"])
    params = [p.detach().float().clone().requires_grad_(True) for _, p in leaves]
    start = [p.detach().clone() for p in params]
    tree = {}
    for (path, _), p in zip(leaves, params):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = p
    b1, b2, eps, wd = opt["beta1"], opt["beta2"], opt["eps"], opt["weight_decay"]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    losses, first, first_raw, first_vec = [], None, None, None
    for step, batch in enumerate(batches):
        loss = train_loss(raw, c, tree, batch, dropout, lin=lin)
        grads = torch.autograd.grad(loss, params)
        losses.append(float(loss.detach()))
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g)
                                                     for g in grads]))
        scale = 1.0 if float(norm) < opt["clip"] else opt["clip"] / float(norm)
        grads = [g * scale for g in grads]
        if step == 0:
            first_vec = [g.detach().clone() for g in grads]
            first = [float(torch.linalg.vector_norm(g)) for g in grads]
            first_raw = [x / scale for x in first]
        lr = opt["lrs"][step]
        with torch.no_grad():
            t = step + 1
            for p, g, mi, vi in zip(params, grads, m, v):
                p.mul_(1.0 - lr * wd)
                mi.mul_(b1).add_(g, alpha=1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = vi.sqrt() / math.sqrt(1.0 - b2 ** t) + eps
                p.addcdiv_(mi, denom, value=-lr / (1.0 - b1 ** t))
        del loss, grads
    change = [float(torch.linalg.vector_norm(p.detach() - s)) for p, s in zip(params, start)]
    return {"paths": [p for p, _ in leaves], "losses": losses, "grad": first,
            "grad_raw": first_raw, "grad_vec": first_vec, "change": change}


def worst_leaf(got: list, want: list, keep: Optional[list] = None) -> float:
    """The worst leaf's gap between two norms, against the larger of the
    reference's norm of that leaf and of the median leaf."""
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = statistics.median(want[i] for i in idx)
    return max(abs(got[i] - want[i]) / max(want[i], med) for i in idx)


def moving_leaves(grad_raw: list, share: float = 1e-3) -> list:
    """Leaves whose reference gradient is above `share` of the median
    leaf's: the others (a key's bias under softmax) move by round-off
    alone under Adam."""
    med = statistics.median(grad_raw)
    return [g > share * med for g in grad_raw]


def leaf_errors(got: list, want: list) -> list:
    """Each leaf's norm of the difference of two gradients over the
    reference's norm of that leaf."""
    return [float(torch.linalg.vector_norm(g.float() - w))
            / max(float(torch.linalg.vector_norm(w)), 1e-30) for g, w in zip(got, want)]


def worst_leaf_error(got: list, want: list) -> float:
    """The worst leaf's norm of the difference of two gradients, against
    the larger of the reference's norm of that leaf and of the median leaf."""
    norms = [float(torch.linalg.vector_norm(w)) for w in want]
    med = statistics.median(norms)
    return max(float(torch.linalg.vector_norm(g.float() - w)) / max(n, med)
               for g, w, n in zip(got, want, norms))


def train_numbers(prog: dict, ref: dict) -> dict:
    """The compared numbers of a training cell from the program's readings
    (losses, first gradients and their norms, change norms, in the
    reference's leaf order) and the reference's."""
    keep = moving_leaves(ref["grad_raw"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": worst_leaf(prog["grad"], ref["grad"]),
        "grad_err": worst_leaf_error(prog["grad_vec"], ref["grad_vec"]),
        "change_gap": worst_leaf(prog["change"], ref["change"], keep),
    }
