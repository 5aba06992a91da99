"""The model in plain float32 torch: DINOv2 (pre-LN ViT with LayerScale),
Bridge-Lite (pre-LN cross attention over the vision tokens, self attention,
exact-GELU FFN) and the decoder on the Gemma-2 equations ((1+w) RMSNorm
around each sublayer, RoPE, GQA with a soft-cap of the attention logits and
alternating window layers, GeGLU, embeddings scaled by sqrt(hidden) and tied
to the head, a final soft-cap). Weights are read from the harness's raw
seeded tree and served as `forms` says (reference.quant.weight); `lin`
may round both operands of each product (the fp8 control). Configurations
are plain dicts: a configuration file's "port" block."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from portbench.reference import quant

Lin = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w


def fp8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return quant.fp8(x) @ quant.fp8(w)


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), eps)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * (1.0 + w.float())


def attention(q, k, v, *, scale, causal=False, key_mask=None, softcap=None, window=None):
    """q [B, T, H, D], k/v [B, S, KH, D] (KH divides H) -> [B, T, H, D]."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    k = k.repeat_interleave(H // KH, dim=2)
    v = v.repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    allowed = torch.ones(T, S, dtype=torch.bool, device=q.device)
    qp = torch.arange(T, device=q.device)[:, None] + (S - T)
    kp = torch.arange(S, device=q.device)[None, :]
    if causal:
        allowed = allowed & (kp <= qp)
    if window is not None:
        allowed = allowed & (kp > qp - window)
    allowed = allowed[None, None]
    if key_mask is not None:
        allowed = allowed & key_mask[:, None, None, :].bool()
    s = s.masked_fill(~allowed, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(s, dim=-1), v)


# --- DINOv2 ------------------------------------------------------------------

def _cubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] bicubic resampling (Keys, A = -0.5, half-pixel centres,
    each output's weights renormalized to sum to one)."""
    src = (torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out) - 0.5
    x = (src[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs()
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    w = torch.where(x < 1.0, near, torch.where(x < 2.0, far, torch.zeros_like(x)))
    w = w / w.sum(dim=0, keepdim=True)
    return w.float().to(device)


def vit(p: dict, c: dict, pixels: torch.Tensor, image_size: int) -> torch.Tensor:
    """pixels [B, H, W, 3] normalized -> [B, 1 + N, hidden] features."""
    B = pixels.shape[0]
    P, h, nh = c["patch_size"], c["hidden_size"], c["num_heads"]
    g = image_size // P
    x = pixels.float().reshape(B, g, P, g, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, g * g, P * P * 3) @ p["patch_embed"]["kernel"].float().reshape(-1, h)
    x = x + p["patch_embed"]["bias"].float()
    x = torch.cat([p["cls_token"].float().expand(B, 1, h), x], dim=1)
    pos = p["pos_embed"].float()
    native = int(round((pos.shape[1] - 1) ** 0.5))
    if native != g:
        m = _cubic_matrix(native, g, pixels.device)
        grid = torch.einsum("ijc,ia,jb->abc", pos[0, 1:].reshape(native, native, h), m, m)
        pos = torch.cat([pos[:, :1], grid.reshape(1, g * g, h)], dim=1)
    x = x + pos
    eps = c["layer_norm_eps"]
    for i in range(c["num_layers"]):
        lp = p["layers"][str(i)]
        y = layer_norm(x, lp["norm1"]["scale"], lp["norm1"]["bias"], eps)
        qkv = y @ lp["attn"]["qkv"].float() + lp["attn"]["qkv_bias"].float()
        q, k, v = (t.reshape(B, -1, nh, h // nh) for t in qkv.split(h, dim=-1))
        a = attention(q, k, v, scale=(h // nh) ** -0.5).reshape(B, -1, h)
        x = x + (a @ lp["attn"]["o"].float() + lp["attn"]["o_bias"].float()) \
            * lp["layerscale1"].float()
        y = layer_norm(x, lp["norm2"]["scale"], lp["norm2"]["bias"], eps)
        y = F.gelu(y @ lp["mlp"]["fc1"].float() + lp["mlp"]["fc1_bias"].float())
        x = x + (y @ lp["mlp"]["fc2"].float() + lp["mlp"]["fc2_bias"].float()) \
            * lp["layerscale2"].float()
    return layer_norm(x, p["final_norm"]["scale"], p["final_norm"]["bias"], eps)


# --- Bridge-Lite ---------------------------------------------------------------

def bridge(p: dict, c: dict, x: torch.Tensor, vision: torch.Tensor, *, form=None,
           cross_kv8: bool = False, causal: bool = False, key_mask=None,
           dropout: Optional[torch.Generator] = None, lin: Lin = matmul) -> torch.Tensor:
    """x [B, T, ld] text embeddings, vision [B, S, vd]. form: how q / o /
    self q|k|v / the FFN are served (the cross k / v stay float);
    cross_kv8: the cross K/V held int8 per vector (the serving cache);
    dropout: a generator, drawn in the order cross, self, FFN activation,
    FFN output of each block, as the bridge's training forward draws."""
    ld, eps = c["language_dim"], c["layer_norm_eps"]
    rate = c["dropout"]

    def drop(h):
        if dropout is None or rate == 0.0:
            return h
        keep = torch.rand(h.shape, generator=dropout, device=h.device) >= rate
        return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))

    def proj(h, wp, key, w_form):
        return lin(h, quant.weight(wp[key], w_form)) + wp[key + "_bias"].float()

    B, T, _ = x.shape
    for b in range(c["num_blocks"]):
        bp = p["blocks"][str(b)]
        hc, hs = c["num_heads_cross"], c["num_heads_self"]
        y = layer_norm(x, bp["ln_cross"]["scale"], bp["ln_cross"]["bias"], eps)
        cp = bp["cross"]
        q = proj(y, cp, "q", form).reshape(B, T, hc, ld // hc)
        k = proj(vision, cp, "k", None).reshape(B, -1, hc, ld // hc)
        v = proj(vision, cp, "v", None).reshape(B, -1, hc, ld // hc)
        if cross_kv8:
            k, v = quant.kv8(k), quant.kv8(v)
        a = attention(q, k, v, scale=(ld // hc) ** -0.5).reshape(B, T, ld)
        x = x + drop(proj(a, cp, "o", form))
        y = layer_norm(x, bp["ln_self"]["scale"], bp["ln_self"]["bias"], eps)
        sp = bp["self"]
        q, k, v = (proj(y, sp, n, form).reshape(B, T, hs, ld // hs) for n in ("q", "k", "v"))
        a = attention(q, k, v, scale=(ld // hs) ** -0.5, causal=causal, key_mask=key_mask)
        x = x + drop(proj(a.reshape(B, T, ld), sp, "o", form))
        y = layer_norm(x, bp["ln_ffn"]["scale"], bp["ln_ffn"]["bias"], eps)
        fp = bp["ffn"]
        y = drop(F.gelu(proj(y, fp, "fc1", form)))
        x = x + drop(proj(y, fp, "fc2", form))
    return x


# --- the decoder ---------------------------------------------------------------

def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, T, H, D] at positions 0..T-1, rotate-half pairing."""
    T, D = x.shape[1], x.shape[3]
    inv = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float32, device=x.device)[:, None] * inv
    ang = torch.cat([ang, ang], dim=-1)[None, :, None, :]
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * torch.cos(ang) + rot * torch.sin(ang)


def decoder_layer(lp: dict, c: dict, i: int, x: torch.Tensor, *, forms: dict,
                  kv8: bool = False, key_mask=None, lin: Lin = matmul) -> torch.Tensor:
    """One decoder layer over x [B, T, hidden]."""
    B, T, _ = x.shape
    eps, d = c["rms_norm_eps"], c["head_dim"]
    nh, kh = c["num_heads"], c["num_kv_heads"]
    a = lp["attn"]
    y = rms_norm(x, lp["input_norm"], eps)
    q = lin(y, quant.weight(a["q"], forms.get("attn"))).reshape(B, T, nh, d)
    k = lin(y, quant.weight(a["k"], forms.get("attn"))).reshape(B, T, kh, d)
    v = lin(y, quant.weight(a["v"], forms.get("attn"))).reshape(B, T, kh, d)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    if kv8:
        k, v = quant.kv8(k), quant.kv8(v)
    window = c["sliding_window"] if i % 2 == 0 else None
    o = attention(q, k, v, scale=c["query_pre_attn_scalar"] ** -0.5, causal=True,
                  key_mask=key_mask, softcap=c["attn_logit_softcap"], window=window)
    o = lin(o.reshape(B, T, nh * d), quant.weight(a["o"], forms.get("attn")))
    x = x + rms_norm(o, lp["post_attn_norm"], eps)
    y = rms_norm(x, lp["pre_ffn_norm"], eps)
    m = lp["mlp"]
    gate = lin(y, quant.weight(m["gate"], forms.get("mlp")))
    up = lin(y, quant.weight(m["up"], forms.get("mlp")))
    y = lin(F.gelu(gate, approximate="tanh") * up, quant.weight(m["down"], forms.get("mlp")))
    return x + rms_norm(y, lp["post_ffn_norm"], eps)


def table(lm: dict, forms: dict) -> torch.Tensor:
    """The tied table [V, hidden] as the recipe serves it."""
    f = forms.get("table")
    return quant.weight(lm["embedding"], f, axis=1)


def embed(tab: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Raw rows of the table (the sqrt(hidden) scale comes in `decoder`)."""
    return tab[ids.long()]


def decoder(lm: dict, c: dict, x: torch.Tensor, *, forms: dict, kv8: bool = False,
            key_mask=None, lin: Lin = matmul, remat: bool = False) -> torch.Tensor:
    """Raw embeddings x [B, T, hidden] -> final-normed hidden states.
    remat: recompute each layer in the backward (torch.utils.checkpoint),
    so that only one layer's f32 weights live at a time."""
    x = x * math.sqrt(c["hidden_size"])
    for i in range(c["num_layers"]):
        args = (lm["layers"][str(i)], c, i, x)
        kw = dict(forms=forms, kv8=kv8, key_mask=key_mask, lin=lin)
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(lambda *a: decoder_layer(*a, **kw), *args,
                                                  use_reentrant=False)
        else:
            x = decoder_layer(*args, **kw)
    return rms_norm(x, lm["final_norm"], c["rms_norm_eps"])


def logits(c: dict, tab: torch.Tensor, hidden: torch.Tensor, lin: Lin = matmul) -> torch.Tensor:
    """Tied head and the final soft-cap, f32 [..., V]."""
    y = lin(hidden, tab.T)
    cap = c["final_logit_softcap"]
    return torch.tanh(y / cap) * cap
