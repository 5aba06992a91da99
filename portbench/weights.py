"""Seeded weights, made on the device in a few large calls, in the tree the
port's models read (the layout of `full_model.init`: bf16 frozen towers,
f32 bridge; N(0, 0.02) projections and tables, zero biases, LayerNorms at
one and zero, Gemma norms at zero; the bridge's weights Xavier-uniform,
scaled by the cell's `bridge_gain`).

Each tower is drawn from a generator of its own, seeded from the run's seed,
into one flat buffer whose views are the leaves: the benchmark hands the
same tree to the port, and the reference draws it again, tower by tower,
once the window has closed.

Why a gain: untrained, at the full Xavier bound, the bridge adds a vision
term some 30 times the token embeddings it is added to, and the decoder's
output hardly depends on anything else; smaller, the captions depend on the
image and the tokens so far, and the check sees more faults (PERF.md
gives the sweep: 0.4 for serving, 0.1 for training).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TOWERS = ("vision", "lm", "bridge")
CHUNK = 1 << 30          # elements a fill call draws
STD = 0.02


class Leaf(NamedTuple):
    path: tuple
    shape: tuple
    init: str            # "random" | "zeros" | "ones" | "const"
    value: float = 0.0   # the constant, or the Xavier bound of a "random" bridge leaf


def _vision(cfg) -> list:
    v = cfg.vision
    h, f = v.hidden_size, v.hidden_size * v.mlp_ratio
    n_pos = v.native_grid ** 2 + 1
    out = [Leaf(("patch_embed", "kernel"), (v.patch_size, v.patch_size, v.num_channels, h),
                "random"),
           Leaf(("patch_embed", "bias"), (h,), "zeros"),
           Leaf(("cls_token",), (1, 1, h), "random"),
           Leaf(("pos_embed",), (1, n_pos, h), "random"),
           Leaf(("final_norm", "scale"), (h,), "ones"),
           Leaf(("final_norm", "bias"), (h,), "zeros")]
    for i in range(v.num_layers):
        p = ("layers", str(i))
        out += [Leaf(p + (n, k), (h,), init) for n in ("norm1", "norm2")
                for k, init in (("scale", "ones"), ("bias", "zeros"))]
        out += [Leaf(p + ("attn", "qkv"), (h, 3 * h), "random"),
                Leaf(p + ("attn", "qkv_bias"), (3 * h,), "zeros"),
                Leaf(p + ("attn", "o"), (h, h), "random"),
                Leaf(p + ("attn", "o_bias"), (h,), "zeros"),
                Leaf(p + ("mlp", "fc1"), (h, f), "random"),
                Leaf(p + ("mlp", "fc1_bias"), (f,), "zeros"),
                Leaf(p + ("mlp", "fc2"), (f, h), "random"),
                Leaf(p + ("mlp", "fc2_bias"), (h,), "zeros"),
                Leaf(p + ("layerscale1",), (h,), "const", v.layerscale_value),
                Leaf(p + ("layerscale2",), (h,), "const", v.layerscale_value)]
    return out


def _lm(cfg) -> list:
    m = cfg.lm
    h, d = m.hidden_size, m.head_dim
    out = [Leaf(("embedding",), (m.vocab_size, h), "random"),
           Leaf(("final_norm",), (h,), "zeros")]
    for i in range(m.num_layers):
        p = ("layers", str(i))
        out += [Leaf(p + (k,), (h,), "zeros")
                for k in ("input_norm", "post_attn_norm", "pre_ffn_norm", "post_ffn_norm")]
        out += [Leaf(p + ("attn", "q"), (h, m.num_heads * d), "random"),
                Leaf(p + ("attn", "k"), (h, m.num_kv_heads * d), "random"),
                Leaf(p + ("attn", "v"), (h, m.num_kv_heads * d), "random"),
                Leaf(p + ("attn", "o"), (m.num_heads * d, h), "random"),
                Leaf(p + ("mlp", "gate"), (h, m.intermediate_size), "random"),
                Leaf(p + ("mlp", "up"), (h, m.intermediate_size), "random"),
                Leaf(p + ("mlp", "down"), (m.intermediate_size, h), "random")]
    return out


def _bridge(cfg, gain: float = 1.0) -> list:
    b = cfg.bridge
    ld, vd, f = b.language_dim, b.vision_dim, b.language_dim * b.ffn_mult

    def xavier(path, fan_in, fan_out):
        return Leaf(path, (fan_in, fan_out), "random", gain * (6.0 / (fan_in + fan_out)) ** 0.5)

    out = []
    for i in range(b.num_blocks):
        p = ("blocks", str(i))
        for part, kv in (("cross", vd), ("self", ld)):
            out += [xavier(p + (part, "q"), ld, ld), Leaf(p + (part, "q_bias"), (ld,), "zeros"),
                    xavier(p + (part, "k"), kv, ld), Leaf(p + (part, "k_bias"), (ld,), "zeros"),
                    xavier(p + (part, "v"), kv, ld), Leaf(p + (part, "v_bias"), (ld,), "zeros"),
                    xavier(p + (part, "o"), ld, ld), Leaf(p + (part, "o_bias"), (ld,), "zeros")]
        out += [xavier(p + ("ffn", "fc1"), ld, f), Leaf(p + ("ffn", "fc1_bias"), (f,), "zeros"),
                xavier(p + ("ffn", "fc2"), f, ld), Leaf(p + ("ffn", "fc2_bias"), (ld,), "zeros")]
        for ln in ("ln_cross", "ln_self", "ln_ffn"):
            out += [Leaf(p + (ln, "scale"), (ld,), "ones"), Leaf(p + (ln, "bias"), (ld,), "zeros")]
    return out


DTYPES = {"vision": torch.bfloat16, "lm": torch.bfloat16, "bridge": torch.float32}


def layout(cfg, tower: str, bridge_gain: float = 1.0) -> list:
    if tower == "bridge":
        return _bridge(cfg, bridge_gain)
    return _vision(cfg) if tower == "vision" else _lm(cfg)


def tower_seed(seed: int, tower: str) -> int:
    """The generator seed of one tower: distinct for every (seed, tower)."""
    return (int(seed) * 8 + 1 + TOWERS.index(tower)) % (1 << 63)


def _put(tree: dict, path: tuple, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


@torch.no_grad()
def make_tower(cfg, tower: str, seed: int, device, bridge_gain: float = 1.0) -> dict:
    """One tower's tree. The random leaves are views of one flat buffer
    filled by a few calls of one generator on `device` (normal for the
    towers, uniform scaled by each leaf's Xavier bound for the bridge)."""
    leaves = layout(cfg, tower, bridge_gain)
    dtype = DTYPES[tower]
    rand = [lf for lf in leaves if lf.init == "random"]
    total = sum(_numel(lf.shape) for lf in rand)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(tower_seed(seed, tower))
    for a in range(0, total, CHUNK):
        part = flat[a:a + CHUNK]
        if tower == "bridge":
            part.uniform_(-1.0, 1.0, generator=gen)
        else:
            part.normal_(0.0, STD, generator=gen)
    tree, off = {}, 0
    for lf in leaves:
        n = _numel(lf.shape)
        if lf.init == "random":
            t = flat[off:off + n].view(lf.shape)
            off += n
            if tower == "bridge":
                t.mul_(lf.value)
        elif lf.init == "zeros":
            t = torch.zeros(lf.shape, dtype=dtype, device=device)
        elif lf.init == "ones":
            t = torch.ones(lf.shape, dtype=dtype, device=device)
        else:
            t = torch.full(lf.shape, lf.value, dtype=dtype, device=device)
        _put(tree, lf.path, t)
    return tree


def make(cfg, seed: int, device, bridge_gain: float = 1.0) -> dict:
    """The full tree {"vision", "lm", "bridge"}; bridge_gain scales the
    bridge's Xavier bound."""
    return {tower: make_tower(cfg, tower, seed, device, bridge_gain) for tower in TOWERS}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
