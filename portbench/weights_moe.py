"""Seeded weights of a decoder with routed experts (configs.Gemma2MoEConfig),
in the tree the port's models read: the vision tower and the bridge as
portbench.weights makes them; the decoder's dense leaves (table, norms,
attention) drawn as portbench.weights draws them, from the decoder's seed,
without the dense MLP that no layer has; each layer's "mlp" holds "router"
[H, E] f32 and "gate" / "up" [E, H, F], "down" [E, F, H] in bf16, drawn from
a generator of their own, seeded apart from the dense leaves.

Both the program and the reference (portbench.reference.moe) take their
weights from here; the reference draws them again once the window has
closed, and may draw the experts of one layer at a time (`experts`)."""

from __future__ import annotations

import torch

from portbench import weights

EXPERT_STREAM = 7   # the experts' and routers' generator, apart from weights.TOWERS'


def dense_leaves(cfg) -> list:
    """The decoder's leaves of portbench.weights without the dense MLP."""
    return [lf for lf in weights.layout(cfg, "lm") if "mlp" not in lf.path]


def _fill(leaves: list, seed: int, device, dtype=torch.bfloat16, std: float = weights.STD) -> dict:
    """A tree of `leaves` whose random ones are views of one flat buffer
    filled N(0, std) in CHUNK-sized calls of one generator (weights.make_tower's
    way)."""
    rand = [lf for lf in leaves if lf.init == "random"]
    total = sum(weights._numel(lf.shape) for lf in rand)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for a in range(0, total, weights.CHUNK):
        flat[a:a + weights.CHUNK].normal_(0.0, std, generator=gen)
    tree, off = {}, 0
    for lf in leaves:
        n = weights._numel(lf.shape)
        if lf.init == "random":
            t = flat[off:off + n].view(lf.shape)
            off += n
        elif lf.init == "zeros":
            t = torch.zeros(lf.shape, dtype=dtype, device=device)
        else:
            raise ValueError(f"no init {lf.init!r} in the decoder")
        weights._put(tree, lf.path, t)
    return tree


def expert_seed(seed: int, layer: int) -> int:
    """The generator seed of one layer's router and experts."""
    return (int(seed) * 8 + EXPERT_STREAM + 8 * 1_000_003 * (layer + 1)) % (1 << 63)


@torch.no_grad()
def experts(cfg, moe: dict, seed: int, layer: int, device) -> dict:
    """Layer `layer`'s {"router" f32 [H, E], "gate", "up" [E, H, F],
    "down" [E, F, H] bf16}: the experts N(0, 0.02), the router N(0,
    moe["router_std"]), one generator a layer."""
    h, e, f = cfg.lm.hidden_size, moe["num_experts"], moe["moe_intermediate_size"]
    leaves = [weights.Leaf(("gate",), (e, h, f), "random"),
              weights.Leaf(("up",), (e, h, f), "random"),
              weights.Leaf(("down",), (e, f, h), "random")]
    out = _fill(leaves, expert_seed(seed, layer), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(expert_seed(seed, layer) ^ 0x5A5A)
    out["router"] = torch.randn(h, e, generator=gen, device=device) * moe["router_std"]
    return out


@torch.no_grad()
def make_lm(cfg, moe: dict, seed: int, device, with_experts: bool = True) -> dict:
    """The decoder's tree; with_experts False leaves each layer's "mlp" out
    (the reference draws it layer by layer)."""
    tree = _fill(dense_leaves(cfg), weights.tower_seed(seed, "lm"), device)
    if with_experts:
        for i in range(cfg.lm.num_layers):
            tree["layers"][str(i)]["mlp"] = experts(cfg, moe, seed, i, device)
    return tree


def make(cfg, moe: dict, seed: int, device, bridge_gain: float = 1.0,
         with_experts: bool = True) -> dict:
    """The full tree {"vision", "lm", "bridge"} (weights.make's, with the
    decoder above)."""
    return {"vision": weights.make_tower(cfg, "vision", seed, device),
            "lm": make_lm(cfg, moe, seed, device, with_experts),
            "bridge": weights.make_tower(cfg, "bridge", seed, device, bridge_gain)}
