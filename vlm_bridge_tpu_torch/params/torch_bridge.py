"""Reference `.pth` bridge checkpoints <-> the port's bridge tree (port of
vlm_bridge_tpu.params.torch_bridge).

The reference writes two layouts:

1. trainer checkpoints: {"model_state_dict": {"bridge_module.bridge_blocks.{b}....": tensor}}
   (with optimizer / scheduler / epoch state beside it);
2. FullModel.save_model: {"bridge_module_state_dict": {"bridge_blocks.{b}....": tensor}}.

Both, and a bare state dict, are read; `save_pth` writes layout 2. The
reference's `nn.Linear` stores its weight [out, in] where the port's tree
holds [in, out], and its FFN is nn.Sequential(Linear, GELU, Dropout, Linear,
Dropout), so fc1 / fc2 are `ffn.0` / `ffn.3`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Mapping

import torch

from vlm_bridge_tpu_torch.configs import BridgeConfig

_ATTN = (("w_q", "q"), ("w_k", "k"), ("w_v", "v"), ("w_o", "o"))


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).detach().to("cpu", torch.float32)


def extract_bridge_state_dict(ckpt: Mapping) -> Dict[str, torch.Tensor]:
    """Any reference layout -> flat {"bridge_blocks.{b}....": f32 CPU tensor}."""
    if "bridge_module_state_dict" in ckpt:
        sd = ckpt["bridge_module_state_dict"]
    elif "model_state_dict" in ckpt:
        sd = ckpt["model_state_dict"]
    else:
        sd = ckpt
    out = {k[k.index("bridge_blocks"):]: _f32(v) for k, v in sd.items() if "bridge_blocks" in k}
    if not out:
        raise ValueError("no bridge_blocks.* keys found in checkpoint")
    return out


def bridge_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: BridgeConfig,
                           dtype=torch.float32, device=None) -> dict:
    """Reference state dict -> the port's bridge tree (linear weights
    transposed to [in, out])."""
    def a(name, transpose=False):
        x = _f32(sd[name])
        return (x.T if transpose else x).contiguous().to(device=device, dtype=dtype)

    def attn(prefix):
        out = {}
        for ref, key in _ATTN:
            out[key] = a(prefix + ref + ".weight", True)
            out[key + "_bias"] = a(prefix + ref + ".bias")
        return out

    def ln(name):
        return {"scale": a(name + ".weight"), "bias": a(name + ".bias")}

    blocks = {}
    for b in range(cfg.num_blocks):
        p = f"bridge_blocks.{b}."
        blocks[str(b)] = {
            "cross": attn(p + "cross_attention."), "ln_cross": ln(p + "ln_cross"),
            "self": attn(p + "self_attention."), "ln_self": ln(p + "ln_self"),
            "ffn": {"fc1": a(p + "ffn.0.weight", True), "fc1_bias": a(p + "ffn.0.bias"),
                    "fc2": a(p + "ffn.3.weight", True), "fc2_bias": a(p + "ffn.3.bias")},
            "ln_ffn": ln(p + "ln_ffn"),
        }
    return {"blocks": blocks}


def bridge_to_state_dict(params: dict, cfg: BridgeConfig) -> Dict[str, torch.Tensor]:
    """The port's bridge tree -> the reference's flat state dict (f32, CPU,
    weights [out, in])."""
    out: Dict[str, torch.Tensor] = {}
    for b in range(cfg.num_blocks):
        bp = params["blocks"][str(b)]
        p = f"bridge_blocks.{b}."

        def put_attn(prefix, tree):
            for ref, key in _ATTN:
                out[prefix + ref + ".weight"] = _f32(tree[key]).T.contiguous()
                out[prefix + ref + ".bias"] = _f32(tree[key + "_bias"]).clone()

        def put_ln(name, tree):
            out[name + ".weight"] = _f32(tree["scale"]).clone()
            out[name + ".bias"] = _f32(tree["bias"]).clone()

        put_attn(p + "cross_attention.", bp["cross"])
        put_ln(p + "ln_cross", bp["ln_cross"])
        put_attn(p + "self_attention.", bp["self"])
        put_ln(p + "ln_self", bp["ln_self"])
        out[p + "ffn.0.weight"] = _f32(bp["ffn"]["fc1"]).T.contiguous()
        out[p + "ffn.0.bias"] = _f32(bp["ffn"]["fc1_bias"]).clone()
        out[p + "ffn.3.weight"] = _f32(bp["ffn"]["fc2"]).T.contiguous()
        out[p + "ffn.3.bias"] = _f32(bp["ffn"]["fc2_bias"]).clone()
        put_ln(p + "ln_ffn", bp["ln_ffn"])
    return out


def load_pth(path: str | Path, cfg: BridgeConfig, dtype=torch.float32, device=None) -> dict:
    """Load a reference .pth checkpoint (any of the three layouts). Trainer
    checkpoints pickle more than tensors (optimizer, config), so the file is
    unpickled in full: load only files you trust."""
    ckpt = torch.load(str(path), map_location="cpu", weights_only=False)
    return bridge_from_state_dict(extract_bridge_state_dict(ckpt), cfg, dtype, device)


def save_pth(params: dict, cfg: BridgeConfig, path: str | Path) -> None:
    """Save in the reference's FullModel.save_model layout (weights only)."""
    torch.save({"bridge_module_state_dict": bridge_to_state_dict(params, cfg),
                "model_config": {"bridge_dropout": cfg.dropout}}, str(path))
