"""Bridge-Lite adapter, serving slice (port of vlm_bridge_tpu.models.bridge).

Ported: Xavier `init`, the int8 serving transformation
`quantize_decode_params`, `supports_fused_decode` and the block stacking for
ops.decode_kernels.fused_bridge_step (in this port's own layout). The
training forward is not ported yet.
"""

from __future__ import annotations

import torch

from vlm_bridge_tpu.configs import BridgeConfig
from vlm_bridge_tpu_torch.ops.decode_kernels import to_fragments
from vlm_bridge_tpu_torch.ops.quant import is_quantized, quantize_int8


def init(cfg: BridgeConfig, *, generator: torch.Generator, dtype=torch.float32,
         device=None) -> dict:
    """Xavier-uniform weights, zero biases, LayerNorm ones/zeros (the JAX
    `init`'s shapes and distributions), drawn from `generator` on `device`."""
    ld, vd = cfg.language_dim, cfg.vision_dim
    ffn = ld * cfg.ffn_mult

    def xavier(fan_in, fan_out):
        bound = (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand(fan_in, fan_out, generator=generator, device=device)
        return (u * (2 * bound) - bound).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones(ld, dtype=dtype, device=device), "bias": zeros(ld)}

    def attn(kv_dim):
        return {"q": xavier(ld, ld), "q_bias": zeros(ld), "k": xavier(kv_dim, ld),
                "k_bias": zeros(ld), "v": xavier(kv_dim, ld), "v_bias": zeros(ld),
                "o": xavier(ld, ld), "o_bias": zeros(ld)}

    blocks = {}
    for b in range(cfg.num_blocks):
        blocks[str(b)] = {
            "cross": attn(vd), "ln_cross": ln(),
            "self": attn(ld), "ln_self": ln(),
            "ffn": {"fc1": xavier(ld, ffn), "fc1_bias": zeros(ffn),
                    "fc2": xavier(ffn, ld), "fc2_bias": zeros(ld)},
            "ln_ffn": ln(),
        }
    return {"blocks": blocks}


def quantize_decode_params(params: dict) -> dict:
    """Int8 weight-only bridge for serving: cross q/o, fused self q|k|v, self
    o and the FFN become int8 dicts; cross k/v stay float (they run once per
    generation, for the cross cache); biases f32; LayerNorms unchanged."""
    f32 = lambda w: w.float()  # noqa: E731
    blocks = {}
    for name, bp in params["blocks"].items():
        qkv = torch.cat([f32(bp["self"]["q"]), f32(bp["self"]["k"]), f32(bp["self"]["v"])], dim=1)
        blocks[name] = {
            "cross": {
                "q": quantize_int8(bp["cross"]["q"], axis=0), "q_bias": f32(bp["cross"]["q_bias"]),
                "k": bp["cross"]["k"], "k_bias": bp["cross"]["k_bias"],
                "v": bp["cross"]["v"], "v_bias": bp["cross"]["v_bias"],
                "o": quantize_int8(bp["cross"]["o"], axis=0), "o_bias": f32(bp["cross"]["o_bias"]),
            },
            "self": {
                "qkv": quantize_int8(qkv, axis=0),
                "q_bias": f32(bp["self"]["q_bias"]), "k_bias": f32(bp["self"]["k_bias"]),
                "v_bias": f32(bp["self"]["v_bias"]),
                "o": quantize_int8(bp["self"]["o"], axis=0), "o_bias": f32(bp["self"]["o_bias"]),
            },
            "ffn": {
                "fc1": quantize_int8(bp["ffn"]["fc1"], axis=0),
                "fc1_bias": f32(bp["ffn"]["fc1_bias"]),
                "fc2": quantize_int8(bp["ffn"]["fc2"], axis=0),
                "fc2_bias": f32(bp["ffn"]["fc2_bias"]),
            },
            "ln_cross": bp["ln_cross"], "ln_self": bp["ln_self"], "ln_ffn": bp["ln_ffn"],
        }
    return {"blocks": blocks}


def supports_fused_decode(params: dict) -> bool:
    """True when every projection the fused bridge step streams is int8."""
    for bp in params["blocks"].values():
        if not (is_quantized(bp["cross"].get("q")) and is_quantized(bp["cross"].get("o"))
                and is_quantized(bp["self"].get("qkv")) and is_quantized(bp["self"].get("o"))
                and is_quantized(bp["ffn"].get("fc1")) and is_quantized(bp["ffn"].get("fc2"))):
            return False
    return True


def stack_bridge_decode_params(params: dict, cfg: BridgeConfig) -> dict:
    """Block-stack the int8 bridge weights for fused_bridge_step: whole
    [in, out] weights per block (no head-major split) in fragment order
    (ops.decode_kernels.to_fragments), f32 scales/biases."""
    bps = [params["blocks"][str(b)] for b in range(cfg.num_blocks)]

    def stk(get):
        return torch.stack([get(bp) for bp in bps]).contiguous()

    out = {"lns": stk(lambda bp: torch.stack([
        bp["ln_cross"]["scale"], bp["ln_cross"]["bias"],
        bp["ln_self"]["scale"], bp["ln_self"]["bias"],
        bp["ln_ffn"]["scale"], bp["ln_ffn"]["bias"]]).float())}
    # (stacked weight, scale/bias prefix, sub-dict, weight key, bias getter)
    table = (
        ("wq", "q", "cross", "q", lambda bp: bp["cross"]["q_bias"]),
        ("wo_c", "o_c", "cross", "o", lambda bp: bp["cross"]["o_bias"]),
        ("wqkv", "qkv", "self", "qkv", lambda bp: torch.cat(
            [bp["self"]["q_bias"], bp["self"]["k_bias"], bp["self"]["v_bias"]])),
        ("wo_s", "o_s", "self", "o", lambda bp: bp["self"]["o_bias"]),
        ("fc1", "fc1", "ffn", "fc1", lambda bp: bp["ffn"]["fc1_bias"]),
        ("fc2", "fc2", "ffn", "fc2", lambda bp: bp["ffn"]["fc2_bias"]),
    )
    for wname, prefix, sub, key, bias in table:
        out[wname] = stk(lambda bp: to_fragments(bp[sub][key]["w_int8"]))
        out[f"{prefix}_scale"] = stk(lambda bp: bp[sub][key]["scale"].float())
        out[f"{prefix}_bias"] = stk(lambda bp: bias(bp).float())
    return out
