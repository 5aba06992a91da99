"""Elementwise / normalization primitives (port of vlm_bridge_tpu.ops.layers).

Norms accumulate in float32 and cast back to the input dtype. Linear weights
are stored [in, out] as in the JAX package; an int8 weight is the dict
{"w_int8": int8 [in, out], "scale": f32 [out]} of ops.quant.quantize_int8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ w (+ b). An int8 dict weight is dequantized per output channel
    after an f32 product (the JAX jnp-int8 path's algebra)."""
    if isinstance(w, dict):
        y = (torch.matmul(x.float(), w["w_int8"].float()) * w["scale"]).to(x.dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics, one-pass variance around a per-row
    pivot x[..., 0] (cancels algebraically; removes the |mean| >> std
    cancellation of E[x^2] - E[x]^2)."""
    xf = x.float()
    xs = xf - xf[..., :1]
    mean = xs.mean(dim=-1, keepdim=True)
    mean_sq = xs.square().mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean.square(), min=0.0)
    y = (xs - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma RMSNorm: x / rms(x) * (1 + w), in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return y.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """gelu_pytorch_tanh — the Gemma-2 hidden activation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Erf-based GELU (DINOv2 MLP, bridge FFN)."""
    return torch.nn.functional.gelu(x)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float = 10000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [..., head_dim] for integer positions, concat(freqs, freqs)
    to pair with rotate_half (f32 throughout)."""
    fraction = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** fraction)
    angles = positions.float()[..., None] * inv_freq
    emb = torch.cat([angles, angles], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, T, H, D]; cos/sin: [B, T, D] or [T, D]."""
    if cos.dim() == x.dim() - 1:
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf = x.float()
    return (xf * cos + _rotate_half(xf) * sin).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return torch.tanh(x / cap) * cap
