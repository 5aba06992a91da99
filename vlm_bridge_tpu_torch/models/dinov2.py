"""DINOv2 ViT encoder (port of vlm_bridge_tpu.models.dinov2).

Patch embedding as reshape + matmul over NHWC pixels, CLS token, position
embeddings bicubically resized to the input grid, then pre-LN transformer
layers with LayerScale and a final LayerNorm; the FFN is the GELU MLP (base,
large) or the SwiGLU FFN (giant). The tower is frozen and has no backward.

Attention goes through ops.attention.dot_product_attention (head dim 64, no
mask: the flash forward kernel on CUDA tensors). With VLM_BRIDGE_VIT_MM=kernel
(or =pallas) the four float projections of each layer run
ops.matmul_kernels.tiled_matmul, and with VLM_BRIDGE_LN_KERNEL set the norms
run ops.norm_kernels.layer_norm_fast (see ops.layers.layer_norm); both are
off by default, as in the JAX package. `quantize_vision_params` (--quantize
vision) turns the layers' projections into int8 dicts, which `linear` sends
to ops.quant.int8_matmul.
"""

from __future__ import annotations

import torch

from vlm_bridge_tpu_torch.configs import DinoV2Config
from vlm_bridge_tpu_torch.ops import matmul_kernels as mk
from vlm_bridge_tpu_torch.ops.attention import dot_product_attention
from vlm_bridge_tpu_torch.ops.layers import gelu_exact, layer_norm, linear
from vlm_bridge_tpu_torch.ops.quant import quantize_int8


def init(cfg: DinoV2Config, *, generator: torch.Generator, dtype=torch.bfloat16,
         device=None) -> dict:
    """Random init with the JAX `init`'s shapes and distributions, drawn from
    `generator` on `device`."""
    h = cfg.hidden_size
    n_pos = cfg.native_grid ** 2 + 1

    def normal(*shape):
        return (torch.randn(*shape, generator=generator, device=device) * 0.02).to(dtype)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def ln():
        return {"scale": torch.ones(h, dtype=dtype, device=device), "bias": zeros(h)}

    def mlp():
        if cfg.use_swiglu_ffn:  # dinov2-giant
            hf = cfg.swiglu_hidden
            return {"win": normal(h, 2 * hf), "win_bias": zeros(2 * hf),
                    "wout": normal(hf, h), "wout_bias": zeros(h)}
        mlp_hidden = h * cfg.mlp_ratio
        return {"fc1": normal(h, mlp_hidden), "fc1_bias": zeros(mlp_hidden),
                "fc2": normal(mlp_hidden, h), "fc2_bias": zeros(h)}

    layers = {}
    for i in range(cfg.num_layers):
        attn = {"qkv": torch.cat([normal(h, h), normal(h, h), normal(h, h)], dim=1),
                "qkv_bias": zeros(3 * h), "o": normal(h, h), "o_bias": zeros(h)}
        layers[str(i)] = {
            "norm1": ln(), "norm2": ln(), "attn": attn, "mlp": mlp(),
            "layerscale1": torch.full((h,), cfg.layerscale_value, dtype=dtype, device=device),
            "layerscale2": torch.full((h,), cfg.layerscale_value, dtype=dtype, device=device),
        }
    return {
        "patch_embed": {"kernel": normal(cfg.patch_size, cfg.patch_size, cfg.num_channels, h),
                        "bias": zeros(h)},
        "cls_token": normal(1, 1, h),
        "pos_embed": normal(1, n_pos, h),
        "final_norm": ln(),
        "layers": layers,
    }


def quantize_vision_params(params: dict) -> dict:
    """Int8 weight-only quantization of the encoder's transformer matmuls
    (`--quantize vision`): each layer's qkv / o / fc1 / fc2 (or SwiGLU win /
    wout) becomes a per-output-channel int8 dict, which `linear` sends to
    ops.quant.int8_matmul (and `_proj` leaves to `linear`). The patch
    embedding, the position and CLS embeddings, the norms, the LayerScales and
    the biases stay in the float dtype."""
    out = {k: v for k, v in params.items() if k != "layers"}
    layers = {}
    for name, lp in params["layers"].items():
        lp = dict(lp)
        attn = dict(lp["attn"])
        attn["qkv"] = quantize_int8(attn["qkv"], axis=0)
        attn["o"] = quantize_int8(attn["o"], axis=0)
        lp["attn"] = attn
        mlp = dict(lp["mlp"])
        for w in ("fc1", "fc2", "win", "wout"):
            if w in mlp:
                mlp[w] = quantize_int8(mlp[w], axis=0)
        lp["mlp"] = mlp
        layers[name] = lp
    out["layers"] = layers
    return out


def _cubic_weight_mat(in_size: int, out_size: int, device=None) -> torch.Tensor:
    """[in, out] resampling matrix of jax.image.resize(method="bicubic",
    antialias=False): Keys cubic with A = -0.5, half-pixel centres, weights
    renormalized per output sample. (torch's bicubic uses A = -0.75.)"""
    scale = out_size / in_size
    inv = 1.0 / scale
    sample = (torch.arange(out_size, dtype=torch.float64) + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float64)[:, None]).abs()
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(torch.float32).to(device)


def interpolate_pos_embed(pos_embed: torch.Tensor, cfg: DinoV2Config, grid: int) -> torch.Tensor:
    """Bicubic resize of the patch position embeddings to a grid x grid
    input, in f32 (the JAX package's jax.image kernel, A = -0.5)."""
    n_pos = pos_embed.shape[1] - 1
    native = int(round(n_pos ** 0.5))
    if native == grid:
        return pos_embed
    h = pos_embed.shape[-1]
    patch = pos_embed[0, 1:].float().reshape(native, native, h)
    w = _cubic_weight_mat(native, grid, device=pos_embed.device)  # [native, grid]
    patch = torch.einsum("ijc,ia,jb->abc", patch, w, w)
    patch = patch.reshape(1, grid * grid, h).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], patch], dim=1)


def _proj(x: torch.Tensor, w, b: torch.Tensor, *, gelu: bool = False) -> torch.Tensor:
    """Encoder projection: [B, T, K] @ [K, N] + bias (+ exact GELU). A float
    weight goes through ops.matmul_kernels.tiled_matmul when
    VLM_BRIDGE_VIT_MM selects it (weight cast to x.dtype, bias passed as
    f32); otherwise, and for an int8 dict, through `linear`."""
    if mk.vit_mm_mode() == "kernel" and not isinstance(w, dict) and x.dim() == 3:
        B, T, K = x.shape
        y = mk.tiled_matmul(x.reshape(B * T, K).contiguous(), w.to(x.dtype).contiguous(),
                            b.float(), gelu=gelu)
        return y.reshape(B, T, -1)
    y = linear(x, w, b)
    return gelu_exact(y) if gelu else y


def _mlp(mp: dict, x: torch.Tensor) -> torch.Tensor:
    """GELU MLP (base / large) or SwiGLU FFN (giant: weights_in -> two halves
    -> silu(x1) * x2 -> weights_out)."""
    if "win" in mp:
        x1, x2 = linear(x, mp["win"], mp["win_bias"]).chunk(2, dim=-1)
        return linear(torch.nn.functional.silu(x1) * x2, mp["wout"], mp["wout_bias"])
    h = _proj(x, mp["fc1"], mp["fc1_bias"], gelu=True)
    return _proj(h, mp["fc2"], mp["fc2_bias"])


def _attention(lp: dict, cfg: DinoV2Config, x: torch.Tensor,
               reference: bool = False) -> torch.Tensor:
    B, T, h = x.shape
    H, D = cfg.num_heads, cfg.head_dim
    qkv = _proj(x, lp["attn"]["qkv"], lp["attn"]["qkv_bias"])
    q, k, v = (qkv[..., :h].reshape(B, T, H, D), qkv[..., h:2 * h].reshape(B, T, H, D),
               qkv[..., 2 * h:].reshape(B, T, H, D))
    out = dot_product_attention(q, k, v, scale=D ** -0.5, reference=reference)
    return _proj(out.reshape(B, T, h), lp["attn"]["o"], lp["attn"]["o_bias"])


def forward(params: dict, cfg: DinoV2Config, pixel_values: torch.Tensor, *,
            reference_attention: bool = False) -> torch.Tensor:
    """pixel_values: [B, H, W, C] (NHWC, normalized) -> [B, 1 + N, hidden].
    reference_attention=True runs attention through `_attention_reference`
    (exact-mode generation asks for it)."""
    B, H_img, W_img, C = pixel_values.shape
    P = cfg.patch_size
    if H_img != W_img or H_img % P != 0:
        raise ValueError(
            f"pixel_values must be square with height/width a multiple of "
            f"patch_size={P}; got {H_img}x{W_img}")
    grid = H_img // P
    patches = pixel_values.reshape(B, grid, P, grid, P, C)
    patches = patches.permute(0, 1, 3, 2, 4, 5).reshape(B, grid * grid, P * P * C)
    kernel = params["patch_embed"]["kernel"].to(pixel_values.dtype)
    x = torch.matmul(patches, kernel.reshape(P * P * C, cfg.hidden_size))
    x = x + params["patch_embed"]["bias"].to(x.dtype)
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    interp_key = f"pos_embed_interp_{grid}"
    pos = (params[interp_key] if interp_key in params
           else interpolate_pos_embed(params["pos_embed"], cfg, grid))
    x = x + pos.to(x.dtype)
    eps = cfg.layer_norm_eps
    for i in range(cfg.num_layers):
        lp = params["layers"][str(i)]
        h = layer_norm(x, lp["norm1"]["scale"], lp["norm1"]["bias"], eps)
        x = x + _attention(lp, cfg, h, reference_attention) * lp["layerscale1"].to(x.dtype)
        h = layer_norm(x, lp["norm2"]["scale"], lp["norm2"]["bias"], eps)
        x = x + _mlp(lp["mlp"], h) * lp["layerscale2"].to(x.dtype)
    return layer_norm(x, params["final_norm"]["scale"], params["final_norm"]["bias"], eps)
