"""LayerNorm for large row batches (port of vlm_bridge_tpu.ops.norm_kernels).

`layer_norm_fast(x2, scale, bias, eps)` normalizes the rows of a 2-D [N, H]
tensor with exact two-pass f32 statistics (the mean, then the mean of the
squared deviations) and returns x2's dtype. Its forward launches
csrc/layer_norm.cu on CUDA tensors (bf16 or f32 rows, H a multiple of 8) or
raises, and runs `layer_norm_fast_plain` on CPU tensors. Its
backward is the closed-form LayerNorm gradient in plain tensor code on
either device, as in the JAX package, where only the forward has a kernel.

This is not the one-pass pivot form of ops.layers.layer_norm: the two agree
to f32 rounding, not bit for bit. Dispatch policy lives in
ops.layers.layer_norm (VLM_BRIDGE_LN_KERNEL).
"""

from __future__ import annotations

import torch

from vlm_bridge_tpu_torch.ops import cuda_lib

def layer_norm_fast_plain(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                          eps: float) -> torch.Tensor:
    """Plain version of the forward kernel."""
    xf = x2.float()
    d = xf - xf.mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float() + bias.float()).to(x2.dtype)


def _forward(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    if not x2.is_cuda:
        return layer_norm_fast_plain(x2, scale, bias, eps)
    if x2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"x2: the kernel takes bfloat16 or float32 rows, not {x2.dtype}")
    N, H = x2.shape
    if N < 1 or H < 8 or H % 8:
        raise ValueError(f"layer_norm_fast rows of {H}: H must be a multiple of 8")
    x2 = x2.contiguous()
    scale, bias = scale.float().contiguous(), bias.float().contiguous()
    cuda_lib.check(x2, "x2", x2.dtype, (N, H))
    cuda_lib.check(scale, "scale", torch.float32, (H,))
    cuda_lib.check(bias, "bias", torch.float32, (H,))
    y = torch.empty_like(x2)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_layer_norm", p(x2), p(scale), p(bias), p(y), N, H,
                  int(x2.dtype == torch.float32), float(eps))
    layer_norm_fast.launches += 1
    return y


class _LayerNormFast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        return _forward(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        xf, dyf = x2.float(), dy.float()
        d = xf - xf.mean(dim=-1, keepdim=True)
        r = torch.rsqrt(d.square().mean(dim=-1, keepdim=True) + ctx.eps)
        xhat = d * r
        dscale = (dyf * xhat).sum(dim=0).to(scale.dtype)
        dbias = dyf.sum(dim=0).to(ctx.bias_dtype)
        dg = dyf * scale.float()
        dx = r * (dg - dg.mean(dim=-1, keepdim=True)
                  - xhat * (dg * xhat).mean(dim=-1, keepdim=True))
        return dx.to(x2.dtype), dscale, dbias, None


def layer_norm_fast(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm over the minor dim of a 2-D [N, H] tensor; callers reshape
    [B, T, H] to [B * T, H] first. Differentiable in x2, scale and bias."""
    return _LayerNormFast.apply(x2, scale, bias, eps)


layer_norm_fast.launches = 0
