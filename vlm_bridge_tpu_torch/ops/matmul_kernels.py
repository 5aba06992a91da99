"""Tiled bf16 matmul with a fused bias / GELU epilogue for the ViT's
projections (port of vlm_bridge_tpu.ops.matmul_kernels).

`tiled_matmul(a, b, bias, gelu=..., out_dtype=...)` computes
[M, K] @ [K, N] (+ bias [N]) (+ erf GELU) with f32 accumulation: the bias
(f32) is added to the f32 sum, the GELU sees that f32 value, and the result
is rounded once, to `out_dtype` (default a.dtype). On CUDA tensors it
launches csrc/tiled_matmul.cu, a persistent wgmma + TMA kernel (a and b
bf16, bias f32, out bf16 or f32; K and N multiples of 8, since the TMA's
row strides are 16-byte units) or raises; on CPU
tensors it runs `tiled_matmul_plain`, which mirrors the kernel's arithmetic
and is therefore not `linear` + `gelu_exact` (those round the product to
bf16 before the bias and again before the GELU). One kernel serves both of
the JAX module's pallas_call sites: a null bias is the bias-free one.

`models.dinov2._proj` sends the encoder's projections here when
`vit_mm_mode()` says so. The default stays `torch.matmul` through `linear`:
the JAX package gates this dispatch by measurement, and so does the port
(`chip_smoke.py` and `scripts/vit_ab_torch.py` time both).

The JAX module's `block_m` / `block_n` arguments and its `DEFAULT_BLOCK_M/N`
are Mosaic's tiling and have no counterpart: the kernel's tile is a
constant of the source.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vlm_bridge_tpu_torch.ops import cuda_lib


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                       gelu: bool = False, out_dtype=None) -> torch.Tensor:
    """Plain version of `tiled_matmul`: f32 product, f32 bias, erf GELU on
    the f32 value, one rounding."""
    y = a.float() @ b.float()
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = torch.nn.functional.gelu(y)
    return y.to(out_dtype or a.dtype)


def tiled_matmul(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor] = None, *,
                 gelu: bool = False, out_dtype=None) -> torch.Tensor:
    """[M, K] @ [K, N] (+ bias [N]) (+ exact GELU) -> [M, N] in `out_dtype`
    (default a.dtype). CPU tensors take the plain version; CUDA tensors
    launch the kernel (a, b bf16; bias f32; bf16 or f32 out) or raise."""
    if not a.is_cuda:
        return tiled_matmul_plain(a, b, bias, gelu=gelu, out_dtype=out_dtype)
    M, K = a.shape
    N = b.shape[1]
    out_dtype = out_dtype or a.dtype
    cuda_lib.check(a, "a", torch.bfloat16, (M, K))
    cuda_lib.check(b, "b", torch.bfloat16, (K, N))
    if bias is not None:
        cuda_lib.check(bias, "bias", torch.float32, (N,))
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel writes bfloat16 or float32, not {out_dtype}")
    if M < 1 or K < 8 or N < 8 or K % 8 or N % 8:
        raise ValueError(f"tiled_matmul {M}x{K} @ {K}x{N}: K and N must be multiples of 8 (the "
                         "kernel's TMA row strides are 16-byte units; it pads nothing)")
    out = torch.empty(M, N, dtype=out_dtype, device=a.device)
    p = cuda_lib.ptr
    cuda_lib.call("vbt_tiled_matmul", p(a), p(b), None if bias is None else p(bias), p(out),
                  M, K, N, int(gelu), int(out_dtype == torch.float32))
    tiled_matmul.launches += 1
    tiled_matmul.bias_launches += bias is not None
    return out


tiled_matmul.launches = 0        # every launch
tiled_matmul.bias_launches = 0   # those with a bias (the JAX module's _mm_bias_kernel site)


def vit_mm_mode() -> str:
    """'kernel' | 'matmul': dispatch of the encoder's projections, read from
    VLM_BRIDGE_VIT_MM at call time. 'kernel' selects `tiled_matmul`, and so
    does 'pallas', the JAX package's word for it, so that one shell drives
    both packages alike; anything else, and the default, is torch.matmul."""
    mode = os.environ.get("VLM_BRIDGE_VIT_MM", "matmul")
    return "kernel" if mode in ("kernel", "pallas") else "matmul"
