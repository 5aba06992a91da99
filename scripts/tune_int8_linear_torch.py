"""Sweep the int8 linear kernels' contraction split on one GPU.

    python3 scripts/tune_int8_linear_torch.py
    VBT_NVCC_FLAGS="-DI8L_KC=32 -DI8L_STAGES=4" python3 scripts/tune_int8_linear_torch.py

For each (blocks per SM, most slices) pair of ops.quant's split plan it
prints the slices chosen and the device time of int8_matmul at Gemma-2-2B's
fused qkv and o shapes and of int8_mlp, at 64 rows of bf16, walking through
eight seeded weight sets so that no call finds its weights in the L2. The
pipeline's depth (rows per stage, stages) is a compile-time choice of
csrc/int8_linear.cu: run the script once per VBT_NVCC_FLAGS value, each in a
process of its own. The timer and the card line are chip_smoke.py's.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

ROWS, HIDDEN, QKV, ATTN, FFN, SETS, ITERS = 64, 2304, 4096, 2048, 9216, 8, 48
PLANS = ((1, 4), (1, 8), (2, 8), (2, 16), (4, 16), (4, 32), (8, 32))


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_int8_linear_torch: this script runs on a GPU only", file=sys.stderr)
        return 2
    from vlm_bridge_tpu_torch.ops import quant

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    flags = os.environ.get("VBT_NVCC_FLAGS", "") or "defaults"
    print(f"card (name, power limit): {cs.card_line()}; nvcc flags: {flags}")

    def weights(i, o):
        return [quant.quantize_int8(torch.randn(i, o, generator=gen, device=dev) * 0.02, axis=0)
                for _ in range(SETS)]

    def x_of(width):
        return torch.randn(ROWS, width, generator=gen, device=dev).to(torch.bfloat16)

    qkv, o = weights(HIDDEN, QKV), weights(ATTN, HIDDEN)
    mlps = list(zip(weights(HIDDEN, FFN), weights(HIDDEN, FFN), weights(FFN, HIDDEN)))
    x, xo = x_of(HIDDEN), x_of(ATTN)
    sms = quant._sms(dev)
    for per_sm, most in PLANS:
        quant._BLOCKS_PER_SM, quant._MAX_SPLITS = per_sm, most
        nq, no, nm = cs.cycle(qkv), cs.cycle(o), cs.cycle(mlps)
        t_qkv = cs.time_ms(lambda: quant.int8_matmul(x, nq()), ITERS)
        t_o = cs.time_ms(lambda: quant.int8_matmul(xo, no()), ITERS)
        t_mlp = cs.time_ms(lambda: quant.int8_mlp(x, *nm()), ITERS)
        slices = [quant._splits(ROWS, n, k, dual=d, sms=sms)
                  for n, k, d in ((QKV, HIDDEN, False), (HIDDEN, ATTN, False),
                                  (FFN, HIDDEN, True), (HIDDEN, FFN, False))]
        print(f"blocks/SM {per_sm}, most slices {most}: slices qkv/o/gate|up/down {slices}; "
              f"int8_matmul qkv {t_qkv * 1e3:.1f} us, o {t_o * 1e3:.1f} us, "
              f"int8_mlp {t_mlp * 1e3:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
