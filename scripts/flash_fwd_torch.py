"""The flash-attention forward alone on one GPU, at the shapes the main path
gives it, beside scaled_dot_product_attention; from this checkout or from
another one, so that two versions of the kernel are timed in one call.

    python3 scripts/flash_fwd_torch.py [--root DIR] [--reps 3]

Shapes: chip_smoke.py's gemma and bridge_self cases (the train step's calls),
vit (B 8) and vit_encode (B 64, q, k and v column views of one fused
projection, as dinov2._attention hands them over). For each: the forward's
device ms (chip_smoke.time_ms: the mean of 50 calls queued behind a spin
kernel; the median of --reps such means), its worst row error against the
plain version, the bound, and SDPA's ms (a mask only where the case has
lengths). --root imports vlm_bridge_tpu_torch from DIR (its kernels build
into DIR/build); where another tree's forward takes contiguous tensors only,
it gets contiguous copies, and the copies' own ms is printed beside (what its
autograd function pays before the kernel). This checkout's forward gets the
views: any error it raises stops the script. Prints the card's name and power limit, then one
JSON line. VBT_NVCC_FLAGS adds compiler flags, as for chip_smoke.py.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
CASES = ("gemma", "bridge_self", "vit", "vit_encode")


def load_chip_smoke():
    """chip_smoke.py of this checkout, whatever --root puts first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_torch: torch.cuda.is_available() is False; this script runs on a GPU "
              "only", file=sys.stderr)
        return 2
    other_tree = args.root.resolve() != REPO
    sys.path.insert(0, str(args.root.resolve()))
    import torch.nn.functional as F

    from vlm_bridge_tpu_torch.ops import cuda_lib
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    cs = load_chip_smoke()
    print(f"card (name, power limit): {cs.card_line()}", flush=True)
    print(f"port from {Path(fa.__file__).resolve().parents[2]}", flush=True)
    cuda_lib.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 5)
    out_line = {}
    with torch.no_grad():
        for case in (c for c in cs.FLASH_CASES if c.name in CASES):
            q, k, v, _, lens = cs.flash_case_inputs(case, dev, gen)
            D = case.D
            kw = dict(scale=D ** -0.5, is_causal=case.causal, logit_softcap=case.cap,
                      sliding_window=case.window)
            copy_ms = None
            try:
                out, lse = fa.flash_attention_fwd(q, k, v, lens, **kw)
                args_kernel = (q, k, v)
            except ValueError as e:   # another tree's forward that takes contiguous tensors only
                if not (other_tree and "contiguous" in str(e)):
                    raise
                args_kernel = tuple(x.contiguous() for x in (q, k, v))
                out, lse = fa.flash_attention_fwd(*args_kernel, lens, **kw)
                copy_ms = statistics.median(
                    cs.time_ms(lambda: [x.contiguous() for x in (q, k, v)], 50)
                    for _ in range(args.reps))
            out_p, _ = fa.flash_attention_plain(q, k, v, lens, **kw)
            failures = []
            cs.row_err(f"flash_attention_fwd out, {case.name}", out, out_p, failures)
            if failures:
                raise AssertionError("; ".join(failures))
            ms = statistics.median(
                cs.time_ms(lambda: fa.flash_attention_fwd(*args_kernel, lens, **kw), 50)
                for _ in range(args.reps))
            pairs = cs.attended_pairs(case, lens)
            bd = cs.bound(cs.nbytes(*args_kernel, lens, out, lse), 4.0 * D * pairs * case.H)
            lib = None
            if case.cap is None:
                qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
                mask = None
                if case.lens is not None:
                    S = case.S
                    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
                lib = statistics.median(
                    cs.time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, scale=D ** -0.5), 50)
                    for _ in range(args.reps))
            print(f"[flash fwd] {case.name}: kernel {ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_ms'] / ms:.0%} of it), SDPA "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}"
                  f"{'' if copy_ms is None else f', copies of q, k, v {copy_ms:.4f} ms'}",
                  flush=True)
            out_line[case.name] = {"ms": ms, **bd, "library_ms": lib, "copy_ms": copy_ms}
    print(json.dumps({"flash_fwd": out_line}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
