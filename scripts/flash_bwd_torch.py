"""The flash-attention backward alone on one GPU, at the shapes the train step
gives it, beside scaled_dot_product_attention's backward; from this checkout or
from another one, so that two versions of the kernels are timed in one call.

    python3 scripts/flash_bwd_torch.py [--root DIR] [--reps 3]

Shapes: chip_smoke.py's gemma and bridge_self cases (the train step's calls:
26 Gemma layers and 2 bridge self-attentions a step). For each: the dq kernel's
and the dk/dv kernel's device ms (chip_smoke.time_ms: the mean of 50 calls
queued behind a spin kernel; the median of --reps such means), the pair's (dq,
whose kernel computes delta, then dk/dv on that delta, as the autograd
function runs them), each one's worst row error against the plain backward and
its bound; at bridge-self (no soft-cap) the ms of SDPA's backward (dq, dk and dv
in one call, with its mask). --root imports vlm_bridge_tpu_torch from DIR (its
kernels build into DIR/build). Another tree's backward may take delta as an
input and contiguous tensors only: it then gets `_delta` (timed inside its
pair, as its autograd function computes it) and contiguous copies (their ms
printed beside). This checkout's kernels are also timed at both shapes with
every row at full length for batches of 1 to 16: a batch whose blocks fit in
one wave gives a block's own latency, and each wave more adds a block's time. Prints the card's name and power limit, then one JSON line.
VBT_NVCC_FLAGS adds compiler flags, as for chip_smoke.py.
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
CASES = ("gemma", "bridge_self")


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
        print("flash_bwd_torch: torch.cuda.is_available() is False; this script runs on a GPU "
              "only", file=sys.stderr)
        return 2
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

    def med(fn):
        return statistics.median(cs.time_ms(fn, 50) for _ in range(args.reps))

    out_line = {}
    with torch.no_grad():
        for case in (c for c in cs.FLASH_CASES if c.name in CASES):
            q, k, v, dout, lens = cs.flash_case_inputs(case, dev, gen)
            D = case.D
            kw = dict(scale=D ** -0.5, is_causal=case.causal, logit_softcap=case.cap,
                      sliding_window=case.window)
            out, lse = fa.flash_attention_plain(q, k, v, lens, **kw)
            want = fa.flash_attention_bwd_plain(q, k, v, lens, out, lse, dout, **kw)
            ins = (q, k, v)
            copy_ms = None
            res = fa.flash_attention_bwd_dq(*ins, lens, out, lse, dout, **kw)
            if isinstance(res, tuple):   # this tree's form: dq and its delta
                def dq_call():
                    return fa.flash_attention_bwd_dq(*ins, lens, out, lse, dout, **kw)

                def pair():
                    _, delta = dq_call()
                    return fa.flash_attention_bwd_dkv(*ins, lens, out, lse, dout, delta=delta,
                                                      **kw)
                dq, delta = res
            else:   # an earlier tree's: delta an input, contiguous tensors
                if not all(x.is_contiguous() for x in ins):
                    copy_ms = med(lambda: [x.contiguous() for x in (q, k, v)])
                ins = tuple(x.contiguous() for x in ins)

                def dq_call():
                    return fa.flash_attention_bwd_dq(*ins, lens, out, lse, dout,
                                                     delta=fa._delta(out, dout), **kw)

                def pair():
                    d = fa._delta(out, dout)
                    fa.flash_attention_bwd_dq(*ins, lens, out, lse, dout, delta=d, **kw)
                    return fa.flash_attention_bwd_dkv(*ins, lens, out, lse, dout, delta=d, **kw)
                dq, delta = dq_call(), fa._delta(out, dout)
            dk, dv = fa.flash_attention_bwd_dkv(*ins, lens, out, lse, dout, delta=delta, **kw)
            failures = []
            for name, got, ref in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
                cs.row_err(f"flash backward {name}, {case.name}", got, ref, failures)
            if failures:
                raise AssertionError("; ".join(failures))
            dq_ms = med(dq_call)
            dkv_ms = med(lambda: fa.flash_attention_bwd_dkv(*ins, lens, out, lse, dout,
                                                            delta=delta, **kw))
            pair_ms = med(pair)
            pairs = cs.attended_pairs(case, lens)
            io = cs.nbytes(q, k, v, dout, lse, lens, delta)
            bd_dq = cs.bound(io + cs.nbytes(out, dq), 6.0 * D * pairs * case.H)
            bd_dkv = cs.bound(io + cs.nbytes(dk, dv), 8.0 * D * pairs * case.H)
            bd_pair = cs.bound(io + cs.nbytes(out, dq, dk, dv), 14.0 * D * pairs * case.H)
            lib = None
            if case.cap is None:
                qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
                mask = (torch.arange(case.S, device=dev)[None, :] < lens[:, None])[:, None, None, :]
                with torch.enable_grad():
                    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=D ** -0.5)
                    lib = med(lambda: torch.autograd.grad(o, (qt, kt, vt), dout.transpose(1, 2),
                                                          retain_graph=True))
            print(f"[flash bwd] {case.name}: dq {dq_ms:.4f} ms (bound {bd_dq['bound_ms']:.4f}), "
                  f"dk/dv {dkv_ms:.4f} ms (bound {bd_dkv['bound_ms']:.4f}), pair with delta "
                  f"{pair_ms:.4f} ms (bound {bd_pair['bound_ms']:.4f}), SDPA backward "
                  f"{'none' if lib is None else f'{lib:.4f} ms'}"
                  f"{'' if copy_ms is None else f', copies of q, k, v {copy_ms:.4f} ms'}",
                  flush=True)
            out_line[case.name] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms, "pair_ms": pair_ms,
                                   "dq_bound_ms": bd_dq["bound_ms"],
                                   "dkv_bound_ms": bd_dkv["bound_ms"],
                                   "pair_bound_ms": bd_pair["bound_ms"],
                                   "library_pair_ms": lib, "copy_ms": copy_ms}
        if args.root.resolve() == REPO:
            out_line["sweep"] = sweep(cs, fa, dev, gen, med)
    print(json.dumps({"flash_bwd": out_line}))
    return 0


def sweep(cs, fa, dev, gen, med) -> dict:
    """dq and dk/dv ms at the two shapes, every row at full length, B = 1 .. 16."""
    res = {}
    for case in (c for c in cs.FLASH_CASES if c.name in CASES):
        D, H, KH, T = case.D, case.H, case.KH, case.T
        kw = dict(scale=D ** -0.5, is_causal=case.causal, logit_softcap=case.cap,
                  sliding_window=case.window)
        for B in (1, 2, 4, 8, 16):
            q, dout = (torch.randn(B, T, H, D, generator=gen, device=dev).to(torch.bfloat16)
                       for _ in range(2))
            k, v = (torch.randn(B, T, KH, D, generator=gen, device=dev).to(torch.bfloat16)
                    for _ in range(2))
            lens = torch.full((B,), T, dtype=torch.int32, device=dev)
            out, lse = fa.flash_attention_fwd(q, k, v, lens, **kw)
            _, delta = fa.flash_attention_bwd_dq(q, k, v, lens, out, lse, dout, **kw)
            dq_ms = med(lambda: fa.flash_attention_bwd_dq(q, k, v, lens, out, lse, dout, **kw))
            dkv_ms = med(lambda: fa.flash_attention_bwd_dkv(q, k, v, lens, out, lse, dout,
                                                            delta=delta, **kw))
            print(f"[flash bwd sweep] {case.name} B{B} (full lengths): dq {dq_ms:.4f} ms, "
                  f"dk/dv {dkv_ms:.4f} ms", flush=True)
            res[f"{case.name}_B{B}"] = {"dq_ms": dq_ms, "dkv_ms": dkv_ms}
    return res


if __name__ == "__main__":
    sys.exit(main())
