"""The fused decode steps' GEMM core alone, the steps it carries, and where a
stack step's time goes, on one GPU; from this checkout or from another one, so
that two versions are timed in one call.

    python3 scripts/decode_gemm_torch.py [--root DIR] [--reps 3]

1. The core alone (ops/decode_kernels.decode_gemm / decode_gemm4, M = 64 rows)
   at the stack's four product shapes (q|k|v, o, gate|up, down of Gemma-2-2B)
   and the bridge's four (q and both o, self q|k|v, fc1, fc2): int8 at every
   shape, int4 in groups of 128 rows and per channel at the stack's. Device
   ms (chip_smoke.time_ms: the mean of 50 calls queued behind a spin kernel,
   each call on another copy of the weights so that none finds them in the
   L2; the median of --reps such means), the worst row error against the
   plain version, the byte bound, and torch.matmul of [64, K] @ [K, N] bf16 at
   the same shape as a yardstick (not the same function). A tree without the
   core's own entry (an earlier one) skips this part.
2. The steps: fused_stack_step with int8 MLP weights, with int4 in groups of
   128 and per channel, and fused_bridge_step, at batch 64 and t = 20 on
   Gemma-2-2B's and Bridge-Lite's full widths (seeded random weights): device
   ms (10 calls a mean), and the host's time for one call: the host clock
   around the call alone (what the host spends issuing it; nothing queued
   ahead) and around the call and a synchronise after it, medians of 20.
3. A torch.profiler breakdown of one int8 stack step and one bridge step:
   the launches a step and a layer (or block), and device ms by part: the
   products by shape (they launch in a fixed order: q|k|v, o, gate|up, down
   a layer; q, cross o, self q|k|v, self o, fc1, fc2 a block), each with the
   stage it carries where the tree runs its stages inside the products (the
   residual norms, GeGLU / GELU; else an earlier tree's separate row, GeGLU
   and GELU kernels), the attention kernels, and memsets.

--root imports vlm_bridge_tpu_torch from DIR (its kernels build into
DIR/build; its stacks are built by its own stack_decode_params, in its own
weight layout), so that a parent's `git archive` and this tree can be timed
in turns, one process each, in one call:

    for r in build/parent . . build/parent; do python3 scripts/decode_gemm_torch.py --root $r; done

Prints the card's name and power limit, then one JSON line.
VBT_NVCC_FLAGS adds compiler flags, as for chip_smoke.py.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ROWS = 64
# (K, N) of each product; int4 only where the stack step runs it (the MLP),
# timed here at all four stack shapes
STACK_SHAPES = {"qkv": (2304, 4096), "o": (2048, 2304), "gate_up": (2304, 18432),
                "down": (9216, 2304)}
BRIDGE_SHAPES = {"bridge_q_o": (2304, 2304), "bridge_qkv": (2304, 6912),
                 "bridge_fc1": (2304, 9216), "bridge_fc2": (9216, 2304)}
STREAM_BYTES = 160e6   # weight copies a timed run cycles through: beyond the 50 MB L2
ROW_TOL = 1e-5         # each output row against its largest value (tests/test_torch_cuda.py)


def load_chip_smoke():
    """chip_smoke.py of this checkout, whatever --root puts first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def row_err(got, want) -> float:
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    return float((diff / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max())


def core(cs, dk, dev, gen, med) -> dict:
    """The GEMM core alone at every product shape."""
    res = {}
    for name, (K, N) in {**STACK_SHAPES, **BRIDGE_SHAPES}.items():
        a2 = dk.split_halves(torch.randn(ROWS, K, generator=gen, device=dev))
        copies = max(2, math.ceil(STREAM_BYTES / (K * N)))
        ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
              for _ in range(copies)]
        scale = torch.rand(N, generator=gen, device=dev) * 1e-3
        y = torch.zeros(ROWS, N, device=dev)
        forms = {"int8": ([dk.to_fragments(w) for w in ws], scale, dk.decode_gemm,
                          dk.decode_gemm_plain)}
        if name in STACK_SHAPES:
            q4 = [dk.to_fragments4((w // 16).clamp(-8, 7)) for w in ws]
            for form, groups in (("int4_g128", K // 128), ("int4_channel", 1)):
                s4 = torch.rand(groups, N, generator=gen, device=dev) * 1e-3 + 1e-4
                forms[form] = (q4, s4, dk.decode_gemm4, dk.decode_gemm4_plain)
        wb = [w.to(torch.bfloat16) for w in ws]
        nb = cs.cycle(wb)
        mm_ms = med(lambda: torch.matmul(a2[0], nb()))
        row = {"K": K, "N": N, "matmul_bf16_ms": mm_ms}
        for form, (wf, sc, fn, plain) in forms.items():
            err = row_err(fn(a2, wf[0], sc), plain(a2, wf[0], sc))
            if not err <= ROW_TOL:
                raise AssertionError(f"{name} {form}: row error {err} above {ROW_TOL}")
            nxt = cs.cycle(wf)
            ms = med(lambda: fn(a2, nxt(), sc, out=y))
            bd = cs.bound(cs.nbytes(wf[0], sc, a2, y), 2.0 * ROWS * K * N)
            rate = cs.nbytes(wf[0]) / ms / 1e9
            print(f"[core] {name} {K}x{N} {form}: {ms:.4f} ms, bound {bd['bound_ms']:.4f} "
                  f"({ms / bd['bound_ms']:.2f}x, {rate:.2f} TB/s of weights), "
                  f"row error {err:.2e}; torch.matmul bf16 {mm_ms:.4f} ms", flush=True)
            row[form] = {"ms": ms, "bound_ms": bd["bound_ms"], "row_err": err}
        res[name] = row
    return res


def step_inputs(cfg, dev, gen, t):
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm = cfg.lm
    cache = gemma2.StackedKVCache.zeros(lm, ROWS, 51, device=dev)
    for c in (cache.k, cache.v):
        c[:, :, :, :t] = torch.randint(-127, 128, c[:, :, :, :t].shape, generator=gen, device=dev,
                                       dtype=torch.int8)
    for c in (cache.k_scale, cache.v_scale):
        c[..., :t] = 0.02 + 0.01 * torch.rand(c[..., :t].shape, generator=gen, device=dev)
    x = (torch.randn(ROWS, lm.hidden_size, generator=gen, device=dev) * 0.02
         * lm.hidden_size ** 0.5).to(torch.bfloat16)
    cos, sin = rope_table(torch.tensor([t], device=dev), lm.head_dim, lm.rope_theta)
    return cache, x, cos[0].contiguous(), sin[0].contiguous()


def host_ms(fn, n=20):
    """Medians over n calls of the host clock around the call alone, and around
    the call and a synchronise after it (nothing queued ahead)."""
    issue, whole = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        issue.append((t1 - t0) * 1e3)
        whole.append((t2 - t0) * 1e3)
    return statistics.median(issue), statistics.median(whole)


def steps(cs, dev, gen, med, t=20) -> tuple:
    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge, gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    cfg = VLMConfig.default()
    lm, bc = cfg.lm, cfg.bridge
    q = gemma2.quantize_params(gemma2.init(lm, generator=gen, device=dev), ("mlp", "attn"))
    cache, x, cos, sin = step_inputs(cfg, dev, gen, t)
    kw = dict(num_heads=lm.num_heads, num_kv_heads=lm.num_kv_heads, head_dim=lm.head_dim,
              attn_scale=lm.attn_scale, softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps)
    res, fns = {}, {}
    for form, mlp4, group in (("stack_int8", False, None), ("stack_int4_g128", True, 128),
                              ("stack_int4_channel", True, None)):
        st = gemma2.stack_decode_params(q, lm, mlp_int4=mlp4, mlp_int4_group=group)
        ck, cp = [c.clone() for c in cache], [c.clone() for c in cache]
        err = cs.check_close(form, dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw),
                             dk.fused_stack_step_plain(t, x, st, *cp, cos, sin, **kw))
        fns[form] = lambda st=st, ck=ck: dk.fused_stack_step(t, x, st, *ck, cos, sin, **kw)
        res[form] = {"max_abs_err": err}
        del cp
    del q
    bp = bridge.quantize_decode_params(bridge.init(bc, generator=gen, device=dev))
    bst = bridge.stack_bridge_decode_params(bp, bc)
    vision = torch.randn(ROWS, cfg.num_vision_tokens, bc.vision_dim, generator=gen,
                         device=dev).to(torch.bfloat16)
    bcache = _build_cross_cache(bp, bc, vision, 51, torch.bfloat16, kv_quant=True)
    cross = (bcache.cross_k, bcache.cross_k_scale, bcache.cross_v, bcache.cross_v_scale)
    xb = (torch.randn(ROWS, bc.language_dim, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    bkw = dict(num_heads_cross=bc.num_heads_cross, num_heads_self=bc.num_heads_self,
               eps=bc.layer_norm_eps)
    sk, sv = bcache.self_k.clone(), bcache.self_v.clone()
    err = cs.check_close("bridge", dk.fused_bridge_step(t, xb, bst, *cross, sk, sv, **bkw),
                         dk.fused_bridge_step_plain(t, xb, bst, *cross, bcache.self_k,
                                                    bcache.self_v, **bkw))
    fns["bridge"] = lambda: dk.fused_bridge_step(t, xb, bst, *cross, sk, sv, **bkw)
    res["bridge"] = {"max_abs_err": err}
    for form, fn in fns.items():
        r = res[form]
        r["ms"] = med(fn, 10)
        issue, whole = host_ms(fn)
        r.update(host_issue_ms=issue, host_call_sync_ms=whole)
        print(f"[step] {form}: device {r['ms']:.4f} ms; host {issue:.4f} ms to issue, "
              f"{whole:.4f} ms with the synchronise; max abs err {r['max_abs_err']:.3g}",
              flush=True)
    return res, fns


# the parts of a step's profile: the products in their launch order (in a tree
# whose products carry their stages, each part holds its stage too), then the
# other kernels by a piece of their names: this tree's first-norm row kernels
# and an earlier tree's stage kernels
STACK_PARTS = (("qkv", "o", "gate_up", "down"),
               {"input_rms": "input RMSNorm (layer 0)", "stack_attn": "attention",
                "residual_rms": "residual norms", "geglu": "GeGLU"})
BRIDGE_PARTS = (("q", "o_cross", "qkv_self", "o_self", "fc1", "fc2"),
                {"input_ln": "input LayerNorm (block 0)", "cross_attn": "cross attention",
                 "self_attn": "self attention", "residual_ln": "residual LayerNorms",
                 "gelu_exact": "GELU"})
# the stage a product carries where the tree runs its norms, GeGLU and GELU
# inside the products (the attentions stay kernels of their own)
STAGES = {"o": "post-attn + pre-FFN norms", "gate_up": "GeGLU",
          "down": "post-FFN + next input norms", "o_cross": "residual LayerNorm",
          "o_self": "residual LayerNorm", "fc1": "GELU", "fc2": "residual LayerNorm"}


def breakdown(name, fn, parts_of, per) -> dict:
    """torch.profiler over one step: device ms by part, launches a step and
    a layer (or block) past the first norm's one; `per` layers or blocks."""
    from torch.profiler import ProfilerActivity, profile

    order, names = parts_of
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not kern:
        print(f"[breakdown {name}] the profiler recorded no device time")
        return {}
    fused = not any(k in e.name for e in kern for k in ("residual_rms", "residual_ln"))
    parts, counts = {}, {}
    n_products = sum("decode_gemm_kernel" in e.name for e in kern)
    seen = 0
    for e in kern:
        if "decode_gemm_kernel" in e.name:
            by_shape = n_products % len(order) == 0
            prod = order[seen % len(order)]
            part = ("product " + prod + (f" + {STAGES[prod]}" if fused and prod in STAGES else "")
                    if by_shape else "products")
            seen += 1
        else:
            part = next((v for k, v in names.items() if k in e.name), None)
            if part is None:
                part = ("memsets" if "emset" in e.name.lower() or "fill" in e.name.lower()
                        else "other: " + e.name[:40])
        parts[part] = parts.get(part, 0.0) + e.time_range.elapsed_us() / 1e3
        counts[part] = counts.get(part, 0) + 1
    span = (kern[-1].time_range.end - kern[0].time_range.start) / 1e3
    busy = sum(parts.values())
    for part in sorted(parts, key=parts.get, reverse=True):
        print(f"[breakdown {name}] {part}: {parts[part]:.4f} ms in {counts[part]} launches")
    print(f"[breakdown {name}] {len(kern)} launches a step, {(len(kern) - 1) / per:.2f} a layer "
          f"or block past the first norm; device busy {busy:.4f} ms of the {span:.4f} ms from "
          f"the first kernel's start to the last one's end (profiler on)")
    return {"parts_ms": parts, "launches": counts, "n_launches": len(kern), "busy_ms": busy,
            "span_ms": span}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_gemm_torch: torch.cuda.is_available() is False; this script runs on a GPU "
              "only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.root.resolve()))
    from vlm_bridge_tpu_torch.configs import VLMConfig
    from vlm_bridge_tpu_torch.ops import cuda_lib
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions run full f32
    cs = load_chip_smoke()
    print(f"card (name, power limit): {cs.card_line()}", flush=True)
    print(f"port from {Path(dk.__file__).resolve().parents[2]}", flush=True)
    cuda_lib.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 13)

    def med(fn, iters=50):
        return statistics.median(cs.time_ms(fn, iters) for _ in range(args.reps))

    out = {}
    with torch.no_grad():
        if hasattr(dk, "decode_gemm"):
            out["core"] = core(cs, dk, dev, gen, med)
        out["steps"], fns = steps(cs, dev, gen, med)
        cfg = VLMConfig.default()
        out["breakdown"] = {"stack_int8": breakdown("stack_int8", fns["stack_int8"],
                                                    STACK_PARTS, cfg.lm.num_layers),
                            "bridge": breakdown("bridge", fns["bridge"], BRIDGE_PARTS,
                                                cfg.bridge.num_blocks)}
    print(json.dumps({"decode_gemm": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
