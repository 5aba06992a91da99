"""The linear kernels of csrc/int8_linear.cu alone on one GPU (ops/quant.
int8_matmul, int8_mlp, int8_ffn, int4_mlp) and the per-layer decode steps
(csrc/layer_step.cu, on the decode GEMM core since its redesign; on this
product before), from this checkout and from another one in turns.

    python3 scripts/int8_linear_torch.py [--root DIR]

Shapes: at M = 64 rows (the decode batch) Gemma-2-2B's fused qkv (2304 x
4096), o (2048 x 2304), the bridge's fused self qkv (2304 x 6912), int8_mlp
(H 2304, F 9216) and int4_mlp (the same MLP, block_f 512, per channel and in
groups of 128; both MLPs also at M = 1), int8_ffn (2304, 9216),
fused_attn_step (t = 20) and
fused_mlp_step, and the stack step (fused_stack_step, 26 layers, t = 20) whose
row kernels this checkout changed; at M = 16448 (64 images x 257 tokens) the
int8 vision tower's four projections (qkv 1024 x 3072, o 1024 x 1024, fc1
1024 x 4096, fc2 4096 x 1024). Seeded random int8 weights made on the card;
the decode shapes walk through weight sets larger than the 50 MB L2 together,
so no call finds its weights there. For each: device ms (chip_smoke.time_ms,
the median of REPS means), the byte or operation bound (chip_smoke.bound:
inputs read and outputs written once over 3.35 TB/s, or 2 M N K over 989
TFLOP/s, whichever is larger), the wrapper's host microseconds a call (the
host clock over CALLS calls issued back to back, the card behind), and for
int8_matmul a bf16 torch.matmul on a dequantized copy made beforehand,
labelled as not the same function. The per-layer steps read their weights in
fragment order where the port has it (decode_kernels.layer_fragments, made
once beforehand; a port without it reads the int8 dicts as they are), and get
a torch.profiler breakdown of CALLS_PROFILED calls queued behind a spin:
device us a call of each kernel by its place in the call (the norm, each
product with its stage, the attention), the span a call and the gaps (span
less busy). Then what ptxas reported for the product kernels (registers,
spills).

--root DIR times DIR's port as well: the script runs itself once a port, in
the order DIR, this checkout, this checkout, DIR, each in a process of its
own (the two ports are one package name), and prints both ports' medians.
A port's kernels build into its own build/ directory. Prints the card's name
and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
M_DECODE, M_TOWER = 64, 64 * 257
DECODE_MM = {"gemma_qkv": (2304, 4096), "gemma_o": (2048, 2304), "bridge_self_qkv": (2304, 6912)}
TOWER_MM = {"qkv": (1024, 3072), "o": (1024, 1024), "fc1": (1024, 4096), "fc2": (4096, 1024)}
H, F = 2304, 9216
REPS, CALLS, CALLS_PROFILED = 3, 200, 20
KERNEL_TAGS = ("i8mm_kernel", "i4l_product", "i8l_epilogue", "ls_rms", "ls_residual",
               "residual_rms", "decode_gemm_kernel", "layer_attn_kernel", "ls_attn_kernel")
INT4_BLOCK_F, INT4_GROUP = 512, 128


def load_chip_smoke():
    """chip_smoke.py of this checkout, whatever --only puts first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(build_log: str) -> dict:
    """Registers and spills ptxas reported for each int8 product kernel."""
    out, log = {}, build_log.splitlines()
    for i, line in enumerate(log):
        tag = next((t for t in KERNEL_TAGS if t in line), None)
        if "Compiling entry function" in line and tag:
            mangled = line.split("'")[1]
            name = mangled[mangled.index(tag):].split("Ev")[0].split("EPK")[0]
            out[name] = " ".join(x.strip() for x in log[i + 1:i + 4]
                                 if "bytes" in x or "registers" in x)
    return out


def host_us(fn) -> float:
    """Host microseconds a call: CALLS calls issued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / CALLS * 1e6


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template arguments and signature."""
    m = re.search(r"(\w*kernel\w*)", name)
    return m.group(1) if m else name[:40]


def breakdown(fn) -> dict:
    """Device us a call of each kernel of fn() by its place in the call, the
    span a call and the gaps, from torch.profiler over CALLS_PROFILED calls
    queued behind a ~10 ms spin (so that the host's issuing stays out)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(CALLS_PROFILED):
            fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)[1:]   # the spin first
    if not ev:
        return {"parts_us": {}, "note": "the profiler recorded no device time"}
    # by place in the call where every call launched the same kernels, else by name
    per = len(ev) // CALLS_PROFILED if len(ev) % CALLS_PROFILED == 0 else None
    parts = {}
    for i, e in enumerate(ev):
        key = f"{i % per} {short_name(e.name)}" if per else short_name(e.name)
        parts[key] = parts.get(key, 0.0) + (e.time_range.end - e.time_range.start) / CALLS_PROFILED
    span = (ev[-1].time_range.end - ev[0].time_range.start) / CALLS_PROFILED
    busy = sum(parts.values())
    return {"kernels_a_call": per or len(ev) / CALLS_PROFILED, "span_us": span, "busy_us": busy, "gaps_us": span - busy,
            "parts_us": parts}


def one_port(root: Path) -> dict:
    """Times this process's port (imported from root)."""
    sys.path.insert(0, str(root.resolve()))
    from vlm_bridge_tpu_torch.ops import cuda_lib, quant
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    cs = load_chip_smoke()
    print(f"port from {Path(quant.__file__).resolve().parents[2]}", flush=True)
    cuda_lib.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 19)
    res = {"ptxas": ptxas_lines(cuda_lib.build_log)}

    def wq(k, n):
        return {"w_int8": torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                                        dtype=torch.int8),
                "scale": torch.rand(n, generator=gen, device=dev) * 1e-3 + 1e-4}

    def x_of(m, k):
        return torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)

    def sets(make, nbytes_one):   # enough weight sets to exceed the L2 twice over
        return [make() for _ in range(max(2, -(-100_000_000 // nbytes_one)))]

    def record(name, fn, plain, args0, nxt, bd, extra=None):
        got = fn(*args0)
        torch.cuda.synchronize()
        cs.rows_close(f"{name}", got if not isinstance(got, tuple) else got[0],
                      plain(*args0) if not isinstance(got, tuple) else plain(*args0)[0],
                      cs.LAYER_TOL if name.startswith("fused") else cs.I8_TOL)
        ms = statistics.median(cs.time_ms(lambda: fn(*nxt()), 20) for _ in range(REPS))
        us = host_us(lambda: fn(*nxt()))
        res[name] = {"ms": ms, **bd, "host_us": us, **(extra or {})}
        print(f"[{name}] {ms:.4f} ms, bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} "
              f"({ms / bd['bound_ms']:.2f}x); host {us:.1f} us a call"
              + "".join(f"; {k} {v:.4f}" for k, v in (extra or {}).items()), flush=True)
        if name.startswith("fused"):
            res[name]["breakdown"] = bdn = breakdown(lambda: fn(*nxt()))
            print(f"[{name} breakdown] " + "; ".join(
                f"{k} {v:.2f} us" for k, v in bdn["parts_us"].items())
                + (f"; span {bdn['span_us']:.2f} us a call, gaps {bdn['gaps_us']:.2f} us, "
                   f"{bdn['kernels_a_call']} kernels a call" if "span_us" in bdn else ""),
                flush=True)

    def wq4(k, n, group, packing):   # random nibbles, as quantize_int4 lays them out
        return {"w_int4": torch.randint(-128, 128, (k // 2, n), generator=gen, device=dev,
                                        dtype=torch.int8),
                "scale": torch.rand((n,) if group is None else (k // group, n), generator=gen,
                                    device=dev) * 1e-3 + 1e-4,
                "packing": packing, "group_size": group}

    with torch.no_grad():
        for M in (M_DECODE, 1):
            x = x_of(M, H)
            mlps = sets(lambda: (wq(H, F), wq(H, F), wq(F, H)), 3 * H * F)
            bd = cs.bound(sum(cs.nbytes(*q.values()) for q in mlps[0]) + 2 * cs.nbytes(x),
                          2.0 * M * 3 * H * F)
            record(f"int8_mlp M{M}", quant.int8_mlp, quant.int8_mlp_plain, (x, *mlps[0]),
                   cs.cycle([(x, *m) for m in mlps]), bd)
            for sname, group in (("per_channel", None), (f"group{INT4_GROUP}", INT4_GROUP)):
                ws = sets(lambda: (wq4(H, F, group, "global"), wq4(H, F, group, "global"),
                                   wq4(F, H, group, f"blockwise{INT4_BLOCK_F}")), 3 * H * F // 2)
                fn = lambda *a: quant.int4_mlp(*a, block_f=INT4_BLOCK_F)  # noqa: E731
                plain = lambda *a: quant.int4_mlp_plain(*a, block_f=INT4_BLOCK_F)  # noqa: E731
                bd = cs.bound(sum(cs.nbytes(q["w_int4"], q["scale"]) for q in ws[0])
                              + 2 * cs.nbytes(x), 2.0 * M * 3 * H * F)
                record(f"int4_mlp {sname} M{M}", fn, plain, (x, *ws[0]),
                       cs.cycle([(x, *w) for w in ws]), bd)
            del mlps, ws
        for name, (K, N) in {**DECODE_MM, **TOWER_MM}.items():
            M = M_DECODE if name in DECODE_MM else M_TOWER
            ws = sets(lambda: wq(K, N), K * N) if M == M_DECODE else [wq(K, N) for _ in range(2)]
            x = x_of(M, K)
            nxt = cs.cycle([(x, w) for w in ws])
            wd = (ws[0]["w_int8"].float() * ws[0]["scale"]).to(torch.bfloat16)
            deq = statistics.median(cs.time_ms(lambda: torch.matmul(x, wd), 20)
                                    for _ in range(REPS))
            del wd
            bd = cs.bound(cs.nbytes(x, ws[0]["w_int8"], ws[0]["scale"]) + M * N * 2,
                          2.0 * M * K * N)
            record(f"int8_matmul {name} M{M}", quant.int8_matmul, quant.int8_matmul_plain,
                   (x, ws[0]), nxt, bd,
                   {"torch.matmul on a dequantized bf16 copy (not the same function)": deq})
        x = x_of(M_DECODE, H)
        mlps = sets(lambda: (wq(H, F), wq(H, F), wq(F, H)), 3 * H * F)
        ffns = sets(lambda: (wq(H, F), torch.randn(F, generator=gen, device=dev) * 0.1,
                             wq(F, H), torch.randn(H, generator=gen, device=dev) * 0.1),
                    2 * H * F)
        f0 = ffns[0]
        bd = cs.bound(cs.nbytes(*f0[0].values(), f0[1], *f0[2].values(), f0[3])
                      + 2 * cs.nbytes(x), 2.0 * M_DECODE * 2 * H * F)
        record("int8_ffn M64", quant.int8_ffn, quant.int8_ffn_plain, (x, *f0),
               cs.cycle([(x, *f) for f in ffns]), bd)

        # the per-layer steps at Gemma-2-2B's layer, t = 20
        NH, KH, D, t, S = 8, 4, 256, 20, 64
        norm = lambda: (torch.randn(H, generator=gen, device=dev) * 0.1).to(torch.bfloat16)  # noqa: E731
        cos, sin = (a[0].contiguous() for a in rope_table(torch.tensor([t], device=dev), D))
        kv = (torch.randint(-127, 128, (M_DECODE, KH, S, D), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(2))
        kc, vc = kv
        ks, vs = (0.02 + 0.01 * torch.rand(M_DECODE, KH, S, generator=gen, device=dev)
                  for _ in range(2))
        kw = dict(num_heads=NH, num_kv_heads=KH, head_dim=D, attn_scale=D ** -0.5,
                  softcap=50.0, eps=1e-6)
        # whole layers, with their fragment forms where the port reads them (a
        # port before them has no layer_fragments)
        prep = getattr(dk, "layer_fragments", lambda lp: lp)
        layers = sets(lambda: prep({"attn": {"qkv": wq(H, (NH + 2 * KH) * D), "o": wq(NH * D, H)},
                                    "mlp": {"gate": wq(H, F), "up": wq(H, F), "down": wq(F, H)}}),
                      H * (NH + 2 * KH) * D + NH * D * H + 3 * H * F)
        attn = [(t, x, lp["attn"]["qkv"], lp["attn"]["o"], norm(), norm(), cos, sin, kc, vc, ks,
                 vs) for lp in layers]
        a0 = attn[0]
        bd = cs.bound(cs.nbytes(a0[2]["w_int8"], a0[2]["scale"], a0[3]["w_int8"], a0[3]["scale"],
                               a0[4], a0[5])
                      + cs.nbytes(kc, vc, ks, vs) * t // S + 2 * cs.nbytes(x),
                      2.0 * M_DECODE * (a0[2]["w_int8"].numel() + a0[3]["w_int8"].numel()))
        record("fused_attn_step M64", lambda *a: dk.fused_attn_step(*a, **kw),
               lambda *a: dk.fused_attn_step_plain(*a, **kw), a0, cs.cycle(attn), bd)
        mlp_args = [(x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"], norm(), norm())
                    for lp in layers]
        bd = cs.bound(sum(cs.nbytes(q["w_int8"], q["scale"]) for q in mlp_args[0][1:4])
                      + 2 * cs.nbytes(x), 2.0 * M_DECODE * 3 * H * F)
        record("fused_mlp_step M64", lambda *a: dk.fused_mlp_step(*a, eps=1e-6),
               lambda *a: dk.fused_mlp_step_plain(*a, eps=1e-6), mlp_args[0],
               cs.cycle(mlp_args), bd)
        del attn, mlp_args, layers, mlps, ffns

        # the stack step: 26 layers of random bytes in the fragment layout
        L, NQKV = 26, (NH + 2 * KH) * D
        frag = lambda k, n: torch.randint(-127, 128, (L, *dk.frag_shape(k, n)), generator=gen,  # noqa: E731
                                          device=dev, dtype=torch.int8)
        sc = lambda n: torch.rand(L, n, generator=gen, device=dev) * 1e-3 + 1e-4  # noqa: E731
        stacked = {"wqkv": frag(H, NQKV), "qkv_scale": sc(NQKV), "wo": frag(NH * D, H),
                   "o_scale": sc(H), "wgu": frag(H, 2 * F), "gu_scale": sc(2 * F),
                   "wd": frag(F, H), "d_scale": sc(H),
                   "norms": torch.randn(L, 4, H, generator=gen, device=dev) * 0.1}
        cache = [torch.zeros(L, M_DECODE, KH, S, D, dtype=torch.int8, device=dev)
                 for _ in range(2)] + [torch.full((L, M_DECODE, KH, S), 0.02, device=dev)
                                       for _ in range(2)]
        xs = (torch.randn(M_DECODE, H, generator=gen, device=dev) * 0.96).to(torch.bfloat16)
        step = lambda: dk.fused_stack_step(t, xs, stacked, *cache, cos, sin, **kw)  # noqa: E731
        ms = statistics.median(cs.time_ms(step, 10) for _ in range(REPS))
        bd = cs.bound(cs.nbytes(*stacked.values()), 2.0 * M_DECODE * sum(
            stacked[k].numel() for k in ("wqkv", "wo", "wgu", "wd")))
        res["fused_stack_step M64"] = {"ms": ms, **bd, "host_us": host_us(step)}
        print(f"[fused_stack_step M64] {ms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
              f"({ms / bd['bound_ms']:.2f}x)", flush=True)
    for name, line in res["ptxas"].items():
        print(f"[ptxas] {name}: {line}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None)
    ap.add_argument("--only", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("int8_linear_torch: torch.cuda.is_available() is False; this script runs on a "
              "GPU only", file=sys.stderr)
        return 2
    if args.only is not None:
        print(json.dumps({"int8_linear": one_port(args.only)}))
        return 0
    cs = load_chip_smoke()
    print(f"card (name, power limit): {cs.card_line()}", flush=True)
    order = [REPO] if args.root is None else [args.root, REPO, REPO, args.root]
    runs = []
    for root in order:
        res = subprocess.run([sys.executable, __file__, "--only", str(root)],
                             capture_output=True, text=True, timeout=900)
        print(res.stdout[-8000:], end="", flush=True)
        if res.returncode != 0:
            print(res.stderr[-6000:], file=sys.stderr)
            return res.returncode
        runs.append((str(root), json.loads(res.stdout.strip().splitlines()[-1])["int8_linear"]))
    summary = {}
    for root in dict.fromkeys(r for r, _ in runs):
        mine = [r for k, r in runs if k == root]
        summary[root] = {key: {"ms": [r[key]["ms"] for r in mine],
                               "host_us": [r[key]["host_us"] for r in mine]}
                         for key in mine[0] if key != "ptxas"}
        print(f"[summary] {root}: " + "; ".join(
            f"{key} {', '.join(f'{v:.4f}' for v in vals['ms'])} ms "
            f"({', '.join(f'{v:.1f}' for v in vals['host_us'])} us host)"
            for key, vals in summary[root].items()))
    print(json.dumps({"int8_linear": {"runs": runs, "summary": summary}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
