"""The tied heads alone on one GPU, the greedy ones (ops/quant.int8_matmul_t_argmax
and int4_matmul_t_argmax) and the sampled ones (int8_matmul_t and
int4_matmul_t), from this checkout and from another one in turns.

    python3 scripts/head_torch.py [--root DIR]

At Gemma-2-2B's table (V = 256000, H = 2304; seeded random bytes and scales
made on the card) and M = 64 and 1 batch rows: the int8 heads, and the int4
heads per channel and in groups of 128. For each: device ms
(chip_smoke.time_ms: the mean of 20 calls queued behind a spin kernel, the
median of REPS such means; the 590 / 295 MB tables are far beyond the
50 MB L2, so every call streams its table), the byte bound (table, scales
and x once, and the ids or the f32 logits written once, over 3.35 TB/s),
and the result against the plain version: the greedy heads' ids equal
except where the plain logits of the two ids lie within 2e-5 of the row's
largest, the sampled heads' logits row by row within chip_smoke's
LOGIT_TOL / LOGIT4_TOL of the row's largest. Then what ptxas reported for
the heads' kernels (registers, spills).

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
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
V, H = 256000, 2304
NEAR_TIE = 2e-5
FORMS = ("int8", "int4_channel", "int4_g128")
REPS = 3
# this port's kernels, and the names an earlier port's build may give them
KERNEL_TAGS = ("tied_head_kernel", "greedy_head_kernel", "argmax_reduce_kernel",
               "logits_block_kernel", "logits4_block_kernel")


def load_chip_smoke():
    """chip_smoke.py of this checkout, whatever --only puts first on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ptxas_lines(build_log: str) -> dict:
    """Registers and spills ptxas reported for each head kernel."""
    out, log = {}, build_log.splitlines()
    for i, line in enumerate(log):
        tag = next((t for t in KERNEL_TAGS if t in line), None)
        if "Compiling entry function" in line and tag:
            mangled = line.split("'")[1]
            name = mangled[mangled.index(tag):].split("Ev")[0].split("EPK")[0]
            out[name] = " ".join(x.strip() for x in log[i + 1:i + 4]
                                 if "bytes" in x or "registers" in x)
    return out


def tables(dev, gen) -> dict:
    e8 = torch.randint(-127, 128, (V, H), generator=gen, device=dev, dtype=torch.int8)
    s8 = torch.rand(V, generator=gen, device=dev) * 1e-3 + 1e-4
    e4 = torch.randint(-128, 128, (V, H // 2), generator=gen, device=dev, dtype=torch.int8)
    s4 = torch.rand(V, generator=gen, device=dev) * 1e-2 + 1e-3
    g4 = torch.rand(H // 128, V, generator=gen, device=dev) * 1e-2 + 1e-3
    return {"int8": {"w_int8": e8, "scale": s8}, "int4_channel": {"w_int4": e4, "scale": s4},
            "int4_g128": {"w_int4": e4, "scale": g4}}


def one_port(root: Path) -> dict:
    """Times this process's port (imported from root)."""
    sys.path.insert(0, str(root.resolve()))
    from vlm_bridge_tpu_torch.ops import cuda_lib, quant

    cs = load_chip_smoke()
    print(f"port from {Path(quant.__file__).resolve().parents[2]}", flush=True)
    cuda_lib.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 17)
    res = {"ptxas": ptxas_lines(cuda_lib.build_log)}
    tabs = tables(dev, gen)
    with torch.no_grad():
        for M in (64, 1):
            x = torch.randn(M, H, generator=gen, device=dev).to(torch.bfloat16)
            for form in FORMS:
                tab = tabs[form]
                head, plain, sampled, logits, tol = (
                    (quant.int8_matmul_t_argmax, quant.int8_matmul_t_argmax_plain,
                     quant.int8_matmul_t, quant.int8_matmul_t_plain, cs.LOGIT_TOL)
                    if form == "int8" else
                    (quant.int4_matmul_t_argmax, quant.int4_matmul_t_argmax_plain,
                     quant.int4_matmul_t, quant.int4_matmul_t_plain, cs.LOGIT4_TOL))
                got, want = head(x, tab), plain(x, tab)
                y = logits(x, tab)
                cs.rows_close(f"sampled {form} M {M}", sampled(x, tab), y, tol)
                rows = torch.arange(M, device=dev)
                differ = got != want
                gap = (y[rows, want.long()] - y[rows, got.long()]).abs()
                lim = NEAR_TIE * y.abs().amax(dim=-1)
                bad = int((differ & ~(gap <= lim)).sum())
                if bad:
                    raise AssertionError(f"{form} M {M}: {bad} ids differ outside a near-tie")
                ms = statistics.median(cs.time_ms(lambda: head(x, tab), 20) for _ in range(REPS))
                bd = cs.bound(cs.nbytes(*tab.values(), x, got), 2.0 * M * V * H)
                rate = cs.nbytes(*tab.values()) / ms / 1e9
                print(f"[head] {form} M {M}: {ms:.4f} ms, bound {bd['bound_ms']:.4f} "
                      f"({ms / bd['bound_ms']:.2f}x; table and scales at {rate:.2f} TB/s); ids "
                      f"differing {int(differ.sum())}, all within a near-tie", flush=True)
                res[f"{form}_M{M}"] = {"ms": ms, "bound_ms": bd["bound_ms"],
                                       "ids_differing": int(differ.sum())}
                ms = statistics.median(cs.time_ms(lambda: sampled(x, tab), 20)
                                       for _ in range(REPS))
                bd = cs.bound(cs.nbytes(*tab.values(), x, y), 2.0 * M * V * H)
                del y
                print(f"[head] sampled {form} M {M}: {ms:.4f} ms, bound {bd['bound_ms']:.4f} "
                      f"({ms / bd['bound_ms']:.2f}x)", flush=True)
                res[f"sampled_{form}_M{M}"] = {"ms": ms, "bound_ms": bd["bound_ms"]}
    for name, line in res["ptxas"].items():
        print(f"[ptxas] {name}: {line}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, default=None)
    ap.add_argument("--only", type=Path, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("head_torch: torch.cuda.is_available() is False; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    if args.only is not None:
        print(json.dumps({"head": one_port(args.only)}))
        return 0
    cs = load_chip_smoke()
    print(f"card (name, power limit): {cs.card_line()}", flush=True)
    order = [REPO] if args.root is None else [args.root, REPO, REPO, args.root]
    runs = []
    for root in order:
        res = subprocess.run([sys.executable, __file__, "--only", str(root)],
                             capture_output=True, text=True, timeout=900)
        print(res.stdout[-6000:], end="", flush=True)
        if res.returncode != 0:
            print(res.stderr[-6000:], file=sys.stderr)
            return res.returncode
        runs.append((str(root), json.loads(res.stdout.strip().splitlines()[-1])["head"]))
    summary = {}
    for root in dict.fromkeys(r for r, _ in runs):
        mine = [r for k, r in runs if k == root]
        summary[root] = {key: [r[key]["ms"] for r in mine]
                         for key in mine[0] if key != "ptxas"}
        print(f"[summary] {root}: " + "; ".join(
            f"{key} {', '.join(f'{v:.4f}' for v in vals)} ms"
            for key, vals in summary[root].items()))
    print(json.dumps({"head": {"runs": runs, "summary": summary}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
