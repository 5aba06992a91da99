"""`vlm-parity-torch`: the token-for-token parity harness (port of
vlm_bridge_tpu.tools.parity), in three modes:

  self-check   No weights needed. Imports the reference's own
               bridge_module.py (pure torch) and holds the port's bridge
               forward and its `.pth` strict-load round trip to it
               (reference: src/vlm_bridge/model_architecture/
               bridge_module.py:240-471).

  check        Given HF snapshots + a converted `.pth` + a recorded
               transcript (JSONL of {"image_path", "tokens" and/or
               "caption"}), run exact-mode greedy decode per image and
               assert token-for-token (or text) equality.

  record       Produce such a transcript from this port's decode, so two
               builds (this port, the JAX package, a reference run that
               dumps ids) can be diffed with `check`.

Transcript format: one JSON object per line;
  tokens  = full id sequence starting at BOS and ending at (and including)
            EOS, or running to max_length
  caption = decoded text (used when "tokens" is absent)

Decoding is batch 1 (numerics independent of batch composition), f32, exact
mode, greedy. The JAX tool pins `jax_default_matmul_precision` to "highest"
because a reduced-precision f32 matmul can flip a near-tie argmax; its
counterpart here is TF32 off for matmuls and for cuDNN (the patch-embed
convolution): `_decode_images` sets both at its start and restores them at
its end. Nothing else in the port changes them.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import List, Optional

import torch

# the reference repository checked out as ~/reference
DEFAULT_REFERENCE = str(Path.home() / "reference" / "src" / "vlm_bridge" / "model_architecture"
                        / "bridge_module.py")


def _load_reference_bridge(path: str | Path):
    spec = importlib.util.spec_from_file_location("ref_bridge_module", str(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["ref_bridge_module"] = mod
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# self-check: reference module as oracle, no weights required
# ---------------------------------------------------------------------------


def self_check(reference: str, dims: str) -> int:
    import numpy as np

    from vlm_bridge_tpu_torch.configs import BridgeConfig
    from vlm_bridge_tpu_torch.models import bridge as bridge_mod
    from vlm_bridge_tpu_torch.params.torch_bridge import (bridge_from_state_dict,
                                                          bridge_to_state_dict)

    ref_path = Path(reference)
    if not ref_path.exists():
        print(f"FAIL: reference module not found at {ref_path}")
        return 2
    ref = _load_reference_bridge(ref_path)

    if dims == "real":
        cfg = BridgeConfig(dropout=0.0)          # 1024/2304/8/18, FFN x4
        B, T, S = 1, 5, 257
        atol = 5e-4
    else:
        cfg = BridgeConfig(vision_dim=32, language_dim=64, num_blocks=2, num_heads_cross=2,
                           num_heads_self=4, ffn_mult=4, dropout=0.0)
        B, T, S = 2, 6, 9
        atol = 2e-5

    torch.manual_seed(0)
    ref_bridge = ref.BridgeLite(
        vision_dim=cfg.vision_dim, language_dim=cfg.language_dim, num_blocks=cfg.num_blocks,
        num_heads_cross=cfg.num_heads_cross, num_heads_self=cfg.num_heads_self, dropout=0.0)
    ref_bridge.eval()

    rng = np.random.default_rng(1)
    text = torch.from_numpy(rng.normal(0, 1, (B, T, cfg.language_dim)).astype(np.float32))
    vision = torch.from_numpy(rng.normal(0, 1, (B, S, cfg.vision_dim)).astype(np.float32))
    with torch.no_grad():
        want = ref_bridge(vision, text)
        params = bridge_from_state_dict(ref_bridge.state_dict(), cfg)
        got = bridge_mod.forward(params, cfg, text, vision)
    diff = float((got - want).abs().max())
    fwd_ok = diff <= atol + atol * float(want.abs().max())

    # .pth layout: the port's export must strict-load into the reference module
    sd = bridge_to_state_dict(bridge_mod.init(cfg, generator=torch.Generator().manual_seed(0)),
                              cfg)
    try:
        ref_bridge.load_state_dict({k: v.detach().clone() for k, v in sd.items()}, strict=True)
        sd_ok = True
    except Exception as e:  # pragma: no cover - failure reporting
        print(f"state_dict strict load failed: {e}")
        sd_ok = False

    print(f"forward parity ({dims} dims): max|diff|={diff:.2e} -> {'OK' if fwd_ok else 'FAIL'}")
    print(f"state_dict layout: {'OK' if sd_ok else 'FAIL'}")
    print("PARITY SELF-CHECK " + ("PASSED" if fwd_ok and sd_ok else "FAILED"))
    return 0 if fwd_ok and sd_ok else 1


# ---------------------------------------------------------------------------
# transcript check / record
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for matmuls and cuDNN inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _decode_images(args, image_paths: List[Path]):
    """Exact-mode greedy tokens for each image, one at a time: yields
    (path, ids, text)."""
    from PIL import Image

    from vlm_bridge_tpu_torch.data.preprocess import host_resize_crop, normalize_on_device
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.tools.loading import load_from_args

    with _no_tf32():
        cfg, params, tokenizer = load_from_args(args)
        device = params["lm"]["final_norm"].device
        if args.pth:
            from vlm_bridge_tpu_torch.params.torch_bridge import load_pth

            params["bridge"] = load_pth(args.pth, cfg.bridge, device=device)
        gen = GenerationConfig(max_length=args.max_length, greedy=True, exact=True)
        for p in image_paths:
            with Image.open(p) as img:
                pixels = host_resize_crop(img)[None]
            pixels = normalize_on_device(torch.tensor(pixels, device=device), dtype=torch.float32)
            toks, lengths = generate_tokens(params, cfg, pixel_values=pixels, gen=gen,
                                            activation_dtype=torch.float32)
            toks, n = toks[0].cpu(), int(lengths[0])
            ids = toks[: min(n + 1, toks.shape[0])].tolist()  # incl. EOS if hit
            yield p, ids, tokenizer.decode(ids)


def run_check(args) -> int:
    rows = [json.loads(line) for line in Path(args.transcript).read_text().splitlines()
            if line.strip()]
    root = Path(args.data_dir or Path(args.transcript).parent)
    paths = [root / r["image_path"] for r in rows]
    failures = 0
    for (p, ids, text), row in zip(_decode_images(args, paths), rows):
        ok = True
        if "tokens" in row:
            ok = list(map(int, row["tokens"])) == ids
        elif "caption" in row:
            ok = row["caption"].strip() == text.strip()
        print(f"{'OK  ' if ok else 'FAIL'} {row['image_path']}: {text[:60]!r}")
        if not ok:
            failures += 1
            if "tokens" in row:
                print(f"     want tokens: {row['tokens']}")
                print(f"     got  tokens: {ids}")
            else:
                print(f"     want: {row.get('caption', '')!r}")
    print(f"token-for-token parity: {len(rows) - failures}/{len(rows)} matched")
    return 1 if failures else 0


def run_record(args) -> int:
    out = Path(args.output)
    with out.open("w") as f:
        for p, ids, text in _decode_images(args, [Path(p) for p in args.images]):
            f.write(json.dumps({"image_path": str(p), "tokens": ids, "caption": text}) + "\n")
            print(f"recorded {p}: {len(ids)} tokens")
    print(f"wrote {out}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    from vlm_bridge_tpu_torch.tools.loading import add_model_args

    ap = argparse.ArgumentParser(prog="vlm-parity-torch",
                                 description="token-for-token parity harness (PyTorch port)")
    sub = ap.add_subparsers(dest="mode", required=True)

    sc = sub.add_parser("self-check", help="reference bridge_module.py as oracle (no weights "
                        "needed)")
    sc.add_argument("--reference", default=DEFAULT_REFERENCE,
                    help="path to the reference bridge_module.py")
    sc.add_argument("--dims", default="real", choices=["real", "tiny"])

    ck = sub.add_parser("check", help="decode images, compare to a recorded transcript "
                        "token for token")
    ck.add_argument("--transcript", required=True)
    ck.add_argument("--data-dir", default=None,
                    help="image paths resolve against this (default: the transcript's "
                         "directory)")
    ck.add_argument("--pth", default=None,
                    help="reference .pth bridge checkpoint to convert and load")
    ck.add_argument("--max-length", type=int, default=50)
    add_model_args(ck)

    rec = sub.add_parser("record", help="write a transcript from this build")
    rec.add_argument("images", nargs="+")
    rec.add_argument("--output", default="transcript.jsonl")
    rec.add_argument("--pth", default=None)
    rec.add_argument("--max-length", type=int, default=50)
    add_model_args(rec)

    args = ap.parse_args(argv)
    if args.mode == "self-check":
        return self_check(args.reference, args.dims)
    if args.mode == "check":
        return run_check(args)
    return run_record(args)


if __name__ == "__main__":
    raise SystemExit(main())
