"""`vlm-caption-torch` CLI: caption image files with the PyTorch port
(port of vlm_bridge_tpu.inference.caption).

    vlm-caption-torch IMAGES --quantize embedding,mlp,attn,bridge [--device cuda]
                      [--sample --temperature 0.7 --top-p 0.9]

IMAGES is a file, a directory or a glob. Decoding is greedy unless --sample
is given; the sampling stream is a generator seeded with --seed. --device cpu
runs the kernels' plain versions. The frozen towers are a seeded random init
(--seed), or HF snapshots with --hf-vision-path / --hf-lm-path;
`--checkpoint <dir>/<slot>` serves a trained bridge from a CheckpointStore
slot. `--mesh D[,M]` captions over a process group of D x M processes
(torchrun, or MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK in the
environment): each data block decodes its rows of every batch
(generate_tokens(mesh=); with M > 1 over an LM cut over the block's M
ranks), --batch-size is kept as given (the padded batch must split over D),
and only rank 0 writes the JSONL.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


def collect_images(spec: str) -> List[Path]:
    import glob as _glob

    p = Path(spec)
    if p.is_dir():
        return sorted(q for q in p.rglob("*") if q.suffix.lower() in IMAGE_EXTS)
    if p.exists():
        return [p]
    matches = sorted(Path(m) for m in _glob.glob(spec, recursive=True))
    return [m for m in matches if m.suffix.lower() in IMAGE_EXTS]


def caption_images(params, cfg, tokenizer, image_paths: List[Path], *, batch_size: int = 32,
                   gen=None, activation_dtype=None, device=None,
                   generator: Optional[torch.Generator] = None, mesh=None) -> List[dict]:
    """Caption a list of image files; returns [{"image", "caption"}...].
    generator: the sampling stream (on `device`), advanced batch after batch.
    mesh: passed to generate_tokens (every rank loads every batch and
    returns every caption)."""
    from PIL import Image

    from vlm_bridge_tpu_torch.data.preprocess import (
        CROP_SIZE, RESIZE_EDGE, host_resize_crop, normalize_on_device, pad_to_batch)
    from vlm_bridge_tpu_torch.inference.generate import (
        GenerationConfig, generate_tokens, resolve_activation_dtype)
    from vlm_bridge_tpu_torch.inference.robust import decode_captions

    if gen is None:
        gen = GenerationConfig(max_length=50, greedy=True, early_stop=True)
    activation_dtype = resolve_activation_dtype(activation_dtype, gen)
    results = []
    crop = cfg.image_size
    edge = max(crop, round(crop * RESIZE_EDGE / CROP_SIZE))
    for start in range(0, len(image_paths), batch_size):
        chunk = image_paths[start: start + batch_size]
        arrs = []
        for path in chunk:
            with Image.open(path) as img:
                arrs.append(host_resize_crop(img.convert("RGB"), crop=crop, edge=edge))
        pixels_np = pad_to_batch(np.stack(arrs), batch_size)
        pixels = normalize_on_device(torch.from_numpy(pixels_np).to(device),
                                     dtype=activation_dtype)
        toks, lens = generate_tokens(params, cfg, pixel_values=pixels, generator=generator,
                                     gen=gen, activation_dtype=activation_dtype, mesh=mesh)
        texts = decode_captions(tokenizer, toks.cpu().numpy()[: len(chunk)],
                                lens.cpu().numpy()[: len(chunk)])
        results.extend({"image": str(p), "caption": t} for p, t in zip(chunk, texts))
    return results


def main(argv=None) -> int:
    import argparse

    from vlm_bridge_tpu_torch.parallel import distributed, init_multihost

    ap = argparse.ArgumentParser(prog="vlm-caption-torch",
                                 description="caption images (file/dir/glob), PyTorch port")
    ap.add_argument("images", help="image file, directory, or glob")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-length", type=int, default=50)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--sample", dest="greedy", action="store_false")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--output", default=None, help="write JSONL here (else stdout)")
    ap.add_argument("--mesh", default=None,
                    help="DATA[,MODEL]: caption over a process group of DATA x MODEL "
                         "processes (torchrun, or MASTER_ADDR / MASTER_PORT / WORLD_SIZE / "
                         "RANK): the batch split over DATA, the frozen LM's float "
                         "projections over MODEL")
    from vlm_bridge_tpu_torch.tools.loading import add_model_args

    add_model_args(ap)
    args = ap.parse_args(argv)

    paths = collect_images(args.images)
    if not paths:
        print(f"no images found for {args.images!r}", file=sys.stderr)
        return 1
    own_group = False
    if args.mesh:
        own_group = not distributed.is_initialized() and init_multihost(device=args.device)
    try:
        return _caption_from_args(args, paths)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _caption_from_args(args, paths: List[Path]) -> int:
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig
    from vlm_bridge_tpu_torch.tools.loading import (load_from_args, mesh_from_args,
                                                    prestack_decode_params)

    cfg, params, tokenizer = load_from_args(args)
    mesh, params = mesh_from_args(args, params)
    # with a quantized LM the int8-KV fused stack decode is the serving recipe
    gen = GenerationConfig(max_length=args.max_length, greedy=args.greedy,
                           temperature=args.temperature, top_p=args.top_p, early_stop=True,
                           kv_quant=bool(args.quantize))
    params = prestack_decode_params(params, cfg, gen, mesh=mesh)
    device = params["lm"]["final_norm"].device
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed if mesh is None else mesh.rank_seed(args.seed))
    t0 = time.time()
    results = caption_images(params, cfg, tokenizer, paths,
                             batch_size=args.batch_size if mesh else min(args.batch_size,
                                                                         len(paths)),
                             gen=gen, device=device, generator=generator, mesh=mesh)
    dt = time.time() - t0
    if mesh is not None and mesh.rank != 0:
        return 0
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        for r in results:
            out.write(json.dumps(r) + "\n")
    finally:
        if args.output:
            out.close()
            print(f"{len(results)} captions -> {args.output} "
                  f"({len(results) / dt:.2f} captions/s on {args.device})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
