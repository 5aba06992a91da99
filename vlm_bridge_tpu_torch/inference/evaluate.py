"""Batched test-split evaluation harness and the `vlm-eval-torch` CLI (port of
vlm_bridge_tpu.inference.evaluate): KV-cache decode over a dataset split,
corpus BLEU-1..4 and CIDEr-D, captions per second.

    vlm-eval-torch --data-dir D --split test --batch-size 64 \\
        --quantize embedding4,mlp,attn,bridge --kv-int8 --mlp-int4 --no-early-stop

is the int4 serving recipe: the fused stack step with int4 MLP weights and
the int4 head. `--device cpu` runs the kernels' plain versions. Images stream
through the BatchLoader's prefetch queue as uint8 and are normalized on the
device; the trailing partial batch is padded by repetition and trimmed after
decode, so every batch has one shape. `--exact` is the reference-parity
decode (f32, full re-forward per token, no early stop); its bridge is
causal when the checkpoint's meta.json says it was trained so
(`--bridge-causal` / `--no-bridge-causal` override). `--checkpoint
<dir>/<slot>` serves a trained bridge over the seeded random init of the
frozen towers (the same --seed as the training run's gives its towers).

`--mesh D[,M]` decodes over a process group of D x M processes (launched by
torchrun, or MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK in the
environment): every rank loads each global batch, and generate_tokens(mesh=)
decodes each data block's rows (with M == 1 through the same single-device
kernels; with M > 1 on the per-layer path over an LM whose float projections
are cut over the M ranks of the block) and gathers the ids in block order;
rank 0 detokenizes and scores.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from vlm_bridge_tpu_torch.configs import VLMConfig
from vlm_bridge_tpu_torch.data.loader import BatchLoader, VLDataset
from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device, pad_to_batch
from vlm_bridge_tpu_torch.inference.generate import (GenerationConfig, generate_tokens,
                                                     resolve_activation_dtype)
from vlm_bridge_tpu_torch.inference.metrics import evaluate_captions
from vlm_bridge_tpu_torch.inference.robust import decode_captions
from vlm_bridge_tpu_torch.models import gemma2
from vlm_bridge_tpu_torch.parallel import distributed, init_multihost
from vlm_bridge_tpu_torch.tools.loading import (add_model_args, load_from_args, mesh_from_args,
                                                prestack_decode_params)


@torch.no_grad()
def evaluate_split(
    params,
    cfg: VLMConfig,
    data_dir: str | Path,
    *,
    tokenizer,
    split: str = "test",
    batch_size: int = 32,
    gen: GenerationConfig = GenerationConfig(max_length=50, greedy=True),
    max_samples: Optional[int] = None,
    activation_dtype=None,  # None -> bf16 (f32 for exact mode)
    generator: Optional[torch.Generator] = None,
    device=None,
    verbose: bool = True,
    dump_samples: Optional[str | Path] = None,
    mesh=None,
) -> Dict[str, object]:
    """Caption every image in a split; score against the references.

    Returns {"metrics": {...bleu/cider...}, "captions_per_sec": ...,
    "num_samples": N, "samples": [(generated, reference), ...first 10]}.
    captions_per_sec is the end-to-end steady-state wall rate (loader, device
    decode and the overlapped host detokenizing), the first batch left out.
    generator: the sampling stream, one torch.Generator on `device` advanced
    batch after batch (None: a generator seeded with 0); greedy draws
    nothing. device: where the batches go (None: the parameters' device).
    mesh: a ("data", "model") mesh (parallel.auto_mesh): generate_tokens
    decodes this rank's data block of every batch (batch_size must split
    over the data axis) and gathers the ids, and only rank 0 detokenizes and
    scores (the other ranks return num_samples and timings, with empty
    metrics and samples).
    """
    activation_dtype = resolve_activation_dtype(activation_dtype, gen)
    if device is None:
        device = params["lm"]["final_norm"].device
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)
    scorer = mesh is None or mesh.rank == 0
    ds = VLDataset(data_dir, split)
    loader = BatchLoader(ds, batch_size=batch_size, tokenizer=tokenizer, shuffle=False,
                         drop_last=False, num_workers=4)

    candidates, refs = [], []
    n_done = 0
    # One-batch-deep software pipeline: while the device decodes batch N+1 the
    # host detokenizes and books batch N. generate_tokens only queues work on
    # the device, so the one host fence is the .cpu() in _drain, issued one
    # batch late.
    pending = None  # (real, captions, toks_dev, lens_dev)
    t_last = [None]

    def _drain(entry):
        nonlocal n_done
        real, caps, toks_dev, lens_dev = entry
        toks, lens = toks_dev.cpu().numpy(), lens_dev.cpu().numpy()  # fence
        if scorer:
            candidates.extend(decode_captions(tokenizer, toks[:real], lens[:real]))
            refs.extend([[c] for c in caps[:real]])
        n_done += real
        now = time.time()
        if verbose and scorer:
            dt = f" (+{now - t_last[0]:.2f}s)" if t_last[0] else ""
            print(f"  evaluated {n_done}/{len(ds)}{dt}", flush=True)
        t_last[0] = now

    def _fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t_start = time.time()
    t_steady0 = None  # wall clock after batch 0 (kernel build, allocator warm-up)
    first_real = 0
    n_dispatched = 0
    for batch in loader:
        pixels_np = batch["pixel_values"]
        real = pixels_np.shape[0]
        if max_samples is not None and n_dispatched + real > max_samples:
            real = max_samples - n_dispatched
            pixels_np = pixels_np[:real]
        if real == 0:
            break
        pixels_np = pad_to_batch(pixels_np, batch_size)
        pixels = normalize_on_device(torch.from_numpy(pixels_np).to(device),
                                     dtype=activation_dtype)
        # under a mesh the ids' gather is queued behind the decode: the fence
        # stays in _drain
        toks, lens = generate_tokens(params, cfg, pixel_values=pixels, generator=generator,
                                     gen=gen, activation_dtype=activation_dtype, mesh=mesh)
        n_dispatched += real
        if pending is None:
            # the first batch pays the one-time costs: fence it and start the
            # steady-state clock before any overlapped work
            _fence()
            t_steady0 = time.time()
            first_real = real
        else:
            _drain(pending)  # host work overlaps the decode just queued
        pending = (real, batch["captions"], toks, lens)
        if max_samples is not None and n_dispatched >= max_samples:
            break
    if pending is not None:
        _drain(pending)
    t_end = time.time()

    metrics = evaluate_captions(candidates, refs) if scorer else {}
    gen_time = t_end - t_start
    total_cps = n_done / gen_time if gen_time > 0 else 0.0
    if t_steady0 is not None and n_done > first_real:
        cps = (n_done - first_real) / (t_end - t_steady0)
    else:
        cps = total_cps
    result = {
        "metrics": metrics,
        "captions_per_sec": cps,
        "captions_per_sec_timing": "end_to_end_wall_steady_state",
        "captions_per_sec_incl_first_batch": total_cps,
        "num_samples": n_done,
        "generation_time_s": gen_time,
        "host_loop_overlapped": True,
        "pixel_cache": ds.pixels is not None,
        "device": str(device),
        "samples": list(zip(candidates[:10], [r[0] for r in refs[:10]])),
    }
    if dump_samples and scorer:
        with open(dump_samples, "w") as f:
            for cand, ref in zip(candidates, refs):
                f.write(json.dumps({"generated": cand, "reference": ref[0]}) + "\n")
    if verbose and scorer:
        m = metrics
        print(f"[eval:{split}] n={n_done} bleu4={m['bleu4']:.4f} bleu1={m['bleu1']:.4f} "
              f"cider_d={m['cider_d']:.4f} ({cps:.2f} captions/s on {device})")
    return result


def main(argv=None) -> int:
    """`vlm-eval-torch` CLI: batched caption evaluation over a dataset split."""
    import argparse

    ap = argparse.ArgumentParser(prog="vlm-eval-torch",
                                 description="batched caption eval (BLEU/CIDEr), PyTorch port")
    ap.add_argument("--data-dir", default="data/groundcap")
    ap.add_argument("--split", default="test")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--max-length", type=int, default=50)
    ap.add_argument("--max-samples", type=int, default=None)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--sample", dest="greedy", action="store_false",
                    help="temperature/top-p sampling instead of greedy")
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--top-p", type=float, default=0.9)
    ap.add_argument("--exact", action="store_true",
                    help="reference-parity decode: f32, full re-forward per token")
    ap.add_argument("--output", default=None, help="write result JSON here")
    ap.add_argument("--dump-samples", default=None,
                    help="write every (generated, reference) pair as JSONL")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV caches: with --quantize this is the fused serving recipe")
    ap.add_argument("--early-stop", action=argparse.BooleanOptionalAction, default=None,
                    help="stop a batch once every row has emitted EOS (default: on). "
                         "--no-early-stop decodes the fixed length, for like-for-like "
                         "throughput comparison")
    ap.add_argument("--bridge-causal", action=argparse.BooleanOptionalAction, default=None,
                    help="causal bridge self-attention in --exact mode (default: the "
                         "checkpoint's meta.json bridge_causal, else off)")
    ap.add_argument("--mlp-int4", action=argparse.BooleanOptionalAction, default=False,
                    help="int4 Gemma MLP weights in the fused stack decode (with --quantize "
                         "mlp,attn + --kv-int8); pair with '--quantize embedding4,...' for "
                         "the int4 head")
    ap.add_argument("--mesh", default=None,
                    help="DATA[,MODEL]: decode over a process group of DATA x MODEL "
                         "processes (torchrun, or MASTER_ADDR / MASTER_PORT / WORLD_SIZE / "
                         "RANK): the batch split over DATA, the frozen LM's float "
                         "projections over MODEL")
    add_model_args(ap)
    args = ap.parse_args(argv)
    own_group = False
    if args.mesh:
        own_group = not distributed.is_initialized() and init_multihost(device=args.device)
    try:
        return _evaluate_from_args(args)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _evaluate_from_args(args) -> int:
    cfg, params, tokenizer = load_from_args(args)
    mesh, params = mesh_from_args(args, params)

    if args.mlp_int4:
        # the int4 MLP serves ONLY the fused stack decode; anything else would
        # measure the int8 path under the int4 label
        if args.exact or not args.kv_int8:
            raise SystemExit("--mlp-int4 serves only the fused-stack decode: pair it with "
                             "--kv-int8, not --exact")
        if not gemma2.supports_fused_decode(params["lm"], cfg.lm, args.max_length + 1):
            raise SystemExit("--mlp-int4 needs fully int8-quantized LM layers within the fused "
                             "cache budget: pass --quantize including mlp,attn (e.g. "
                             "embedding4,mlp,attn,bridge)")

    if args.early_stop and args.exact:
        print("[vlm-eval-torch] --early-stop is ignored in --exact mode (the parity decode is "
              "a fixed-length masked buffer)", flush=True)
    early_stop = (not args.exact) if args.early_stop is None else (args.early_stop
                                                                   and not args.exact)
    # exact mode masks the bridge as the checkpoint was trained (meta.json),
    # unless --bridge-causal / --no-bridge-causal says otherwise
    bridge_causal = args.bridge_causal
    if bridge_causal is None:
        bridge_causal = bool(getattr(args, "_ckpt_meta", {}).get("bridge_causal", False))
        if bridge_causal and args.exact:
            print("[vlm-eval-torch] checkpoint was trained with bridge_causal; exact mode uses "
                  "the causal bridge mask", flush=True)
    gen = GenerationConfig(max_length=args.max_length, greedy=args.greedy,
                           temperature=args.temperature, top_p=args.top_p, exact=args.exact,
                           early_stop=early_stop, kv_quant=args.kv_int8,
                           bridge_causal=bridge_causal, mlp_int4=args.mlp_int4)
    # serving stacks the decode weights once at load time, not per batch
    params = prestack_decode_params(params, cfg, gen, mesh=mesh)
    device = params["lm"]["final_norm"].device
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed if mesh is None else mesh.rank_seed(args.seed))
    result = evaluate_split(params, cfg, args.data_dir, tokenizer=tokenizer, split=args.split,
                            batch_size=args.batch_size, gen=gen, max_samples=args.max_samples,
                            dump_samples=args.dump_samples, generator=generator, device=device,
                            mesh=mesh)
    if args.output and (mesh is None or mesh.rank == 0):
        Path(args.output).write_text(json.dumps(
            {k: v for k, v in result.items() if k != "samples"}, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
