"""Close-the-loop training proof: train -> checkpoint -> correct captions
(port of vlm_bridge_tpu.tools.memorize).

Overfit the tiny preset on K fixed image / caption pairs through the real
orchestrator (`execute_full_training`: epochs, validation, best-checkpoint
selection), reload the best slot through the real store, and require that
greedy `generate_tokens` reproduces every training caption token for token;
then score the split with the real harness (`evaluate_split`) and require
BLEU-4 ~ 1.0.

Two knobs make this reachable at tiny scale, as in the JAX package:

- `bridge_causal=True`: a non-causal bridge leaks each next token into
  training position t through its self-attention, so teacher-forced loss
  converges without the model learning the conditional it is served with.
  The causal bridge trains the KV-cached decode's conditional.
- `embed_scale`: with the tiny random LM, logits are RMSNorm-bounded hidden
  states against 0.02-std embedding rows, so cross-entropy has a floor of
  ~5 nats whatever the bridge does. Scaling the frozen table lets the head
  express confident distributions, as trained Gemma-2 tables do.

The dataset is written with numpy alone (a manifest and the pixel cache's
two files; no image file is decoded), so the proof needs no PIL.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

# >= 4 words each, so corpus BLEU-4 has 4-grams to match
CAPTIONS8 = ("a red dog runs by.", "the blue cat sat up!",
             "one green fox hid low?", "a tall tree fell over.",
             "an old boat sank fast.", "my new car drove off!",
             "a wet rock slid down?", "the dry sand blew away.")


def build_memorization_dataset(data_dir: str | Path, *, captions=CAPTIONS8,
                               train_repeats: int = 32, seed: int = 0) -> None:
    """GroundCap-layout dataset of K fixed pairs: train/ holds each pair
    `train_repeats` times (one epoch is several optimizer steps at batch K),
    val/ and test/ once each. Pixels go straight into each split's pixel
    cache, at the loader's crop size."""
    import numpy as np

    from vlm_bridge_tpu_torch.data import pixel_cache
    from vlm_bridge_tpu_torch.data.preprocess import CROP_SIZE

    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (len(captions), CROP_SIZE, CROP_SIZE, 3), np.uint8)
    for split, repeats in (("train", train_repeats), ("val", 1), ("test", 1)):
        root = Path(data_dir) / split
        root.mkdir(parents=True, exist_ok=True)
        recs, rows = [], []
        for i, cap in enumerate(captions):
            for _ in range(repeats):
                recs.append({"image_path": f"images/memo{i:03d}.jpg", "caption": cap,
                             "original_id": f"memo{i:03d}"})
                rows.append(i)
        (root / "captions.jsonl").write_text("".join(json.dumps(r) + "\n" for r in recs))
        np.save(root / pixel_cache.CACHE_NAME, images[rows])
        (root / pixel_cache.META_NAME).write_text(json.dumps(
            {"n": len(recs), "crop": CROP_SIZE,
             "fingerprint": pixel_cache.manifest_fingerprint(root, recs)}))


def run_proof(workdir: str | Path, *, num_epochs: int = 60, learning_rate: float = 3e-3,
              embed_scale: float = 25.0, captions=CAPTIONS8, max_length: int = 32,
              verbose: bool = True, recipes: tuple = ("bf16",),
              device="cuda") -> Dict[str, object]:
    """Train the tiny preset to memorize `captions` on `device`; return the
    proof record: per-caption exact matches, the best slot's val loss and
    evaluate_split's metrics for each decode recipe of the same trained
    checkpoint ("bf16": the float fast path; "int8": the int8 serving
    recipe with the int8 KV cache through the fused stack step; "int4": the
    same with int4 MLP weights and the int4 table). Raises nothing on a
    mismatch: callers assert on the fields, so failures show the captions."""
    import numpy as np
    import torch

    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.data.loader import VLDataset
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
    from vlm_bridge_tpu_torch.data.tokenizer import ByteTokenizer
    from vlm_bridge_tpu_torch.inference.evaluate import evaluate_split
    from vlm_bridge_tpu_torch.inference.generate import GenerationConfig, generate_tokens
    from vlm_bridge_tpu_torch.models import bridge as bridge_mod
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.tools.loading import resolve_device
    from vlm_bridge_tpu_torch.training.orchestrator import (execute_full_training,
                                                            prepare_environment)
    from vlm_bridge_tpu_torch.training.stack import init_params

    unknown = set(recipes) - {"bf16", "int8", "int4"}
    if unknown:
        raise ValueError(f"unknown recipes: {sorted(unknown)}")
    device = resolve_device(device)
    workdir = Path(workdir)
    data_dir = workdir / "data"
    build_memorization_dataset(data_dir, captions=captions)
    quantized = [r for r in recipes if r != "bf16"]

    K = len(captions)
    tc = TrainingConfig(
        model_preset="tiny_test_wide" if quantized else "tiny_test",
        data_dir=str(data_dir), batch_size=K, num_epochs=num_epochs,
        learning_rate=learning_rate, min_lr=learning_rate, scheduler_type="constant",
        weight_decay=0.0, gradient_clip_val=1.0, loss_chunk_size=16,
        max_text_len=max_length, pad_to_buckets=(max_length,), bridge_causal=True,
        use_early_stopping=False, early_stopping_min_delta=0.0,
        generate_samples_every_n_epochs=10 ** 6,  # no sampling mid-run
        log_every_n_steps=10 ** 6, checkpoint_dir=str(workdir / "ckpt"),
        log_dir=str(workdir / "logs"), num_workers=2, seed=0)
    cfg = tc.model_config()

    params = init_params(tc, cfg, device=device)
    params["lm"]["embedding"] = params["lm"]["embedding"] * embed_scale
    ctx = prepare_environment(tc, params=params)
    history = execute_full_training(tc, ctx=ctx)

    # the BEST slot through the real store (a weights-only template)
    restored, meta = ctx.store.load("best", template={"bridge_params": ctx.state.bridge_params})
    proof_params = {**ctx.frozen, "bridge": restored["bridge_params"]}

    ds = VLDataset(data_dir, "test")
    order = {Path(ds.samples[i]["image_path"]).stem: i for i in range(len(ds))}
    pixels = np.stack([ds.load_image(order[f"memo{i:03d}"]) for i in range(K)])
    pv = normalize_on_device(torch.from_numpy(pixels).to(device), dtype=torch.bfloat16)
    tok = ByteTokenizer()

    def score(pp, gen, tag):
        toks, lengths = generate_tokens(pp, cfg, pixel_values=pv, gen=gen)
        toks, lengths = toks.cpu().numpy(), lengths.cpu().numpy()
        results = []
        for i, want in enumerate(captions):
            got = tok.decode([int(x) for x in toks[i][1:lengths[i]]])
            results.append({"want": want, "got": got, "exact": got == want})
            if verbose:
                print(f"[memorize/{tag} {'OK ' if got == want else 'MISS'}] "
                      f"want={want!r} got={got!r}")
        eval_out = evaluate_split(pp, cfg, data_dir, tokenizer=tok, split="test", batch_size=K,
                                  gen=gen, verbose=verbose, device=device)
        return {"captions": results, "exact_matches": sum(r["exact"] for r in results),
                "total": K, "metrics": eval_out["metrics"]}

    def recipe_params_gen(name):
        if name == "bf16":
            return proof_params, GenerationConfig(max_length=max_length, greedy=True)
        with torch.no_grad():
            qbridge = bridge_mod.quantize_decode_params(proof_params["bridge"])
            if name == "int8":
                qlm = gemma2.quantize_params(proof_params["lm"])
                return ({**proof_params, "lm": qlm, "bridge": qbridge},
                        GenerationConfig(max_length=max_length, greedy=True, kv_quant=True))
            qlm = gemma2.quantize_params(proof_params["lm"], parts=("embedding4", "mlp", "attn"))
        # the scale group must divide the tiny FFN width
        group = 16 if cfg.lm.intermediate_size < 256 else 128
        return ({**proof_params, "lm": qlm, "bridge": qbridge},
                GenerationConfig(max_length=max_length, greedy=True, kv_quant=True,
                                 mlp_int4=True, mlp_int4_group=group))

    per_recipe = {}
    for name in dict.fromkeys(recipes):
        per_recipe[name] = score(*recipe_params_gen(name), name)

    head = per_recipe[recipes[0]]
    return {
        **head,  # captions / exact_matches / total / metrics of the FIRST recipe
        "best_val_loss": meta.get("val_loss"),
        "final_train_loss": history["history"][-1]["train_loss"] if history["history"] else None,
        "recipes": per_recipe,
        "model_preset": tc.model_preset,
    }


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(
        prog="vlm-memorize-torch",
        description="train -> checkpoint -> correct captions proof (tiny preset)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device to train and decode on (no fallback)")
    ap.add_argument("--recipes", default="bf16",
                    help="comma list of decode recipes scored on the same trained "
                         "checkpoint: bf16,int8,int4")
    ap.add_argument("--output", default=None, help="write the JSON record here")
    args = ap.parse_args(argv)

    workdir = args.workdir or tempfile.mkdtemp(prefix="vlm-memorize.")
    record = run_proof(workdir, num_epochs=args.epochs, recipes=tuple(args.recipes.split(",")),
                       device=args.device)
    record["device"] = args.device
    line = json.dumps(record)
    print(line)
    if args.output:
        Path(args.output).write_text(line + "\n")
    ok = record["exact_matches"] == record["total"] and record["metrics"]["bleu4"] > 0.99
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
