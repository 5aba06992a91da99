"""GroundCap dataset tooling: download/explore, transform, split (the port's
own copy of vlm_bridge_tpu.data.groundcap, pure Python / numpy / PIL; held equal
to it by tests/test_torch_eval.py).

Re-implements the reference data build (same on-disk layout, so datasets
prepared by either stack are interchangeable):

- `load_ground_cap` — HF hub download of daniel3303/groundcap
  (reference: data_pipeline/load_and_explore.py:13-41)
- `transform_and_save_images` — concat train+test, contiguous 80/2/18 index
  split, JPEG q95 per split dir, grounding-tag strip
  (reference: data_pipeline/transform_full_dataset.py:16-149)
- `split_and_organize_files` — per-split captions.jsonl manifests
  (reference: data_pipeline/split_and_save.py:15-113)
- `make_synthetic_dataset` — offline generator with the identical layout for
  hermetic tests and zero-egress environments (no reference equivalent).

Output layout:
  <out>/{train,val,test}/images/<id>.jpg
  <out>/{train,val,test}/captions.jsonl   lines: {"image_path", "caption", "original_id"}
"""

from __future__ import annotations

import json
import re
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional, Tuple

SPLIT_FRACS = {"train": (0.0, 0.8), "val": (0.8, 0.82), "test": (0.82, 1.0)}
_TAG_RE = re.compile(r"<[^>]+>")
_WS_RE = re.compile(r"\s+")


def clean_caption(raw: str) -> str:
    """Strip <gdo/gda/gdl ...> grounding tags (and any HTML), squeeze
    whitespace (reference _extract_clean_caption semantics)."""
    return _WS_RE.sub(" ", _TAG_RE.sub("", raw)).strip()


def split_bounds(total: int) -> Dict[str, Tuple[int, int]]:
    """Contiguous, non-shuffled index split: 80/2/18
    (reference transform_full_dataset.py:47-55)."""
    train_end = int(0.8 * total)
    val_end = int(0.82 * total)
    return {"train": (0, train_end), "val": (train_end, val_end),
            "test": (val_end, total)}


def split_of_index(i: int, bounds: Dict[str, Tuple[int, int]]) -> str:
    for name, (lo, hi) in bounds.items():
        if lo <= i < hi:
            return name
    raise ValueError(f"index {i} outside all splits")


def load_ground_cap(cache_dir: Optional[str] = None):
    """Download/load daniel3303/groundcap via HF datasets (needs network)."""
    from datasets import load_dataset

    return load_dataset("daniel3303/groundcap", cache_dir=cache_dir)


def inspect_dataset_structure(ds) -> Dict[str, object]:
    """Split sizes + a sample's fields/caption-tag stats (console report)."""
    info: Dict[str, object] = {"splits": {k: len(v) for k, v in ds.items()}}
    first_split = next(iter(ds.values()))
    if len(first_split):
        sample = first_split[0]
        info["fields"] = list(sample.keys())
        if "caption" in sample:
            raw = sample["caption"]
            info["sample_caption_raw"] = raw[:200]
            info["sample_caption_clean"] = clean_caption(raw)[:200]
            info["grounding_tags"] = {
                t: len(re.findall(f"<{t}", raw)) for t in ("gdo", "gda", "gdl")}
    for k, v in info.items():
        print(f"  {k}: {v}")
    return info


def transform_and_save_images(
    dataset,
    output_dir: str | Path,
    *,
    jpeg_quality: int = 95,
    num_workers: int = 4,
) -> List[dict]:
    """Save each sample's image as JPEG into its split dir + collect manifests.

    dataset: any sequence of {"id", "image" (PIL), "caption"} — the
    concatenated GroundCap train+test in production.
    """
    output_dir = Path(output_dir)
    bounds = split_bounds(len(dataset))
    for split in SPLIT_FRACS:
        (output_dir / split / "images").mkdir(parents=True, exist_ok=True)

    records: List[Optional[dict]] = [None] * len(dataset)

    def process(i: int) -> None:
        sample = dataset[i]
        split = split_of_index(i, bounds)
        original_id = str(sample["id"])
        rel = f"images/{original_id}.jpg"
        img = sample["image"]
        if img.mode != "RGB":
            img = img.convert("RGB")
        img.save(output_dir / split / rel, "JPEG", quality=jpeg_quality)
        records[i] = {
            "split": split,
            "image_path": rel,
            "caption": clean_caption(sample["caption"]),
            "original_id": original_id,
        }

    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        list(pool.map(process, range(len(dataset))))
    return [r for r in records if r is not None]


def split_and_organize_files(records: List[dict], output_dir: str | Path) -> Dict[str, int]:
    """Write per-split captions.jsonl manifests; returns split sizes."""
    output_dir = Path(output_dir)
    counts = {s: 0 for s in SPLIT_FRACS}
    handles = {
        s: open(output_dir / s / "captions.jsonl", "w") for s in SPLIT_FRACS}
    try:
        for r in records:
            s = r["split"]
            handles[s].write(json.dumps({
                "image_path": r["image_path"],
                "caption": r["caption"],
                "original_id": r["original_id"],
            }) + "\n")
            counts[s] += 1
    finally:
        for h in handles.values():
            h.close()
    return counts


def get_transform_stats(dataset, records: List[dict]) -> Dict[str, object]:
    """Before/after transform statistics (reference get_transform_stats,
    transform_full_dataset.py:152-188): counts, average caption lengths, and
    a sample pair showing the grounding-tag strip."""
    raw_lengths = [len(dataset[i]["caption"]) for i in range(len(dataset))]
    clean_lengths = [len(r["caption"]) for r in records]
    return {
        "original_count": len(dataset),
        "transformed_count": len(records),
        "avg_original_caption_length":
            sum(raw_lengths) / max(len(raw_lengths), 1),
        "avg_transformed_caption_length":
            sum(clean_lengths) / max(len(clean_lengths), 1),
        "sample_original": dataset[0]["caption"][:200] if len(dataset) else "",
        "sample_transformed": records[0]["caption"][:200] if records else "",
    }


def get_split_stats(output_dir: str | Path) -> Dict[str, dict]:
    """Per-split sample counts + caption length stats."""
    output_dir = Path(output_dir)
    stats = {}
    for split in SPLIT_FRACS:
        manifest = output_dir / split / "captions.jsonl"
        if not manifest.exists():
            continue
        lengths = []
        with open(manifest) as f:
            for line in f:
                try:
                    lengths.append(len(json.loads(line)["caption"]))
                except (json.JSONDecodeError, KeyError):
                    continue
        stats[split] = {
            "num_samples": len(lengths),
            "avg_caption_chars": sum(lengths) / max(len(lengths), 1),
        }
    return stats


def make_synthetic_dataset(
    output_dir: str | Path, *, num_samples: int = 32, image_size: int = 224,
    seed: int = 0,
) -> Dict[str, int]:
    """Hermetic GroundCap-layout dataset (random JPEG images + captions)."""
    import numpy as np
    from PIL import Image

    words = ("a man walks the dog near red house and tall tree under blue sky "
             "with small car on wet road").split()

    class _Synth:
        def __len__(self):
            return num_samples

        def __getitem__(self, i):
            # per-index generator: np.random.Generator is NOT thread-safe,
            # and the transform pool calls this concurrently — deriving from
            # (seed, i) keeps output identical under any scheduling
            rng = np.random.default_rng((seed, i))
            arr = rng.integers(0, 256, (image_size, image_size, 3), np.uint8)
            n = 4 + int(rng.integers(0, 8))
            cap = " ".join(rng.choice(words, n)) + "."
            # sprinkle grounding tags so clean_caption is exercised
            cap = f'<gdo id="0">{cap.split()[0]}</gdo> ' + " ".join(cap.split()[1:])
            return {"id": f"synth{i:05d}",
                    "image": Image.fromarray(arr), "caption": cap}

    ds = _Synth()
    records = transform_and_save_images(ds, output_dir, num_workers=2)
    return split_and_organize_files(records, output_dir)
