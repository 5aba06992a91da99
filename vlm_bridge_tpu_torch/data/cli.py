"""`vlm-data-torch` CLI: dataset download / transform / split / inspect (port
of vlm_bridge_tpu_torch.data.cli, over the port's own data modules).

Subcommand parity with the reference (data_pipeline/cli.py:18-94):
  explore-dataset, transform --output-dir, inspect-loader --data-dir
plus `synth` (offline synthetic dataset for hermetic runs), `stats` and
`precache`. explore-dataset and transform download GroundCap and need the
network; the others run offline. Nothing here touches a device.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vlm-data-torch", description="GroundCap data pipeline (PyTorch port)")
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("explore-dataset", help="download GroundCap and print structure")

    p_tr = sub.add_parser("transform",
                          help="download, transform, split, save")
    p_tr.add_argument("--output-dir", default="data/groundcap")
    p_tr.add_argument("--jpeg-quality", type=int, default=95)
    p_tr.add_argument("--num-workers", type=int, default=4)

    p_in = sub.add_parser("inspect-loader",
                          help="inspect prepared batches")
    p_in.add_argument("--data-dir", default="data/groundcap")
    p_in.add_argument("--split", default="train")
    p_in.add_argument("--batch-size", type=int, default=4)
    p_in.add_argument("--tokenizer-path", default=None)

    p_sy = sub.add_parser("synth",
                          help="generate an offline synthetic dataset")
    p_sy.add_argument("--output-dir", default="data/groundcap-synth")
    p_sy.add_argument("--num-samples", type=int, default=32)
    p_sy.add_argument("--image-size", type=int, default=224)
    p_sy.add_argument("--seed", type=int, default=0)

    p_st = sub.add_parser("stats",
                          help="print split statistics")
    p_st.add_argument("--data-dir", default="data/groundcap")

    p_pc = sub.add_parser(
        "precache",
        help="materialize the preprocessed uint8 pixel cache per split "
             "(decode+resize once; loaders then stream at memory speed)")
    p_pc.add_argument("--data-dir", default="data/groundcap")
    p_pc.add_argument("--split", default=None,
                      help="one split (default: every split present)")
    p_pc.add_argument("--num-workers", type=int, default=4)
    p_pc.add_argument("--force", action="store_true",
                      help="rebuild even if a fresh cache exists")

    args = parser.parse_args(argv)

    from vlm_bridge_tpu_torch.data import groundcap

    if args.command == "explore-dataset":
        ds = groundcap.load_ground_cap()
        groundcap.inspect_dataset_structure(ds)

    elif args.command == "transform":
        from datasets import concatenate_datasets

        t0 = time.time()
        ds = groundcap.load_ground_cap()
        merged = concatenate_datasets([ds["train"], ds["test"]])
        print(f"transforming {len(merged)} samples -> {args.output_dir}")
        records = groundcap.transform_and_save_images(
            merged, args.output_dir, jpeg_quality=args.jpeg_quality,
            num_workers=args.num_workers)
        counts = groundcap.split_and_organize_files(records, args.output_dir)
        for k, v in groundcap.get_transform_stats(merged, records).items():
            print(f"  {k}: {v}")
        print(f"done in {time.time() - t0:.1f}s: {counts}")

    elif args.command == "inspect-loader":
        from vlm_bridge_tpu_torch.data.loader import BatchLoader, VLDataset, inspect_data_loader
        from vlm_bridge_tpu_torch.data.tokenizer import get_tokenizer

        loader = BatchLoader(
            VLDataset(args.data_dir, args.split), batch_size=args.batch_size,
            tokenizer=get_tokenizer(args.tokenizer_path))
        inspect_data_loader(loader)

    elif args.command == "synth":
        counts = groundcap.make_synthetic_dataset(
            args.output_dir, num_samples=args.num_samples,
            image_size=args.image_size, seed=args.seed)
        print(f"synthetic dataset at {args.output_dir}: {counts}")

    elif args.command == "stats":
        for split, st in groundcap.get_split_stats(args.data_dir).items():
            print(f"{split}: {st}")

    elif args.command == "precache":
        from pathlib import Path

        from vlm_bridge_tpu_torch.data.loader import VLDataset
        from vlm_bridge_tpu_torch.data.pixel_cache import build_pixel_cache

        splits = ([args.split] if args.split else
                  [p.parent.name for p in
                   sorted(Path(args.data_dir).glob("*/captions.jsonl"))])
        for split in splits:
            t0 = time.time()
            ds = VLDataset(args.data_dir, split)
            if ds.pixels is not None and not args.force:
                print(f"  [{split}] cache fresh ({len(ds)} images) — "
                      f"skipping (--force rebuilds)")
                continue
            ds.pixels = None  # build from the JPEG path
            build_pixel_cache(ds, num_workers=args.num_workers)
            print(f"  [{split}] {len(ds)} images in {time.time() - t0:.1f}s")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
