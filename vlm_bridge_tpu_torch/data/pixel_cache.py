"""Materialized preprocessed-pixel cache: decode + resize once, stream forever
(the port's own copy of vlm_bridge_tpu.data.pixel_cache: the same files, so a
cache built by either package attaches in both).

JPEG decode + bicubic resize costs milliseconds of host CPU per image, which
on a host with few cores caps the data path below what the fused decode
kernels serve and makes every epoch and every eval pass host-bound. The
reference re-decodes every JPEG on every epoch
(reference: data_loader.py:118-125). Here the preprocessed uint8
[N, 224, 224, 3] tensor is materialized ONCE per split as a `.npy` memmap
sidecar next to `captions.jsonl`; afterwards `VLDataset.load_image` is a
memory-mapped row read (~µs), and loaders stream at memory speed.

Staleness: a meta sidecar records the manifest fingerprint (sha1 of the
ordered image paths) + row count + crop size; `try_attach` refuses a cache
that does not match the live manifest, so a re-transformed dataset can
never serve stale pixels. A crashed build leaves no meta -> never attached.

Build: `vlm-data precache --data-dir D [--split S]` or
`build_pixel_cache(dataset)`.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import List, Optional

import numpy as np

from vlm_bridge_tpu_torch.data.preprocess import CROP_SIZE

CACHE_NAME = "pixels_u8.npy"
META_NAME = "pixels_u8.meta.json"


def manifest_fingerprint(root: Path, samples: List[dict]) -> str:
    """sha1 over (path, size, mtime_ns) of every image: a re-transform that
    rewrites image CONTENT under the same filenames (e.g. a different
    --jpeg-quality) must invalidate the cache, not just manifest edits.
    mtime moves on copy, which at worst forces a rebuild — the safe
    direction."""
    h = hashlib.sha1()
    for rec in samples:
        h.update(rec["image_path"].encode())
        try:
            st = (root / rec["image_path"]).stat()
            h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
        except OSError:
            h.update(b"missing")
        h.update(b"\0")
    return h.hexdigest()


def try_attach(root: Path, samples: List[dict],
               *, crop: int = CROP_SIZE) -> Optional[np.memmap]:
    """Return a read-only memmap over the split's pixel cache, or None if
    absent/stale. Never raises on a bad cache — falls back to JPEG decode."""
    npy, meta_p = root / CACHE_NAME, root / META_NAME
    if not (npy.exists() and meta_p.exists()):
        return None
    try:
        meta = json.loads(meta_p.read_text())
        if (meta.get("n") != len(samples) or meta.get("crop") != crop
                or meta.get("fingerprint") != manifest_fingerprint(
                    root, samples)):
            return None
        arr = np.load(npy, mmap_mode="r")
        if arr.shape != (len(samples), crop, crop, 3) or arr.dtype != np.uint8:
            return None
        return arr
    except Exception:
        return None


def build_pixel_cache(dataset, *, num_workers: int = 4,
                      verbose: bool = True) -> Path:
    """Decode/resize every image of a VLDataset into the split's cache file.

    Writes the data through an on-disk memmap (no N×150KB RAM spike), then
    the meta sidecar LAST so interrupted builds are never attached.
    """
    import os
    from concurrent.futures import ThreadPoolExecutor

    root, samples = dataset.root, dataset.samples
    crop = CROP_SIZE
    npy, meta_p = root / CACHE_NAME, root / META_NAME
    meta_p.unlink(missing_ok=True)  # invalidate any previous cache first
    # build into a temp file + atomic rename: truncating the live .npy in
    # place would SIGBUS (or feed half-written rows to) any process that
    # already attached a memmap over the old inode. The temp name is unique
    # per process (pid) so concurrent builds — two hosts on a shared
    # filesystem, or two jobs started together — each rename their OWN file
    # instead of racing on one path (a shared name made the loser's
    # os.replace hit ENOENT after the winner renamed it away); both write
    # identical bytes, so last-rename-wins is benign.
    tmp = root / f"{CACHE_NAME}.tmp.{os.getpid()}"
    try:
        out = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=np.uint8,
            shape=(len(samples), crop, crop, 3))

        def _one(i: int) -> None:
            out[i] = dataset.decode_image(i)

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for k, _ in enumerate(pool.map(_one, range(len(samples)))):
                if verbose and (k + 1) % 2000 == 0:
                    print(f"  precached {k + 1}/{len(samples)}", flush=True)
        out.flush()
        del out
        os.replace(tmp, npy)
    finally:
        tmp.unlink(missing_ok=True)  # failed build: no orphaned GBs
    meta_p.write_text(json.dumps({
        "n": len(samples), "crop": crop,
        "fingerprint": manifest_fingerprint(root, samples),
    }))
    if verbose:
        mb = npy.stat().st_size / 2**20
        print(f"pixel cache: {len(samples)} images -> {npy} ({mb:.0f} MiB)")
    return npy
