"""Inputs made from the seed, the same for every seed in size and shape:
pools of uint8 images (what a loader hands over after decoding and
cropping: tinted noise, `images`), and training batches of ragged captions padded to one bucket.
A cell's traffic file gives the numbers; nothing here names a cell."""

from __future__ import annotations

import torch

# ImageNet normalization, as the port's loader applies it on the device
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


def stream_seed(seed: int, stream: int) -> int:
    """Seeds of the input streams, apart from the weights' (weights.tower_seed)."""
    return (int(seed) * 8 + 5 + stream) % (1 << 63)


def _gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


def images(g: torch.Generator, shape: tuple, device) -> torch.Tensor:
    """uint8 images [..., H, W, 3]: each a tint of its own (a colour drawn
    per image) with noise of a contrast of its own around it, so that
    images differ as photographs do in colour and texture, and not only in
    their noise."""
    lead = shape[:-3]
    tint = torch.rand((*lead, 1, 1, 3), generator=g, device=device) * 255.0
    contrast = torch.rand((*lead, 1, 1, 1), generator=g, device=device) * 0.8 + 0.1
    noise = torch.rand(shape, generator=g, device=device) - 0.5
    return torch.clamp(tint + contrast * noise * 255.0, 0.0, 255.0).to(torch.uint8)


def image_pool(seed: int, batches: int, batch: int, size: int, device) -> torch.Tensor:
    """[batches, batch, size, size, 3] images (`images`) drawn on `device`,
    then held in pinned host memory: the pixels a batch hands to the port."""
    pool = images(_gen(seed, 0, device), (batches, batch, size, size, 3), device)
    host = torch.empty(pool.shape, dtype=torch.uint8, pin_memory=device.type == "cuda")
    host.copy_(pool)
    return host


def normalize(pixels_u8: torch.Tensor, dtype) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> ImageNet-normalized `dtype` on the same device."""
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=pixels_u8.device) * 255.0
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=pixels_u8.device) * 255.0
    return ((pixels_u8.float() - mean) / std).to(dtype)


def caption_lengths(batches: int, batch: int, seq: int, shortest: int, seed: int) -> torch.Tensor:
    """[batches, batch] caption lengths: every batch holds one of `seq`
    (it fills the bucket), the others are spread evenly over
    [shortest, seq] and dealt out by the seed, so each seed trains on the
    same set of lengths in another order."""
    n = batches * (batch - 1)
    spread = torch.round(torch.linspace(shortest, seq, n)).to(torch.int64)
    g = torch.Generator()
    g.manual_seed(stream_seed(seed, 1))
    spread = spread[torch.randperm(n, generator=g)].reshape(batches, batch - 1)
    return torch.cat([torch.full((batches, 1), seq, dtype=torch.int64), spread], dim=1)


def train_pool(seed: int, batches: int, batch: int, seq: int, shortest: int, size: int,
               vocab: int, device) -> list:
    """`batches` training batches of uint8 images and ragged captions (ids
    in [3, vocab), right-padded with 0 to `seq`), in pinned host memory as
    the trainer's loader hands them over."""
    g = _gen(seed, 2, device)
    lens = caption_lengths(batches, batch, seq, shortest, seed)
    pix = images(g, (batches, batch, size, size, 3), device)
    ids = torch.randint(3, vocab, (batches, batch, seq), generator=g, device=device)
    mask = (torch.arange(seq, device=device)[None, None, :] < lens.to(device)[..., None]).int()
    ids = torch.where(mask > 0, ids, torch.zeros_like(ids))
    pin = device.type == "cuda"
    out = []
    for b in range(batches):
        out.append({k: v[b].cpu().pin_memory() if pin else v[b].cpu()
                    for k, v in (("pixel_values", pix), ("input_ids", ids), ("attn_mask", mask))})
    return out


def to_device(batch: dict, device) -> dict:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
