"""Image preprocessing (port of vlm_bridge_tpu.data.preprocess).

Host side: PIL decode, shortest-edge resize (bicubic) and centre crop, as
the DINOv2 image processor does. Device side: uint8 -> ImageNet-normalized
tensor in torch, so only uint8 pixels cross to the device. PIL is imported
inside the host function: the serving machine may not have it.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
RESIZE_EDGE = 256
CROP_SIZE = 224


def host_resize_crop(img, *, crop: int = CROP_SIZE, edge: int = RESIZE_EDGE) -> np.ndarray:
    """PIL image -> uint8 [crop, crop, 3] (RGB, resized + center-cropped)."""
    from PIL import Image

    if img.mode != "RGB":
        img = img.convert("RGB")
    w, h = img.size
    if w <= h:
        nw, nh = edge, max(1, round(h * edge / w))
    else:
        nh, nw = edge, max(1, round(w * edge / h))
    img = img.resize((nw, nh), Image.BICUBIC)
    left = (nw - crop) // 2
    top = (nh - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    return np.asarray(img, np.uint8)


def normalize_on_device(pixels_u8: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """[B, H, W, 3] uint8 -> normalized `dtype` tensor on the same device."""
    mean = torch.tensor(IMAGE_MEAN, dtype=torch.float32, device=pixels_u8.device) * 255.0
    std = torch.tensor(IMAGE_STD, dtype=torch.float32, device=pixels_u8.device) * 255.0
    return ((pixels_u8.float() - mean) / std).to(dtype)


def pad_to_batch(x: np.ndarray, batch_size: int) -> np.ndarray:
    """Pad a partial batch to batch_size by repeating row 0 (callers slice
    results back to the real count)."""
    if x.shape[0] >= batch_size:
        return x
    reps = np.repeat(x[:1], batch_size - x.shape[0], axis=0)
    return np.concatenate([x, reps], axis=0)
