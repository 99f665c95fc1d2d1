"""Host-side eval transforms (numpy, CHW float32 in [0, 1])."""

from __future__ import annotations

import numpy as np

from sam2unet_torch.ops.resize_np import resize_np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    return (img - mean[:, None, None]) / std[:, None, None]


def letterbox(img: np.ndarray, size: int, method: str = "bilinear",
              antialias: bool = True
              ) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Resize the longest side to `size`, center-pad to square with zeros.
    Returns (padded (C, size, size), (left, top, right, bottom))."""
    h, w = img.shape[-2:]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_np(img, (nh, nw), method, antialias=antialias)
    pad_h, pad_w = size - nh, size - nw
    top, left = pad_h // 2, pad_w // 2
    bottom, right = pad_h - top, pad_w - left
    out = np.zeros((img.shape[0], size, size), np.float32)
    out[:, top: top + nh, left: left + nw] = resized
    return out, (left, top, right, bottom)
