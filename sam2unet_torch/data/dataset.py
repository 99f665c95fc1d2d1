"""EvalDataset (reference TestDataset, dataset.py:405-447): sorted images
and masks, deterministic letterbox with padding metadata, PIL decode."""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np
from PIL import Image

from sam2unet_torch.data.transforms import letterbox, normalize


def _list_pairs(image_root: str, gt_root: str) -> tuple[list[str], list[str]]:
    images = sorted(os.path.join(image_root, f) for f in os.listdir(image_root)
                    if f.endswith((".jpg", ".png")))
    gts = sorted(os.path.join(gt_root, f) for f in os.listdir(gt_root)
                 if f.endswith(".png"))
    return images, gts


def load_rgb(path: str) -> np.ndarray:
    """(3, H, W) float32 in [0, 1]."""
    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


class EvalDataset:
    def __init__(self, image_root: str, gt_root: str, size: int):
        self.images, self.gts = _list_pairs(image_root, gt_root)
        if len(self.images) != len(self.gts):
            raise ValueError(f"image/gt count mismatch: {len(self.images)} vs "
                             f"{len(self.gts)}")
        self.size = size

    @property
    def count(self) -> int:
        return len(self.images)

    def item(self, i: int):
        """(image (1,S,S,3) normalized NHWC, gt (H,W) float, name, padding)."""
        path = self.images[i]
        gt = np.asarray(Image.open(self.gts[i]).convert("L"), np.float32)
        padded, padding = letterbox(load_rgb(path), self.size)
        padded = normalize(padded)
        return padded.transpose(1, 2, 0)[None], gt, os.path.basename(path), padding

    def batches(self, batch_size: int) -> Iterator[dict]:
        """Fixed-shape batches; the tail batch is zero-padded, `valid`
        counts its real samples."""
        for start in range(0, self.count, batch_size):
            idxs = list(range(start, min(start + batch_size, self.count)))
            images = np.zeros((batch_size, self.size, self.size, 3), np.float32)
            paddings, gts, names = [], [], []
            for j, i in enumerate(idxs):
                img, gt, name, padding = self.item(i)
                images[j] = img[0]
                paddings.append(padding)
                gts.append(gt)
                names.append(name)
            yield {"image": images, "padding": paddings, "gt": gts,
                   "name": names, "valid": len(idxs)}
