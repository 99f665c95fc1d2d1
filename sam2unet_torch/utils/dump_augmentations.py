"""Visual-inspection dump of the train augmentation pipeline
(`data/dataset.py::TrainDataset`): the port's counterpart of the JAX
package's scripts/dump_augmentations.py (the reference dataset.py
__main__, dataset.py:450-488). Writes N augmented pairs, `<i>.jpg` (the
image with the normalisation undone) and `label_<i>.png`, the i-th drawn
with seed i, to --out. Host only: it runs no model.

    python -m sam2unet_torch.utils.dump_augmentations --image_path imgs/ \
        --mask_path masks/ [--out result] [--size 960] [--count 100]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from sam2unet_torch.data.dataset import TrainDataset
from sam2unet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def dump(image_path: str, mask_path: str, out: str, size: int,
         count: int) -> int:
    """Write the pairs; returns how many."""
    os.makedirs(out, exist_ok=True)
    ds = TrainDataset(image_path, mask_path, size)
    n = min(count, len(ds))
    for i in range(n):
        img, lbl = ds.sample(i % len(ds), rng_seed=i)
        # undo the normalisation for viewing (dataset.py:468-471)
        img = img * IMAGENET_STD[:, None, None] + IMAGENET_MEAN[:, None, None]
        img = np.clip(img.transpose(1, 2, 0), 0, 1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            os.path.join(out, f"{i}.jpg"))
        Image.fromarray((np.clip(lbl[0], 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(out, f"label_{i}.png"))
        print(i, img.shape, float(img.max()), float(lbl.max()))
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--image_path", required=True)
    p.add_argument("--mask_path", required=True)
    p.add_argument("--out", default="result")
    p.add_argument("--size", type=int, default=960)
    p.add_argument("--count", type=int, default=100)
    a = p.parse_args(argv)
    return dump(a.image_path, a.mask_path, a.out, a.size, a.count)


if __name__ == "__main__":
    main()
