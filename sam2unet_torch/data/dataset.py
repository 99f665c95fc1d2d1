"""Datasets (host side): the port's own copies of the JAX package's
TrainDataset and EvalDataset (sam2unet_tpu/data/dataset.py; reference
FullDataset dataset.py:288-333 and TestDataset dataset.py:405-447).

Sorted .jpg/.png images and .png masks. JPEGs decode through the native
loader (`data/native_loader.py`, libjpeg) where it builds and is not turned
off (SAM2UNET_NO_NATIVE_LOADER=1), else through PIL, as the JAX package's
datasets do (dataset.py:47-66, :147-159 there); the eval items take its
fused letterbox and normalization too. Train samples are
augmented with a per-sample seed derived from (dataset seed, epoch, index)
and collated into fixed-shape NHWC batches by a thread pool feeding a
bounded queue; a ragged last batch is wrap-filled with real samples and
`valid` counts them. The eval batches are letterboxed with their padding
metadata.
"""

from __future__ import annotations

import os
import queue
import threading
from collections.abc import Iterator
from dataclasses import dataclass

import numpy as np
from PIL import Image

from sam2unet_torch.data import native_loader
from sam2unet_torch.data.transforms import (
    TrainAugment,
    letterbox,
    letterbox_nearest,
    normalize,
)


def _list_pairs(image_root: str, gt_root: str) -> tuple[list[str], list[str]]:
    images = sorted(os.path.join(image_root, f) for f in os.listdir(image_root)
                    if f.endswith((".jpg", ".png")))
    gts = sorted(os.path.join(gt_root, f) for f in os.listdir(gt_root)
                 if f.endswith(".png"))
    return images, gts


def load_rgb(path: str) -> np.ndarray:
    """(3, H, W) float32 in [0, 1]."""
    if path.endswith(".jpg") and native_loader.enabled():
        rgb = native_loader.decode_jpeg(path)  # the pixels PIL gives
        if rgb is not None:
            return rgb.astype(np.float32).transpose(2, 0, 1) / 255.0
    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    return np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0


def load_gray(path: str) -> np.ndarray:
    """(1, H, W) float32 in [0, 1]."""
    with open(path, "rb") as f:
        img = Image.open(f).convert("L")
    return np.asarray(img, np.float32)[None] / 255.0


@dataclass
class Batch:
    image: np.ndarray  # (B, H, W, 3) normalized
    label: np.ndarray  # (B, H, W, 1) in {0, 1}
    valid: int         # real samples in the global batch (the rest repeat them)


class TrainDataset:
    def __init__(self, image_root: str, gt_root: str, size: int, seed: int = 0):
        self.images, self.gts = _list_pairs(image_root, gt_root)
        if len(self.images) != len(self.gts):
            raise ValueError(f"image/mask count mismatch: {len(self.images)} "
                             f"vs {len(self.gts)}")
        self.size = size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.images)

    def sample(self, idx: int, rng_seed: int) -> tuple[np.ndarray, np.ndarray]:
        aug = TrainAugment(self.size, seed=rng_seed)
        return aug(load_rgb(self.images[idx]), load_gray(self.gts[idx]))

    def epoch(self, batch_size: int, epoch: int = 0, shuffle: bool = True,
              num_workers: int = 8, drop_last: bool = False,
              rows: slice | None = None) -> Iterator[Batch]:
        """The epoch's global batches of `batch_size`, or with `rows` only
        those rows of each (a data-parallel rank's, `parallel/mesh.py`):
        each sample's augmentation is seeded by (seed, epoch, index), so a
        rank's rows are those of the whole batch, bit for bit."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(self.seed + epoch).shuffle(order)
        if drop_last:
            order = order[: (len(order) // batch_size) * batch_size]

        def produce(idx: int):
            seed = self.seed * 1_000_003 + epoch * 65_537 + int(idx)
            return self.sample(int(idx), rng_seed=seed)

        yield from _batched_prefetch(order, produce, batch_size, self.size,
                                     num_workers, rows)


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
        name = os.path.basename(path)
        if path.endswith(".jpg") and native_loader.enabled():
            rgb = native_loader.decode_jpeg(path)
            if rgb is not None:
                hwc, padding = native_loader.letterbox_norm(rgb, self.size)
                return hwc[None], gt, name, padding
        padded, padding = letterbox(load_rgb(path), self.size)
        padded = normalize(padded)
        return padded.transpose(1, 2, 0)[None], gt, name, padding

    def batches(self, batch_size: int, letterbox_gt: bool = False) -> Iterator[dict]:
        """Fixed-shape batches; the tail batch is zero-padded, `valid`
        counts its real samples. letterbox_gt adds "gt_letterboxed", the GT
        letterboxed to model resolution (nearest), for device metrics."""
        for start in range(0, self.count, batch_size):
            idxs = list(range(start, min(start + batch_size, self.count)))
            images = np.zeros((batch_size, self.size, self.size, 3), np.float32)
            gt_lb = np.zeros((batch_size, self.size, self.size), np.float32)
            paddings, gts, names = [], [], []
            for j, i in enumerate(idxs):
                img, gt, name, padding = self.item(i)
                images[j] = img[0]
                paddings.append(padding)
                gts.append(gt)
                names.append(name)
                if letterbox_gt:
                    gt_lb[j] = letterbox_nearest(gt[None], self.size)[0]
            out = {"image": images, "padding": paddings, "gt": gts,
                   "name": names, "valid": len(idxs)}
            if letterbox_gt:
                out["gt_letterboxed"] = gt_lb
            yield out


def _batched_prefetch(order, produce, batch_size, size, num_workers,
                      rows: slice | None = None):
    """Thread-pool sample production feeding a bounded batch queue: batches
    of `batch_size`, a short tail wrap-filled with its own samples, or only
    their `rows`; `valid` counts the whole batch's real samples. A failure
    in a worker reaches the consumer; an abandoned generator stops the
    producer."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(order)
    picked = slice(None) if rows is None else rows
    out_q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                out_q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            with ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
                for start in range(0, n, batch_size):
                    if stop.is_set():
                        return
                    chunk = order[start: start + batch_size]
                    b = len(chunk)
                    # row j holds sample j % b (the tail's wrap-fill)
                    take = [j % b for j in range(batch_size)[picked]]
                    made = dict(zip(sorted(set(take)), pool.map(
                        produce, [chunk[t] for t in sorted(set(take))])))
                    images = np.zeros((len(take), size, size, 3), np.float32)
                    labels = np.zeros((len(take), size, size, 1), np.float32)
                    for j, t in enumerate(take):
                        images[j] = made[t][0].transpose(1, 2, 0)
                        labels[j] = made[t][1].transpose(1, 2, 0)
                    if not put(Batch(images, labels, valid=b)):
                        return
            put(None)
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = out_q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        t.join()
