"""SAM2 input and output transforms on the host, numpy (the port's copy of
the JAX package's `predictors/transforms.py`, sam2/utils/transforms.py:
13-99): square bilinear antialiased resize and ImageNet normalisation,
coordinates and boxes to the model's resolution, and the host mask
postprocess: hole filling (background components of at most
`max_hole_area` pixels become foreground), sprinkle removal (foreground
components of at most `max_sprinkle_area` pixels become background), both
through the host connected components (`ops/connected_components.py`),
then a bilinear resize to the original size. A negative area, as
`scripts/bench_sam2.py` sets to force the host postprocess, fills nothing.
"""

from __future__ import annotations

import numpy as np

from sam2unet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from sam2unet_torch.ops.connected_components import label_components_native
from sam2unet_torch.ops.resize_np import resize_np


class SAM2Transforms:
    def __init__(self, resolution: int, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0):
        self.resolution = resolution
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area

    @property
    def device_postprocess(self) -> bool:
        """Whether the predictor may postprocess on the device: nothing to
        fill and no host path asked for (both areas 0)."""
        return self.max_hole_area == 0 and self.max_sprinkle_area == 0

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8/float [0, 255] -> (res, res, 3) float32 normalised."""
        chw = (np.asarray(image, np.float32) / 255.0).transpose(2, 0, 1)
        chw = resize_np(chw, (self.resolution, self.resolution), "bilinear",
                        antialias=True)
        chw = (chw - IMAGENET_MEAN[:, None, None]) / IMAGENET_STD[:, None, None]
        return chw.transpose(1, 2, 0)

    def forward_batch(self, images: list[np.ndarray]) -> np.ndarray:
        return np.stack([self(im) for im in images], axis=0)

    def transform_coords(self, coords: np.ndarray, normalize: bool = False,
                         orig_hw=None) -> np.ndarray:
        coords = np.asarray(coords, np.float32).copy()
        if normalize:
            h, w = orig_hw
            coords[..., 0] = coords[..., 0] / w
            coords[..., 1] = coords[..., 1] / h
        return coords * self.resolution

    def transform_boxes(self, boxes: np.ndarray, normalize: bool = False,
                        orig_hw=None) -> np.ndarray:
        return self.transform_coords(np.asarray(boxes).reshape(-1, 2, 2),
                                     normalize, orig_hw)

    def postprocess_masks(self, masks: np.ndarray, orig_hw) -> np.ndarray:
        """(B, M, h, w) logits -> (B, M, H, W) at the original size, holes
        and sprinkles filled first (transforms.py:74-99)."""
        masks = np.asarray(masks, np.float32)
        b, m, h, w = masks.shape
        flat = masks.reshape(b * m, 1, h, w)
        t = self.mask_threshold
        if self.max_hole_area > 0:
            labels, areas = label_components_native(flat <= t)
            flat = np.where((labels > 0) & (areas <= self.max_hole_area),
                            t + 10.0, flat)
        if self.max_sprinkle_area > 0:
            labels, areas = label_components_native(flat > t)
            flat = np.where((labels > 0) & (areas <= self.max_sprinkle_area),
                            t - 10.0, flat)
        return resize_np(flat.reshape(b, m, h, w), tuple(orig_hw), "bilinear")
