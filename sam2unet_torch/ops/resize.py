"""Device resizes as the reference calls them (`F.interpolate`).

bicubic (align_corners=False) for the Hiera pos-embed (hieradet.py:271),
bilinear align_corners=True in the decoder's `Up` (SAM2UNet.py:35), and
bilinear align_corners=False at the three heads (SAM2UNet.py:168-172).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_nchw(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode=method,
                         align_corners=align_corners)
