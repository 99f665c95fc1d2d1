"""Pooling on NHWC tensors: the 2x2 max q-pool of Hiera stage changes
(hieradet.py:110)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NHWC max pool, no padding (ceil_mode=False)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride)
    return y.permute(0, 2, 3, 1).contiguous()
