"""Pooling on NHWC tensors: the 2x2 max q-pool of Hiera stage changes
(hieradet.py:110) and the 31x31 stride-1 average pool of the structure
loss (train.py:22)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """NHWC max pool, no padding (ceil_mode=False)."""
    y = F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride)
    return y.permute(0, 2, 3, 1).contiguous()


def avg_pool2d_same(x: torch.Tensor, kernel: int) -> torch.Tensor:
    """NHWC stride-1 average pool with symmetric zero padding, dividing by
    kernel**2 everywhere (count_include_pad=True, as the structure loss
    uses it: k=31, s=1, p=15)."""
    if kernel % 2 != 1:
        raise ValueError("same-shape average pool needs an odd kernel")
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, stride=1,
                     padding=kernel // 2, count_include_pad=True)
    return y.permute(0, 2, 3, 1)
