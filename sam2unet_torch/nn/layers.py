"""Building blocks with the reference's torch module names.

  - GELU is the exact erf form; LayerNorm eps is 1e-6 in the trunk and
    BatchNorm eps 1e-5 in the neck and decoder.
  - `ConvBN` is the reference's BasicConv2d, whose forward skips its
    defined ReLU (SAM2UNet.py:83-86): conv (no bias) + BN, no activation.
  - `Conv2d` computes in its input's dtype: the fp32 master weights of the
    neck and decoder are cast to bf16 inside the graph under bf16 compute.
    BatchNorm takes bf16 activations with fp32 parameters and statistics.
  - `SyncBatchNorm2d` normalises a train-mode batch split over ranks with
    the global batch's moments (flax `BatchNorm(axis_name=...)`).
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-6
BN_EPS = 1e-5


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def layer_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in fp32, cast back to x's dtype (the
    pre-norm every fused kernel computes on chip)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + LN_EPS) * weight.float() + bias.float()
    return y.to(x.dtype)


def linear_f32(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """x @ weight.T (+ bias) accumulated and returned in fp32 (the
    `preferred_element_type=float32` products of the reference forms)."""
    y = x.float() @ weight.float().t()
    return y if bias is None else y + bias.float()


class Conv2d(nn.Conv2d):
    """nn.Conv2d in the input's dtype (same parameters and keys)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class SyncBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d over the global batch of a data-parallel step, the
    counterpart of flax `BatchNorm(axis_name=bn_axis)` (sam2unet_tpu/nn/
    layers.py:42,64). In train mode across ranks, each rank all-reduces its
    per-channel sum, sum of squares and count (`torch.distributed.nn.
    functional.all_reduce`, whose backward all-reduces the cotangent, so
    the gradient reaches every rank's input) and normalises with the global
    mean and biased variance E[x^2] - E[x]^2 in fp32, as flax does; the
    running statistics move with momentum 0.1 toward the global mean and
    the global variance corrected by n/(n-1) over the global count
    (torch's convention, as `nn.BatchNorm2d`'s). The output takes the
    input's dtype. The ranks are those of `group`, the data group of the
    mesh (`parallel/mesh.py`; None, the default, is every rank): on a
    (data, model) mesh the model axis's ranks hold the same rows, and an
    all-reduce over them would count each row once per rank of the model
    axis. The moments and the gradients survive that (the count doubles
    with the sums); the running variance's n / (n - 1) does not. In eval
    mode, for one rank or with no process group it is `nn.BatchNorm2d`,
    whose state-dict names it keeps. (torch's own `nn.SyncBatchNorm`
    refuses CPU tensors.)"""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and dist.is_available() and dist.is_initialized()
                and dist.get_world_size(self.group) > 1):
            return super().forward(x)
        c = x.shape[1]
        xf = x.float()
        local = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)),
                           xf.new_full((1,), x.numel() // c)])
        with warnings.catch_warnings():
            # deprecated in favour of functional collectives that carry no
            # gradient
            warnings.simplefilter("ignore", FutureWarning)
            total = dist_nn.all_reduce(local, group=self.group)
        count = total[2 * c]
        mean = total[:c] / count
        var = (total[c: 2 * c] / count - mean * mean).clamp(min=0)
        scale = self.weight.float() * torch.rsqrt(var + self.eps)
        shift = self.bias.float() - mean * scale
        with torch.no_grad():
            # the count stays on the device: no host sync in the step
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(mean.detach(), alpha=m)
            self.running_var.mul_(1 - m).add_(
                var.detach() * (count / (count - 1)), alpha=m)
            self.num_batches_tracked.add_(1)
        return (xf * scale[:, None, None] + shift[:, None, None]).to(x.dtype)


class ConvBN(nn.Module):
    """Conv (no bias) + BatchNorm, NO activation (BasicConv2d quirk)."""

    def __init__(self, cin: int, cout: int, kernel, padding=0, dilation=1):
        super().__init__()
        self.conv = Conv2d(cin, cout, kernel, padding=padding,
                           dilation=dilation, bias=False)
        self.bn = SyncBatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class MLP(nn.Module):
    """Linear stack with `layers.{i}` names (sam2_utils.MLP:108-132):
    `activation` (ReLU by default; GELU in Hiera's block tails) between
    the layers, optionally a sigmoid on the output. Hiera's blocks read
    `layers` and run K1, whose plain version computes this forward."""

    def __init__(self, dim: int, hidden: int, out: int, num_layers: int = 2,
                 activation=F.relu, sigmoid_output: bool = False):
        super().__init__()
        dims = [dim] + [hidden] * (num_layers - 1) + [out]
        self.layers = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.activation, self.sigmoid_output = activation, sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return torch.sigmoid(x) if self.sigmoid_output else x


class LayerNorm2d(nn.Module):
    """LayerNorm over the channels of an NCHW tensor (sam2_utils.py
    LayerNorm2d, eps 1e-6), statistics in fp32, output in x's dtype."""

    def __init__(self, channels: int, eps: float = LN_EPS):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        w, b = self.weight.float(), self.bias.float()
        return (y * w[:, None, None] + b[:, None, None]).to(x.dtype)
