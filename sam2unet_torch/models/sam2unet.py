"""SAM2-UNet (SAM2UNet.py:128-173): frozen adapter-wrapped Hiera trunk +
RFB neck + U-Net decoder with three heads.

Public layout is NHWC: `forward` takes (B, S, S, 3) and returns
(out, out1, out2), each (B, S, S, 1) logits. The neck and decoder run
NCHW, as the reference does. `up4` is constructed and never called, as in
the reference, so its keys are in the state dict.

The trunk is frozen at construction (`Hiera`), as in the reference
(SAM2UNet.py:146-147). The input is cast to the trunk's
dtype and every layer computes in its input's dtype; the neck's and
decoder's convolutions cast their (fp32 master) weights to it, and
BatchNorm keeps fp32 parameters and statistics (`cast_frozen` makes the
bf16 training model: frozen weights bf16, trainable ones fp32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam2unet_torch.configs import SAM2UNetConfig
from sam2unet_torch.models.hiera import Hiera
from sam2unet_torch.nn.layers import BN_EPS, Conv2d, ConvBN, SyncBatchNorm2d
from sam2unet_torch.ops.resize import resize_nchw


class RFBModified(nn.Module):
    """4-branch receptive field block (SAM2UNet.py:89-125); ConvBN has no
    inner ReLU (the BasicConv2d quirk); final ReLU after the residual."""

    def __init__(self, cin: int, cout: int):
        super().__init__()

        def branch(k: int | None):
            layers = [ConvBN(cin, cout, 1)]
            if k is not None:
                layers += [ConvBN(cout, cout, (1, k), padding=(0, k // 2)),
                           ConvBN(cout, cout, (k, 1), padding=(k // 2, 0)),
                           ConvBN(cout, cout, 3, padding=k, dilation=k)]
            return nn.Sequential(*layers)

        self.branch0 = branch(None)
        self.branch1 = branch(3)
        self.branch2 = branch(5)
        self.branch3 = branch(7)
        self.conv_cat = ConvBN(4 * cout, cout, 3, padding=1)
        self.conv_res = ConvBN(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cat = torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                         self.branch3(x)], dim=1)
        return F.relu(self.conv_cat(cat) + self.conv_res(x))


class DoubleConv(nn.Module):
    """(conv3x3 no-bias -> BN -> ReLU) x 2 (SAM2UNet.py:9-26)."""

    def __init__(self, cin: int, cout: int, mid: int):
        super().__init__()
        self.double_conv = nn.Sequential(
            Conv2d(cin, mid, 3, padding=1, bias=False),
            SyncBatchNorm2d(mid, eps=BN_EPS), nn.ReLU(inplace=True),
            Conv2d(mid, cout, 3, padding=1, bias=False),
            SyncBatchNorm2d(cout, eps=BN_EPS), nn.ReLU(inplace=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


class Up(nn.Module):
    """Bilinear x2 (align_corners=True), pad/crop to the skip's grid,
    concat, DoubleConv (SAM2UNet.py:29-49)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = DoubleConv(cin, cout, cin // 2)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        h1, w1 = x1.shape[2], x1.shape[3]
        x1 = resize_nchw(x1, (2 * h1, 2 * w1), "bilinear", align_corners=True)
        dy = x2.shape[2] - x1.shape[2]
        dx = x2.shape[3] - x1.shape[3]
        if dy or dx:  # negative amounts crop (SAM2UNet.py:44)
            x1 = F.pad(x1, [dx // 2, dx - dx // 2, dy // 2, dy - dy // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class SAM2UNet(nn.Module):
    def __init__(self, cfg: SAM2UNetConfig = SAM2UNetConfig(),
                 remat: bool = False, sp_group=None, sp_degree: int = 1):
        """`remat`: recompute each trunk block's activations in the
        backward (`Hiera`), for bigger batches. `sp_group` / `sp_degree`:
        the trunk's global blocks sequence-parallel over that process group
        (`Hiera`; the JAX model's `sp_axis` / `sp_degree`); the state-dict
        keys are the same. The neck's and decoder's BatchNorms are
        `SyncBatchNorm2d`s: in a train step across ranks they normalise
        over the global batch (the JAX model's `bn_axis`), and otherwise
        they are `nn.BatchNorm2d`s."""
        super().__init__()
        self.cfg = cfg
        self.encoder = Hiera(cfg.trunk, use_adapters=True,
                             adapter_dim=cfg.adapter_dim, remat=remat,
                             sp_group=sp_group, sp_degree=sp_degree)
        ch, r = cfg.trunk.channel_list, cfg.rfb_out
        self.rfb1 = RFBModified(ch[0], r)
        self.rfb2 = RFBModified(ch[1], r)
        self.rfb3 = RFBModified(ch[2], r)
        self.rfb4 = RFBModified(ch[3], r)
        self.up1 = Up(2 * r, r)
        self.up2 = Up(2 * r, r)
        self.up3 = Up(2 * r, r)
        self.up4 = Up(2 * r, r)  # never called (reference parity)
        self.side1 = Conv2d(r, 1, 1)
        self.side2 = Conv2d(r, 1, 1)
        self.head = Conv2d(r, 1, 1)

    def forward(self, x: torch.Tensor):
        x = x.to(self.encoder.pos_embed.dtype)
        f1, f2, f3, f4 = (f.permute(0, 3, 1, 2) for f in self.encoder(x))
        x1, x2 = self.rfb1(f1), self.rfb2(f2)
        x3, x4 = self.rfb3(f3), self.rfb4(f4)

        def up_head(conv: nn.Module, d: torch.Tensor, scale: int):
            s = conv(d)
            s = resize_nchw(s, (scale * s.shape[2], scale * s.shape[3]),
                            "bilinear", align_corners=False)
            return s.permute(0, 2, 3, 1).contiguous()

        d = self.up1(x4, x3)
        out1 = up_head(self.side1, d, 16)
        d = self.up2(d, x2)
        out2 = up_head(self.side2, d, 8)
        d = self.up3(d, x1)
        out = up_head(self.head, d, 4)
        return out, out1, out2


def cast_frozen(model: nn.Module, dtype: torch.dtype) -> None:
    """Cast every parameter that needs no gradient (the frozen trunk) to
    `dtype` in place, once: the bf16 training model keeps its trainable
    parameters, buffers and BatchNorm in fp32."""
    for p in model.parameters():
        if not p.requires_grad:
            p.data = p.data.to(dtype)
