"""SAM2's image encoder: the Hiera trunk (no adapters) and the FPN neck
(sam2/modeling/backbones/image_encoder.py:14-133; the JAX package's
`models/fpn.py`). NHWC: 1x1 laterals to d_model (as products over the
channels), a nearest x2 top-down sum on the levels of
`fpn_top_down_levels`, and a sine encoding per level.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from sam2unet_torch.configs import HieraConfig
from sam2unet_torch.models.hiera import Hiera
from sam2unet_torch.models.position_encoding import PositionEmbeddingSine


class FpnNeck(nn.Module):
    def __init__(self, d_model: int = 256,
                 backbone_channel_list: tuple[int, ...] = (768, 384, 192, 96),
                 fpn_top_down_levels: tuple[int, ...] = (2, 3)):
        super().__init__()
        self.position_encoding = PositionEmbeddingSine(d_model)
        # the reference's Sequential(conv=Conv2d(c, d_model, 1)) per level
        # (keys convs.N.conv.*), applied as a product over the channels
        self.convs = nn.ModuleList(
            nn.Sequential(OrderedDict(conv=nn.Conv2d(c, d_model, 1)))
            for c in backbone_channel_list)
        self.fpn_top_down_levels = tuple(fpn_top_down_levels)

    def forward(self, xs: list[torch.Tensor]):
        """xs: the trunk's maps fine to coarse (NHWC). Returns (features,
        pos), both fine to coarse."""
        n = len(self.convs) - 1
        out: list = [None] * (n + 1)
        pos: list = [None] * (n + 1)
        prev = None
        for i in range(n, -1, -1):
            conv = self.convs[n - i].conv
            lateral = F.linear(xs[i], conv.weight.flatten(1), conv.bias)
            if i in self.fpn_top_down_levels and prev is not None:
                td = F.interpolate(prev.float().permute(0, 3, 1, 2),
                                   scale_factor=2.0, mode="nearest")
                prev = lateral + td.permute(0, 2, 3, 1).to(lateral.dtype)
            else:
                prev = lateral
            out[i] = prev
            pos[i] = self.position_encoding(prev)
        return out, pos


class ImageEncoder(nn.Module):
    """Trunk -> neck; `scalp` drops the coarsest level(s)
    (image_encoder.py:14-42)."""

    def __init__(self, trunk_cfg: HieraConfig, d_model: int = 256,
                 scalp: int = 1):
        super().__init__()
        self.trunk = Hiera(trunk_cfg, use_adapters=False)
        self.neck = FpnNeck(d_model, tuple(reversed(trunk_cfg.channel_list)))
        self.scalp = scalp

    def forward(self, x: torch.Tensor) -> dict:
        features, pos = self.neck(self.trunk(x))
        if self.scalp > 0:
            features, pos = features[:-self.scalp], pos[:-self.scalp]
        return {"vision_features": features[-1], "vision_pos_enc": pos,
                "backbone_fpn": features}
