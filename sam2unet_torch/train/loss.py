"""Structure loss (weighted BCE + weighted IoU) summed over the three
heads, the port's copy of sam2unet_tpu/train/loss.py (reference
train.py:21-29).

The reference's legacy `reduce="none"` resolves to reduction='mean', so
its BCE term is a scalar mean and the per-pixel weighting cancels; that is
the default here too. The intended per-pixel weighted BCE is behind
`weighted_bce=True`. Inputs are NHWC with one channel; everything runs in
fp32 whatever the model's compute dtype."""

from __future__ import annotations

import torch

from sam2unet_torch.ops.pooling import avg_pool2d_same


def _bce_with_logits(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise, in torch's numerically stable form."""
    return (torch.clamp(pred, min=0) - pred * target
            + torch.log1p(torch.exp(-pred.abs())))


def structure_loss(pred: torch.Tensor, mask: torch.Tensor,
                   weighted_bce: bool = False) -> torch.Tensor:
    """pred, mask: (B, H, W, 1). Returns a scalar."""
    pred, mask = pred.float(), mask.float()
    weit = 1.0 + 5.0 * (avg_pool2d_same(mask, 31) - mask).abs()
    bce = _bce_with_logits(pred, mask)
    if weighted_bce:
        wbce = (weit * bce).sum(dim=(1, 2, 3)) / weit.sum(dim=(1, 2, 3))
    else:
        wbce = bce.mean()
    p = torch.sigmoid(pred)
    inter = (p * mask * weit).sum(dim=(1, 2, 3))
    union = ((p + mask) * weit).sum(dim=(1, 2, 3))
    wiou = 1.0 - (inter + 1.0) / (union - inter + 1.0)
    return (wbce + wiou).mean()


def multi_head_loss(preds, mask: torch.Tensor,
                    weighted_bce: bool = False) -> torch.Tensor:
    """Sum of the structure losses of (out, out1, out2), train.py:76-79."""
    return sum(structure_loss(p, mask, weighted_bce) for p in preds)
