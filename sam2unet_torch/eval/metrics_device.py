"""Batched semantic metrics on the device, the port's copy of
sam2unet_tpu/eval/metrics_device.py: per-image IoU and Dice over padded
batches with validity masking, so the per-epoch evaluation reads back a
few numbers per batch."""

from __future__ import annotations

import torch


def batched_semantic_metrics(pred_probs: torch.Tensor, gt: torch.Tensor,
                             valid: torch.Tensor,
                             pixel_valid: torch.Tensor | None = None,
                             threshold: float = 0.1,
                             gt_threshold: float | None = None):
    """pred_probs (B, H, W) in [0, 1]; gt (B, H, W) in [0, 255] (or bool);
    valid (B,) bool; pixel_valid (B, H, W) the un-padded region. Returns
    per-image (iou (B,), dice (B,)), zero for invalid entries.

    With `pixel_valid` the prediction is binarized as the reference
    evaluation does (train.py:109-112 and eval.py): per-image min-max over
    the un-padded region, scale to 255, truncate, threshold at
    255 * threshold; without it the probabilities are thresholded raw."""
    if pixel_valid is not None:
        pf = pred_probs.float()
        inf = torch.tensor(float("inf"), device=pf.device)
        pmin = torch.where(pixel_valid, pf, inf).amin(dim=(1, 2), keepdim=True)
        pmax = torch.where(pixel_valid, pf, -inf).amax(dim=(1, 2), keepdim=True)
        norm = (pf - pmin) / (pmax - pmin + 1e-8)
        p = (torch.floor(norm * 255.0) > 255.0 * threshold) & pixel_valid
    else:
        p = pred_probs > threshold
    if gt_threshold is None:
        gt_threshold = 0.5 if gt.dtype == torch.bool else 255.0 * threshold
    g = gt > gt_threshold
    inter = (p & g).sum(dim=(1, 2)).float()
    union = (p | g).sum(dim=(1, 2)).float()
    sums = (p.sum(dim=(1, 2)) + g.sum(dim=(1, 2))).float()
    zero = torch.zeros_like(inter)
    iou = torch.where(union > 0, inter / union.clamp(min=1), zero)
    dice = torch.where(sums > 0, 2 * inter / sums.clamp(min=1), zero)
    v = valid.float()
    return iou * v, dice * v
