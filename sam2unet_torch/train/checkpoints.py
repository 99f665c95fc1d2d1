"""The reference's checkpoint policy (train.py:130-149; the JAX package's
sam2unet_tpu/train/checkpoints.py:39-75): a snapshot named by epoch, loss
and IoU whenever the mean IoU beats the best so far, else a rolling
`SAM2-UNet_epoch-latest.pth` every `save_interval` epochs and at the last
epoch. Files are state dicts written with torch.save, which the port's
test CLI loads with strict=True."""

from __future__ import annotations

import os
from collections.abc import Callable

import torch

LATEST_NAME = "SAM2-UNet_epoch-latest.pth"


def best_checkpoint_name(epoch: int, loss: float, iou: float) -> str:
    return f"SAM2-UNet_epoch-{epoch}_loss-{loss:.3f}_iou-{iou:.3f}.pth"


class CheckpointPolicy:
    """Best-mIoU gating plus the periodic latest snapshot."""

    def __init__(self, save_path: str, base_mean_iou: float,
                 save_interval: int, total_epochs: int):
        self.save_path = save_path
        self.best = base_mean_iou
        self.interval = save_interval
        self.total = total_epochs
        os.makedirs(save_path, exist_ok=True)

    def maybe_save(self, epoch1: int, loss: float, mean_iou: float,
                   state_dict: Callable[[], dict]) -> str | None:
        """epoch1 is 1-based; `state_dict()` is called only when a file is
        written. Returns the saved path or None."""
        if mean_iou > self.best:
            self.best = mean_iou
            out = os.path.join(self.save_path,
                               best_checkpoint_name(epoch1, loss, mean_iou))
            torch.save(state_dict(), out)
            print("Saving Snapshot best:", out)
            return out
        if epoch1 % self.interval == 0 or epoch1 == self.total:
            out = os.path.join(self.save_path, LATEST_NAME)
            torch.save(state_dict(), out)
            print("Saving Snapshot:", out)
            return out
        return None
