"""The reference's checkpoint policy (train.py:130-149; the JAX package's
sam2unet_tpu/train/checkpoints.py:39-75): a snapshot named by epoch, loss
and IoU whenever the mean IoU beats the best so far, else a rolling
`SAM2-UNet_epoch-latest.pth` every `save_interval` epochs and at the last
epoch. Files are state dicts written with torch.save, which the port's
test CLI loads with strict=True. `save_train_state` / `restore_train_state`
(the JAX package's, checkpoints.py:77-95 there) keep the whole training
state for a true resume: the reference restarts the optimizer."""

from __future__ import annotations

import os
from collections.abc import Callable

import torch
from torch import nn

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


TRAIN_STATE_KEYS = ("model", "optimizer", "epoch", "step")


def save_train_state(path: str, model_state: dict[str, torch.Tensor],
                     optimizer: torch.optim.Optimizer, epoch: int,
                     step: int) -> None:
    """One torch.save file with the fp32 model state (`fp32_state_dict`:
    frozen weights from their fp32 masters, BatchNorm statistics), the
    AdamW moments, and the epochs and steps done. The schedule is a
    function of the epoch and the resuming run's flags (`optim.cosine_lr`)
    and has no state to keep."""
    torch.save({"model": model_state, "optimizer": optimizer.state_dict(),
                "epoch": int(epoch), "step": int(step)}, path)


def restore_train_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer,
                        masters: dict[str, torch.Tensor] | None = None
                        ) -> tuple[int, int]:
    """Load a `save_train_state` file into the model (strict; a bf16 frozen
    weight takes the rounded fp32 value, and `masters`, the fp32 copies the
    checkpoints are written from, take the exact one) and the optimizer.
    Returns (epochs done, steps done)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or set(state) != set(TRAIN_STATE_KEYS):
        raise KeyError(f"{path} is not a train state: expected the entries "
                       f"{TRAIN_STATE_KEYS}")
    model.load_state_dict(state["model"], strict=True)
    for name in masters or {}:
        masters[name] = state["model"][name]
    optimizer.load_state_dict(state["optimizer"])
    return state["epoch"], state["step"]
