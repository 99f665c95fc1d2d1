"""The reference's checkpoint policy (train.py:130-149; the JAX package's
sam2unet_tpu/train/checkpoints.py:39-75): a snapshot named by epoch, loss
and IoU whenever the mean IoU beats the best so far, else a rolling
`SAM2-UNet_epoch-latest.pth` every `save_interval` epochs and at the last
epoch. Files are state dicts written with torch.save, which the port's
test CLI loads with strict=True. `save_train_state` / `restore_train_state`
(the JAX package's, checkpoints.py:77-95 there) keep the whole training
state for a true resume: the reference restarts the optimizer.

`save_variables`, `restore_variables` and `load_any_checkpoint` are the
JAX package's (checkpoints.py:25-36,90-97 there), on the same Orbax
directories (`interop/orbax.py`, no JAX): variables are the JAX tree, a
nested dict of numpy arrays ({"params", "batch_stats"});
`interop/from_jax.py` converts them from and to the port's state dict. The
policy above keeps writing `.pth` files."""

from __future__ import annotations

import os
from collections.abc import Callable

import numpy as np
import torch
from torch import nn

from sam2unet_torch.interop import orbax
from sam2unet_torch.interop.from_jax import state_dict_to_jax

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


def save_variables(path: str, variables: dict) -> None:
    """Save model variables ({"params", "batch_stats"}, nested dicts of
    arrays) to an Orbax directory, replacing one that is there."""
    orbax.write_tree(path, variables)


def _flat(tree: dict, prefix: tuple = ()) -> dict[tuple, object]:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): v})
    return out


def _like(variables: dict, template: dict) -> dict:
    """`variables` held to `template`: the same leaves and shapes (else
    KeyError / ValueError), each cast to the template leaf's dtype."""
    got, want = _flat(variables), _flat(template)
    if got.keys() != want.keys():
        missing = sorted("/".join(k) for k in want.keys() - got.keys())
        extra = sorted("/".join(k) for k in got.keys() - want.keys())
        raise KeyError(f"checkpoint does not match the template: missing "
                       f"{missing[:5]}, unexpected {extra[:5]}")
    out: dict = {}
    for k, t in want.items():
        t = np.asarray(t)
        v = np.asarray(got[k])
        if v.shape != t.shape:
            raise ValueError(f"{'/'.join(k)}: shape {v.shape} in the "
                             f"checkpoint, {t.shape} in the template")
        node = out
        for p in k[:-1]:
            node = node.setdefault(p, {})
        node[k[-1]] = v.astype(t.dtype, copy=False)
    return out


def restore_variables(path: str, template: dict | None = None) -> dict:
    """The variables of an Orbax directory; with `template`, held to its
    leaves, shapes and dtypes."""
    variables = orbax.read_tree(path)
    return variables if template is None else _like(variables, template)


def load_any_checkpoint(path: str, template: dict | None = None) -> dict:
    """Model variables from an Orbax directory or a torch `.pth`/`.pt`
    state dict (an optional top-level "model" entry unwrapped), converted
    to the JAX tree."""
    if os.path.isdir(path):
        return restore_variables(path, template)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    variables = state_dict_to_jax(state)
    return variables if template is None else _like(variables, template)
