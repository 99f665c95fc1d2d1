"""The reference's checkpoint policy (train.py:130-149; the JAX package's
sam2unet_tpu/train/checkpoints.py:39-75): a snapshot named by epoch, loss
and IoU whenever the mean IoU beats the best so far, else a rolling
`SAM2-UNet_epoch-latest.pth` every `save_interval` epochs and at the last
epoch. Files are state dicts written with torch.save, which the port's
test CLI loads with strict=True. `save_jax_train_state` /
`restore_train_state` (the JAX package's `save_train_state` /
`restore_train_state`, checkpoints.py:77-95 there) keep the whole training
state for a true resume (the reference restarts the optimizer), as the JAX
package's own train state: an Orbax directory of its `TrainState` (`step`,
the flax-flattened `trainable` and `frozen` parameters, `batch_stats`, and
optax's adamw chain `(ScaleByAdamState(count, mu, nu), EmptyState(),
ScaleByScheduleState(count))`), which the JAX package's
`restore_train_state` restores too. `restore_train_state` also reads the
single torch.save file this package wrote before (`{"model", "optimizer",
"step"}` and an `epoch` it ignores), so older runs still resume.
Parameters and statistics go through `interop/from_jax.py`'s layouts, and
so do the moments: `mu` / `nu` of each trainable leaf are AdamW's
`exp_avg` / `exp_avg_sq` of the parameter, `count` its `step`.

optax's `adamw` (sam2unet_tpu/train/optim.py:33-49) and torch's AdamW are
one update: both keep mu <- b1 mu + (1 - b1) g and nu <- b2 nu + (1 - b2)
g^2 (torch by lerp and addcmul), correct both by 1 - b^t with t the count
after the increment, add eps outside the square root of the corrected nu
(optax's eps_root is 0), and decay decoupled by lr * wd * p with the
scheduled lr and the parameter before the step (torch scales p by
1 - lr wd first, optax adds -lr wd p to the update: the same sum). They
differ only in the rounding of that arithmetic, and in the rate's
precision: optax evaluates the schedule in fp32, torch takes the Python
float.

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
from sam2unet_torch.interop.from_jax import jax_to_state_dict, state_dict_to_jax
from sam2unet_torch.train.optim import is_trainable, trainable_parameters

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


# the entries of the older single-file train state (an `epoch` beside them
# is read by nothing)
TRAIN_STATE_KEYS = ("model", "optimizer", "step")


def restore_train_state(path: str, model: nn.Module,
                        optimizer: torch.optim.Optimizer,
                        masters: dict[str, torch.Tensor] | None = None) -> int:
    """Load a train state into the model (strict; a bf16 frozen weight
    takes the rounded fp32 value, and `masters`, the fp32 copies the
    checkpoints are written from, take the exact one) and the optimizer
    (made by `optim.make_optimizer` for this model): a directory of the
    JAX package's `TrainState`, or this package's older train-state file.
    Returns the steps done (the schedule is a function of the global step
    and the resuming run's flags, `optim.cosine_step_lr`, and has no state
    to keep)."""
    if os.path.isdir(path):
        model_state, opt_state, step = _from_jax_train_state(path, model,
                                                             optimizer)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if not isinstance(state, dict) or set(state) - {"epoch"} != set(
                TRAIN_STATE_KEYS):
            raise KeyError(f"{path} is not a train state: expected the "
                           f"entries {TRAIN_STATE_KEYS}")
        model_state, opt_state, step = (state["model"], state["optimizer"],
                                        state["step"])
    model.load_state_dict(model_state, strict=True)
    for name in masters or {}:
        masters[name] = model_state[name]
    optimizer.load_state_dict(opt_state)
    return int(step)


def jax_train_state_path(snapshot: str) -> str:
    """Where the JAX train state of `snapshot` goes: the JAX CLI's name,
    `<snapshot without .pth>_train_state`."""
    return snapshot.removesuffix(".pth") + "_train_state"


JAX_TRAIN_STATE_KEYS = ("step", "trainable", "frozen", "batch_stats",
                        "opt_state")


def _unflat(flat: dict[tuple, object]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def _from_jax_train_state(path: str, model: nn.Module,
                          optimizer: torch.optim.Optimizer
                          ) -> tuple[dict, dict, int]:
    """(model state dict, AdamW state dict, step) of a JAX `TrainState`
    directory, for `model` and `optimizer`, over `trainable_parameters`."""
    tree = orbax.read_tree(path)
    if set(tree) != set(JAX_TRAIN_STATE_KEYS):
        raise KeyError(f"{path} is not a JAX train state: expected the "
                       f"entries {JAX_TRAIN_STATE_KEYS}, found {sorted(tree)}")
    adam, sched = tree["opt_state"].get(0), tree["opt_state"].get(2)
    if (not isinstance(adam, dict) or set(adam) != {"count", "mu", "nu"}
            or not isinstance(sched, dict) or set(sched) != {"count"}):
        raise KeyError(f"{path}: opt_state is not optax's adamw chain "
                       "(ScaleByAdamState, EmptyState, ScaleByScheduleState)")
    step = int(tree["step"])
    if int(adam["count"]) != step or int(sched["count"]) != step:
        raise ValueError(f"{path}: step {step}, but the optimizer counts "
                         f"{int(adam['count'])} and {int(sched['count'])}")
    variables = {"params": _unflat({**tree["trainable"], **tree["frozen"]}),
                 "batch_stats": tree["batch_stats"]}
    model_state = jax_to_state_dict(variables, model.state_dict().keys())
    names = [n for n, _ in trainable_parameters(model)]
    mu = jax_to_state_dict({"params": _unflat(adam["mu"])}, names)
    nu = jax_to_state_dict({"params": _unflat(adam["nu"])}, names)
    opt_state = {
        "state": {i: {"step": torch.tensor(float(step), dtype=torch.float32),
                      "exp_avg": mu[n], "exp_avg_sq": nu[n]}
                  for i, n in enumerate(names)},
        "param_groups": optimizer.state_dict()["param_groups"]}
    return model_state, opt_state, step


def save_jax_train_state(path: str, model_state: dict[str, torch.Tensor],
                         model: nn.Module, optimizer: torch.optim.Optimizer,
                         step: int) -> None:
    """Write the JAX package's `TrainState` of this run to the Orbax
    directory `path`: the fp32 `model_state` (`fp32_state_dict`) split into
    the trainable and frozen leaves, the BatchNorm statistics, AdamW's
    moments as optax's, and `step` as the step and both optimizer counts
    (AdamW's step must equal it)."""
    variables = state_dict_to_jax(model_state)
    flat = _flat(variables["params"])
    named = trainable_parameters(model)
    if [p for _, p in named] != [p for g in optimizer.param_groups
                                 for p in g["params"]]:
        raise ValueError("the optimizer is not over the model's trainable "
                         "parameters in their order")
    moments = {}
    for slot in ("exp_avg", "exp_avg_sq"):
        sd = {}
        for name, p in named:
            st = optimizer.state.get(p, {})
            if st and int(st["step"]) != step:
                raise ValueError(f"{name}: AdamW's step {int(st['step'])} is "
                                 f"not the run's {step}")
            sd[name] = st[slot] if st else torch.zeros_like(p)
        moments[slot] = _flat(state_dict_to_jax(sd)["params"])
    count = np.asarray(step, np.int32)
    orbax.write_tree(path, {
        "step": count,
        "trainable": {k: v for k, v in flat.items()
                      if is_trainable(".".join(k))},
        "frozen": {k: v for k, v in flat.items()
                   if not is_trainable(".".join(k))},
        "batch_stats": variables.get("batch_stats", {}),
        "opt_state": {0: {"count": count, "mu": moments["exp_avg"],
                          "nu": moments["exp_avg_sq"]},
                      1: None, 2: {"count": count}}})


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
