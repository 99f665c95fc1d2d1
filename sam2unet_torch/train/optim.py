"""Optimizer, schedule and the trainable set, after
sam2unet_tpu/train/optim.py (reference train.py:48-54): AdamW (betas
0.9/0.999, eps 1e-8, decoupled weight decay) with the reference's
CosineAnnealingLR, one value per epoch down to eta_min 1e-7, as a function
of the epoch and the run's flags (`cosine_lr`), or of the global step, as
the JAX package's optax schedule is (`cosine_step_lr`, which the train CLI
sets before every step), so that a resumed run needs no schedule state.

The trainable set is the adapters, the neck, the decoder and the heads;
the trunk is frozen (SAM2UNet.py:146-147) and `up4`, built but never
called by the reference, gets no gradient, so AdamW must not see it (its
decoupled weight decay would shrink it every step)."""

from __future__ import annotations

import math

import torch
from torch import nn

ETA_MIN = 1e-7


def is_trainable(name: str) -> bool:
    """True for adapter, neck, decoder and head parameters (by state-dict
    name); the JAX package's `is_trainable` (optim.py:48-59)."""
    parts = name.split(".")
    if parts[0] == "up4":
        return False
    if parts[0] != "encoder":
        return True
    return "prompt_learn" in parts


def trainable_parameters(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    return [(n, p) for n, p in model.named_parameters() if is_trainable(n)]


def make_optimizer(model: nn.Module, lr: float = 1e-3,
                   weight_decay: float = 5e-4) -> torch.optim.AdamW:
    """AdamW over the trainable set."""
    params = [p for _, p in trainable_parameters(model)]
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def cosine_lr(base_lr: float, epoch: int, epochs: int) -> float:
    """The learning rate of 0-based `epoch` in a run of `epochs`:
    CosineAnnealingLR(T_max=epochs, eta_min=ETA_MIN) in closed form."""
    return ETA_MIN + (base_lr - ETA_MIN) * (1 + math.cos(math.pi * epoch / epochs)) / 2


def cosine_step_lr(base_lr: float, step: int, epochs: int,
                   steps_per_epoch: int) -> float:
    """The rate of the update at 0-based global `step` (the JAX package's
    `cosine_epoch_schedule`, optim.py:20-29 there): `cosine_lr` of the
    epoch `step // steps_per_epoch`, held at the last value past
    `epochs`."""
    epoch = min(step // max(steps_per_epoch, 1), epochs)
    return ETA_MIN + (base_lr - ETA_MIN) * (
        1 + math.cos(math.pi * epoch / max(epochs, 1))) / 2


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
