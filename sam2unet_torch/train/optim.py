"""Optimizer, schedule and the trainable set, after
sam2unet_tpu/train/optim.py (reference train.py:48-54): AdamW (betas
0.9/0.999, eps 1e-8, decoupled weight decay) with CosineAnnealingLR stepped
once per epoch down to eta_min 1e-7.

The trainable set is the adapters, the neck, the decoder and the heads;
the trunk is frozen (SAM2UNet.py:146-147) and `up4`, built but never
called by the reference, gets no gradient, so AdamW must not see it (its
decoupled weight decay would shrink it every step)."""

from __future__ import annotations

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
                   weight_decay: float = 5e-4, epochs: int = 50):
    """(AdamW over the trainable set, its per-epoch cosine schedule)."""
    params = [p for _, p in trainable_parameters(model)]
    opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=epochs,
                                                       eta_min=ETA_MIN)
    return opt, sched
