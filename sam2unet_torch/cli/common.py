"""Shared CLI plumbing: device, model construction, strict weight loading,
the reference postprocess."""

from __future__ import annotations

import numpy as np
import torch

from sam2unet_torch.configs import SAM2UNetConfig, hiera_config
from sam2unet_torch.models.sam2unet import SAM2UNet
from sam2unet_torch.ops.resize_np import resize_np


def resolve_device(name: str) -> torch.device:
    """`cuda` (the default of every entry point) must have a card; the CPU
    is used only when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def build_model(model_cfg: str, device: torch.device,
                dtype: torch.dtype = torch.float32) -> SAM2UNet:
    model = SAM2UNet(SAM2UNetConfig(trunk=hiera_config(model_cfg)))
    return model.to(device=device, dtype=dtype).eval()


def load_checkpoint(model: SAM2UNet, path: str) -> None:
    """Strict load of a reference-style `.pth` state dict (an optional
    top-level "model" entry is unwrapped)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    model.load_state_dict(state, strict=True)


def postprocess_prediction(logits_nhwc: np.ndarray,
                           padding: tuple[int, int, int, int], size: int,
                           gt_shape: tuple[int, int]) -> np.ndarray:
    """Reference test postprocess (test.py:66-76): crop the letterbox
    padding -> bilinear resize to GT size -> sigmoid -> min-max -> uint8."""
    left, top, right, bottom = padding
    res = logits_nhwc[0, top: size - bottom, left: size - right, 0]
    res = resize_np(res[None, None], tuple(gt_shape), "bilinear")[0, 0]
    res = 1.0 / (1.0 + np.exp(-res))
    res = (res - res.min()) / (res.max() - res.min() + 1e-8)
    return (res * 255).astype(np.uint8)
