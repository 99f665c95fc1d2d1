"""Shared CLI plumbing: device, model construction, strict weight loading
(a SAM2 trunk .pt, a SAM2-UNet .pth), the reference postprocess."""

from __future__ import annotations

import numpy as np
import torch

from sam2unet_torch.configs import SAM2UNetConfig, hiera_config
from sam2unet_torch.models.sam2unet import SAM2UNet
from sam2unet_torch.ops.resize_np import resize_np


def resolve_device(name: str | torch.device) -> torch.device:
    """`cuda` (the default of every entry point) must have a card; the CPU
    is used only when asked for."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA was requested but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")
    return dev


def build_model(model_cfg: str, device: torch.device,
                dtype: torch.dtype = torch.float32,
                remat: bool = False) -> SAM2UNet:
    model = SAM2UNet(SAM2UNetConfig(trunk=hiera_config(model_cfg)),
                     remat=remat)
    return model.to(device=device, dtype=dtype).eval()


def load_checkpoint(model: SAM2UNet, path: str) -> None:
    """Strict load of a reference-style `.pth` state dict (an optional
    top-level "model" entry is unwrapped)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    model.load_state_dict(state, strict=True)


def sam2_trunk_state(path: str) -> dict[str, torch.Tensor]:
    """An official sam2_hiera_*.pt's `image_encoder.trunk.*` tensors under
    this package's keys: `encoder.` in front, and each block's own keys
    inside the adapter wrapper (`blocks.N.` -> `blocks.N.block.`), the JAX
    package's `load_sam2_trunk` rules (interop/torch_convert.py:243-257)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    prefix = "image_encoder.trunk."
    out = {}
    for k, v in state.items():
        if not k.startswith(prefix):
            continue
        parts = k[len(prefix):].split(".")
        if parts[0] == "blocks":
            parts = parts[:2] + ["block"] + parts[2:]
        out["encoder." + ".".join(parts)] = v
    if not out:
        raise ValueError(f"no image_encoder.trunk.* keys found in {path}")
    return out


def load_weights(model: SAM2UNet, hiera_path: str = "",
                 checkpoint: str = "") -> None:
    """The reference loading contract (train.py:42-46): an optional SAM2
    trunk, strict over the trunk's keys and shapes (every encoder key but
    the adapters'), then an optional strict SAM2-UNet checkpoint."""
    if hiera_path:
        trunk = sam2_trunk_state(hiera_path)
        want = {k: v for k, v in model.state_dict().items()
                if k.startswith("encoder.") and "prompt_learn" not in k.split(".")}
        missing, extra = sorted(set(want) - set(trunk)), sorted(set(trunk) - set(want))
        shapes = sorted(k for k in set(want) & set(trunk)
                        if tuple(want[k].shape) != tuple(trunk[k].shape))
        if missing or extra or shapes:
            raise KeyError(f"sam2 trunk {hiera_path} does not match "
                           f"{type(model.encoder).__name__}: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}, shape "
                           f"mismatch {shapes[:5]}")
        model.load_state_dict(trunk, strict=False)
    if checkpoint:
        load_checkpoint(model, checkpoint)


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
