"""SAM2 model factory: `build_sam2` and `build_sam2_image_predictor`, the
port's copies of the JAX package's (sam2unet_tpu/build_sam.py:20-119).

The configuration comes from the registry (`sam2_hiera_s`, the default,
and the other names of `configs.registry`) or from explicit `sam2_config`
/ `trunk_cfg` dataclasses, which win; with `apply_postprocessing` and no
explicit `sam2_config` the mask decoder gets the reference's stability
overrides (build_sam.py:25-31: dynamic multimask via stability, delta
0.05, threshold 0.98). A YAML config path and `hydra_overrides_extra` need
the reference's config composition (`configs/hydra_compat.py`), which the
port has not copied yet: they raise, naming the ROADMAP.md item.

`ckpt_path` loads an official SAM2 checkpoint (`sam2_hiera_*.pt`, the
reference's key layout, an optional top-level "model" entry): every key of
the image path must be there with its shape, and every other key must lie
under one of `VIDEO_PATH_PREFIXES`; anything else raises. The model is
built on `device` (the card unless the caller asks for the CPU) and cast
to `dtype` once, in eval mode.
"""

from __future__ import annotations

import dataclasses

import torch

from sam2unet_torch.cli.common import resolve_device
from sam2unet_torch.configs import HieraConfig, hiera_config
from sam2unet_torch.models.sam2_base import (
    VIDEO_PATH_PREFIXES,
    SAM2Base,
    SAM2Config,
)

HYDRA_ITEM = ("ROADMAP.md queue 1 item 11: configs/hydra_compat.py is not "
              "ported yet")


def load_sam2_checkpoint(model: SAM2Base, path: str) -> None:
    """Strict load of an official SAM2 `.pt` into the image path (see the
    module docstring)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    stray = sorted(k for k in set(state) - set(want)
                   if not k.startswith(VIDEO_PATH_PREFIXES))
    shapes = sorted(k for k in set(want) & set(state)
                    if tuple(want[k].shape) != tuple(state[k].shape))
    if missing or stray or shapes:
        raise KeyError(f"sam2 checkpoint {path} does not match the image "
                       f"path: missing {missing[:5]}, unexpected {stray[:5]}, "
                       f"shape mismatch {shapes[:5]}")
    model.load_state_dict({k: state[k] for k in want}, strict=True)


def build_sam2(config_name: str = "sam2_hiera_s", ckpt_path: str | None = None,
               *, sam2_config: SAM2Config | None = None,
               trunk_cfg: HieraConfig | None = None,
               device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.float32,
               hydra_overrides_extra=(),
               apply_postprocessing: bool = True) -> SAM2Base:
    if config_name.endswith((".yaml", ".yml")) or hydra_overrides_extra:
        raise NotImplementedError(
            f"build_sam2({config_name!r}, hydra_overrides_extra="
            f"{list(hydra_overrides_extra)}): {HYDRA_ITEM}")
    trunk = trunk_cfg or hiera_config(config_name)
    cfg = sam2_config
    if cfg is None:
        cfg = SAM2Config()
        if apply_postprocessing:
            cfg = dataclasses.replace(
                cfg, dynamic_multimask_via_stability=True,
                dynamic_multimask_stability_delta=0.05,
                dynamic_multimask_stability_thresh=0.98)
    dev = resolve_device(device)
    model = SAM2Base(trunk, cfg)
    if ckpt_path:
        load_sam2_checkpoint(model, ckpt_path)
    return model.to(device=dev, dtype=dtype).eval()


def build_sam2_image_predictor(config_name: str = "sam2_hiera_s",
                               ckpt_path: str | None = None, **kw):
    from sam2unet_torch.predictors.image_predictor import SAM2ImagePredictor

    return SAM2ImagePredictor(build_sam2(config_name, ckpt_path, **kw))
