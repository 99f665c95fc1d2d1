"""SAM2 model factory: `build_sam2`, `build_sam2_image_predictor` and
`build_sam2_video_predictor`, the port's copies of the JAX package's
(sam2unet_tpu/build_sam.py:20-141).

The configuration comes from a registry name (`sam2_hiera_s`, the default,
and the other names of `configs.registry`) or from a path to a
reference-shaped YAML config (the port's copies are in
`configs_yaml/`), with the reference's `++key.path=value` override
strings in `hydra_overrides_extra` (composed by
`configs_yaml/hydra_compat.py`: `++model.image_size=512` builds the model
of `SAM2Config(image_size=512)`). With `apply_postprocessing` the mask
decoder gets the reference's stability overrides (build_sam.py:25-31:
dynamic multimask via stability, delta 0.05, threshold 0.98), and the
video predictor also binarises the masks of prompted frames for the memory
encoder and fills holes of up to 8 pixels (build_sam.py:55-66 of the
reference). Explicit `sam2_config` / `trunk_cfg` dataclasses win over the
YAML and every override.

`ckpt_path` loads an official SAM2 checkpoint (`sam2_hiera_*.pt`, the
reference's key layout, an optional top-level "model" entry) strictly:
every key of the model with its shape, and no other; anything else
raises. The model is built on `device` (the card unless the caller asks
for the CPU) and cast to `dtype` once, in eval mode.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from sam2unet_torch.cli.common import resolve_device
from sam2unet_torch.configs import HieraConfig, hiera_config
from sam2unet_torch.configs_yaml import hydra_compat
from sam2unet_torch.models.sam2_base import SAM2Base, SAM2Config

# the reference's postprocessing overrides (build_sam.py:25-31, :55-66)
POSTPROCESSING = (
    "++model.sam_mask_decoder_extra_args.dynamic_multimask_via_stability=true",
    "++model.sam_mask_decoder_extra_args.dynamic_multimask_stability_delta=0.05",
    "++model.sam_mask_decoder_extra_args.dynamic_multimask_stability_thresh=0.98",
)
VIDEO_POSTPROCESSING = ("++model.binarize_mask_from_pts_for_mem_enc=true",)


def load_sam2_checkpoint(model: SAM2Base, path: str) -> None:
    """Strict load of an official SAM2 `.pt` (see the module docstring)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and isinstance(state.get("model"), dict):
        state = state["model"]
    want = model.state_dict()
    missing = sorted(set(want) - set(state))
    stray = sorted(set(state) - set(want))
    shapes = sorted(k for k in set(want) & set(state)
                    if tuple(want[k].shape) != tuple(state[k].shape))
    if missing or stray or shapes:
        raise KeyError(f"sam2 checkpoint {path} does not match the "
                       f"model: missing {missing[:5]}, unexpected {stray[:5]}, "
                       f"shape mismatch {shapes[:5]}")
    model.load_state_dict({k: state[k] for k in want}, strict=True)


def build_configs(config_name: str = "sam2_hiera_s",
                  hydra_overrides_extra=(),
                  apply_postprocessing: bool = True
                  ) -> tuple[HieraConfig, SAM2Config]:
    """(trunk, SAM2 config) of a registry name or a YAML path with the
    overrides, as the JAX package's `build_sam2` composes them."""
    overrides = list(hydra_overrides_extra)
    if apply_postprocessing:
        overrides += POSTPROCESSING
    if config_name.endswith((".yaml", ".yml")) and os.path.exists(config_name):
        tree = hydra_compat.compose(config_name, overrides)
    else:
        tree = hydra_compat.merge_overrides({}, overrides)
        tree.setdefault("model", {}).setdefault("image_encoder", {})[
            "trunk"] = dataclasses.asdict(hiera_config(config_name))
    return hydra_compat.configs_from_tree(tree)


def build_sam2(config_name: str = "sam2_hiera_s", ckpt_path: str | None = None,
               *, sam2_config: SAM2Config | None = None,
               trunk_cfg: HieraConfig | None = None,
               device: str | torch.device = "cuda",
               dtype: torch.dtype = torch.float32,
               hydra_overrides_extra=(),
               apply_postprocessing: bool = True) -> SAM2Base:
    yaml_trunk, yaml_cfg = build_configs(config_name, hydra_overrides_extra,
                                         apply_postprocessing)
    dev = resolve_device(device)
    model = SAM2Base(trunk_cfg or yaml_trunk, sam2_config or yaml_cfg)
    if ckpt_path:
        load_sam2_checkpoint(model, ckpt_path)
    return model.to(device=dev, dtype=dtype).eval()


def build_sam2_image_predictor(config_name: str = "sam2_hiera_s",
                               ckpt_path: str | None = None, **kw):
    from sam2unet_torch.predictors.image_predictor import SAM2ImagePredictor

    return SAM2ImagePredictor(build_sam2(config_name, ckpt_path, **kw))


def build_sam2_video_predictor(config_name: str = "sam2_hiera_s",
                               ckpt_path: str | None = None, *,
                               fill_hole_area: int | None = None, **kw):
    """The video predictor with the reference's video postprocessing
    (build_sam.py:55-66): binarised prompted masks for the memory encoder
    and hole filling of up to 8 pixels, both off with
    `apply_postprocessing=False`; an explicit `sam2_config` wins over the
    first, an explicit `fill_hole_area` over the second."""
    from sam2unet_torch.predictors.video_predictor import SAM2VideoPredictor

    overrides = list(kw.pop("hydra_overrides_extra", ()))
    if kw.get("apply_postprocessing", True):
        overrides += VIDEO_POSTPROCESSING
        if fill_hole_area is None:
            fill_hole_area = 8
    model = build_sam2(config_name, ckpt_path,
                       hydra_overrides_extra=overrides, **kw)
    return SAM2VideoPredictor(model, fill_hole_area=fill_hole_area or 0)
