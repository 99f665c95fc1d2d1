"""SAM2 model factory: `build_sam2`, `build_sam2_image_predictor` and
`build_sam2_video_predictor`, the port's copies of the JAX package's
(sam2unet_tpu/build_sam.py:20-141).

The configuration comes from the registry (`sam2_hiera_s`, the default,
and the other names of `configs.registry`) or from explicit `sam2_config`
/ `trunk_cfg` dataclasses, which win; with `apply_postprocessing` and no
explicit `sam2_config` the mask decoder gets the reference's stability
overrides (build_sam.py:25-31: dynamic multimask via stability, delta
0.05, threshold 0.98), and the video predictor also binarises the masks
of prompted frames for the memory encoder and fills holes of up to 8
pixels (build_sam.py:55-66 of the reference). A YAML config path and
`hydra_overrides_extra` need the reference's config composition
(`configs/hydra_compat.py`), which the port has not copied yet: they
raise, naming the ROADMAP.md item.

`ckpt_path` loads an official SAM2 checkpoint (`sam2_hiera_*.pt`, the
reference's key layout, an optional top-level "model" entry) strictly:
every key of the model with its shape, and no other; anything else
raises. The model is built on `device` (the card unless the caller asks
for the CPU) and cast to `dtype` once, in eval mode.
"""

from __future__ import annotations

import dataclasses

import torch

from sam2unet_torch.cli.common import resolve_device
from sam2unet_torch.configs import HieraConfig, hiera_config
from sam2unet_torch.models.sam2_base import SAM2Base, SAM2Config

HYDRA_ITEM = ("ROADMAP.md queue 1 item 11: configs/hydra_compat.py is not "
              "ported yet")


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


def postprocessing_config(video: bool = False) -> SAM2Config:
    """SAM2Config with the postprocessing overrides of the reference's
    build functions: the mask decoder's stability fallback, and for video
    the binarised masks of prompted frames in the memory encoder."""
    cfg = dataclasses.replace(SAM2Config(), dynamic_multimask_via_stability=True,
                              dynamic_multimask_stability_delta=0.05,
                              dynamic_multimask_stability_thresh=0.98)
    if video:
        cfg = dataclasses.replace(cfg, binarize_mask_from_pts_for_mem_enc=True)
    return cfg


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
        cfg = postprocessing_config() if apply_postprocessing else SAM2Config()
    dev = resolve_device(device)
    model = SAM2Base(trunk, cfg)
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

    if kw.get("apply_postprocessing", True):
        if kw.get("sam2_config") is None:
            kw["sam2_config"] = postprocessing_config(video=True)
        if fill_hole_area is None:
            fill_hole_area = 8
    return SAM2VideoPredictor(build_sam2(config_name, ckpt_path, **kw),
                              fill_hole_area=fill_hole_area or 0)
