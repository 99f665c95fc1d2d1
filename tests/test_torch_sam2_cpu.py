"""The port's SAM2 image path against the JAX package's, on the CPU in
fp32: `forward_image` (FPN levels and position encodings), the prompt
encoder, `forward_sam_heads`' 7-tuple, `use_mask_as_output` and the image
predictor end to end, at the JAX tests' tiny config (TINY_SAM2 + HIERA_TEST
at 64 px, tests/test_predictors.py) and at a narrow trunk with hiera_s's
geometry at 1024 px (grids 256/128/64/32, windows 8/4/14/7, a 4096-token
global block). Also the route of every block of sam2_hiera_s at 1024
against the JAX package's gates, build_sam2, the transforms' hole and
sprinkle filling and the converter (strict both ways, the official key
layout, video keys included).

Weights: the JAX package's `build_sam2` initialises them, zero leaves get
seeded noise, and `interop/from_jax.py` moves them across (strict). The JAX
side runs its XLA forms on the CPU. Tolerance: fp32 on both sides, sums in
other orders through the trunk, neck and two-way transformer: every tensor
within 2e-5 of its max magnitude (measured at most ~3e-6); binary masks
agree except at pixels whose logit lies within 1e-4 of the threshold.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_model_cpu import _perturb
from test_torch_model_960_cpu import _route_of_each_block

import sam2unet_torch.models.hiera as port_hiera
from sam2unet_torch import build_sam as port_build
from sam2unet_torch.configs import HIERA_S as PORT_HIERA_S
from sam2unet_torch.configs import HIERA_T as PORT_HIERA_T
from sam2unet_torch.configs import HIERA_TEST as PORT_HIERA_TEST
from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs_yaml import YAML_DIR
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2_base import SAM2Config as PortSAM2Config
from sam2unet_torch.predictors.image_predictor import SAM2ImagePredictor
from sam2unet_torch.predictors.transforms import SAM2Transforms
from sam2unet_tpu.build_sam import build_sam2
from sam2unet_tpu.configs import HIERA_S, HIERA_T, HieraConfig
from sam2unet_tpu.models import hiera as jax_hiera
from sam2unet_tpu.models.sam2_base import SAM2Base, SAM2Config
from sam2unet_tpu.ops.pallas import flash_attention as fa
from sam2unet_tpu.ops.pallas.fused_attention_block import (
    strips_rem_supported as jax_strips_rem_supported,
)
from sam2unet_tpu.predictors.image_predictor import (
    SAM2ImagePredictor as JaxPredictor,
)
from sam2unet_tpu.predictors.transforms import (
    SAM2Transforms as JaxTransforms,
)

REL_TOL = 2e-5
MASK_MARGIN = 1e-4

TINY = dict(size=64, sam=dict(image_size=64, hidden_dim=64, mem_dim=16,
                              max_obj_ptrs_in_encoder=4),
            trunk=dataclasses.asdict(PORT_HIERA_TEST))
# hiera_s's windows and pos-embed at a narrow width and cut depth: one
# block of each kind the 1024 path has (K4, K8, K4, K8, a global block over
# 4096 tokens, K12, the plain 64x64 window-14 transition, K12)
S1024 = dict(size=1024, sam=dict(image_size=1024, hidden_dim=64, mem_dim=16),
             trunk=dict(embed_dim=8, num_heads=1, stages=(1, 2, 3, 2),
                        global_att_blocks=(4,), window_spec=(8, 4, 14, 7),
                        window_pos_embed_bkg_spatial_size=(7, 7)))


def _close(got, want, what: str, tol: float = REL_TOL) -> None:
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


class Pair:
    """One JAX model + variables and the port's model with the same
    weights."""

    def __init__(self, spec: dict):
        self.size = spec["size"]
        trunk, sam = spec["trunk"], spec["sam"]
        self.jax_model, variables = build_sam2(
            "hiera_test", sam2_config=SAM2Config(**sam),
            trunk_cfg=HieraConfig(**trunk))
        variables = jax.tree_util.tree_map(np.asarray, dict(variables))
        self.variables = _perturb(variables, np.random.default_rng(0))
        self.port = port_build.build_sam2(
            "hiera_test", sam2_config=PortSAM2Config(**sam),
            trunk_cfg=PortHieraConfig(**trunk), device="cpu")
        self.port.load_state_dict(jax_to_state_dict(
            self.variables, self.port.state_dict().keys(), wrap_blocks=False),
            strict=True)

    def jax(self, fn, *args):
        return self.jax_model.apply(self.variables, *args, method=fn)

    @functools.cached_property
    def features(self):
        """(JAX's, the port's) `forward_image` of one seeded image."""
        x = np.random.default_rng(1).standard_normal(
            (1, self.size, self.size, 3)).astype(np.float32)
        want = jax.jit(lambda v, a: self.jax_model.apply(
            v, a, method=SAM2Base.forward_image))(self.variables, x)
        with torch.inference_mode():
            got = self.port.forward_image(torch.from_numpy(x))
        return want, got


@pytest.fixture(scope="module", params=["tiny", "s1024"])
def pair(request):
    return Pair(TINY if request.param == "tiny" else S1024)


@pytest.fixture(scope="module")
def tiny():
    return Pair(TINY)


def test_forward_image_matches_jax(pair):
    want, got = pair.features
    assert len(got["backbone_fpn"]) == len(want["backbone_fpn"]) == 3
    for i, (g, w) in enumerate(zip(got["backbone_fpn"], want["backbone_fpn"])):
        _close(g, w, f"backbone_fpn[{i}]")
    for i, (g, w) in enumerate(zip(got["vision_pos_enc"],
                                   want["vision_pos_enc"])):
        _close(g, w, f"vision_pos_enc[{i}]")
    _close(got["vision_features"], want["vision_features"], "vision_features")


def _prompts(pr: Pair, b: int = 2, n: int = 3, seed: int = 3):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, pr.size, (b, n, 2)).astype(np.float32)
    labels = rng.integers(-1, 4, (b, n)).astype(np.int32)
    return coords, labels


def test_prompt_encoder_matches_jax(pair):
    coords, labels = _prompts(pair)
    side = 4 * (pair.size // 16)
    masks = np.random.default_rng(4).standard_normal(
        (2, side, side, 1)).astype(np.float32)
    pe = pair.port.sam_prompt_encoder
    for m in (None, masks):
        want = pair.jax(lambda mod: mod.sam_prompt_encoder(
            jnp.asarray(coords), jnp.asarray(labels), None,
            None if m is None else jnp.asarray(m)))
        with torch.inference_mode():
            got = pe(torch.from_numpy(coords), torch.from_numpy(labels),
                     None if m is None else torch.from_numpy(m))
        _close(got[0], want[0], "sparse")
        _close(got[1], want[1], "dense")
    want = pair.jax(lambda mod: mod.sam_prompt_encoder.get_dense_pe())
    _close(pe.get_dense_pe(), want, "dense pe")


@pytest.mark.parametrize("multimask", [False, True])
@pytest.mark.parametrize("with_mask", [False, True])
def test_forward_sam_heads_matches_jax(pair, multimask, with_mask):
    want_f, got_f = pair.features
    coords, labels = _prompts(pair, b=1, n=4, seed=5)
    mask = None
    if with_mask:   # a low-res mask at another size: the antialiased resize
        mask = np.random.default_rng(6).standard_normal(
            (1, pair.size // 2, pair.size // 2, 1)).astype(np.float32)

    def jax_heads(mod):
        fpn = want_f["backbone_fpn"]
        return mod.forward_sam_heads(
            fpn[-1], jnp.asarray(coords), jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), (fpn[0], fpn[1]),
            multimask)

    want = pair.jax(jax_heads)
    fpn = got_f["backbone_fpn"]
    with torch.inference_mode():
        got = pair.port.forward_sam_heads(
            fpn[-1], torch.from_numpy(coords), torch.from_numpy(labels),
            None if mask is None else torch.from_numpy(mask),
            (fpn[0], fpn[1]), multimask)
    names = ("low_res_multimasks", "high_res_multimasks", "ious",
             "low_res_masks", "high_res_masks", "obj_ptr",
             "object_score_logits")
    assert len(got) == len(want) == 7
    for n, g, w in zip(names, got, want):
        _close(g, w, n)


def test_use_mask_as_output_matches_jax(tiny):
    want_f, got_f = tiny.features
    mask = (np.random.default_rng(7).random((1, 64, 64, 1)) > 0.5).astype(
        np.float32)
    want = tiny.jax(lambda mod: mod.use_mask_as_output(
        want_f["backbone_fpn"][-1], tuple(want_f["backbone_fpn"][:2]),
        jnp.asarray(mask)))
    fpn = got_f["backbone_fpn"]
    with torch.inference_mode():
        got = tiny.port.use_mask_as_output(fpn[-1], tuple(fpn[:2]),
                                           torch.from_numpy(mask))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"use_mask_as_output[{i}]")


def _masks_agree(got: np.ndarray, want: np.ndarray, logits: np.ndarray,
                 thr: float = 0.0) -> None:
    """Binary masks equal except where the logit is within MASK_MARGIN of
    the threshold."""
    assert got.shape == want.shape and got.dtype == want.dtype == bool
    differ = got != want
    assert not (differ & (np.abs(logits - thr) > MASK_MARGIN)).any()


PROMPTS = {
    "point": dict(point_coords=np.array([[20.0, 25.0]]),
                  point_labels=np.array([1])),
    "box": dict(box=np.array([5.0, 5.0, 40.0, 40.0])),
    "points_box": dict(point_coords=np.array([[20.0, 25.0], [10.0, 30.0]]),
                       point_labels=np.array([1, 0]),
                       box=np.array([4.0, 6.0, 44.0, 38.0])),
    "nine_points": dict(point_coords=np.stack(
        [np.linspace(5, 50, 9), np.linspace(4, 40, 9)], 1),
        point_labels=np.array([1, 0] * 4 + [1])),
    "none": dict(),
}


@pytest.fixture(scope="module")
def tiny_predictors(tiny):
    image = (np.random.default_rng(0).random((48, 56, 3)) * 255).astype(
        np.uint8)
    jp = JaxPredictor(tiny.jax_model, tiny.variables)
    pp = SAM2ImagePredictor(tiny.port)
    jp.set_image(image)
    pp.set_image(image)
    return jp, pp


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
@pytest.mark.parametrize("multimask", [True, False])
def test_predictor_matches_jax(tiny_predictors, prompt, multimask):
    jp, pp = tiny_predictors
    kw = dict(PROMPTS[prompt], multimask_output=multimask)
    wl, wi, wlow = jp.predict(**kw, return_logits=True)
    gl, gi, glow = pp.predict(**kw, return_logits=True)
    _close(gl, wl, "logits")
    _close(gi, wi, "ious")
    _close(glow, wlow, "low_res")
    wm, _, _ = jp.predict(**kw)
    gm, _, _ = pp.predict(**kw)
    assert gm.shape == (1 if not multimask else 3, 48, 56)
    _masks_agree(gm, wm, np.asarray(wl))


def test_predictor_mask_input_and_embedding_match_jax(tiny_predictors):
    jp, pp = tiny_predictors
    low = jp.predict(**PROMPTS["point"])[2]
    kw = dict(PROMPTS["point"], mask_input=low[:1], multimask_output=False)
    wl, wi, _ = jp.predict(**kw, return_logits=True)
    gl, gi, _ = pp.predict(**kw, return_logits=True)
    _close(gl, wl, "logits with a mask input")
    _close(gi, wi, "ious with a mask input")
    _close(pp.get_image_embedding(), jp.get_image_embedding(), "embedding")


def test_predictor_batch_and_batched_prompts_match_jax(tiny):
    rng = np.random.default_rng(1)
    imgs = [(rng.random((32, 40, 3)) * 255).astype(np.uint8) for _ in range(2)]
    jp = JaxPredictor(tiny.jax_model, tiny.variables)
    pp = SAM2ImagePredictor(tiny.port)
    kw = dict(point_coords_batch=[np.array([[10.0, 10.0]]),
                                  np.array([[20.0, 15.0]])],
              point_labels_batch=[np.array([1]), np.array([1])],
              multimask_output=True, return_logits=True)
    for p in (jp, pp):
        p.set_image_batch(imgs)
    want, got = jp.predict_batch(**kw), pp.predict_batch(**kw)
    for w_list, g_list in zip(want, got):
        assert len(g_list) == 2
        for g, w in zip(g_list, w_list):
            _close(g, w, "predict_batch")
    # B prompts against one image, coordinates at model resolution
    coords = rng.uniform(0, 64, (3, 2, 2)).astype(np.float32)
    labels = np.array([[1, 0], [1, 1], [0, 1]], np.int32)
    for p in (jp, pp):
        p.set_image(imgs[0])
    want = jp._predict(coords, labels, return_logits=True)
    got = pp._predict(coords, labels, return_logits=True)
    for g, w in zip(got, want):
        _close(g, w, "_predict")


def test_host_postprocess_equals_the_device_one(tiny_predictors):
    """max_hole_area = -1 takes the host postprocess without labelling (as
    scripts/bench_sam2.py forces it): the same logits and masks."""
    _, pp = tiny_predictors
    kw = dict(PROMPTS["points_box"], multimask_output=True)
    dev = pp.predict(**kw, return_logits=True)[0]
    pp._transforms.max_hole_area = -1.0
    try:
        host = pp.predict(**kw, return_logits=True)[0]
        host_masks = pp.predict(**kw)[0]
    finally:
        pp._transforms.max_hole_area = 0.0
    _close(host, dev, "host postprocess", tol=1e-5)
    assert (host_masks == (host > 0)).all()


def test_predictor_at_each_size_matches_jax(pair):
    image = (np.random.default_rng(2).random((72, 96, 3)) * 255).astype(
        np.uint8)
    jp = JaxPredictor(pair.jax_model, pair.variables)
    pp = SAM2ImagePredictor(pair.port)
    jp.set_image(image)
    pp.set_image(image)
    kw = dict(point_coords=np.array([[40.0, 30.0]]), point_labels=np.array([1]),
              multimask_output=True)
    wl, wi, _ = jp.predict(**kw, return_logits=True)
    gl, gi, _ = pp.predict(**kw, return_logits=True)
    _close(gl, wl, f"logits at {pair.size}")
    _close(gi, wi, f"ious at {pair.size}")
    _masks_agree(pp.predict(**kw)[0], jp.predict(**kw)[0], np.asarray(wl))


# ------------------------------------------------------------ routes


def _jax_route(bk: dict, h: int, w: int) -> str:
    """The branch the JAX package's MultiScaleBlock takes (hiera.py:210-383
    there) on the card's working type (bf16, itemsize 2), outside training:
    its gates evaluated, VMEM estimates included."""
    window, c = bk["window_size"], bk["dim"]
    if bk["dim"] != bk["dim_out"]:
        fused = (bk["q_stride"] == (2, 2) and window > 0 and window % 2 == 0
                 and window * window % 16 == 0 and h % window == 0
                 and w % window == 0)
        return "K8" if fused else "plain"
    if window == 0:
        s = h * w
        s16 = s + (-s) % 16
        if 8 * s16 * s16 + 14 * s16 * c <= 12 * 2**20:
            return "K6"
        # `_xla_window_block`: the streaming kernel past 1024 tokens where
        # an aligned block divides S, `_xla_attention` otherwise
        stream = s > fa._MAX_FULL_SEQ and fa._pick_stream_blocks(s, s)
        return "long" if stream else "plain global"
    rem = h % window or w % window or window * window % 16
    if rem and jax_strips_rem_supported(h, w, window, c, bk["num_heads"], 2):
        return "K12"
    if h % window or w % window:
        return "groups"
    return "K4" if window * window % 16 == 0 else "K6"


def test_sam2_hiera_s_1024_routes_every_block_like_the_jax_package():
    """sam2_hiera_s at 1024, full width and depth (16 blocks, no adapters):
    the route of each block equals the JAX package's gates on the card's
    bf16, the remainder-strip VMEM estimate included (it admits 64x64 w14
    and 32x32 w7), so per `set_image` K1 16 (tails only), K4 2, K8 2, K12 8
    and K10 3 (the 4096-token global blocks), and the 64x64 window-14
    transition the plain path (K14 under the "pallas" backend)."""
    x = torch.zeros(1, 1024, 1024, 3)
    routes, mlp, outs = _route_of_each_block(PORT_HIERA_S, x, stub=True,
                                             use_adapters=False)
    want, h = [], 256
    for bk in jax_hiera._block_plan(HIERA_S):
        want.append(_jax_route(bk, h, h))
        if bk["q_stride"] is not None:
            h //= 2
    assert routes == want
    assert routes == (["K4", "K8", "K4", "K8"] + ["K12"] * 3 + ["long"]
                      + ["K12"] * 2 + ["long"] + ["K12"] * 2 + ["long"]
                      + ["plain", "K12"])
    assert mlp == {True: 16}
    assert [o.shape[1] for o in outs] == [256, 128, 64, 32]
    # in fp32 the JAX estimate refuses the 64x64 grid (the port's gate
    # leaves the estimate out; the card runs bf16)
    assert not jax_strips_rem_supported(64, 64, 14, 384, 4, 4)


# sam2_hiera_t's routes per `set_image` (12 blocks): at 512 px, the video
# point of the JAX package's scripts/smoke_video.py, grids 128/64/32/16; at
# 1024 px, the AMG point of its scripts/bench_amg.py, grids 256/128/64/32
HIERA_T_ROUTES = {
    # the three global blocks (5, 7, 9) hold 1024 tokens at width 384, past
    # the live gate: the JAX package runs `_xla_window_block` with
    # `_xla_attention` there, the port the plain form, no K10; the remainder
    # grids (32x32 w14, 16x16 w7) have n_w = 3 < 4 columns of windows, so
    # their blocks take the valid groups (K6, four groups each): K1 12, K4 2,
    # K8 2, K6 16
    512: ["K4", "K8", "K4", "K8", "groups", "plain global", "groups",
          "plain global", "groups", "plain global", "plain", "groups"],
    # as sam2_hiera_s at 1024 with fewer stage-3 blocks: K1 12, K4 2, K8 2,
    # K12 4, K10 3 (4096-token global blocks)
    1024: ["K4", "K8", "K4", "K8", "K12", "long", "K12", "long", "K12", "long",
           "plain", "K12"],
}


@pytest.mark.parametrize("size", sorted(HIERA_T_ROUTES))
def test_sam2_hiera_t_routes_every_block_like_the_jax_package(size):
    """sam2_hiera_t at full width and depth (no adapters): the route of
    each block equals the JAX package's gates on the card's bf16 (the
    window-14 transition of stage 3 is the plain path, K14 under the
    "pallas" backend)."""
    x = torch.zeros(1, size, size, 3)
    routes, mlp, outs = _route_of_each_block(PORT_HIERA_T, x, stub=True,
                                             use_adapters=False)
    want, h = [], size // 4
    for bk in jax_hiera._block_plan(HIERA_T):
        want.append(_jax_route(bk, h, h))
        if bk["q_stride"] is not None:
            h //= 2
    assert routes == want == HIERA_T_ROUTES[size]
    assert mlp == {True: 12}
    assert [o.shape[1] for o in outs] == [size // 4 >> i for i in range(4)]


def test_trunk_without_adapters_is_sam2s():
    """`Hiera(use_adapters=False)`: plain blocks under `blocks.N.*`, nothing
    frozen; a global block of such a trunk at 256 px needs K7's
    weight-gradient mode in training, which the port names."""
    trunk = port_hiera.Hiera(PORT_HIERA_TEST)
    keys = list(trunk.state_dict())
    assert "blocks.0.attn.qkv.weight" in keys
    assert not any("prompt_learn" in k or ".block." in k for k in keys)
    assert all(p.requires_grad for p in trunk.parameters())
    gaps = port_hiera.unported_train_backward(PORT_HIERA_S, 256, frozen=False)
    assert [g.split(":")[0] for g in gaps] == ["block 7", "block 10", "block 13"]


# ------------------------------------------------- build_sam2, transforms


def test_build_sam2_config_and_refusals():
    model = port_build.build_sam2("hiera_test", device="cpu")
    assert model.cfg.dynamic_multimask_via_stability
    assert (model.cfg.dynamic_multimask_stability_delta,
            model.cfg.dynamic_multimask_stability_thresh) == (0.05, 0.98)
    assert not port_build.build_sam2(
        "hiera_test", device="cpu",
        apply_postprocessing=False).cfg.dynamic_multimask_via_stability
    # an explicit config wins over the overrides, as in the JAX package
    assert not port_build.build_sam2(
        "hiera_test", device="cpu",
        sam2_config=PortSAM2Config()).cfg.dynamic_multimask_via_stability
    # a YAML config and hydra overrides, composed as the JAX package's
    # build_sam2 composes them (the name dates from their refusal); a
    # YAML name that is not a file is the registry's, unknown keys are
    # ignored
    yaml_model = port_build.build_sam2(
        str(YAML_DIR / "sam2_hiera_t.yaml"), device="cpu",
        hydra_overrides_extra=["++model.image_size=512", "++model.x=1"])
    assert yaml_model.cfg.image_size == 512
    assert yaml_model.cfg.dynamic_multimask_via_stability
    assert yaml_model.image_encoder.trunk.cfg == PORT_HIERA_T
    assert yaml_model.sam_prompt_encoder.image_embedding_size == (32, 32)
    assert port_build.build_sam2(
        "sam2_hiera_s.yaml", device="cpu").image_encoder.trunk.cfg == PORT_HIERA_S


def test_entry_points_default_to_the_card(monkeypatch):
    import inspect

    for fn in (port_build.build_sam2, port_build.build_sam2_image_predictor):
        sig = inspect.signature(fn)
        assert sig.parameters["config_name"].default == "sam2_hiera_s"
    assert inspect.signature(port_build.build_sam2).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (port_build.build_sam2, port_build.build_sam2_image_predictor):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn("hiera_test")


def test_hole_filling_waits_for_connected_components():
    """Hole and sprinkle filling through the port's connected components:
    `postprocess_masks` equals the JAX package's at each setting (logits
    with blobs, holes and specks at 2 x 3 x 40 x 44 -> 90 x 70). The name
    dates from when the port refused these settings."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 3, 40, 44)).astype(np.float32) - 0.3
    logits[:, :, 8:30, 10:34] += 3.0
    for kw in (dict(), dict(max_hole_area=8.0), dict(max_sprinkle_area=4.0),
               dict(max_hole_area=20.0, max_sprinkle_area=6.0),
               dict(max_hole_area=-1.0)):
        got = SAM2Transforms(64, **kw).postprocess_masks(logits, (90, 70))
        want = JaxTransforms(64, **kw).postprocess_masks(logits, (90, 70))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=str(kw))
    assert SAM2Transforms(64, max_hole_area=-1.0).device_postprocess is False
    assert SAM2Transforms(64, max_hole_area=8.0).device_postprocess is False
    assert SAM2Transforms(64).device_postprocess is True


# --------------------------------------------------------------- converter


def test_converter_is_strict_both_ways(tiny):
    keys = list(tiny.port.state_dict())
    sd = jax_to_state_dict(tiny.variables, keys, wrap_blocks=False)
    assert set(sd) == set(keys)
    # a port key without its JAX leaf
    params = dict(tiny.variables["params"])
    dec = dict(params["sam_mask_decoder"])
    dec.pop("iou_token")
    with pytest.raises(KeyError, match="iou_token"):
        jax_to_state_dict({"params": {**params, "sam_mask_decoder": dec}},
                          keys, wrap_blocks=False)
    # a JAX leaf no port key takes (here one of the memory attention's)
    mem = dict(params["memory_attention"])
    mem["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="memory_attention/stray"):
        jax_to_state_dict({"params": {**params, "memory_attention": mem}},
                          keys, wrap_blocks=False)
    # round trip: the state dict back through the port's loader equals it
    tiny.port.load_state_dict(sd, strict=True)
    for k, v in tiny.port.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_official_layout_loads_with_the_video_keys(tiny, tmp_path):
    """A checkpoint in the reference key layout loads strictly, the video
    path's keys with the image path's; a stray key, a missing one (of
    either path) and a wrong shape are refused."""
    state = {k: v.clone() for k, v in tiny.port.state_dict().items()}
    for k in ("memory_attention.layers.0.self_attn.q_proj.weight",
              "memory_attention.layers.1.cross_attn_image.k_proj.weight",
              "memory_encoder.mask_downsampler.encoder.12.weight",
              "memory_encoder.fuser.layers.0.gamma",
              "memory_encoder.out_proj.weight", "maskmem_tpos_enc",
              "no_mem_pos_enc"):
        assert k in state, k
    path = tmp_path / "sam2_tiny.pt"
    torch.save({"model": state}, path)
    model = port_build.build_sam2(
        "hiera_test", str(path), sam2_config=PortSAM2Config(**TINY["sam"]),
        trunk_cfg=PORT_HIERA_TEST, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k
    for bad in ({**state, "sam_mask_decoder.stray.weight": torch.zeros(1)},
                {**state, "obj_ptr_tpos_proj.weight": torch.zeros(16, 64)},
                {k: v for k, v in state.items()
                 if k != "sam_mask_decoder.iou_token.weight"},
                {k: v for k, v in state.items()
                 if k != "memory_encoder.fuser.layers.1.gamma"},
                {**state, "no_mem_embed": torch.zeros(1, 1, 65)}):
        torch.save(bad, path)
        with pytest.raises(KeyError):
            port_build.build_sam2(
                "hiera_test", str(path),
                sam2_config=PortSAM2Config(**TINY["sam"]),
                trunk_cfg=PORT_HIERA_TEST, device="cpu")


def test_port_keys_are_the_reference_layout(tiny):
    """The port's keys are those of the reference SAM2Base (image and
    video paths), the layout official checkpoints use."""
    keys = set(tiny.port.state_dict())
    for k in ("image_encoder.trunk.patch_embed.proj.weight",
              "image_encoder.trunk.blocks.0.attn.qkv.weight",
              "image_encoder.neck.convs.0.conv.weight",
              "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix",
              "sam_prompt_encoder.point_embeddings.3.weight",
              "sam_prompt_encoder.not_a_point_embed.weight",
              "sam_prompt_encoder.mask_downscaling.4.weight",
              "sam_prompt_encoder.no_mask_embed.weight",
              "sam_mask_decoder.transformer.layers.1.mlp.layers.1.bias",
              "sam_mask_decoder.transformer.final_attn_token_to_image.v_proj.weight",
              "sam_mask_decoder.iou_token.weight",
              "sam_mask_decoder.obj_score_token.weight",
              "sam_mask_decoder.output_upscaling.3.weight",
              "sam_mask_decoder.conv_s1.weight",
              "sam_mask_decoder.output_hypernetworks_mlps.3.layers.2.weight",
              "sam_mask_decoder.pred_obj_score_head.layers.2.bias",
              "no_mem_embed", "no_obj_ptr", "mask_downsample.weight",
              "obj_ptr_proj.layers.2.weight",
              "memory_attention.layers.3.norm3.weight",
              "memory_attention.norm.bias",
              "memory_attention.layers.0.cross_attn_image.v_proj.weight",
              "memory_encoder.mask_downsampler.encoder.1.weight",
              "memory_encoder.pix_feat_proj.weight",
              "memory_encoder.fuser.layers.1.dwconv.weight",
              "memory_encoder.fuser.layers.1.pwconv2.bias",
              "maskmem_tpos_enc", "no_mem_pos_enc"):
        assert k in keys, k
    counts = collections.Counter(k.split(".")[0] for k in keys)
    assert set(counts) == {"image_encoder", "sam_prompt_encoder",
                           "sam_mask_decoder", "no_mem_embed", "no_obj_ptr",
                           "mask_downsample", "obj_ptr_proj",
                           "memory_attention", "memory_encoder",
                           "maskmem_tpos_enc", "no_mem_pos_enc"}
