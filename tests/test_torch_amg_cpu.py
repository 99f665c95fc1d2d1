"""The port's automatic mask generator, its numpy utilities, the predictor's
AMG batch (`_predict_amg`) and the YAML / Hydra-override configuration,
against the JAX package's, on the CPU in fp32.

- `configs_yaml/hydra_compat.py` against `sam2unet_tpu/configs/hydra_compat.py`:
  parse, merge, instantiate and compose on the same inputs give equal
  trees; the four YAMLs give HieraConfig and SAM2Config objects equal to
  the JAX package's, field by field (every field the port's dataclasses
  have), with and without `++model.image_size=512`.
- `utils/amg.py` against the JAX one on seeded inputs: exact (numpy on
  both sides).
- `_predict_amg` and `generate` at the JAX tests' tiny config (TINY_SAM2 +
  HIERA_TEST at 64 px, tests/test_torch_sam2_cpu.py) with the iou and
  stability filters at 0: ious within 2e-5 of their max, masks equal except
  at pixels whose logit lies within 1e-4 of the threshold, stability
  scores equal except where such pixels move the two counts.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
from test_torch_sam2_cpu import MASK_MARGIN, TINY, Pair, _close

from sam2unet_torch import build_sam as port_build
from sam2unet_torch.configs_yaml import YAML_DIR
from sam2unet_torch.configs_yaml import hydra_compat as port_hc
from sam2unet_torch.models.sam2_base import SAM2Config as PortSAM2Config
from sam2unet_torch.predictors.amg import (
    SAM2AutomaticMaskGenerator as PortAMG,
)
from sam2unet_torch.predictors.image_predictor import SAM2ImagePredictor
from sam2unet_torch.utils import amg as port_amg
from sam2unet_tpu.configs import hydra_compat as jax_hc
from sam2unet_tpu.predictors.amg import SAM2AutomaticMaskGenerator as JaxAMG
from sam2unet_tpu.predictors.image_predictor import (
    SAM2ImagePredictor as JaxPredictor,
)
from sam2unet_tpu.utils import amg as jax_amg

JAX_YAML = YAML_DIR.parents[1] / "sam2unet_tpu" / "configs" / "yaml"
CONFIGS = ["sam2_hiera_t", "sam2_hiera_s", "sam2_hiera_b+", "sam2_hiera_l"]


def _rng(seed: int):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ hydra_compat

DOTLISTS = {
    "image size": ["++model.image_size=512"],
    "nested and lists": ["++a.b.c=3", "+d=[1, 2]", "e.f=true", "g=x y"],
    "overwrite": ["a.b=1", "a.b=2", "a.c={k: v}"],
    "postprocessing": list(port_build.POSTPROCESSING),
}


@pytest.mark.parametrize("case", sorted(DOTLISTS))
def test_parse_and_merge_match_jax(case):
    items = DOTLISTS[case]
    assert port_hc.parse_dotlist(items) == jax_hc.parse_dotlist(items)
    base = {"a": {"b": 0, "z": [1]}, "model": {"image_size": 1024}}
    got = port_hc.merge_overrides(base, items)
    assert got == jax_hc.merge_overrides(base, items)
    assert base == {"a": {"b": 0, "z": [1]}, "model": {"image_size": 1024}}


def test_parse_refuses_what_the_jax_package_refuses():
    for bad in (["a.b"], ["a=1", "a.b=2"]):
        with pytest.raises(ValueError):
            jax_hc.parse_dotlist(bad)
        with pytest.raises(ValueError):
            port_hc.parse_dotlist(bad)


def test_instantiate_matches_jax():
    """`_target_` nodes called with their instantiated children,
    `_partial_` as functools.partial, `_recursive_: false` leaving the
    children raw, a module path resolved by its longest importable prefix."""
    tree = {"_target_": "fractions.Fraction", "numerator": 3,
            "denominator": {"_target_": "math.gcd", "_args_": 0, "a": 8}}
    node = {"outer": {"_target_": "builtins.dict", "x": [
        {"_target_": "fractions.Fraction", "numerator": 1, "denominator": 4},
        7]}, "lazy": {"_target_": "fractions.Fraction", "_partial_": True,
                      "numerator": 5},
        "raw": {"_target_": "builtins.dict", "_recursive_": False,
                "y": {"_target_": "fractions.Fraction", "numerator": 2}}}
    for fn in (port_hc.instantiate, jax_hc.instantiate):
        with pytest.raises(TypeError):   # math.gcd takes no keyword a
            fn(tree)
    got, want = port_hc.instantiate(node), jax_hc.instantiate(node)
    assert got["outer"] == want["outer"]
    assert isinstance(got["lazy"], functools.partial)
    assert got["lazy"](denominator=10) == want["lazy"](denominator=10)
    assert got["raw"] == want["raw"] == {"y": {"_target_": "fractions.Fraction",
                                               "numerator": 2}}
    assert port_hc._locate("os.path.join") is jax_hc._locate("os.path.join")
    with pytest.raises(ImportError):
        port_hc._locate("no_such_module_anywhere.fn")


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("overrides", [[], ["++model.image_size=512"]])
def test_yaml_configs_match_jax(name, overrides):
    """The port's YAML copy, composed with the overrides, gives the JAX
    package's trunk and SAM2 configs from its own YAML, field by field;
    the YAMLs are the same trees."""
    got = port_hc.compose(str(YAML_DIR / f"{name}.yaml"), overrides)
    want = jax_hc.compose(str(JAX_YAML / f"{name}.yaml"), overrides)
    assert got == want
    g_trunk, g_cfg = port_hc.configs_from_tree(got)
    w_trunk, w_cfg = jax_hc.configs_from_tree(want)
    for g, w in ((g_trunk, w_trunk), (g_cfg, w_cfg)):
        for key, value in _fields(g).items():
            assert value == getattr(w, key), (name, key)
    assert g_cfg.image_size == (512 if overrides else 1024)


def test_build_sam2_from_yaml_with_an_override_is_the_dataclass_model():
    """`build_sam2(<yaml>, hydra_overrides_extra=["++model.image_size=512"])`
    builds the model of `SAM2Config(image_size=512)` with the reference's
    postprocessing overrides, as the JAX package's build_sam2 composes it:
    the same configs, the same parameters by name and shape."""
    trunk, cfg = port_build.build_configs(
        str(YAML_DIR / "sam2_hiera_t.yaml"), ["++model.image_size=512"])
    want = dataclasses.replace(
        PortSAM2Config(image_size=512), dynamic_multimask_via_stability=True,
        dynamic_multimask_stability_delta=0.05,
        dynamic_multimask_stability_thresh=0.98)
    assert cfg == want
    assert trunk == port_build.hiera_config("sam2_hiera_t")
    j_trunk, j_cfg = jax_hc.configs_from_tree(jax_hc.compose(
        str(JAX_YAML / "sam2_hiera_t.yaml"),
        ["++model.image_size=512", *port_build.POSTPROCESSING]))
    assert _fields(cfg) == {k: getattr(j_cfg, k) for k in _fields(cfg)}
    # the registry name takes the same overrides, as in the JAX package
    assert port_build.build_configs(
        "sam2_hiera_t", ["++model.image_size=512"]) == (trunk, cfg)


# ---------------------------------------------------------------- utils


def _masks(seed: int, b: int = 5, h: int = 23, w: int = 31) -> np.ndarray:
    """Blobs: thresholded smoothed noise; of three or more masks the first
    is empty and the second full."""
    rng = _rng(seed)
    noise = rng.standard_normal((b, h + 4, w + 4))
    smooth = sum(noise[:, i:i + h, j:j + w] for i in range(5) for j in range(5))
    m = smooth > 1.0
    if b >= 3:
        m[0] = False
        m[1] = True
    return m


def test_rle_round_trip_matches_jax():
    m = _masks(40)
    got, want = port_amg.mask_to_rle(m), jax_amg.mask_to_rle(m)
    assert got == want
    for rle, mask in zip(got, m):
        np.testing.assert_array_equal(port_amg.rle_to_mask(rle), mask)
        np.testing.assert_array_equal(jax_amg.rle_to_mask(rle), mask)
        assert port_amg.area_from_rle(rle) == jax_amg.area_from_rle(rle) \
            == int(mask.sum())
    assert port_amg.mask_to_rle(m[:0]) == []


def test_stability_boxes_and_grids_match_jax():
    logits = _rng(41).standard_normal((3, 4, 17, 19)).astype(np.float32) * 3
    logits[0, 0] = -5.0   # empty at the loose threshold: score 0
    for thr, off in ((0.0, 1.0), (0.5, 0.25)):
        np.testing.assert_array_equal(
            port_amg.calculate_stability_score(logits, thr, off),
            jax_amg.calculate_stability_score(logits, thr, off))
    m = _masks(42)
    got = port_amg.batched_mask_to_box(m)
    np.testing.assert_array_equal(got, jax_amg.batched_mask_to_box(m))
    assert got.dtype == np.int64 and (got[0] == 0).all()
    np.testing.assert_array_equal(port_amg.batched_mask_to_box(m[:0]),
                                  jax_amg.batched_mask_to_box(m[:0]))
    np.testing.assert_array_equal(port_amg.box_xyxy_to_xywh(got[2]),
                                  jax_amg.box_xyxy_to_xywh(got[2]))
    for n in (1, 4, 16):
        np.testing.assert_array_equal(port_amg.build_point_grid(n),
                                      jax_amg.build_point_grid(n))
    for got_g, want_g in zip(port_amg.build_all_layer_point_grids(16, 2, 2),
                             jax_amg.build_all_layer_point_grids(16, 2, 2)):
        np.testing.assert_array_equal(got_g, want_g)


@pytest.mark.parametrize("im_size,layers", [((480, 640), 0), ((480, 640), 2),
                                            ((101, 37), 1)])
def test_crop_boxes_and_uncrop_match_jax(im_size, layers):
    got = port_amg.generate_crop_boxes(im_size, layers, 512 / 1500)
    assert got == jax_amg.generate_crop_boxes(im_size, layers, 512 / 1500)
    boxes = _rng(43).integers(0, 30, (6, 4))
    pts = _rng(44).uniform(0, 30, (6, 2))
    m = _masks(45, b=2, h=9, w=7)
    for crop in got[0]:
        np.testing.assert_array_equal(port_amg.uncrop_boxes_xyxy(boxes, crop),
                                      jax_amg.uncrop_boxes_xyxy(boxes, crop))
        np.testing.assert_array_equal(port_amg.uncrop_points(pts, crop),
                                      jax_amg.uncrop_points(pts, crop))
        np.testing.assert_array_equal(
            port_amg.is_box_near_crop_edge(boxes, crop, [0, 0, *im_size[::-1]]),
            jax_amg.is_box_near_crop_edge(boxes, crop, [0, 0, *im_size[::-1]]))
        if crop[2] - crop[0] == 7 and crop[3] - crop[1] == 9:
            np.testing.assert_array_equal(
                port_amg.uncrop_masks(m, crop, *im_size),
                jax_amg.uncrop_masks(m, crop, *im_size))
    full = [0, 0, 7, 9]
    assert port_amg.uncrop_masks(m, full, 9, 7) is m


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("area", [3, 30, 10_000])
def test_remove_small_regions_matches_jax(mode, area):
    """Over the port's host connected components (csrc/ccl.cc, built with
    g++) and the JAX package's: the same mask and the same changed flag;
    at an area past every island, the largest island is kept."""
    for seed in (46, 47):
        mask = _masks(seed, b=1, h=40, w=44)[0]
        got = port_amg.remove_small_regions(mask, area, mode)
        want = jax_amg.remove_small_regions(mask, area, mode)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_batched_nms_matches_jax():
    """Greedy NMS over several categories and more boxes than one chunk
    holds; scores distinct."""
    rng = _rng(48)
    n = 2500
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.permutation(n).astype(np.float64) / n
    idxs = rng.integers(0, 3, n)
    for thr in (0.3, 0.7):
        np.testing.assert_array_equal(
            port_amg.batched_nms(boxes, scores, idxs, thr),
            jax_amg.batched_nms(boxes, scores, idxs, thr))
    assert port_amg.batched_nms(boxes[:0], scores[:0], idxs[:0], 0.7).size == 0


def test_mask_data_and_batching_match_jax():
    for cls in (port_amg.MaskData, jax_amg.MaskData):
        d = cls(a=np.arange(6), b=list("abcdef"))
        d.cat(cls(a=np.arange(2), b=["g", "h"]))
        d.filter(np.array([True, False] * 4))
        assert d["a"].tolist() == [0, 2, 4, 0] and d["b"] == list("aceg")
        d.filter(np.array([3, 0]))
        assert d["a"].tolist() == [0, 0] and d["b"] == ["g", "a"]
    batches = [b for b in port_amg.batch_iterator(4, np.arange(10), list("x" * 10))]
    assert [len(b[0]) for b in batches] == [4, 4, 2]
    assert [[a.tolist(), b] for a, b in batches] == [
        [a.tolist(), b] for a, b in jax_amg.batch_iterator(
            4, np.arange(10), list("x" * 10))]


def test_coco_rle_needs_pycocotools():
    """Without pycocotools, as on the machines this repo runs on, both
    raise ImportError."""
    try:
        import pycocotools  # noqa: F401
    except ImportError:
        rle = port_amg.mask_to_rle(_masks(50, b=1))[0]
        for fn in (port_amg.coco_encode_rle, jax_amg.coco_encode_rle):
            with pytest.raises(ImportError, match="pycocotools"):
                fn(rle)
    else:
        rle = port_amg.mask_to_rle(_masks(50, b=1))[0]
        assert port_amg.coco_encode_rle(rle) == jax_amg.coco_encode_rle(rle)


# ------------------------------------------------------ predictor and AMG


@functools.lru_cache(maxsize=None)
def _pair() -> Pair:
    return Pair(TINY)


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _image(seed: int = 51, hw=(48, 56)) -> np.ndarray:
    """bench_amg.py's recipe at a small size: two sinusoids, noise and a
    bright disc."""
    rng = _rng(seed)
    h, w = hw
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([127 + 90 * np.sin(yy / 7.0), 127 + 90 * np.cos(xx / 5.0),
                    rng.random((h, w)) * 60 + 90], axis=-1)
    img = img.clip(0, 255).astype(np.uint8)
    img[((yy - h // 2) ** 2 + (xx - w // 2) ** 2) < (h // 4) ** 2] = 240
    return img


def _stability_bound(logits: np.ndarray, thr: float, off: float):
    """Per mask, the most the stability score can move when pixels within
    MASK_MARGIN of thr +- off are counted on the other side."""
    near_hi = (np.abs(logits - (thr + off)) <= MASK_MARGIN).sum((-1, -2))
    near_lo = (np.abs(logits - (thr - off)) <= MASK_MARGIN).sum((-1, -2))
    lo = np.maximum((logits > thr - off).sum((-1, -2)) - near_lo, 1)
    return (near_hi + near_lo) / lo + 1e-6


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("host", [False, True])
def test_predict_amg_matches_jax(tiny, multimask, host):
    """One AMG batch of 16 grid points on a 48x56 image: the device path
    (the clip, resize, stability score and threshold with the decode) and
    the host path (hole filling asked for: `_predict` and the numpy score),
    against the JAX predictor's `_predict_amg` on the same path."""
    image = _image()
    area = 4.0 if host else 0.0
    jp = JaxPredictor(tiny.jax_model, tiny.variables, max_hole_area=area,
                      max_sprinkle_area=area)
    pp = SAM2ImagePredictor(tiny.port, max_hole_area=area,
                            max_sprinkle_area=area)
    jp.set_image(image)
    pp.set_image(image)
    pts = port_amg.build_point_grid(4) * np.array([[56, 48]])
    coords = pp._transforms.transform_coords(pts, normalize=True,
                                             orig_hw=(48, 56))[:, None]
    labels = np.ones((16, 1), np.int32)
    kw = dict(multimask_output=multimask, stability_offset=1.0,
              need_low_res=True)
    gm, gi, glow, gs = pp._predict_amg(coords, labels, **kw)
    wm, wi, wlow, ws = jp._predict_amg(coords, labels, **kw)
    n_out = 3 if multimask else 1
    assert gm.shape == (16, n_out, 48, 56) and gm.dtype == np.bool_
    _close(gi, wi, "ious")
    _close(glow, wlow, "low-res logits")
    logits = jp._predict(coords, labels, multimask_output=multimask,
                         return_logits=True)[0]
    flips = (gm != np.asarray(wm)) & (np.abs(logits) > MASK_MARGIN)
    assert not flips.any()
    assert (np.abs(gs - ws) <= _stability_bound(logits, 0.0, 1.0)).all()
    # the device score is fp32, as the JAX package's; the host one numpy's
    assert gs.dtype == (np.float64 if host else np.float32)


def _candidates(amg, image) -> list[tuple[np.ndarray, np.ndarray]]:
    """(predicted IoUs, XYXY boxes of the masks) of every candidate of each
    crop, as `generate` decodes them (before the filters, which are 0)."""
    boxes, layers = port_amg.generate_crop_boxes(
        image.shape[:2], amg.crop_n_layers, amg.crop_overlap_ratio)
    out = []
    for (x0, y0, x1, y1), layer in zip(boxes, layers):
        crop = image[y0:y1, x0:x1]
        amg.predictor.set_image(crop)
        pts = amg.point_grids[layer] * np.array(crop.shape[:2])[None, ::-1]
        c = amg.predictor._transforms.transform_coords(
            pts, normalize=True, orig_hw=crop.shape[:2])
        masks, ious, _, _ = amg.predictor._predict_amg(
            c[:, None], np.ones((len(c), 1), np.int32))
        masks = np.asarray(masks)
        out.append((np.asarray(ious).ravel(), port_amg.batched_mask_to_box(
            masks.reshape(-1, *masks.shape[2:])).astype(np.float64)))
    return out


@pytest.mark.parametrize("crop_layers", [0, 1])
def test_generate_matches_jax(tiny, crop_layers):
    """`generate` with 6 points per side, the filters at 0 (as
    scripts/bench_amg.py runs it on random weights), with and without a
    crop layer, at two output modes.

    The rule for score ties: NMS keeps candidates in the order of their
    predicted IoU (a stable sort: the point order breaks exact ties, in
    both packages). The packages' scores differ by fp32 rounding (at most
    2e-5 of their max), so two candidates of a crop whose scores lie that
    close may come in either order. Where the two packages order such a
    pair differently the test requires the pair's boxes to be equal, so
    that either member suppresses the same others, and lets the packages
    keep different members of that pair; every other record agrees one to
    one."""
    image = _image(52, (40, 60))
    kw = dict(points_per_side=6, points_per_batch=24, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, crop_n_layers=crop_layers,
              output_mode="uncompressed_rle")
    jamg = JaxAMG(tiny.jax_model, tiny.variables, **kw)
    pamg = PortAMG(tiny.port, **kw)
    got_c, want_c = _candidates(pamg, image), _candidates(jamg, image)
    err = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got_c, want_c))
    assert err <= 2e-5 * max(float(np.abs(w[0]).max()) for w in want_c)
    swapped = set()   # the (crop box, point) pairs ordered differently
    crops = port_amg.generate_crop_boxes(image.shape[:2], crop_layers,
                                         pamg.crop_overlap_ratio)
    for (g, g_boxes), (w, w_boxes), crop, layer in zip(got_c, want_c,
                                                       *crops):
        np.testing.assert_array_equal(g_boxes, w_boxes)
        rank = np.argsort(np.argsort(-w, kind="stable"))
        pts = port_amg.uncrop_points(
            pamg.point_grids[layer]
            * [[crop[2] - crop[0], crop[3] - crop[1]]], crop)
        for i, j in zip(*np.nonzero(
                (rank[:, None] < rank[None]) & (g[:, None] < g[None]))):
            assert abs(w[i] - w[j]) <= 2 * err
            np.testing.assert_array_equal(w_boxes[i], w_boxes[j])
            swapped.add(frozenset({(tuple(crop), tuple(pts[i // 3])),
                                   (tuple(crop), tuple(pts[j // 3]))}))
    got, want = pamg.generate(image), jamg.generate(image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        members = {(tuple(port_amg.uncrop_boxes_xyxy(
            [[0, 0, *r["crop_box"][2:]]], r["crop_box"])[0]),
                    tuple(r["point_coords"][0])) for r in (g, w)}
        if any(members <= pair for pair in swapped):
            continue   # either member of a swapped pair may be kept
        for k in ("crop_box", "point_coords", "bbox", "area"):
            assert g[k] == w[k], k
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= err
        gm, wm = (port_amg.rle_to_mask(r["segmentation"]) for r in (g, w))
        assert gm.shape == (40, 60)
        np.testing.assert_array_equal(gm, wm)
        assert g["stability_score"] == pytest.approx(w["stability_score"],
                                                     abs=1e-6)
    # binary masks: the records' masks
    pamg.output_mode = "binary_mask"
    masks = pamg.generate(image)
    assert all(r["segmentation"].shape == (40, 60)
               and r["segmentation"].dtype == np.bool_ for r in masks)
    assert [r["area"] for r in masks] == [int(r["segmentation"].sum())
                                          for r in masks]


def test_generate_with_small_region_removal_and_m2m_matches_jax(tiny):
    """`min_mask_region_area` (holes and islands removed over the host
    connected components, then NMS again; the host decode path) and
    `use_m2m` (each mask refined with its own low-res logits)."""
    image = _image(53, (40, 48))
    kw = dict(points_per_side=4, pred_iou_thresh=0.0,
              stability_score_thresh=0.0, min_mask_region_area=6,
              use_m2m=True, output_mode="uncompressed_rle")
    got = PortAMG(tiny.port, **kw).generate(image)
    want = JaxAMG(tiny.jax_model, tiny.variables, **kw).generate(image)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= 2e-5
        for k in ("point_coords", "bbox", "area", "crop_box"):
            assert g[k] == w[k], k
        assert g["stability_score"] == pytest.approx(w["stability_score"],
                                                     abs=1e-6)
        gm, wm = (port_amg.rle_to_mask(r["segmentation"]) for r in (g, w))
        np.testing.assert_array_equal(gm, wm)
