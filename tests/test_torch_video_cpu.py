"""The port's SAM2 video path against the JAX package's, on the CPU in fp32,
at the JAX tests' tiny config (TINY_SAM2 + HIERA_TEST at 64 px, as
tests/test_torch_sam2_cpu.py builds it): the memory encoder, the memory
attention (with and without a key mask, with object-pointer tokens left
unrotated, over several memory grids), the memory conditioning and
encoding of SAM2Base, the non-overlap constraint, the position encodings,
both connected-components forms, and the video predictor end to end (two
objects, points and a mask, forward and reverse, holes of up to 8 pixels
filled) on the device-resident path and on the host-gathered one. Also the
re-tracking contract, the attention routes of the memory attention at
d_model 256 over a 4096-token frame (K10 for the self-attention, the
einsum form for the masked cross-attention, in both packages), the video
predictor's factory and the frame loaders.

Tolerance: fp32 on both sides, sums in other orders: every tensor within
2e-5 of its max magnitude; binary masks equal except at pixels whose logit
lies within 1e-4 of the threshold; connected components exact.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_sam2_cpu import MASK_MARGIN, TINY, Pair, _close

import sam2unet_torch.ops.attention as port_attention
import sam2unet_torch.ops.flash_attention as port_fa
import sam2unet_tpu.ops.pallas.flash_attention as fa
from sam2unet_torch import build_sam as port_build
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models import position_encoding as port_pe
from sam2unet_torch.models.memory import MemoryAttention as PortMemoryAttention
from sam2unet_torch.models.sam2_base import SAM2Base as PortSAM2Base
from sam2unet_torch.models.sam2_base import SAM2Config as PortSAM2Config
from sam2unet_torch.ops import connected_components as port_cc
from sam2unet_torch.predictors.video_device import pack_bits_width
from sam2unet_torch.predictors.video_predictor import (
    SAM2VideoPredictor as PortVideoPredictor,
)
from sam2unet_torch.utils import video as port_video
from sam2unet_tpu.models import position_encoding as jax_pe
from sam2unet_tpu.models.memory import MemoryAttention
from sam2unet_tpu.models.sam2_base import SAM2Base
from sam2unet_tpu.ops import connected_components as jax_cc
from sam2unet_tpu.predictors.video_predictor import SAM2VideoPredictor
from sam2unet_tpu.utils import video as jax_video

FILL_HOLE_AREA = 8


@functools.lru_cache(maxsize=None)
def _pair() -> Pair:
    return Pair(TINY)


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _rng(seed: int):
    return np.random.default_rng(seed)


# ------------------------------------------------------------ the modules


@pytest.mark.parametrize("from_pts", [False, True])
def test_encode_new_memory_matches_jax(tiny, from_pts):
    """SAM2Base.encode_new_memory (the memory encoder: mask downsampler,
    pixel projection, fuser, out projection, sine encoding), the mask
    binarised (a mask from points, binarize_mask_from_pts_for_mem_enc) or
    through the sigmoid."""
    cfg = dataclasses.replace(tiny.jax_model.cfg,
                              binarize_mask_from_pts_for_mem_enc=True)
    jax_model = SAM2Base(trunk_cfg=tiny.jax_model.trunk_cfg, cfg=cfg)
    tiny.port.cfg = PortSAM2Config(**{**TINY["sam"],
                                      "binarize_mask_from_pts_for_mem_enc": True})
    try:
        rng = _rng(11)
        feat = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
        masks = (rng.standard_normal((2, 1, 64, 64)) * 4).astype(np.float32)
        want = jax_model.apply(tiny.variables, feat, masks, from_pts,
                               method=SAM2Base.encode_new_memory)
        with torch.inference_mode():
            got = tiny.port.encode_new_memory(_t(feat), _t(masks), from_pts)
    finally:
        tiny.port.cfg = PortSAM2Config(**TINY["sam"])
    _close(got[0], want[0], "maskmem_features")
    assert len(got[1]) == len(want[1]) == 1
    _close(got[1][0], want[1][0], "maskmem_pos_enc")


MEMORY_CASES = {
    # (memory grids, pointer tokens, key mask)
    "two grids": (2, 0, False),
    "grids and unrotated pointers": (1, 4, False),
    "padded bank with key mask": (3, 8, True),
}


@pytest.mark.parametrize("case", sorted(MEMORY_CASES))
def test_memory_attention_matches_jax(tiny, case):
    """MemoryAttention (four RoPE layers): the memory's grids take the
    repeated rotation (rope_k_repeat), the last `num_obj_ptr_tokens` keys
    none; a key mask drops padded slots."""
    n_grid, n_ptr, masked = MEMORY_CASES[case]
    rng = _rng(12)
    s_mem = n_grid * 16 + n_ptr
    curr, curr_pos = (rng.standard_normal((2, 16, 64)).astype(np.float32)
                      for _ in range(2))
    mem, mem_pos = (rng.standard_normal((2, s_mem, 16)).astype(np.float32)
                    for _ in range(2))
    valid = None
    if masked:
        valid = rng.random((2, s_mem)) > 0.3
        valid[:, 0] = True
    jmod = MemoryAttention(d_model=64, num_layers=4, kv_in_dim=16)
    want = jmod.apply({"params": tiny.variables["params"]["memory_attention"]},
                      curr, mem, curr_pos, mem_pos, n_ptr,
                      None if valid is None else jnp.asarray(valid))
    with torch.inference_mode():
        got = tiny.port.memory_attention(
            _t(curr), _t(mem), _t(curr_pos), _t(mem_pos), n_ptr,
            None if valid is None else _t(valid))
    _close(got, want, case)


@pytest.mark.parametrize("init", [True, False])
def test_condition_features_on_memory_matches_jax(tiny, init):
    """An initial conditioning frame (no_mem_embed added) and a padded bank
    of three grids and eight pointer tokens with its validity mask."""
    rng = _rng(13)
    feat, pos = (rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
                 for _ in range(2))
    mem, mem_pos = (rng.standard_normal((2, 56, 16)).astype(np.float32)
                    for _ in range(2))
    valid = rng.random((2, 56)) > 0.25
    valid[:, 0] = True
    args = (None, None, 0, True, None) if init else (mem, mem_pos, 8, False,
                                                     valid)
    want = jax.jit(lambda v, *a: tiny.jax_model.apply(
        v, *a, method=SAM2Base.condition_features_on_memory),
        static_argnums=(5, 6))(tiny.variables, feat, pos, *args)
    with torch.inference_mode():
        got = tiny.port.condition_features_on_memory(
            _t(feat), _t(pos), *(None if a is None else
                                 _t(a) if isinstance(a, np.ndarray) else a
                                 for a in args))
    _close(got, want, f"init={init}")


def test_non_overlapping_constraints_and_multimask_choice_match_jax(tiny):
    x = _rng(14).standard_normal((3, 8, 9, 1)).astype(np.float32) * 20
    _close(PortSAM2Base.apply_non_overlapping_constraints(_t(x)),
           SAM2Base.apply_non_overlapping_constraints(jnp.asarray(x)),
           "non-overlap", tol=0.0)
    assert PortSAM2Base.apply_non_overlapping_constraints(_t(x[:1])).equal(
        _t(x[:1]))
    for init in (True, False):
        for n in range(4):
            assert tiny.port.use_multimask(init, n) == tiny.jax_model.apply(
                tiny.variables, init, n, method=SAM2Base.use_multimask)


def test_position_encodings_match_jax():
    """The axial RoPE tables, the rotation of q and k (k over three query
    grids with the angles repeated, over fewer tokens than one grid with
    the first rows), the 1-D sine encoding and the sine grid."""
    cos, sin = port_pe.axial_rope_cos_sin(16, 4, 4)
    jcos, jsin = jax_pe.axial_rope_cos_sin(16, 4, 4)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    rng = _rng(15)
    q = rng.standard_normal((2, 16, 1, 16)).astype(np.float32)
    for nk in (48, 3, 0):
        k = rng.standard_normal((2, nk, 1, 16)).astype(np.float32)
        want = jax_pe.apply_rotary_enc(
            jnp.asarray(q.transpose(0, 2, 1, 3)),
            jnp.asarray(k.transpose(0, 2, 1, 3)), jnp.asarray(jcos),
            jnp.asarray(jsin), repeat_freqs_k=True)
        got = port_pe.apply_rotary_enc(_t(q), _t(k), _t(cos), _t(sin), True)
        assert got[1].shape == k.shape
        for g, w in zip(got, want[:2 if nk else 1]):
            _close(g.transpose(1, 2), w, f"rope nk={nk}", tol=1e-6)
    pos = np.array([0.0, 1.0, 3.0, 7.5], np.float32)
    _close(port_pe.get_1d_sine_pe(_t(pos), 32),
           jax_pe.get_1d_sine_pe(jnp.asarray(pos), 32), "1-D sine", tol=1e-6)
    np.testing.assert_array_equal(port_pe.sine_position_embedding(5, 7, 16),
                                  jax_pe.sine_position_embedding(5, 7, 16))


# --------------------------------------------------- connected components


def _ccl_masks():
    rng = _rng(16)
    masks = [(rng.random((3, 1, 37, 53)) < p).astype(np.uint8)
             for p in (0.3, 0.55, 0.8)]
    ring = np.zeros((1, 1, 20, 20), np.uint8)   # one component around a hole
    ring[0, 0, 3:17, 3:17] = 1
    ring[0, 0, 6:14, 6:14] = 0
    return masks + [ring, np.zeros((2, 1, 5, 6), np.uint8)]


@pytest.mark.parametrize("form", ["torch", "native"])
def test_connected_components_match_jax(form):
    """`label_components_torch` gives label_components_jax's labels and
    areas exactly; `label_components_native` (csrc/ccl.cc built with g++)
    the JAX package's native labels and areas; after canonicalize_labels
    every form agrees."""
    for m in _ccl_masks():
        jl, ja = (np.asarray(t) for t in jax_cc.label_components_jax(m))
        if form == "torch":
            gl, ga = (t.numpy() for t in port_cc.label_components_torch(_t(m)))
            np.testing.assert_array_equal(gl, jl)
        else:
            gl, ga = port_cc.label_components_native(m)
            nl, na = jax_cc.label_components_native(m)
            np.testing.assert_array_equal(port_cc.canonicalize_labels(gl),
                                          jax_cc.canonicalize_labels(nl))
            np.testing.assert_array_equal(ga, na)
        assert gl.dtype == ga.dtype == np.int32
        np.testing.assert_array_equal(ga, ja)
        np.testing.assert_array_equal(port_cc.canonicalize_labels(gl),
                                      jax_cc.canonicalize_labels(jl))
    gl, ga = port_cc.get_connected_components(_t(_ccl_masks()[3]))
    assert int(ga.max()) == 14 * 14 - 8 * 8 and int(gl.max()) == 3 * 20 + 3 + 1


# ------------------------------------------------------- video predictor


def _frames():
    return (_rng(17).random((6, 40, 48, 3)) * 255).astype(np.uint8)


def _drive(pred):
    """Two objects prompted on frame 0 (a point each, then a mask on the
    second), propagation forward, then in reverse from the last frame:
    every returned mask and every tracked frame's low-res logits."""
    state = pred.init_state(images=_frames())
    mask = np.zeros((40, 48), np.uint8)
    mask[12:30, 20:40] = 1
    out = {"point 1": pred.add_new_points(state, 0, 1, [[14.0, 12.0]], [1])[2],
           "point 2": pred.add_new_points(state, 0, 2, [[30.0, 24.0]], [1])[2],
           "mask 2": pred.add_new_mask(state, 0, 2, mask)[2]}
    for tag, kw in (("fwd", {}), ("rev", dict(start_frame_idx=5, reverse=True))):
        for f, ids, m in pred.propagate_in_video(state, **kw):
            assert list(ids) == [1, 2]
            out[f"{tag} {f}"] = m
            low = state["output_dict"]["non_cond_frame_outputs"].get(f)
            if low is not None:
                out[f"{tag} {f} low-res"] = low["pred_masks"]
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float32)
            for k, v in out.items()}


@pytest.mark.parametrize("resident", [True, False])
def test_video_predictor_matches_jax(tiny, resident):
    """The whole flow on the device-resident path (the device bank, the
    device preprocess and connected components) and on the host-gathered
    one, against the JAX predictor on the same path: masks of every
    prompt and tracked frame at video resolution, the tracked frames'
    low-res logits after hole filling."""
    want = _drive(SAM2VideoPredictor(tiny.jax_model, tiny.variables,
                                     fill_hole_area=FILL_HOLE_AREA,
                                     device_resident=resident))
    got = _drive(PortVideoPredictor(tiny.port, fill_hole_area=FILL_HOLE_AREA,
                                    device_resident=resident))
    assert set(got) == set(want) and len(want) == 3 + 6 + 6 + 5 + 5
    filled = 0
    for k, w in want.items():
        _close(got[k], w, k)
        flips = ((got[k] > 0) != (w > 0)) & (np.abs(w) > MASK_MARGIN)
        assert not flips.any(), k
        filled += int((w == np.float32(0.1)).sum()) if "low-res" in k else 0
    assert filled > 0   # holes were filled on this run


OPTIONS = dict(fill_hole_area=FILL_HOLE_AREA, non_overlap_masks=True,
               clear_non_cond_mem_around_input=True,
               clear_non_cond_mem_for_multi_obj=True)


def _drive_options(pred):
    """Twelve frames, so the device bank's grid ring (7 slots at this
    config) and pointer ring (4) both wrap; the state offloaded to the
    host. Two objects prompted on frame 0, tracked to frame 4; a negative
    click on object 1 at frame 4, a correction of a tracked frame, which
    clears the memories around it; forward from frame 6, whose bank then
    holds frame 4's memory and nothing of frames 1-3 and 5; reverse from
    the last frame, where frame 11 takes the ring slot of frame 4, which
    frame 3 reads again."""
    frames = (_rng(21).random((12, 40, 48, 3)) * 255).astype(np.uint8)
    state = pred.init_state(images=frames, offload_state_to_cpu=True)
    mask = np.zeros((40, 48), np.uint8)
    mask[12:30, 20:40] = 1
    out = {"point 1": pred.add_new_points(state, 0, 1, [[14.0, 12.0]], [1])[2],
           "point 2": pred.add_new_points(state, 0, 2, [[30.0, 24.0]], [1])[2],
           "mask 2": pred.add_new_mask(state, 0, 2, mask)[2]}
    passes = (("fwd", dict(max_frame_num_to_track=4)),
              ("fix", None),
              ("fwd6", dict(start_frame_idx=6)),
              ("rev", dict(start_frame_idx=11, reverse=True)))
    for tag, kw in passes:
        if kw is None:
            out[tag] = pred.add_new_points(state, 4, 1, [[30.0, 24.0]], [0],
                                           clear_old_points=False)[2]
            continue
        for f, ids, m in pred.propagate_in_video(state, **kw):
            assert list(ids) == [1, 2]
            out[f"{tag} {f}"] = m
            low = state["output_dict"]["non_cond_frame_outputs"].get(f)
            if low is not None:
                out[f"{tag} {f} low-res"] = low["pred_masks"]
    kept = state["output_dict"]["non_cond_frame_outputs"]
    out["kept"] = np.asarray(sorted(kept), np.float32)
    assert all(isinstance(v["pred_masks"], np.ndarray) for v in kept.values())
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float32)
            for k, v in out.items()}


@pytest.mark.parametrize("resident", [True, False])
def test_video_predictor_options_match_jax(tiny, resident):
    """The predictor's options against the JAX predictor's on the same path:
    non-overlapping masks, the memories around a prompt cleared (for two
    objects), the state offloaded to the host, holes filled; twelve frames
    wrap the device bank's rings. Masks of every prompt and tracked frame,
    the tracked frames' low-res logits, the frames whose outputs are kept;
    where two objects tie within rounding, as set out below."""
    want = _drive_options(SAM2VideoPredictor(
        tiny.jax_model, tiny.variables, device_resident=resident, **OPTIONS))
    got = _drive_options(PortVideoPredictor(
        tiny.port, device_resident=resident, **OPTIONS))
    assert set(got) == set(want)
    np.testing.assert_array_equal(got.pop("kept"), want.pop("kept"))
    for k, w in want.items():
        g = got[k]
        if "low-res" in k:   # before the constraint
            _close(g, w, k)
            flips = ((g > 0) != (w > 0)) & (np.abs(w) > MASK_MARGIN)
            assert not flips.any(), k
            continue
        # After the constraint a pixel where two objects' scores tie within
        # rounding (holes filled with 0.1 in both) may keep either object.
        # The winning score, and each score clamped at -10, are continuous
        # in the scores and held everywhere; the masks wherever both
        # packages keep the same object.
        assert ((w > 0).sum(0) <= 1).all(), k
        _close(g.max(0), w.max(0), k + " winning score")
        _close(np.minimum(g, -10), np.minimum(w, -10), k + " clamped")
        same = g.argmax(0) == w.argmax(0)
        _close(np.where(same, g, 0), np.where(same, w, 0), k)
        flips = ((g > 0) != (w > 0)) & (np.abs(w) > MASK_MARGIN) & same
        assert not flips.any(), k


@pytest.mark.parametrize("resident", [True, False])
def test_video_predictor_retracks_every_frame_without_fresh_input(tiny,
                                                                  resident):
    """Only frames with fresh prompts are served from cache: a second
    propagation tracks the three other frames again (CLAUDE.md, the video
    predictor's caching contract)."""
    pred = PortVideoPredictor(tiny.port, device_resident=resident)
    state = pred.init_state(images=_frames()[:4])
    pred.add_new_points(state, 0, 1, [[24.0, 20.0]], [1])
    list(pred.propagate_in_video(state))
    name = "_run_device_frame" if resident else "_run_single_frame_inference"
    calls = []
    orig = getattr(pred, name)
    setattr(pred, name, lambda *a, **k: calls.append(a) or orig(*a, **k))
    list(pred.propagate_in_video(state))
    assert len(calls) == 3


def test_device_path_gathers_nothing_on_the_host_and_packs_masks(tiny):
    """The device-resident propagation never gathers the bank on the host;
    its bit-packed masks are np.packbits of its float masks."""
    pred = PortVideoPredictor(tiny.port)
    state = pred.init_state(images=_frames()[:3])
    pred.add_new_points(state, 0, 1, [[24.0, 20.0]], [1])
    pred._gather_memory = None   # a host gather would fail
    dense = {f: np.asarray(m) for f, _, m in pred.propagate_in_video(state)}
    packed = {f: np.asarray(m) for f, _, m in
              pred.propagate_in_video(state, yield_packed_masks=True)}
    for f in dense:
        np.testing.assert_array_equal(
            np.unpackbits(packed[f], axis=-1)[..., :48].astype(bool),
            dense[f] > 0, err_msg=str(f))
    odd = _rng(18).random((2, 3, 13)) > 0.5
    np.testing.assert_array_equal(pack_bits_width(_t(odd)).numpy(),
                                  np.packbits(odd, axis=-1))


def _memory_attention_routes(monkeypatch, tokens: int, impl: str | None):
    """One memory-attention layer at d_model 256 over a frame of `tokens`
    and a bank of one grid and 4 pointer tokens with a key mask, under the
    attention backend `impl` (None: the callers' own) in both packages:
    (the JAX package's forms, the port's, the port's output, the JAX
    one). The JAX package's TPU test answers no, each form spied."""
    from sam2unet_tpu.ops import attention as jax_attention

    rng = _rng(19)
    curr, curr_pos = (rng.standard_normal((1, tokens, 256)).astype(np.float32)
                      for _ in range(2))
    mem, mem_pos = (rng.standard_normal((1, tokens + 4, 64)).astype(
        np.float32) for _ in range(2))
    valid = rng.random((1, tokens + 4)) > 0.2
    jmod = MemoryAttention(d_model=256, num_layers=1, dim_feedforward=64,
                           kv_in_dim=64)
    variables = jax.jit(jmod.init, static_argnums=(5,))(
        jax.random.PRNGKey(0), curr, mem, curr_pos, mem_pos, 4,
        jnp.asarray(valid))
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    port = PortMemoryAttention(256, 1, dim_feedforward=64, kv_in_dim=64)
    port.load_state_dict(jax_to_state_dict(variables, port.state_dict().keys()),
                         strict=True)

    jax_seen, xla = [], fa._xla_attention

    def jax_spy(name):
        def run(q, k, v, scale=None, **kw):
            jax_seen.append(name)
            o = xla(q, k, v, scale=scale, key_valid=kw.get("key_valid"))
            return (o, None) if name == "K10" else o
        return run

    monkeypatch.setattr(fa.dispatch, "xla_only", lambda: False)
    monkeypatch.setattr(fa, "_fused_full", jax_spy("K14"))
    monkeypatch.setattr(fa, "_stream_fwd_impl", jax_spy("K10"))
    monkeypatch.setattr(fa, "_xla_attention", jax_spy("einsum"))
    jax_attention.set_attention_impl(impl)
    try:
        want = jmod.apply(variables, curr, mem, curr_pos, mem_pos, 4,
                          jnp.asarray(valid))
    finally:
        jax_attention.set_attention_impl(None)

    seen, depth = [], [0]

    def spy(name, fn):
        def run(*a, **kw):   # the outermost form only: K14's plain version
            if not depth[0]:  # is itself an einsum
                seen.append(name)
            depth[0] += 1
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    monkeypatch.setattr(port_fa, "full_attention",
                        spy("K14", port_fa.full_attention))
    monkeypatch.setattr(port_fa, "flash_attention",
                        spy("K10", port_fa.flash_attention))
    monkeypatch.setattr(port_fa, "einsum_attention",
                        spy("einsum", port_fa.einsum_attention))
    monkeypatch.setattr(port_attention, "einsum_attention",
                        spy("einsum", port_attention.einsum_attention))
    port_attention.set_attention_impl(impl)
    try:
        with torch.inference_mode():
            got = port(_t(curr), _t(mem), _t(curr_pos), _t(mem_pos), 4,
                       _t(valid))
    finally:
        port_attention.set_attention_impl(None)
    return jax_seen, seen, got, want


def test_memory_attention_routes_like_the_jax_package(monkeypatch):
    """One memory-attention layer at d_model 256 over a 64 x 64 frame (4096
    tokens) and a bank of one grid and 4 pointer tokens with a key mask:
    the self-attention runs K10 and the masked cross-attention the einsum
    form, in both packages (the JAX package's TPU test answered no, each
    form spied); the outputs agree."""
    jax_seen, seen, got, want = _memory_attention_routes(monkeypatch, 4096,
                                                         None)
    assert jax_seen == seen == ["K10", "einsum"]
    _close(got, want, "one layer at d_model 256")


@pytest.mark.parametrize("impl", [None, "pallas"])
def test_memory_attention_at_512_px_routes_like_the_jax_package(monkeypatch,
                                                                impl):
    """The same layer over a 32 x 32 frame (1024 tokens, a 512-px video):
    under the default backend both attentions take the einsum form; under
    `set_attention_impl("pallas")` the self-attention runs K14 at head dim
    256 (at most 1024 keys) and the masked cross-attention still the
    einsum form, in both packages; the outputs agree."""
    jax_seen, seen, got, want = _memory_attention_routes(monkeypatch, 1024,
                                                         impl)
    first = "K14" if impl == "pallas" else "einsum"
    assert jax_seen == seen == [first, "einsum"]
    _close(got, want, f"one layer at d_model 256 over 1024 tokens, {impl}")


# ------------------------------------------------ factory and frame loading


def test_build_sam2_video_predictor_defaults_and_refusals(monkeypatch):
    """The reference's video postprocessing: prompted masks binarised for
    the memory encoder and holes of up to 8 pixels filled, both off with
    apply_postprocessing=False; an explicit config wins over the first, an
    explicit fill_hole_area over the second; hydra overrides composed as
    the JAX package composes them (the name dates from their refusal); the
    card by default."""
    kw = dict(device="cpu")
    pred = port_build.build_sam2_video_predictor("hiera_test", **kw)
    assert pred.cfg.binarize_mask_from_pts_for_mem_enc
    assert pred.cfg.dynamic_multimask_via_stability
    assert pred.fill_hole_area == 8 and pred.device_resident
    off = port_build.build_sam2_video_predictor(
        "hiera_test", apply_postprocessing=False, **kw)
    assert not off.cfg.binarize_mask_from_pts_for_mem_enc
    assert off.fill_hole_area == 0
    mine = port_build.build_sam2_video_predictor(
        "hiera_test", sam2_config=PortSAM2Config(), fill_hole_area=3, **kw)
    assert not mine.cfg.binarize_mask_from_pts_for_mem_enc
    assert mine.fill_hole_area == 3
    small = port_build.build_sam2_video_predictor(
        "hiera_test", hydra_overrides_extra=["++model.image_size=128"], **kw)
    assert small.cfg.image_size == 128 and small.fill_hole_area == 8
    assert small.cfg.binarize_mask_from_pts_for_mem_enc
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_build.build_sam2_video_predictor("hiera_test")


def test_frame_loaders_match_jax(tmp_path):
    """load_video_frames and AsyncVideoFrameLoader on a directory of frames
    named by index (10 sorts after 9), as the JAX package's."""
    frames = (_rng(20).random((11, 6, 7, 3)) * 255).astype(np.uint8)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"{i}.png")
    got, h, w = port_video.load_video_frames(str(tmp_path))
    want, jh, jw = jax_video.load_video_frames(str(tmp_path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)
    assert (h, w) == (jh, jw) == (6, 7)
    loader = port_video.AsyncVideoFrameLoader(str(tmp_path))
    loader.thread.join()
    assert len(loader) == 11 and loader.shape == (11, 6, 7, 3)
    np.testing.assert_array_equal(loader[10], frames[10])
