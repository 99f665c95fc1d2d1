"""The port's SAM2 video predictor at 512 px against the JAX package's, on
the CPU in fp32: the flow of the JAX package's scripts/smoke_video.py
(sam2_hiera_t at 512 px, its default) at narrow widths and cut depth, on
both bank paths, under the default attention backend and under "pallas".
Its own file, so that the test run's workers share the video tests.

Tolerance: fp32 on both sides, sums in other orders: every tensor within
2e-5 of its max magnitude; binary masks equal except at pixels whose logit
lies within 1e-4 of the threshold.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import pytest
import torch
from test_torch_sam2_cpu import MASK_MARGIN, Pair, _close

import sam2unet_torch.ops.attention as port_attention
from sam2unet_torch.predictors.video_predictor import (
    SAM2VideoPredictor as PortVideoPredictor,
)
from sam2unet_tpu.ops import attention as jax_attention
from sam2unet_tpu.predictors.video_predictor import SAM2VideoPredictor

FILL_HOLE_AREA = 8


def _rng(seed: int):
    return np.random.default_rng(seed)


# hiera_t's windows at 512 px, the point of the JAX package's
# scripts/smoke_video.py, at narrow widths and cut depth: grids 128/64/32/16,
# a 32 x 32 = 1024-token image embedding (the memory attention's tokens and
# the decoder's keys, at most 1024: K14 under the "pallas" backend)
V512 = dict(size=512, sam=dict(image_size=512, hidden_dim=64, mem_dim=16,
                               max_obj_ptrs_in_encoder=4),
            trunk=dict(embed_dim=8, num_heads=1, stages=(1, 2, 3, 2),
                       global_att_blocks=(4,), window_spec=(8, 4, 14, 7),
                       window_pos_embed_bkg_spatial_size=(7, 7)))


@functools.lru_cache(maxsize=None)
def _pair512() -> Pair:
    return Pair(V512)


def _frames512():
    """smoke_video.py's frames at a quarter of its 240x320 (still smaller
    than the model's input: the upscale path): noise, a bright disc moving
    right, a dark one moving left."""
    rng = _rng(21)
    h, w = 60, 80
    yy, xx = np.mgrid[:h, :w]
    frames = (rng.random((4, h, w, 3)) * 255).astype(np.uint8)
    for t in range(4):
        cx = 20 + 5 * t
        frames[t][((yy - 30) ** 2 + (xx - cx) ** 2) < 10 ** 2] = 230
        frames[t][((yy - 15) ** 2 + (xx - (w - cx)) ** 2) < 8 ** 2] = 25
    return frames


def _drive512(pred):
    """smoke_video.py's flow: a point on each disc, a mask on the second,
    propagation forward, then in reverse from the middle frame."""
    state = pred.init_state(images=_frames512())
    mask = np.zeros((60, 80), bool)
    mask[6:24, 51:69] = True
    out = {"point 1": pred.add_new_points(state, 0, 1, [[20.0, 30.0]], [1])[2],
           "point 2": pred.add_new_points(state, 0, 2, [[60.0, 15.0]], [1])[2],
           "mask 2": pred.add_new_mask(state, 0, 2, mask)[2]}
    for tag, kw in (("fwd", {}), ("rev", dict(start_frame_idx=2, reverse=True))):
        for f, ids, m in pred.propagate_in_video(state, **kw):
            assert list(ids) == [1, 2]
            out[f"{tag} {f}"] = m
    return {k: np.asarray(v.cpu() if torch.is_tensor(v) else v, np.float32)
            for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _jax_flow(resident: bool) -> dict:
    """The JAX predictor's flow on one bank path. On the CPU the JAX
    package's "pallas" backend runs its XLA forms (`dispatch.xla_only`),
    the same arithmetic as its default backend, so one run serves both."""
    pr = _pair512()
    jax_attention.set_attention_impl("pallas")
    try:
        return _drive512(SAM2VideoPredictor(
            pr.jax_model, pr.variables, fill_hole_area=FILL_HOLE_AREA,
            device_resident=resident))
    finally:
        jax_attention.set_attention_impl(None)


@pytest.mark.parametrize("impl", [None, "pallas"])
@pytest.mark.parametrize("resident", [True, False])
def test_video_predictor_at_512_px_matches_jax(impl, resident):
    """The video flow of scripts/smoke_video.py at a 512-px model on 60x80
    frames (the frames upscaled to the input), on both bank paths, under the
    default attention backend and under "pallas" (K14's plain version in
    the port), against the JAX predictor: the masks of every prompt and
    tracked frame at video resolution."""
    pr = _pair512()
    want = _jax_flow(resident)
    port_attention.set_attention_impl(impl)
    try:
        got = _drive512(PortVideoPredictor(pr.port,
                                           fill_hole_area=FILL_HOLE_AREA,
                                           device_resident=resident))
    finally:
        port_attention.set_attention_impl(None)
    assert set(got) == set(want) and len(want) == 3 + 4 + 3
    for k, w in want.items():
        assert got[k].shape[-2:] == (60, 80)
        _close(got[k], w, k)
        flips = ((got[k] > 0) != (w > 0)) & (np.abs(w) > MASK_MARGIN)
        assert not flips.any(), k


def test_pallas_backend_launches_of_the_512_px_flow(monkeypatch):
    """Under `set_attention_impl("pallas")`, the attentions of the 512-px
    flow that reach K14 (`full_attention`), call by call, as the card's run
    counts them (chip_smoke.py's t512video table; each attention's route is
    the JAX package's `_dispatch_fwd`, held in
    tests/test_torch_kernels_cpu.py::test_sdpa_routes_like_the_jax_package):
    init_state one, the trunk's 32x32 window-14 transition (9 windows of 49
    queries over 196 keys); each prompt's decode (7 tokens) seven (two token
    self-attentions, three token->image attentions over the 1024 image
    tokens, two image->token attentions); a tracked frame the transition,
    the decode's seven and the memory attention's four self-attentions over
    its 1024 tokens (one head of hidden_dim: 256 in sam2_hiera_t, 64 here);
    a frame served from the prompts' outputs none. Under the default
    backend no attention of this flow reaches a kernel."""
    import sam2unet_torch.ops.flash_attention as port_fa

    calls = []
    k14 = port_fa.full_attention

    def spy(q, k, v, scale=None):
        calls.append((q.shape[1], k.shape[1], q.shape[-1]))
        return k14(q, k, v, scale)

    monkeypatch.setattr(port_fa, "full_attention", spy)
    pred = PortVideoPredictor(_pair512().port, fill_hole_area=FILL_HOLE_AREA)
    # the decoder's tokens: 6 output tokens and one prompt point (or the
    # empty prompt of a tracked frame); head dims at this width: 8 in the
    # token self-attention, 4 in the cross-attentions (downsampled 2x), 8 in
    # the stage-4 transition; in sam2_hiera_t 32, 16 and 96
    tokens = 7

    def counted(fn):
        calls.clear()
        out = fn()
        return out, collections.Counter(calls)

    decode = {(tokens, tokens, 8): 2, (tokens, 1024, 4): 3,
              (1024, tokens, 4): 2}
    transition = {(49, 196, 8): 1}
    port_attention.set_attention_impl("pallas")
    try:
        state, seen = counted(lambda: pred.init_state(images=_frames512()))
        assert seen == transition
        mask = np.zeros((60, 80), bool)
        mask[6:24, 51:69] = True
        for fn in (lambda: pred.add_new_points(state, 0, 1, [[20.0, 30.0]], [1]),
                   lambda: pred.add_new_points(state, 0, 2, [[60.0, 15.0]], [1]),
                   lambda: pred.add_new_mask(state, 0, 2, mask)):
            assert counted(fn)[1] == decode
        it = pred.propagate_in_video(state)
        frame = {**transition, **decode, (1024, 1024, 64): 4}
        for f in range(4):
            (idx, _, _), seen = counted(lambda: next(it))
            assert idx == f and seen == ({} if f == 0 else frame), f
    finally:
        port_attention.set_attention_impl(None)
    calls.clear()
    list(pred.propagate_in_video(state))
    assert calls == []
