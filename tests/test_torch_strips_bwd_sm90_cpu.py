"""K5's and K9's route to the Hopper entry points (csrc/block_bwd_sm90.cu)
and the plain versions they are held to, on the CPU.

`_strips_bwd_library` picks, on the host, whether a K5 call runs
`k5_window_block_strips_bwd_sm90`: bf16 with c and the head dim multiples of
8 elements, the head dim up to 128, windows of 4 or 8 (window**2 at most
64, and the 16-aligned windows the JAX package's K5 takes).
`_transition_bwd_library` picks `k9_transition_bwd_sm90` for K9 on the same
terms (cin and cout multiples of 8, windows of 4 or 8): both are
`small_window_sm90`. Everything else keeps csrc/fused_attention_block_bwd.cu
and csrc/fused_transition_bwd.cu. The entry points' scratch is one
`dispatch.workspace`; their LN passes are gemm.cuh's and gemm_bwd.cuh's
(four lanes a row at c <= 192, for every caller).
The kernels run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py); here the wrappers are driven with the libraries replaced by
recorders (which entry point, which arguments, which scratch: one workspace
of the working dtype, no o, lse or D buffer), and the plain K5 and K9 are
held against `jax.vjp` of the JAX package's `_xla_strips` and
`_xla_transition` at the small-window pass's edge shapes: an odd count of
w4 windows along W (a strip's last packed tile holds one window), head dim
72 (an instance of 80, zero-filled past d), and K9 cells of four equal
tokens (exact ties: the first maximum takes the gradient). Inputs from a
numpy seed; fp32, tolerance 2e-5 of the largest value (sums in another
order).
"""

from __future__ import annotations

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_transition as ft
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.fused_attention_block import (
    SM90_SMALL_WINDOWS,
    _strips_bwd_library,
    _window_bwd_library,
    small_window_sm90,
    strips_bwd_kernel,
    window_block_strips_bwd,
)
from sam2unet_torch.ops.fused_mlp import SM90_BLOCK_BWD
from sam2unet_torch.ops.fused_transition import (
    _transition_bwd_library,
    transition_bwd,
    transition_bwd_supported,
)
from sam2unet_torch.utils import profile_model

SRC = build.CSRC / f"{SM90_BLOCK_BWD}.cu"


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("c,heads,window,sm90", [
    (96, 1, 8, True), (192, 2, 4, True), (144, 2, 8, True), (288, 4, 4, True),
    (192, 2, 8, True), (200, 5, 8, True), (256, 2, 4, True),
    (272, 2, 8, False), (576, 4, 4, False), (144, 2, 16, False),
    (144, 2, 12, False), (144, 2, 2, False), (148, 2, 8, False), (24, 2, 4, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_strips_bwd_route_by_dtype_width_head_dim_and_window(dtype, c, heads, window,
                                                             sm90):
    """bf16 at hiera_s@960's (d 96) and hiera_l@352's (d 72) w8 and w4
    strips, and head dims 40 and 128, runs csrc/block_bwd_sm90.cu; head dim
    136 or 144, windows past 8 (or of 2), a width or head dim off the
    multiples of 8, and fp32 keep csrc/fused_attention_block_bwd.cu."""
    want = SM90_BLOCK_BWD if sm90 and dtype == torch.bfloat16 else None
    assert _strips_bwd_library(dtype, c, heads, window) == want


@pytest.mark.parametrize("cin,cout,heads,window,sm90", [
    (144, 288, 4, 8, True), (288, 576, 8, 4, True), (192, 384, 4, 4, True),
    (96, 192, 2, 8, True), (72, 144, 2, 8, True), (144, 288, 2, 8, False),
    (144, 272, 2, 4, False), (144, 288, 4, 16, False), (148, 288, 4, 8, False),
    (20, 40, 4, 4, False), (144, 292, 4, 8, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_transition_bwd_route_by_dtype_width_head_dim_and_window(dtype, cin, cout, heads,
                                                                 window, sm90):
    """bf16 at the main path's transitions (88 -> 44 w8 and 44 -> 22 w4 of
    hiera_l@352, 120 -> 60 w4 of hiera_s@960) runs csrc/block_bwd_sm90.cu;
    head dims 144 and 136, a window of 16, widths off the multiples of 8
    and fp32 keep csrc/fused_transition_bwd.cu."""
    want = SM90_BLOCK_BWD if sm90 and dtype == torch.bfloat16 else None
    assert _transition_bwd_library(dtype, cin, cout, heads, window) == want


@pytest.mark.parametrize("window", range(2, 17, 2))
def test_small_windows_are_those_the_jax_gates_pass_up_to_eight(window):
    """The new route's windows are the 16-aligned ones (the JAX package's K5
    and K9 gates) with window**2 at most 64: 4 and 8."""
    in_route = window in SM90_SMALL_WINDOWS
    assert in_route == (window * window <= 64 and strips_bwd_kernel(window, 96))
    assert in_route == (window <= 8 and transition_bwd_supported(window, 96, 32, 48))


@pytest.mark.parametrize("window", [2, 4, 8, 12, 16])
@pytest.mark.parametrize("c,heads", [(96, 1), (144, 2), (192, 2), (272, 2), (148, 2), (24, 2)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_both_routes_share_one_small_window_gate(dtype, c, heads, window):
    """K5's and K9's routes are `small_window_sm90` (K7's terms on the
    attention's width and heads, and a window of 4 or 8); K9's adds only
    cin % 8."""
    gate = small_window_sm90(dtype, c, heads, window)
    assert gate == (_window_bwd_library(dtype, c, heads) is not None
                    and window in SM90_SMALL_WINDOWS)
    want = SM90_BLOCK_BWD if gate else None
    assert _strips_bwd_library(dtype, c, heads, window) == want
    assert _transition_bwd_library(dtype, 72, c, heads, window) == want
    assert _transition_bwd_library(dtype, 76, c, heads, window) is None


@pytest.mark.parametrize("nbytes", [(1,), (256, 1, 513), (6 * 88 * 144, 3 * 2 * 144, 7)])
def test_workspace_lays_buffers_out_256_bytes_apart_in_one_allocation(monkeypatch, nbytes):
    """`dispatch.workspace` (the Hopper entry points' scratch): one uint8
    allocation, each buffer at a 256-byte aligned offset past the last."""
    allocs, empty = [], torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **k: allocs.append(empty(*a, **k))
                        or allocs[-1])
    ptrs = dispatch.workspace(torch.device("cpu"), *nbytes)
    offs, size = _workspace_offsets(nbytes, itemsize=1)
    (ws,) = allocs
    assert ws.dtype == torch.uint8 and ws.numel() == size
    assert ptrs == [ws.data_ptr() + o for o in offs]
    assert all(o % 256 == 0 for o in offs)


def test_the_route_runs_the_shared_ln_passes_narrow_at_the_small_widths():
    """K5 and K9 on csrc/block_bwd_sm90.cu launch gemm.cuh's and
    gemm_bwd.cuh's LN passes (no LN kernel of their own), whose four-lanes
    form takes every width up to 192 (hiera_s's 96 and 192, hiera_l's 144)
    for every caller, and the one-warp form up to 2048."""
    text = SRC.read_text()
    assert "ln_quad" not in text and "route_ln" not in text
    k5 = text[text.index('extern "C" int k5_window_block_strips_bwd_sm90('):]
    assert "launch_ln_dt(1," in k5 and "launch_ln_bwd_dt(1," in k5
    gemm = (build.CSRC / "gemm.cuh").read_text()
    lanes, maxv = map(int, re.search(
        r"LN_NARROW_LANES = (\d+), LN_NARROW_MAXV = (\d+);", gemm).groups())
    assert lanes * maxv * 8 == 192 and 32 * int(re.search(
        r"LN_MAXV = (\d+);", gemm)[1]) * 8 == 2048
    assert "K <= LN_NARROW_MAX_K" in gemm
    assert "K <= LN_NARROW_MAX_K" in (build.CSRC / "gemm_bwd.cuh").read_text()


class _Recorder:
    """Libraries whose entry points record (library, entry, arguments) and
    return 0, and torch.empty's allocations; the card's stream stubbed, so
    the wrappers run their kernel route on CPU tensors."""

    def __init__(self, monkeypatch):
        self.calls, self.allocs = [], []

        def library(name):
            return types.SimpleNamespace(**{
                fn: (lambda *a, fn=fn: self.calls.append((name, fn, a)) or 0)
                for fn in build.SIGNATURES[name]})

        empty = torch.empty

        def spy(*shape, **kw):
            t = empty(*shape, **kw)
            self.allocs.append(t)
            return t

        monkeypatch.setattr(build, "library", library)
        monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
        monkeypatch.setattr(dispatch, "stream_of", lambda x: 0)
        monkeypatch.setattr(torch, "empty", spy)


def _z(dtype, *shape):
    return torch.zeros(*shape, dtype=dtype)


def _strip_args(b, hh, wd, c, dtype):
    return (_z(dtype, b, hh, wd, c), _z(dtype, b, hh, wd, c), _z(dtype, 3 * c, c),
            _z(dtype, 3 * c), _z(dtype, c) + 1, _z(dtype, c), _z(dtype, c, c), _z(dtype, c))


def _transition_args(b, hh, wd, cin, cout, dtype):
    return (_z(dtype, b, hh, wd, cin), _z(dtype, b, hh // 2, wd // 2, cout),
            _z(dtype, 3 * cout, cin), _z(dtype, 3 * cout), _z(dtype, cin) + 1,
            _z(dtype, cin), _z(dtype, cout, cout), _z(dtype, cout), _z(dtype, cout, cin),
            _z(dtype, cout))


def _workspace_offsets(elements, itemsize=2):
    at, offs = 0, []
    for n in elements:
        offs.append(at)
        at += -(-n * itemsize // 256) * 256
    return offs, at


@pytest.mark.parametrize("b,hh,wd,c,nh,win,residual", [
    (2, 240, 240, 96, 1, 8, True), (2, 120, 120, 192, 2, 4, True),
    (2, 88, 88, 144, 2, 8, False), (1, 44, 44, 288, 4, 4, True), (1, 8, 20, 144, 2, 4, True)])
def test_strips_bwd_takes_the_hopper_entry_with_one_workspace(monkeypatch, b, hh, wd, c, nh,
                                                              win, residual):
    """K5's bf16 call at the main paths' strip shapes (and an odd count of
    w4 windows) launches k5_window_block_strips_bwd_sm90 once, with the
    arguments its signature names, the geometry (B, H, W, c, heads, window,
    residual), and one bf16 workspace of LN(x), qkv, dO, dqkv, dLN(x) (256
    bytes aligned each): no o, lse or D buffer, nothing in fp32."""
    rec = _Recorder(monkeypatch)
    dispatch.reset_launches()
    dx = window_block_strips_bwd(*_strip_args(b, hh, wd, c, torch.bfloat16), num_heads=nh,
                                 window=win, residual=residual)
    (lib, fn, args), = rec.calls
    assert (lib, fn) == (SM90_BLOCK_BWD, "k5_window_block_strips_bwd_sm90")
    assert len(args) == len(build.SIGNATURES[lib][fn])
    assert args[-8:-1] == (b, hh, wd, c, nh, win, int(residual))
    m = b * hh * wd
    offs, size = _workspace_offsets([m * c, 3 * m * c, m * c, 3 * m * c, m * c])
    (ws,) = rec.allocs
    assert ws.dtype == torch.uint8 and ws.numel() == size
    assert list(args[8:13]) == [ws.data_ptr() + o for o in offs]
    assert args[13] == dx.data_ptr() and dx.shape == (b, hh, wd, c)
    assert dict(dispatch.variants) == {("window_block_strips_bwd", f"window={win}"): 1}


@pytest.mark.parametrize("b,hh,wd,cin,cout,nh,win", [
    (2, 88, 88, 144, 288, 4, 8), (2, 44, 44, 288, 576, 8, 4), (1, 120, 120, 192, 384, 4, 4),
    (1, 8, 20, 144, 288, 4, 4)])
def test_transition_bwd_takes_the_hopper_entry_with_one_workspace(monkeypatch, b, hh, wd, cin,
                                                                  cout, nh, win):
    """K9's bf16 call at the main paths' transitions launches
    k9_transition_bwd_sm90 once with the geometry (B, H, W, cin, cout,
    heads, window) and one bf16 workspace of LN(x), qkv, the shortcut, dO
    (pooled rows), [dq | dk | dv | dshort] and dLN(x): no o, lse or D."""
    rec = _Recorder(monkeypatch)
    dispatch.reset_launches()
    dx = transition_bwd(*_transition_args(b, hh, wd, cin, cout, torch.bfloat16),
                        num_heads=nh, window=win)
    (lib, fn, args), = rec.calls
    assert (lib, fn) == (SM90_BLOCK_BWD, "k9_transition_bwd_sm90")
    assert len(args) == len(build.SIGNATURES[lib][fn])
    assert args[-8:-1] == (b, hh, wd, cin, cout, nh, win)
    m = b * hh * wd
    offs, size = _workspace_offsets([m * cin, 3 * m * cout, m * cout, m // 4 * cout,
                                     4 * m * cout, m * cin])
    (ws,) = rec.allocs
    assert ws.dtype == torch.uint8 and ws.numel() == size
    assert list(args[10:16]) == [ws.data_ptr() + o for o in offs]
    assert args[16] == dx.data_ptr() and dx.shape == (b, hh, wd, cin)
    assert dict(dispatch.variants) == {("transition_bwd", f"window={win}"): 1}


@pytest.mark.parametrize("case", ["fp32", "head_dim_136", "window_16"])
def test_strips_and_transition_other_calls_keep_their_sources(monkeypatch, case):
    """fp32, head dim 136 and a window of 16 keep
    csrc/fused_attention_block_bwd.cu and csrc/fused_transition_bwd.cu,
    with their o, lse and D buffers."""
    rec = _Recorder(monkeypatch)
    dtype, c, nh, win = {"fp32": (torch.float32, 288, 4, 8),
                         "head_dim_136": (torch.bfloat16, 272, 2, 8),
                         "window_16": (torch.bfloat16, 288, 4, 16)}[case]
    window_block_strips_bwd(*_strip_args(1, 16, 16, c, dtype), num_heads=nh, window=win)
    transition_bwd(*_transition_args(1, 16, 16, 144, c, dtype), num_heads=nh, window=win)
    assert [(lib, fn) for lib, fn, _ in rec.calls] == [
        ("fused_attention_block_bwd", "k5_window_block_strips_bwd"),
        ("fused_transition_bwd", "k9_transition_bwd")]
    assert any(t.dtype == torch.float32 and t.dim() == 2 for t in rec.allocs)   # lse


def test_the_entry_points_are_registered_and_profiled():
    """The two entry points are csrc/block_bwd_sm90.cu's, with their
    CUDA-core counterparts' arguments less O, lse and D, and counted under
    the same wrappers in a profile."""
    k5 = build.SIGNATURES["fused_attention_block_bwd"]["k5_window_block_strips_bwd"]
    k9 = build.SIGNATURES["fused_transition_bwd"]["k9_transition_bwd"]
    new = build.SIGNATURES[SM90_BLOCK_BWD]
    # K5: x .. w_proj, xn, qkv, [o, lse], dout, [D], dqkv, dxn, dx, ints
    assert new["k5_window_block_strips_bwd_sm90"] == k5[:10] + k5[12:13] + k5[14:]
    # K9: x .. b_short, xn, qkv, shortcut, [o, lse], dout, [D], dcat, dxn, dx
    assert new["k9_transition_bwd_sm90"] == k9[:13] + k9[15:16] + k9[17:]
    text = SRC.read_text()
    for fn in ("k5_window_block_strips_bwd_sm90", "k9_transition_bwd_sm90"):
        assert f'extern "C" int {fn}(' in text
    assert profile_model.ENTRY_WRAPPER["k5_window_block_strips_bwd_sm90"] == \
        "window_block_strips_bwd"
    assert profile_model.ENTRY_WRAPPER["k9_transition_bwd_sm90"] == "transition_bwd"


# ------------------------------------------------- plain versions vs JAX


def _mk(seed):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return mk


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _rel_err(got, want):
    want = np.asarray(want)
    return float(np.abs(got.numpy() - want).max()) / float(np.abs(want).max())


@pytest.mark.parametrize("b,hh,wd,c,nh,win,residual", [
    (1, 8, 20, 144, 2, 4, True),    # five w4 windows a strip: the last tile holds one
    (1, 16, 16, 144, 2, 8, False),  # head dim 72 at w8
    (2, 4, 12, 64, 2, 4, True)])    # three w4 windows, head dim 32
def test_plain_k5_matches_jax_vjp_at_the_small_window_edges(b, hh, wd, c, nh, win, residual):
    """The plain K5 against `jax.vjp` of `_xla_strips`: dx to 2e-5 of its
    largest value."""
    mk = _mk(hh * wd + c)
    x, gy = mk(b, hh, wd, c), mk(b, hh, wd, c)
    w, bq = mk(c, 3 * c, scale=c ** -0.5), mk(3 * c)
    lns, lnb, wp, bp = mk(c) + 1, mk(c), mk(c, c, scale=c ** -0.5), mk(c)
    _, vjp = jax.vjp(lambda xx: fab._xla_strips(xx, w, bq, lns, lnb, wp, bp, nh, win,
                                                residual), jnp.asarray(x))
    want = vjp(jnp.asarray(gy))[0]
    got = window_block_strips_bwd(_t(x), _t(gy), _t(w, True), _t(bq), _t(lns), _t(lnb),
                                  _t(wp, True), _t(bp), num_heads=nh, window=win,
                                  residual=residual)
    assert _rel_err(got, want) <= 2e-5


@pytest.mark.parametrize("b,hh,wd,cin,cout,nh,win,tied", [
    (1, 8, 20, 72, 144, 2, 4, False),   # five w4 windows a strip, head dim 72
    (1, 8, 20, 72, 144, 2, 4, True),    # ... every cell four equal tokens
    (1, 16, 8, 48, 96, 2, 8, True)])    # w8, exact ties
def test_plain_k9_matches_jax_vjp_at_the_small_window_edges(b, hh, wd, cin, cout, nh, win,
                                                            tied):
    """The plain K9 against `jax.vjp` of `_xla_transition`: dx to 2e-5 of
    its largest value; with every 2x2 cell of four equal tokens, both
    max-pools tie exactly and both send the gradient to the cell's first
    token."""
    mk = _mk(hh * wd + cout + tied)
    x = mk(b, hh, wd, cin)
    if tied:
        x = np.repeat(np.repeat(x[:, ::2, ::2], 2, 1), 2, 2)
    gy = mk(b, hh // 2, wd // 2, cout)
    w, bq = mk(cin, 3 * cout, scale=cin ** -0.5), mk(3 * cout)
    lns, lnb = mk(cin) + 1, mk(cin)
    wp, bp = mk(cout, cout, scale=cout ** -0.5), mk(cout)
    wsh, bsh = mk(cin, cout, scale=cin ** -0.5), mk(cout)
    _, vjp = jax.vjp(lambda xx: ft._xla_transition(xx, w, bq, lns, lnb, wp, bp, wsh, bsh,
                                                   nh, win), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    got = transition_bwd(_t(x), _t(gy), _t(w, True), _t(bq), _t(lns), _t(lnb), _t(wp, True),
                         _t(bp), _t(wsh, True), _t(bsh), num_heads=nh, window=win)
    assert _rel_err(got, want) <= 2e-5
