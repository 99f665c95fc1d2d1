"""The port's kernel modules against the JAX package, on the CPU in fp32.

Each port wrapper is given CPU tensors, so it takes its plain PyTorch
version (the CUDA kernel itself runs only on the card: chip_smoke.py and
tests/test_torch_kernels_cuda.py). The same seeded numpy inputs go through
the JAX reference form (`_xla_mlp`, `_xla_strips`, `_xla_window_block`,
`_xla_transition`, `_xla_strips_rem`) and, for K4, K6, K8, K10 and K12,
through the Pallas kernel in interpret mode at the geometries of
tests/test_fused_ops.py. Weights are
JAX-layout (in, out) on the JAX side and transposed for the port.

Tolerance: rtol = atol = 2e-5 in fp32, the bound tests/test_fused_ops.py
holds the Pallas kernels to (sums in another order, no other difference).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.flash_attention as fa
import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_transition as ft
from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.flash_attention import flash_attention
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    long_sequence,
    strips_rem_supported,
)
from sam2unet_torch.ops.fused_mlp import fused_mlp
from sam2unet_torch.ops.fused_transition import fused_transition_block
from sam2unet_tpu.ops.pallas.fused_mlp import _xla_mlp

TOL = dict(rtol=2e-5, atol=2e-5)


def _mk(rng):
    """Activations and vectors ~ 0.3 N(0, 1); a 2-D weight (fan_in, out)
    ~ N(0, 1/fan_in), so outputs stay O(1) at every width."""
    def mk(*sh):
        scale = 1.0 / np.sqrt(sh[0]) if len(sh) == 2 and sh[0] >= 16 else 0.3
        return (rng.standard_normal(sh) * scale).astype(np.float32)
    return mk


def _t(a, transpose=False):
    a = a.T if transpose else a
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("shape,hidden", [((2, 7, 9, 32), 128), ((5, 48), 192),
                                          ((3, 4, 4, 144), 576)])
def test_k1_tail_matches_xla_mlp(shape, hidden):
    mk = _mk(np.random.default_rng(0))
    c = shape[-1]
    x, w1, b1, w2, b2 = mk(*shape), mk(c, hidden), mk(hidden), mk(hidden, c), mk(c)
    lns, lnb = mk(c) + 1, mk(c)
    want = _xla_mlp(jnp.asarray(x), w1, b1, w2, b2, lns, lnb, residual=True)
    got = fused_mlp(_t(x), _t(w1, True), _t(b1), _t(w2, True), _t(b2),
                    ln_w=_t(lns), ln_b=_t(lnb), residual=True)
    _close(got, want)


@pytest.mark.parametrize("shape", [(2, 8, 8, 24), (6, 144), (2, 11, 11, 48)])
def test_k1_adapter_matches_xla_mlp(shape):
    mk = _mk(np.random.default_rng(1))
    c, hidden = shape[-1], 32
    x, w1, b1, w2, b2 = mk(*shape), mk(c, hidden), mk(hidden), mk(hidden, c), mk(c)
    want = _xla_mlp(jnp.asarray(x), w1, b1, w2, b2, residual=True,
                    gelu_out=True)
    got = fused_mlp(_t(x), _t(w1, True), _t(b1), _t(w2, True), _t(b2),
                    residual=True, gelu_out=True)
    _close(got, want)


# ------------------------------------------------------------- K4 / K6


def _block_weights(mk, c):
    w, b = mk(c, 3 * c), mk(3 * c)
    lns, lnb, wp, bp = mk(c) + 1, mk(c), mk(c, c), mk(c)
    jax_args = (w, b, lns, lnb, wp, bp)
    port_args = (_t(w, True), _t(b), _t(lns), _t(lnb), _t(wp, True), _t(bp))
    return jax_args, port_args


# (batch, H, W, c, heads, window, residual) — test_fused_ops.py:483-486
STRIP_GEOMS = [(2, 8, 16, 24, 2, 4, True), (1, 16, 16, 64, 8, 4, True),
               (2, 8, 8, 24, 2, 8, False), (2, 16, 16, 16, 1, 8, True)]


@pytest.mark.parametrize("geom", STRIP_GEOMS)
def test_k4_strips_matches_xla_strips(geom):
    b, hh, wd, c, nh, win, res = geom
    mk = _mk(np.random.default_rng(13))
    x = mk(b, hh, wd, c)
    ja, pa = _block_weights(mk, c)
    want = fab._xla_strips(jnp.asarray(x), *ja, nh, win, res)
    got = fused_window_block_strips(_t(x), *pa, num_heads=nh, window=win,
                                    residual=res)
    _close(got, want)


@pytest.mark.parametrize("geom", STRIP_GEOMS[:3])
def test_k4_strips_matches_pallas_interpret(geom):
    b, hh, wd, c, nh, win, res = geom
    mk = _mk(np.random.default_rng(14))
    x = mk(b, hh, wd, c)
    ja, pa = _block_weights(mk, c)
    want = fab._fused_strips_fwd_impl(jnp.asarray(x), *ja, nh, win, res,
                                      interpret=True)
    got = fused_window_block_strips(_t(x), *pa, num_heads=nh, window=win,
                                    residual=res)
    _close(got, want)


# (windows, S, c, heads, n_pad) — test_fused_ops.py:321-324 plus the
# hiera_l@352 group shapes in miniature, a global block (S = 484) and a
# long one past 1024 tokens (the JAX form's streaming branch)
WINDOW_GEOMS = [(4, 16, 24, 2, 0), (4, 16, 24, 2, 5), (2, 16, 64, 8, 0),
                (2, 96, 32, 2, 160), (2, 36, 32, 2, 220), (2, 9, 16, 1, 55),
                (2, 484, 32, 2, 0), (1, 1089, 32, 2, 0)]


@pytest.mark.parametrize("geom", WINDOW_GEOMS)
def test_k6_window_block_matches_xla(geom):
    nw, s, c, nh, n_pad = geom
    mk = _mk(np.random.default_rng(11))
    x = mk(nw, s, c)
    ja, pa = _block_weights(mk, c)
    want = fab._xla_window_block(jnp.asarray(x), *ja, nh, n_pad, True)
    got = fused_window_block(_t(x), *pa, num_heads=nh, n_pad=n_pad)
    _close(got, want)


@pytest.mark.parametrize("geom", WINDOW_GEOMS[:4])
def test_k6_window_block_matches_pallas_interpret(geom):
    nw, s, c, nh, n_pad = geom
    mk = _mk(np.random.default_rng(12))
    x = mk(nw, s, c)
    ja, pa = _block_weights(mk, c)
    mask = jnp.zeros((8, 128), jnp.float32)
    lm = jnp.zeros((1, 8), jnp.float32)
    want = fab._fused_window_block_fwd_impl(jnp.asarray(x), *ja, mask, lm, nh,
                                            n_pad, True, False, interpret=True)
    got = fused_window_block(_t(x), *pa, num_heads=nh, n_pad=n_pad)
    _close(got, want)


# ------------------------------------------------------------------ K8

# (batch, H, W, cin, cout, heads, window) — test_fused_ops.py:738-741
TRANSITION_GEOMS = [(2, 16, 24, 24, 48, 2, 8), (1, 8, 16, 24, 48, 4, 4),
                    (1, 16, 16, 32, 64, 8, 8)]


def _transition_inputs(seed, geom):
    b, hh, wd, cin, cout, nh, win = geom
    mk = _mk(np.random.default_rng(seed))
    x = mk(b, hh, wd, cin)
    w, bq, lns, lnb = mk(cin, 3 * cout), mk(3 * cout), mk(cin) + 1, mk(cin)
    wp, bp, wsh, bsh = mk(cout, cout), mk(cout), mk(cin, cout), mk(cout)
    ja = (w, bq, lns, lnb, wp, bp, wsh, bsh)
    pa = (_t(w, True), _t(bq), _t(lns), _t(lnb), _t(wp, True), _t(bp),
          _t(wsh, True), _t(bsh))
    return x, ja, pa


@pytest.mark.parametrize("geom", TRANSITION_GEOMS)
def test_k8_transition_matches_xla(geom):
    x, ja, pa = _transition_inputs(17, geom)
    nh, win = geom[5], geom[6]
    want = ft._xla_transition(jnp.asarray(x), *ja, nh, win)
    got = fused_transition_block(_t(x), *pa, num_heads=nh, window=win)
    assert got.shape == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("geom", TRANSITION_GEOMS)
def test_k8_transition_matches_pallas_interpret(geom):
    x, ja, pa = _transition_inputs(18, geom)
    nh, win = geom[5], geom[6]
    want = ft._fused_transition_fwd_impl(jnp.asarray(x), *ja, nh, win,
                                         interpret=True)
    got = fused_transition_block(_t(x), *pa, num_heads=nh, window=win)
    _close(got, want)


# ----------------------------------------------------------------- K10

# (batch, Sq, Sk, heads, d) — test_fused_ops.py:816-818
FLASH_GEOMS = [(1, 960, 960, 1, 32), (2, 160, 320, 2, 16), (1, 48, 1280, 1, 8)]


@pytest.mark.parametrize("geom", FLASH_GEOMS)
def test_k10_flash_attention_matches_pallas_interpret(geom):
    b, sq, sk, nh, d = geom
    rng = np.random.default_rng(21)
    q, k, v = (rng.standard_normal(sh).astype(np.float32) * 0.5
               for sh in ((b, sq, nh, d), (b, sk, nh, d), (b, sk, nh, d)))
    want, want_lse = fa._stream_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), 1.0 / math.sqrt(d),
                                         interpret=True)
    got, lse = flash_attention(_t(q), _t(k), _t(v), return_lse=True)
    assert lse.shape == (b * nh, sq)
    _close(got, want)
    _close(lse, np.asarray(want_lse).reshape(b * nh, sq))


def test_k10_takes_strided_views_of_the_qkv_output():
    """q/k/v as the long-form blocks pass them: channel slices of one QKV
    buffer (rows of 3c), against the same values made contiguous."""
    rng = np.random.default_rng(3)
    qkv = _t(rng.standard_normal((2, 200, 3, 2, 16)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert q.stride() == (200 * 96, 96, 16, 1)
    got, lse = flash_attention(q, k, v, return_lse=True)
    want, want_lse = flash_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), return_lse=True)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)


@pytest.mark.parametrize("s,c,long", [(3600, 384, True), (4096, 256, True),
                                      (484, 576, False), (196, 384, False),
                                      (1024, 384, True), (1024, 256, False)])
def test_long_sequence_gate_matches_jax(s, c, long):
    """The port's copy of the live-VMEM gate of `_fused_window_block_vjp`
    (fused_attention_block.py:303-305) at the shipped global blocks and
    around its edge."""
    s16 = s + (-s) % 16
    assert (8 * s16 * s16 + 14 * s16 * c > 12 * 1024 * 1024) is long
    assert long_sequence(s, c) is long


# ----------------------------------------------------------------- K12

# (batch, H, W, c, heads, window, residual) — test_fused_ops.py:586-591
REM_GEOMS = [(1, 22, 22, 24, 2, 16, True), (1, 30, 30, 32, 4, 7, True),
             (2, 32, 32, 24, 2, 14, True), (1, 28, 28, 24, 2, 14, True),
             (2, 12, 12, 24, 2, 5, False), (2, 12, 18, 24, 2, 5, True)]


@pytest.mark.parametrize("geom", REM_GEOMS)
def test_k12_strips_rem_matches_xla_strips_rem(geom):
    b, hh, wd, c, nh, win, res = geom
    mk = _mk(np.random.default_rng(23))
    x = mk(b, hh, wd, c)
    ja, pa = _block_weights(mk, c)
    want = fab._xla_strips_rem(jnp.asarray(x), *ja, nh, win, res)
    got = fused_window_block_strips_rem(_t(x), *pa, num_heads=nh, window=win,
                                        residual=res)
    _close(got, want)


@pytest.mark.parametrize("geom", REM_GEOMS)
def test_k12_strips_rem_matches_pallas_interpret(geom):
    b, hh, wd, c, nh, win, res = geom
    mk = _mk(np.random.default_rng(24))
    x = mk(b, hh, wd, c)
    ja, pa = _block_weights(mk, c)
    want = fab._fused_strips_rem_fwd_impl(jnp.asarray(x), *ja, nh, win, res,
                                          interpret=True)
    got = fused_window_block_strips_rem(_t(x), *pa, num_heads=nh, window=win,
                                        residual=res)
    _close(got, want)


# (H, W, window, c, heads): hiera_s@960 stages 3 and 4 take the remainder
# strips; hiera_l@352 stages 3 and 4 (n_w = 2) take the valid groups
@pytest.mark.parametrize("geom,want", [((60, 60, 14, 384, 4), True),
                                       ((30, 30, 7, 768, 8), True),
                                       ((22, 22, 16, 576, 8), False),
                                       ((11, 11, 8, 1152, 16), False)])
def test_rem_strip_gate_matches_jax(geom, want):
    hh, wd, win, c, nh = geom
    assert fab.strips_rem_supported(hh, wd, win, c, nh) is want
    assert strips_rem_supported(hh, wd, win) is want


# ------------------------------------------------------------ dispatch


def test_cpu_tensors_take_the_plain_version_without_building():
    from sam2unet_torch.ops import build

    mk = _mk(np.random.default_rng(2))
    x, w1, b1, w2, b2 = mk(4, 16), mk(32, 16), mk(32), mk(16, 32), mk(16)
    dispatch.reset_launches()
    with dispatch.force_plain():
        a = fused_mlp(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    b = fused_mlp(_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    assert torch.equal(a, b)
    assert sum(dispatch.launches.values()) == 0
    assert not build._libs


def test_kernel_arg_checks_reject_what_the_kernels_do_not_take():
    x = torch.zeros(4, 16)
    with pytest.raises(TypeError):
        dispatch.check_kernel_args(x.double())
    with pytest.raises(TypeError):
        dispatch.check_kernel_args(x, torch.zeros(16, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        dispatch.check_kernel_args(x, torch.zeros(16, 4).t())
    assert dispatch.check_kernel_args(x.bfloat16()) == 1
    assert dispatch.check_kernel_args(x) == 0
