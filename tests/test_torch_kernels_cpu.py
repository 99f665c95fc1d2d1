"""The port's kernel modules against the JAX package, on the CPU in fp32.

Each port wrapper is given CPU tensors, so it takes its plain PyTorch
version (the CUDA kernel itself runs only on the card: chip_smoke.py and
tests/test_torch_kernels_cuda.py). The same seeded numpy inputs go through
the JAX reference form (`_xla_mlp`, `_xla_strips`, `_xla_window_block`,
`_xla_transition`) and, for K4, K6 and K8, through the Pallas kernel in
interpret mode at the geometries of tests/test_fused_ops.py. Weights are
JAX-layout (in, out) on the JAX side and transposed for the port.

Tolerance: rtol = atol = 2e-5 in fp32, the bound tests/test_fused_ops.py
holds the Pallas kernels to (sums in another order, no other difference).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_transition as ft
from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
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
# hiera_l@352 group shapes in miniature and a global block (S = 484)
WINDOW_GEOMS = [(4, 16, 24, 2, 0), (4, 16, 24, 2, 5), (2, 16, 64, 8, 0),
                (2, 96, 32, 2, 160), (2, 36, 32, 2, 220), (2, 9, 16, 1, 55),
                (2, 484, 32, 2, 0)]


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
