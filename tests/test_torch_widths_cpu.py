"""Every width the JAX MLP, LN-matmul and window kernels take, on the CPU in
fp32: K1, K2, K3, K15, K16, the window block K6 / K7 in every mode, the
strips K4 / K5, the remainder strips K12 / K13 and the transition K8 / K9 at
widths that are not a multiple of 8 and at LN widths past 2048.

On the card these widths run the kernels of csrc/gemm_any.cu (the LN and
GEMM passes at any width) and csrc/attention_any*.cu (the attention at any
head dim); on CPU tensors each wrapper takes its plain version, which is
what these tests hold against the JAX package: its Pallas kernels in
interpret mode where the launcher takes `interpret` (the window, strip,
remainder and transition impls, as tests/test_fused_ops.py runs them), its
`_xla_*` forms and custom VJPs otherwise, and at the widths past 2048 (where
interpret mode would take most of the file's time). K2 and K3 are held to
`jax.vjp` of `_xla_mlp`: the Pallas `_mlp_bwd_dx` and `_adapter_bwd`
differentiate tanh-GELU, the port's kernels the exact-erf GELU of the JAX
package's `_xla_mlp`. Then the wrapper checks take every width here.
The kernels themselves are held against their plain versions on the card
by tests/test_torch_kernels_cuda.py and chip_smoke.py's `widths` path.

Geometries: the JAX tests' K15 / K16 (x (5, 4, 4, 12), W 12 -> 36), K15 at
C 13 -> 20 and 2060 -> 24; K1 / K2 / K3 at C 12 (hidden 8), 13 (26), 20
(32) and 2056 (64; K3's adapter 32); the window block at c 26 over 2 heads,
20 over 4 and 2064 over 8 on (2 windows, 16 tokens); the strips on (2, 16,
16, 26) w8 and (2, 30, 30, 26) w8 over 2 heads; the transition (2, 16, 16,
20) -> 40 w8 over 4 heads and (1, 8, 8, 2056) -> 48 w4 over 4.

Tolerances: the JAX tests' bounds, forward rtol = atol = 2e-5, gradients
rtol 1e-4 and atol 1e-5; against the interpret-mode backward kernels the
bounds tests/test_torch_bwd_modes_cpu.py holds them to (the weight-gradient
kernel rtol 2e-4, atol 2e-5; the remainder strips rtol 2e-4, atol 2e-4).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_mlp as fm
import sam2unet_tpu.ops.pallas.fused_transition as ft
from sam2unet_torch.ops.fused_attention_block import (
    _check_block,
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    strips_rem_bwd_regime,
    window_block_bwd,
    window_block_strips_bwd,
    window_block_strips_rem_bwd,
)
from sam2unet_torch.ops.fused_mlp import (
    _check_mlp,
    _ln_matmul_kernel,
    adapter_bwd,
    fused_ln_matmul,
    fused_ln_qkv,
    fused_mlp,
    mlp_bwd_dx,
)
from sam2unet_torch.ops.fused_transition import (
    _check_transition,
    fused_transition_block,
    transition_bwd,
)
from sam2unet_torch.ops.windowing import grid_window_mask

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
INTERPRET_WGRAD_TOL = dict(rtol=2e-4, atol=2e-5)
INTERPRET_REM_TOL = dict(rtol=2e-4, atol=2e-4)
WIDE = 2048   # the widths past this are held against the `_xla_*` forms

# (C, hidden) of K1 / K2 / K3
MLP_WIDTHS = [(12, 8), (13, 26), (20, 32), (2056, 64)]
# (c, heads) of the window block on (2 windows, 16 tokens)
BLOCK_WIDTHS = [(26, 2), (20, 4), (2064, 8)]
# (batch, H, W, cin, cout, heads, window) of the transition
TRANSITION_GEOMS = [(2, 16, 16, 20, 40, 4, 8), (1, 8, 8, 2056, 48, 4, 4)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng):
    """Activations and vectors ~ 0.3 N(0, 1); a 2-D weight (fan_in, out)
    ~ N(0, 1/fan_in), so outputs stay O(1) at every width."""
    def mk(*sh):
        scale = 1.0 / np.sqrt(sh[0]) if len(sh) == 2 and sh[0] >= 8 else 0.3
        return (rng.standard_normal(sh) * scale).astype(np.float32)
    return mk


def _t(a, transpose=False):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _n(t):
    return t.detach().numpy()


def _close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(_n(got), np.asarray(want), **tol)


# ------------------------------------------------------------ K15, K16


@pytest.mark.parametrize("add_bias", [True, False])
def test_k15_k16_at_the_jax_tests_width(add_bias):
    """The JAX test's geometry (tests/test_fused_ops.py:84-114): x (5, 4, 4,
    12), W 12 -> 36, with and without the bias: K15 and K16 forward against
    the JAX `fused_ln_matmul` / `fused_ln_qkv`, and the gradients of x and W
    under autograd against `jax.grad` of the JAX test's loss."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 4, 4, 12)).astype(np.float32)
    w = (rng.standard_normal((12, 36)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(36) * 0.3).astype(np.float32)
    scale, bias = (rng.standard_normal(12).astype(np.float32) for _ in range(2))
    jargs = [jnp.asarray(a) for a in (x, w, b, scale, bias)]
    pargs = [_t(x), _t(w, True), _t(b), _t(scale), _t(bias)]
    _close(fused_ln_matmul(*pargs, add_bias=add_bias),
           fm.fused_ln_matmul(*jargs, add_bias))
    for got, want in zip(fused_ln_qkv(*pargs, add_bias=add_bias),
                         fm.fused_ln_qkv(*jargs, add_bias)):
        _close(got, want)

    def loss(x, w):
        q, k, v = fm.fused_ln_qkv(x, w, *jargs[2:], add_bias)
        return (q * 2 + k - v).sum()

    want = jax.grad(loss, argnums=(0, 1))(jargs[0], jargs[1])
    leaves = [pargs[0].requires_grad_(True), pargs[1].requires_grad_(True)]
    q, k, v = fused_ln_qkv(*leaves, *pargs[2:], add_bias=add_bias)
    (q * 2 + k - v).sum().backward()
    _close(leaves[0].grad, want[0], GRAD_TOL)
    _close(leaves[1].grad.t(), want[1], GRAD_TOL)


@pytest.mark.parametrize("c,n", [(13, 20), (2060, 24)])
def test_k15_at_ragged_and_wide_widths(c, n):
    """K15 at C 13 -> 20 and at C 2060 -> 24 (an LN row past 2048, C % 8 !=
    0) against the JAX `fused_ln_matmul`, and its gradients against
    `jax.vjp` of it."""
    mk = _mk(np.random.default_rng(c))
    x, w, b, scale, bias = mk(3, 5, c), mk(c, n), mk(n), mk(c) + 1, mk(c)
    jargs = [jnp.asarray(a) for a in (x, w, b, scale, bias)]
    gy = mk(3, 5, n)
    want, vjp = jax.vjp(lambda xx, ww: fm.fused_ln_matmul(xx, ww, *jargs[2:]),
                        jargs[0], jargs[1])
    leaves = [_t(x).requires_grad_(True), _t(w, True).requires_grad_(True)]
    got = fused_ln_matmul(*leaves, _t(b), _t(scale), _t(bias))
    _close(got, want)
    got.backward(_t(gy))
    want_dx, want_dw = vjp(jnp.asarray(gy))
    _close(leaves[0].grad, want_dx, GRAD_TOL)
    _close(leaves[1].grad.t(), want_dw, GRAD_TOL)


# ------------------------------------------------------------ K1, K2, K3


def _mlp_inputs(c, hd, seed):
    mk = _mk(np.random.default_rng(seed))
    return (mk(2, 3, c), mk(c, hd), mk(hd), mk(hd, c), mk(c), mk(c) + 1,
            mk(c), mk(2, 3, c))


def _port_mlp(x, w1, b1, w2, b2):
    return [_t(x), _t(w1, True), _t(b1), _t(w2, True), _t(b2)]


@pytest.mark.parametrize("mode", ["ln tail", "adapter", "no ln, no residual"])
@pytest.mark.parametrize("c,hd", MLP_WIDTHS)
def test_k1_matches_jax_in_each_mode(c, hd, mode):
    """K1's forward in each of the JAX package's modes (the LN tail, the
    adapter with `gelu_out`, neither LN nor the residual) against the JAX
    `fused_mlp`, and under autograd with trainable weights (the plain
    recompute, or K3's route for the adapter) against `jax.grad`."""
    x, w1, b1, w2, b2, lns, lnb, gy = _mlp_inputs(c, hd, c + hd)
    kw = {"ln tail": dict(residual=True), "adapter": dict(residual=True,
                                                          gelu_out=True),
          "no ln, no residual": {}}[mode]
    ln = mode == "ln tail"
    jln = dict(ln_scale=jnp.asarray(lns), ln_bias=jnp.asarray(lnb)) if ln else {}
    pln = dict(ln_w=_t(lns), ln_b=_t(lnb)) if ln else {}
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    want, vjp = jax.vjp(lambda *a: fm.fused_mlp(*a, **jln, **kw), *jargs)
    leaves = [t.requires_grad_(True) for t in _port_mlp(x, w1, b1, w2, b2)]
    got = fused_mlp(*leaves, **pln, **kw)
    _close(got, want)
    got.backward(_t(gy))
    for leaf, w, transpose in zip(leaves, vjp(jnp.asarray(gy)),
                                  (False, True, False, True, False)):
        _close(leaf.grad.t() if transpose else leaf.grad, w, GRAD_TOL)


@pytest.mark.parametrize("ln", [True, False], ids=["ln tail", "no ln, no residual"])
@pytest.mark.parametrize("c,hd", MLP_WIDTHS)
def test_k2_matches_jax_vjp(c, hd, ln):
    """K2 (dx of the frozen MLP) in the LN tail's mode and without LN and
    the residual: `mlp_bwd_dx`, and `fused_mlp` under autograd with only x
    trainable (K2's route), against `jax.vjp` of `_xla_mlp`. (The Pallas
    `_mlp_bwd_dx` differentiates tanh-GELU, fused_mlp.py:347, a function the
    port's exact-erf K2 does not compute: the port is held to the erf form
    that the JAX package's custom VJP takes on the CPU.)"""
    x, w1, b1, w2, b2, lns, lnb, gy = _mlp_inputs(c, hd, 100 + c + hd)
    res = ln
    jl = (jnp.asarray(lns), jnp.asarray(lnb)) if ln else (None, None)
    _, vjp = jax.vjp(lambda xx: fm._xla_mlp(xx, w1, b1, w2, b2, *jl,
                                            residual=res), jnp.asarray(x))
    want = vjp(jnp.asarray(gy))[0]
    pl = (_t(lns), _t(lnb)) if ln else (None, None)
    pw = _port_mlp(x, w1, b1, w2, b2)
    _close(mlp_bwd_dx(_t(x), _t(gy), *pw[1:], *pl, residual=res), want,
           GRAD_TOL)
    xt = pw[0].requires_grad_(True)
    fused_mlp(xt, *pw[1:], *pl, residual=res).backward(_t(gy))
    _close(xt.grad, want, GRAD_TOL)


@pytest.mark.parametrize("c,hd", MLP_WIDTHS[:3] + [(2056, 32)])
def test_k3_matches_jax_vjp(c, hd):
    """K3 (the adapter's dx and four weight gradients) against `jax.vjp` of
    `_xla_mlp` with `gelu_out` (the Pallas `_adapter_bwd` differentiates
    tanh-GELU, as K2's does)."""
    x, w1, b1, w2, b2, _, _, gy = _mlp_inputs(c, hd, 200 + c + hd)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    _, vjp = jax.vjp(lambda *a: fm._xla_mlp(*a, residual=True, gelu_out=True),
                     *jargs)
    pw = _port_mlp(x, w1, b1, w2, b2)
    got = adapter_bwd(pw[0], _t(gy), *pw[1:])
    for g, w, transpose in zip(got, vjp(jnp.asarray(gy)),
                               (False, True, False, True, False)):
        _close(g.t() if transpose else g, w, GRAD_TOL)


# ------------------------------------------------- window block K6, K7


def _block_params(rng, c):
    """(JAX weights, the port's): w_qkv and w_proj transposed to (out, in)."""
    mk = _mk(rng)
    jax_args = (mk(c, 3 * c), mk(3 * c), mk(c) + 1, mk(c), mk(c, c), mk(c))
    w, b, lns, lnb, wp, bp = jax_args
    port_args = (_t(w, True), _t(b), _t(lns), _t(lnb), _t(wp, True), _t(bp))
    return [jnp.asarray(a) for a in jax_args], port_args


@pytest.mark.parametrize("n_pad", [0, 5])
@pytest.mark.parametrize("c,nh", BLOCK_WIDTHS)
def test_k6_k7_window_block(c, nh, n_pad):
    """K6 forward against `_fused_window_block_fwd_impl` in interpret mode
    (`_xla_window_block` past 2048) and dx against `jax.vjp` of the XLA
    form; without the pad key also K7 against `_fused_window_block_bwd_impl`
    in interpret mode."""
    rng = np.random.default_rng(c + n_pad)
    ja, pa = _block_params(rng, c)
    x, gy = _mk(rng)(2, 16, c), _mk(rng)(2, 16, c)
    jx, jgy = jnp.asarray(x), jnp.asarray(gy)
    want, vjp = jax.vjp(lambda xx: fab._xla_window_block(xx, *ja, nh, n_pad,
                                                         True), jx)
    want_dx = vjp(jgy)[0]
    if c <= WIDE:
        mask, lm = jnp.zeros((8, 128), jnp.float32), jnp.zeros((1, 8), jnp.float32)
        kernel = fab._fused_window_block_fwd_impl(jx, *ja, mask, lm, nh, n_pad,
                                                  True, False, interpret=True)
        _close(fused_window_block(_t(x), *pa, num_heads=nh, n_pad=n_pad), kernel)
        if n_pad == 0:
            kdx = fab._fused_window_block_bwd_impl(
                jx, jgy, *ja[:5], nh, True, weight_grads=False,
                interpret=True)[0]
            np.testing.assert_allclose(np.asarray(kdx), np.asarray(want_dx),
                                       **GRAD_TOL)
    xt = _t(x).requires_grad_(True)
    got = fused_window_block(xt, *pa, num_heads=nh, n_pad=n_pad)
    _close(got, want)
    got.backward(_t(gy))
    _close(xt.grad, want_dx, GRAD_TOL)
    if n_pad == 0:
        _close(window_block_bwd(_t(x), _t(gy), *pa, num_heads=nh), want_dx,
               GRAD_TOL)


@pytest.mark.parametrize("c,nh", BLOCK_WIDTHS)
def test_k6_k7_masked(c, nh):
    """The masked whole-grid mode on a 4 x 4 grid, window 3 (S 16, two
    images), forward and dx, against the JAX masked K6 / K7 in interpret
    mode (the JAX `fused_window_block` under its XLA form past 2048)."""
    rng = np.random.default_rng(30 + c)
    ja, pa = _block_params(rng, c)
    x, gy = _mk(rng)(2, 16, c), _mk(rng)(2, 16, c)
    jx, jgy = jnp.asarray(x), jnp.asarray(gy)
    mask_np, lm_np = grid_window_mask(4, 4, 3)
    mask, lm = jnp.asarray(mask_np), jnp.asarray(lm_np)
    if c <= WIDE:
        want = fab._fused_window_block_fwd_impl(jx, *ja, mask, lm, nh, 0, True,
                                                True, interpret=True)
        want_dx = fab._fused_window_block_bwd_impl(
            jx, jgy, *ja[:5], nh, True, weight_grads=False, attn_mask=mask,
            pad_logmult=lm, interpret=True)[0]
    else:
        want, vjp = jax.vjp(lambda xx: fab._xla_window_block(
            xx, *ja, nh, 0, True, mask, lm), jx)
        want_dx = vjp(jgy)[0]
    pm, plm = torch.from_numpy(mask_np), torch.from_numpy(lm_np)
    _close(fused_window_block(_t(x), *pa, num_heads=nh, attn_mask=pm,
                              pad_logmult=plm), want)
    _close(window_block_bwd(_t(x), _t(gy), *pa, num_heads=nh, attn_mask=pm,
                            pad_logmult=plm), want_dx, GRAD_TOL)


@pytest.mark.parametrize("c,nh", BLOCK_WIDTHS)
def test_k7_weight_gradient_mode(c, nh):
    """K7's weight-gradient mode, all seven outputs, against
    `_fused_window_block_bwd_impl(weight_grads=True)` in interpret mode and
    `jax.vjp` of `_xla_window_block` (the latter alone past 2048)."""
    rng = np.random.default_rng(40 + c)
    ja, pa = _block_params(rng, c)
    x, gy = _mk(rng)(2, 16, c), _mk(rng)(2, 16, c)
    jx, jgy = jnp.asarray(x), jnp.asarray(gy)
    _, vjp = jax.vjp(lambda *a: fab._xla_window_block(*a, nh, 0, True),
                     jx, *ja)
    wants = [vjp(jgy)]
    if c <= WIDE:
        wants.append(fab._fused_window_block_bwd_impl(
            jx, jgy, *ja[:5], nh, True, weight_grads=True, interpret=True))
    got = window_block_bwd(_t(x), _t(gy), *pa, num_heads=nh, weight_grads=True)
    assert len(got) == 7
    layout = (False, True, False, False, False, True, False)
    for want in wants:
        for g, w, transpose in zip(got, want, layout):
            np.testing.assert_allclose(_n(g.t() if transpose else g),
                                       np.asarray(w), **INTERPRET_WGRAD_TOL)


# ----------------------------------------- strips K4, K5; K12, K13


def test_k4_k5_strips():
    """K4 and K5 on (2, 16, 16, 26) window 8 over 2 heads (head dim 13)
    against `_fused_strips_fwd_impl` / `_fused_strips_bwd_impl` in interpret
    mode."""
    b, hh, c, nh, win = 2, 16, 26, 2, 8
    rng = np.random.default_rng(50)
    ja, pa = _block_params(rng, c)
    x, gy = _mk(rng)(b, hh, hh, c), _mk(rng)(b, hh, hh, c)
    jx, jgy = jnp.asarray(x), jnp.asarray(gy)
    _close(fused_window_block_strips(_t(x), *pa, num_heads=nh, window=win),
           fab._fused_strips_fwd_impl(jx, *ja, nh, win, True, interpret=True))
    _close(window_block_strips_bwd(_t(x), _t(gy), *pa, num_heads=nh,
                                   window=win),
           fab._fused_strips_bwd_impl(jx, jgy, *ja[:5], nh, win, True,
                                      interpret=True), GRAD_TOL)


def test_k12_k13_remainder_strips():
    """K12 and K13 on (2, 30, 30, 26) window 8 over 2 heads against
    `_fused_strips_rem_fwd_impl` and the JAX remainder backward of the
    geometry's regime (`_fused_strips_rem_bwd_impl`, K13a, or
    `_fused_strips_rem_bwd_jw_impl`, K13b) in interpret mode."""
    b, hh, c, nh, win = 2, 30, 26, 2, 8
    rng = np.random.default_rng(51)
    ja, pa = _block_params(rng, c)
    x, gy = _mk(rng)(b, hh, hh, c), _mk(rng)(b, hh, hh, c)
    jx, jgy = jnp.asarray(x), jnp.asarray(gy)
    _close(fused_window_block_strips_rem(_t(x), *pa, num_heads=nh, window=win),
           fab._fused_strips_rem_fwd_impl(jx, *ja, nh, win, True,
                                          interpret=True))
    if strips_rem_bwd_regime(hh, hh, win, c, nh, 4) == "K13b":
        kernel = fab._fused_strips_rem_bwd_jw_impl(jx, jgy, *ja[:5], nh, win,
                                                   True, interpret=True)
    else:
        kernel = fab._fused_strips_rem_bwd_impl(jx, jgy, *ja[:5], nh, win,
                                                True, interpret=True)
    np.testing.assert_allclose(
        _n(window_block_strips_rem_bwd(_t(x), _t(gy), *pa, num_heads=nh,
                                       window=win)),
        np.asarray(kernel), **INTERPRET_REM_TOL)


# ------------------------------------------------------ transition K8, K9


def _transition_inputs(seed, geom):
    b, hh, wd, cin, cout, nh, win = geom
    mk = _mk(np.random.default_rng(seed))
    x = mk(b, hh, wd, cin)
    w, bq, lns, lnb = mk(cin, 3 * cout), mk(3 * cout), mk(cin) + 1, mk(cin)
    wp, bp, wsh, bsh = mk(cout, cout), mk(cout), mk(cin, cout), mk(cout)
    ja = [jnp.asarray(a) for a in (w, bq, lns, lnb, wp, bp, wsh, bsh)]
    pa = (_t(w, True), _t(bq), _t(lns), _t(lnb), _t(wp, True), _t(bp),
          _t(wsh, True), _t(bsh))
    gy = mk(b, hh // 2, wd // 2, cout)
    return x, gy, ja, pa


@pytest.mark.parametrize("geom", TRANSITION_GEOMS)
def test_k8_k9_transition(geom):
    """K8 and K9 against `_fused_transition_fwd_impl` and
    `_transition_bwd_impl` in interpret mode (past 2048, `_xla_transition`
    and `jax.vjp` of it)."""
    x, gy, ja, pa = _transition_inputs(60 + geom[3], geom)
    nh, win = geom[5], geom[6]
    jx, jgy = jnp.asarray(x), jnp.asarray(gy)
    if geom[3] <= WIDE:
        want = ft._fused_transition_fwd_impl(jx, *ja, nh, win, interpret=True)
        w, bq, lns, lnb, wp, _, wsh, bsh = ja
        want_dx = ft._transition_bwd_impl(jx, jgy, w, bq, lns, lnb, wp, wsh,
                                          bsh, nh, win, interpret=True)
    else:
        want, vjp = jax.vjp(lambda xx: ft._xla_transition(xx, *ja, nh, win), jx)
        want_dx = vjp(jgy)[0]
    got = fused_transition_block(_t(x), *pa, num_heads=nh, window=win)
    assert got.shape == tuple(want.shape)
    _close(got, want)
    _close(transition_bwd(_t(x), _t(gy), *pa, num_heads=nh, window=win),
           want_dx, GRAD_TOL)


# ---------------------------------------------------------- the checks


def test_wrapper_checks_take_every_width_here():
    """`_check_mlp`, `_check_block` and `_check_transition` pass every width
    above (the kernels' launchers route them to csrc/gemm_any.cu); K16
    refuses only a W whose rows do not split into q, k and v."""
    z = torch.zeros
    with pytest.raises(ValueError, match="split"):
        _ln_matmul_kernel(z(2, 12), z(35, 12), z(35), z(12), z(12),
                          add_bias=True, split=True)
    for c, hd in MLP_WIDTHS + [(2056, 32)]:
        assert _check_mlp(z(2, c), z(hd, c), z(hd), z(c, hd), z(c), z(c), z(c),
                          True) == (c, hd, c)
    for c, nh in BLOCK_WIDTHS + [(26, 2)]:
        assert _check_block(z(2, 16, c), c, z(3 * c, c), z(3 * c), z(c), z(c),
                            z(c, c), z(c), nh) == 0
    for _, _, _, cin, cout, nh, _ in TRANSITION_GEOMS:
        assert _check_transition(
            z(1, 8, 8, cin), 4, z(3 * cout, cin), z(3 * cout), z(cin), z(cin),
            z(cout, cout), z(cout), z(cout, cin), z(cout), nh) == (0, cout)
