"""The JAX package's kernel entry points that no model calls, against the
port's counterparts, on the CPU: K15 `fused_ln_matmul`, K16 `fused_ln_qkv`,
K2 in the frozen `fused_mlp`'s no-LN and no-residual modes, and the masked
whole-grid mode of K6 / K7 (`fused_window_block(attn_mask=, pad_logmult=)`
with `grid_window_mask`); `MultiScaleAttention(x, ln_w, ln_b)` and
`MLP(fused=True)` on parameters moved by `interop/from_jax.py`.

The port's wrappers take CPU tensors, so they run their plain versions (the
CUDA kernels run on the card: tests/test_torch_kernels_cuda.py,
chip_smoke.py's `opsapi` path). The JAX side runs under `force_xla()`, its
`_xla_*` forms and their custom VJPs, and the masked K6 / K7 also as Pallas
kernels in interpret mode at the JAX tests' own 4 x 4, window 3 geometry
(tests/test_fused_ops.py:290-385). Inputs are seeded numpy, fp32.

Tolerances, as the JAX tests hold these functions: forwards within 2e-5 of
the larger output's max |value| (sums in another order), gradients rtol
1e-4, atol 1e-5; the interpret-mode backward kernel against the port
rtol 2e-4, atol 2e-5, the bound tests/test_fused_ops.py:375-385 holds that
kernel to against `jax.vjp` of the XLA form.

The route tests sweep widths, dtypes and grids: the port's fp32 weight gate
is the JAX `_f32_weights_overflow`, and spies on both packages (the JAX
package traced with `jax.eval_shape` and its dispatch as on the TPU,
`xla_only` False, `pl.pallas_call` recording the kernel; the port's kernel
launchers replaced, `use_kernel` True) see the same kernel, or none, for
K1, K2, K3, K15, K16 and the masked K6 / K7, forward and backward.
"""

from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pl

import sam2unet_torch.ops.fused_attention_block as port_fab
import sam2unet_torch.ops.fused_mlp as port_mlp
import sam2unet_tpu.ops.pallas.dispatch as jax_dispatch
import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_mlp as fm
import sam2unet_tpu.ops.windowing as jax_windowing
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.hiera import MultiScaleAttention
from sam2unet_torch.nn.layers import MLP, gelu
from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    long_sequence,
    valid_group_blocks,
    window_block_bwd,
    window_block_bwd_route,
)
from sam2unet_torch.ops.fused_mlp import (
    f32_weights_overflow,
    fused_ln_matmul,
    fused_ln_qkv,
    fused_mlp,
    mlp_bwd_dx,
)
from sam2unet_torch.ops.windowing import grid_window_mask

FWD_REL = 2e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
INTERPRET_BWD_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(rng, scale=0.3):
    return lambda *sh: (rng.standard_normal(sh) * scale).astype(np.float32)


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


def _n(t):
    return None if t is None else t.detach().numpy()


def _close_fwd(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_n(got), want, rtol=0,
                               atol=FWD_REL * np.abs(want).max())


def _close_grad(got, want):
    np.testing.assert_allclose(_n(got), np.asarray(want), **GRAD_TOL)


# ----------------------------------------------------------- K15, K16


@pytest.mark.parametrize("add_bias", [True, False])
@pytest.mark.parametrize("fn", ["ln_matmul", "ln_qkv"])
def test_ln_matmul_and_qkv_match_jax(fn, add_bias):
    """Forward and the gradients of x, W and the LN's scale and bias
    (`_lm_bwd` / `_lq_bwd`: jax.vjp of the XLA forms) at the JAX test's
    geometry (tests/test_fused_ops.py:84-113) and at a hiera-like width."""
    rng = np.random.default_rng(7)
    for shape, n in (((5, 4, 4, 12), 36), ((2, 7, 48), 144)):
        c = shape[-1]
        mk = _mk(rng)
        x, w, b = mk(*shape), mk(c, n), mk(n)
        lns, lnb = mk(c) + 1, mk(c)
        cot = [mk(*shape[:-1], n // 3) for _ in range(3)]
        jfn = fm.fused_ln_qkv if fn == "ln_qkv" else fm.fused_ln_matmul
        pfn = fused_ln_qkv if fn == "ln_qkv" else fused_ln_matmul
        g = tuple(cot) if fn == "ln_qkv" else np.concatenate(cot, -1)
        with jax_dispatch.force_xla():
            want, vjp = jax.vjp(
                lambda *a: jfn(*a, add_bias), jnp.asarray(x), jnp.asarray(w),
                jnp.asarray(b), jnp.asarray(lns), jnp.asarray(lnb))
            dx, dw, _, dls, dlb = vjp(jax.tree.map(jnp.asarray, g))
        leaves = [_t(x), _t(w, True), _t(b), _t(lns), _t(lnb)]
        for t in leaves:
            t.requires_grad_(True)
        got = pfn(*leaves, add_bias=add_bias)
        outs = got if fn == "ln_qkv" else (got,)
        wants = want if fn == "ln_qkv" else (want,)
        for o, wnt in zip(outs, wants):
            _close_fwd(o, wnt)
        torch.autograd.backward(outs, [_t(a) for a in (
            cot if fn == "ln_qkv" else [g])])
        _close_grad(leaves[0].grad, dx)
        _close_grad(leaves[1].grad.T, dw)
        _close_grad(leaves[3].grad, dls)
        _close_grad(leaves[4].grad, dlb)
        assert (leaves[2].grad is None) == (not add_bias)


def test_ln_qkv_is_ln_matmul_split():
    """K16's q, k and v are K15's output's three column blocks, to the last
    bit (the JAX pair is held the same way), separate contiguous tensors."""
    mk = _mk(np.random.default_rng(3))
    x, w, b = _t(mk(3, 5, 24)), _t(mk(72, 24)), _t(mk(72))
    lns, lnb = _t(mk(24) + 1), _t(mk(24))
    for add_bias in (True, False):
        full = fused_ln_matmul(x, w, b, lns, lnb, add_bias)
        q, k, v = fused_ln_qkv(x, w, b, lns, lnb, add_bias)
        assert torch.equal(torch.cat([q, k, v], -1), full)


# ------------------------------------------------------------------ K2


@pytest.mark.parametrize("ln,residual", [(False, True), (False, False),
                                         (True, False), (True, True)])
def test_frozen_fused_mlp_dx_matches_jax(ln, residual):
    """`fused_mlp` with frozen weights in each mode, and `mlp_bwd_dx` (K2's
    wrapper) on the CPU, against jax.vjp of the JAX `fused_mlp(...,
    weight_grads=False)` (its XLA recompute)."""
    rng = np.random.default_rng(11)
    mk = _mk(rng)
    c, hd = 24, 96
    x, gy = mk(2, 5, c), mk(2, 5, c)
    w1, b1, w2, b2 = mk(c, hd), mk(hd), mk(hd, c), mk(c)
    lns, lnb = (mk(c) + 1, mk(c)) if ln else (None, None)
    with jax_dispatch.force_xla():
        want, vjp = jax.vjp(
            lambda xx: fm.fused_mlp(xx, w1, b1, w2, b2, lns, lnb, residual,
                                    weight_grads=False), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(gy))
    weights = (_t(w1, True), _t(b1), _t(w2, True), _t(b2))
    ln_args = dict(ln_w=_t(lns), ln_b=_t(lnb)) if ln else {}
    xt = _t(x).requires_grad_(True)
    out = fused_mlp(xt, *weights, residual=residual, **ln_args)
    _close_fwd(out, want)
    out.backward(_t(gy))
    _close_grad(xt.grad, want_dx)
    _close_grad(mlp_bwd_dx(_t(x), _t(gy), *weights, residual=residual,
                           **ln_args), want_dx)


# -------------------------------------------------------- masked K6/K7


def _block_params(rng, c):
    mk = _mk(rng)
    jax_args = (mk(c, 3 * c), mk(3 * c) * 2, mk(c) + 1, mk(c), mk(c, c),
                mk(c))
    w, b, lns, lnb, wp, bp = jax_args
    port_args = (_t(w, True), _t(b), _t(lns), _t(lnb), _t(wp, True), _t(bp))
    return jax_args, port_args


# (batch, H, W, c, heads, window): the JAX test's 11 x 11 window 8
# (tests/test_fused_ops.py:247-285) and hiera_t@288's stage 3 (18 x 18,
# window 14) at a narrow width
MASKED_GEOMS = [(2, 11, 11, 16, 2, 8), (1, 18, 18, 32, 2, 14)]


@pytest.mark.parametrize("geom", MASKED_GEOMS)
def test_masked_block_matches_jax(geom):
    """The masked whole-grid block, forward and dx (frozen weights: K7's
    masked route), against the JAX `fused_window_block` under force_xla
    (`_xla_window_block` and jax.vjp of it); and equal to the port's
    valid-group route on the same grid."""
    b, h, w, c, nh, win = geom
    rng = np.random.default_rng(8)
    jax_args, port_args = _block_params(rng, c)
    x = _mk(rng, 0.5)(b, h * w, c)
    gy = _mk(rng)(b, h * w, c)
    mask_np, lm_np = grid_window_mask(h, w, win)
    with jax_dispatch.force_xla():
        want, vjp = jax.vjp(
            lambda xx: fab.fused_window_block(
                xx, *jax_args, num_heads=nh, weight_grads=False,
                attn_mask=jnp.asarray(mask_np),
                pad_logmult=jnp.asarray(lm_np)), jnp.asarray(x))
        (want_dx,) = vjp(jnp.asarray(gy))
    mask, lm = torch.from_numpy(mask_np), torch.from_numpy(lm_np)
    xt = _t(x).requires_grad_(True)
    got = fused_window_block(xt, *port_args, num_heads=nh, attn_mask=mask,
                             pad_logmult=lm)
    _close_fwd(got, want)
    got.backward(_t(gy))
    _close_grad(xt.grad, want_dx)
    _close_grad(window_block_bwd(_t(x), _t(gy), *port_args, num_heads=nh,
                                 attn_mask=mask, pad_logmult=lm), want_dx)
    groups = valid_group_blocks(fused_window_block, _t(x).reshape(b, h, w, c),
                                *port_args, num_heads=nh, window=win)
    _close_fwd(got.detach().reshape(b, h, w, c), _n(groups))


def test_masked_block_matches_pallas_interpret():
    """The port's masked block, forward and dx, against the JAX masked
    K6 / K7 Pallas kernels in interpret mode at the JAX tests' geometry (4 x
    4 grid, window 3, S 16, c 24, 2 heads)."""
    rng = np.random.default_rng(9)
    nw, c, nh = 4, 24, 2
    jax_args, port_args = _block_params(rng, c)
    w, b, lns, lnb, wp, bp = (jnp.asarray(a) for a in jax_args)
    x, gy = _mk(rng)(nw, 16, c), _mk(rng)(nw, 16, c)
    mask_np, lm_np = grid_window_mask(4, 4, 3)
    mask, lm = jnp.asarray(mask_np), jnp.asarray(lm_np)
    want = fab._fused_window_block_fwd_impl(
        jnp.asarray(x), w, b, lns, lnb, wp, bp, mask, lm, nh, 0, True, True,
        interpret=True)
    want_dx = fab._fused_window_block_bwd_impl(
        jnp.asarray(x), jnp.asarray(gy), w, b, lns, lnb, wp, nh, True,
        weight_grads=False, attn_mask=mask, pad_logmult=lm,
        interpret=True)[0]
    pm, plm = torch.from_numpy(mask_np), torch.from_numpy(lm_np)
    got = fused_window_block(_t(x), *port_args, num_heads=nh, attn_mask=pm,
                             pad_logmult=plm)
    _close_fwd(got, want)
    got_dx = window_block_bwd(_t(x), _t(gy), *port_args, num_heads=nh,
                              attn_mask=pm, pad_logmult=plm)
    np.testing.assert_allclose(_n(got_dx), np.asarray(want_dx),
                               **INTERPRET_BWD_TOL)


@pytest.mark.parametrize("hw,window", [((11, 11), 8), ((4, 4), 3),
                                       ((18, 18), 14), ((22, 22), 16),
                                       ((7, 12), 5), ((8, 8), 8)])
def test_grid_window_mask_equals_the_jax_one(hw, window):
    got, want = grid_window_mask(*hw, window), \
        jax_windowing.grid_window_mask(*hw, window)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_masked_mode_takes_the_mask_and_logmult_together():
    _, port_args = _block_params(np.random.default_rng(1), 16)
    x = torch.zeros(1, 16, 16)
    mask, lm = (torch.from_numpy(a) for a in grid_window_mask(4, 4, 3))
    for kw in (dict(attn_mask=mask), dict(pad_logmult=lm),
               dict(attn_mask=mask, pad_logmult=lm, n_pad=3)):
        with pytest.raises(ValueError):
            fused_window_block(x, *port_args, num_heads=2, **kw)


# ------------------------------------------------------ the slice whole


def test_multiscale_attention_with_fused_ln_matches_jax():
    """The port's `MultiScaleAttention(x, ln_w, ln_b)` (its `project_qkv`
    through K15's wrapper) against the JAX module's `apply` with
    `ln_scale` / `ln_bias`, on the JAX parameters moved by
    `jax_to_state_dict` with strict=True: forward, and the gradients of x,
    the LN's scale and bias and the module's parameters."""
    from sam2unet_tpu.models.hiera import MultiScaleAttention as JaxMSA

    rng = np.random.default_rng(5)
    c, nh = 32, 2
    jm = JaxMSA(dim=c, dim_out=c, num_heads=nh)
    x = _mk(rng, 1.0)(2, 4, 4, c)
    lns, lnb = _mk(rng)(c) + 1, _mk(rng)(c)
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    gy = _mk(rng)(2, 4, 4, c)
    with jax_dispatch.force_xla():
        want, vjp = jax.vjp(
            lambda p, xx, s_, b_: jm.apply({"params": p}, xx, s_, b_),
            params, jnp.asarray(x), jnp.asarray(lns), jnp.asarray(lnb))
        gp, gx, gs, gb = vjp(jnp.asarray(gy))
    port = MultiScaleAttention(c, c, nh)
    port.load_state_dict(jax_to_state_dict(
        {"params": jax.tree.map(np.asarray, params)},
        port.state_dict().keys(), wrap_blocks=False), strict=True)
    leaves = [_t(x), _t(lns), _t(lnb)]
    for t in leaves:
        t.requires_grad_(True)
    got = port(*leaves)
    _close_fwd(got, want)
    got.backward(_t(gy))
    for t, wnt in zip(leaves, (gx, gs, gb)):
        _close_grad(t.grad, wnt)
    _close_grad(port.qkv.weight.grad.T, gp["qkv"]["kernel"])
    _close_grad(port.qkv.bias.grad, gp["qkv"]["bias"])
    _close_grad(port.proj.weight.grad.T, gp["proj"]["kernel"])
    _close_grad(port.proj.bias.grad, gp["proj"]["bias"])
    # the same call without the fused LN, LN applied first
    with torch.no_grad():
        ln = torch.nn.functional.layer_norm(_t(x), (c,), _t(lns), _t(lnb),
                                            1e-6)
        _close_fwd(port(ln), want)


@pytest.mark.parametrize("frozen", [False, True])
def test_fused_mlp_module_matches_jax(frozen):
    """The port's `MLP(fused=True)` (2 layers, GELU: `fused_mlp`) against
    the JAX `MLP(fused=True)` on parameters moved with strict=True: the
    forward, dx, and with trainable weights their gradients."""
    from sam2unet_tpu.nn.layers import MLP as JaxMLP
    from sam2unet_tpu.nn.layers import gelu as jax_gelu

    rng = np.random.default_rng(6)
    c, hd = 24, 96
    jm = JaxMLP(hidden_dim=hd, output_dim=c, num_layers=2,
                activation=jax_gelu, fused=True)
    x, gy = _mk(rng, 1.0)(3, 5, c), _mk(rng)(3, 5, c)
    params = jax.tree.map(lambda a: a + 0.1 * jnp.asarray(
        rng.standard_normal(a.shape), jnp.float32),
        jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    with jax_dispatch.force_xla():
        want, vjp = jax.vjp(lambda p, xx: jm.apply({"params": p}, xx),
                            params, jnp.asarray(x))
        gp, gx = vjp(jnp.asarray(gy))
    port = MLP(c, hd, c, activation=gelu, fused=True)
    port.load_state_dict(jax_to_state_dict(
        {"params": jax.tree.map(np.asarray, params)},
        port.state_dict().keys(), wrap_blocks=False), strict=True)
    port.requires_grad_(not frozen)
    xt = _t(x).requires_grad_(True)
    got = port(xt)
    _close_fwd(got, want)
    got.backward(_t(gy))
    _close_grad(xt.grad, gx)
    for i in (0, 1):
        layer = port.layers[i]
        if frozen:
            assert layer.weight.grad is None
            continue
        _close_grad(layer.weight.grad.T, gp[f"layers_{i}"]["kernel"])
        _close_grad(layer.bias.grad, gp[f"layers_{i}"]["bias"])


# ---------------------------------------------------------- the routes


def test_f32_gate_equals_the_jax_one():
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        for c in (96, 144, 192, 288, 384, 576, 768, 1152):
            for hd in (32, 4 * c):
                w1, w2 = torch.empty(hd, c), torch.empty(c, hd)
                want = fm._f32_weights_overflow(
                    jax.ShapeDtypeStruct((2, c), jdt),
                    jax.ShapeDtypeStruct((c, hd), jnp.float32),
                    jax.ShapeDtypeStruct((hd, c), jnp.float32))
                assert f32_weights_overflow(torch.empty(2, c, dtype=dt),
                                            w1, w2) == want
            want = fm._f32_weights_overflow(
                jax.ShapeDtypeStruct((2, c), jdt),
                jax.ShapeDtypeStruct((c, 3 * c), jnp.float32))
            assert f32_weights_overflow(torch.empty(2, c, dtype=dt),
                                        torch.empty(3 * c, c)) == want


_JAX_KERNELS = {("fused_mlp", "_kernel"): "K1",
                ("fused_mlp", "_mlp_bwd_dx_kernel"): "K2",
                ("fused_mlp", "_adapter_bwd_kernel"): "K3",
                ("fused_mlp", "_ln_matmul_kernel"): "K15",
                ("fused_mlp", "_ln_qkv_kernel"): "K16",
                ("fused_attention_block", "_kernel"): "K6",
                ("fused_attention_block", "_bwd_kernel"): "K7"}


@pytest.fixture
def spies(monkeypatch):
    """(jax_seen, port_seen): the kernels each package launches. The JAX
    side as on the TPU, every `pl.pallas_call` recorded and answered with
    zeros; the port's kernel launchers recorded and answered with zeros,
    its plain window block too (it is not a kernel; zeros keep the sweep
    fast)."""
    jax_seen, port_seen = [], []

    def pallas_call(kernel, *a, out_shape, **k):
        fn = kernel.func if isinstance(kernel, functools.partial) else kernel
        jax_seen.append(_JAX_KERNELS[(fn.__module__.rsplit(".", 1)[-1],
                                      fn.__name__)])
        return lambda *args: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    monkeypatch.setattr(jax_dispatch, "xla_only", lambda: False)
    monkeypatch.setattr(jax_pl, "pallas_call", pallas_call)

    def k1(x, w1, b1, w2, b2, *a, **k):
        port_seen.append("K1")
        return x.new_zeros(*x.shape[:-1], w2.shape[0])

    def k2(x, *a, **k):
        port_seen.append("K2")
        return torch.zeros_like(x)

    def k3(x, gy, *ws, **k):
        port_seen.append("K3")
        return (torch.zeros_like(x), *(torch.zeros_like(w) for w in ws[:4]))

    def k15(x, w, *a, split, **k):
        port_seen.append("K16" if split else "K15")
        n = w.shape[0] // (3 if split else 1)
        out = tuple(x.new_zeros(*x.shape[:-1], n) for _ in range(3))
        return out if split else out[0]

    def k6(x, *a, **k):
        port_seen.append("K6")
        return torch.zeros_like(x)

    def k7(x, *a, **k):
        port_seen.append("K7")
        return torch.zeros_like(x)

    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(port_mlp, "_mlp_kernel", k1)
    monkeypatch.setattr(port_mlp, "mlp_bwd_dx", k2)
    monkeypatch.setattr(port_mlp, "adapter_bwd", k3)
    monkeypatch.setattr(port_mlp, "_ln_matmul_kernel", k15)
    monkeypatch.setattr(port_fab, "_k6_window_block", k6)
    monkeypatch.setattr(port_fab, "window_block_bwd", k7)
    monkeypatch.setattr(port_fab, "plain_window_block",
                        lambda x, *a, **k: x * 0)
    return jax_seen, port_seen


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
WIDTHS = (96, 384, 576, 768, 1152)


def _sweep_one(spies, jax_call, port_call):
    jax_seen, port_seen = spies
    jax_seen.clear()
    port_seen.clear()
    jax_call()
    port_call()
    assert jax_seen == port_seen
    return list(port_seen)


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_mlp_routes_match_the_jax_dispatch(spies, dt, jdt):
    """K1's forward and the K2 / K3 / plain backward of the frozen MLP in
    its four modes and of the trainable adapter, over the trunks' widths:
    fp32 at 768 and 1152 (hidden 4c) takes the plain forms in both
    packages, bf16 always the kernels."""
    routes = collections.Counter()
    for c in WIDTHS:
        for hd, gelu_out, trainable, modes in (
                (4 * c, False, False, [(a, b) for a in (0, 1)
                                       for b in (0, 1)]),
                (32, True, True, [(0, 1)])):
            w1, b1 = torch.zeros(hd, c), torch.zeros(hd)
            w2, b2 = torch.zeros(c, hd), torch.zeros(c)
            lns, lnb = torch.ones(c), torch.zeros(c)
            for ln, residual in modes:
                lnj = (jnp.ones(c, jdt), jnp.zeros(c, jdt)) if ln else (None,
                                                                       None)

                def jax_call():
                    def f(x, ws):
                        return fm.fused_mlp(x, *ws, *lnj, bool(residual),
                                            weight_grads=trainable,
                                            gelu_out=gelu_out)
                    ws = tuple(jnp.zeros(s, jdt) for s in
                               ((c, hd), (hd,), (hd, c), (c,)))
                    x = jnp.zeros((8, c), jdt)
                    jax.eval_shape(lambda x, ws: jax.vjp(f, x, ws)[1](
                        jnp.zeros((8, c), jdt)), x, ws)

                def port_call():
                    ws = [t.to(dt).requires_grad_(trainable)
                          for t in (w1, b1, w2, b2)]
                    x = torch.zeros(8, c, dtype=dt, requires_grad=True)
                    kw = dict(ln_w=lns.to(dt), ln_b=lnb.to(dt)) if ln else {}
                    fused_mlp(x, *ws, residual=bool(residual),
                              gelu_out=gelu_out, **kw).sum().backward()

                routes[tuple(_sweep_one(spies, jax_call, port_call))] += 1
    overflow = 2 * 4 if dt == torch.float32 else 0   # c 768, 1152, 4 modes
    assert routes[()] == overflow
    assert routes[("K1", "K2")] == 4 * len(WIDTHS) - overflow
    assert routes[("K1", "K3")] == len(WIDTHS)


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_ln_matmul_routes_match_the_jax_dispatch(spies, dt, jdt):
    """K15 and K16 over the widths and both add_bias: fp32 QKV weights
    past 12 MiB (c 1152: 15.9 MB) take the plain forms; the backward is the
    plain recompute in both packages."""
    plain = 0
    for c in WIDTHS:
        for split in (False, True):
            for add_bias in (True, False):
                jfn = fm.fused_ln_qkv if split else fm.fused_ln_matmul
                pfn = fused_ln_qkv if split else fused_ln_matmul

                def jax_call():
                    def f(x, w):
                        out = jfn(x, w, jnp.zeros(3 * c, jdt),
                                  jnp.ones(c, jdt), jnp.zeros(c, jdt),
                                  add_bias)
                        return out if split else (out,)
                    x, w = jnp.zeros((8, c), jdt), jnp.zeros((c, 3 * c), jdt)
                    jax.eval_shape(
                        lambda x, w: jax.vjp(f, x, w)[1](tuple(
                            jnp.zeros((8, (c if split else 3 * c)), jdt)
                            for _ in range(3 if split else 1))), x, w)

                def port_call():
                    x = torch.zeros(8, c, dtype=dt, requires_grad=True)
                    w = torch.zeros(3 * c, c, dtype=dt, requires_grad=True)
                    out = pfn(x, w, torch.zeros(3 * c, dtype=dt),
                              torch.ones(c, dtype=dt),
                              torch.zeros(c, dtype=dt), add_bias)
                    sum(o.sum() for o in (out if split else (out,))
                        ).backward()

                seen = _sweep_one(spies, jax_call, port_call)
                plain += not seen
    assert plain == (4 if dt == torch.float32 else 0)


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_masked_block_routes_match_the_jax_dispatch(spies, dt, jdt):
    """The masked block's forward (K6 where one row's live estimate fits
    12 MiB, else the plain form) and backward (K7's masked dx-only mode
    where it fits the 8 MiB dx-only budget and the weights are frozen,
    else the plain recompute) over grids and widths, as the JAX gates
    route them (fused_attention_block.py:303-309, :1945-1991)."""
    routes = collections.Counter()
    for (h, win), (c, nh) in ((g, w) for g in ((11, 8), (22, 16), (24, 8),
                                               (30, 7))
                              for w in ((96, 1), (576, 8), (1152, 16))):
        s = h * h
        mask_np, lm_np = grid_window_mask(h, h, win)
        for trainable in (False, True):
            def jax_call():
                def f(x, ws):
                    return fab.fused_window_block(
                        x, *ws, num_heads=nh, weight_grads=trainable,
                        attn_mask=jnp.asarray(mask_np),
                        pad_logmult=jnp.asarray(lm_np))
                ws = tuple(jnp.zeros(sh, jdt) for sh in (
                    (c, 3 * c), (3 * c,), (c,), (c,), (c, c), (c,)))
                x = jnp.zeros((1, s, c), jdt)
                jax.eval_shape(lambda x, ws: jax.vjp(f, x, ws)[1](
                    jnp.zeros((1, s, c), jdt)), x, ws)

            def port_call():
                ws = [torch.zeros(sh, dtype=dt).requires_grad_(trainable)
                      for sh in ((3 * c, c), (3 * c,), (c,), (c,), (c, c),
                                 (c,))]
                x = torch.zeros(1, s, c, dtype=dt, requires_grad=True)
                fused_window_block(
                    x, *ws, num_heads=nh, attn_mask=torch.from_numpy(mask_np),
                    pad_logmult=torch.from_numpy(lm_np)).sum().backward()

            seen = _sweep_one(spies, jax_call, port_call)
            assert ("K6" in seen) == (not long_sequence(s, c))
            route = window_block_bwd_route(s, c, 0, trainable, masked=True)
            assert ("K7" in seen) == (route == "K7 masked")
            routes[tuple(seen)] += 1
    # every route of the sweep is taken: both kernels, the plain backward
    # (trainable, or over the budget: c 1152 at 484 tokens), the plain form
    assert set(routes) == {("K6", "K7"), ("K6",), ()}


@pytest.mark.parametrize("trunk,size,grouped,want", [
    ("HIERA_S", 352, True, {True: 44, False: 49}),   # a hiera_s@352 step
    ("HIERA_L", 256, True, {True: 44, False: 48}),   # a hiera_l@256 step
    ("HIERA_S", 352, False, {True: 14, False: 16}),  # the SP forward's
])                                                   # per-block routes
def test_fp32_gate_sets_the_dry_run_k1_launches(monkeypatch, trunk, size,
                                                grouped, want):
    """The K1 launches of the dry run's fp32 models (chip_smoke.py's s352mc,
    full widths, stubbed kernels): the tails at width 768 (hiera_s stage
    4) and 1152 (hiera_l stage 4) take the plain form past the fp32 weight
    gate, the adapters and the narrower tails launch K1; each launched
    frozen tail's backward is one K2."""
    import sam2unet_torch.configs as port_configs
    from test_torch_model_960_cpu import _route_of_each_block

    if not grouped:
        monkeypatch.setenv("SAM2UNET_DISABLE_GROUPED", "1")
    x = torch.zeros(1, size, size, 3)
    _, k1, _ = _route_of_each_block(getattr(port_configs, trunk), x,
                                    train=grouped, stub=True, launched=True)
    assert k1 == want
