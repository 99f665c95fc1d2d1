"""K7's weight-gradient mode and K13 (the remainder strips' dx-only
backward) against the JAX package on the CPU, and `fused_window_block_strips`
on any grid, as the JAX function takes it.

The port's wrappers take CPU tensors, so they run their plain versions (the
CUDA kernels run on the card: tests/test_torch_kernels_cuda.py,
chip_smoke.py's `bwdmodes` path). The JAX side runs its XLA forms and the
Pallas kernels in interpret mode at the JAX tests' own geometries
(tests/test_fused_ops.py:334-356 for the weight-gradient kernel, :596-651
for K13a / K13b). Inputs are seeded numpy, fp32.

Tolerances: forwards within 2e-5 of the larger output's max |value| (sums
in another order), dx rtol 1e-4, atol 1e-5, weight gradients (sums over
every row) rtol 1e-4 and within 2e-5 of their max |value|; against the
interpret-mode kernels each JAX test's own bound against `jax.vjp` of the
XLA form (the weight-gradient kernel rtol 2e-4, atol 2e-5; the remainder
strips' rtol 2e-4, atol 2e-4, as the JAX test holds
`fused_window_block_strips`' gradients on a remainder grid). The models:
the one-step tolerances of
tests/test_torch_train_cpu.py (loss 1e-5 relative, each gradient 2e-2 of
its leaf's max |g| and correlation >= 0.9999).

The route tests sweep widths, dtypes and grids: spies on both packages (the
JAX package traced with `jax.eval_shape` and its dispatch as on the TPU,
`xla_only` False, `pl.pallas_call` recording the kernel; the port's
libraries replaced by entry points that launch nothing, `use_kernel` True,
each launch recorded from the wrapper's own count) see the same kernels for
`fused_window_block` with weights that need gradients,
`fused_window_block_strips` forward and backward, the remainder strips'
backward with its K13a / K13b regime, a trainable `Hiera` in training and a
`SAM2UNet` gradient in eval mode.
"""

from __future__ import annotations

import collections
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as jax_pl

import sam2unet_torch.ops.fused_attention_block as port_fab
import sam2unet_tpu.ops.pallas.dispatch as jax_dispatch
import sam2unet_tpu.ops.pallas.fused_attention_block as fab
from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.hiera import Hiera as PortHiera
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    strips_bwd_route,
    strips_rem_bwd_regime,
    strips_route,
    window_block_bwd,
    window_block_bwd_route,
    window_block_strips_rem_bwd,
)
from sam2unet_torch.train.loss import multi_head_loss as port_loss
from sam2unet_torch.train.optim import is_trainable
from sam2unet_tpu.configs import HieraConfig, SAM2UNetConfig
from sam2unet_tpu.models.hiera import Hiera as JaxHiera
from sam2unet_tpu.models.sam2unet import SAM2UNet
from sam2unet_tpu.train.loss import multi_head_loss
from sam2unet_tpu.train.optim import merge_params, partition_params

FWD_REL = 2e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
INTERPRET_WGRAD_TOL = dict(rtol=2e-4, atol=2e-5)
INTERPRET_REM_TOL = dict(rtol=2e-4, atol=2e-4)
# `fused_window_block_strips`' gradients: the JAX test of the same function
# on a remainder grid (tests/test_fused_ops.py:693-694)
STRIPS_GRAD_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_RTOL, LEAF_TOL, LEAF_CORR = 1e-5, 2e-2, 0.9999


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
    return t.detach().numpy()


def _block_params(rng, c):
    """(JAX weights, the port's): w_qkv and w_proj transposed to (out, in)."""
    mk = _mk(rng)
    jax_args = (mk(c, 3 * c), mk(3 * c), mk(c) + 1, mk(c), mk(c, c), mk(c))
    w, b, lns, lnb, wp, bp = jax_args
    port_args = (_t(w, True), _t(b), _t(lns), _t(lnb), _t(wp, True), _t(bp))
    return jax_args, port_args


def _close_fwd(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(_n(got), want, rtol=0,
                               atol=FWD_REL * np.abs(want).max())


def _close_grads(got, want):
    """dx (the first) elementwise; the weight gradients, sums over every
    row, also within FWD_REL of their max."""
    for i, (g, r) in enumerate(zip(got, want)):
        r = np.asarray(r)
        atol = GRAD_TOL["atol"] if i == 0 else FWD_REL * np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=GRAD_TOL["rtol"], atol=atol)


# the port's weight gradients in the JAX layouts: w_qkv and w_proj back to
# (in, out)
_JAX_LAYOUT = (False, True, False, False, False, True, False)


def _as_jax(grads):
    return [_n(g).T if tr else _n(g) for g, tr in zip(grads, _JAX_LAYOUT)]


# ------------------------------------------- K7's weight-gradient mode


@pytest.mark.parametrize("geom", [(4, 16, 24, 2), (2, 49, 32, 2),
                                  (3, 16, 24, 2, False)])
def test_weight_gradient_mode_matches_the_pallas_kernel(geom):
    """`window_block_bwd(weight_grads=True)`'s plain version, all seven
    outputs, against `_fused_window_block_bwd_impl(weight_grads=True)` in
    interpret mode and against `jax.vjp` of `_xla_window_block`, at the
    bound the JAX test holds the kernel to against the latter: the JAX
    test's (4, 16, 24, 2 heads), a 7 x 7 window (49 rows, padded to 64 in
    the Pallas kernel), and without the residual."""
    nw, s, c, nh, *res = geom
    residual = res[0] if res else True
    rng = np.random.default_rng(9)
    jax_args, port_args = _block_params(rng, c)
    x, gy = _mk(rng)(nw, s, c), _mk(rng)(nw, s, c)
    args = [jnp.asarray(a) for a in (x, *jax_args)]

    @jax.jit
    def jax_side(args, gy):
        x, w, b, lns, lnb, wp, bp = args
        kernel = fab._fused_window_block_bwd_impl(
            x, gy, w, b, lns, lnb, wp, nh, residual, weight_grads=True,
            interpret=True)
        _, vjp = jax.vjp(lambda *a: fab._xla_window_block(*a, nh, 0, residual),
                         *args)
        return kernel, vjp(gy)

    kernel, want = jax_side(args, jnp.asarray(gy))
    got = window_block_bwd(_t(x), _t(gy), *port_args, num_heads=nh,
                           residual=residual, weight_grads=True)
    assert len(got) == 7 and all(g.dtype == torch.float32 for g in got)
    for g, k, r in zip(_as_jax(got), kernel, want):
        np.testing.assert_allclose(g, np.asarray(k), **INTERPRET_WGRAD_TOL)
        np.testing.assert_allclose(g, np.asarray(r), **INTERPRET_WGRAD_TOL)


@pytest.mark.parametrize("n_pad", [0, 5])
def test_trainable_window_block_matches_jax(n_pad):
    """`fused_window_block` with weights that need gradients, through
    autograd: the gradients of x and of the six weights against `jax.vjp`
    of the JAX function with weight_grads=True (its XLA dispatch on the
    CPU), without and with the pad key."""
    nw, s, c, nh = 4, 16, 24, 2
    rng = np.random.default_rng(10)
    jax_args, port_args = _block_params(rng, c)
    x, gy = _mk(rng)(nw, s, c), _mk(rng)(nw, s, c)
    @jax.jit
    def jax_side(args, gy):
        with jax_dispatch.force_xla():
            y, vjp = jax.vjp(
                lambda *a: fab.fused_window_block(
                    *a, num_heads=nh, n_pad=n_pad, weight_grads=True), *args)
            return y, vjp(gy)

    want_y, want = jax_side([jnp.asarray(a) for a in (x, *jax_args)],
                            jnp.asarray(gy))
    leaves = [_t(x)] + [t.clone() for t in port_args]
    for t in leaves:
        t.requires_grad_(True)
    y = fused_window_block(*leaves, num_heads=nh, n_pad=n_pad)
    _close_fwd(y, want_y)
    y.backward(_t(gy))
    _close_grads(_as_jax([t.grad for t in leaves]), want)


def test_weight_gradient_mode_takes_no_mask():
    x = torch.zeros(1, 16, 8)
    _, port_args = _block_params(np.random.default_rng(1), 8)
    with pytest.raises(ValueError, match="no mask"):
        window_block_bwd(x, x, *port_args, num_heads=1, weight_grads=True,
                         attn_mask=torch.zeros(16, 16),
                         pad_logmult=torch.zeros(1, 16))


# ---------------------------------------------------------------- K13


@pytest.mark.parametrize("geom", [(1, 22, 22, 24, 2, 16, True),
                                  (1, 30, 30, 32, 4, 7, True),
                                  (2, 32, 32, 24, 2, 14, True),
                                  (2, 12, 18, 24, 2, 5, False)])
def test_rem_strip_backward_matches_the_pallas_kernel(geom):
    """K13's plain version against `_fused_strips_rem_bwd_impl` (K13a) in
    interpret mode and against `jax.vjp` of `_xla_strips_rem`, at the JAX
    test's geometries (tests/test_fused_ops.py:618-621)."""
    b, hh, wd, c, nh, window, residual = geom
    rng = np.random.default_rng(24)
    jax_args, port_args = _block_params(rng, c)
    x, gy = _mk(rng)(b, hh, wd, c), _mk(rng)(b, hh, wd, c)
    @jax.jit
    def jax_side(x, gy, w, bq, lns, lnb, wp, bp):
        kernel = fab._fused_strips_rem_bwd_impl(
            x, gy, w, bq, lns, lnb, wp, nh, window, residual, interpret=True)
        want = jax.vjp(lambda xx: fab._xla_strips_rem(
            xx, w, bq, lns, lnb, wp, bp, nh, window, residual), x)[1](gy)[0]
        return kernel, want

    kernel, want = jax_side(*(jnp.asarray(a) for a in (x, gy, *jax_args)))
    got = window_block_strips_rem_bwd(_t(x), _t(gy), *port_args, num_heads=nh,
                                      window=window, residual=residual)
    np.testing.assert_allclose(_n(got), np.asarray(kernel), **INTERPRET_REM_TOL)
    np.testing.assert_allclose(_n(got), np.asarray(want), **GRAD_TOL)


def test_rem_strip_backward_matches_the_window_on_grid_kernel():
    """The same against `_fused_strips_rem_bwd_jw_impl` (K13b) in interpret
    mode at hiera_s@960 stage 3's grid, 60 x 60 window 14, at width 16 (the
    JAX test's, tests/test_fused_ops.py:648)."""
    b, hh, wd, c, nh, window = 1, 60, 60, 16, 2, 14
    rng = np.random.default_rng(26)
    jax_args, port_args = _block_params(rng, c)
    x, gy = _mk(rng)(b, hh, wd, c), _mk(rng)(b, hh, wd, c)
    w, bq, lns, lnb, wp, _ = (jnp.asarray(a) for a in jax_args)
    kernel = jax.jit(lambda *a: fab._fused_strips_rem_bwd_jw_impl(
        *a, nh, window, True, interpret=True))(
            jnp.asarray(x), jnp.asarray(gy), w, bq, lns, lnb, wp)
    got = window_block_strips_rem_bwd(_t(x), _t(gy), *port_args, num_heads=nh,
                                      window=window)
    np.testing.assert_allclose(_n(got), np.asarray(kernel), **INTERPRET_REM_TOL)


# --------------------------------------- fused_window_block_strips, any grid


_STRIPS_GEOMS = {
    "12x18w5": (2, 12, 18, 24, 2, 5),    # remainder (the fault's geometry)
    "22x22w16": (2, 22, 22, 24, 2, 16),  # remainder (hiera_l@352 stage 3)
    "10x20w5": (2, 10, 20, 24, 2, 5),    # divisible, 25-token windows
    "28x28w14": (1, 28, 28, 24, 2, 14),  # divisible, 196-token windows
    "16x16w8": (2, 16, 16, 24, 2, 8),    # divisible, 16-aligned
}


@functools.lru_cache(maxsize=None)
def _jax_strips(name):
    """Inputs, cotangent and the JAX function's output and gradients on one
    grid, frozen (dx) and trainable (all seven), in one compiled call."""
    b, hh, wd, c, nh, window = _STRIPS_GEOMS[name]
    rng = np.random.default_rng(25)
    jax_args, port_args = _block_params(rng, c)
    x, gy = _mk(rng)(b, hh, wd, c), _mk(rng)(b, hh, wd, c)

    @jax.jit
    def jax_side(args, gy):
        out = []
        with jax_dispatch.force_xla():
            for trainable in (False, True):
                y, vjp = jax.vjp(lambda *a: fab.fused_window_block_strips(
                    *a, num_heads=nh, window=window, weight_grads=trainable),
                    *args)
                out.append((y, vjp(gy)))
        return out

    want = jax_side([jnp.asarray(a) for a in (x, *jax_args)], jnp.asarray(gy))
    return x, gy, port_args, want


@pytest.mark.parametrize("trainable", [False, True], ids=["frozen", "trainable"])
@pytest.mark.parametrize("name", list(_STRIPS_GEOMS))
def test_strips_match_the_jax_function_on_any_grid(name, trainable):
    """`fused_window_block_strips` against the JAX function (its XLA
    dispatch on the CPU), value and gradients: on a remainder grid each
    edge window attends over its tokens and the pad key of the
    reference's post-LN zero pads, not over zero-padded raw tokens."""
    _, _, _, _, nh, window = _STRIPS_GEOMS[name]
    x, gy, port_args, want = _jax_strips(name)
    want_y, want = want[trainable]
    leaves = [_t(x)] + [t.clone().requires_grad_(trainable) for t in port_args]
    leaves[0].requires_grad_(True)
    y = fused_window_block_strips(*leaves, num_heads=nh, window=window)
    _close_fwd(y, want_y)
    y.backward(_t(gy))
    got = _as_jax([t.grad for t in leaves]) if trainable else [
        _n(leaves[0].grad)]
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), **STRIPS_GRAD_TOL)


def test_rem_strips_equal_the_strips_on_a_remainder_grid():
    """The model's K12 wrapper and the repaired strips agree where both take
    a remainder grid, value and dx."""
    rng = np.random.default_rng(27)
    _, port_args = _block_params(rng, 24)
    x, gy = _t(_mk(rng)(2, 12, 18, 24)), _t(_mk(rng)(2, 12, 18, 24))
    outs = []
    for fn in (fused_window_block_strips, fused_window_block_strips_rem):
        xx = x.clone().requires_grad_(True)
        y = fn(xx, *port_args, num_heads=2, window=5)
        y.backward(gy)
        outs.append((y.detach(), xx.grad))
    for a, r in zip(*outs):
        np.testing.assert_allclose(_n(a), _n(r), rtol=0,
                                   atol=FWD_REL * float(r.abs().max()))


# ------------------------------------------------------------- routes


_JAX_KERNELS = {("fused_mlp", "_kernel"): "K1",
                ("fused_mlp", "_mlp_bwd_dx_kernel"): "K2",
                ("fused_mlp", "_adapter_bwd_kernel"): "K3",
                ("fused_attention_block", "_strip_kernel"): "K4",
                ("fused_attention_block", "_strip_bwd_kernel"): "K5",
                ("fused_attention_block", "_kernel"): "K6",
                ("fused_attention_block", "_bwd_kernel"): "K7",
                ("fused_transition", "_transition_kernel"): "K8",
                ("fused_transition", "_transition_bwd_kernel"): "K9",
                ("flash_attention", "_stream_fwd_kernel"): "K10",
                ("flash_attention", "_stream_bwd_dq_kernel"): "K11a",
                ("flash_attention", "_stream_bwd_dkv_kernel"): "K11b",
                ("fused_attention_block", "_strip_rem_kernel"): "K12",
                ("fused_attention_block", "_strip_rem_bwd_kernel"): "K13a",
                ("fused_attention_block", "_strip_rem_bwd_kernel_jw"): "K13b",
                ("flash_attention", "_kernel"): "K14"}

# the port's launch counters by wrapper; K11's delta pass is XLA in the JAX
# package, so the port's is not compared
_PORT_KERNELS = {"fused_mlp": "K1", "mlp_bwd_dx": "K2", "adapter_bwd": "K3",
                 "fused_window_block_strips": "K4",
                 "window_block_strips_bwd": "K5", "fused_window_block": "K6",
                 "fused_transition_block": "K8", "transition_bwd": "K9",
                 "flash_attention": "K10", "flash_attention_bwd_dq": "K11a",
                 "flash_attention_bwd_dkv": "K11b",
                 "fused_window_block_strips_rem": "K12",
                 "full_attention": "K14"}


def _port_kernel(wrapper: str, variant: str) -> str | None:
    if wrapper == "window_block_bwd":
        return "K7 weight-grad" if variant.endswith(",wgrad") else "K7"
    if wrapper == "window_block_strips_rem_bwd":
        return variant.rsplit(",", 1)[1]
    return _PORT_KERNELS.get(wrapper)


class _Launchless(types.SimpleNamespace):
    """A kernel library whose entry points launch nothing and succeed."""

    def __getattr__(self, name):
        return lambda *a: 0


@pytest.fixture
def spies(monkeypatch):
    """(jax_seen, port_seen): the kernels each package launches, as
    Counters. The JAX side as on the TPU, every `pl.pallas_call` recorded
    (K7 split by its weight-gradient flag) and answered with zeros; the
    port's kernel wrappers run as on the card but their libraries launch
    nothing, and each launch is recorded from the wrapper's own count."""
    jax_seen, port_seen = collections.Counter(), collections.Counter()

    def pallas_call(kernel, *a, out_shape, **k):
        fn = kernel.func if isinstance(kernel, functools.partial) else kernel
        name = _JAX_KERNELS[(fn.__module__.rsplit(".", 1)[-1], fn.__name__)]
        if name == "K7" and kernel.keywords.get("wg"):
            name = "K7 weight-grad"
        jax_seen[name] += 1
        return lambda *args: jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), out_shape)

    monkeypatch.setattr(jax_dispatch, "xla_only", lambda: False)
    monkeypatch.setattr(jax_pl, "pallas_call", pallas_call)

    count = dispatch.count_launch

    def counted(wrapper, variant):
        count(wrapper, variant)
        name = _port_kernel(wrapper, variant)
        if name:
            port_seen[name] += 1

    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    monkeypatch.setattr(dispatch, "count_launch", counted)
    monkeypatch.setattr(build, "library", lambda name: _Launchless())
    return jax_seen, port_seen


def _fast_plain(monkeypatch):
    """The plain window block as zeros: the op-level sweeps run at the
    trunks' full widths, where its arithmetic on the CPU is slow and the
    route is all they hold."""
    monkeypatch.setattr(port_fab, "plain_window_block",
                        lambda x, *a, **k: x * 0)


def _sweep_one(spies, jax_call, port_call):
    jax_seen, port_seen = spies
    jax_seen.clear()
    port_seen.clear()
    jax_call()
    port_call()
    assert jax_seen == port_seen
    return dict(port_seen)


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
_WEIGHT_SHAPES = lambda c: ((c, 3 * c), (3 * c,), (c,), (c,), (c, c), (c,))  # noqa: E731


def _port_weights(c, dt, trainable):
    return [torch.zeros(sh, dtype=dt).requires_grad_(trainable)
            for sh in ((3 * c, c), (3 * c,), (c,), (c,), (c, c), (c,))]


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_weight_gradient_route_matches_the_jax_dispatch(spies, monkeypatch,
                                                        dt, jdt):
    """A trainable `fused_window_block`'s backward over window lengths and
    widths: K7's weight-gradient mode where the gradients (16 c^2) fit 8
    MiB and one window's live set fits 4 MiB, else the plain recompute,
    as the JAX gate `_bwd` routes it (fused_attention_block.py:1945-1991);
    the pad key always the plain recompute."""
    _fast_plain(monkeypatch)
    routes = collections.Counter()
    for s, c, nh, n_pad in ((16, 96, 1, 0), (64, 1152, 16, 0),
                            (196, 384, 4, 0), (256, 576, 8, 0),
                            (256, 384, 4, 0), (484, 576, 8, 0),
                            (484, 96, 1, 0), (256, 576, 8, 60),
                            (1024, 384, 4, 0)):
        def jax_call():
            def f(x, ws):
                return fab.fused_window_block(x, *ws, num_heads=nh,
                                              n_pad=n_pad, weight_grads=True)
            ws = tuple(jnp.zeros(sh, jdt) for sh in _WEIGHT_SHAPES(c))
            x = jnp.zeros((2, s, c), jdt)
            jax.eval_shape(lambda x, ws: jax.vjp(f, x, ws)[1](x), x, ws)

        def port_call():
            x = torch.zeros(2, s, c, dtype=dt, requires_grad=True)
            fused_window_block(x, *_port_weights(c, dt, True), num_heads=nh,
                               n_pad=n_pad).sum().backward()

        seen = _sweep_one(spies, jax_call, port_call)
        route = window_block_bwd_route(s, c, n_pad, True)
        assert ("K7 weight-grad" in seen) == (route == "K7 weight-grad")
        routes[route] += 1
    assert set(routes) == {"K7 weight-grad", "plain"}


# (H, W, window, c, heads): remainder grids at and below 4 window columns,
# divisible grids with aligned and unaligned windows, at the trunks' widths
_STRIP_GRIDS = [(60, 60, 14, 384, 4), (30, 30, 7, 768, 8),
                (64, 64, 14, 384, 4), (22, 22, 16, 576, 8),
                (12, 18, 5, 96, 1), (56, 56, 14, 384, 4),
                (28, 28, 14, 384, 4), (16, 16, 8, 1152, 16),
                (60, 60, 14, 448, 7)]


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_strips_routes_match_the_jax_dispatch(spies, monkeypatch, dt, jdt):
    """`fused_window_block_strips` forward (K4, K12 or the plain form) and
    backward (K5, K13a, K13b or the plain recompute) over grids, widths and
    dtypes, frozen and trainable, as `_fused_strips_vjp` and `_strips_bwd`
    route them; `strips_route` and `strips_bwd_route` name the same."""
    _fast_plain(monkeypatch)
    routes = collections.Counter()
    for i, (hh, wd, window, c, nh) in enumerate(_STRIP_GRIDS):
        # weights that need gradients always take the plain recompute:
        # two grids hold it
        for trainable in (False, True)[:1 + (i in (1, 7))]:
            def jax_call():
                def f(x, ws):
                    return fab.fused_window_block_strips(
                        x, *ws, num_heads=nh, window=window,
                        weight_grads=trainable)
                ws = tuple(jnp.zeros(sh, jdt) for sh in _WEIGHT_SHAPES(c))
                x = jnp.zeros((1, hh, wd, c), jdt)
                jax.eval_shape(lambda x, ws: jax.vjp(f, x, ws)[1](x), x, ws)

            def port_call():
                x = torch.zeros(1, hh, wd, c, dtype=dt, requires_grad=True)
                fused_window_block_strips(
                    x, *_port_weights(c, dt, trainable), num_heads=nh,
                    window=window).sum().backward()

            seen = _sweep_one(spies, jax_call, port_call)
            fwd = strips_route(hh, wd, window, c, nh, dt.itemsize)
            bwd = strips_bwd_route(hh, wd, window, c, nh, dt.itemsize,
                                   trainable)
            assert set(seen) == {fwd, bwd} - {"plain"}
            routes[fwd, bwd] += 1
    # hiera_b+@960's stage 3 (c 448): no K12 forward, K13b backward
    want = {("K4", "K5"), ("K12", "K13a"), ("plain", "plain"), ("K4", "plain"),
            ("K12", "plain")}
    if dt == torch.bfloat16:
        want |= {("K12", "K13b"), ("plain", "K13b")}
    assert want <= set(routes)


@pytest.mark.parametrize("dt,jdt", DTYPES)
def test_rem_strips_backward_regime_matches_the_jax_dispatch(spies, dt, jdt):
    """The model's K12 wrapper on the geometries where the JAX model takes
    K12 (hiera_t / hiera_s / hiera_b+ at 960 and 1024, stages 3-4): its
    backward launches the JAX package's K13a or K13b, or the plain
    recompute where the backward gate refuses, as `_strips_bwd` does
    after the same forward."""
    regimes = collections.Counter()
    for hh, wd, window, c, nh in _STRIP_GRIDS:
        if strips_route(hh, wd, window, c, nh, dt.itemsize) != "K12":
            continue

        def jax_call():
            def f(x):
                return fab.fused_window_block_strips(
                    x, *(jnp.zeros(sh, jdt) for sh in _WEIGHT_SHAPES(c)),
                    num_heads=nh, window=window, weight_grads=False)
            x = jnp.zeros((1, hh, wd, c), jdt)
            jax.eval_shape(lambda x: jax.vjp(f, x)[1](x), x)

        def port_call():
            x = torch.zeros(1, hh, wd, c, dtype=dt, requires_grad=True)
            fused_window_block_strips_rem(
                x, *_port_weights(c, dt, False), num_heads=nh,
                window=window).sum().backward()

        seen = _sweep_one(spies, jax_call, port_call)
        bwd = strips_bwd_route(hh, wd, window, c, nh, dt.itemsize)
        assert set(seen) == {"K12", bwd}
        regimes[bwd] += 1
    assert set(regimes) == ({"K13a", "K13b"} if dt == torch.bfloat16
                            else {"K13a"})


def test_rem_regime_is_the_jax_packages_choice():
    """`strips_rem_bwd_regime` against the regime test of
    `_fused_strips_rem_bwd_impl` (:1612-1620), computed with the JAX
    package's own estimate, wherever its backward gate holds."""
    seen = set()
    for hh, wd, window, c, nh in _STRIP_GRIDS:
        for itemsize in (2, 4):
            if not fab.strips_rem_supported(hh, wd, window, c, nh, itemsize,
                                            bwd=True):
                continue
            hp, wp = fab._win_pad_dims(window)
            d, n_w = c // nh, -(-wd // window)
            resident, _ = fab._pick_layout(nh, c, d, itemsize)
            wb = fab._rem_weight_bytes(nh, c, d, itemsize, resident)
            jw = fab._rem_vmem_est(1, n_w, hp * wp, c, d, window, wd,
                                   itemsize, wb, True) > fab._REM_VMEM_CAP
            want = "K13b" if jw else "K13a"
            assert strips_rem_bwd_regime(hh, wd, window, c, nh,
                                         itemsize) == want
            seen.add(want)
    assert seen == {"K13a", "K13b"}


# ------------------------------------------------------------- models


# Narrow, shallow trunks (blocks 1, 2 and the last the q-pool
# transitions). TRAIN, at 128 px (grids 32 / 16 / 8 / 4): stage 3's
# windowed block (8 x 8 at window 6) runs the persistent window groups in
# training, with one pad-free group (K7's weight-gradient mode) beside its
# pad-key groups, and the global block 3 (64 tokens at width 64) fits the
# weight-gradient budget too: 2 a step. EVAL, at 224 px (grids 56 / 28 /
# 14 / 7): stage 3's block (14 x 14 at window 4) has 4 window columns on a
# remainder grid, so the remainder-strip kernel (K12, backward K13a) takes
# it outside training.
TRAIN_TRUNK = dict(embed_dim=16, num_heads=1, stages=(1, 1, 3, 1),
                   global_att_blocks=(3,), window_spec=(8, 4, 6, 4),
                   window_pos_embed_bkg_spatial_size=(14, 14))
EVAL_TRUNK = dict(TRAIN_TRUNK, stages=(1, 1, 2, 1), global_att_blocks=(),
                  window_spec=(8, 4, 4, 2))
TRAIN_SIZE, EVAL_SIZE, RFB_OUT = 128, 224, 16


def _seeded(shapes, rng):
    """Seeded parameters for a tree of shapes: kernels lecun-scaled, scales
    near 1, everything else small noise."""
    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "kernel":
            return n / np.sqrt(np.prod(s.shape[:-1]))
        return 0.1 * n
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _assert_leaves_match(got: dict, want: dict):
    assert got.keys() == want.keys() and got
    for name, w in want.items():
        g, w = got[name].detach().double(), w.double()
        scale = float(w.abs().max())
        assert scale > 0, name
        assert float((g - w).abs().max()) <= LEAF_TOL * scale, name
        if g.numel() > 1:
            corr = torch.corrcoef(torch.stack([g.flatten(), w.flatten()]))
            assert float(corr[0, 1]) >= LEAF_CORR, name


@pytest.fixture(scope="module")
def trainable_trunk():
    """The JAX trunk without adapters (nothing frozen), its parameters, an
    input, cotangents of the four outputs and the gradients of
    sum(outputs * cotangents) in training."""
    model = JaxHiera(HieraConfig(**TRAIN_TRUNK))
    x = np.random.default_rng(5).standard_normal(
        (2, TRAIN_SIZE, TRAIN_SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), x)["params"]
    params = _seeded(shapes, np.random.default_rng(6))
    cot = [np.random.default_rng(7 + i).standard_normal(
        (2, TRAIN_SIZE // 4 >> i, TRAIN_SIZE // 4 >> i, 16 << i)).astype(
            np.float32) for i in range(4)]

    def loss(p, x, cot):
        outs = model.apply({"params": p}, x, train=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot))

    value, grads = jax.jit(jax.value_and_grad(loss))(params, x, cot)
    return model, params, x, cot, float(value), grads


def test_trainable_trunk_gradients_match_jax(trainable_trunk):
    """`Hiera(use_adapters=False)` in training: every parameter's gradient
    against `jax.grad` of the JAX `Hiera` (blocks not frozen, so its
    windowed blocks take K7's weight-gradient mode on the card)."""
    _, params, x, cot, value, grads = trainable_trunk
    port = PortHiera(PortHieraConfig(**TRAIN_TRUNK)).train()
    port.load_state_dict(jax_to_state_dict({"params": params},
                                           port.state_dict().keys(),
                                           wrap_blocks=False), strict=True)
    outs = port(torch.from_numpy(x))
    loss = sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot))
    assert abs(loss.item() - value) <= LOSS_RTOL * abs(value)
    loss.backward()
    want = jax_to_state_dict({"params": jax.tree.map(np.asarray, grads)},
                             port.state_dict().keys(), wrap_blocks=False)
    got = {n: p.grad for n, p in port.named_parameters()}
    assert all(g is not None for g in got.values())
    _assert_leaves_match(got, {n: want[n] for n in got})


def test_trainable_trunk_routes_match_the_jax_dispatch(spies,
                                                       trainable_trunk):
    """The same training step's kernels on both packages: per windowed
    group of n_pad = 0 and the global block, K7's weight-gradient mode."""
    model, params, *_ = trainable_trunk
    shape = (1, TRAIN_SIZE, TRAIN_SIZE, 3)

    def jax_call():
        ps = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), params)
        jax.eval_shape(jax.grad(lambda p, x: sum(
            jnp.sum(o) for o in model.apply({"params": p}, x, train=True))),
            ps, jnp.zeros(shape, jnp.float32))

    def port_call():
        port = PortHiera(PortHieraConfig(**TRAIN_TRUNK)).train()
        sum(o.sum() for o in port(torch.zeros(shape))).backward()

    seen = _sweep_one(spies, jax_call, port_call)
    # stage 3's windowed block (its pad-free group) and the global block
    assert seen["K7 weight-grad"] == 2 and "K7" not in seen


def _sam2unet_params(model, rng):
    x0 = np.zeros((1, EVAL_SIZE, EVAL_SIZE, 3), np.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), x0)
    params = _seeded(shapes["params"], rng)
    stats = jax.tree.map(
        lambda s: (np.abs(rng.standard_normal(s.shape)) * 0.3 + 0.5).astype(
            np.float32), shapes["batch_stats"])
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def eval_gradient():
    """The JAX SAM2UNet at EVAL_TRUNK, its variables, a batch, and the
    gradient of the structure loss with respect to the trainable set
    (adapters, neck, decoder) of `apply(..., train=False)`."""
    model = SAM2UNet(SAM2UNetConfig(trunk=HieraConfig(**EVAL_TRUNK),
                                    rfb_out=RFB_OUT))
    variables = _sam2unet_params(model, np.random.default_rng(11))
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, EVAL_SIZE, EVAL_SIZE, 3)).astype(np.float32)
    y = (rng.random((2, EVAL_SIZE, EVAL_SIZE, 1)) < 0.3).astype(np.float32)
    trainable, frozen = partition_params(variables["params"])

    def loss_fn(tr, frozen, stats, x, y):
        preds = model.apply({"params": merge_params(tr, frozen),
                             "batch_stats": stats}, x, train=False)
        return multi_head_loss(preds, y)

    value, grads = jax.jit(jax.value_and_grad(loss_fn))(
        trainable, frozen, variables["batch_stats"], x, y)
    return model, variables, x, y, float(value), grads


def test_frozen_trunk_eval_gradient_matches_jax(eval_gradient):
    """`SAM2UNet` in eval mode: the structure loss's gradient with respect
    to the trainable set through the frozen trunk, against `jax.grad` of
    the JAX `apply(..., train=False)` (the trunk's stage 3 runs K12
    forward and K13 backward on the card)."""
    from test_torch_train_cpu import _unflatten

    _, variables, x, y, value, grads = eval_gradient
    port = PortSAM2UNet(PortConfig(trunk=PortHieraConfig(**EVAL_TRUNK),
                                   rfb_out=RFB_OUT)).eval()
    port.load_state_dict(jax_to_state_dict(variables,
                                           port.state_dict().keys()),
                         strict=True)
    loss = port_loss(port(torch.from_numpy(x)), torch.from_numpy(y))
    assert abs(loss.item() - value) <= LOSS_RTOL * abs(value)
    names = [n for n, p in port.named_parameters() if is_trainable(n)]
    got = dict(zip(names, torch.autograd.grad(
        loss, [dict(port.named_parameters())[n] for n in names])))
    want = jax_to_state_dict({"params": _unflatten(grads)}, names)
    _assert_leaves_match(got, want)


def test_frozen_trunk_eval_routes_match_the_jax_dispatch(spies, eval_gradient):
    """The same eval-mode gradient's kernels on both packages: K12 forward
    and K13a backward on the remainder-grid block, beside K4, K8 / K9 and
    the tails' and adapters' K1 / K2 / K3."""
    model, variables, *_ = eval_gradient
    shape = (1, EVAL_SIZE, EVAL_SIZE, 3)
    trainable, frozen = partition_params(variables["params"])

    def jax_call():
        zeros = functools.partial(jax.tree.map,
                                  lambda a: jnp.zeros(a.shape, jnp.float32))
        jax.eval_shape(jax.grad(lambda tr, x: sum(
            jnp.sum(p) for p in model.apply(
                {"params": merge_params(tr, zeros(frozen)),
                 "batch_stats": zeros(variables["batch_stats"])},
                x, train=False))), zeros(trainable),
            jnp.zeros(shape, jnp.float32))

    def port_call():
        port = PortSAM2UNet(PortConfig(trunk=PortHieraConfig(**EVAL_TRUNK),
                                       rfb_out=RFB_OUT))
        preds = port.eval()(torch.zeros(shape))
        sum(p.sum() for p in preds).backward()

    seen = _sweep_one(spies, jax_call, port_call)
    assert seen["K12"] == seen["K13a"] == 1 and "K13b" not in seen
