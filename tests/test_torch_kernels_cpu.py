"""The port's kernel modules against the JAX package, on the CPU in fp32.

Each port wrapper is given CPU tensors, so it takes its plain PyTorch
version (the CUDA kernel itself runs only on the card: chip_smoke.py and
tests/test_torch_kernels_cuda.py). The same seeded numpy inputs go through
the JAX reference form (`_xla_mlp`, `_xla_strips`, `_xla_window_block`,
`_xla_transition`, `_xla_strips_rem`) and, for K4, K6, K8, K10 and K12,
through the Pallas kernel in interpret mode at the geometries of
tests/test_fused_ops.py. The backward wrappers (K2, K3, K5, K7, K9, K11)
are held against `jax.vjp` of the same `_xla_*` forms, and K5, K7, K9 and
K11 also against the Pallas backward kernels in interpret mode (K2 and K3 only
against `jax.vjp(_xla_mlp)`: the Pallas kernels differentiate tanh-GELU,
the port exact erf). Weights are JAX-layout (in, out) on the JAX side and
transposed for the port, weight gradients likewise.

Tolerance: rtol = atol = 2e-5 in fp32, the bound tests/test_fused_ops.py
holds the Pallas kernels to (sums in another order, no other difference).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_torch.ops.fused_attention_block as port_fab
import sam2unet_torch.ops.fused_mlp as port_mlp
import sam2unet_tpu.ops.pallas.flash_attention as fa
import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_transition as ft
from sam2unet_torch.ops import dispatch
from sam2unet_torch.ops.flash_attention import (
    _check_args,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_delta,
    plain_flash_attention_bwd,
)
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    long_sequence,
    strips_rem_supported,
    window_block_bwd,
    window_block_strips_bwd,
)
from sam2unet_torch.ops.fused_mlp import adapter_bwd, fused_mlp, mlp_bwd_dx
from sam2unet_torch.ops.fused_transition import (
    fused_transition_block,
    transition_bwd,
    transition_bwd_supported,
)
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


def test_hiera_block_mlp_module_is_the_gelu_mlp_of_its_tail():
    """A Hiera block's `mlp` module, called on its own, computes the GELU
    MLP that its tail runs through K1 (x + mlp(norm2(x)), the JAX
    package's `_xla_mlp` with LN and residual), not the ReLU default of
    the SAM2 heads' MLP."""
    from sam2unet_torch.models.hiera import MultiScaleBlock

    torch.manual_seed(3)
    blk = MultiScaleBlock(24, 24, 2, 4).eval()
    for prm in blk.parameters():
        torch.nn.init.normal_(prm, std=0.3)
    x = torch.randn(2, 8, 8, 24)
    a, b = blk.mlp.layers
    n = lambda t: t.detach().numpy()
    want = _xla_mlp(jnp.asarray(n(x)), n(a.weight).T, n(a.bias),
                    n(b.weight).T, n(b.bias), n(blk.norm2.weight),
                    n(blk.norm2.bias), residual=True)
    with torch.no_grad():
        _close(x + blk.mlp(blk.norm2(x)), want)


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


# ----------------------------------------------------------------- K11

# fp32, the bound tests/test_fused_ops.py:821-847 holds the Pallas streaming
# backward to: sums over up to 960 keys in another order
K11_TOL = dict(rtol=2e-4, atol=2e-4)


def _flash_inputs(geom, seed):
    b, sq, sk, nh, d = geom
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32) * 0.5
                 for sh in ((b, sq, nh, d), (b, sk, nh, d), (b, sk, nh, d),
                            (b, sq, nh, d)))


@pytest.mark.parametrize("geom", FLASH_GEOMS[:2])
def test_k11_flash_attention_bwd_matches_pallas_interpret(geom):
    """The port's backward fed the Pallas forward's o and lse, against the
    Pallas dq and dk/dv kernels in interpret mode. The second geometry has
    B = 2 and 2 heads, so it pins the (B*heads, Sq) order of lse and D
    (index b*heads + h, `_to_flat`'s)."""
    b, sq, sk, nh, d = geom
    q, k, v, g = _flash_inputs(geom, 51)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._stream_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 scale, interpret=True)
    want = fa._stream_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               o, lse, jnp.asarray(g), scale, interpret=True)
    lse_t = _t(np.array(lse).reshape(b * nh, sq))
    got = flash_attention_bwd(_t(q), _t(k), _t(v), _t(np.array(o)), lse_t,
                              _t(g), scale)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **K11_TOL)


# the two above and a ragged pair of lengths (no multiple of 16, Sq != Sk),
# which the Pallas kernels do not take
@pytest.mark.parametrize("geom", FLASH_GEOMS[:2] + [(2, 75, 133, 2, 16)])
def test_k11_flash_attention_bwd_matches_jax_vjp(geom):
    q, k, v, g = _flash_inputs(geom, 52)
    _, vjp = jax.vjp(fa._xla_attention, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    o, lse = flash_attention(_t(q), _t(k), _t(v), return_lse=True)
    got = flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(g))
    plain = plain_flash_attention_bwd(_t(q), _t(k), _t(v), o, lse, _t(g))
    for a, b, w in zip(got, plain, vjp(jnp.asarray(g))):
        assert torch.equal(a, b)   # a CPU tensor takes the plain version
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **K11_TOL)


def test_k11_delta_is_indexed_by_batch_then_head():
    """D[b*heads + h, t] = dO[b, t, h] . o[b, t, h], the order of K10's lse
    (`_stream_bwd_impl`'s delta, flash_attention.py:306)."""
    rng = np.random.default_rng(53)
    o, g = (rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = jnp.einsum("bqhd,bqhd->bhq", g, o).reshape(6, 20)
    got = flash_attention_bwd_delta(_t(o), _t(g))
    _close(got, want)
    assert abs(float(got[1 * 2 + 1, 7]) - float((g[1, 7, 1] * o[1, 7, 1]).sum())) < 1e-5


def test_k11_takes_and_writes_strided_views():
    """q/k/v as channel slices of one QKV buffer and dq/dk/dv written into
    the channel slices of one dqkv buffer, as the long block's backward
    does, against the same values made contiguous."""
    rng = np.random.default_rng(54)
    qkv = _t(rng.standard_normal((2, 200, 3, 2, 16)).astype(np.float32))
    g = _t(rng.standard_normal((2, 200, 2, 16)).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    o, lse = flash_attention(q, k, v, return_lse=True)
    want = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               o, lse, g)
    dqkv = torch.full_like(qkv, float("nan"))
    got = flash_attention_bwd(q, k, v, o, lse, g,
                              out=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
    assert got[0].data_ptr() == dqkv.data_ptr()
    assert got[0].stride() == (200 * 96, 96, 16, 1)
    for i, w in enumerate(want):
        assert torch.equal(dqkv[:, :, i], w)


def test_flash_attention_is_differentiable_on_the_cpu():
    """On a CPU tensor autograd goes through the plain version; its
    gradients are those `flash_attention_bwd` computes from o and lse."""
    q, k, v, g = (_t(a) for a in _flash_inputs((2, 40, 56, 2, 8), 55))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o, lse = flash_attention(*leaves, return_lse=True)
    want = torch.autograd.grad(o, leaves, g)
    got = flash_attention_bwd(q, k, v, o.detach(), lse.detach(), g)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("case", ["head dim 12", "odd token stride",
                                  "strided channels", "k and v differ",
                                  "dk shaped like q", "fp64"])
def test_flash_argument_checks_refuse_what_the_kernels_cannot_address(case):
    """The checks the card's K10 and K11 wrappers run before a launch
    (16-byte vector loads: aligned bases, strides in multiples of 8
    elements, unit stride over d, d % 8 == 0 and <= 96)."""
    z = torch.zeros
    q, k, v, more, err = z(1, 32, 2, 16), z(1, 48, 2, 16), z(1, 48, 2, 16), {}, ValueError
    if case == "head dim 12":
        q, k, v = z(1, 32, 2, 12), z(1, 48, 2, 12), z(1, 48, 2, 12)
    elif case == "odd token stride":
        q = z(1, 32, 36)[:, :, :32].reshape(1, 32, 2, 16)
        assert q.stride(1) == 36
    elif case == "strided channels":
        q = z(1, 32, 2, 32)[..., ::2]
    elif case == "k and v differ":
        v = z(1, 48, 3, 2, 16)[:, :, 0]
    elif case == "dk shaped like q":
        more = dict(dk=z(1, 32, 2, 16))
    else:
        q, k, v, err = q.double(), k.double(), v.double(), TypeError
    with pytest.raises(err):
        _check_args(q, k, v, **more)
    assert _check_args(z(1, 32, 2, 16), z(1, 48, 2, 16), z(1, 48, 2, 16),
                       dk=z(1, 48, 2, 16)) == (1, 32, 48, 2, 16)


def test_long_window_block_backward_matches_jax_vjp():
    """A 1296-token block: past `long_sequence` and past 1024 tokens with a
    16-aligned length, so its backward route is K11 and the card's node is
    `_long_window_block_backward` (LN, QKV, K10 again, K11, the products
    and LN backward). Run here on CPU tensors, where each wrapper inside it
    takes its plain version, against `jax.vjp` of `_xla_window_block`: dx to
    2e-5 of its max."""
    nw, s, c, nh = 1, 1296, 32, 2
    assert long_sequence(s, c)
    assert port_fab.window_block_bwd_route(s, c, 0, False) == "K11"
    mk = _mk(np.random.default_rng(56))
    x, gy = mk(nw, s, c), mk(nw, s, c)
    ja, pa = _block_weights(mk, c)
    _, vjp = jax.vjp(lambda xx: fab._xla_window_block(xx, *ja, nh, 0, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_fab, "flash_attention_bwd",
                   lambda *a, **k: calls.append(1) or flash_attention_bwd(*a, **k))
        got = port_fab._window_block_backward(
            (_t(x), *pa), _t(gy), (True,) + (False,) * 6, num_heads=nh,
            n_pad=0, residual=True)
    assert calls == [1] and all(g is None for g in got[1:])
    err = float(np.abs(got[0].numpy() - want).max())
    assert err <= 2e-5 * float(np.abs(want).max()), err


def test_long_window_block_backward_with_trainable_weights():
    """Weights that need gradients: autograd through the long form
    recomputed, against `jax.vjp` of `_xla_window_block` on every input."""
    nw, s, c, nh = 1, 1040, 16, 1
    mk = _mk(np.random.default_rng(57))
    x, gy = mk(nw, s, c), mk(nw, s, c)
    ja, pa = _block_weights(mk, c)
    _, vjp = jax.vjp(lambda *a: fab._xla_window_block(*a, nh, 0, False),
                     jnp.asarray(x), *ja)
    want = vjp(jnp.asarray(gy))
    got = port_fab._window_block_backward(
        (_t(x), *pa), _t(gy), (True,) * 7, num_heads=nh, n_pad=0,
        residual=False)
    for i, (a, w) in enumerate(zip(got, want)):
        w = np.asarray(w).T if i in (1, 5) else np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(a.numpy() - w).max()) <= 2e-5 * scale, i


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


# ------------------------------------------------------- backward: K2, K3


@pytest.mark.parametrize("shape,hidden", [((2, 7, 9, 32), 128), ((5, 48), 192),
                                          ((3, 4, 4, 144), 576)])
def test_k2_mlp_bwd_dx_matches_jax_vjp(shape, hidden):
    mk = _mk(np.random.default_rng(30))
    c = shape[-1]
    x, gy = mk(*shape), mk(*shape)
    w1, b1, w2, b2 = mk(c, hidden), mk(hidden), mk(hidden, c), mk(c)
    lns, lnb = mk(c) + 1, mk(c)
    _, vjp = jax.vjp(lambda xx: _xla_mlp(xx, w1, b1, w2, b2, lns, lnb,
                                         residual=True), jnp.asarray(x))
    got = mlp_bwd_dx(_t(x), _t(gy), _t(w1, True), _t(b1), _t(w2, True),
                     _t(b2), _t(lns), _t(lnb))
    _close(got, vjp(jnp.asarray(gy))[0])


@pytest.mark.parametrize("shape", [(2, 8, 8, 24), (6, 144), (2, 11, 11, 48)])
def test_k3_adapter_bwd_matches_jax_vjp(shape):
    """dx and the four weight gradients."""
    mk = _mk(np.random.default_rng(31))
    c, hidden = shape[-1], 32
    x, gy = mk(*shape), mk(*shape)
    w1, b1, w2, b2 = mk(c, hidden), mk(hidden), mk(hidden, c), mk(c)
    _, vjp = jax.vjp(lambda *a: _xla_mlp(*a, residual=True, gelu_out=True),
                     jnp.asarray(x), w1, b1, w2, b2)
    want = vjp(jnp.asarray(gy))
    got = adapter_bwd(_t(x), _t(gy), _t(w1, True), _t(b1), _t(w2, True),
                      _t(b2))
    for g, w, transpose in zip(got, want, (False, True, False, True, False)):
        _close(g.t() if transpose else g, w)


# --------------------------------------------------- backward: K5, K7, K9


@pytest.mark.parametrize("geom", STRIP_GEOMS)
def test_k5_strips_bwd_matches_jax_vjp(geom):
    b, hh, wd, c, nh, win, res = geom
    mk = _mk(np.random.default_rng(32))
    x, gy = mk(b, hh, wd, c), mk(b, hh, wd, c)
    ja, pa = _block_weights(mk, c)
    _, vjp = jax.vjp(lambda xx: fab._xla_strips(xx, *ja, nh, win, res),
                     jnp.asarray(x))
    got = window_block_strips_bwd(_t(x), _t(gy), *pa, num_heads=nh,
                                  window=win, residual=res)
    _close(got, vjp(jnp.asarray(gy))[0])


@pytest.mark.parametrize("geom", STRIP_GEOMS[:3])
def test_k5_strips_bwd_matches_pallas_interpret(geom):
    b, hh, wd, c, nh, win, res = geom
    mk = _mk(np.random.default_rng(33))
    x, gy = mk(b, hh, wd, c), mk(b, hh, wd, c)
    ja, pa = _block_weights(mk, c)
    want = fab._fused_strips_bwd_impl(jnp.asarray(x), jnp.asarray(gy),
                                      *ja[:5], nh, win, res, interpret=True)
    got = window_block_strips_bwd(_t(x), _t(gy), *pa, num_heads=nh,
                                  window=win, residual=res)
    _close(got, want)


# K7's geometries: n_pad = 0 only (the pad-key groups' backward is the
# reference recompute), with hiera_l@352's full groups and global block in
# miniature and a ragged S
K7_GEOMS = [g for g in WINDOW_GEOMS if g[4] == 0 and g[1] < 1024] + [
    (2, 100, 24, 2, 0)]


@pytest.mark.parametrize("geom", K7_GEOMS)
def test_k7_window_block_bwd_matches_jax_vjp(geom):
    nw, s, c, nh, _ = geom
    mk = _mk(np.random.default_rng(34))
    x, gy = mk(nw, s, c), mk(nw, s, c)
    ja, pa = _block_weights(mk, c)
    _, vjp = jax.vjp(lambda xx: fab._xla_window_block(xx, *ja, nh, 0, True),
                     jnp.asarray(x))
    got = window_block_bwd(_t(x), _t(gy), *pa, num_heads=nh)
    _close(got, vjp(jnp.asarray(gy))[0])


@pytest.mark.parametrize("geom", K7_GEOMS[:2])
def test_k7_window_block_bwd_matches_pallas_interpret(geom):
    """test_fused_ops.py:334's frozen dx-only variant."""
    nw, s, c, nh, _ = geom
    mk = _mk(np.random.default_rng(35))
    x, gy = mk(nw, s, c), mk(nw, s, c)
    ja, pa = _block_weights(mk, c)
    want = fab._fused_window_block_bwd_impl(
        jnp.asarray(x), jnp.asarray(gy), *ja[:5], nh, True,
        weight_grads=False, interpret=True)[0]
    got = window_block_bwd(_t(x), _t(gy), *pa, num_heads=nh)
    _close(got, want)


@pytest.mark.parametrize("geom", TRANSITION_GEOMS)
def test_k9_transition_bwd_matches_jax_vjp(geom):
    x, ja, pa = _transition_inputs(36, geom)
    b, hh, wd, _, cout, nh, win = geom
    gy = _mk(np.random.default_rng(37))(b, hh // 2, wd // 2, cout)
    _, vjp = jax.vjp(lambda xx: ft._xla_transition(xx, *ja, nh, win),
                     jnp.asarray(x))
    got = transition_bwd(_t(x), _t(gy), *pa, num_heads=nh, window=win)
    _close(got, vjp(jnp.asarray(gy))[0])


@pytest.mark.parametrize("geom", TRANSITION_GEOMS)
def test_k9_transition_bwd_matches_pallas_interpret(geom):
    """test_fused_ops.py:859's geometries."""
    x, ja, pa = _transition_inputs(38, geom)
    b, hh, wd, _, cout, nh, win = geom
    gy = _mk(np.random.default_rng(39))(b, hh // 2, wd // 2, cout)
    w, bq, lns, lnb, wp, _, wsh, bsh = ja
    want = ft._transition_bwd_impl(jnp.asarray(x), jnp.asarray(gy), w, bq,
                                   lns, lnb, wp, wsh, bsh, nh, win,
                                   interpret=True)
    got = transition_bwd(_t(x), _t(gy), *pa, num_heads=nh, window=win)
    _close(got, want)


def test_k9_routes_anti_diagonal_ties_like_xla():
    """Cells [[u, v], [v, u]] tie on the diagonal or the anti-diagonal in
    every channel. XLA's select_and_scatter (and torch's max_pool2d) send
    the gradient to the first maximum in row-major order; so does the port.
    (The Pallas backward pools rows first, then columns, and picks (1, 0)
    on an anti-diagonal tie: it is not the oracle here.)"""
    geom = (1, 8, 8, 24, 48, 2, 4)
    x, ja, pa = _transition_inputs(41, geom)
    u, v = x[:, :4, :4], x[:, 4:, 4:]
    x = np.stack([np.stack([u, v], 3), np.stack([v, u], 3)], 2).reshape(x.shape)
    gy = _mk(np.random.default_rng(42))(1, 4, 4, 48)
    _, vjp = jax.vjp(lambda xx: ft._xla_transition(xx, *ja, 2, 4),
                     jnp.asarray(x))
    got = transition_bwd(_t(x), _t(gy), *pa, num_heads=2, window=4)
    _close(got, vjp(jnp.asarray(gy))[0])


# (window, cout, W, cin, want): hiera_l@352's two divisible transitions
# pass; hiera_s@960's 240x240 window-8 one does not
@pytest.mark.parametrize("geom", [(8, 288, 88, 144, True), (4, 576, 44, 288, True),
                                  (8, 192, 240, 96, False), (4, 384, 120, 192, True),
                                  (14, 768, 60, 384, False)])
def test_transition_bwd_gate_matches_jax(geom):
    *args, want = geom
    assert ft.transition_bwd_supported(*args) is want
    assert transition_bwd_supported(*args) is want


# (S, c, n_pad, weight_grads, route) of `fused_window_block`'s backward:
# hiera_l@352's full groups, pad-key groups and 484-token global blocks;
# hiera_s@960's 3600-token global blocks (K11); trainable weights
@pytest.mark.parametrize("geom", [
    (256, 576, 0, False, "K7"), (64, 1152, 0, False, "K7"),
    (484, 576, 0, False, "K7"), (96, 576, 160, False, "plain"),
    (3600, 384, 0, False, "K11"), (1089, 384, 0, False, "plain"),
    (1024, 256, 0, False, "plain"), (256, 576, 0, True, "K7 weight-grad"),
    (64, 1152, 0, True, "plain"), (484, 576, 0, True, "plain"),
    (36, 576, 220, True, "plain")])
def test_window_block_bwd_route_follows_the_jax_dispatch(geom):
    """The JAX package's `_bwd` (fused_attention_block.py:1956-1968) takes
    its kernel for n_pad = 0 when the weight-gradient scratch and one
    window's live set fit; otherwise its XLA recompute, whose attention
    past 1024 tokens with a 16-aligned block is `flash_attention`'s
    streaming backward (flash_attention.py:439-464, K11)."""
    s, c, n_pad, weight_grads, want = geom
    s_pad = s + (-s) % 16
    live = 12 * s_pad * s_pad + 14 * s_pad * c
    budget = (4 if weight_grads else 8) * 1024 * 1024
    kernel = (n_pad == 0 and (16 * c * c if weight_grads else 0) <= 8 * 1024 * 1024
              and live <= budget)
    stream = (not kernel and n_pad == 0 and s > fa._MAX_FULL_SEQ
              and fa._pick_stream_blocks(s, s) is not None)
    assert {"K7": kernel and not weight_grads,
            "K7 weight-grad": kernel and weight_grads,
            "K11": stream, "plain": not kernel and not stream}[want]
    assert port_fab.window_block_bwd_route(s, c, n_pad, weight_grads) == want


@pytest.mark.parametrize("window,c,want", [(8, 144, True), (4, 288, True),
                                           (8, 96, True), (7, 384, False),
                                           (16, 1152, True), (32, 768, False)])
def test_strips_bwd_gate_matches_jax(window, c, want):
    """`_strips_bwd`'s K5 gate (fused_attention_block.py:1899-1905) on
    divisible grids."""
    s = window * window
    s16 = s + (-s) % 16
    assert (s % 16 == 0 and 12 * s16 * s16 + 18 * s16 * c <= 8 * 1024 * 1024) is want
    assert port_fab.strips_bwd_kernel(window, c) is want


def _zeros_block(nw, s, c):
    x = torch.zeros(nw, s, c)
    return (x, torch.zeros(3 * c, c), torch.zeros(3 * c), torch.ones(c),
            torch.zeros(c), torch.zeros(c, c), torch.zeros(c))


@pytest.mark.parametrize("case", ["K7 weight-grad", "K13", "K2"])
def test_backward_raises_where_the_jax_package_runs_an_unported_kernel(case):
    """The backward nodes the card's wrappers record: where the JAX package
    runs a kernel the port has not ported, they raise naming the ROADMAP.md
    item, and never recompute through the plain version instead."""
    if case == "K7 weight-grad":
        saved = _zeros_block(1, 16, 24)
        call = lambda: port_fab._window_block_backward(  # noqa: E731
            saved, torch.zeros(1, 16, 24), (True,) * 7, num_heads=1, n_pad=0,
            residual=True)
        match = "weight-grad.*open item 1"
    elif case == "K13":
        x, *w = _zeros_block(1, 12, 8)
        saved = (x.reshape(1, 3, 4, 8), *w)
        call = lambda: port_fab._strips_rem_backward(  # noqa: E731
            saved, saved[0], (True,) + (False,) * 6, num_heads=1, window=3,
            residual=True)
        match = "K13.*open item 2"
    else:
        x = torch.zeros(4, 16)
        saved = (x, torch.zeros(32, 16), torch.zeros(32), torch.zeros(16, 32),
                 torch.zeros(16), None, None)
        call = lambda: port_mlp._mlp_backward(  # noqa: E731
            saved, x, (True,) + (False,) * 6, residual=True, gelu_out=False)
        match = "K2 without LayerNorm.*open item 1"
    with pytest.raises(NotImplementedError, match=match):
        call()


def test_backward_takes_the_plain_recompute_where_the_jax_package_does():
    """A pad-key group's backward (the JAX package's XLA recompute) and a
    trainable block's: autograd through the plain version, on every input
    that needs a gradient."""
    saved = _zeros_block(2, 9, 8)
    gy = torch.ones(2, 9, 8)
    got = port_fab._window_block_backward(saved, gy, (True,) + (False,) * 6,
                                          num_heads=1, n_pad=55, residual=True)
    assert got[0].shape == (2, 9, 8) and all(g is None for g in got[1:])
    got = port_fab._window_block_backward(saved, gy, (True,) * 7, num_heads=1,
                                          n_pad=55, residual=True)
    assert all(g is not None for g in got)


def test_wrappers_record_the_plain_graph_on_the_cpu():
    """A CPU tensor that requires grad goes through the plain version, so
    autograd reaches the inputs and the weights."""
    mk = _mk(np.random.default_rng(40))
    x = _t(mk(2, 8, 8, 24)).requires_grad_(True)
    _, pa = _block_weights(mk, 24)
    pa = [w.requires_grad_(True) for w in pa]
    fused_window_block_strips(x, *pa, num_heads=2, window=4).sum().backward()
    assert x.grad is not None and all(w.grad is not None for w in pa)


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


# ------------------------------------------------------- K14 and the switch

# the shapes K14 takes on the paths of the port (q and k/v lengths, heads,
# head dim; the batch cut for the CPU): the SAM2 hiera_s@1024 and SAM2-UNet
# hiera_s@960 stage 3->4 transition, the mask decoder's token
# self-attention (8 tokens) and image->token attention (4096 queries), the
# hiera_l@352 transition
K14_SHAPES = [(2, 49, 196, 8, 96), (1, 8, 8, 8, 32), (1, 4096, 8, 8, 16),
              (2, 64, 256, 16, 72), (2, 16, 16, 8, 32)]


class _Ref:
    """A stand-in for a Pallas ref: `[:]` reads the array, assignment
    keeps the value."""

    def __init__(self, value=None, dtype=jnp.float32):
        self.value, self.dtype = value, dtype

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


def _qkv(shape, seed=31):
    b, sq, sk, nh, d = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32) * 0.7
                 for sh in ((b, sq, nh, d), (b, sk, nh, d), (b, sk, nh, d)))


@pytest.mark.parametrize("shape", K14_SHAPES)
def test_k14_plain_version_matches_the_tpu_kernel_and_xla(shape):
    """`plain_full_attention` (what `full_attention` runs on CPU tensors)
    against the body of the JAX package's K14, `_kernel`, run on arrays in
    its (batch*heads, S, d) layout (`_fused_full` has no interpret switch),
    and against `_xla_attention`."""
    b, sq, sk, nh, d = shape
    q, k, v = _qkv(shape)
    scale = 1.0 / math.sqrt(d)
    flat = [jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * nh, -1, d))
            for t in (q, k, v)]
    out = _Ref()
    fa._kernel(*map(_Ref, flat), out, scale=scale)
    want = np.asarray(out.value).reshape(b, nh, sq, d).transpose(0, 2, 1, 3)
    from sam2unet_torch.ops.flash_attention import full_attention

    got = full_attention(_t(q), _t(k), _t(v))
    _close(got, want)
    _close(got, fa._xla_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v)))


def test_k14_backward_matches_the_jax_recompute():
    """Autograd through `full_attention` against the JAX package's VJP in
    this regime (the einsum recompute of `flash_attention._bwd`)."""
    from sam2unet_torch.ops.flash_attention import full_attention

    shape = (2, 24, 40, 2, 16)
    q, k, v = _qkv(shape, seed=32)
    g = np.random.default_rng(33).standard_normal(q.shape).astype(np.float32)
    want = fa._bwd(None, (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None, None), jnp.asarray(g))
    leaves = [_t(t).requires_grad_(True) for t in (q, k, v)]
    full_attention(*leaves).backward(_t(g))
    for leaf, w in zip(leaves, want):
        _close(leaf.grad, w)


def test_k14_backward_in_bf16_keeps_p_in_fp32_as_the_jax_recompute():
    """In bf16 too the gradients are `_bwd`'s: p, dp and ds stay fp32 and
    only dq, dk and dv are rounded, so the port's gradients agree with the
    JAX package's to 1e-3 of max |grad| (fp32 summation order). Autograd
    through the plain forward, which rounds p to bf16 before P.V, misses
    that by 2-6e-3 at this shape."""
    from sam2unet_torch.ops.flash_attention import full_attention

    q, k, v = _qkv((2, 49, 196, 2, 32), seed=36)
    g = np.random.default_rng(37).standard_normal(q.shape).astype(np.float32)
    want = fa._bwd(None, tuple(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
                   + (None, None), jnp.asarray(g, jnp.bfloat16))
    leaves = [_t(t).bfloat16().requires_grad_(True) for t in (q, k, v)]
    full_attention(*leaves).backward(_t(g).bfloat16())
    for leaf, w in zip(leaves, want):
        w = np.asarray(w.astype(jnp.float32))
        assert leaf.grad.dtype == torch.bfloat16
        assert np.abs(leaf.grad.float().numpy() - w).max() <= (
            1e-3 * np.abs(w).max())


def _jax_route(monkeypatch, impl, q, k, v, key_valid):
    """Which form the JAX package's `sdpa` runs for `impl` on the card,
    recorded on the CPU: its TPU test (`dispatch.xla_only`) answered no and
    each form replaced by a spy that computes `_xla_attention`."""
    from sam2unet_tpu.ops import attention as jax_attention

    seen = []
    xla = fa._xla_attention

    def spy(name):
        def run(q_, k_, v_, scale=None, **kw):
            seen.append(name)
            o = xla(q_, k_, v_, scale=scale, key_valid=kw.get("key_valid"))
            return (o, jnp.zeros((q_.shape[0] * q_.shape[2], q_.shape[1], 1))
                    ) if name == "K10" else o
        return run

    monkeypatch.setattr(fa.dispatch, "xla_only", lambda: False)
    monkeypatch.setattr(fa, "_fused_full", spy("K14"))
    monkeypatch.setattr(fa, "_stream_fwd_impl", spy("K10"))
    monkeypatch.setattr(fa, "_xla_attention", spy("einsum"))
    monkeypatch.setattr(jax.nn, "dot_product_attention", spy("xla"))
    out = jax_attention.sdpa(*(jnp.asarray(t) for t in (q, k, v)), impl=impl,
                             key_valid=None if key_valid is None
                             else jnp.asarray(key_valid))
    return seen, np.asarray(out)


ROUTE_CASES = {
    # the mask decoder at 1024 px: token self-attention, image->token and
    # token->image with 8 tokens (one point) and 16 (nine points)
    "8 tokens": (1, 8, 8, 2, 8),
    "4096 queries x 8 tokens": (1, 4096, 8, 2, 8),
    "8 tokens x 4096 keys": (1, 8, 4096, 2, 8),
    "16 tokens x 4096 keys": (1, 16, 4096, 2, 8),
    # the unfused stage 3->4 transition window at 960 and 1024 px
    "transition window": (2, 49, 196, 2, 8),
    # no 16-aligned block divides 1100 keys
    "1100 keys": (1, 32, 1100, 1, 8),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
@pytest.mark.parametrize("impl", ["auto", "einsum", "xla", "pallas"])
@pytest.mark.parametrize("masked", [False, True])
def test_sdpa_routes_like_the_jax_package(monkeypatch, case, impl, masked):
    """The port's `sdpa` / `dispatch_attention` launch K14, K10 or nothing
    exactly where the JAX package's `sdpa` / `_dispatch_fwd` run `_fused_full`,
    the streaming kernel or the einsum form, for every backend and with a
    key mask (which forces the einsum form); "xla" (the JAX package's
    `jax.nn.dot_product_attention`, no Pallas kernel) is the einsum form in
    the port. The outputs agree too."""
    import sam2unet_torch.ops.attention as port_attention
    import sam2unet_torch.ops.flash_attention as port_fa

    shape = ROUTE_CASES[case]
    q, k, v = _qkv(shape, seed=34)
    key_valid = None
    if masked:
        key_valid = np.random.default_rng(35).random((shape[0], shape[2])) > 0.3
        key_valid[:, 0] = True
    want_route, want = _jax_route(monkeypatch, impl, q, k, v, key_valid)
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
    got = port_attention.sdpa(_t(q), _t(k), _t(v), impl=impl,
                              key_valid=None if key_valid is None
                              else torch.from_numpy(key_valid))
    assert seen == ["einsum" if r == "xla" else r for r in want_route]
    assert len(seen) == 1
    _close(got, want)


def test_attention_backend_switch_reaches_k14_in_the_trunk(monkeypatch):
    """`set_attention_impl("pallas")` sends the trunk's unfused q-pool
    transition (the 64x64 window-14 one of SAM2 at 1024 px, here at 28x28)
    to K14 once, as the JAX package's switch sends it to `_fused_full`; the
    default backend ("auto", 196 keys) does not reach K14. The outputs are
    equal. Unknown backends are refused."""
    import sam2unet_torch.models.hiera as port_hiera
    import sam2unet_torch.ops.flash_attention as port_fa
    from sam2unet_torch.ops import attention

    calls = []
    k14 = port_fa.full_attention
    monkeypatch.setattr(port_fa, "full_attention",
                        lambda *a, **kw: calls.append(a[1].shape) or k14(*a, **kw))
    blk = port_hiera.MultiScaleBlock(16, 32, 2, 14, (2, 2)).eval()
    x = torch.randn(1, 28, 28, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = blk(x)
        assert calls == []
        attention.set_attention_impl("pallas")
        try:
            got = blk(x)
        finally:
            attention.set_attention_impl(None)
    assert calls == [(4, 196, 2, 16)]
    _close(got, want.numpy())
    with pytest.raises(ValueError):
        attention.set_attention_impl("flash")
    with pytest.raises(ValueError):
        attention.sdpa(torch.zeros(1, 2, 1, 8), torch.zeros(1, 2, 1, 8),
                       torch.zeros(1, 2, 1, 8), impl="cudnn")


def test_full_attention_checks_refuse_what_k14_cannot_take():
    """On CPU tensors the plain version runs; these checks guard the
    kernel's launch (the card's tests hold the raise there)."""
    from sam2unet_torch.ops.flash_attention import _full_attention_kernel

    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="1024"):
        _full_attention_kernel(q, torch.zeros(1, 1025, 2, 16),
                               torch.zeros(1, 1025, 2, 16), 0.25)
    with pytest.raises(ValueError, match="shapes"):
        _full_attention_kernel(q, torch.zeros(1, 4, 2, 8), q, 0.25)
    with pytest.raises(TypeError):
        _full_attention_kernel(q.double(), q.double(), q.double(), 0.25)
