"""Every head dim the JAX attention kernels take, on the CPU in fp32.

The port's K10, K11 and K14 take any head dim on the card (the chunked,
element-loading kernels of csrc/attention_any*.cu past the 16-byte-vector
instances); on CPU tensors each wrapper takes its plain version, which is
what these tests hold against the JAX package: the Pallas streaming
kernels in interpret mode (`_stream_fwd_impl`, `_stream_bwd_impl`), the body
of the full-row kernel (`_kernel`, which `_fused_full` launches) and
`jax.vjp` of the JAX `flash_attention`, at head dims 12 (the JAX kernel
tests' window family), 128, 256 (the video memory attention's) and 264.
Then the wrapper checks: any head dim, any stride and any width pass (the
widths once refused reach their entry point; csrc/gemm_any.cu takes them
on the card), a head count that does not divide c does not. The window
family at head dim 12 is held against the JAX package in
tests/test_torch_kernels_cpu.py (its geometries are the JAX tests' c 24
over 2 heads); the kernels
themselves against their plain versions on the card in
tests/test_torch_kernels_cuda.py and chip_smoke.py's `headdims` path.

Tolerances: the JAX tests' bounds, 2e-5 forward and 2e-4 backward.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.flash_attention as fa
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.flash_attention import (
    _check_args,
    _check_view,
    _flash_attention_kernel,
    _full_attention_kernel,
    flash_attention,
    flash_attention_bwd,
    full_attention,
)
from sam2unet_torch.ops.fused_attention_block import (
    _check_block,
    _window_block_kernel,
)
from sam2unet_torch.ops.fused_transition import (
    _check_transition,
    _transition_kernel,
)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-4)
HEAD_DIMS = (12, 128, 256, 264)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, sq, sk, nh, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32) * 0.5
                 for sh in ((b, sq, nh, d), (b, sk, nh, d), (b, sk, nh, d),
                            (b, sq, nh, d)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k10_and_k11_plain_versions_match_the_pallas_kernels(d):
    """K10's o and lse and K11's dq, dk, dv (plain versions, what the CPU
    runs) against `_stream_fwd_impl` and `_stream_bwd_impl` in interpret
    mode at (2, 160, 320, 2, d): 16-aligned lengths the Pallas kernels'
    blocks divide, two batch entries and two heads (the (B*heads, Sq) order
    of lse and D), the scale 1/sqrt(d) of the true d."""
    b, sq, sk, nh = 2, 160, 320, 2
    q, k, v, g = _inputs(b, sq, sk, nh, d, 160 + d)
    scale = 1.0 / math.sqrt(d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o, lse = fa._stream_fwd_impl(jq, jk, jv, scale, interpret=True)
    got, got_lse = flash_attention(_t(q), _t(k), _t(v), return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(o), **FWD_TOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse).reshape(b * nh, sq), **FWD_TOL)
    want = fa._stream_bwd_impl(jq, jk, jv, o, lse, jnp.asarray(g), scale,
                               interpret=True)
    grads = flash_attention_bwd(_t(q), _t(k), _t(v), got, got_lse, _t(g))
    for a, w in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **BWD_TOL)


class _Ref:
    """A Pallas ref stand-in: `[:]` reads the array, assignment keeps it."""

    def __init__(self, value=None, dtype=jnp.float32):
        self.value, self.dtype = value, dtype

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k14_plain_version_matches_the_full_row_kernel(d):
    """K14's plain version (`full_attention` on CPU tensors) against the
    body of the JAX package's K14, `_kernel`, on its (batch*heads, S, d)
    layout (`_fused_full` has no interpret switch), over 49 -> 196 tokens
    (SAM2-UNet's 960 transition's lengths)."""
    b, sq, sk, nh = 2, 49, 196, 2
    q, k, v, _ = _inputs(b, sq, sk, nh, d, 490 + d)
    flat = [jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * nh, -1, d))
            for t in (q, k, v)]
    out = _Ref()
    fa._kernel(*map(_Ref, flat), out, scale=1.0 / math.sqrt(d))
    want = np.asarray(out.value).reshape(b, nh, sq, d).transpose(0, 2, 1, 3)
    got = full_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), want, **FWD_TOL)


def test_flash_attention_at_head_dim_256_matches_jax_vjp(monkeypatch):
    """`flash_attention` under autograd at the video memory attention's head
    dim, against `jax.vjp` of the JAX `flash_attention` as its tests run
    it: on the CPU its XLA form (`xla_only`), and with the streaming
    kernels it dispatches past 1024 keys (`_stream_fwd_impl` and its VJP's
    `_stream_bwd_impl`) in interpret mode."""
    b, sq, sk, nh, d = 1, 64, 1280, 1, 256
    q, k, v, g = _inputs(b, sq, sk, nh, d, 256)
    leaves = [_t(t).requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*leaves)
    got = torch.autograd.grad(o, leaves, _t(g))
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    for streaming in (False, True):
        if streaming:
            interp = lambda fn: lambda *a, **kw: fn(*a, **kw, interpret=True)  # noqa: E731
            monkeypatch.setattr(fa.dispatch, "xla_only", lambda: False)
            monkeypatch.setattr(fa, "_stream_fwd_impl",
                                interp(fa._stream_fwd_impl))
            monkeypatch.setattr(fa, "_stream_bwd_impl",
                                interp(fa._stream_bwd_impl))
        want_o, vjp = jax.vjp(fa.flash_attention, *jargs)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(want_o),
                                   **FWD_TOL)
        for a, w in zip(got, vjp(jnp.asarray(g))):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), **BWD_TOL)


@pytest.mark.parametrize("d", (12, 13, 144, 264))
def test_wrapper_checks_take_any_head_dim(d):
    """`_check_args` / `_check_view` (K10, K11, K14), `_check_block` (K4-K7,
    K12, K13) and `_check_transition` (K8, K9) take head dims that are not
    a multiple of 8 or are above 96, and views at any strides (the kernels
    read element by element where 16-byte vectors do not fit)."""
    z = torch.zeros
    assert _check_args(z(1, 32, 2, d), z(1, 48, 2, d), z(1, 48, 2, d),
                       dk=z(1, 48, 2, d)) == (1, 32, 48, 2, d)
    qkv = z(1, 32, 3 * 2 * d + 4)[:, :, :3 * 2 * d].reshape(1, 32, 3, 2, d)
    assert qkv[:, :, 0].stride(1) % 8 or d % 8
    assert _check_args(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) == (
        1, 32, 32, 2, d)
    _check_view(z(2, 5, 3, d)[:, 1:], "q")
    nh = 8 if d % 8 else 1
    c = nh * d
    ln = (z(c), z(c))
    assert _check_block(z(2, 16, c), c, z(3 * c, c), z(3 * c), *ln, z(c, c),
                        z(c), nh) == 0
    cin = 24
    assert _check_transition(
        z(1, 8, 8, cin), 4, z(3 * c, cin), z(3 * c), z(cin), z(cin), z(c, c),
        z(c), z(c, cin), z(c), nh) == (0, c)


@pytest.mark.parametrize("case", ["block wider than the LN pass",
                                  "block width not a multiple of 8",
                                  "transition cin not a multiple of 8",
                                  "transition wider than the LN pass",
                                  "heads do not divide c"])
def test_wrapper_checks_refuse_the_widths_still_to_port(monkeypatch, case):
    """The four widths the LN pass and the GEMM once refused now pass the
    checks and reach their entry point with the ragged sizes (the LN and
    GEMM passes take any width: csrc/gemm_any.cu); what stays refused is a
    head count that does not divide c. No launch: the libraries are
    recorders."""
    z = torch.zeros
    if case == "heads do not divide c":
        with pytest.raises(ValueError, match="heads"):
            _check_block(z(1, 4, 24), 24, z(72, 24), z(72), z(24), z(24),
                         z(24, 24), z(24), 5)
        return
    seen, calls = [], []
    monkeypatch.setattr(build, "library",
                        lambda name: _Recorder(name, seen, calls))
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    if case.startswith("block"):
        c, nh = {"block wider than the LN pass": (2056, 8),
                 "block width not a multiple of 8": (26, 2)}[case]
        ln = (z(c), z(c))
        assert _check_block(z(1, 4, c), c, z(3 * c, c), z(3 * c), *ln,
                            z(c, c), z(c), nh) == 0
        _window_block_kernel(z(1, 4, c), z(3 * c, c), z(3 * c), *ln, z(c, c),
                             z(c), nh, 0, True)
        assert seen == [("fused_attention_block", "k6_window_block")]
        assert calls[0][1][-7:-3] == (1, 4, c, nh)
        return
    cin = 20 if "multiple" in case else 2056
    c = 48
    args = (z(1, 8, 8, cin), z(3 * c, cin), z(3 * c), z(cin), z(cin), z(c, c),
            z(c), z(c, cin), z(c))
    assert _check_transition(args[0], 4, *args[1:], 4) == (0, c)
    _transition_kernel(*args, 4, 4)
    assert seen == [("fused_transition", "k8_transition")]
    assert calls[0][1][-8:-1] == (1, 8, 8, cin, c, 4, 4)


def test_nothing_raises_for_a_kernel_not_ported():
    """Every kernel the JAX attention path runs has a port: `not_ported` is
    gone from the dispatch, and K11 at head dim 256 on CPU tensors is its
    plain version."""
    assert not hasattr(dispatch, "not_ported")
    q, k, v, g = (_t(a) for a in _inputs(1, 40, 40, 1, 256, 7))
    o, lse = flash_attention(q, k, v, return_lse=True)
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape


class _Recorder:
    """A kernel library that launches nothing and names its entry points
    (and, given `calls`, records each call's arguments)."""

    def __init__(self, name, seen, calls=None):
        self.name, self.seen, self.calls = name, seen, calls

    def __getattr__(self, entry):
        def launch(*args):
            self.seen.append((self.name, entry))
            if self.calls is not None:
                self.calls.append((entry, args))
            return 0
        return launch


@pytest.mark.parametrize("kernel", ["K10", "K14"])
@pytest.mark.parametrize("view", ["aligned", "odd token stride", "offset base"])
def test_head_dim_256_takes_the_d256_forwards_only_at_aligned_views(
        monkeypatch, kernel, view):
    """The d256 forwards load 16-byte vectors, so K10 and K14 at head dim
    256 take them only where every base is 16-byte aligned and every stride
    a multiple of 8 elements; any other view goes to the element-loading
    entry (`k10_flash_attention` / `k14_full_attention`, which send it on
    to csrc/attention_any.cu). No launch: the libraries are recorders."""
    seen = []
    monkeypatch.setattr(build, "library", lambda name: _Recorder(name, seen))
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    if view == "aligned":
        buf = torch.zeros(2, 40, 3, 1, 256)
    elif view == "odd token stride":
        buf = torch.zeros(2, 40, 3 * 256 + 4)[..., :3 * 256].reshape(2, 40, 3, 1, 256)
    else:
        buf = torch.zeros(2 * 40 * 3 * 256 + 1)[1:].reshape(2, 40, 3, 1, 256)
    q, k, v = buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]
    fn = _flash_attention_kernel if kernel == "K10" else _full_attention_kernel
    fn(q, k, v, 1.0 / 16)
    wide = ("flash_attention_d256", "k10_flash_attention_d256") if kernel == "K10" \
        else ("full_attention_d256", "k14_full_attention_d256")
    any_d = ("flash_attention", "k10_flash_attention") if kernel == "K10" \
        else ("full_attention", "k14_full_attention")
    assert seen == [wide if view == "aligned" else any_d]
