"""K10's and K14's route to the Hopper forward (csrc/flash_attention_fwd_sm90.cu)
and their arithmetic at its edge shapes, on the CPU.

`_fwd_library` picks, on the host, whether the Hopper forward runs a K10 or
K14 call: bf16 at d % 8 == 0 up to 256 on views a TMA tensor map can
address goes to the wgmma kernels (d padded to 64, 96, 128 or 256);
everything else stays on the kernel's own library (fp32 on
csrc/flash_attention.cu, csrc/full_attention.cu and their d256 files, other
head dims and views on csrc/attention_any.cu). The kernels themselves run
only on the card (tests/test_torch_kernels_cuda.py); here the plain K10 and
K14, which they are held to there, are held against the JAX package's
kernels at the instances' edge shapes: K10 against `_stream_fwd_impl` in
interpret mode (o and lse) at head dims 72 and 200 (padded to 96 and 256),
S_q != S_k and lengths no multiple of the 64-row tiles; K14 against the
body of `_kernel` at head dims 128 and 200 over 7 and 196 keys (one pass)
and 1000 (two passes). Inputs from a numpy seed; tolerance 2e-5, as the
K10 and K14 tests of tests/test_torch_kernels_cpu.py (fp32, sums in
another order).
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.flash_attention as fa
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.flash_attention import (
    _flash_attention_kernel,
    _full_attention_kernel,
    _fwd_library,
    flash_attention,
    full_attention,
    plain_flash_attention,
    plain_full_attention,
)

TOL = dict(rtol=2e-5, atol=2e-5)
SM90 = "flash_attention_fwd_sm90"


def _views(dtype, d, nh=2, s=40, head_stride=None, offset=0):
    """q, k, v as channel blocks of one (1, s, 3, nh, hs) buffer (hs the
    head stride, d by default), the first `offset` elements skipped."""
    hs = head_stride or d
    flat = torch.zeros(offset + s * 3 * nh * hs, dtype=dtype)
    buf = flat[offset:].view(1, s, 3, nh, hs)[..., :d]
    return buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]


@pytest.mark.parametrize("d,hopper", [(12, False), (16, True), (56, True),
                                      (96, True), (128, True), (200, True),
                                      (256, True), (264, False), (384, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fwd_library_by_dtype_and_head_dim(dtype, d, hopper):
    """bf16 at d % 8 == 0 up to 256 runs the Hopper forward; fp32 at any
    head dim, and bf16 at 12, 264 or 384, keep their kernels."""
    q, k, v = _views(dtype, d)
    want = SM90 if hopper and dtype == torch.bfloat16 else None
    assert _fwd_library(dtype, d, q, k, v) == want


@pytest.mark.parametrize("d", [16, 56, 96, 128, 256])
@pytest.mark.parametrize("view", ["head_stride", "base", "broadcast"])
def test_fwd_library_keeps_views_no_tensor_map_addresses(d, view):
    """A head stride of d + 4 elements, a base 2 bytes past alignment or a
    zero stride (an expanded tensor) cannot be a tensor map; the same
    shapes aligned can."""
    q, k, v = _views(torch.bfloat16, d)
    assert _fwd_library(torch.bfloat16, d, q, k, v) == SM90
    if view == "head_stride":
        q, k, v = _views(torch.bfloat16, d, head_stride=d + 4)
    elif view == "base":
        q, k, v = _views(torch.bfloat16, d, offset=1)
    else:
        k = k[:, :, :1].expand(k.shape)
    assert _fwd_library(torch.bfloat16, d, q, k, v) is None


class _Recorder:
    """A kernel library that launches nothing and records which entry
    point each call took."""

    def __init__(self, name, seen):
        self.name, self.seen = name, seen

    def __getattr__(self, entry):
        def launch(*args):
            self.seen.append((self.name, entry, args))
            return 0
        return launch


@pytest.mark.parametrize("kernel", ["K10", "K14"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 96), (torch.bfloat16, 256),
                                     (torch.bfloat16, 12), (torch.float32, 96),
                                     (torch.float32, 256)])
def test_entry_point_by_route(monkeypatch, kernel, dtype, d):
    """The wrappers call `k10_flash_attention_sm90` / `k14_full_attention_sm90`
    where `_fwd_library` names the Hopper library, with the arguments of
    the CUDA-core entry points; fp32 keeps its entry points (the d256 ones
    at 256), bf16 at head dim 12 the CUDA-core entry point, which sends it
    to csrc/attention_any.cu. One launch counted either way."""
    seen = []
    monkeypatch.setattr(build, "library", lambda name: _Recorder(name, seen))
    monkeypatch.setattr(dispatch, "stream_of", lambda t: 0)
    q, k, v = _views(dtype, d)
    fn = _flash_attention_kernel if kernel == "K10" else _full_attention_kernel
    dispatch.reset_launches()
    fn(q, k, v, 1.0 / math.sqrt(d))
    stem = "k10_flash_attention" if kernel == "K10" else "k14_full_attention"
    base = "flash_attention" if kernel == "K10" else "full_attention"
    if dtype == torch.bfloat16 and d != 12:
        want = (SM90, f"{stem}_sm90")
    elif d == 256:
        want = (f"{base}_d256", f"{stem}_d256")
    else:
        want = (base, stem)
    assert [s[:2] for s in seen] == [want]
    args = seen[0][2]
    assert args[0] == int(dtype == torch.bfloat16)
    # B, Sq, Sk, heads, d after the pointers, then q's and k's strides
    n_ptr = 5 if kernel == "K10" else 4
    assert args[1 + n_ptr:6 + n_ptr] == (1, 40, 40, 2, d)
    assert args[6 + n_ptr:12 + n_ptr] == (*q.stride()[:3], *k.stride()[:3])
    assert sum(dispatch.launches.values()) == 1


def test_the_hopper_forward_is_registered_with_the_old_arguments():
    sigs = build.SIGNATURES
    assert SM90 in build.SOURCES
    assert (build.CSRC / f"{SM90}.cu").is_file()
    assert (sigs[SM90]["k10_flash_attention_sm90"]
            == sigs["flash_attention"]["k10_flash_attention"])
    assert (sigs[SM90]["k14_full_attention_sm90"]
            == sigs["full_attention"]["k14_full_attention"])
    # it builds after the libraries whose symbols others take
    assert build.SOURCES.index(SM90) > max(build.SOURCES.index(s)
                                           for s in build.SHARED_SOURCES)


def _inputs(geom, seed):
    b, sq, sk, nh, d = geom
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32) * 0.5
                 for sh in ((b, sq, nh, d), (b, sk, nh, d), (b, sk, nh, d)))


# (batch, Sq, Sk, heads, d): the 96- and 256-wide instances' padded head
# dims, each length one 16-aligned Pallas block and no multiple of 64
K10_EDGE_GEOMS = [(1, 96, 160, 2, 72), (2, 160, 208, 1, 200)]


@pytest.mark.parametrize("geom", K10_EDGE_GEOMS)
def test_plain_k10_matches_pallas_interpret_at_the_edge_shapes(geom):
    """plain_flash_attention (and the wrapper, which takes it for CPU
    tensors), o and lse, against the Pallas forward in interpret mode."""
    b, sq, sk, nh, d = geom
    q, k, v = _inputs(geom, 71)
    scale = 1.0 / math.sqrt(d)
    want, want_lse = fa._stream_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), scale, interpret=True)
    args = tuple(torch.from_numpy(t) for t in (q, k, v))
    plain, lse = plain_flash_attention(*args, scale, return_lse=True)
    got, got_lse = flash_attention(*args, scale, return_lse=True)
    assert torch.equal(got, plain) and torch.equal(got_lse, lse)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse).reshape(b * nh, sq), **TOL)


class _Ref:
    """A stand-in for a Pallas ref: `[:]` reads the array, assignment
    keeps the value."""

    def __init__(self, value=None, dtype=jnp.float32):
        self.value, self.dtype = value, dtype

    def __getitem__(self, idx):
        return self.value[idx]

    def __setitem__(self, idx, value):
        self.value = value


# one pass (7 and 196 keys: one and four 64-key tiles) and two (1000 keys)
K14_EDGE_GEOMS = [(2, 7, 7, 2, 128), (2, 49, 196, 2, 128), (1, 7, 7, 3, 200),
                  (2, 49, 196, 1, 200), (1, 33, 1000, 1, 200)]


@pytest.mark.parametrize("geom", K14_EDGE_GEOMS)
def test_plain_k14_matches_the_tpu_kernel_at_the_edge_shapes(geom):
    """plain_full_attention (and the wrapper on CPU tensors) against the
    body of the JAX package's `_kernel` on arrays in its (batch*heads, S,
    d) layout: p = e / sum(e) normalised in fp32 before the product."""
    b, sq, sk, nh, d = geom
    q, k, v = _inputs(geom, 72)
    scale = 1.0 / math.sqrt(d)
    flat = [jnp.asarray(t.transpose(0, 2, 1, 3).reshape(b * nh, -1, d))
            for t in (q, k, v)]
    out = _Ref()
    fa._kernel(*map(_Ref, flat), out, scale=scale)
    want = np.asarray(out.value).reshape(b, nh, sq, d).transpose(0, 2, 1, 3)
    args = tuple(torch.from_numpy(t) for t in (q, k, v))
    plain = plain_full_attention(*args, scale)
    assert torch.equal(full_attention(*args, scale), plain)
    np.testing.assert_allclose(plain.numpy(), want, **TOL)
