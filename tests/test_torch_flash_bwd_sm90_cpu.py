"""K11's route to the Hopper kernels (csrc/flash_attention_bwd_sm90.cu) and
its arithmetic at their edge shapes, on the CPU.

`_bwd_library` picks, on the host, the library that runs K11's dq or dk/dv
pass: bf16 at d % 8 == 0 up to 256 on views a TMA tensor map can address
goes to the wgmma kernels (d padded to 64, 96, 128 or 256), everything else
stays where it ran before them (fp32 on csrc/flash_attention_bwd.cu, other
head dims and views on csrc/attention_any_bwd.cu). The kernels themselves
run only on the card (tests/test_torch_kernels_cuda.py); here the plain K11,
which they are held to there, is held against the JAX package's
`_stream_bwd_impl` in interpret mode at the instances' edge shapes: head
dims 72 and 200 (padded to 96 and 256), S_q != S_k, lengths that are no
multiple of the kernels' 64-row tiles. Inputs from a numpy seed; tolerance
K11_TOL of tests/test_torch_kernels_cpu.py (fp32, sums in another order).
"""

from __future__ import annotations

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.flash_attention as fa
from sam2unet_torch.ops import build
from sam2unet_torch.ops import flash_attention as port
from sam2unet_torch.ops.flash_attention import (
    _bwd_library,
    flash_attention_bwd,
    plain_flash_attention_bwd,
)

K11_TOL = dict(rtol=2e-4, atol=2e-4)
SM90, OLD = "flash_attention_bwd_sm90", "flash_attention_bwd"


def _views(dtype, d, nh=2, s=40, head_stride=None, offset=0):
    """q, k, v as channel blocks of one (1, s, 3, nh, hs) buffer (hs the
    head stride, d by default), the first `offset` elements skipped."""
    hs = head_stride or d
    flat = torch.zeros(offset + s * 3 * nh * hs, dtype=dtype)
    buf = flat[offset:].view(1, s, 3, nh, hs)[..., :d]
    return buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]


@pytest.mark.parametrize("d,want", [(12, OLD), (56, SM90), (96, SM90),
                                    (128, SM90), (130, OLD), (256, SM90),
                                    (264, OLD)])
def test_bwd_library_by_head_dim_in_bf16(d, want):
    q, k, v = _views(torch.bfloat16, d)
    assert _bwd_library(torch.bfloat16, d, q, k, v, q.clone()) == want


@pytest.mark.parametrize("d", [12, 56, 96, 128, 130, 256, 264])
def test_bwd_library_keeps_fp32_on_its_kernels(d):
    q, k, v = _views(torch.float32, d)
    assert _bwd_library(torch.float32, d, q, k, v, q.clone()) == OLD


@pytest.mark.parametrize("d", [56, 96, 128, 256])
@pytest.mark.parametrize("view", ["head_stride", "base", "output", "broadcast"])
def test_bwd_library_sends_unaligned_views_to_the_chunked_kernels(d, view):
    """A head stride of d + 4 elements, a base 2 bytes past alignment, an
    output view with either, or a zero stride (an expanded tensor) cannot be
    a tensor map; the same shapes aligned can."""
    q, k, v = _views(torch.bfloat16, d)
    out = torch.empty(q.shape, dtype=torch.bfloat16)
    assert _bwd_library(torch.bfloat16, d, q, k, v, q.clone(), out) == SM90
    if view == "head_stride":
        q, k, v = _views(torch.bfloat16, d, head_stride=d + 4)
    elif view == "base":
        q, k, v = _views(torch.bfloat16, d, offset=1)
    elif view == "output":
        out = _views(torch.bfloat16, d, offset=1)[0]
    else:
        k = k[:, :, :1].expand(k.shape)
    assert _bwd_library(torch.bfloat16, d, q, k, v, q.clone(), out) == OLD


@pytest.mark.parametrize("lib,suffix", [(SM90, "_sm90"), (OLD, "")])
def test_bwd_entry_names_the_library_entry_point(monkeypatch, lib, suffix):
    """Both libraries take the same arguments; the Hopper one's entry
    points carry `_sm90`, so a profile names the route that ran."""
    names = {f"k11_flash_attention_bwd_{p}{s}" for p in ("dq", "dkv")
             for s in ("", "_sm90")}
    libs = {name: types.SimpleNamespace(**{n: (name, n) for n in names})
            for name in (SM90, OLD)}
    monkeypatch.setattr(build, "library", lambda name: libs[name])
    for p in ("dq", "dkv"):
        got = port._bwd_entry(lib, f"k11_flash_attention_bwd_{p}")
        assert got == (lib, f"k11_flash_attention_bwd_{p}{suffix}")


def test_the_hopper_library_is_registered_with_the_old_arguments():
    sigs = build.SIGNATURES
    assert "flash_attention_bwd_sm90" in build.SOURCES
    assert (build.CSRC / "flash_attention_bwd_sm90.cu").is_file()
    assert (build.CSRC / "hopper.cuh").is_file()
    for p in ("dq", "dkv"):
        assert (sigs[SM90][f"k11_flash_attention_bwd_{p}_sm90"]
                == sigs[OLD][f"k11_flash_attention_bwd_{p}"])


# (batch, Sq, Sk, heads, d): the 96- and 256-wide instances' padded head
# dims, each length one 16-aligned Pallas block and no multiple of 64
EDGE_GEOMS = [(1, 96, 160, 2, 72), (2, 160, 96, 1, 200)]


def _inputs(geom, seed):
    b, sq, sk, nh, d = geom
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(sh).astype(np.float32) * 0.5
                 for sh in ((b, sq, nh, d), (b, sk, nh, d), (b, sk, nh, d),
                            (b, sq, nh, d)))


@pytest.mark.parametrize("geom", EDGE_GEOMS)
def test_plain_k11_matches_pallas_interpret_at_the_edge_shapes(geom):
    """plain_flash_attention_bwd (and the wrapper, which takes it for CPU
    tensors) fed the Pallas forward's o and lse, against the Pallas dq and
    dk/dv kernels in interpret mode."""
    b, sq, sk, nh, d = geom
    q, k, v, g = _inputs(geom, 61)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa._stream_fwd_impl(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), scale, interpret=True)
    want = fa._stream_bwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               o, lse, jnp.asarray(g), scale, interpret=True)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(np.array(o)),
            torch.from_numpy(np.array(lse).reshape(b * nh, sq)),
            torch.from_numpy(g))
    plain = plain_flash_attention_bwd(*args, scale)
    got = flash_attention_bwd(*args, scale)
    for a, p, w in zip(got, plain, want):
        assert torch.equal(a, p)
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **K11_TOL)
