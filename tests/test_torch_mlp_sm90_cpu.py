"""K1's and K2's route to the Hopper kernels (csrc/mlp_sm90.cu) and their
arithmetic at its edge shapes, on the CPU.

`_mlp_library` picks, on the host, whether a K1 or K2 call runs
csrc/mlp_sm90.cu: bf16 whose rows (C, hidden, Cout) are multiples of 8
elements (16 bytes) on the contiguous, 16-byte aligned tensors every call
must pass, what a TMA tensor map addresses, at any number of rows (GELU on
K1's output only where its adapter kernel takes the call); fp32 stays on
the CUDA-core GEMM and other widths on csrc/gemm_any.cu. The
kernels themselves run only on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py); here
the plain K1 (the LN tail, the adapter) and the plain K2 (LN with and
without the residual, the residual without LN, neither), which the kernels
are held to there, are held against the JAX package's `_xla_mlp` and
`jax.vjp` of it (the Pallas kernels differentiate and apply tanh-GELU, the
port exact erf, as tests/test_torch_widths_cpu.py explains) at the kernels'
edge shapes: 200 rows (no multiple of the 128-row GEMM tile or the 64-row
adapter tile), C 96 (one and a half 64-column k-steps), C 144 (the 144-wide
column tile), hidden 32 (the adapter's streaming kernel) and C 1152 at a few
rows (W2 streamed in the adapter). Inputs from a numpy seed; tolerance
2e-5 (fp32, sums in another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import re

import sam2unet_tpu.ops.pallas.fused_mlp as fm
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.fused_mlp import (
    SM90,
    SM90_ADAPTER_MAX_C,
    _mlp_library,
    fused_mlp,
    mlp_bwd_dx,
)
from sam2unet_torch.utils import profile_model

TOL = dict(rtol=2e-5, atol=2e-5)

# (rows, C, hidden): the edge shapes of csrc/mlp_sm90.cu's tiles
EDGES = [(200, 96, 384), (200, 144, 576), (200, 96, 32), (200, 144, 32),
         (5, 1152, 4608), (5, 1152, 32)]


def _z(*shape, dtype=torch.bfloat16):
    return torch.zeros(*shape, dtype=dtype)


@pytest.mark.parametrize("c,hd,cout,sm90", [
    (96, 384, 96, True), (144, 576, 144, True), (1152, 32, 1152, True),
    (2056, 64, 2056, True), (100, 400, 100, False), (96, 36, 96, False),
    (96, 384, 20, False), (12, 8, 12, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_route_by_dtype_and_width(dtype, c, hd, cout, sm90):
    """bf16 with C, hidden and Cout multiples of 8 runs csrc/mlp_sm90.cu;
    fp32 at any width, and bf16 at a width that is not, keep the kernels'
    own libraries."""
    want = SM90 if sm90 and dtype == torch.bfloat16 else None
    assert _mlp_library(dtype, c, hd, cout) == want


@pytest.mark.parametrize("c,hd,cout,ln,sm90", [
    (384, 32, 384, False, True), (1152, 32, 1152, False, True),
    (1160, 32, 1160, False, False), (2056, 64, 2056, False, False),
    (384, 1536, 384, False, False), (384, 32, 384, True, False),
    (384, 32, 192, False, False)])
def test_route_takes_gelu_out_only_where_the_adapter_kernel_does(c, hd, cout,
                                                                 ln, sm90):
    """GELU on K1's output runs on csrc/mlp_sm90.cu only in its adapter
    kernel (no LN, hidden 32, Cout = C up to the widest C it holds); every
    other gelu_out call keeps csrc/fused_mlp.cu, whatever its widths."""
    want = SM90 if sm90 else None
    assert _mlp_library(torch.bfloat16, c, hd, cout, gelu_out=True, ln=ln) == want
    assert _mlp_library(torch.bfloat16, c, hd, cout, ln=ln) == SM90


def test_adapter_max_c_is_the_kernels_shared_memory_plan():
    """`SM90_ADAPTER_MAX_C` is the widest C (in 64-column atoms) at which
    `adapter_plan` in csrc/mlp_sm90.cu fits one x slot beside W1, two W2
    chunks and the barriers under the block's shared memory."""
    src = (build.CSRC / f"{SM90}.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src)[1]
        return eval(re.sub(r"//.*", "", expr), {},
                    {k: const(k) for k in re.findall(r"k[A-Z]\w+", expr)})

    limit, atom, w1, w2 = (const(k) for k in ("kSmemLimit", "kAtom", "kW1Atom",
                                              "kW2Chunk"))
    room = limit - 1024 - const("kAdapterBars")

    def fits(atoms):
        return room - atoms * w1 - 2 * w2 >= atoms * atom

    atoms = SM90_ADAPTER_MAX_C // 64
    assert SM90_ADAPTER_MAX_C % 64 == 0 and fits(atoms) and not fits(atoms + 1)


@pytest.mark.parametrize("rows", [1, 64, 200, 57600])
def test_route_takes_any_number_of_rows(rows):
    """The route reads only the widths: every number of rows goes (the
    kernels store no row past M, tests/test_torch_kernels_cuda.py)."""
    x = torch.empty(rows, 384, dtype=torch.bfloat16)
    assert _mlp_library(x.dtype, x.shape[-1], 1536, 384) == SM90


@pytest.mark.parametrize("view", ["row_stride", "base"])
def test_no_call_reaches_a_library_with_views_no_tensor_map_addresses(view):
    """A row stride of C + 4 elements, or a base 2 bytes past alignment,
    cannot be a tensor map: the wrappers refuse such a view before any
    library (`check_kernel_args`), so the route need only read the widths;
    the same shape contiguous and aligned passes."""
    flat = torch.zeros(8 + 50 * 100, dtype=torch.bfloat16)
    dispatch.check_kernel_args(flat[:50 * 96].view(50, 96))
    if view == "row_stride":
        x = flat[:50 * 100].view(50, 100)[:, :96]
    else:
        x = flat[1:1 + 50 * 96].view(50, 96)
    with pytest.raises(ValueError):
        dispatch.check_kernel_args(x)


def test_library_takes_the_old_entry_points_arguments():
    """csrc/mlp_sm90.cu is a library of its own, built beside the others;
    K1's entry point takes k1_fused_mlp's arguments, K2's those of
    k2_mlp_bwd_dx without its fp32 pre-activation buffer; both count under
    their wrappers in a profile."""
    assert SM90 in build.SOURCES and (build.CSRC / f"{SM90}.cu").is_file()
    sig, old = build.SIGNATURES[SM90], build.SIGNATURES
    assert set(sig) == {"k1_fused_mlp_sm90", "k2_mlp_bwd_dx_sm90"}
    assert sig["k1_fused_mlp_sm90"] == old["fused_mlp"]["k1_fused_mlp"]
    k2 = old["fused_mlp_bwd"]["k2_mlp_bwd_dx"]
    assert sig["k2_mlp_bwd_dx_sm90"] == k2[:9] + k2[10:]   # minus hpre
    assert profile_model.ENTRY_WRAPPER["k1_fused_mlp_sm90"] == "fused_mlp"
    assert profile_model.ENTRY_WRAPPER["k2_mlp_bwd_dx_sm90"] == "mlp_bwd_dx"


def _inputs(m, c, hd, seed):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return (mk(m, c), mk(c, hd, scale=c ** -0.5), mk(hd),
            mk(hd, c, scale=hd ** -0.5), mk(c), mk(c) + 1, mk(c), mk(m, c))


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


@pytest.mark.parametrize("m,c,hd", EDGES)
def test_plain_k1_matches_jax_at_the_edge_shapes(m, c, hd):
    """K1's plain version in its two main-path modes, the LN tail and the
    adapter (GELU on the output too, the residual), against `_xla_mlp`."""
    x, w1, b1, w2, b2, lns, lnb, _ = _inputs(m, c, hd, m + c + hd)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]
    pw = [_t(x), _t(w1, True), _t(b1), _t(w2, True), _t(b2)]
    want = fm._xla_mlp(*jargs, jnp.asarray(lns), jnp.asarray(lnb), residual=True)
    got = fused_mlp(*pw, _t(lns), _t(lnb), residual=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = fm._xla_mlp(*jargs, residual=True, gelu_out=True)
    got = fused_mlp(*pw, residual=True, gelu_out=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ln,residual", [(True, True), (True, False),
                                         (False, True), (False, False)])
@pytest.mark.parametrize("m,c,hd", [e for e in EDGES if e[2] != 32]
                         + [(200, 96, 32)])
def test_plain_k2_matches_jax_vjp_at_the_edge_shapes(m, c, hd, ln, residual):
    """K2's plain version (dx of the frozen MLP) in its four modes against
    `jax.vjp` of `_xla_mlp`."""
    x, w1, b1, w2, b2, lns, lnb, gy = _inputs(m, c, hd, 7 * m + c + hd)
    jl = (jnp.asarray(lns), jnp.asarray(lnb)) if ln else (None, None)
    _, vjp = jax.vjp(lambda xx: fm._xla_mlp(xx, w1, b1, w2, b2, *jl,
                                            residual=residual), jnp.asarray(x))
    want = vjp(jnp.asarray(gy))[0]
    pl = (_t(lns), _t(lnb)) if ln else (None, None)
    got = mlp_bwd_dx(_t(x), _t(gy), _t(w1, True), _t(b1), _t(w2, True),
                     _t(b2), *pl, residual=residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
