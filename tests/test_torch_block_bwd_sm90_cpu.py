"""K3's and K7's route to the Hopper kernels (csrc/block_bwd_sm90.cu), their
shared-memory plans, and the plain versions they are held to, on the CPU.

`_adapter_bwd_library` picks, on the host, whether a K3 call runs
csrc/block_bwd_sm90.cu's streaming pass: bf16 at C a multiple of 8 elements
up to the widest C its shared memory holds, hidden 32, any number of rows.
`_window_bwd_library` picks it for K7's dx-only unmasked mode: bf16 with c
and the head dim multiples of 8 and the head dim up to 128 (K11's block
shapes), any window length. Everything else keeps csrc/fused_mlp_bwd.cu and
csrc/fused_attention_block_bwd.cu; K7's masked and weight-gradient modes
keep theirs. The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py); here the wrappers are
driven with the libraries replaced by recorders (which entry point, which
arguments), K3's plan is recomputed from the constants of the source, and
the plain K3 and K7 are held against `jax.vjp` of the JAX package's
`_xla_mlp` and `_xla_window_block` at the kernels' edge shapes: 200 rows
(no multiple of the 64-row tile) at C 96 (one and a half 64-column chunks),
768 and 1152 (partials in device memory); windows of 196 tokens (no
multiple of 64) at head dims 72 (instance 96, zero-filled past d) and 96.
Inputs from a numpy seed; fp32, tolerance 2e-5 (of the largest value for
K7: sums in another order).
"""

from __future__ import annotations

import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_tpu.ops.pallas.fused_attention_block as fab
import sam2unet_tpu.ops.pallas.fused_mlp as fm
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops import fused_attention_block as port_fab
from sam2unet_torch.ops import fused_mlp as port_mlp
from sam2unet_torch.ops.fused_attention_block import (
    SM90_K7_MAX_HEAD_DIM,
    _window_bwd_library,
    window_block_bwd,
)
from sam2unet_torch.ops.fused_mlp import (
    K3_SM90_PART_FLOATS,
    SM90_ADAPTER_BWD_MAX_C,
    SM90_BLOCK_BWD,
    _adapter_bwd_library,
    adapter_bwd,
)
from sam2unet_torch.utils import profile_model

TOL = dict(rtol=2e-5, atol=2e-5)
# the main paths' widths (hiera_s 96-768, hiera_l 144-1152)
MAIN_WIDTHS = [96, 144, 192, 288, 384, 576, 768, 1152]
SRC = build.CSRC / f"{SM90_BLOCK_BWD}.cu"


def _const(name: str, text: str) -> int:
    expr = re.search(rf"constexpr int {name} = ([^;]+);", text)[1]
    expr = re.sub(r"//.*", "", expr)
    return eval(expr, {}, {k: _const(k, text) for k in re.findall(r"k[A-Z]\w+", expr)})


def _k3_plan(c: int) -> tuple[int, int, bool]:
    """`k3_plan` of csrc/block_bwd_sm90.cu from its constants: (bytes,
    ring slots, partials in shared memory)."""
    text = SRC.read_text()
    k = {n: _const(n, text) for n in ("kSmemLimit", "kAtom", "kW1Atom", "kW2Chunk",
                                      "kMaxRing", "kMinRing", "kK3Fixed", "kK3Bars",
                                      "kPartFloats")}
    a = -(-c // 64)
    room = (k["kSmemLimit"] - 1024 - k["kK3Bars"] - k["kK3Fixed"]
            - a * (k["kW1Atom"] + k["kW2Chunk"]))
    part = a * k["kPartFloats"] * 4
    in_smem = room - part >= k["kMinRing"] * k["kAtom"]
    ring = min((room - (part if in_smem else 0)) // k["kAtom"], k["kMaxRing"])
    smem = 0 if ring < 2 else k["kSmemLimit"] - room + (part if in_smem else 0) + ring * k["kAtom"]
    return smem, ring, in_smem


# ------------------------------------------------------------------ routes


@pytest.mark.parametrize("c,hd,sm90", [
    *((c, 32, True) for c in MAIN_WIDTHS), (1408, 32, True), (1416, 32, False),
    (2056, 32, False), (100, 32, False), (572, 32, False), (96, 64, False),
    (384, 24, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adapter_bwd_route_by_dtype_width_and_hidden(dtype, c, hd, sm90):
    """bf16 at C % 8 == 0 up to the widest C of the plan, hidden 32, runs
    csrc/block_bwd_sm90.cu; fp32, other widths and hiddens keep
    csrc/fused_mlp_bwd.cu."""
    want = SM90_BLOCK_BWD if sm90 and dtype == torch.bfloat16 else None
    assert _adapter_bwd_library(dtype, c, hd) == want


@pytest.mark.parametrize("c,heads,sm90", [
    (384, 4, True), (768, 8, True), (576, 8, True), (1152, 16, True),
    (256, 4, True), (128, 1, True), (576, 4, False), (576, 2, False),
    (576, 48, False), (580, 4, False), (200, 5, True), (200, 8, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_bwd_route_by_dtype_width_and_head_dim(dtype, c, heads, sm90):
    """bf16 with c and the head dim multiples of 8 and the head dim up to
    128 (d 96 at hiera_s@960, 72 at hiera_l@352, 40 at c 200 over 5) runs
    csrc/block_bwd_sm90.cu; head dims past 128 (144, 288), below 8 or not a
    multiple of 8, ragged widths and fp32 keep their sources."""
    want = SM90_BLOCK_BWD if sm90 and dtype == torch.bfloat16 else None
    assert _window_bwd_library(dtype, c, heads) == want


class _Recorder:
    """Libraries whose entry points record (library, entry, arguments) and
    return 0; the card's stream and SM count stubbed, so the wrappers run
    their kernel route on CPU tensors."""

    def __init__(self, monkeypatch):
        self.calls = []

        def library(name):
            return types.SimpleNamespace(**{
                fn: (lambda *a, fn=fn: self.calls.append((name, fn, a)) or 0)
                for fn in build.SIGNATURES[name]})

        monkeypatch.setattr(build, "library", library)
        monkeypatch.setattr(dispatch, "use_kernel", lambda x: True)
        monkeypatch.setattr(dispatch, "stream_of", lambda x: 0)
        monkeypatch.setattr(port_mlp, "_sm_count", lambda device: 132)


def _window_args(nw, s, c, dtype):
    z = lambda *sh: torch.zeros(*sh, dtype=dtype)  # noqa: E731
    return (z(nw, s, c), z(nw, s, c), z(3 * c, c), z(3 * c), z(c) + 1, z(c),
            z(c, c), z(c))


@pytest.mark.parametrize("s", [49, 64, 196, 256, 484])
def test_window_bwd_takes_the_hopper_entry_at_every_window_length(monkeypatch, s):
    """K7's dx-only unmasked bf16 calls at the main paths' window lengths
    (49 and 196 at hiera_s@960, 64, 256 and the 484-token global blocks at
    hiera_l@352) launch k7_window_block_bwd_sm90 once, with the arguments
    its signature names and the geometry (nW, S, c, heads, residual); the
    launch is counted as before."""
    rec = _Recorder(monkeypatch)
    c, nh = (384, 4) if s in (49, 196) else (576, 8)
    dispatch.reset_launches()
    window_block_bwd(*_window_args(2, s, c, torch.bfloat16), num_heads=nh)
    (lib, fn, args), = rec.calls
    assert (lib, fn) == (SM90_BLOCK_BWD, "k7_window_block_bwd_sm90")
    assert len(args) == len(build.SIGNATURES[lib][fn])
    assert args[-6:-1] == (2, s, c, nh, 1)
    assert dict(dispatch.variants) == {("window_block_bwd", f"S={s}"): 1}


@pytest.mark.parametrize("mode", ["fp32", "masked", "wgrad", "head_dim_144"])
def test_window_bwd_other_modes_keep_their_sources(monkeypatch, mode):
    """fp32, the masked mode, the weight-gradient mode and a head dim past
    128 keep csrc/fused_attention_block_bwd.cu,
    csrc/fused_attention_block_masked.cu and
    csrc/fused_attention_block_wgrad.cu."""
    rec = _Recorder(monkeypatch)
    dtype = torch.float32 if mode == "fp32" else torch.bfloat16
    nh = 4 if mode == "head_dim_144" else 8
    args = _window_args(2, 16, 576, dtype)
    kw = {}
    if mode == "masked":
        kw = dict(attn_mask=torch.zeros(16, 16), pad_logmult=torch.zeros(1, 16))
    window_block_bwd(*args, num_heads=nh, weight_grads=mode == "wgrad", **kw)
    (lib, fn, _), = rec.calls
    want = {"fp32": "fused_attention_block_bwd",
            "head_dim_144": "fused_attention_block_bwd",
            "masked": "fused_attention_block_masked",
            "wgrad": "fused_attention_block_wgrad"}[mode]
    assert lib == want and not fn.endswith("_sm90")


@pytest.mark.parametrize("m,c", [(200, 96), (57600, 384), (1936, 1152), (64, 768)])
def test_adapter_bwd_takes_the_hopper_entry_with_its_partial_buffer(monkeypatch, m, c):
    """A bf16 K3 call launches k3_adapter_bwd_sm90 once with a partial
    buffer of one block per SM and per 64-row tile (at most), each
    `K3_SM90_PART_FLOATS` a 64-column chunk and db1's 32, and the grid it
    sized; fp32 keeps csrc/fused_mlp_bwd.cu."""
    rec = _Recorder(monkeypatch)
    x = torch.zeros(m, c, dtype=torch.bfloat16)
    w1, b1 = torch.zeros(32, c, dtype=torch.bfloat16), torch.zeros(32, dtype=torch.bfloat16)
    w2, b2 = torch.zeros(c, 32, dtype=torch.bfloat16), torch.zeros(c, dtype=torch.bfloat16)
    seen = {}
    empty = torch.empty

    def spy(*shape, **kw):
        t = empty(*shape, **kw)
        seen.setdefault(kw.get("dtype"), []).append(t)
        return t

    monkeypatch.setattr(torch, "empty", spy)
    dx, dw1, db1, dw2, db2 = adapter_bwd(x, x, w1, b1, w2, b2)
    monkeypatch.setattr(torch, "empty", empty)
    (lib, fn, args), = rec.calls
    assert (lib, fn) == (SM90_BLOCK_BWD, "k3_adapter_bwd_sm90")
    assert len(args) == len(build.SIGNATURES[lib][fn])
    blocks = min(-(-m // 64), 132)
    assert args[-6:-1] == (m, c, 32, 1, blocks)
    part = [t for t in seen[torch.float32] if t.data_ptr() == args[7]]
    assert part and part[0].numel() == blocks * (-(-c // 64) * K3_SM90_PART_FLOATS + 32)
    assert dx.shape == x.shape and dw1.shape == (32, c) and dw2.shape == (c, 32)
    assert all(t.dtype == torch.float32 for t in (dw1, db1, dw2, db2))
    rec.calls.clear()
    adapter_bwd(x.float(), x.float(), w1.float(), b1.float(), w2.float(), b2.float())
    assert [(lib, fn) for lib, fn, _ in rec.calls] == [("fused_mlp_bwd", "k3_adapter_bwd")]


def test_the_library_is_registered_and_profiled():
    """csrc/block_bwd_sm90.cu is a library of its own, built beside the
    others after the shared ones; its entry points (K3's, K7's, and K5's and
    K9's, tests/test_torch_strips_bwd_sm90_cpu.py) are counted under the
    wrappers of their CUDA-core counterparts in a profile."""
    assert SM90_BLOCK_BWD in build.SOURCES and SRC.is_file()
    assert build.SOURCES.index(SM90_BLOCK_BWD) > max(
        build.SOURCES.index(s) for s in build.SHARED_SOURCES)
    assert set(build.SIGNATURES[SM90_BLOCK_BWD]) == {
        "k3_adapter_bwd_sm90", "k7_window_block_bwd_sm90",
        "k5_window_block_strips_bwd_sm90", "k9_transition_bwd_sm90"}
    k7 = build.SIGNATURES["fused_attention_block_bwd"]["k7_window_block_bwd"]
    # K7's arguments without O
    assert build.SIGNATURES[SM90_BLOCK_BWD]["k7_window_block_bwd_sm90"] == k7[:10] + k7[11:]
    assert profile_model.ENTRY_WRAPPER["k3_adapter_bwd_sm90"] == "adapter_bwd"
    assert profile_model.ENTRY_WRAPPER["k7_window_block_bwd_sm90"] == "window_block_bwd"


# ------------------------------------------------------------------- plans


PLANS = {96: (16, True), 144: (14, True), 192: (14, True), 288: (8, True),
         384: (5, True), 576: (15, False), 768: (12, False), 1152: (6, False)}


@pytest.mark.parametrize("c", MAIN_WIDTHS)
def test_k3_plan_at_the_main_path_widths(c):
    """The plan the source note states for each main-path width: the ring's
    slots, whether the partials stay in shared memory (up to C 384, beside
    at least `kMinRing` slots) or go to device memory, all under the
    block's limit."""
    smem, ring, in_smem = _k3_plan(c)
    assert (ring, in_smem) == PLANS[c]
    assert 0 < smem <= _const("kSmemLimit", SRC.read_text())


def test_k3_widest_c_and_partials_are_the_sources():
    """`SM90_ADAPTER_BWD_MAX_C` is the widest C (in 64-column atoms) at
    which two ring slots fit beside W1, W2, the staging tiles and the
    barriers; `K3_SM90_PART_FLOATS` is the source's `kPartFloats` (dW2 |
    db2 at 20 and dW1^T at 16 floats a thread of 128)."""
    assert SM90_ADAPTER_BWD_MAX_C % 64 == 0
    assert _k3_plan(SM90_ADAPTER_BWD_MAX_C)[0] > 0
    assert _k3_plan(SM90_ADAPTER_BWD_MAX_C + 64)[0] == 0
    assert K3_SM90_PART_FLOATS == _const("kPartFloats", SRC.read_text()) == 36 * 128


def test_k7_head_dims_are_k11s_unsplit_block_shapes():
    """K7's query-side and dk/dv blocks take K11's block shape without the
    column split, which starts past 128 (csrc/flash_attention_bwd_sm90.cuh),
    so the route stops there."""
    header = (build.CSRC / "flash_attention_bwd_sm90.cuh").read_text()
    assert re.search(r"SPLIT = D > (\d+);", header)[1] == str(SM90_K7_MAX_HEAD_DIM)
    assert 'static_assert(!S::SPLIT, "head dims up to 128")' in SRC.read_text()


# ------------------------------------------------- plain versions vs JAX


def _mk(seed):
    rng = np.random.default_rng(seed)

    def mk(*shape, scale=0.3):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return mk


def _t(a, transpose=False):
    return torch.from_numpy(np.ascontiguousarray(a.T if transpose else a))


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("c", [96, 768, 1152])
def test_plain_k3_matches_jax_vjp(c, residual):
    """The plain K3 (dx and the four weight gradients) against `jax.vjp` of
    `_xla_mlp(gelu_out=True)` at 200 rows."""
    mk = _mk(c + residual)
    x, gy = mk(200, c), mk(200, c)
    w1, b1, w2, b2 = mk(c, 32, scale=c ** -0.5), mk(32), mk(32, c, scale=32 ** -0.5), mk(c)
    _, vjp = jax.vjp(lambda *a: fm._xla_mlp(*a, residual=residual, gelu_out=True),
                     jnp.asarray(x), w1, b1, w2, b2)
    want = vjp(jnp.asarray(gy))
    got = adapter_bwd(_t(x), _t(gy), _t(w1, True), _t(b1), _t(w2, True), _t(b2),
                      residual=residual)
    for g, w, transpose in zip(got, want, (False, True, False, True, False)):
        np.testing.assert_allclose((g.t() if transpose else g).numpy(), np.asarray(w),
                                   **TOL)


@pytest.mark.parametrize("c,heads", [(144, 2), (192, 2)])
def test_plain_k7_matches_jax_vjp(c, heads):
    """The plain K7 (dx-only, unmasked) against `jax.vjp` of
    `_xla_window_block` on three windows of 196 tokens, head dims 72 and
    96: dx to 2e-5 of its largest value."""
    nw, s = 3, 196
    mk = _mk(s + c)
    x, gy = mk(nw, s, c), mk(nw, s, c)
    w, b = mk(c, 3 * c, scale=c ** -0.5), mk(3 * c)
    lns, lnb, wp, bp = mk(c) + 1, mk(c), mk(c, c, scale=c ** -0.5), mk(c)
    _, vjp = jax.vjp(lambda xx: fab._xla_window_block(xx, w, b, lns, lnb, wp, bp,
                                                      heads, 0, True),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gy))[0])
    got = window_block_bwd(_t(x), _t(gy), _t(w, True), _t(b), _t(lns), _t(lnb),
                           _t(wp, True), _t(bp), num_heads=heads)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 2e-5 * float(np.abs(want).max()), err
    assert port_fab.window_block_bwd_route(s, c, 0, False) == "K7"
