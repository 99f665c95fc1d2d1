"""The port at the fork's default operating point (hiera_s @ 960) on the
CPU in fp32: which kernel wrapper each block calls, in eval and (at
hiera_s@960 and hiera_l@352, full widths) in training, and the whole
SAM2-UNet forward against the JAX package's.

At 960 the stage grids are 240/120/60/30 with hiera_s's windows 8/4/14/7:
stages 1-2 take K4 and the K8 transitions, the 60x60 and 30x30 remainder
grids (n_w = 5) take K12 in eval and the persistent window groups in
training ("grouped": K6 and K1 per group), the global blocks (S = 3600)
take the long form of `fused_window_block` (LN -> QKV -> K10 -> proj) and
the stage 3->4 transition (window 14 on 60x60) the plain path. The launch
counts per block kind are held against the JAX package's own dispatch in
tests/test_torch_grouped_cpu.py. The JAX side runs on the CPU, where every
fused op takes its `_xla_*` form; weights come from the JAX variables
through `interop/from_jax.py` and load with strict=True.
"""

from __future__ import annotations

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_model_cpu import _perturb

import sam2unet_torch.models.hiera as port_hiera
from sam2unet_torch.configs import HIERA_L as PORT_HIERA_L
from sam2unet_torch.configs import HIERA_S as PORT_HIERA_S
from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.ops.fused_attention_block import (
    long_form_kernel,
    long_sequence,
    window_block_bwd_route,
)
from sam2unet_torch.ops.fused_mlp import f32_weights_overflow
from sam2unet_tpu.configs import HieraConfig, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet

SIZE = 960
# hiera_s's windows and pos-embed at a narrow width and cut depth: one
# block per kind of the 960 path (K4, K8, K4, K8, global, K12, plain
# transition, K12)
TRUNK = dict(embed_dim=16, num_heads=1, stages=(1, 2, 3, 2),
             global_att_blocks=(4,), window_spec=(8, 4, 14, 7),
             window_pos_embed_bkg_spatial_size=(7, 7))
# fp32 on both sides, sums in different orders through the trunk, neck and
# decoder: measured max error 2.1e-6 of the output's max magnitude. Bound:
# 2e-5 of it.
REL_TOL = 2e-5


def _route_of_each_block(trunk: PortHieraConfig, x: torch.Tensor,
                         train: bool = False, stub: bool = False,
                         use_adapters: bool = True, launched: bool = False):
    """Run the port's trunk on x with spies on the kernel wrappers that
    hiera.py calls; returns the route each block took (in order) and the
    number of fused_mlp calls (tails and adapters, per window group inside
    a grouped run; with `launched` only those that launch K1, past the fp32
    weight gate `f32_weights_overflow`). A block on the persistent window
    groups is "grouped", whatever its window. `train` runs the trunk in
    training mode; `stub` makes each spied wrapper return a tensor of its
    output's shape instead of computing it, so a full-width trunk routes in
    a moment; `use_adapters` False routes SAM2's own trunk. The model takes
    x's dtype (the remainder-strip gate reads its item size)."""
    routes, mlp, inside = [], collections.Counter(), []

    def shape_of(name, a):
        if name == "K8":
            b, h, w, _ = a[0].shape
            return a[0].new_zeros(b, h // 2, w // 2, a[5].shape[0])
        if name == "plain":
            blk, xx = a
            b, h, w, _ = xx.shape
            return xx.new_zeros(b, -(-h // 2), -(-w // 2), blk.dim_out)
        return a[1] if name == "groups" else a[0]

    def spy(name, fn):
        def call(*a, **k):
            if not inside:
                routes.append(name(a[0]) if callable(name) else name)
            return shape_of(name, a) if stub else fn(*a, **k)
        return call

    def grouped(blk, xg):
        routes.append("grouped")
        inside.append(blk)
        try:
            return grouped_fn(blk, xg)
        finally:
            inside.pop()

    def global_route(xw):
        _, s, c = xw.shape
        if not long_sequence(s, c):
            return "K6"
        return "long" if long_form_kernel(s) else "plain global"

    def mlp_spy(*a, **k):
        if not (launched and f32_weights_overflow(a[0], a[1], a[3])):
            mlp[k.get("ln_w") is not None] += 1
        return a[0] if stub else fused_mlp(*a, **k)

    fused_mlp = port_hiera.fused_mlp
    grouped_fn = port_hiera.MultiScaleBlock._grouped
    model = port_hiera.Hiera(trunk, use_adapters=use_adapters).train(train)
    model = model.to(x.dtype)
    with pytest.MonkeyPatch.context() as mp:
        for attr, name in (("fused_window_block_strips", "K4"),
                           ("fused_window_block_strips_rem", "K12"),
                           ("fused_transition_block", "K8"),
                           ("valid_group_blocks", "groups"),
                           ("fused_window_block", global_route)):
            mp.setattr(port_hiera, attr, spy(name, getattr(port_hiera, attr)))
        mp.setattr(port_hiera.MultiScaleBlock, "_unfused",
                   spy("plain", port_hiera.MultiScaleBlock._unfused))
        mp.setattr(port_hiera.MultiScaleBlock, "_grouped", grouped)
        mp.setattr(port_hiera, "fused_mlp", mlp_spy)
        with torch.no_grad():
            outs = model(x)
    return routes, mlp, outs


def test_hiera_s_960_routes_every_block_like_the_jax_package():
    """hiera_s's full depth (16 blocks) at 960, narrow widths: the launches
    per forward the card must show (K1 32, K4 2, K8 2, K12 8, K10 3, K6 0)
    and the block each lands on."""
    trunk = dataclasses.replace(PORT_HIERA_S, embed_dim=16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32))
    routes, mlp, outs = _route_of_each_block(trunk, x)
    assert routes == (["K4", "K8", "K4", "K8"] + ["K12"] * 3 + ["long"]
                      + ["K12"] * 2 + ["long"] + ["K12"] * 2 + ["long"]
                      + ["plain", "K12"])
    assert mlp == {True: 16, False: 16}
    assert [o.shape[1] for o in outs] == [240, 120, 60, 30]


def test_hiera_s_960_routes_every_block_in_training():
    """In training, as in the JAX package (hiera.py:250-259, :311-327,
    :509-537 there): no remainder strips (K12 is eval only), so stage 3's
    ten blocks after the transition (the three 3600-token global blocks
    among them, on the long form over the concatenated tokens) run as one
    grouped run on four window groups, and block 15 on 30x30 w7 as
    another: K6 forward per group, K7 / the pad-key recompute backward; the
    240x240 window-8 transition fails the copied `transition_bwd_supported`
    at full width and takes the plain path. Per step K1 49 tails and 49
    adapters (the per-block route launched 16 + 16)."""
    x = torch.zeros(1, SIZE, SIZE, 3)
    routes, mlp, outs = _route_of_each_block(PORT_HIERA_S, x, train=True,
                                             stub=True)
    assert routes == (["K4", "plain", "K4", "K8"] + ["grouped"] * 10
                      + ["plain", "grouped"])
    assert mlp == {True: 49, False: 49}
    assert [o.shape[1] for o in outs] == [240, 120, 60, 30]


@pytest.mark.parametrize("train", [False, True])
def test_hiera_l_352_routes_every_block(train):
    """hiera_l at full width and depth (48 blocks) at 352, in eval and in
    training (the same routes: n_w = 2 keeps K12 out, both divisible
    transitions pass the train gate): K4 7, K8 2, stage 3's 35 blocks (the
    3 global ones, K6 S = 484 over the concatenated tokens, among them) as
    one grouped run on 4 window groups (22x22 w16) and stage 4's last 3 on
    4 groups of 11x11 w8, so per forward K1 162 tails and 162 adapters,
    the JAX package's counts (the per-block route launched 48 + 48)."""
    x = torch.zeros(1, 352, 352, 3)
    routes, mlp, outs = _route_of_each_block(PORT_HIERA_L, x, train=train,
                                             stub=True)
    assert routes == (["K4"] * 2 + ["K8"] + ["K4"] * 5 + ["K8"]
                      + ["grouped"] * 35 + ["plain"] + ["grouped"] * 3)
    assert mlp == {True: 162, False: 162}
    assert [o.shape[1] for o in outs] == [88, 44, 22, 11]


def test_hiera_s_960_trains_on_the_ported_kernels():
    """The three 3600-token global blocks of hiera_s@960 take the long form
    forward and, in training, its backward over K11, frozen or not (the
    train CLI runs its defaults on the card)."""
    blocks = port_hiera._block_plan(PORT_HIERA_S)
    assert [i for i, bk in enumerate(blocks) if bk["window_size"] == 0] == [7, 10, 13]
    assert window_block_bwd_route(3600, 384, 0, False) == "K11"
    assert window_block_bwd_route(3600, 384, 0, True) == "K11"


def test_a_trainable_global_block_takes_k7_weight_gradients():
    """A trunk that is not frozen: hiera_s at 256 px has 256-token global
    blocks (7, 10 and 13) at width 384, which the JAX package and the port
    differentiate through K7's weight-gradient mode; frozen, the same
    blocks take the dx-only K7."""
    blocks = port_hiera._block_plan(PORT_HIERA_S)
    h = 256 // 4
    glob = []
    for i, bk in enumerate(blocks):
        if bk["window_size"] == 0 and bk["dim"] == bk["dim_out"]:
            glob.append(i)
            assert h * h == 256 and bk["dim"] == 384
            assert window_block_bwd_route(h * h, bk["dim"], 0,
                                          True) == "K7 weight-grad"
            assert window_block_bwd_route(h * h, bk["dim"], 0, False) == "K7"
        if bk["q_stride"] is not None:
            h //= bk["q_stride"][0]
    assert glob == [7, 10, 13]


def test_training_routes_need_the_frozen_trunk():
    """A trainable transition block leaves the fused transition in
    training (hiera.py:325 there: `self.frozen and ...`)."""
    x = torch.zeros(1, 352, 352, 3)
    trunk = dataclasses.replace(PORT_HIERA_L, stages=(1, 1, 1, 1),
                                global_att_blocks=())
    model_routes = []
    for frozen in (True, False):
        with pytest.MonkeyPatch.context() as mp:
            if not frozen:
                mp.setattr(port_hiera.MultiScaleBlock, "frozen",
                           lambda self: False)
            model_routes.append(_route_of_each_block(trunk, x, train=True,
                                                     stub=True)[0])
    assert model_routes[0][1] == "K8" and model_routes[1][1] == "plain"


@pytest.fixture(scope="module")
def pair():
    model = SAM2UNet(SAM2UNetConfig(trunk=HieraConfig(**TRUNK)))
    x0 = np.zeros((1, SIZE, SIZE, 3), np.float32)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), x0, train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = _perturb(dict(variables), np.random.default_rng(0))
    x = np.random.default_rng(1).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)
    port = PortSAM2UNet(PortConfig(trunk=PortHieraConfig(**TRUNK))).eval()
    port.load_state_dict(jax_to_state_dict(variables, port.state_dict().keys()),
                         strict=True)
    return x, [np.asarray(w) for w in want], port


def test_narrow_trunk_routes():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, SIZE, SIZE, 3)).astype(np.float32))
    routes, mlp, _ = _route_of_each_block(PortHieraConfig(**TRUNK), x)
    assert routes == ["K4", "K8", "K4", "K8", "long", "K12", "plain", "K12"]
    assert mlp == {True: 8, False: 8}


def test_full_forward_at_960_matches_jax(pair):
    x, want, port = pair
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape == (1, SIZE, SIZE, 1)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= REL_TOL * scale, (err, scale)
