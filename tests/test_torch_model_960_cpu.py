"""The port at the fork's default operating point (hiera_s @ 960) on the
CPU in fp32: which kernel wrapper each block calls, and the whole
SAM2-UNet forward against the JAX package's.

At 960 the stage grids are 240/120/60/30 with hiera_s's windows 8/4/14/7:
stages 1-2 take K4 and the K8 transitions, the 60x60 and 30x30 remainder
grids (n_w = 5) take K12, the global blocks (S = 3600) take the long form
of `fused_window_block` (LN -> QKV -> K10 -> proj) and the stage 3->4
transition (window 14 on 60x60) the plain path. The JAX side runs on the
CPU, where every fused op takes its `_xla_*` form; weights come from the
JAX variables through `interop/from_jax.py` and load with strict=True.
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
from sam2unet_torch.configs import HIERA_S as PORT_HIERA_S
from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_torch.ops.fused_attention_block import long_sequence
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


def _route_of_each_block(trunk: PortHieraConfig, x: torch.Tensor):
    """Run the port's trunk on x with spies on the kernel wrappers that
    hiera.py calls; returns the route each block took (in order) and the
    number of fused_mlp calls."""
    routes, mlp = [], collections.Counter()

    def spy(name, fn):
        def call(*a, **k):
            routes.append(name(a[0]) if callable(name) else name)
            return fn(*a, **k)
        return call

    def global_route(xw):
        _, s, c = xw.shape
        return "long" if long_sequence(s, c) else "K6"

    def mlp_spy(*a, **k):
        mlp[k.get("ln_w") is not None] += 1
        return fused_mlp(*a, **k)

    fused_mlp = port_hiera.fused_mlp
    model = port_hiera.Hiera(trunk).eval()
    with pytest.MonkeyPatch.context() as mp:
        for attr, name in (("fused_window_block_strips", "K4"),
                           ("fused_window_block_strips_rem", "K12"),
                           ("fused_transition_block", "K8"),
                           ("valid_group_blocks", "groups"),
                           ("fused_window_block", global_route)):
            mp.setattr(port_hiera, attr, spy(name, getattr(port_hiera, attr)))
        mp.setattr(port_hiera.MultiScaleBlock, "_unfused",
                   spy("plain", port_hiera.MultiScaleBlock._unfused))
        mp.setattr(port_hiera, "fused_mlp", mlp_spy)
        with torch.inference_mode():
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
