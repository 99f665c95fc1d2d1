"""The PyTorch port's whole SAM2-UNet forward against the JAX package's, on
the CPU in fp32.

The narrow config keeps hiera_l's geometry at 352 px (grids 88/44/22/11,
windows 8/4/16/8, one global block), so the port takes every branch of the
hiera_l@352 path: strip blocks (K4) in stages 1-2, fused transitions (K8)
into stages 2-3, remainder valid groups with the synthetic pad key (K6) in
stages 3-4, a global block (K6), the plain q-pool transition into stage 4,
and the MLP tails and adapters (K1). The JAX side runs on the CPU, where
every fused op takes its `_xla_*` form. Weights come from the JAX variables
through `interop/from_jax.py` and load with strict=True.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.configs import SAM2UNetConfig as PortConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.models.sam2unet import SAM2UNet as PortSAM2UNet
from sam2unet_tpu.configs import HieraConfig, SAM2UNetConfig
from sam2unet_tpu.models.sam2unet import SAM2UNet

TRUNK = dict(embed_dim=16, num_heads=1, stages=(1, 2, 3, 2),
             global_att_blocks=(4,), window_spec=(8, 4, 16, 8),
             window_pos_embed_bkg_spatial_size=(14, 14))
SIZE, BATCH = 352, 2
# fp32 on both sides; the two frameworks sum in different orders through 8
# blocks, the neck and the decoder: measured max error 2.6e-6 of the
# output's max magnitude. Bound: 2e-5 of it.
REL_TOL = 2e-5


def _perturb(variables: dict, rng: np.random.Generator) -> dict:
    """Seeded noise on every zero- or one-initialised leaf (biases, LN/BN
    gains, pos-embeds, BN statistics) so none of them is a no-op."""
    def walk(tree, name=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
                continue
            v = np.asarray(v, np.float32)
            if k == "var":
                v = v + rng.uniform(0.2, 0.8, v.shape).astype(np.float32)
            elif k in ("bias", "mean", "pos_embed", "pos_embed_window"):
                v = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            elif k == "scale":
                v = v + 0.1 * rng.standard_normal(v.shape).astype(np.float32)
            out[k] = v
        return out
    return walk(variables)


@pytest.fixture(scope="module")
def pair():
    model = SAM2UNet(SAM2UNetConfig(trunk=HieraConfig(**TRUNK)))
    x0 = np.zeros((1, SIZE, SIZE, 3), np.float32)
    variables = jax.jit(model.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), x0, train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = _perturb(dict(variables), np.random.default_rng(0))
    x = np.random.default_rng(1).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(lambda v, a: model.apply(v, a, train=False))(variables, x)
    port = PortSAM2UNet(PortConfig(trunk=PortHieraConfig(**TRUNK))).eval()
    return variables, x, [np.asarray(w) for w in want], port


def test_state_dict_converts_strictly(pair):
    variables, _, _, port = pair
    state = jax_to_state_dict(variables, port.state_dict().keys())
    result = port.load_state_dict(state, strict=True)
    assert not result.missing_keys and not result.unexpected_keys


def test_full_forward_matches_jax(pair):
    variables, x, want, port = pair
    port.load_state_dict(jax_to_state_dict(variables, port.state_dict().keys()),
                         strict=True)
    with torch.inference_mode():
        got = port(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape == (BATCH, SIZE, SIZE, 1)
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= REL_TOL * scale, (err, scale)


def test_conversion_rejects_missing_and_extra_leaves(pair):
    variables, _, _, port = pair
    keys = list(port.state_dict().keys())
    with pytest.raises(KeyError, match="no JAX variable"):
        jax_to_state_dict(variables, keys + ["encoder.blocks.0.block.extra.weight"])
    with pytest.raises(KeyError, match="no port key"):
        jax_to_state_dict(variables, [k for k in keys if not k.startswith("side1.")])
