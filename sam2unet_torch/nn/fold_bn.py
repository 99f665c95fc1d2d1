"""Inference-time BatchNorm folding: the port's copy of
sam2unet_tpu/nn/fold_bn.py on this package's state dict and modules.

Folds every BatchNorm's affine and running statistics into the preceding
convolution's weight, leaving the BN an exact identity plus bias:

    W'    = W * scale / sqrt(var + eps)          (per out-channel)
    bias' = bn_bias - mean * scale / sqrt(var + eps)
    then   scale := 1, mean := 0, var := 1 - eps, bn_bias := bias'

so BN computes (x - 0) / sqrt((1 - eps) + eps) * 1 + bias' = x + bias',
without changing the module structure (the same keys load strictly).
Conv/BN adjacency is structural, the JAX package's rule on this package's
names: a BN named `bn` folds into its sibling `conv` (`ConvBN`, the
reference's BasicConv2d), a BN at Sequential index i into index i - 1
(`DoubleConv`'s `double_conv`).

Apply to eval weights only: training would go on updating the running
statistics against folded weights.
"""

from __future__ import annotations

import torch
from torch import nn

from sam2unet_torch.nn.layers import BN_EPS


def _conv_key_for(bn_prefix: str) -> str | None:
    parent, _, name = bn_prefix.rpartition(".")
    if name == "bn":
        return f"{parent}.conv"
    if name.isdigit() and int(name) > 0:
        return f"{parent}.{int(name) - 1}"
    return None


def fold_batchnorm(state: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A new state dict with every conv-adjacent BN folded (the input is
    left as it is). Computed in fp32, stored in each tensor's own dtype."""
    out = dict(state)
    for key in state:
        if not key.endswith(".running_mean"):
            continue
        bn = key[: -len(".running_mean")]
        conv = _conv_key_for(bn)
        if conv is None or state.get(f"{conv}.weight") is None \
                or state[f"{conv}.weight"].ndim != 4:
            continue
        f32 = {n: state[f"{bn}.{n}"].float()
               for n in ("weight", "bias", "running_mean", "running_var")}
        inv = f32["weight"] / torch.sqrt(f32["running_var"] + BN_EPS)
        w = state[f"{conv}.weight"]
        out[f"{conv}.weight"] = (w.float() * inv[:, None, None, None]).to(w.dtype)
        bias = f32["bias"] - f32["running_mean"] * inv
        conv_bias = state.get(f"{conv}.bias")
        if conv_bias is not None:
            bias = bias + conv_bias.float() * inv
            out[f"{conv}.bias"] = torch.zeros_like(conv_bias)
        for name, value in (("weight", torch.ones_like(inv)), ("bias", bias),
                            ("running_mean", torch.zeros_like(inv)),
                            ("running_var", torch.full_like(inv, 1.0 - BN_EPS))):
            ref = state[f"{bn}.{name}"]
            out[f"{bn}.{name}"] = value.to(ref.dtype)
    return out


def fold_model(model: nn.Module) -> nn.Module:
    """Fold `model`'s BatchNorms in place (strict load of the folded state
    dict) and return it."""
    with torch.no_grad():
        model.load_state_dict(fold_batchnorm(model.state_dict()), strict=True)
    return model
