"""Parameter sharding policy: tensor parallelism over the model axis, the
JAX package's (sam2unet_tpu/parallel/sharding.py) decision for decision.

Large matmul weights shard on their output feature axis (a Megatron
column split); everything else replicates. The rule is decided on the
JAX layout of each leaf (`interop/from_jax.py::jax_leaf`): at least 2
dimensions, at least `min_size` elements, and the last JAX axis divisible
by the model axis's size. It is applied to the torch axis that the last
JAX axis comes from: dim 0 of a Linear weight (out, in) and of a Conv2d
weight (out, in, kh, kw), dim 1 of `pos_embed` (1, C, H, W). BatchNorm
statistics (1-D) replicate. The same decisions hold for AdamW's moments,
which have their parameters' shapes, and for the frozen trunk, as the JAX
`TrainState`'s `frozen` subtree is placed by the same policy.

Where JAX places the leaves and XLA inserts the collectives, the port's
train step (`train/engine.py::ShardedState`) gathers the full leaves over
the model group before its forward and keeps only this rank's column
shard between steps.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sam2unet_torch.interop.from_jax import jax_leaf
from sam2unet_torch.parallel.mesh import Mesh

# leaves smaller than this stay replicated (gather overhead dominates)
_MIN_SHARD_SIZE = 65536


def leaf_spec(name: str, t: torch.Tensor, mesh: Mesh,
              min_size: int = _MIN_SHARD_SIZE) -> int | None:
    """The torch dim that state-dict entry `name` (tensor `t`) is split
    along over the model axis, or None where it is replicated."""
    tp = mesh.model_parallel
    place = jax_leaf(name, t.dim())
    if tp == 1 or place is None:
        return None
    _, _, axes = place
    shape = [t.shape[a] for a in axes]
    if (len(shape) >= 2 and shape[-1] % tp == 0
            and math.prod(shape) >= min_size):
        return axes[-1]
    return None


def tree_shardings(module: nn.Module, mesh: Mesh,
                   min_size: int = _MIN_SHARD_SIZE) -> dict[str, int]:
    """{parameter name: split dim} of every parameter the policy splits."""
    out = {}
    for name, p in module.named_parameters():
        dim = leaf_spec(name, p, mesh, min_size)
        if dim is not None:
            out[name] = dim
    return out


def shard(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's column shard of `t` along `dim` (a new tensor)."""
    size = t.shape[dim] // mesh.model_parallel
    return t.narrow(dim, mesh.model_index * size, size).clone()


def shard_tree(module: nn.Module, mesh: Mesh,
               min_size: int = _MIN_SHARD_SIZE) -> dict[str, int]:
    """Replace each parameter the policy splits by this rank's shard, in
    place. Returns `tree_shardings`."""
    dims = tree_shardings(module, mesh, min_size)
    params = dict(module.named_parameters())
    with torch.no_grad():
        for name, dim in dims.items():
            params[name].data = shard(params[name].data, dim, mesh)
    return dims
