"""Persistent valid-window-group token layout for remainder grids (the
port's copy of sam2unet_tpu/ops/grouped.py).

On a grid the window does not divide, a block's attention runs over the
pad-free valid window groups (`window_partition_valid`: full windows, the
right and bottom edge windows, the corner). Every operation between that
partition and its merge is per token (LayerNorm, the MLP tail, the
adapter), per window (the window attention), or equivariant under a
permutation of the whole token set (global attention: the position
embedding was added once at the trunk's entry). So across a run of
dim-preserving blocks the Hiera loop partitions once at the run's start and
merges once at its end, and each block consumes and produces
`GroupedTokens`, as the JAX package's trunk does by default.

The numerics are those of the per-block valid groups: the same kernel calls
per group with the same pad-key counts; a global block sees the same tokens
in another order.
"""

from __future__ import annotations

import torch

from sam2unet_torch.ops.windowing import (
    window_merge_valid,
    window_partition_valid,
)


class GroupedTokens:
    """A (B, H, W, C) activation held as valid-window-group token rows.

    groups: (B * nW_g, S_g, C) tensors, batch-major window rows with the
    tokens row-major inside each window (what the window kernels take);
    n_pads: each group's synthetic pad-key count; geoms: each group's
    (gh, gw) window shape, for the merge."""

    def __init__(self, groups, n_pads, geoms, b: int, h: int, w: int,
                 window: int):
        self.groups = tuple(groups)
        self.n_pads = tuple(n_pads)
        self.geoms = tuple(geoms)
        self.b, self.h, self.w, self.window = b, h, w, window

    @classmethod
    def from_dense(cls, x: torch.Tensor, window: int) -> "GroupedTokens":
        b, h, w, c = x.shape
        gs, pads, geoms = [], [], []
        for g, n_pad in window_partition_valid(x, window):
            nw_, gh, gw, _ = g.shape
            gs.append(g.reshape(nw_, gh * gw, c))
            pads.append(n_pad)
            geoms.append((gh, gw))
        return cls(gs, pads, geoms, b, h, w, window)

    def to_dense(self) -> torch.Tensor:
        outs = [g.reshape(g.shape[0], gh, gw, g.shape[-1])
                for g, (gh, gw) in zip(self.groups, self.geoms)]
        return window_merge_valid(outs, self.b, self.h, self.w, self.window)

    def with_groups(self, new_groups) -> "GroupedTokens":
        return GroupedTokens(new_groups, self.n_pads, self.geoms, self.b,
                             self.h, self.w, self.window)

    def concat_tokens(self) -> torch.Tensor:
        """(B, H*W, C) in group- and window-major token order."""
        parts = [g.reshape(self.b, -1, g.shape[-1]) for g in self.groups]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def split_tokens(self, x: torch.Tensor) -> "GroupedTokens":
        """Inverse of `concat_tokens` for a (B, S, C) in the same order;
        each group contiguous, as the kernels take it."""
        outs, i = [], 0
        for g in self.groups:
            n = (g.shape[0] // self.b) * g.shape[1]
            outs.append(x[:, i:i + n].reshape(g.shape[0], g.shape[1], -1)
                        .contiguous())
            i += n
        return self.with_groups(outs)

    @property
    def dtype(self) -> torch.dtype:
        return self.groups[0].dtype

    @property
    def shape(self) -> tuple[int, int, int, int]:
        return (self.b, self.h, self.w, self.groups[0].shape[-1])
