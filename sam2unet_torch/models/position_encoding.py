"""Position encodings of SAM2's image path: the sine grid of the FPN neck
and the random-Fourier encoding of the prompt encoder
(sam2/modeling/position_encoding.py:16-149; the JAX package's
`models/position_encoding.py`). The axial 2-D RoPE of the memory attention
comes with the video predictor.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


class PositionEmbeddingSine(nn.Module):
    """(H, W, C) sine grid, normalised, temperature 10000
    (position_encoding.py:79-112), computed once per grid in numpy in float64
    and kept on the device in the working dtype (the JAX package bakes it
    into its program as a constant; copying it anew would move ~90 MB per
    1024-px image to the card); no parameters."""

    def __init__(self, num_pos_feats: int = 256, temperature: int = 10000,
                 normalize: bool = True, scale: float | None = None):
        super().__init__()
        if num_pos_feats % 2:
            raise ValueError("PositionEmbeddingSine needs an even width")
        self.num_pos_feats, self.temperature = num_pos_feats, temperature
        self.normalize = normalize
        self.scale = 2 * math.pi if scale is None else scale
        self._cache: dict[tuple, torch.Tensor] = {}

    def grid(self, h: int, w: int) -> np.ndarray:
        """The (h, w, num_pos_feats) encoding, float32."""
        half = self.num_pos_feats // 2
        y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
        x = np.arange(1, w + 1, dtype=np.float64)[None, :] * np.ones((h, 1))
        if self.normalize:
            eps = 1e-6
            y = y / (y[-1:, :] + eps) * self.scale
            x = x / (x[:, -1:] + eps) * self.scale
        dim_t = np.arange(half, dtype=np.float64)
        dim_t = self.temperature ** (2 * (dim_t // 2) / half)
        px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
        px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])],
                      axis=3).reshape(h, w, -1)
        py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])],
                      axis=3).reshape(h, w, -1)
        return np.concatenate([py, px], axis=2).astype(np.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> its (B, H, W, num_pos_feats) encoding, a view
        of the cached grid."""
        b, h, w = x.shape[:3]
        key = (h, w, x.device, x.dtype)
        if key not in self._cache:
            with torch.inference_mode(False):   # usable outside it too
                self._cache[key] = torch.from_numpy(self.grid(h, w)).to(
                    device=x.device, dtype=x.dtype)
        return self._cache[key][None].expand(b, h, w, self.num_pos_feats)


class PositionEmbeddingRandom(nn.Module):
    """Random-Fourier encoding of coordinates in [0, 1]
    (position_encoding.py:115-149): sin and cos of 2*pi*(2c - 1) G, in
    fp32. G (2, F) is the buffer `positional_encoding_gaussian_matrix`."""

    def __init__(self, num_pos_feats: int = 64):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def encode(self, coords01: torch.Tensor) -> torch.Tensor:
        """(..., 2) fp32 -> (..., 2F) fp32."""
        c = 2.0 * coords01.float() - 1.0
        c = 2.0 * math.pi * (c @ self.positional_encoding_gaussian_matrix.float())
        return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)

    def grid(self, h: int, w: int) -> torch.Tensor:
        """(H, W, 2F) encoding of the cell centres."""
        dev = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        xy = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)],
                         dim=-1)
        return self.encode(xy)
