"""Position encodings (sam2/modeling/position_encoding.py:16-216,
sam2_utils.py:60-70; the JAX package's `models/position_encoding.py`): the
sine grid of the FPN neck and the memory encoder, the random-Fourier
encoding of the prompt encoder, the 1-D sine encoding of the object
pointers' time offsets, and the memory attention's axial 2-D rotary
embedding. The complex RoPE of the reference is a rotation of adjacent
feature pairs by (cos, sin) in fp32, as in the JAX package; its tables are
computed in numpy (float64).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def sine_position_embedding(h: int, w: int, num_pos_feats: int = 256,
                            temperature: int = 10000, normalize: bool = True,
                            scale: float | None = None) -> np.ndarray:
    """(H, W, C) sine grid, float32 (position_encoding.py:79-112)."""
    if num_pos_feats % 2:
        raise ValueError("the sine encoding needs an even width")
    half = num_pos_feats // 2
    scale = 2 * math.pi if scale is None else scale
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.arange(1, w + 1, dtype=np.float64)[None, :] * np.ones((h, 1))
    if normalize:
        eps = 1e-6
        y = y / (y[-1:, :] + eps) * scale
        x = x / (x[:, -1:] + eps) * scale
    dim_t = np.arange(half, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / half)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = np.stack([np.sin(px[:, :, 0::2]), np.cos(px[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    py = np.stack([np.sin(py[:, :, 0::2]), np.cos(py[:, :, 1::2])],
                  axis=3).reshape(h, w, -1)
    return np.concatenate([py, px], axis=2).astype(np.float32)


def get_1d_sine_pe(pos_inds: torch.Tensor, dim: int,
                   temperature: float = 10000) -> torch.Tensor:
    """(..., dim) sine encoding of positions (sam2_utils.py:60-70), fp32."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos_inds.device)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    pos = pos_inds.float()[..., None] / dim_t
    return torch.cat([torch.sin(pos), torch.cos(pos)], dim=-1)


def axial_rope_cos_sin(dim: int, end_x: int, end_y: int,
                       theta: float = 10000.0) -> tuple[np.ndarray, np.ndarray]:
    """(S, dim // 2) cos and sin of the axial frequencies
    (position_encoding.py:167-183), float32."""
    quarter = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[:quarter].astype(np.float64)
                             / dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    ang = np.concatenate([np.outer(t % end_x, freqs),
                          np.outer(np.floor(t / end_x), freqs)], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate the adjacent feature pairs of x (B, S, heads, d) by the angles
    of (S, d // 2) cos / sin, in fp32; the result in x's dtype."""
    x2 = x.float().reshape(*x.shape[:-1], -1, 2)
    a, b = x2[..., 0], x2[..., 1]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([a * c - b * s, a * s + b * c],
                       dim=-1).reshape(x.shape).to(x.dtype)


def apply_rotary_enc(xq: torch.Tensor, xk: torch.Tensor, cos: torch.Tensor,
                     sin: torch.Tensor, repeat_freqs_k: bool = False):
    """Rotate q and k, (B, S, heads, d), by (Sq, d // 2) angles
    (position_encoding.py:194-216). With `repeat_freqs_k` a k of r query
    grids repeats the angles r times; a k shorter than one grid takes the
    first rows (the JAX package's guard, where the reference crashes)."""
    xq_out = apply_rotary(xq, cos, sin)
    if xk.shape[1] == 0:
        return xq_out, xk
    if repeat_freqs_k and xk.shape[1] != xq.shape[1]:
        r = xk.shape[1] // xq.shape[1]
        if r >= 1:
            cos, sin = cos.repeat(r, 1), sin.repeat(r, 1)
        else:
            cos, sin = cos[:xk.shape[1]], sin[:xk.shape[1]]
    return xq_out, apply_rotary(xk, cos, sin)


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
        return sine_position_embedding(h, w, self.num_pos_feats,
                                       self.temperature, self.normalize,
                                       self.scale)

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
