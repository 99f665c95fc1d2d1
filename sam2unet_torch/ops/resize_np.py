"""Host-side (numpy) resize with torch coordinate semantics, used by the
data letterbox and the test postprocess.

  - ``bilinear`` / ``bicubic`` with align_corners True/False, matching
    torch.nn.functional.interpolate (bicubic uses A=-0.75).
  - ``nearest`` with torch's legacy floor rule.
  - ``antialias=True`` triangle/cubic filters matching torchvision/PIL
    downsampling (out-of-range taps dropped and renormalized).
"""

from __future__ import annotations

import functools

import numpy as np

_A = -0.75  # torch's bicubic convolution constant


def _source_index(out_size: int, in_size: int, align_corners: bool) -> np.ndarray:
    d = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(1, dtype=np.float64)
        return d * (in_size - 1) / (out_size - 1)
    scale = in_size / out_size
    return (d + 0.5) * scale - 0.5


def _cubic_kernel(x: np.ndarray, a: float = _A) -> np.ndarray:
    ax = np.abs(x)
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0),
    )


@functools.lru_cache(maxsize=512)
def _taps(in_size: int, out_size: int, method: str, align_corners: bool,
          antialias: bool) -> tuple[np.ndarray, np.ndarray]:
    """(idx (out, T) int32 clipped, w (out, T) float32), rows sum to 1."""
    if method == "nearest":
        idx = np.floor(np.arange(out_size) * (in_size / out_size)).astype(np.int64)
        idx = np.minimum(idx, in_size - 1)[:, None]
        return idx.astype(np.int32), np.ones((out_size, 1), np.float32)

    src = _source_index(out_size, in_size, align_corners)
    downscale = in_size / out_size if out_size < in_size else 1.0
    use_aa = antialias and downscale > 1.0

    if method == "bilinear" and not use_aa:
        s = src if align_corners else np.maximum(src, 0.0)
        i0 = np.clip(np.floor(s).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        t = (s - i0).astype(np.float64)
        idx = np.stack([i0, i1], axis=1)
        w = np.stack([1.0 - t, t], axis=1)
        return idx.astype(np.int32), w.astype(np.float32)

    if method == "bicubic" and not use_aa:
        i0 = np.floor(src).astype(np.int64)
        t = src - i0
        offs = np.array([-1, 0, 1, 2])
        idx = i0[:, None] + offs[None, :]
        w = _cubic_kernel(np.stack([1.0 + t, t, 1.0 - t, 2.0 - t], axis=1))
        idx = np.clip(idx, 0, in_size - 1)  # border replication
        return idx.astype(np.int32), w.astype(np.float32)

    if method == "bilinear":
        support = downscale

        def kernel(u):
            return np.maximum(0.0, 1.0 - np.abs(u))
    elif method == "bicubic":
        support = 2.0 * downscale
        kernel = _cubic_kernel
    else:
        raise ValueError(f"unknown resize method: {method}")

    tmax = int(np.ceil(2 * support)) + 2
    lo = (np.floor(src - support) + 1).astype(np.int64)
    taps = lo[:, None] + np.arange(tmax)[None, :]
    w = kernel((taps - src[:, None]) / downscale)
    valid = (taps >= 0) & (taps < in_size)
    w = np.where(valid, w, 0.0)
    w = w / w.sum(axis=1, keepdims=True)
    idx = np.clip(taps, 0, in_size - 1)
    return idx.astype(np.int32), w.astype(np.float32)


def resize_matrix(in_size: int, out_size: int, method: str = "bilinear",
                  align_corners: bool = False,
                  antialias: bool = False) -> np.ndarray:
    """Dense (out_size, in_size) float32 resize matrix of the same taps
    (the device resize, `ops/resize.py::resize_nhwc`)."""
    idx, w = _taps(in_size, out_size, method, align_corners, antialias)
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.repeat(np.arange(out_size), idx.shape[1])
    np.add.at(mat, (rows, idx.ravel()), w.astype(np.float64).ravel())
    return mat.astype(np.float32)


def _apply_taps(x: np.ndarray, axis: int, idx: np.ndarray, w: np.ndarray):
    """out[..., o, ...] = sum_t w[o,t] x[idx[o,t]] along `axis`."""
    g = np.take(x, idx, axis=axis)
    shape = [1] * g.ndim
    shape[axis] = idx.shape[0]
    shape[axis + 1] = idx.shape[1]
    return (g * w.reshape(shape)).sum(axis=axis + 1)


def resize_np(x: np.ndarray, size: tuple[int, int], method: str = "bilinear",
              align_corners: bool = False, antialias: bool = False) -> np.ndarray:
    """Resize an (..., H, W) array with torch semantics."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = size
    out = np.asarray(x, np.float32)
    if oh != h:
        idx, wt = _taps(h, oh, method, align_corners, antialias)
        out = _apply_taps(out, out.ndim - 2, idx, wt)
    if ow != w:
        idx, wt = _taps(w, ow, method, align_corners, antialias)
        out = _apply_taps(out, out.ndim - 1, idx, wt)
    return out.astype(np.float32)
