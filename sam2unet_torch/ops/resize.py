"""Device resizes as the reference calls them (`F.interpolate`).

bicubic (align_corners=False) for the Hiera pos-embed (hieradet.py:271),
bilinear align_corners=True in the decoder's `Up` (SAM2UNet.py:35), and
bilinear align_corners=False at the three heads (SAM2UNet.py:168-172).
`resize_nhwc` is the JAX package's device resize (ops/resize.py there):
two products with the (out, in) matrices of `resize_np`'s taps, which
carry the antialiased downscale the SAM2 image path asks for
(sam2_base.py:173-177, :244-248 of the JAX package).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam2unet_torch.ops.resize_np import resize_matrix


def resize_nchw(x: torch.Tensor, size: tuple[int, int], method: str = "bilinear",
                align_corners: bool = False) -> torch.Tensor:
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=size, mode=method,
                         align_corners=align_corners)


_MATRICES: dict[tuple, torch.Tensor] = {}


def _matrix(n: int, o: int, method: str, align_corners: bool,
            antialias: bool, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """`resize_matrix` on `device` in `dtype`, built once per key (a
    per-call host build and copy would cost each video frame two)."""
    key = (n, o, method, align_corners, antialias, device, dtype)
    if key not in _MATRICES:
        with torch.inference_mode(False):   # usable outside it too
            _MATRICES[key] = torch.from_numpy(resize_matrix(
                n, o, method, align_corners, antialias)).to(device, dtype)
    return _MATRICES[key]


def resize_nhwc(x: torch.Tensor, size: tuple[int, int],
                method: str = "bilinear", align_corners: bool = False,
                antialias: bool = False) -> torch.Tensor:
    """(B, H, W, C) -> (B, *size, C) through dense resize matrices, in
    x's dtype."""
    _, h, w, _ = x.shape
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    rh, rw = (_matrix(n, o, method, align_corners, antialias, x.device,
                      x.dtype) for n, o in ((h, oh), (w, ow)))
    x = torch.einsum("oh,bhwc->bowc", rh, x)
    return torch.einsum("pw,bowc->bopc", rw, x)
