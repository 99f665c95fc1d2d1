"""ctypes bridge to the native data-loading library (csrc/dataload.cc), the
port's copy of sam2unet_tpu/data/native_loader.py.

JPEG decode through libjpeg (the pixels PIL gives) and a fused letterbox
and normalization whose resize taps come from `ops/resize_np.py`, the
weights of the numpy path, so the two pipelines are interchangeable (to
~1e-6). The library is built with g++ and -ljpeg at first use
(`ops/build.py::host_library`). `available()` is False where it cannot be
built or loaded (no g++, no libjpeg headers or library), and the datasets
then decode with PIL; `status()` says which loader runs and why.
SAM2UNET_NO_NATIVE_LOADER=1 turns it off.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from sam2unet_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from sam2unet_torch.ops import build
from sam2unet_torch.ops.resize_np import _taps

_I32P = ctypes.POINTER(ctypes.c_int32)
_F32P = ctypes.POINTER(ctypes.c_float)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@functools.lru_cache(maxsize=1)
def _build() -> tuple[ctypes.CDLL | None, str]:
    """(the library or None, where it was built or why it was not)."""
    try:
        path = build.host_library("dataload", libs=("-ljpeg",))
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError) as e:
        return None, f"it did not build or load: {str(e)[:300]}"
    lib.dl_jpeg_info.argtypes = [_U8P, ctypes.c_size_t,
                                 ctypes.POINTER(ctypes.c_int),
                                 ctypes.POINTER(ctypes.c_int)]
    lib.dl_jpeg_decode.argtypes = [_U8P, ctypes.c_size_t, _U8P, ctypes.c_int]
    lib.dl_letterbox_norm.argtypes = (
        [_U8P] + [ctypes.c_int] * 2
        + [_I32P, _F32P, ctypes.c_int, ctypes.c_int] * 2
        + [ctypes.c_int] * 3 + [_F32P, _F32P, _F32P])
    for fn in (lib.dl_jpeg_info, lib.dl_jpeg_decode, lib.dl_letterbox_norm):
        fn.restype = ctypes.c_int
    return lib, str(path)


def _lib() -> ctypes.CDLL | None:
    return _build()[0]


def available() -> bool:
    return _lib() is not None


def enabled() -> bool:
    """The datasets use the native loader: not switched off, and built."""
    return not os.environ.get("SAM2UNET_NO_NATIVE_LOADER") and available()


def status() -> str:
    """Which loader the datasets use for .jpg files, and why."""
    if os.environ.get("SAM2UNET_NO_NATIVE_LOADER"):
        return "PIL (SAM2UNET_NO_NATIVE_LOADER is set)"
    lib, where = _build()
    return f"native libjpeg ({where})" if lib is not None else f"PIL ({where})"


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def decode_jpeg(path: str) -> np.ndarray | None:
    """(H, W, 3) uint8 RGB, or None if the file is not a decodable JPEG."""
    lib = _lib()
    if lib is None:
        return None
    buf = np.fromfile(path, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.dl_jpeg_info(_u8p(buf), buf.size, ctypes.byref(h),
                        ctypes.byref(w)) != 0:
        return None
    if h.value * w.value * 3 > 2**31 - 1:
        # the C interface carries sizes as int32: a header declaring a
        # larger image goes to PIL
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.dl_jpeg_decode(_u8p(buf), buf.size, _u8p(out), out.size) != 0:
        return None
    return out


@functools.lru_cache(maxsize=512)
def _taps_c(in_size: int, out_size: int):
    """Contiguous int32 / float32 antialiased bilinear taps for the C
    interface, cached per geometry."""
    idx, w = _taps(in_size, out_size, "bilinear", False, True)
    return (np.ascontiguousarray(idx, np.int32),
            np.ascontiguousarray(w, np.float32))


_MEAN = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
_STD = np.ascontiguousarray(IMAGENET_STD, np.float32)


def letterbox_norm(rgb: np.ndarray, size: int):
    """uint8 (H, W, 3) -> (fp32 (size, size, 3) normalized NHWC, padding
    (left, top, right, bottom)): the geometry and weights of
    `data/transforms.py::letterbox` followed by `normalize`."""
    lib = _lib()
    if lib is None:
        raise RuntimeError(status())
    h, w = rgb.shape[:2]
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    pad_h, pad_w = size - nh, size - nw
    top, left = pad_h // 2, pad_w // 2
    ih, wh = _taps_c(h, nh)
    iw, ww = _taps_c(w, nw)
    # the numpy path normalizes after the zero pad: pad pixels carry
    # (0 - mean) / std
    out = np.empty((size, size, 3), np.float32)
    out[:] = (0.0 - _MEAN) / _STD
    rgb = np.ascontiguousarray(rgb)
    rc = lib.dl_letterbox_norm(
        _u8p(rgb), h, w, ih.ctypes.data_as(_I32P), _f32p(wh), nh, ih.shape[1],
        iw.ctypes.data_as(_I32P), _f32p(ww), nw, iw.shape[1], size, top,
        left, _f32p(_MEAN), _f32p(_STD), _f32p(out))
    if rc != 0:
        raise RuntimeError(f"dl_letterbox_norm failed ({rc})")
    return out, (left, top, pad_w - left, pad_h - top)
