"""Connected-component labeling, 8-connectivity (the port's copy of the JAX
package's `ops/connected_components.py`; the reference's CUDA union-find,
sam2/csrc/connected_components.cu:20-289, `get_connected_componnets`).
Both forms share its contract:

    labels, counts = get_connected_components(mask)   # mask: (N, 1, H, W)

    labels: int32, 0 on the background; the pixels of one component share
            one id.
    counts: int32, 0 on the background; each foreground pixel carries the
            area of its component.

  - On tensors (`label_components_torch`, the device-resident video step's
    hole filling): min-label propagation, a 3x3 min over the 8-neighbourhood
    then a pointer-jumping hop `label <- label[label]`, repeated until
    nothing changes, then the areas by a histogram per image. Ids are the
    raster index of each component's first pixel plus one, exactly those of
    the JAX package's `label_components_jax`. Plain PyTorch: the JAX form is
    no Pallas kernel either.
  - On the host (`label_components_native`, the predictors' host
    postprocess): two-pass union-find in C++ (csrc/ccl.cc) through ctypes,
    built with g++ at first use into `build/native/<hash>/` at the
    repository root. A failed build raises. Masks over 2**31 - 1 pixels take
    scipy's labeling, as in the JAX package (the C interface carries pixel
    indices as int32). Ids are dense, in first-seen order.

`canonicalize_labels` renumbers ids to first-seen order, so the two forms
compare exactly.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sam2unet_torch.ops import build

MAX_NATIVE_PIXELS = 2**31 - 1


def _min8(labels: torch.Tensor, big: int) -> torch.Tensor:
    """3x3 minimum over each pixel's 8-neighbourhood and itself, (N, H, W),
    the border padded with `big`."""
    h, w = labels.shape[1:]
    padded = F.pad(labels, (1, 1, 1, 1), value=big)
    out = labels
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, padded[:, dy:dy + h, dx:dx + w])
    return out


def label_components_torch(mask: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """mask (N, 1, H, W), any dtype (foreground where > 0) -> (labels,
    counts), int32, on mask's device. The propagation ends as soon as the
    labels stop changing, which pointer jumping reaches in about log2(H*W)
    rounds; H*W rounds is the cap."""
    n, c, h, w = mask.shape
    if c != 1:
        raise ValueError(f"expected (N, 1, H, W), got {tuple(mask.shape)}")
    size = h * w
    fg = mask[:, 0] > 0
    init = torch.arange(size, dtype=torch.int32,
                        device=mask.device).reshape(1, h, w)
    labels = torch.where(fg, init, size)
    for _ in range(size):
        prop = torch.where(fg, _min8(labels, size), size)
        flat = prop.reshape(n, size)
        hopped = torch.gather(flat, 1, flat.clamp(max=size - 1).long())
        new = torch.where(flat < size, torch.minimum(flat, hopped),
                          flat).reshape(n, h, w)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    flat = labels.reshape(n, size)
    live = flat < size
    slot = flat.clamp(max=size).long()
    hist = torch.zeros(n, size + 1, dtype=torch.int32, device=mask.device)
    hist.scatter_add_(1, slot, live.to(torch.int32))
    counts = torch.where(live, torch.gather(hist, 1, slot), 0)
    labels = torch.where(live, flat + 1, 0)
    return (labels.reshape(n, 1, h, w).to(torch.int32),
            counts.reshape(n, 1, h, w).to(torch.int32))


# ------------------------------------------------------------- host native

_native: ctypes.CDLL | None = None


def native_library() -> ctypes.CDLL:
    """libccl.so, compiled from csrc/ccl.cc with g++ on first use
    (`build.host_library`)."""
    global _native
    if _native is None:
        cdll = ctypes.CDLL(str(build.host_library("ccl")))
        cdll.ccl_label_u8.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 2
        cdll.ccl_label_u8.restype = ctypes.c_int32
        _native = cdll
    return _native


def label_components_native(mask: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """mask (N, 1, H, W) numpy -> (labels, counts), int32 numpy."""
    n, c, h, w = mask.shape
    if c != 1:
        raise ValueError(f"expected (N, 1, H, W), got {tuple(mask.shape)}")
    m = np.ascontiguousarray(mask[:, 0] > 0, dtype=np.uint8)
    labels = np.zeros((n, h, w), np.int32)
    counts = np.zeros((n, h, w), np.int32)
    if h * w <= MAX_NATIVE_PIXELS:
        lib = native_library()
        for i in range(n):
            if lib.ccl_label_u8(m[i].ctypes.data, labels[i].ctypes.data,
                                counts[i].ctypes.data, h, w) < 0:
                raise RuntimeError(f"ccl_label_u8 refused a {h}x{w} mask")
    else:
        from scipy import ndimage

        for i in range(n):
            lab, num = ndimage.label(m[i], structure=np.ones((3, 3), np.int32))
            labels[i] = lab
            if num:
                areas = np.bincount(lab.ravel(), minlength=num + 1)
                areas[0] = 0
                counts[i] = areas[lab]
    return labels[:, None], counts[:, None]


def canonicalize_labels(labels) -> np.ndarray:
    """Component ids renumbered to first-seen (raster) order per image,
    background 0."""
    labels = np.asarray(labels)
    out = np.zeros(labels.shape, np.int32)
    for i in range(labels.shape[0]):
        flat = labels[i].ravel()
        ids, first = np.unique(flat, return_index=True)
        keep = ids != 0
        ids, first = ids[keep], first[keep]
        rank = np.empty(len(ids), np.int32)
        rank[np.argsort(first, kind="stable")] = np.arange(1, len(ids) + 1)
        pos = np.searchsorted(ids, flat)
        fg = flat != 0
        o = out[i].reshape(-1)
        o[fg] = rank[pos[fg]]
    return out


def get_connected_components(mask) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's `_C.get_connected_componnets` (sam2/utils/misc.py:
    47-63): `label_components_torch` on mask's device."""
    return label_components_torch(torch.as_tensor(mask))
