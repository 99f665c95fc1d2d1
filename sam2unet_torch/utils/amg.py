"""Utilities for the automatic mask generator (sam2/utils/amg.py:18-348),
the port's numpy copy of the JAX package's `utils/amg.py`.

Numpy: these run on the host around the predictor's device decode. RLE
follows the pycocotools uncompressed format (column-major runs starting
with background). `coco_encode_rle` needs pycocotools and raises
ImportError without it; `remove_small_regions` labels components with the
port's host connected components (`ops/connected_components.py`).
"""

from __future__ import annotations

import numpy as np


class ScratchBuffers:
    """Reusable host buffers for the large per-batch AMG intermediates.

    glibc routes allocations above the mmap threshold through mmap/munmap,
    so every fresh multi-MB numpy array pays first-touch page faults again
    on the next call; writes into already-faulted pages do not.
    Single-threaded use only (the predictors drive these sequentially);
    a buffer's contents are valid until the next request for the same key.
    """

    def __init__(self):
        self._bufs: dict[str, np.ndarray] = {}

    def get(self, key: str, shape: tuple[int, ...], dtype) -> np.ndarray:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != shape or buf.dtype != np.dtype(dtype):
            buf = np.empty(shape, dtype)
            self._bufs[key] = buf
        return buf


_scratch = ScratchBuffers()

class MaskData:
    """Dict of batched tensors/lists with filter/cat/update (amg.py:18-77)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            assert isinstance(v, (list, np.ndarray))
        self._stats = dict(**kwargs)

    def __setitem__(self, key, item):
        self._stats[key] = item

    def __delitem__(self, key):
        del self._stats[key]

    def __getitem__(self, key):
        return self._stats[key]

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray) -> None:
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list) and keep.dtype == bool:
                self._stats[k] = [a for i, a in enumerate(v) if keep[i]]
            elif isinstance(v, list):
                self._stats[k] = [v[i] for i in keep]

    def cat(self, new_stats: "MaskData") -> None:
        # shallow container copies only: the incoming values are freshly
        # built per point batch and never mutated afterwards. The
        # reference's deepcopy here (amg.py:64-66) is O(total RLE runs)
        # and dominated the 256-point wall time (minutes of copying
        # ~150k-run RLE dicts element by element).
        for k, v in new_stats.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = list(v) if isinstance(v, list) else v
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + list(v)


def is_box_near_crop_edge(boxes, crop_box, orig_box, atol=20.0) -> np.ndarray:
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    boxes = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    near_crop = near_crop & ~near_image
    return np.any(near_crop, axis=1)


def batch_iterator(batch_size: int, *args):
    assert len(args) > 0 and all(len(a) == len(args[0]) for a in args)
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size : (b + 1) * batch_size] for arg in args]


def mask_to_rle(tensor: np.ndarray) -> list[dict]:
    """(B, H, W) binary -> uncompressed RLE dicts (amg.py:109-138).

    Batched: one transition scan over the whole stack, in warm scratch
    buffers (a fresh transpose copy plus per-row int casts would re-fault
    the pages of every batch)."""
    b, h, w = tensor.shape
    if b == 0:
        # every candidate of a point batch can be filtered out (iou /
        # stability thresholds) — numpy cannot infer -1 on 0 elements
        return []
    n = h * w
    # column-major (F order) flatten into a reused buffer
    flat = _scratch.get("rle_flat", (b, w, h), np.bool_)
    np.copyto(flat, tensor.transpose(0, 2, 1), casting="unsafe")
    flat = flat.reshape(b, n)
    diff = _scratch.get("rle_diff", (b, n - 1), np.bool_)
    np.not_equal(flat[:, 1:], flat[:, :-1], out=diff)
    rows, pos = np.nonzero(diff)
    row_splits = np.searchsorted(rows, np.arange(1, b))
    starts_first = flat[:, 0]
    out = []
    for i, idx in enumerate(np.split(pos + 1, row_splits)):
        lengths = np.diff(idx, prepend=0, append=n).tolist()
        if starts_first[i]:
            lengths = [0] + lengths
        out.append({"size": [h, w], "counts": lengths})
    return out


def rle_to_mask(rle: dict) -> np.ndarray:
    """Uncompressed RLE -> (H, W) bool mask, vectorized (contract of
    amg.py:141-153). Runs alternate bg/fg starting with background; a
    difference array marks fg run boundaries and one cumsum paints them."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    delta = np.zeros(h * w + 1, np.int64)
    np.add.at(delta, starts[1::2], 1)   # foreground runs open...
    np.add.at(delta, ends[1::2], -1)    # ...and close
    flat = np.cumsum(delta[:-1]) > 0
    return flat.reshape(w, h).T         # runs are column-major


def area_from_rle(rle: dict) -> int:
    return int(np.sum(np.asarray(rle["counts"], np.int64)[1::2]))


def calculate_stability_score(
    masks: np.ndarray, mask_threshold: float, threshold_offset: float
) -> np.ndarray:
    """IoU between high/low-thresholded masks (amg.py:158-178)."""
    intersections = (
        (masks > (mask_threshold + threshold_offset)).sum(-1).sum(-1)
    ).astype(np.float64)
    unions = ((masks > (mask_threshold - threshold_offset)).sum(-1).sum(-1)).astype(
        np.float64
    )
    # union == 0 (mask empty even at the loose threshold): the reference
    # computes 0/0 = NaN, which fails its >= thresh filter — 0.0 drops the
    # same candidates without propagating NaNs
    return np.where(unions > 0, intersections / np.maximum(unions, 1), 0.0)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(N^2, 2) cell-centered unit-square grid, x fastest (contract of
    amg.py:181-187): point i*N+j sits at ((j+.5)/N, (i+.5)/N)."""
    centers = (np.arange(n_per_side) + 0.5) / n_per_side
    ys, xs = np.meshgrid(centers, centers, indexing="ij")
    return np.stack([xs.ravel(), ys.ravel()], axis=1)


def build_all_layer_point_grids(n_per_side, n_layers, scale_per_layer):
    """One grid per crop layer, side length shrunk by scale each layer."""
    sides = n_per_side // np.power(scale_per_layer, np.arange(n_layers + 1))
    return [build_point_grid(int(s)) for s in sides]


def generate_crop_boxes(im_size, n_layers, overlap_ratio):
    """Overlapping crops pyramid (contract of amg.py:205-237): layer L has
    2^L x 2^L crops in XYXY, ordered x-major; layer 0 is the whole image.
    Crop sizes use integer ceil-division so every pixel is covered."""
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes = [[0, 0, im_w, im_h]]
    layer_idxs = [0]
    for layer in range(1, n_layers + 1):
        per_side = 2**layer
        overlap = int(overlap_ratio * short_side * 2 / per_side)
        # smallest crop length whose per_side tiling (with overlap) covers
        # the image: ceil((orig + overlap*(per_side-1)) / per_side)
        crop_w = -(-(im_w + overlap * (per_side - 1)) // per_side)
        crop_h = -(-(im_h + overlap * (per_side - 1)) // per_side)
        x0s = (crop_w - overlap) * np.arange(per_side)
        y0s = (crop_h - overlap) * np.arange(per_side)
        for x0 in x0s:
            for y0 in y0s:
                crop_boxes.append([int(x0), int(y0),
                                   int(min(x0 + crop_w, im_w)),
                                   int(min(y0 + crop_h, im_h))])
                layer_idxs.append(layer)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return np.asarray(boxes) + np.asarray([[x0, y0, x0, y0]])


def uncrop_points(points: np.ndarray, crop_box) -> np.ndarray:
    x0, y0, _, _ = crop_box
    return np.asarray(points) + np.asarray([[x0, y0]])


def uncrop_masks(masks: np.ndarray, crop_box, orig_h, orig_w) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad = (
        (0, 0),
        (y0, orig_h - y1),
        (x0, orig_w - x1),
    )
    return np.pad(masks, pad)


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str):
    """Fill small holes/islands via the port's host connected components
    (amg.py:269-293; replaces the reference's
    cv2.connectedComponentsWithStats)."""
    from sam2unet_torch.ops.connected_components import label_components_native

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working = (correct_holes ^ mask).astype(np.uint8)
    labels, _ = label_components_native(working[None, None])
    labels = labels[0, 0]
    # one bincount gives every component's area at once (the old
    # per-component counts[labels == i] probe was O(components * H * W))
    areas = np.bincount(labels.ravel())
    fg = areas > 0
    fg[0] = False  # label 0 is background
    small = fg & (areas < area_thresh)
    if not small.any():
        return mask, False
    if not correct_holes and small.sum() == fg.sum():
        # every island is below threshold: keep the largest instead of
        # emptying the mask (amg.py:288-291)
        small[int(np.argmax(np.where(fg, areas, 0)))] = False
    fill = small[labels]
    mask = mask | fill if correct_holes else mask & ~fill
    return mask, True


def coco_encode_rle(uncompressed_rle: dict) -> dict:
    try:
        from pycocotools import mask as mask_utils  # type: ignore

        h, w = uncompressed_rle["size"]
        rle = mask_utils.frPyObjects(uncompressed_rle, h, w)
        rle["counts"] = rle["counts"].decode("utf-8")
        return rle
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError("pycocotools is required for COCO RLE output") from e


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """(amg.py:305-348): XYXY boxes around masks; zeros for empty masks.
    Integer dtype like the reference (torch bool*arange promotes to int64),
    so downstream record fields ('bbox', 'crop_box') serialize as ints."""
    if masks.size == 0:
        return np.zeros((*masks.shape[:-2], 4), np.int64)
    shape = masks.shape
    h, w = shape[-2:]
    flat = masks.reshape(-1, h, w)
    if flat.dtype != np.bool_:  # astype would re-fault ~60 MB per batch
        flat = flat.astype(bool)

    in_height = np.max(flat, axis=-1)
    in_height_coords = in_height * np.arange(h)[None]
    bottom_edges = np.max(in_height_coords, axis=-1)
    in_height_coords = in_height_coords + h * (~in_height)
    top_edges = np.min(in_height_coords, axis=-1)

    in_width = np.max(flat, axis=-2)
    in_width_coords = in_width * np.arange(w)[None]
    right_edges = np.max(in_width_coords, axis=-1)
    in_width_coords = in_width_coords + w * (~in_width)
    left_edges = np.min(in_width_coords, axis=-1)

    empty = (right_edges < left_edges) | (bottom_edges < top_edges)
    out = np.stack([left_edges, top_edges, right_edges, bottom_edges], axis=-1)
    out = out * (~empty)[..., None]
    return out.reshape(*shape[:-2], 4).astype(np.int64)


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    # dtype-preserving like the reference's deepcopy (amg.py:255-260)
    box = np.asarray(box).copy()
    box[2] = box[2] - box[0]
    box[3] = box[3] - box[1]
    return box


def batched_nms(boxes: np.ndarray, scores: np.ndarray, idxs: np.ndarray,
                iou_threshold: float) -> np.ndarray:
    """Category-aware greedy NMS (torchvision.ops.batched_nms equivalent)."""
    if len(boxes) == 0:
        return np.zeros(0, np.int64)
    boxes = np.asarray(boxes, np.float32)  # reference calls .float() before NMS
    # offset boxes per category so cross-category boxes never overlap
    max_coord = boxes.max() + 1
    offsets = idxs.astype(np.float32) * max_coord
    shifted = boxes + offsets[:, None]
    order = np.argsort(-scores, kind="stable")
    b = shifted[order]
    x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    areas = np.maximum(0, x1 - x0) * np.maximum(0, y1 - y0)
    n = len(b)

    def iou_block(a_idx, b_idx):
        # (len(a), len(b)) IoU block between two index sets (sorted order)
        xx0 = np.maximum(x0[a_idx][:, None], x0[b_idx][None])
        yy0 = np.maximum(y0[a_idx][:, None], y0[b_idx][None])
        xx1 = np.minimum(x1[a_idx][:, None], x1[b_idx][None])
        yy1 = np.minimum(y1[a_idx][:, None], y1[b_idx][None])
        inter = np.maximum(0, xx1 - xx0) * np.maximum(0, yy1 - yy0)
        union = areas[a_idx][:, None] + areas[b_idx][None] - inter
        return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)

    # Exact greedy NMS with bounded memory. A full N^2 IoU matrix is 144 GiB
    # at the 196k boxes a dense 256-point grid produces, so instead walk the
    # score-sorted boxes in chunks: each chunk is first vector-suppressed
    # against every box already kept (in bounded blocks), then the survivors
    # run the sequential greedy pass — one O(chunk) IoU row per kept box.
    # A box is suppressed iff it overlaps a higher-scoring kept box, and all
    # such boxes are either in an earlier chunk (pre-suppression) or earlier
    # in this chunk (the loop), so the result is identical to the one-pass
    # matrix form. Peak memory is O(CHUNK * KBLOCK).
    CHUNK, KBLOCK = 2048, 4096
    kept = np.zeros(0, np.int64)
    for s in range(0, n, CHUNK):
        cand = np.arange(s, min(s + CHUNK, n))
        alive = np.ones(cand.size, bool)
        for ks in range(0, kept.size, KBLOCK):
            live = cand[alive]
            if live.size == 0:
                break
            blk = iou_block(live, kept[ks : ks + KBLOCK])
            alive[alive] = ~(blk > iou_threshold).any(axis=1)
        cand = cand[alive]
        new_kept = []
        while cand.size:
            i = cand[0]
            new_kept.append(i)
            rest = cand[1:]
            row = iou_block(np.asarray([i]), rest)[0]
            cand = rest[row <= iou_threshold]
        kept = np.concatenate([kept, np.asarray(new_kept, np.int64)])
    return order[kept]
