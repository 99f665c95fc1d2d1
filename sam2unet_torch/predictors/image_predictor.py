"""SAM2 image predictor: embed an image once, then masks for each prompt
(the port's copy of the JAX package's `predictors/image_predictor.py`,
sam2/sam2_image_predictor.py:20-447). Numpy in, numpy out; prompts follow
the reference's conventions (XY pixel coordinates, labels 1/0 for
foreground/background, an XYXY box merged in as two corner points with
labels 2 and 3, the pad point always appended).

The prompt-to-mask path runs under `torch.inference_mode()` on the model's
device. With nothing to fill (both areas of the transforms 0) the whole
postprocess runs there too: clip the low-resolution logits to [-32, 32],
bilinear resize to the original size (`ops/resize.py`, torch semantics,
identical to the host path's taps), threshold; only the final masks come
back. The JAX package bit-packs the binary masks before that copy, a
measure against its TPU link's bandwidth; the port copies bool masks. A
non-zero area takes the host postprocess (`SAM2Transforms`: a positive
one fills holes or removes sprinkles there). The automatic mask
generator's batches take `_predict_amg`: the clip, the resize, the
stability score and the threshold of each batch all run on the device,
and only the bool masks and the scores come back (the host path where
holes are to be filled or the batch's logits would pass 2**28 elements).

`get_image_embedding` returns the (B, 64, 64, 256) NHWC embedding the
mask decoder reads (the reference's is NCHW).
"""

from __future__ import annotations

import numpy as np
import torch

from sam2unet_torch.models.sam2_base import SAM2Base
from sam2unet_torch.ops.resize import resize_nchw
from sam2unet_torch.predictors.transforms import SAM2Transforms
from sam2unet_torch.utils.amg import calculate_stability_score

# batched prompts whose full-resolution logits would exceed this many
# elements take the host postprocess (image_predictor.py:340-345); an AMG
# batch, past the second (image_predictor.py:382-384)
DEVICE_POST_ELEMENTS = 2 ** 26
AMG_DEVICE_ELEMENTS = 2 ** 28


def assemble_prompts(box_coords, point_coords, point_labels):
    """Box corners (labels 2, 3) then points, at model resolution, as one
    (B, P, 2) / (B, P) pair with the pad point (label -1) ALWAYS appended:
    SAM2's image predictor calls the prompt encoder with boxes=None, so its
    pad=(boxes is None) holds for box prompts too (image_predictor.py:22-52
    of the JAX package). No prompt at all gives zero-length arrays."""
    pieces_c, pieces_l = [], []
    if box_coords is not None:
        bc = np.asarray(box_coords, np.float32).reshape(-1, 2, 2)
        pieces_c.append(bc)
        pieces_l.append(np.tile(np.array([[2, 3]], np.int32), (bc.shape[0], 1)))
    if point_coords is not None:
        pc = np.asarray(point_coords, np.float32)
        pl = np.asarray(point_labels, np.int32)
        pieces_c.append(pc[None] if pc.ndim == 2 else pc)
        pieces_l.append(pl[None] if pl.ndim == 1 else pl)
    if not pieces_c:
        return np.zeros((1, 0, 2), np.float32), np.zeros((1, 0), np.int32)
    coords = np.concatenate(pieces_c, axis=1)
    labels = np.concatenate(pieces_l, axis=1)
    b = coords.shape[0]
    coords = np.concatenate([coords, np.zeros((b, 1, 2), np.float32)], axis=1)
    labels = np.concatenate([labels, -np.ones((b, 1), np.int32)], axis=1)
    return coords.astype(np.float32), labels.astype(np.int32)


class SAM2ImagePredictor:
    def __init__(self, sam_model: SAM2Base, mask_threshold: float = 0.0,
                 max_hole_area: float = 0.0, max_sprinkle_area: float = 0.0):
        self.model = sam_model.eval()
        self.mask_threshold = mask_threshold
        self._transforms = SAM2Transforms(
            sam_model.cfg.image_size, mask_threshold=mask_threshold,
            max_hole_area=max_hole_area, max_sprinkle_area=max_sprinkle_area)
        self.device = sam_model.no_mem_embed.device
        self.reset_predictor()

    # ------------------------------------------------------------ features

    def set_image(self, image: np.ndarray) -> None:
        """image: HWC RGB, uint8 or float in [0, 255]."""
        self.reset_predictor()
        self._orig_hw = [tuple(image.shape[:2])]
        self._compute_features(self._transforms(image)[None])

    def set_image_batch(self, image_list: list[np.ndarray]) -> None:
        self.reset_predictor()
        self._orig_hw = [tuple(im.shape[:2]) for im in image_list]
        self._compute_features(self._transforms.forward_batch(image_list))
        self._is_batch = True

    @torch.inference_mode()
    def _compute_features(self, x: np.ndarray) -> None:
        out = self.model.forward_image(torch.from_numpy(x).to(self.device))
        feats = list(out["backbone_fpn"])
        # no_mem_embed on the lowest-resolution level, as the video path
        # trained it (sam2_image_predictor.py:100-103)
        if self.model.cfg.directly_add_no_mem_embed:
            feats[-1] = feats[-1] + self.model.no_mem_embed
        self._features = {"image_embed": feats[-1],
                          "high_res_feats": feats[:-1]}

    # ------------------------------------------------------------- predict

    def predict(self, point_coords=None, point_labels=None, box=None,
                mask_input=None, multimask_output: bool = True,
                return_logits: bool = False, normalize_coords: bool = True):
        """(masks (M, H, W), ious (M,), low-res logits (M, h, w))."""
        self._need_features()
        coords, labels = self._prep_prompts(point_coords, point_labels, box,
                                            normalize_coords, 0)
        masks, ious, low_res = self._run(0, coords, labels, mask_input,
                                         multimask_output, return_logits)
        return masks[0], ious[0], low_res[0]

    def predict_batch(self, point_coords_batch=None, point_labels_batch=None,
                      box_batch=None, mask_input_batch=None,
                      multimask_output: bool = True, return_logits: bool = False,
                      normalize_coords: bool = True):
        """One prompt set per image of `set_image_batch`: lists of masks,
        ious and low-res logits."""
        if not self._is_batch:
            raise RuntimeError("call set_image_batch(...) first")
        out = ([], [], [])

        def item(seq, i):
            return None if seq is None else seq[i]

        for i in range(len(self._orig_hw)):
            coords, labels = self._prep_prompts(
                item(point_coords_batch, i), item(point_labels_batch, i),
                item(box_batch, i), normalize_coords, i)
            res = self._run(i, coords, labels, item(mask_input_batch, i),
                            multimask_output, return_logits)
            for acc, r in zip(out, res):
                acc.append(r[0])
        return out

    def _predict(self, point_coords, point_labels, boxes=None, mask_input=None,
                 multimask_output: bool = True, return_logits: bool = False,
                 img_idx: int = 0):
        """B prompts against one set image (sam2_image_predictor.py:318-447):
        coordinates already at model resolution. Returns numpy (B, M, H, W),
        (B, M), (B, M, h, w)."""
        self._need_features()
        coords, labels = assemble_prompts(boxes, point_coords, point_labels)
        if coords.shape[1] == 0 and mask_input is not None:
            # mask-only prompts: B comes from the mask batch
            b0 = np.asarray(mask_input).shape[0]
            coords = np.zeros((b0, 0, 2), np.float32)
            labels = np.zeros((b0, 0), np.int32)
        hw = self._orig_hw[img_idx]
        big = coords.shape[0] * 3 * hw[0] * hw[1] > DEVICE_POST_ELEMENTS
        mi = None
        if mask_input is not None:
            mi = np.asarray(mask_input, np.float32)
            mi = mi[:, None] if mi.ndim == 3 else mi
        return self._run(img_idx, coords, labels, mi, multimask_output,
                         return_logits, host_post=big)

    def _prep_prompts(self, point_coords, point_labels, box, normalize: bool,
                      img_idx: int):
        hw = self._orig_hw[img_idx]
        bc = None
        if box is not None:
            bc = self._transforms.transform_boxes(
                box, normalize=normalize, orig_hw=hw).reshape(1, 2, 2)
        pc = None
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_coords need point_labels")
            pc = self._transforms.transform_coords(
                np.asarray(point_coords, np.float32), normalize=normalize,
                orig_hw=hw)
        return assemble_prompts(bc, pc, point_labels)

    @torch.inference_mode()
    def _decode(self, img_idx: int, coords: np.ndarray, labels: np.ndarray,
                mask_input: np.ndarray | None, multimask_output: bool):
        """The prompt encoder and mask decoder on the set image: (low-res
        logits clipped to [-32, 32], fp32 (B, M, h, w); ious (B, M))."""
        m = self.model
        f = self._features
        sl = slice(img_idx, img_idx + 1)
        dev = self.device
        mi = None
        if mask_input is not None:
            mi = np.asarray(mask_input, np.float32)
            mi = mi[None] if mi.ndim == 3 else mi
            mi = torch.from_numpy(mi.transpose(0, 2, 3, 1).copy()).to(dev)
        pe = m.sam_prompt_encoder
        sparse, dense = pe(torch.from_numpy(coords).to(dev),
                           torch.from_numpy(labels).to(dev), mi)
        high = tuple(h[sl] for h in f["high_res_feats"])
        low_res, ious, _, _ = m.sam_mask_decoder(
            f["image_embed"][sl], pe.get_dense_pe(), sparse, dense,
            multimask_output, high)
        return low_res.float().clamp(-32.0, 32.0), ious.float()

    def _run(self, img_idx: int, coords, labels, mask_input,
             multimask_output: bool, return_logits: bool,
             host_post: bool = False):
        low_res, ious = self._decode(img_idx, coords, labels, mask_input,
                                     multimask_output)
        hw = self._orig_hw[img_idx]
        if self._transforms.device_postprocess and not host_post:
            with torch.inference_mode():
                full = resize_nchw(low_res, tuple(hw), "bilinear")
                if not return_logits:
                    full = full > self.mask_threshold
            masks = full.cpu().numpy()
        else:
            masks = self._transforms.postprocess_masks(low_res.cpu().numpy(),
                                                       hw)
            if not return_logits:
                masks = masks > self.mask_threshold
        return masks, ious.cpu().numpy(), low_res.cpu().numpy()

    def _predict_amg(self, point_coords: np.ndarray,
                     point_labels: np.ndarray, multimask_output: bool = True,
                     stability_offset: float = 1.0, need_low_res: bool = False,
                     img_idx: int = 0, mask_threshold: float | None = None):
        """The automatic mask generator's batch (image_predictor.py:363-431
        of the JAX package): B prompts at model resolution against the set
        image; the clip, the bilinear resize to the original size, the
        stability score (the IoU of the masks thresholded at thr +- the
        offset, 0 where the looser one is empty) and the threshold run on
        the device. Returns numpy (B, M, H, W) bool masks, (B, M) ious,
        (B, M, h, w) low-res logits or None, (B, M) fp32 stability scores.
        Hole filling, or logits past AMG_DEVICE_ELEMENTS, take `_predict`
        and the host score."""
        b = point_coords.shape[0]
        hw = tuple(self._orig_hw[img_idx])
        n_out = 3 if multimask_output else 1
        thr = (self.mask_threshold if mask_threshold is None
               else float(mask_threshold))
        if (not self._transforms.device_postprocess
                or b * n_out * hw[0] * hw[1] > AMG_DEVICE_ELEMENTS):
            masks, ious, low_res = self._predict(
                point_coords, point_labels, multimask_output=multimask_output,
                return_logits=True, img_idx=img_idx)
            stability = calculate_stability_score(masks, thr, stability_offset)
            return (masks > thr, ious, low_res if need_low_res else None,
                    stability)
        coords, labels = assemble_prompts(None, point_coords, point_labels)
        low_res, ious = self._decode(img_idx, coords, labels, None,
                                     multimask_output)
        with torch.inference_mode():
            full = resize_nchw(low_res, hw, "bilinear")
            hi = (full > thr + stability_offset).sum((-1, -2))
            lo = (full > thr - stability_offset).sum((-1, -2))
            stability = torch.where(lo > 0, hi.float() / lo.clamp_min(1), 0.0)
            masks = full > thr
        return (masks.cpu().numpy(), ious.cpu().numpy(),
                low_res.cpu().numpy() if need_low_res else None,
                stability.cpu().numpy())

    def get_image_embedding(self) -> torch.Tensor:
        self._need_features()
        return self._features["image_embed"]

    def _need_features(self) -> None:
        if self._features is None:
            raise RuntimeError("An image must be set with .set_image(...) "
                               "first.")

    def reset_predictor(self) -> None:
        self._features = None
        self._orig_hw: list[tuple[int, int]] = []
        self._is_batch = False
