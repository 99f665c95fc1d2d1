"""Automatic mask generator: grid prompting, the crops pyramid, NMS
deduplication (sam2/automatic_mask_generator.py:36-434), the port's copy
of the JAX package's `predictors/amg.py` around the port's image
predictor. The decode of each point batch runs on the model's device
(`SAM2ImagePredictor._predict_amg`); the filtering, the NMS, the RLE and
the small-region removal are host numpy (`utils/amg.py`).

    amg = SAM2AutomaticMaskGenerator(build_sam2("sam2_hiera_t"),
                                     points_per_side=16)
    records = amg.generate(image)   # HWC uint8 RGB
"""

from __future__ import annotations

import numpy as np

from sam2unet_torch.predictors.image_predictor import SAM2ImagePredictor
from sam2unet_torch.utils.amg import (
    MaskData,
    area_from_rle,
    batch_iterator,
    batched_mask_to_box,
    batched_nms,
    box_xyxy_to_xywh,
    build_all_layer_point_grids,
    calculate_stability_score,
    coco_encode_rle,
    generate_crop_boxes,
    is_box_near_crop_edge,
    mask_to_rle,
    remove_small_regions,
    rle_to_mask,
    uncrop_boxes_xyxy,
    uncrop_masks,
    uncrop_points,
)


class SAM2AutomaticMaskGenerator:
    def __init__(
        self,
        model,
        points_per_side: int | None = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.8,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        mask_threshold: float = 0.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: list[np.ndarray] | None = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        use_m2m: bool = False,
        multimask_output: bool = True,
    ) -> None:
        assert (points_per_side is None) != (point_grids is None)
        if points_per_side is not None:
            self.point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor
            )
        else:
            self.point_grids = point_grids
        assert output_mode in ("binary_mask", "uncompressed_rle", "coco_rle")

        self.predictor = SAM2ImagePredictor(
            model,
            max_hole_area=min_mask_region_area,
            max_sprinkle_area=min_mask_region_area,
        )
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.crop_n_points_downscale_factor = crop_n_points_downscale_factor
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.use_m2m = use_m2m
        self.multimask_output = multimask_output

    def generate(self, image: np.ndarray) -> list[dict]:
        """image: HWC uint8 RGB. Returns the reference's record schema
        (automatic_mask_generator.py:158-205)."""
        mask_data = self._generate_masks(image)

        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh),
            )

        if self.output_mode == "coco_rle":
            segs = [coco_encode_rle(r) for r in mask_data["rles"]]
        elif self.output_mode == "binary_mask":
            segs = [rle_to_mask(r) for r in mask_data["rles"]]
        else:
            segs = mask_data["rles"]

        anns = []
        for i in range(len(segs)):
            anns.append(
                {
                    "segmentation": segs[i],
                    "area": area_from_rle(mask_data["rles"][i]),
                    "bbox": box_xyxy_to_xywh(mask_data["boxes"][i]).tolist(),
                    "predicted_iou": float(mask_data["iou_preds"][i]),
                    "point_coords": [mask_data["points"][i].tolist()],
                    "stability_score": float(mask_data["stability_score"][i]),
                    "crop_box": box_xyxy_to_xywh(mask_data["crop_boxes"][i]).tolist(),
                }
            )
        return anns

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio
        )
        data = MaskData()
        for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
            data.cat(self._process_crop(image, crop_box, layer_idx, orig_size))

        if len(crop_boxes) > 1:
            areas = (
                (data["crop_boxes"][:, 2] - data["crop_boxes"][:, 0])
                * (data["crop_boxes"][:, 3] - data["crop_boxes"][:, 1])
            ).astype(np.float64)
            scores = 1.0 / np.maximum(areas, 1)
            keep = batched_nms(
                data["boxes"].astype(np.float32), scores,
                np.zeros(len(scores), np.int64), self.crop_nms_thresh,
            )
            data.filter(keep)
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx, orig_size) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1, :]
        crop_size = cropped.shape[:2]
        self.predictor.set_image(cropped)

        points_scale = np.array(crop_size)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale

        data = MaskData()
        for (points,) in batch_iterator(self.points_per_batch, points_for_image):
            data.cat(
                self._process_batch(points, crop_size, crop_box, orig_size)
            )
        self.predictor.reset_predictor()

        keep = batched_nms(
            data["boxes"].astype(np.float32), data["iou_preds"],
            np.zeros(len(data["iou_preds"]), np.int64), self.box_nms_thresh,
        )
        data.filter(keep)

        data["boxes"] = uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = uncrop_points(data["points"], crop_box)
        # reshape keeps (0, 4) when the crop survives zero masks (a bare
        # asarray gives (0,) and breaks cross-crop concatenation/indexing)
        data["crop_boxes"] = np.asarray(
            [crop_box] * len(data["rles"]), np.int64
        ).reshape(-1, 4)
        return data

    def _process_batch(self, points, im_size, crop_box, orig_size) -> MaskData:
        orig_h, orig_w = orig_size
        in_points = self.predictor._transforms.transform_coords(
            points, normalize=True, orig_hw=im_size
        )
        in_labels = np.ones(len(in_points), np.int32)
        if not self.use_m2m:
            # device fast path: the stability score and the threshold run
            # with the decode; only the bool masks and the scores come back
            masks, iou_preds, _, stability = self.predictor._predict_amg(
                in_points[:, None, :], in_labels[:, None],
                multimask_output=self.multimask_output,
                stability_offset=self.stability_score_offset,
                mask_threshold=self.mask_threshold,
            )
            m = masks.shape[1]
            data = MaskData(
                masks=masks.reshape(-1, *masks.shape[2:]),
                iou_preds=iou_preds.reshape(-1),
                points=np.repeat(np.asarray(points), m, axis=0),
                stability_score=stability.reshape(-1),
            )
            if self.pred_iou_thresh > 0.0:
                data.filter(data["iou_preds"] > self.pred_iou_thresh)
            if self.stability_score_thresh > 0.0:
                data.filter(data["stability_score"] >= self.stability_score_thresh)
        else:
            masks, iou_preds, low_res = self.predictor._predict(
                in_points[:, None, :], in_labels[:, None],
                multimask_output=self.multimask_output, return_logits=True,
            )
            m = masks.shape[1]
            data = MaskData(
                masks=masks.reshape(-1, *masks.shape[2:]),
                iou_preds=iou_preds.reshape(-1),
                points=np.repeat(np.asarray(points), m, axis=0),
                low_res_masks=low_res.reshape(-1, *low_res.shape[2:]),
            )
            in_points = self.predictor._transforms.transform_coords(
                data["points"], normalize=True, orig_hw=im_size
            )
            labels = np.ones(len(in_points), np.int32)
            masks, ious = self._refine_with_m2m(
                in_points, labels, data["low_res_masks"], self.points_per_batch
            )
            data["masks"] = masks[:, 0]
            data["iou_preds"] = ious[:, 0]
            if self.pred_iou_thresh > 0.0:
                data.filter(data["iou_preds"] > self.pred_iou_thresh)
            data["stability_score"] = calculate_stability_score(
                data["masks"], self.mask_threshold, self.stability_score_offset
            )
            if self.stability_score_thresh > 0.0:
                data.filter(data["stability_score"] >= self.stability_score_thresh)

        if data["masks"].dtype != np.bool_:
            data["masks"] = data["masks"] > self.mask_threshold
        data["boxes"] = batched_mask_to_box(data["masks"])
        keep = ~is_box_near_crop_edge(data["boxes"], crop_box,
                                      [0, 0, orig_w, orig_h])
        if not np.all(keep):
            data.filter(keep)
        data["masks"] = uncrop_masks(data["masks"], crop_box, orig_h, orig_w)
        data["rles"] = mask_to_rle(data["masks"])
        del data["masks"]
        return data

    def _refine_with_m2m(self, points, point_labels, low_res_masks,
                         points_per_batch):
        new_masks, new_ious = [], []
        for cur_p, cur_l, low in batch_iterator(
            points_per_batch, points, point_labels, low_res_masks
        ):
            m, iou, _ = self.predictor._predict(
                np.asarray(cur_p)[:, None, :], np.asarray(cur_l)[:, None],
                mask_input=np.asarray(low)[:, None],
                multimask_output=False, return_logits=True,
            )
            new_masks.append(m)
            new_ious.append(iou)
        return np.concatenate(new_masks), np.concatenate(new_ious)

    @staticmethod
    def postprocess_small_regions(mask_data: MaskData, min_area: int,
                                  nms_thresh: float) -> MaskData:
        """(automatic_mask_generator.py:367-415)."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed = remove_small_regions(mask, min_area, "holes")
            unchanged = not changed
            mask, changed = remove_small_regions(mask, min_area, "islands")
            unchanged = unchanged and not changed
            new_masks.append(mask[None])
            scores.append(float(unchanged))
        masks = np.concatenate(new_masks, axis=0)
        boxes = batched_mask_to_box(masks)
        keep = batched_nms(boxes.astype(np.float32), np.asarray(scores),
                           np.zeros(len(boxes), np.int64), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:
                mask_data["rles"][i] = mask_to_rle(masks[i : i + 1])[0]
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data
