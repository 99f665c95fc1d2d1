"""Semantic and instance segmentation evaluation on the host: the port's
copy of sam2unet_tpu/eval/metrics.py (reference eval.py:9-264).

Binarize at 0.1 * 255, global pixel IoU and Dice, instance matching at IoU
{0.5, 0.75} with greedy best-IoU assignment, dataset aggregation with
global precision, recall and F1 from per-image precision times count. One
label-pair histogram gives the intersection matrix; connected components
are 8-connected (skimage.label's default in the reference) through
scipy.ndimage. `print_eval_report` writes the reference's report block.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

IOU_THRESHOLDS = (0.5, 0.75)
SCORE_THRESHOLD = 0.1
SEMANTIC_IOU = "semantic_iou"
DICE_COEFFICIENT = "dice_coefficient"
COUNT_GT = "count_gt"
COUNT_PRED = "count_pred"
INSTANCE_PRECISION = "instance_precision"
INSTANCE_RECALL = "instance_recall"
INSTANCE_F1 = "instance_f1"
MIOU = "mIoU"
MDICE = "mDice"

_EIGHT = np.ones((3, 3), dtype=np.int32)


def label_components(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connectivity connected components; returns (labels, count)."""
    labels, num = ndimage.label(binary, structure=_EIGHT)
    return labels, int(num)


def _intersection_matrix(
    pred_label: np.ndarray, n_pred: int, gt_label: np.ndarray, n_gt: int
) -> np.ndarray:
    """inter[p, g] = |pred==p+1 & gt==g+1| via one 2-D histogram pass."""
    pair = pred_label.astype(np.int64) * (n_gt + 1) + gt_label.astype(np.int64)
    counts = np.bincount(pair.ravel(), minlength=(n_pred + 1) * (n_gt + 1))
    mat = counts.reshape(n_pred + 1, n_gt + 1)
    return mat[1:, 1:]


def evaluate_segmentation_performance(
    pred_mask: np.ndarray,
    gt_mask: np.ndarray,
    threshold: float = 255 * SCORE_THRESHOLD,
) -> dict[str, float]:
    """Per-image metrics; same keys/semantics as the reference
    (eval.py:55-169)."""
    if pred_mask.shape != gt_mask.shape:
        raise ValueError(
            f"Shape mismatch: Pred {pred_mask.shape} vs GT {gt_mask.shape}"
        )

    pred_bin = (pred_mask > threshold).astype(np.uint8)
    gt_bin = (gt_mask > threshold).astype(np.uint8)

    intersection = int(np.logical_and(pred_bin, gt_bin).sum())
    union = int(np.logical_or(pred_bin, gt_bin).sum())
    s_iou = intersection / union if union > 0 else 0.0
    denom = int(pred_bin.sum()) + int(gt_bin.sum())
    dice = (2 * intersection) / denom if denom > 0 else 0.0

    pred_label, n_pred = label_components(pred_bin)
    gt_label, n_gt = label_components(gt_bin)

    result = {
        SEMANTIC_IOU: s_iou,
        DICE_COEFFICIENT: dice,
        COUNT_GT: n_gt,
        COUNT_PRED: n_pred,
    }

    if n_pred and n_gt:
        inter = _intersection_matrix(pred_label, n_pred, gt_label, n_gt)
        area_p = np.bincount(pred_label.ravel(), minlength=n_pred + 1)[1:]
        area_g = np.bincount(gt_label.ravel(), minlength=n_gt + 1)[1:]
        union_m = area_p[:, None] + area_g[None, :] - inter
        iou_m = np.where(union_m > 0, inter / np.maximum(union_m, 1), 0.0)
    else:
        iou_m = np.zeros((n_pred, n_gt))

    for thresh in IOU_THRESHOLDS:
        tp = _greedy_tp(iou_m, thresh)
        precision = tp / n_pred if n_pred > 0 else 0.0
        recall = tp / n_gt if n_gt > 0 else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall) > 0
            else 0.0
        )
        suffix = int(thresh * 100)
        result[f"{INSTANCE_PRECISION}_{suffix}"] = precision
        result[f"{INSTANCE_RECALL}_{suffix}"] = recall
        result[f"{INSTANCE_F1}_{suffix}"] = f1

    return result


def _greedy_tp(iou_m: np.ndarray, thresh: float) -> int:
    """Greedy best-IoU matching with the reference's exact semantics
    (eval.py:124-152): preds claim gts in pred-index order, each taking the
    still-unmatched gt with the highest IoU (ties -> lowest gt index, the
    strict-`>` scan's behavior), counted as TP when that IoU >= thresh.

    The match sequence is sequential through the matched set, so the pred
    loop stays Python — but the per-pred scan is one masked argmax, taking
    the inner loop from O(G) interpreted steps to a single C pass. Dense
    instance maps (hundreds of components, AMG-style) go from O(P*G)
    Python to O(P) Python."""
    n_pred, n_gt = iou_m.shape
    avail = np.ones(n_gt, dtype=bool)
    tp = 0
    for p in range(n_pred):
        row = np.where(avail, iou_m[p], 0.0)
        g = int(np.argmax(row)) if n_gt else -1
        if g >= 0 and row[g] >= thresh and row[g] > 0.0:
            tp += 1
            avail[g] = False
    return tp


def evaluate_dataset(all_image_results: list[dict[str, float]]) -> dict:
    """Dataset aggregation, identical to eval.py:172-225."""
    if not all_image_results:
        return {}

    mean_iou = float(np.mean([r[SEMANTIC_IOU] for r in all_image_results]))
    mean_dice = float(np.mean([r[DICE_COEFFICIENT] for r in all_image_results]))
    total_gt = sum(r[COUNT_GT] for r in all_image_results)
    total_pred = sum(r[COUNT_PRED] for r in all_image_results)

    final = {MIOU: mean_iou, MDICE: mean_dice, "images_count": total_gt}
    for thresh in IOU_THRESHOLDS:
        suffix = int(thresh * 100)
        total_tp = sum(
            r[f"{INSTANCE_PRECISION}_{suffix}"] * r[COUNT_PRED]
            for r in all_image_results
        )
        precision = total_tp / total_pred if total_pred > 0 else 0.0
        recall = total_tp / total_gt if total_gt > 0 else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if (precision + recall) > 0
            else 0.0
        )
        final[f"Precision_{suffix}"] = precision
        final[f"Recall_{suffix}"] = recall
        final[f"F1_Score_{suffix}"] = f1
    return final


def print_eval_report(results: dict, title: str = "Evaluation Results",
                      log_path: str | None = None) -> str:
    """Formatted report block, byte-compatible with the reference's; appended
    to `log_path` when given."""
    width = max(len(title) + 2, 25)
    report = [f"\n{'=' * width}", f"{title:^{width}}", f"{'-' * width}"]
    for metric, value in results.items():
        display = metric.replace("_", " ")
        if isinstance(value, float):
            report.append(f"{display:<{width - 8}}: {value:>6.4f}")
        else:
            report.append(f"{display:<{width - 8}}: {value:>6}")
    report.append(f"{'=' * width}\n")
    full = "\n".join(report)
    print(full)
    if log_path:
        with open(log_path, "a") as f:
            f.write(full)
    return full
