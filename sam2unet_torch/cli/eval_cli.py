"""Offline evaluator, flag-compatible with the reference eval.py:228-264
(the JAX package's cli/eval_cli.py): compares saved prediction PNGs with
the ground-truth masks on the host and appends each image's report and the
dataset's to <pred_path>/log.txt.

    python -m sam2unet_torch.cli.eval_cli --pred_path preds/ --gt_path masks/
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from sam2unet_torch.eval.metrics import (
    evaluate_dataset,
    evaluate_segmentation_performance,
    print_eval_report,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--pred_path", type=str, required=True)
    p.add_argument("--gt_path", type=str, required=True)
    return p


def main(args) -> dict:
    gt_list = sorted(os.listdir(args.gt_path))
    log_path = os.path.join(args.pred_path, "log.txt")
    results = []
    for i, mask_name in enumerate(gt_list):
        title = f"[{i + 1}/{len(gt_list)}] {mask_name}"
        gt = np.asarray(Image.open(os.path.join(args.gt_path, mask_name))
                        .convert("L"))
        pred_file = os.path.join(args.pred_path, mask_name[:-4] + ".png")
        pred = np.asarray(Image.open(pred_file).convert("L"))
        result = evaluate_segmentation_performance(pred, gt)
        print_eval_report(result, title=title, log_path=log_path)
        results.append(result)
    final = evaluate_dataset(results)
    print_eval_report(final, title="Segmentation Evaluation", log_path=log_path)
    return final


def run() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    run()
