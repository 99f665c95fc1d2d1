"""Deployed-model inference harness, flag-compatible with the JAX package's
test_exported.py (the reference test_onnx.py analog), plus --device: runs
an exported artifact over a test set with `SamUnetSegmenter`, saves the
uint8 masks as PNGs, evaluates them against the GT masks when given, and
prints the mean time per image.

    python -m sam2unet_torch.cli.deploy_cli --model_path model.pt2 \
        --test_image_path imgs/ --test_gt_path masks/ --save_path out/ \
        [--backend onnx --model_path model.onnx] [--device cpu]

--device is where the `torch_export` program runs (it must be the device
it was exported on); the onnx backend runs on the host (onnxruntime where
installed, else the numpy runner; the line "onnx runtime:" says which).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
from PIL import Image

from sam2unet_torch.cli.common import resolve_device
from sam2unet_torch.deploy.segmenter import BACKENDS, SamUnetSegmenter
from sam2unet_torch.eval.metrics import (
    evaluate_dataset,
    evaluate_segmentation_performance,
    print_eval_report,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--model_path", type=str, required=True)
    p.add_argument("--test_image_path", type=str, required=True)
    p.add_argument("--test_gt_path", type=str, default="")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--size", type=int, default=960)
    p.add_argument("--backend", default="torch_export", choices=BACKENDS)
    p.add_argument("--device", default="cuda", type=str)
    return p


def main(args) -> dict:
    device = resolve_device(args.device)
    seg = SamUnetSegmenter(args.model_path, input_size=args.size,
                           backend=args.backend, device=device)
    if seg.onnx_runtime:
        print(f"onnx runtime: {seg.onnx_runtime}")
    os.makedirs(args.save_path, exist_ok=True)
    names = sorted(f for f in os.listdir(args.test_image_path)
                   if f.endswith((".jpg", ".png")))
    results, times, process_times = [], [], []
    log_path = os.path.join(args.save_path, "log.txt")
    start = time.perf_counter()
    for i, name in enumerate(names):
        image = np.asarray(Image.open(
            os.path.join(args.test_image_path, name)).convert("RGB"))
        t0 = time.perf_counter()
        mask = seg.segment(image)
        times.append(time.perf_counter() - t0)
        process_times.append(seg.last_process_time)
        out_name = os.path.splitext(name)[0] + ".png"
        Image.fromarray(mask).save(os.path.join(args.save_path, out_name))
        if args.test_gt_path:
            gt = np.asarray(Image.open(
                os.path.join(args.test_gt_path, out_name)).convert("L"))
            r = evaluate_segmentation_performance(mask, gt)
            print_eval_report(r, title=f"[{i + 1}/{len(names)}] {name}",
                              log_path=log_path)
            results.append(r)
    seconds = time.perf_counter() - start
    report = None
    if results:
        report = evaluate_dataset(results)
        print_eval_report(report, title="Segmentation Evaluation",
                          log_path=log_path)
    if times:
        print(f"average process_time: {sum(times) / len(times):.4f}s")
    return {"images": len(names), "times": times,
            "process_times": process_times, "seconds": seconds,
            "report": report, "onnx_runtime": seg.onnx_runtime,
            "segmenter": seg}


def run() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    run()
