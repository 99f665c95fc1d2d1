"""Inference entry point, flag-compatible with the reference test.py:13-35
(plus --device): predict -> crop letterbox padding -> resize to GT size ->
sigmoid -> min-max -> uint8 PNG, with the mean time per image.

    python -m sam2unet_torch.cli.test_cli --checkpoint model.pth \
        --test_image_path imgs/ --test_gt_path masks/ --save_path out/ \
        --size 352 --model_cfg sam2_hiera_l --bf16 --batch_size 4
"""

from __future__ import annotations

import argparse
import os
import time

import torch
from PIL import Image

from sam2unet_torch.cli.common import (
    build_model,
    load_checkpoint,
    postprocess_prediction,
    resolve_device,
)
from sam2unet_torch.data.dataset import EvalDataset


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, required=True)
    p.add_argument("--test_image_path", type=str, required=True)
    p.add_argument("--test_gt_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--size", default=960, type=int)
    p.add_argument("--model_cfg", type=str, default="sam2_hiera_s")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--batch_size", default=1, type=int,
                   help="images per forward (the tail batch is padded)")
    p.add_argument("--device", default="cuda", type=str)
    return p


def main(args) -> dict:
    device = resolve_device(args.device)
    loader = EvalDataset(args.test_image_path, args.test_gt_path, args.size)
    model = build_model(args.model_cfg, torch.device("cpu"))
    load_checkpoint(model, args.checkpoint)
    model = model.to(device=device,
                     dtype=torch.bfloat16 if args.bf16 else torch.float32)
    os.makedirs(args.save_path, exist_ok=True)
    cuda = device.type == "cuda"

    times, forwards = [], 0
    with torch.inference_mode():
        for eb in loader.batches(args.batch_size):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            else:
                t0 = time.perf_counter()
            x = torch.from_numpy(eb["image"]).to(device)
            logits = model(x)[0]
            if cuda:
                end.record()
                end.synchronize()
                seconds = start.elapsed_time(end) / 1000.0
            else:
                seconds = time.perf_counter() - t0
            forwards += 1
            times.append(seconds / eb["valid"])
            logits = logits.float().cpu().numpy()
            for j in range(eb["valid"]):
                res = postprocess_prediction(logits[j: j + 1], eb["padding"][j],
                                             args.size, eb["gt"][j].shape)
                name = os.path.splitext(eb["name"][j])[0] + ".png"
                print("Saving " + os.path.join(args.save_path, name))
                Image.fromarray(res).save(os.path.join(args.save_path, name))

    mean = None
    if times:
        steady = times[1:] or times
        mean = sum(steady) / len(steady)
        clock = "CUDA events" if cuda else "host clock"
        print(f"mean_test_time: {mean:.4f}s per image ({clock}, {device}; "
              f"first batch {times[0]:.4f}s per image incl. kernel build)")
    return {"forwards": forwards, "mean_test_time": mean,
            "images": loader.count}


def run() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    run()
