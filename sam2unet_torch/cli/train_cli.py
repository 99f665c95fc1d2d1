"""Training entry point, flag-compatible with the JAX package's train CLI
(sam2unet_tpu/cli/train_cli.py:35-80, itself the reference train.py's
flags) plus --device: per epoch, the train steps (bf16 compute over fp32
master parameters with --bf16), then device evaluation with the IoU-gated
checkpoint policy and the reference's log.txt report. Its defaults are the
fork's operating point, hiera_s at 960 with batch 16.

    python -m sam2unet_torch.cli.train_cli --save_path run/ --bf16 \
        --train_image_path train/images/ --train_mask_path train/masks/ \
        --test_image_path test/images/ --test_gt_path test/masks/ \
        [--size 352 --model_cfg sam2_hiera_l] [--remat] \
        [--save_train_state] [--resume run/<snapshot>_train_state]

--remat recomputes each trunk block in the backward (less memory, more
time). --save_train_state writes `<snapshot>_train_state` beside each
snapshot (model, AdamW moments, epochs and steps done), and --resume
continues from such a file: the epoch count and the optimizer go on where
they stopped, and the cosine schedule, a function of the epoch and this
run's --lr and --epoch, with them.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from sam2unet_torch.cli.common import build_model, load_weights, resolve_device
from sam2unet_torch.configs import hiera_config
from sam2unet_torch.data.dataset import EvalDataset, TrainDataset
from sam2unet_torch.eval.metrics import MIOU, print_eval_report
from sam2unet_torch.models.hiera import unported_train_backward
from sam2unet_torch.models.sam2unet import cast_frozen
from sam2unet_torch.train.checkpoints import (
    CheckpointPolicy,
    restore_train_state,
    save_train_state,
)
from sam2unet_torch.train.engine import evaluate, fp32_state_dict, train_step
from sam2unet_torch.train.optim import cosine_lr, make_optimizer, set_lr

# flags of the JAX CLI that the port does not run yet, and the ROADMAP.md
# item that will port each
UNPORTED = {
    "full_eval": "queue 1 item 6 (the host evaluator, eval/metrics.py)",
    "shard_map": "queue 1 item 12 (parallelism)",
    "profile_dir": "queue 1 item 13 (tooling)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SAM2-UNet (PyTorch/CUDA)")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--hiera_path", type=str, default="",
                   help="path to the sam2 pretrained hiera (.pt)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="SAM2-UNet checkpoint (.pth state dict)")
    p.add_argument("--train_image_path", type=str, required=True)
    p.add_argument("--train_mask_path", type=str, required=True)
    p.add_argument("--test_image_path", type=str, required=True)
    p.add_argument("--test_gt_path", type=str, required=True)
    p.add_argument("--epoch", type=int, default=500)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--batch_size", default=16, type=int)
    p.add_argument("--size", default=960, type=int)
    p.add_argument("--weight_decay", default=5e-4, type=float)
    p.add_argument("--save_interval", default=20, type=int)
    p.add_argument("--base_mean_iou", default=0.83, type=float)
    p.add_argument("--model_cfg", type=str, default="sam2_hiera_s")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 params, loss and statistics)")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing per trunk block")
    p.add_argument("--eval_batch_size", type=int, default=0,
                   help="0 = same as batch_size")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--fast_eval", action="store_true",
                   help="deprecated: device-side semantic eval is the default")
    p.add_argument("--full_eval", action="store_true", help="not ported yet")
    p.add_argument("--shard_map", action="store_true", help="not ported yet")
    p.add_argument("--profile_dir", type=str, default="",
                   help="not ported yet")
    p.add_argument("--resume", type=str, default="",
                   help="train state file to resume from (optimizer, "
                        "epoch and step included; the reference "
                        "restarts them)")
    p.add_argument("--save_train_state", action="store_true",
                   help="also save the full train state beside each snapshot")
    p.add_argument("--device", default="cuda", type=str)
    return p


def check_ported(model_cfg: str, size: int, device: torch.device) -> None:
    """Exit where training this trunk at this size on the card would reach
    a backward kernel not ported yet (none of the shipped trunks does: the
    trunk is frozen, and hiera_s@960's long global blocks train through
    K11)."""
    gaps = unported_train_backward(hiera_config(model_cfg), size)
    if device.type == "cuda" and gaps:
        raise SystemExit(
            f"training {model_cfg} at --size {size} on the card needs "
            f"backward kernels sam2unet_torch has not ported yet (ROADMAP.md "
            f"open item 1): {'; '.join(gaps)}")


def main(args) -> dict:
    for flag, item in UNPORTED.items():
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not ported to sam2unet_torch yet "
                             f"(ROADMAP.md {item})")
    device = resolve_device(args.device)
    check_ported(args.model_cfg, args.size, device)
    dataset = TrainDataset(args.train_image_path, args.train_mask_path,
                           args.size)
    if len(dataset) == 0:
        raise SystemExit(f"no training images found under "
                         f"{args.train_image_path!r} (masks: "
                         f"{args.train_mask_path!r})")
    test_data = EvalDataset(args.test_image_path, args.test_gt_path, args.size)

    model = build_model(args.model_cfg, torch.device("cpu"), remat=args.remat)
    load_weights(model, args.hiera_path, args.checkpoint)
    # the frozen weights as loaded (fp32, on the CPU): checkpoints save these
    masters = {n: p.detach() for n, p in model.named_parameters()
               if not p.requires_grad}
    model = model.to(device)
    if args.bf16:
        cast_frozen(model, torch.bfloat16)
    optimizer = make_optimizer(model, args.lr, args.weight_decay)
    eval_bs = args.eval_batch_size or args.batch_size
    os.makedirs(args.save_path, exist_ok=True)
    log_path = os.path.join(args.save_path, "log.txt")
    policy = CheckpointPolicy(args.save_path, args.base_mean_iou,
                              args.save_interval, args.epoch)

    losses, saved, steps, eval_forwards = [], [], 0, 0
    start_epoch = steps_before = 0
    if args.resume:
        start_epoch, steps_before = restore_train_state(
            args.resume, model, optimizer, masters)
        print(f"Resumed full train state from {args.resume} (epoch "
              f"{start_epoch}, step {steps_before})")
    for epoch in range(start_epoch, args.epoch):
        print("Training:")
        set_lr(optimizer, cosine_lr(args.lr, epoch, args.epoch))
        t_epoch = time.perf_counter()
        n_imgs, epoch_losses = 0, []
        for i, batch in enumerate(dataset.epoch(args.batch_size, epoch,
                                                num_workers=args.num_workers)):
            images = torch.from_numpy(batch.image).to(device)
            labels = torch.from_numpy(batch.label).to(device)
            loss = train_step(model, optimizer, images, labels)
            epoch_losses.append(loss)
            n_imgs += batch.valid
            steps += 1
            if i % 10 == 0:
                print(f"epoch-{epoch + 1}-{i + 1}: loss:{float(loss)}")
        epoch_losses = torch.stack(epoch_losses).float().cpu().tolist()
        losses += epoch_losses
        epoch_loss = epoch_losses[-1]
        dt = time.perf_counter() - t_epoch
        print(f"epoch-{epoch + 1}: {n_imgs} imgs in {dt:.1f}s "
              f"({n_imgs / max(dt, 1e-9):.2f} img/s, host clock)")

        print("Evaluating", end="")
        t_eval = time.perf_counter()
        result, forwards = evaluate(model, test_data, eval_bs, args.size,
                                    device)
        eval_forwards += forwards
        print(f"\nepoch-{epoch + 1} eval: {test_data.count} imgs in "
              f"{time.perf_counter() - t_eval:.1f}s (device path)")
        print_eval_report(result, title=f"epoch-{epoch + 1}_loss-{epoch_loss:.3f}",
                          log_path=log_path)
        out = policy.maybe_save(epoch + 1, epoch_loss, result[MIOU],
                                lambda: fp32_state_dict(model, masters))
        if out:
            saved.append(out)
            if args.save_train_state:
                save_train_state(out + "_train_state",
                                 fp32_state_dict(model, masters), optimizer,
                                 epoch + 1, steps_before + steps)
    return {"steps": steps, "eval_forwards": eval_forwards, "losses": losses,
            "saved": saved, "log": log_path, "start_epoch": start_epoch,
            "global_step": steps_before + steps}


def run() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    run()
