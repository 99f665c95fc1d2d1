"""Training entry point, flag-compatible with the JAX package's train CLI
(sam2unet_tpu/cli/train_cli.py:35-80, itself the reference train.py's
flags) plus --device: per epoch, the train steps (bf16 compute over fp32
master parameters with --bf16), then evaluation with the IoU-gated
checkpoint policy and the reference's log.txt report. Its defaults are the
fork's operating point, hiera_s at 960 with batch 16.

    python -m sam2unet_torch.cli.train_cli --save_path run/ --bf16 \
        --train_image_path train/images/ --train_mask_path train/masks/ \
        --test_image_path test/images/ --test_gt_path test/masks/ \
        [--size 352 --model_cfg sam2_hiera_l] [--remat] \
        [--save_train_state] [--resume run/SAM2-UNet_epoch-latest_train_state] \
        [--full_eval] [--profile_dir trace/]
    torchrun --nproc_per_node N -m sam2unet_torch.cli.train_cli ...

Under torchrun the run is data-parallel over its N ranks, as the JAX CLI
is over its devices (`parallel/mesh.py`): --batch_size and
--eval_batch_size are global and must divide by N, each rank trains on its
rows of every batch with the neck's and decoder's BatchNorms synchronised
(SyncBN) and the gradients averaged; only rank 0 writes log.txt, the
snapshots, the train states and the profiler trace. --shard_map is the
JAX CLI's flag for that form and changes nothing here.

--remat recomputes each trunk block in the backward (less memory, more
time). --save_train_state writes the train state beside each snapshot
(model, AdamW moments, steps done) as the JAX CLI does: its TrainState
directory `<snapshot without .pth>_train_state`, which either CLI resumes.
--resume takes such a directory, the JAX CLI's or this one's, or this
package's older single-file train state `<snapshot>_train_state`, and then
does what the JAX CLI does: it
trains --epoch epochs from epoch 0 (the same shuffles, the same checkpoint
epochs), each step at the cosine schedule's rate at the global step (the
saved step plus this run's), held at its last value past --epoch epochs.
The evaluation runs on the device at
model resolution (mIoU and mDice against the letterboxed GT), or with
--full_eval on the host as the reference does: each image's logits cropped
and resized to its GT's resolution, binarized, and scored for semantic and
instance metrics (`eval/metrics.py`); the checkpoint gate reads mIoU
either way. --profile_dir writes a torch.profiler trace (CPU and CUDA
activities, Chrome JSON) of this run's steps 10-14 into the directory, or
of the steps from 10 on if the run ends first.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from sam2unet_torch.cli.common import (
    build_model,
    load_weights,
    postprocess_prediction,
    resolve_device,
)
from sam2unet_torch.data.dataset import EvalDataset, TrainDataset
from sam2unet_torch.eval.metrics import (
    MIOU,
    evaluate_dataset,
    evaluate_segmentation_performance,
    print_eval_report,
)
from sam2unet_torch.models.sam2unet import cast_frozen
from sam2unet_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    rank_and_world,
    replicate,
    rows,
    shard_batch,
)
from sam2unet_torch.train.checkpoints import (
    CheckpointPolicy,
    jax_train_state_path,
    restore_train_state,
    save_jax_train_state,
)
from sam2unet_torch.train.engine import (
    eval_logits,
    evaluate,
    fp32_state_dict,
    train_step,
)
from sam2unet_torch.train.optim import cosine_step_lr, make_optimizer, set_lr

# the profiled steps of a run, as the JAX CLI's trace window
PROFILE_STEPS = (10, 15)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("SAM2-UNet (PyTorch/CUDA)")
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--hiera_path", type=str, default="",
                   help="path to the sam2 pretrained hiera (.pt)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="SAM2-UNet checkpoint: a .pth state dict or an "
                        "Orbax directory the JAX train CLI saved")
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
    p.add_argument("--full_eval", action="store_true",
                   help="reference-style host eval: per-image un-pad + resize "
                        "to GT resolution, semantic AND instance metrics "
                        "(train.py:89-123). Slower; the default device eval "
                        "computes mIoU/mDice at model resolution -- the "
                        "checkpoint gate uses mIoU only either way")
    p.add_argument("--shard_map", action="store_true",
                   help="the JAX CLI's shard_map step; here every run over "
                        "more than one rank is that step (per-rank local "
                        "programs, SyncBN, averaged gradients), because the "
                        "JAX GSPMD step also normalises over the global "
                        "batch: the flag changes no number")
    p.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of steps 10-14 here")
    p.add_argument("--resume", type=str, default="",
                   help="train state to resume from: a JAX TrainState "
                        "directory or this package's file (optimizer and "
                        "step included; the reference restarts them). As "
                        "in the JAX CLI, the run then trains --epoch epochs "
                        "from epoch 0 at the schedule's rate from the "
                        "saved step on")
    p.add_argument("--save_train_state", action="store_true",
                   help="also save the full train state beside each "
                        "snapshot, as the JAX CLI's TrainState directory")
    p.add_argument("--device", default="cuda", type=str)
    return p


def full_evaluate(model, test_data: EvalDataset, batch_size: int, size: int,
                  device: torch.device) -> tuple[dict, int]:
    """The JAX CLI's host evaluation (cli/train_cli.py:235-251 there): per
    image the logits on the host, the test postprocess at GT resolution
    (`postprocess_prediction`), the per-image metrics, then the dataset's.
    Its "images_count" is the GT instance count (the reference's quirk).
    Across ranks each scores its rows of the global batch and every rank
    gathers all the images' metrics, in order. Returns (report dict,
    forwards run)."""
    mesh = Mesh(*rank_and_world(), device)
    own = rows(batch_size, mesh)
    results, forwards = [], 0
    for bi, eb in enumerate(test_data.batches(batch_size)):
        logits = eval_logits(model, shard_batch(mesh, eb["image"]))
        logits = logits.float().cpu().numpy()
        forwards += 1
        for j in range(own.start, min(own.stop, eb["valid"])):
            res = postprocess_prediction(logits[j - own.start: j - own.start + 1],
                                         eb["padding"][j], size,
                                         eb["gt"][j].shape)
            results.append((bi * batch_size + j, evaluate_segmentation_performance(
                res, eb["gt"][j])))
            if (bi * batch_size + j) % 10 == 0:
                print(".", end="", flush=True)
    if mesh.world > 1:
        parts = [None] * mesh.world
        dist.all_gather_object(parts, results)
        results = sorted((r for part in parts for r in part),
                         key=lambda r: r[0])
    return evaluate_dataset([r for _, r in results]), forwards


def start_profile(device: torch.device) -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof: torch.profiler.profile, out_dir: str, first: int,
                 last: int, device: torch.device) -> str:
    """Stop the trace after the queued work and write it as Chrome JSON."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"train_steps_{first}-{last}.pt.trace.json")
    prof.export_chrome_trace(path)
    return path


def main(args) -> dict:
    device = resolve_device(args.device)
    owns_group = not dist.is_initialized()
    mesh = make_mesh(device)
    try:
        return _train(args, mesh)
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, mesh: Mesh) -> dict:
    lead = mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    dataset = TrainDataset(args.train_image_path, args.train_mask_path,
                           args.size)
    if len(dataset) == 0:
        raise SystemExit(f"no training images found under "
                         f"{args.train_image_path!r} (masks: "
                         f"{args.train_mask_path!r})")
    test_data = EvalDataset(args.test_image_path, args.test_gt_path, args.size)
    eval_bs = args.eval_batch_size or args.batch_size
    for nm, bs in (("--batch_size", args.batch_size),
                   ("--eval_batch_size", eval_bs)):
        if bs % mesh.world:
            raise SystemExit(
                f"{nm}={bs} is not divisible by the {mesh.world}-device data "
                "axis; pick a multiple so batches shard evenly (a partial "
                "shard would otherwise fail AFTER the first epoch trains)")
    if mesh.world > 1:
        say(f"[train] data parallel over {mesh.world} ranks "
            f"({dist.get_backend()}), {args.batch_size // mesh.world} rows "
            f"each, SyncBN")

    model = build_model(args.model_cfg, torch.device("cpu"), remat=args.remat)
    load_weights(model, args.hiera_path, args.checkpoint)
    model = replicate(mesh, model.to(mesh.device))
    # the frozen weights as loaded (fp32, on the CPU): checkpoints save these
    masters = {n: p.detach().cpu() for n, p in model.named_parameters()
               if not p.requires_grad}
    if args.bf16:
        cast_frozen(model, torch.bfloat16)
    optimizer = make_optimizer(model, args.lr, args.weight_decay)
    steps_per_epoch = max(1, -(-len(dataset) // args.batch_size))
    log_path = os.path.join(args.save_path, "log.txt")
    if lead:
        policy = CheckpointPolicy(args.save_path, args.base_mean_iou,
                                  args.save_interval, args.epoch)

    losses, lrs, saved, steps, eval_forwards = [], [], [], 0, 0
    reports, epoch_seconds, eval_seconds = [], [], []
    prof = trace = None
    steps_before = 0
    if args.resume:
        steps_before = restore_train_state(args.resume, model, optimizer,
                                           masters)
        say(f"Resumed full train state from {args.resume} "
            f"(step {steps_before})")
    own_rows = rows(args.batch_size, mesh)
    for epoch in range(args.epoch):
        say("Training:")
        t_epoch = time.perf_counter()
        n_imgs, epoch_losses = 0, []
        for i, batch in enumerate(dataset.epoch(args.batch_size, epoch,
                                                num_workers=args.num_workers,
                                                rows=own_rows)):
            lrs.append(cosine_step_lr(args.lr, steps_before + steps,
                                      args.epoch, steps_per_epoch))
            set_lr(optimizer, lrs[-1])
            if lead and args.profile_dir and steps == PROFILE_STEPS[0]:
                prof = start_profile(mesh.device)
            images = torch.from_numpy(batch.image).to(mesh.device)
            labels = torch.from_numpy(batch.label).to(mesh.device)
            loss = train_step(model, optimizer, images, labels)
            epoch_losses.append(loss)
            n_imgs += batch.valid
            steps += 1
            if prof is not None and steps == PROFILE_STEPS[1]:
                trace = stop_profile(prof, args.profile_dir, PROFILE_STEPS[0],
                                     steps - 1, mesh.device)
                prof = None
                say(f"profiler trace written to {args.profile_dir}")
            if i % 10 == 0:
                say(f"epoch-{epoch + 1}-{i + 1}: loss:{float(loss)}")
        if prof is not None:
            # the run ended before the window filled: flush what there is
            trace = stop_profile(prof, args.profile_dir, PROFILE_STEPS[0],
                                 steps - 1, mesh.device)
            prof = None
            say(f"profiler trace (short run) written to {args.profile_dir}")
        epoch_losses = torch.stack(epoch_losses).float().cpu().tolist()
        losses += epoch_losses
        epoch_loss = epoch_losses[-1]
        dt = time.perf_counter() - t_epoch
        epoch_seconds.append(dt)
        say(f"epoch-{epoch + 1}: {n_imgs} imgs in {dt:.1f}s "
            f"({n_imgs / max(dt, 1e-9):.2f} img/s, host clock)")

        say("Evaluating", end="")
        t_eval = time.perf_counter()
        run_eval = full_evaluate if args.full_eval else evaluate
        result, forwards = run_eval(model, test_data, eval_bs, args.size,
                                    mesh.device)
        eval_forwards += forwards
        eval_seconds.append(time.perf_counter() - t_eval)
        reports.append(result)
        if not lead:
            continue
        # with --full_eval "images_count" is the GT instance count (the
        # reference's quirk): report the real images here
        print(f"\nepoch-{epoch + 1} eval: {test_data.count} imgs in "
              f"{eval_seconds[-1]:.1f}s "
              f"({'host' if args.full_eval else 'device'} path)")
        print_eval_report(result, title=f"epoch-{epoch + 1}_loss-{epoch_loss:.3f}",
                          log_path=log_path)
        out = policy.maybe_save(epoch + 1, epoch_loss, result[MIOU],
                                lambda: fp32_state_dict(model, masters))
        if out:
            saved.append(out)
            if args.save_train_state:
                save_jax_train_state(jax_train_state_path(out),
                                     fp32_state_dict(model, masters), model,
                                     optimizer, steps_before + steps)
    if mesh.world > 1:
        dist.barrier()   # rank 0's files are written when every rank returns
    return {"steps": steps, "eval_forwards": eval_forwards, "losses": losses,
            "lrs": lrs, "saved": saved, "log": log_path if lead else None,
            "rank": mesh.rank, "world": mesh.world,
            "global_step": steps_before + steps, "reports": reports,
            "epoch_seconds": epoch_seconds, "eval_seconds": eval_seconds,
            "trace": trace}


def run() -> None:
    main(build_parser().parse_args())


if __name__ == "__main__":
    run()
