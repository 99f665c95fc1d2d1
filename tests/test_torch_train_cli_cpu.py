"""The port's train CLI end to end on the CPU (`--device cpu`), in the
manner of tests/test_cli_e2e.py: the `hiera_test` trunk at --size 64 on a
small synthetic dataset, two epochs. It writes log.txt with the epoch
reports and a checkpoint that the port's test CLI loads strictly and runs;
the frozen trunk comes back bit-identical, the trainable set changed. Also:
--save_train_state writes the JAX CLI's train state directory and
--resume trains --epoch
epochs from it as the JAX CLI does (every epoch from 0, the rate of the
global step), --remat trains to the same losses, --shard_map changes no
number at world 1, the defaults (hiera_s@960) pass the card's gate, and
--hiera_path loads a SAM2 trunk through the port's own key rules."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.cli import test_cli, train_cli
from sam2unet_torch.cli.common import build_model, load_weights
from sam2unet_torch.data.dataset import TrainDataset
from sam2unet_torch.train.checkpoints import (
    jax_train_state_path,
    restore_train_state,
)
from sam2unet_torch.train.loss import multi_head_loss
from sam2unet_torch.train.optim import (
    ETA_MIN,
    cosine_lr,
    cosine_step_lr,
    is_trainable,
    make_optimizer,
)

SIZE, CFG = 64, "hiera_test"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own thread pool would oversubscribe
    them and a small train step would take seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_split(root, n, rng):
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(48, 96)), int(rng.integers(48, 96))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        mask = ((yy - h // 2) ** 2 + (xx - w // 2) ** 2 < (min(h, w) // 4) ** 2)
        mask = mask.astype(np.uint8) * 255
        img[mask > 0] = (img[mask > 0] * 0.3 + 170).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"s{i}.jpg")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.default_rng(0)
    _write_split(root / "train", 6, rng)
    _write_split(root / "test", 3, rng)
    torch.manual_seed(0)
    start = build_model(CFG, torch.device("cpu")).state_dict()
    torch.save(start, root / "start.pth")
    argv = ["--save_path", str(root / "out"), "--checkpoint", str(root / "start.pth"),
            "--train_image_path", str(root / "train" / "images"),
            "--train_mask_path", str(root / "train" / "masks"),
            "--test_image_path", str(root / "test" / "images"),
            "--test_gt_path", str(root / "test" / "masks"),
            "--epoch", "2", "--batch_size", "4", "--size", str(SIZE),
            "--model_cfg", CFG, "--save_interval", "1", "--num_workers", "2",
            "--device", "cpu"]
    stats = train_cli.main(train_cli.build_parser().parse_args(argv))
    return root, start, stats, argv


def test_train_cli_runs_two_epochs(run):
    _, _, stats, _ = run
    assert stats["steps"] == 4 and stats["eval_forwards"] == 2
    assert len(stats["losses"]) == 4
    assert all(np.isfinite(stats["losses"]))


def test_train_cli_writes_the_epoch_reports(run):
    root, _, stats, _ = run
    log = (root / "out" / "log.txt").read_text()
    assert "epoch-1_loss-" in log and "epoch-2_loss-" in log
    assert log.count("mIoU") == 2 and log.count("mDice") == 2


def test_checkpoint_keeps_the_frozen_trunk_and_moves_the_trainable_set(run):
    root, start, stats, _ = run
    assert stats["saved"] and all(p.endswith(".pth") for p in stats["saved"])
    saved = torch.load(stats["saved"][-1], weights_only=True)
    assert saved.keys() == start.keys()
    params = {n for n, _ in build_model(CFG, torch.device("cpu")).named_parameters()}
    trainable = {n for n in params if is_trainable(n)}
    assert trainable and trainable < params
    for k in params:
        same = torch.equal(saved[k], start[k])
        assert same == (k not in trainable), k


def test_the_test_cli_loads_the_checkpoint_strictly(run, tmp_path):
    root, _, stats, _ = run
    args = test_cli.build_parser().parse_args([
        "--checkpoint", stats["saved"][-1],
        "--test_image_path", str(root / "test" / "images"),
        "--test_gt_path", str(root / "test" / "masks"),
        "--save_path", str(tmp_path), "--size", str(SIZE),
        "--model_cfg", CFG, "--batch_size", "2", "--device", "cpu"])
    out = test_cli.main(args)
    assert out["images"] == 3 and out["forwards"] == 2
    assert len(list(tmp_path.glob("*.png"))) == 3


def test_shard_map_changes_no_number(run, tmp_path):
    """--shard_map is the JAX CLI's flag for the per-rank step with SyncBN;
    every run over ranks is that step here, so at world 1 the flag trains
    to the same losses as the run without it."""
    _, _, stats, argv = run
    argv = list(argv)
    argv[argv.index("--save_path") + 1] = str(tmp_path)
    argv[argv.index("--epoch") + 1] = "1"
    got = train_cli.main(train_cli.build_parser().parse_args(
        argv + ["--shard_map"]))
    assert got["world"] == 1 and got["steps"] == 2
    np.testing.assert_array_equal(got["losses"], stats["losses"][:2])


def test_the_train_cli_defaults_to_the_card():
    args = train_cli.build_parser().parse_args(
        ["--save_path", "a", "--train_image_path", "b", "--train_mask_path", "c",
         "--test_image_path", "d", "--test_gt_path", "e"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_cli.main(args)


def test_the_train_cli_defaults_parse_and_build_without_a_gate():
    """Its defaults, hiera_s@960 at batch 16, parse and build on the CPU;
    no gate stands between them and the card (every backward the trunk
    can take is ported), and the trainable set is the adapters, neck and
    decoder."""
    args = train_cli.build_parser().parse_args(
        ["--save_path", "a", "--train_image_path", "b", "--train_mask_path", "c",
         "--test_image_path", "d", "--test_gt_path", "e"])
    assert (args.model_cfg, args.size, args.batch_size) == ("sam2_hiera_s", 960, 16)
    assert not hasattr(train_cli, "check_ported")
    model = build_model(args.model_cfg, torch.device("cpu"))
    assert model.encoder.cfg.embed_dim == 96
    trainable = {n.split(".")[0] for n, p in model.named_parameters()
                 if p.requires_grad}
    assert "encoder" in trainable and "rfb1" in trainable
    assert all("prompt_learn" in n for n, p in model.encoder.named_parameters()
               if p.requires_grad)


@pytest.fixture(scope="module")
def resumed(run, tmp_path_factory):
    """Three epochs without a stop, keeping the train state beside each
    snapshot (a base mIoU of -1 makes epoch 1 a best snapshot, whose files
    later epochs do not overwrite); then a second run resumed from the state
    after epoch 1."""
    root, _, _, argv = run
    out = tmp_path_factory.mktemp("resume")
    argv = argv[:argv.index("--epoch")] + argv[argv.index("--epoch") + 2:]
    common = argv + ["--epoch", "3", "--base_mean_iou", "-1"]
    common[common.index("--save_path") + 1] = str(out / "full")
    full = train_cli.main(train_cli.build_parser().parse_args(
        common + ["--save_train_state"]))
    first = [p for p in full["saved"] if "epoch-1_" in p]
    assert len(first) == 1
    common[common.index("--save_path") + 1] = str(out / "again")
    state = jax_train_state_path(first[0])
    again = train_cli.main(train_cli.build_parser().parse_args(
        common + ["--resume", state]))
    return full, again, state


def test_save_train_state_writes_the_state_beside_each_snapshot(resumed):
    """Beside each snapshot the JAX CLI's TrainState directory and nothing
    else: it restores the snapshot's fp32 model, AdamW moments for every
    trainable parameter, and the steps done."""
    full, _, state_path = resumed
    root = Path(full["saved"][0]).parent
    assert sorted(p.name for p in root.iterdir()) == sorted(
        ["log.txt"] + [Path(s).name for s in full["saved"]]
        + [Path(jax_train_state_path(s)).name for s in full["saved"]])
    for snap in full["saved"]:
        state = jax_train_state_path(snap)
        assert Path(state).is_dir() and not Path(snap + "_train_state").exists()
        # two steps an epoch; the latest snapshot is the third epoch's
        epoch = re.search(r"epoch-(\d+)_", snap)
        steps = 2 * (int(epoch.group(1)) if epoch else 3)
        model = build_model(CFG, torch.device("cpu"))
        opt = make_optimizer(model)
        assert restore_train_state(state, model, opt) == steps
        want = torch.load(snap, weights_only=True)
        got = model.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[n], v) for n, v in want.items()
                   if not n.endswith("num_batches_tracked"))
        assert all(v.dtype == torch.float32 for v in got.values()
                   if v.is_floating_point())
        moments = opt.state_dict()["state"]
        assert len(moments) == len(opt.param_groups[0]["params"]) > 0
        assert all(int(m["step"]) == steps for m in moments.values())
    assert state_path == jax_train_state_path(full["saved"][0])


def test_resume_trains_every_epoch_from_the_saved_state(resumed, run):
    """As the JAX CLI (sam2unet_tpu/cli/train_cli.py:165): resumed from the
    state after epoch 1 with --epoch 3, the run trains epochs 0-2 again
    (three evaluations, the steps of three epochs), each step at the
    schedule's rate at the global step, which goes on from the saved 2; its
    first step is the restored state's on epoch 0's first batch."""
    _, again, state_path = resumed
    root, _, _, _ = run
    assert (again["steps"], again["global_step"], again["eval_forwards"]) \
        == (6, 8, 3)
    assert again["lrs"] == [cosine_step_lr(1e-3, s, 3, 2) for s in range(2, 8)]
    log = open(again["log"]).read()
    assert all(f"epoch-{e}_loss-" in log for e in (1, 2, 3))
    model = build_model(CFG, torch.device("cpu"))
    assert restore_train_state(state_path, model, make_optimizer(model)) == 2
    batch = next(iter(TrainDataset(str(root / "train" / "images"),
                                   str(root / "train" / "masks"), SIZE)
                      .epoch(4, 0, num_workers=2)))
    loss = multi_head_loss(model.train()(torch.from_numpy(batch.image)),
                           torch.from_numpy(batch.label))
    np.testing.assert_allclose(again["losses"][0], float(loss.detach()),
                               rtol=1e-6)


def test_resume_refuses_a_file_that_is_no_train_state(run):
    _, _, stats, argv = run
    with pytest.raises(KeyError, match="not a train state"):
        train_cli.main(train_cli.build_parser().parse_args(
            argv + ["--resume", stats["saved"][-1]]))


def test_resume_with_another_epoch_count_follows_that_schedule(
        run, resumed, tmp_path, monkeypatch):
    """The schedule is torch's CosineAnnealingLR per epoch, and a function of
    the global step and the resuming run's flags, as the JAX package's
    optax schedule is: resumed at step 2 with --epoch 5 (2 steps an
    epoch), the run trains 5 epochs, its rates those of steps 2-11 of a
    5-epoch run, held at eta_min past the fifth epoch, whatever the saved
    optimizer state held."""
    model = build_model(CFG, torch.device("cpu"))
    opt = make_optimizer(model, 1e-3, 5e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=5,
                                                       eta_min=ETA_MIN)
    for epoch in range(5):
        assert cosine_lr(1e-3, epoch, 5) == pytest.approx(
            sched.get_last_lr()[0], rel=1e-12)
        for step in (2 * epoch, 2 * epoch + 1):
            assert cosine_step_lr(1e-3, step, 5, 2) == cosine_lr(1e-3, epoch, 5)
        opt.step()
        sched.step()
    assert cosine_step_lr(1e-3, 13, 5, 2) == cosine_lr(1e-3, 5, 5) \
        == pytest.approx(ETA_MIN)
    # the train-state file this package wrote before (an older run's)
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(),
                "epoch": 1, "step": 2}, tmp_path / "s")
    opt2 = make_optimizer(model, 1e-3, 5e-4)
    assert restore_train_state(str(tmp_path / "s"), model, opt2) == 2
    assert opt2.state_dict()["state"].keys() == opt.state_dict()["state"].keys()

    _, _, _, argv = run
    _, _, state_path = resumed
    argv = list(argv)
    argv[argv.index("--save_path") + 1] = str(tmp_path / "longer")
    argv[argv.index("--epoch") + 1] = "5"
    seen = []
    step = train_cli.train_step
    monkeypatch.setattr(
        train_cli, "train_step",
        lambda model, optimizer, *a: (seen.append(optimizer.param_groups[0]["lr"]),
                                      step(model, optimizer, *a))[1])
    got = train_cli.main(train_cli.build_parser().parse_args(
        argv + ["--resume", state_path]))
    assert got["global_step"] == 12 and got["steps"] == len(seen) == 10
    assert seen == got["lrs"] == [cosine_step_lr(1e-3, s, 5, 2)
                                  for s in range(2, 12)]
    assert seen[-2:] == [cosine_lr(1e-3, 5, 5)] * 2


def test_remat_trains_to_the_same_losses(run, tmp_path):
    """--remat recomputes each trunk block in the backward: same arithmetic,
    so the same losses as the run without it."""
    _, _, stats, argv = run
    argv = list(argv)
    argv[argv.index("--save_path") + 1] = str(tmp_path)
    argv[argv.index("--epoch") + 1] = "1"
    got = train_cli.main(train_cli.build_parser().parse_args(argv + ["--remat"]))
    assert got["steps"] == 2
    np.testing.assert_allclose(got["losses"], stats["losses"][:2], rtol=1e-6)


def test_hiera_path_loads_a_sam2_trunk(tmp_path):
    """A SAM2-style .pt (`model` -> `image_encoder.trunk.*`, blocks without
    the adapter wrapper) loads into every trunk key; a trunk of another
    width is refused."""
    torch.manual_seed(1)
    src = build_model(CFG, torch.device("cpu"))
    trunk = {}
    for k, v in src.state_dict().items():
        parts = k.split(".")
        if parts[0] != "encoder" or "prompt_learn" in parts:
            continue
        parts = parts[1:]
        if parts[0] == "blocks":
            parts = parts[:2] + parts[3:]
        trunk["image_encoder.trunk." + ".".join(parts)] = v
    torch.save({"model": {**trunk, "sam_mask_decoder.x": torch.zeros(1)}},
               tmp_path / "sam2.pt")
    torch.manual_seed(2)
    dst = build_model(CFG, torch.device("cpu"))
    load_weights(dst, hiera_path=str(tmp_path / "sam2.pt"))
    got, want = dst.state_dict(), src.state_dict()
    for k in want:
        if k.startswith("encoder.") and "prompt_learn" not in k.split("."):
            assert torch.equal(got[k], want[k]), k
    trunk["image_encoder.trunk.pos_embed"] = torch.zeros(1, 3, 7, 7)
    torch.save({"model": trunk}, tmp_path / "bad.pt")
    with pytest.raises(KeyError, match="shape mismatch"):
        load_weights(dst, hiera_path=str(tmp_path / "bad.pt"))
