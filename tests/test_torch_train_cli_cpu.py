"""The port's train CLI end to end on the CPU (`--device cpu`), in the
manner of tests/test_cli_e2e.py: the `hiera_test` trunk at --size 64 on a
small synthetic dataset, two epochs. It writes log.txt with the epoch
reports and a checkpoint that the port's test CLI loads strictly and runs;
the frozen trunk comes back bit-identical, the trainable set changed. Also:
--save_train_state and --resume reproduce the uninterrupted run, --remat
trains to the same losses, the flags not ported yet exit non-zero naming
their ROADMAP.md item, the defaults (hiera_s@960) pass the card's gate, and
--hiera_path loads a SAM2 trunk through the port's own key rules."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.cli import test_cli, train_cli
from sam2unet_torch.cli.common import build_model, load_weights
from sam2unet_torch.train.checkpoints import (
    restore_train_state,
    save_train_state,
)
from sam2unet_torch.train.optim import (
    ETA_MIN,
    cosine_lr,
    is_trainable,
    make_optimizer,
)

SIZE, CFG = 64, "hiera_test"


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


@pytest.mark.parametrize("flag", sorted(train_cli.UNPORTED))
def test_unported_flags_exit_with_their_roadmap_item(run, flag):
    _, _, _, argv = run
    extra = [f"--{flag}"] + ([] if isinstance(
        getattr(train_cli.build_parser().parse_args(argv), flag), bool) else ["x"])
    with pytest.raises(SystemExit) as e:
        train_cli.main(train_cli.build_parser().parse_args(argv + extra))
    assert "ROADMAP.md" in str(e.value.code) and f"--{flag}" in str(e.value.code)


def test_the_train_cli_defaults_to_the_card():
    args = train_cli.build_parser().parse_args(
        ["--save_path", "a", "--train_image_path", "b", "--train_mask_path", "c",
         "--test_image_path", "d", "--test_gt_path", "e"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_cli.main(args)


def test_the_train_cli_accepts_its_defaults_on_the_card(monkeypatch):
    """Its defaults, hiera_s@960, train through K11 on the card, so the gate
    that guards kernels not ported yet lets them pass (the gate function is
    tested, not a card); a geometry the guard names still exits with the
    ROADMAP.md item."""
    args = train_cli.build_parser().parse_args(
        ["--save_path", "a", "--train_image_path", "b", "--train_mask_path", "c",
         "--test_image_path", "d", "--test_gt_path", "e"])
    assert (args.model_cfg, args.size, args.batch_size) == ("sam2_hiera_s", 960, 16)
    cuda = torch.device("cuda")
    assert train_cli.check_ported(args.model_cfg, args.size, cuda) is None
    assert train_cli.check_ported("sam2_hiera_l", 352, cuda) is None
    monkeypatch.setattr(train_cli, "unported_train_backward",
                        lambda cfg, size: ["block 7: needs K7 weight-grad"])
    assert train_cli.check_ported(args.model_cfg, args.size,
                                  torch.device("cpu")) is None
    with pytest.raises(SystemExit) as e:
        train_cli.check_ported(args.model_cfg, args.size, cuda)
    assert "ROADMAP.md open item 1" in str(e.value.code)
    assert "needs K7 weight-grad" in str(e.value.code)


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
    again = train_cli.main(train_cli.build_parser().parse_args(
        common + ["--resume", first[0] + "_train_state"]))
    return full, again, first[0] + "_train_state"


def test_save_train_state_writes_the_state_beside_each_snapshot(resumed):
    full, _, state_path = resumed
    for snap in full["saved"]:
        state = torch.load(snap + "_train_state", weights_only=True)
        assert set(state) == {"model", "optimizer", "epoch", "step"}
        model = torch.load(snap, weights_only=True)
        assert state["model"].keys() == model.keys()
        assert all(v.dtype == torch.float32 for v in state["model"].values()
                   if v.is_floating_point())
    first = torch.load(state_path, weights_only=True)
    assert (first["epoch"], first["step"]) == (1, 2)
    assert first["optimizer"]["param_groups"][0]["lr"] == cosine_lr(1e-3, 0, 3)
    assert len(first["optimizer"]["state"]) > 0


def test_resume_reproduces_the_uninterrupted_run(resumed):
    """The counterpart of tests/test_resume_and_reverse.py::
    test_train_state_resume_roundtrip: resumed after epoch 1, epochs 2 and
    3 see the same batches, schedule, AdamW moments and BatchNorm statistics,
    so their losses are those of the run that never stopped."""
    full, again, _ = resumed
    assert full["steps"] == 6 and again["steps"] == 4
    assert (again["start_epoch"], again["global_step"]) == (1, 6)
    assert again["eval_forwards"] == 2
    np.testing.assert_allclose(again["losses"], full["losses"][2:], rtol=1e-6)
    a = torch.load(full["saved"][-1], weights_only=True)
    b = torch.load(again["saved"][-1], weights_only=True)
    for k in a:
        np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_resume_refuses_a_file_that_is_no_train_state(run):
    _, _, stats, argv = run
    with pytest.raises(KeyError, match="not a train state"):
        train_cli.main(train_cli.build_parser().parse_args(
            argv + ["--resume", stats["saved"][-1]]))


def test_resume_with_another_epoch_count_follows_that_schedule(
        run, resumed, tmp_path, monkeypatch):
    """The schedule is torch's CosineAnnealingLR, and a function of the
    epoch and the resuming run's flags (as the JAX package's is of the step
    count and the flags): resumed with a longer --epoch, the learning rate
    is the new length's from the restored epoch on, whatever the saved
    optimizer state held."""
    model = build_model(CFG, torch.device("cpu"))
    opt = make_optimizer(model, 1e-3, 5e-4)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=5,
                                                       eta_min=ETA_MIN)
    for epoch in range(5):
        assert cosine_lr(1e-3, epoch, 5) == pytest.approx(
            sched.get_last_lr()[0], rel=1e-12)
        opt.step()
        sched.step()
    save_train_state(str(tmp_path / "s"), model.state_dict(), opt, 1, 2)
    opt2 = make_optimizer(model, 1e-3, 5e-4)
    assert restore_train_state(str(tmp_path / "s"), model, opt2) == (1, 2)
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
    assert got["start_epoch"] == 1 and got["steps"] == len(seen) == 8
    assert seen == [cosine_lr(1e-3, e, 5) for e in (1, 2, 3, 4) for _ in range(2)]


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
