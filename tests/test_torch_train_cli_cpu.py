"""The port's train CLI end to end on the CPU (`--device cpu`), in the
manner of tests/test_cli_e2e.py: the `hiera_test` trunk at --size 64 on a
small synthetic dataset, two epochs. It writes log.txt with the epoch
reports and a checkpoint that the port's test CLI loads strictly and runs;
the frozen trunk comes back bit-identical, the trainable set changed. Also:
the flags not ported yet exit non-zero naming their ROADMAP.md item, and
--hiera_path loads a SAM2 trunk through the port's own key rules."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.cli import test_cli, train_cli
from sam2unet_torch.cli.common import build_model, load_weights
from sam2unet_torch.train.optim import is_trainable

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


def test_the_train_cli_refuses_hiera_s_960_on_the_card(monkeypatch):
    """Its defaults, hiera_s@960, need K11 for the global blocks' backward:
    on the card the CLI exits naming the ROADMAP.md item before it builds
    anything (the device is stubbed, so no card is needed here)."""
    monkeypatch.setattr(train_cli, "resolve_device",
                        lambda name: torch.device("cuda"))
    args = train_cli.build_parser().parse_args(
        ["--save_path", "a", "--train_image_path", "b", "--train_mask_path", "c",
         "--test_image_path", "d", "--test_gt_path", "e"])
    assert (args.model_cfg, args.size) == ("sam2_hiera_s", 960)
    with pytest.raises(SystemExit) as e:
        train_cli.main(args)
    assert "ROADMAP.md open item 1" in str(e.value.code)
    assert str(e.value.code).count("needs K11") == 3


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
