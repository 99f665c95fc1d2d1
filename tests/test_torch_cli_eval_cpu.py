"""The port's host evaluator, eval CLI, the train CLI's --full_eval and
--profile_dir, and the native JPEG loader, on the CPU against the JAX
package's.

  - `evaluate_segmentation_performance` and `evaluate_dataset` equal the
    JAX package's exactly on random masks with several components each.
  - The eval CLI writes the JAX eval CLI's log.txt on the same directory.
  - The train CLI with --full_eval (hiera_test at 64 px, one epoch from one
    .pth, the same data) reports what the JAX train CLI reports.
  - --profile_dir writes a Chrome trace of steps 10-14 (a short run's from
    step 10 on).
  - The native loader (csrc/dataload.cc, built with g++ -ljpeg here):
    `decode_jpeg` gives PIL's pixels, `letterbox_norm` the port's numpy
    letterbox and normalization and the JAX package's.
"""

from __future__ import annotations

import json
import re
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.cli import eval_cli, train_cli
from sam2unet_torch.cli.common import build_model
from sam2unet_torch.data import native_loader
from sam2unet_torch.data.transforms import letterbox, normalize
from sam2unet_torch.eval import metrics
from sam2unet_tpu.cli import eval_cli as jax_eval_cli
from sam2unet_tpu.cli import train_cli as jax_train_cli
from sam2unet_tpu.data import transforms as jax_transforms
from sam2unet_tpu.eval import metrics as jax_metrics

SIZE, CFG = 64, "hiera_test"


def _blobs(rng, h, w, n):
    """A uint8 mask of `n` random discs and boxes (0 or 255)."""
    yy, xx = np.mgrid[:h, :w]
    m = np.zeros((h, w), bool)
    for _ in range(n):
        cy, cx = rng.integers(0, h), rng.integers(0, w)
        r = rng.integers(2, max(3, min(h, w) // 6))
        if rng.random() < 0.5:
            m |= (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
        else:
            m |= (abs(yy - cy) < r) & (abs(xx - cx) < r // 2 + 1)
    return m.astype(np.uint8) * 255


def _pair(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(40, 120)), int(rng.integers(40, 120))
    gt = _blobs(rng, h, w, int(rng.integers(0, 6)))
    pred = _blobs(rng, h, w, int(rng.integers(0, 9)))
    # a soft prediction that overlaps the GT in part
    soft = np.clip(pred * rng.random((h, w)) + 0.6 * gt, 0, 255)
    return soft.astype(np.uint8), gt


@pytest.mark.parametrize("seed", range(4))
def test_host_evaluator_equals_the_jax_package(seed):
    pairs = [_pair(100 * seed + i) for i in range(6)]
    got = [metrics.evaluate_segmentation_performance(p, g) for p, g in pairs]
    want = [jax_metrics.evaluate_segmentation_performance(p, g)
            for p, g in pairs]
    assert got == want
    assert any(r[metrics.COUNT_PRED] > 1 and r[metrics.COUNT_GT] > 1
               for r in got)
    assert metrics.evaluate_dataset(got) == jax_metrics.evaluate_dataset(want)
    # the reference's quirk: "images_count" is the GT instance count
    assert metrics.evaluate_dataset(got)["images_count"] == sum(
        r[metrics.COUNT_GT] for r in got)


def test_eval_cli_writes_the_jax_log(tmp_path):
    gt_dir, preds = tmp_path / "gt", tmp_path / "preds"
    gt_dir.mkdir()
    preds.mkdir()
    for i in range(5):
        pred, gt = _pair(7 + i)
        Image.fromarray(gt).save(gt_dir / f"m{i}.png")
        Image.fromarray(pred).save(preds / f"m{i}.png")
    shutil.copytree(preds, tmp_path / "jax_preds")
    final = eval_cli.main(eval_cli.build_parser().parse_args(
        ["--pred_path", str(preds), "--gt_path", str(gt_dir)]))
    jax_eval_cli.main(jax_eval_cli.build_parser().parse_args(
        ["--pred_path", str(tmp_path / "jax_preds"), "--gt_path",
         str(gt_dir)]))
    log = (preds / "log.txt").read_text()
    assert log == (tmp_path / "jax_preds" / "log.txt").read_text()
    assert log.count("Segmentation Evaluation") == 1
    assert final[metrics.MIOU] > 0


def _write_split(root, n, rng):
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(48, 96)), int(rng.integers(48, 96))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        mask = _blobs(rng, h, w, 3)
        img[mask > 0] = (img[mask > 0] * 0.3 + 170).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"s{i}.jpg")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


def _report(log: str) -> dict:
    """The last report block of a log.txt, {metric: value}."""
    block = log.rsplit("-" * 25, 1)[-1]
    out = {}
    for line in block.splitlines():
        m = re.match(r"(.+?)\s*:\s*(\S+)$", line)
        if m:
            out[m.group(1)] = float(m.group(2))
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_eval")
    rng = np.random.default_rng(3)
    _write_split(root / "train", 8, rng)
    _write_split(root / "test", 5, rng)
    torch.manual_seed(0)
    torch.save(build_model(CFG, torch.device("cpu")).state_dict(),
               root / "start.pth")
    return root


def _argv(root, out):
    return ["--save_path", str(out), "--checkpoint", str(root / "start.pth"),
            "--train_image_path", str(root / "train" / "images"),
            "--train_mask_path", str(root / "train" / "masks"),
            "--test_image_path", str(root / "test" / "images"),
            "--test_gt_path", str(root / "test" / "masks"),
            "--epoch", "1", "--batch_size", "8", "--size", str(SIZE),
            "--model_cfg", CFG, "--num_workers", "2", "--lr", "0",
            "--weight_decay", "0", "--full_eval"]


def test_train_cli_full_eval_matches_the_jax_cli(data, tmp_path, monkeypatch,
                                                 one_thread):
    """Both CLIs with --full_eval from one .pth on the same data, their train
    steps replaced by ones that change nothing (training is held against the
    JAX package elsewhere; here both evaluate the checkpoint's weights and
    BatchNorm statistics): the same host report. The masks are binarized at
    0.1 of the min-max normalized probability, so a pixel at that threshold
    could fall either way: the semantic scores must agree to 1e-3 (as
    written in log.txt, 4 decimals), the instance scores and counts
    exactly."""
    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    monkeypatch.setattr(train_cli, "train_step",
                        lambda model, opt, images, labels: torch.zeros(()))
    monkeypatch.setattr(jax_train_cli, "make_train_step",
                        lambda *a, **k: lambda state, x, y: (
                            state, {"loss": np.float32(0.0)}))
    stats = train_cli.main(train_cli.build_parser().parse_args(
        _argv(data, tmp_path / "port") + ["--device", "cpu"]))
    jax_train_cli.main(jax_train_cli.build_parser().parse_args(
        _argv(data, tmp_path / "jax")))
    got = _report((tmp_path / "port" / "log.txt").read_text())
    want = _report((tmp_path / "jax" / "log.txt").read_text())
    assert got.keys() == want.keys() and "Precision 50" in got
    assert stats["reports"][-1]["images_count"] == got["images count"] > 0
    for k in got:
        tol = 1e-3 if k in ("mIoU", "mDice") else 0.0
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])
    assert stats["eval_forwards"] == 1


@pytest.fixture
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own thread pool would oversubscribe
    them and a small train step would take seconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(data, tmp_path, n_images):
    """The train CLI at batch 1 for one epoch over `n_images` images (so as
    many steps), profiled."""
    _write_split(tmp_path / "train", n_images, np.random.default_rng(4))
    argv = _argv(data, tmp_path / "run")
    argv[argv.index("--batch_size") + 1] = "1"
    argv.remove("--full_eval")
    argv[argv.index("--train_image_path") + 1] = str(tmp_path / "train"
                                                     / "images")
    argv[argv.index("--train_mask_path") + 1] = str(tmp_path / "train"
                                                    / "masks")
    return train_cli.main(train_cli.build_parser().parse_args(
        argv + ["--device", "cpu", "--profile_dir", str(tmp_path / "prof")]))


def test_profile_dir_writes_a_trace_of_steps_10_to_14(data, tmp_path, capsys,
                                                      one_thread):
    """15 steps: the trace opens before step 10 and closes after step 14."""
    stats = _profiled(data, tmp_path, 15)
    assert stats["steps"] == 15
    assert stats["trace"] == str(tmp_path / "prof"
                                 / "train_steps_10-14.pt.trace.json")
    events = json.loads(open(stats["trace"]).read())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    out = capsys.readouterr().out
    assert f"profiler trace written to {tmp_path / 'prof'}" in out
    assert "short run" not in out


def test_profile_dir_flushes_a_short_run(data, tmp_path, capsys, one_thread):
    """11 steps: the run ends inside the window, and the trace of step 10 is
    written at the end of the epoch."""
    stats = _profiled(data, tmp_path, 11)
    assert stats["steps"] == 11
    assert stats["trace"].endswith("train_steps_10-10.pt.trace.json")
    assert json.loads(open(stats["trace"]).read())["traceEvents"]
    out = capsys.readouterr().out
    assert f"profiler trace (short run) written to {tmp_path / 'prof'}" in out


# ------------------------------------------------------------ native loader


def _jpeg(tmp_path, h=277, w=401, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([127 + 80 * np.sin(yy / 23) + 40 * np.cos(xx / 17),
                    127 + 60 * np.cos(yy / 31),
                    rng.random((h, w)) * 60 + 90], axis=-1)
    path = tmp_path / f"img{seed}.jpg"
    Image.fromarray(img.clip(0, 255).astype(np.uint8)).save(path, quality=92)
    return str(path)


def test_native_loader_builds_here():
    assert native_loader.available(), native_loader.status()
    assert native_loader.status().startswith("native libjpeg")


def test_native_loader_switch(monkeypatch):
    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    assert not native_loader.enabled()
    assert native_loader.status() == "PIL (SAM2UNET_NO_NATIVE_LOADER is set)"


@pytest.mark.parametrize("seed,h,w", [(0, 277, 401), (1, 480, 320),
                                      (2, 97, 131)])
def test_native_decode_equals_pil(tmp_path, seed, h, w):
    path = _jpeg(tmp_path, h, w, seed)
    got = native_loader.decode_jpeg(path)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))


def test_native_decode_refuses_what_is_no_jpeg(tmp_path):
    path = tmp_path / "not.jpg"
    path.write_bytes(b"no jpeg here")
    assert native_loader.decode_jpeg(str(path)) is None


@pytest.mark.parametrize("seed,h,w,size", [(0, 277, 401, 352),
                                           (1, 480, 320, 960),
                                           (2, 97, 131, 64)])
def test_native_letterbox_equals_the_numpy_paths(tmp_path, seed, h, w, size):
    rgb = np.asarray(Image.open(_jpeg(tmp_path, h, w, seed)).convert("RGB"))
    got, pad = native_loader.letterbox_norm(rgb, size)
    chw = rgb.astype(np.float32).transpose(2, 0, 1) / 255.0
    want, want_pad = letterbox(chw, size)
    want = normalize(want).transpose(1, 2, 0)
    jax_want, jax_pad = jax_transforms.letterbox(chw, size)
    jax_want = jax_transforms.normalize(
        jax_want, jax_transforms.IMAGENET_MEAN,
        jax_transforms.IMAGENET_STD).transpose(1, 2, 0)
    assert pad == want_pad == jax_pad
    # float32 sums in another order (C against numpy): measured at most
    # 1.07e-6 on values up to 2.64 (5.9e-7 of the value). Bound: 1e-6
    # relative and absolute.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, jax_want, rtol=1e-6, atol=1e-6)
