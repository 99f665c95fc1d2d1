"""The port's host-side and plain tensor pieces against the JAX package, on
the CPU: windowing, pooling, attention, the host resize, the eval dataset,
the postprocess, and the test CLI end to end on a tiny model."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.cli import test_cli
from sam2unet_torch.cli.common import build_model, postprocess_prediction
from sam2unet_torch.data.dataset import EvalDataset
from sam2unet_torch.ops import attention, pooling, resize_np, windowing
from sam2unet_tpu.cli.common import postprocess_prediction as jax_postprocess
from sam2unet_tpu.data.dataset import EvalDataset as JaxEvalDataset
from sam2unet_tpu.ops import pooling as jax_pooling
from sam2unet_tpu.ops import resize_np as jax_resize_np
from sam2unet_tpu.ops import windowing as jax_windowing
from sam2unet_tpu.ops.pallas.flash_attention import (
    _xla_attention,
    attention_with_padkey,
)


@pytest.mark.parametrize("h,w,window", [(22, 22, 16), (11, 11, 8), (16, 16, 8),
                                        (12, 8, 5), (5, 5, 4)])
def test_window_partition_valid_matches_jax(h, w, window):
    x = np.random.default_rng(0).standard_normal((2, h, w, 6)).astype(np.float32)
    got = windowing.window_partition_valid(torch.from_numpy(x), window)
    want = jax_windowing.window_partition_valid(jnp.asarray(x), window)
    assert [n for _, n in got] == [n for _, n in want]
    for (g, _), (r, _) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    merged = windowing.window_merge_valid([g for g, _ in got], 2, h, w, window)
    np.testing.assert_array_equal(merged.numpy(), x)


@pytest.mark.parametrize("h,w,window", [(22, 22, 16), (88, 88, 8), (11, 11, 8)])
def test_window_partition_roundtrip_matches_jax(h, w, window):
    x = np.random.default_rng(1).standard_normal((2, h, w, 4)).astype(np.float32)
    got, pad = windowing.window_partition(torch.from_numpy(x), window)
    want, jpad = jax_windowing.window_partition(jnp.asarray(x), window)
    assert pad == jpad
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = windowing.window_unpartition(got, window, pad, (h, w))
    np.testing.assert_array_equal(back.numpy(), x)


def test_max_pool_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 8, 6, 5)).astype(np.float32)
    got = pooling.max_pool2d(torch.from_numpy(x), 2, 2)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_pooling.max_pool2d(jnp.asarray(x), 2, 2)))


@pytest.mark.parametrize("n_pad", [0, 7])
def test_attention_matches_jax(n_pad):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 9, 2, 8)).astype(np.float32)
               for _ in range(3))
    kp, vp = (rng.standard_normal((2, 8)).astype(np.float32) for _ in range(2))
    t = torch.from_numpy
    if n_pad:
        got = attention.attention_with_padkey(t(q), t(k), t(v), t(kp), t(vp), n_pad)
        want = attention_with_padkey(q, k, v, kp, vp, n_pad)
    else:
        got = attention.sdpa(t(q), t(k), t(v))
        want = _xla_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("size,method,ac,aa", [
    ((40, 30), "bilinear", False, True), ((70, 90), "bilinear", False, False),
    ((70, 90), "bilinear", True, False), ((33, 17), "bicubic", False, False),
    ((33, 17), "nearest", False, False)])
def test_resize_np_matches_jax(size, method, ac, aa):
    x = np.random.default_rng(4).random((3, 50, 60)).astype(np.float32)
    got = resize_np.resize_np(x, size, method, ac, aa)
    want = jax_resize_np.resize_np(x, size, method, ac, aa)
    np.testing.assert_array_equal(got, want)


def _write_dataset(root, n=3):
    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(40, 80)), int(rng.integers(40, 80))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4: h // 2, w // 4: w // 2] = 255
        Image.fromarray(img).save(root / "images" / f"s{i}.png")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


def test_eval_dataset_and_postprocess_match_jax(tmp_path):
    _write_dataset(tmp_path)
    ours = EvalDataset(str(tmp_path / "images"), str(tmp_path / "masks"), 64)
    theirs = JaxEvalDataset(str(tmp_path / "images"), str(tmp_path / "masks"), 64)
    assert ours.count == theirs.count == 3
    rng = np.random.default_rng(5)
    for i in range(ours.count):
        img, gt, name, pad = ours.item(i)
        jimg, jgt, jname, jpad = theirs.item(i)
        np.testing.assert_allclose(img, jimg, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(gt, jgt)
        assert name == jname and tuple(pad) == tuple(jpad)
        logits = rng.standard_normal((1, 64, 64, 1)).astype(np.float32)
        np.testing.assert_array_equal(
            postprocess_prediction(logits, pad, 64, gt.shape),
            jax_postprocess(logits, pad, 64, gt.shape))


def test_test_cli_end_to_end_on_cpu(tmp_path):
    _write_dataset(tmp_path / "data")
    torch.manual_seed(0)
    ckpt = tmp_path / "model.pth"
    torch.save(build_model("hiera_test", torch.device("cpu")).state_dict(), ckpt)
    args = test_cli.build_parser().parse_args([
        "--checkpoint", str(ckpt),
        "--test_image_path", str(tmp_path / "data" / "images"),
        "--test_gt_path", str(tmp_path / "data" / "masks"),
        "--save_path", str(tmp_path / "preds"), "--size", "64",
        "--model_cfg", "hiera_test", "--batch_size", "2", "--device", "cpu"])
    stats = test_cli.main(args)
    assert stats["forwards"] == 2 and stats["images"] == 3
    assert sorted(os.listdir(tmp_path / "preds")) == ["s0.png", "s1.png", "s2.png"]
    for i in range(3):
        png = np.asarray(Image.open(tmp_path / "preds" / f"s{i}.png"))
        gt = np.asarray(Image.open(tmp_path / "data" / "masks" / f"s{i}.png"))
        assert png.shape == gt.shape and png.dtype == np.uint8


def test_cuda_device_is_required_unless_cpu_is_asked(monkeypatch):
    from sam2unet_torch.cli.common import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_every_entry_point_defaults_to_the_card():
    """Both CLIs take the card unless --device cpu is passed, and
    chip_smoke.py has no other device: without one it exits non-zero and
    prints no result line."""
    import subprocess
    import sys
    from pathlib import Path

    from sam2unet_torch.cli import train_cli

    assert test_cli.build_parser().parse_args(
        ["--checkpoint", "a", "--test_image_path", "b", "--test_gt_path", "c",
         "--save_path", "d"]).device == "cuda"
    assert train_cli.build_parser().parse_args(
        ["--save_path", "a", "--train_image_path", "b", "--train_mask_path", "c",
         "--test_image_path", "d", "--test_gt_path", "e"]).device == "cuda"
    if torch.cuda.is_available():
        return
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, str(root / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert run.returncode != 0
    assert '"ok"' not in run.stdout and "no CUDA device" in run.stdout
