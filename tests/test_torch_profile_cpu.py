"""The port's profiler (`utils/profile_model.py`) and augmentation dump
(`utils/dump_augmentations.py`) on the CPU, one torch thread.

  - `profile_model` at the tiny geometry (hiera_test, 64 px), both modes:
    its table of CPU operators, per step; no entry point is called (the CPU
    runs the plain versions).
  - `trace_device_time` and `entry_calls` on a small saved Chrome trace in
    torch.profiler's layout: device kernels launched inside a C entry
    point's annotation count under its name, others under their own.
  - every C entry point of `ops/build.py` has its dispatch wrapper, a name
    the wrappers count launches under.
  - the augmentation dump writes its pairs, and equals the JAX script's
    on the same data (the same seeded pipeline).
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from sam2unet_torch.ops import build
from sam2unet_torch.utils import dump_augmentations, profile_model

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several test processes on the
    machine's cores, where torch's own pool would oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["infer", "train"])
def test_profile_model_prints_its_table_on_the_cpu(mode, capsys):
    out = profile_model.main(["--mode", mode, "--batch", "2", "--size", "64",
                              "--model_cfg", "hiera_test", "--top", "5",
                              "--steps", "2", "--device", "cpu"])
    text = capsys.readouterr().out
    assert out["device"] == "the CPU" and out["steps"] == 2
    assert out["calls"] == {}
    assert f"hiera_test@64 {mode} batch 2 bf16 on the CPU" in text
    assert "top 5 CPU operators (own time) (avg per step over 2):" in text
    rows = [ln for ln in text.splitlines() if re.match(r"\s*\d+\.\d+ ms  n=", ln)]
    assert len(rows) == 5
    names = [r[0] for r in out["rows"]]
    assert any(n.startswith("aten::") for n in names)
    if mode == "train":
        assert "aten::convolution_backward" in names
    ms = [r[1] for r in out["rows"]]
    assert ms == sorted(ms, reverse=True) and ms[0] > 0


def _trace(tmp_path: Path) -> Path:
    """Two K1 calls (a GEMM and an LN kernel each), one K10 call, and a
    PyTorch kernel outside any annotation, on one thread."""
    ev = []

    def annot(name, ts, dur):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "pid": 1, "tid": 7, "ts": ts, "dur": dur})

    def launch(corr, ts, kernel, dur):
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "pid": 1, "tid": 7, "ts": ts, "dur": 1,
                   "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": kernel, "pid": 0,
                   "tid": 3, "ts": ts + 50, "dur": dur,
                   "args": {"correlation": corr}})

    annot("k1_fused_mlp", 100, 20)
    launch(1, 105, "gemm_bf16_kernel", 30)
    launch(2, 110, "ln_kernel", 5)
    annot("k1_fused_mlp", 200, 20)
    launch(3, 205, "gemm_bf16_kernel", 31)
    launch(4, 210, "ln_kernel", 6)
    annot("k10_flash_attention", 300, 10)
    launch(5, 303, "flash_fwd_kernel", 40)
    launch(6, 400, "at::native::elementwise_kernel", 7)
    annot("aten::add", 400, 5)      # an annotation that is no entry point
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


def test_trace_device_time_names_kernels_by_their_entry_point(tmp_path):
    path = _trace(tmp_path)
    got = {k: list(v) for k, v in profile_model.trace_device_time(path).items()}
    assert got == {"k1_fused_mlp": [72.0, 4], "k10_flash_attention": [40.0, 1],
                   "at::native::elementwise_kernel": [7.0, 1]}
    assert profile_model.entry_calls(path) == {"k1_fused_mlp": 2,
                                               "k10_flash_attention": 1}


def test_every_entry_point_has_its_wrapper():
    entries = {fn for src in build.SIGNATURES.values() for fn in src}
    assert set(profile_model.ENTRY_WRAPPER) == entries
    counted = set()
    for f in (ROOT / "sam2unet_torch" / "ops").glob("*.py"):
        counted |= set(re.findall(r'count_launch\("([a-z0-9_]+)"',
                                  f.read_text()))
    assert set(profile_model.ENTRY_WRAPPER.values()) == counted


def test_dump_augmentations_writes_the_jax_scripts_pairs(tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("SAM2UNET_NO_NATIVE_LOADER", "1")
    rng = np.random.default_rng(0)
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    for i in range(3):
        h, w = int(rng.integers(30, 60)), int(rng.integers(30, 60))
        Image.fromarray((rng.random((h, w, 3)) * 255).astype(np.uint8)).save(
            tmp_path / "images" / f"s{i}.png")
        m = np.zeros((h, w), np.uint8)
        m[h // 3:, : w // 2] = 255
        Image.fromarray(m).save(tmp_path / "masks" / f"s{i}.png")
    args = ["--image_path", str(tmp_path / "images"), "--mask_path",
            str(tmp_path / "masks"), "--size", "48", "--count", "4"]
    assert dump_augmentations.main(args + ["--out", str(tmp_path / "port")]) == 3
    sys.path.insert(0, str(ROOT / "scripts"))
    try:
        import dump_augmentations as jax_dump
    finally:
        sys.path.remove(str(ROOT / "scripts"))
    monkeypatch.setattr(sys, "argv", ["dump_augmentations.py", *args,
                                      "--out", str(tmp_path / "jax")])
    jax_dump.main()
    for i in range(3):
        for name in (f"{i}.jpg", f"label_{i}.png"):
            got = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
            want = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
            assert got.shape == want.shape == ((48, 48, 3) if name.endswith(
                "jpg") else (48, 48))
            # the JPEG encoder sees float images that may round one level
            # apart: within 2 levels
            assert np.abs(got - want).max() <= (2 if name.endswith("jpg")
                                                else 0), name
