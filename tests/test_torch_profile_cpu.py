"""The port's profiler (`utils/profile_model.py`) and augmentation dump
(`utils/dump_augmentations.py`) on the CPU, one torch thread.

  - `profile_model` at the tiny geometry (hiera_test, 64 px), both modes:
    its table of CPU operators, per step; no entry point is called (the CPU
    runs the plain versions).
  - `trace_device_time` and `entry_calls` on a small saved Chrome trace in
    torch.profiler's layout: device kernels launched inside a C entry
    point's annotation count under its name, others under their own;
    `trace_call_kernels` on a trace of repeated calls, whole or missing a
    kernel, a launch or a call's launches.
  - every C entry point of `ops/build.py` has its dispatch wrapper, a name
    the wrappers count launches under.
  - the augmentation dump writes its pairs, and equals the JAX script's
    on the same data (the same seeded pipeline).
"""

from __future__ import annotations

import json
import re
import sys
import types
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


def test_trace_entry_kernels_lists_each_entry_points_kernels(tmp_path):
    """The device kernels launched inside each entry point's annotation, by
    name, with their time and count; kernels outside every entry point are
    left out."""
    got = {e: {k: list(v) for k, v in ks.items()} for e, ks in
           profile_model.trace_entry_kernels(_trace(tmp_path)).items()}
    assert got == {"k1_fused_mlp": {"gemm_bf16_kernel": [61.0, 2],
                                    "ln_kernel": [11.0, 2]},
                   "k10_flash_attention": {"flash_fwd_kernel": [40.0, 1]}}


def _repeat_trace(tmp_path: Path, drop=None, k1_kernels=(2, 2)) -> Path:
    """Two calls of K1 (k1_kernels[i] launches each) and a PyTorch kernel
    outside them, on one thread; `drop` = "kernel" or "launch" leaves out
    the device or the host record of the first call's first launch."""
    ev, corr, ts = [], 0, 100
    for n in k1_kernels:
        ev.append({"ph": "X", "cat": "user_annotation", "name": "k1_fused_mlp",
                   "pid": 1, "tid": 7, "ts": ts, "dur": 20})
        for j in range(n):
            corr += 1
            if not (drop == "launch" and corr == 1):
                ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "pid": 1, "tid": 7, "ts": ts + 2 + j, "dur": 1,
                           "args": {"correlation": corr}})
            if not (drop == "kernel" and corr == 1):
                ev.append({"ph": "X", "cat": "kernel", "name": f"kern{j}", "pid": 0,
                           "tid": 3, "ts": ts + 50 + j, "dur": 10 + j,
                           "args": {"correlation": corr}})
        ts += 100
    corr += 1
    ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "pid": 1,
               "tid": 7, "ts": ts, "dur": 1, "args": {"correlation": corr}})
    ev.append({"ph": "X", "cat": "kernel", "name": "elementwise", "pid": 0, "tid": 3,
               "ts": ts + 50, "dur": 4, "args": {"correlation": corr}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return path


@pytest.mark.parametrize("drop,k1_kernels,calls,faults", [
    (None, (2, 2), 2, []),
    ("kernel", (2, 2), 2, ["launches [1] of 5 without their kernel"]),
    ("launch", (2, 2), 2, ["1 of 5 kernels without their launch",
                           "k1_fused_mlp: 2 calls launching [1, 2] kernels"]),
    (None, (2, 1), 2, ["k1_fused_mlp: 2 calls launching [2, 1] kernels"]),
    (None, (2, 2), 3, ["k1_fused_mlp: 2 calls launching [2, 2] kernels"])])
def test_trace_call_kernels_reads_repeated_calls_and_what_they_miss(tmp_path, drop,
                                                                    k1_kernels, calls, faults):
    """Every kernel of the repeated calls by name, with its time and count;
    a launch without its kernel, a kernel without its launch, an entry
    point whose calls launched unequal counts or whose calls are not a
    multiple of the repeats are each named."""
    got, missed = profile_model.trace_call_kernels(
        _repeat_trace(tmp_path, drop, k1_kernels), calls)
    assert missed == faults
    if not faults:
        assert got == {"kern0": [20.0, 2], "kern1": [22.0, 2], "elementwise": [4.0, 1]}


def test_trace_call_kernels_within_an_annotation_counts_only_its_calls(tmp_path):
    """With `within`, a call before the annotation (whose first launch lost
    its kernel) counts neither its launches nor its kernels."""
    path = _repeat_trace(tmp_path, "kernel")
    trace = json.loads(path.read_text())
    trace["traceEvents"].append({"ph": "X", "cat": "user_annotation", "name": "timed",
                                 "pid": 1, "tid": 7, "ts": 195, "dur": 30})
    path.write_text(json.dumps(trace))
    got, missed = profile_model.trace_call_kernels(path, 1, "timed")
    assert missed == [] and got == {"kern0": [10.0, 1], "kern1": [11.0, 1]}
    assert profile_model.trace_call_kernels(path, 2)[1] == [
        "launches [1] of 5 without their kernel"]


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


def _event(name, start, end, device=True, annotation=False):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation,
        time_range=types.SimpleNamespace(start=start, end=end))


def test_idle_share_counts_device_kernels_only():
    """A profile's device events hold, beside the kernels, each C entry
    point's GPU user annotation (spanning the kernels it launched) and
    copies. The busy time is the union of the kernels' intervals alone, so
    the idle share 1 - busy / span lies in [0, 1]; summing every device
    event, as the chip script's profile once did, read it negative."""
    events = [
        _event("k11_flash_attention_bwd_dq_sm90", 0, 100, annotation=True),
        _event("k11_dq_sm90_kernel<96>", 10, 60),
        _event("k11_dkv_sm90_kernel<96>", 50, 90),   # overlaps the one before
        _event("k10_flash_attention_sm90", 150, 200),   # an annotation, older torch
        _event("fwd_sm90_kernel<96, 0, false>", 160, 190),
        _event("Memcpy HtoD (Pageable -> Device)", 190, 400),
        _event("aten::add", 0, 500, device=False),
    ]
    kernels = profile_model.device_kernels(events)
    assert [e.name for e in kernels] == ["k11_dq_sm90_kernel<96>",
                                         "k11_dkv_sm90_kernel<96>",
                                         "fwd_sm90_kernel<96, 0, false>"]
    busy, span = profile_model.busy_span_us(kernels)
    assert (busy, span) == (110.0, 180.0)
    assert 0.0 <= 1 - busy / span <= 1.0
    everything = [e for e in events if e.name != "aten::add"]
    summed = sum(e.time_range.end - e.time_range.start for e in everything)
    assert 1 - summed / span < 0
    assert profile_model.busy_span_us([]) == (0.0, 0.0)
