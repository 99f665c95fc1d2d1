"""The wheel ships the port's C and CUDA sources, and an installed port
builds its host libraries outside the repository.

`ops/build.py` compiles `sam2unet_torch/csrc/` at first use, so the sources
are the port's native component: every file there must match a
`sam2unet_torch` package-data glob of pyproject.toml. The slow test builds
the wheel, installs it with `--target` into a directory it then makes
read-only (and, since permission bits do not stop root, puts a file where
`build/` would go), and from a subprocess outside the repository builds
`ccl.cc` through `host_library` (into the per-user cache under the
subprocess's HOME) and labels a mask with it.
"""

from __future__ import annotations

import fnmatch
import os
import shutil
import stat
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "sam2unet_torch" / "csrc"


def _package_data() -> list[str]:
    with open(REPO / "pyproject.toml", "rb") as f:
        conf = tomllib.load(f)
    return conf["tool"]["setuptools"]["package-data"]["sam2unet_torch"]


def test_every_port_source_matches_a_package_data_glob():
    globs = _package_data()
    files = sorted(p.relative_to(REPO / "sam2unet_torch").as_posix()
                   for p in CSRC.iterdir() if p.is_file())
    assert len(files) == 24, files
    loose = [f for f in files if not any(fnmatch.fnmatch(f, g) for g in globs)]
    assert not loose, f"not shipped in the wheel: {loose}"


def _read_only(root: Path) -> None:
    for p in [root, *root.rglob("*")]:
        mode = p.stat().st_mode & ~(stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH)
        p.chmod(mode)


def _writable(root: Path) -> None:
    for p in [root, *root.rglob("*")]:
        p.chmod(p.stat().st_mode | stat.S_IWUSR)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
@pytest.mark.slow
def test_installed_port_builds_a_host_library(tmp_path):
    wheel_dir = tmp_path / "dist"
    subprocess.run(
        [sys.executable, "-m", "pip", "wheel", str(REPO), "--no-deps",
         "--no-build-isolation", "-w", str(wheel_dir)],
        check=True, capture_output=True, text=True, cwd=REPO)
    wheels = list(wheel_dir.glob("sam2unet_tpu-*.whl"))
    assert len(wheels) == 1, wheels
    target = tmp_path / "site"
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "--target", str(target),
         "--no-deps", str(wheels[0]), "-q"],
        check=True, capture_output=True, text=True)
    shipped = sorted(p.name for p in (target / "sam2unet_torch" / "csrc")
                     .iterdir())
    assert shipped == sorted(p.name for p in CSRC.iterdir() if p.is_file())
    probe = (
        "import numpy as np\n"
        "import sam2unet_torch\n"
        "assert sam2unet_torch.__file__.startswith(%r), sam2unet_torch.__file__\n"
        "from sam2unet_torch.ops import build\n"
        "from sam2unet_torch.ops.connected_components import "
        "label_components_native\n"
        "lib = build.host_library('ccl')\n"
        "assert str(lib).startswith(%r), lib\n"
        "m = np.zeros((1, 1, 8, 8), np.bool_)\n"
        "m[..., 1:3, 1:3] = True; m[..., 5:7, 5:7] = True\n"
        "labels, counts = label_components_native(m)\n"
        "assert labels.max() == 2 and counts.max() == 4, (labels, counts)\n"
        "print('wheel ok', lib)\n"
    ) % (str(target), str(tmp_path / "home" / ".cache" / "sam2unet_torch"))
    (tmp_path / "home").mkdir()
    (target / "build").write_text("not a directory")
    _read_only(target)
    try:
        out = subprocess.run(
            [sys.executable, "-c", probe], capture_output=True, text=True,
            cwd=tmp_path, timeout=600,
            env={"PATH": os.environ.get("PATH", "/usr/bin:/bin"),
                 "PYTHONPATH": str(target), "HOME": str(tmp_path / "home")})
    finally:
        _writable(target)
    assert out.returncode == 0, out.stderr
    assert "wheel ok" in out.stdout
