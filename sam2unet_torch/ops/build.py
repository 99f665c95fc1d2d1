"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each `csrc/*.cu` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). All sources compile in
parallel, one nvcc process each, into `build/torch_kernels/<hash>/` at the
repository root; the hash covers every source, header and flag, so an
edited source rebuilds and an unchanged one is reused. Pointers and the
stream cross as `c_void_p`; each C entry point returns the CUDA error code
of its launches, and `check` raises on a non-zero one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("fused_mlp", "fused_attention_block", "fused_transition",
           "flash_attention", "fused_mlp_bwd", "fused_attention_block_bwd",
           "fused_transition_bwd", "flash_attention_bwd", "full_attention")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "fused_mlp": {
        "k1_fused_mlp": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _L, _I, _I, _I, _I, _I, _P],
    },
    "fused_attention_block": {
        "k4_window_block_strips": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "k6_window_block": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _P],
        "k12_window_block_strips_rem": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                        _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _I, _P],
    },
    "fused_transition": {
        "k8_transition": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "flash_attention": {
        "k10_flash_attention": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, ctypes.c_float, _P],
    },
    # the backward kernels, in libraries of their own (the forward's stay as
    # they are built without them)
    "fused_mlp_bwd": {
        "k2_mlp_bwd_dx": [_I, *[_P] * 12, _L, _I, _I, _P],
        "k3_adapter_bwd": [_I, *[_P] * 16, _L, _I, _I, _I, _P],
    },
    "fused_attention_block_bwd": {
        "k5_window_block_strips_bwd": [_I, *[_P] * 16, *[_I] * 7, _P],
        "k7_window_block_bwd": [_I, *[_P] * 16, *[_I] * 5, _P],
    },
    "fused_transition_bwd": {
        "k9_transition_bwd": [_I, *[_P] * 19, *[_I] * 7, _P],
    },
    "flash_attention_bwd": {
        "k11_flash_attention_bwd_delta": [_I, *[_P] * 3, *[_I] * 4, *[_L] * 6,
                                          _P],
        "k11_flash_attention_bwd_dq": [_I, *[_P] * 7, *[_I] * 5, *[_L] * 12,
                                       ctypes.c_float, _P],
        "k11_flash_attention_bwd_dkv": [_I, *[_P] * 8, *[_I] * 5, *[_L] * 12,
                                        ctypes.c_float, _P],
    },
    "full_attention": {
        "k14_full_attention": [_I, *[_P] * 4, *[_I] * 5, *[_L] * 6,
                               ctypes.c_float, _P],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# seconds nvcc took for each source built by this process (they run at once,
# so the slowest is the build's time)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every missing library, all nvcc processes at once."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs, start = [], time.perf_counter()
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.so.tmp{os.getpid()}"
        log = open(out / f"{name}.log", "w")
        cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed, running = [], list(procs)
    while running:
        time.sleep(0.2)
        for entry in list(running):
            name, lib, tmp, log, proc = entry
            rc = proc.poll()
            if rc is None:
                continue
            running.remove(entry)
            build_seconds[name] = time.perf_counter() - start
            log.close()
            if rc == 0:
                os.replace(tmp, lib)
            else:
                failed.append(name)
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def library(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            out = build_all()
            for src in SOURCES:
                lib = ctypes.CDLL(str(out / f"lib{src}.so"))
                for fn, argtypes in SIGNATURES[src].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[src] = lib
        return _libs[name]


def ptxas_summary(out: Path) -> list[str]:
    """One line per compiled kernel from the `-Xptxas -v` build logs:
    registers, spills and stack."""
    lines = []
    for log in sorted(out.glob("*.log")):
        fn = spill = ""
        for ln in log.read_text().splitlines():
            if "Function properties for" in ln:
                fn = ln.rsplit(" ", 1)[-1]
            elif "spill stores" in ln:
                spill = ln.strip()
            elif "Used" in ln and "registers" in ln and fn:
                regs = ln.split("Used", 1)[1].strip()
                lines.append(f"{log.stem}: {fn}: {regs}; {spill}")
                fn = spill = ""
    return lines


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
