"""Build the CUDA kernels with nvcc, and the host libraries with g++, at
first use, and load them with ctypes.

Each `csrc/*.cu` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). The LN and GEMM passes at
any width and the attention kernels at any head dim (`SHARED_SOURCES`) are
called by the other libraries' entry points, every caller alike
(`gany_gemm`, `attn_any_fwd`, `attn_any_bwd`, ...), which leave those
symbols undefined: they load first, with their symbols global, so each of
their instances is compiled once. Their backward is two sources
only so that it builds in parallel: one of them alone would be the slowest
source of the build (on an 8-core H100 host, ~100 s and ~157 s of nvcc in
parallel, against ~178 s for the slowest other source). All sources
compile in parallel, one nvcc process each,
into `build/torch_kernels/<hash>/` at the repository root; the hash covers every source, header and flag, so an
edited source rebuilds and an unchanged one is reused. The sources ship in
the wheel (package data, `sam2unet_torch/csrc/`). Outputs go to `build/`
beside the package's parent directory (the repository root in a checkout)
where that directory is writable; where it is not (an installed package in
a read-only site-packages), to a per-user cache,
`$XDG_CACHE_HOME/sam2unet_torch/` (by default `~/.cache/sam2unet_torch/`). Pointers and the
stream cross as `c_void_p`; each C entry point returns the CUDA error code
of its launches, and `check` raises on a non-zero one. While a
torch.profiler trace records, each entry point's call is a user annotation
named after it (`k1_fused_mlp`, ...), so a trace attributes the device
kernels it launches (`gemm_bf16_kernel` serves several) to it. A host library
(`csrc/*.cc`: connected components, the JPEG loader) is built by
`host_library` into `native/<hash>/` under the same directory, the hash over
its source, flags and link libraries.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import types
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# csrc/gemm_any.cuh's and csrc/attention_any.cuh's entry points, which the
# other libraries call
SHARED_SOURCES = ("gemm_any", "attention_any", "attention_any_bwd",
                  "attention_any_bwd_pad")
SOURCES = (*SHARED_SOURCES, "fused_mlp", "fused_attention_block",
           "fused_transition", "flash_attention", "fused_mlp_bwd",
           "fused_attention_block_bwd",
           "fused_transition_bwd", "flash_attention_bwd",
           "flash_attention_bwd_sm90", "flash_attention_fwd_sm90",
           "mlp_sm90", "block_bwd_sm90", "full_attention",
           "flash_attention_d256", "full_attention_d256",
           "fused_attention_block_masked", "fused_attention_block_wgrad",
           "fused_attention_block_rem_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_K10 = [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
        ctypes.c_float, _P]
_K14 = [_I, *[_P] * 4, *[_I] * 5, *[_L] * 6, ctypes.c_float, _P]
_K11_DQ = [_I, *[_P] * 7, *[_I] * 5, *[_L] * 12, ctypes.c_float, _P]
_K11_DKV = [_I, *[_P] * 8, *[_I] * 5, *[_L] * 12, ctypes.c_float, _P]
SIGNATURES = {
    **{name: {} for name in SHARED_SOURCES},
    "fused_mlp": {
        "k1_fused_mlp": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _L, _I, _I, _I, _I, _I, _P],
        "k15_ln_matmul": [_I, *[_P] * 7, _L, _I, _I, _P],
        "k16_ln_qkv": [_I, *[_P] * 9, _L, _I, _I, _P],
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
    "flash_attention": {"k10_flash_attention": _K10},
    # K10 at head dim 256, a translation unit of its own
    "flash_attention_d256": {"k10_flash_attention_d256": _K10},
    # the backward kernels, in libraries of their own (the forward's stay as
    # they are built without them)
    "fused_mlp_bwd": {
        "k2_mlp_bwd_dx": [_I, *[_P] * 12, _L, _I, _I, _I, _I, _P],
        "k3_adapter_bwd": [_I, *[_P] * 16, _L, _I, _I, _I, _P],
    },
    "fused_attention_block_bwd": {
        "k5_window_block_strips_bwd": [_I, *[_P] * 16, *[_I] * 7, _P],
        "k7_window_block_bwd": [_I, *[_P] * 16, *[_I] * 5, _P],
    },
    # K6 and K7 in the masked whole-grid mode, a library of their own
    "fused_attention_block_masked": {
        "k6_window_block_masked": [_I, *[_P] * 13, *[_I] * 5, _P],
        "k7_window_block_bwd_masked": [_I, *[_P] * 18, *[_I] * 5, _P],
    },
    # K7's weight-gradient mode and K13, libraries of their own
    "fused_attention_block_wgrad": {
        "k7_window_block_bwd_wgrad": [_I, *[_P] * 23, *[_I] * 5, _P],
    },
    "fused_attention_block_rem_bwd": {
        "k13_window_block_strips_rem_bwd": [_I, *[_P] * 16, *[_I] * 7, _P],
    },
    "fused_transition_bwd": {
        "k9_transition_bwd": [_I, *[_P] * 19, *[_I] * 7, _P],
    },
    "flash_attention_bwd": {
        "k11_flash_attention_bwd_delta": [_I, *[_P] * 3, *[_I] * 4, *[_L] * 6,
                                          _P],
        "k11_flash_attention_bwd_dq": _K11_DQ,
        "k11_flash_attention_bwd_dkv": _K11_DKV,
    },
    # K11's dq and dk/dv passes in bf16 on wgmma fed by TMA (csrc/hopper.cuh),
    # the same arguments
    "flash_attention_bwd_sm90": {
        "k11_flash_attention_bwd_dq_sm90": _K11_DQ,
        "k11_flash_attention_bwd_dkv_sm90": _K11_DKV,
    },
    # K10 and K14 in bf16 on wgmma fed by TMA (csrc/hopper.cuh), the
    # arguments of their CUDA-core entry points
    "flash_attention_fwd_sm90": {"k10_flash_attention_sm90": _K10,
                                 "k14_full_attention_sm90": _K14},
    # K1 and K2 in bf16 on wgmma fed by TMA (csrc/hopper.cuh): K1's
    # arguments, K2's without the fp32 pre-activation buffer
    "mlp_sm90": {
        "k1_fused_mlp_sm90": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _L, _I, _I, _I, _I, _I, _P],
        "k2_mlp_bwd_dx_sm90": [_I, *[_P] * 11, _L, _I, _I, _I, _I, _P],
    },
    # K3 and K7's dx-only unmasked mode in bf16 on wgmma fed by TMA
    # (csrc/hopper.cuh, csrc/gemm_sm90.cuh): K3's arguments are the partial
    # buffer's and the outputs' (no intermediate buffers) and its grid; K7's
    # those of its CUDA-core entry point without O; K5's and K9's without O,
    # lse and D (their small-window pass keeps them on the SM)
    "block_bwd_sm90": {
        "k3_adapter_bwd_sm90": [_I, *[_P] * 12, _L, _I, _I, _I, _I, _P],
        "k7_window_block_bwd_sm90": [_I, *[_P] * 15, *[_I] * 5, _P],
        "k5_window_block_strips_bwd_sm90": [_I, *[_P] * 13, *[_I] * 7, _P],
        "k9_transition_bwd_sm90": [_I, *[_P] * 16, *[_I] * 7, _P],
    },
    "full_attention": {"k14_full_attention": _K14},
    # K14 at head dim 256, a translation unit of its own
    "full_attention_d256": {"k14_full_attention_d256": _K14},
}

_lock = threading.Lock()
_libs: dict[str, types.SimpleNamespace] = {}
# seconds nvcc took for each source built by this process (they run at once,
# so the slowest is the build's time)
build_seconds: dict[str, float] = {}


def build_base() -> Path:
    """`build/` in the package's parent directory where it can be made and
    written, else the per-user cache."""
    local = Path(__file__).resolve().parents[2] / "build"
    try:
        local.mkdir(exist_ok=True)
        if os.access(local, os.W_OK):
            return local
    except OSError:   # a read-only parent, or a file in the way
        pass
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "sam2unet_torch"


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
    return build_base() / "torch_kernels" / h.hexdigest()[:16]


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


def _annotated(fn, name: str):
    """`fn` inside a profiler range named `name` while a profiler runs."""
    def call(*args):
        if not torch._C._autograd._profiler_enabled():
            return fn(*args)
        with torch.profiler.record_function(name):
            return fn(*args)
    return call


def library(name: str) -> types.SimpleNamespace:
    """The entry points of `lib<name>.so`, building every library first."""
    with _lock:
        if name not in _libs:
            out = build_all()
            for src in SOURCES:
                lib = ctypes.CDLL(str(out / f"lib{src}.so"),
                                  mode=(ctypes.RTLD_GLOBAL
                                        if src in SHARED_SOURCES
                                        else ctypes.RTLD_LOCAL))
                entries = {}
                for fn, argtypes in SIGNATURES[src].items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                    entries[fn] = _annotated(getattr(lib, fn), fn)
                _libs[src] = types.SimpleNamespace(**entries)
        return _libs[name]


def host_library(name: str, libs: tuple[str, ...] = ()) -> Path:
    """`csrc/<name>.cc` compiled with g++ (linked with `libs`) into
    `native/<hash>/lib<name>.so` under `build_base()` unless it is there;
    its path. A failed build raises."""
    source = CSRC / f"{name}.cc"
    h = hashlib.sha256(" ".join(HOST_FLAGS + libs).encode())
    h.update(source.read_bytes())
    out = build_base() / "native" / h.hexdigest()[:16]
    lib = out / f"lib{name}.so"
    with _lock:
        if not lib.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = out / f"lib{name}.so.tmp{os.getpid()}"
            proc = subprocess.run(["g++", *HOST_FLAGS, str(source), "-o",
                                   str(tmp), *libs], capture_output=True,
                                  text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed to build {source}:\n"
                                   f"{proc.stderr[-4000:]}")
            os.replace(tmp, lib)
    return lib


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
