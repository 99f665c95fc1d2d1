"""Kernel dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version.

`force_plain()` sends CUDA tensors to the plain versions too; only the
tests and the comparison phases of `chip_smoke.py` use it. There is no
fallback: a CUDA tensor outside `force_plain()` launches the kernel or the
wrapper raises.

`launches` counts, per kernel wrapper, the calls that launched the kernel
(one per wrapper call, however many CUDA launches the kernel takes);
`variants` splits the same calls by (wrapper, shape variant).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars

import torch

_FORCE_PLAIN = contextvars.ContextVar("sam2unet_torch_force_plain",
                                      default=False)

launches: collections.Counter = collections.Counter()
variants: collections.Counter = collections.Counter()


def use_kernel(x: torch.Tensor) -> bool:
    """True when `x` must go through the CUDA kernel."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no kernel or plain path for device {x.device}")
    return not _FORCE_PLAIN.get()


@contextlib.contextmanager
def force_plain():
    token = _FORCE_PLAIN.set(True)
    try:
        yield
    finally:
        _FORCE_PLAIN.reset(token)


def reset_launches() -> None:
    launches.clear()
    variants.clear()


def count_launch(wrapper: str, variant: str) -> None:
    launches[wrapper] += 1
    variants[(wrapper, variant)] += 1


def check_kernel_args(x: torch.Tensor, *others: torch.Tensor | None) -> int:
    """Validate what the CUDA kernels take: CUDA tensors of one device and
    one dtype (bf16 or fp32), contiguous and 16-byte aligned. Returns 1 for
    bf16, 0 for fp32."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernels take bf16 or fp32, got {x.dtype}")
    for t in (x, *others):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"tensor on {t.device}, expected {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"mixed dtypes {t.dtype} and {x.dtype}: cast the "
                            "weights to the activations' dtype")
        if not t.is_contiguous():
            raise ValueError("kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("kernels take 16-byte aligned tensors")
    return int(x.dtype == torch.bfloat16)


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream
