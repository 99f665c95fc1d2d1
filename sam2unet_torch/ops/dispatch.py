"""Kernel dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version.

`force_plain()` sends CUDA tensors to the plain versions too; only the
tests and the comparison phases of `chip_smoke.py` use it. There is no
fallback: a CUDA tensor outside `force_plain()` launches the kernel or the
wrapper raises.

`launches` counts, per kernel wrapper, the calls that launched the kernel
(one per wrapper call, however many CUDA launches the kernel takes);
`variants` splits the same calls by (wrapper, shape variant).

`with_backward` makes a kernel launch one autograd node that saves only its
inputs and recomputes in its backward, as the JAX package's custom VJPs
do; `plain_vjp` is the backward through the plain version, for the cases
the JAX package also sends to its reference recompute.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
from collections.abc import Callable, Sequence

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


def workspace(device: torch.device, *nbytes: int) -> list[int]:
    """Pointers to buffers of these sizes in bytes, each 256-byte aligned,
    in one allocation: an entry point's scratch (one allocation, not one a
    buffer, before its first launch)."""
    at, offs = 0, []
    for n in nbytes:
        offs.append(at)
        at += -(-n // 256) * 256
    ws = torch.empty(at, dtype=torch.uint8, device=device)
    return [ws.data_ptr() + o for o in offs]


def cast(dtype: torch.dtype, *tensors: torch.Tensor | None) -> tuple:
    """Each tensor in `dtype` (itself where it already is; None stays)."""
    return tuple(t if t is None or t.dtype == dtype else t.to(dtype)
                 for t in tensors)


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """True when autograd records and one of `tensors` requires a gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _KernelFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fwd, bwd, *tensors):
        ctx.bwd = bwd
        ctx.save_for_backward(*tensors)
        return fwd(*tensors)

    @staticmethod
    def backward(ctx, *gys):
        gys = tuple(g.contiguous() for g in gys)
        grads = ctx.bwd(ctx.saved_tensors, gys[0] if len(gys) == 1 else gys,
                        ctx.needs_input_grad[2:])
        return (None, None, *grads)


def with_backward(fwd: Callable, bwd: Callable,
                  *tensors: torch.Tensor | None):
    """`fwd(*tensors)` (a tensor, or a tuple of them) as one autograd node.
    Its backward calls `bwd(tensors, gy, needs)` (gy a tuple where `fwd`
    returns one), which returns one gradient per tensor (None where `needs`
    is False). Only the inputs are saved."""
    return _KernelFunction.apply(fwd, bwd, *tensors)


def plain_vjp(fn: Callable, args: Sequence[torch.Tensor | None],
              gy, needs: Sequence[bool]) -> tuple:
    """Gradients of `fn(*args)` for the cotangent `gy` (a tuple where `fn`
    returns one), by autograd through `fn` recomputed (the plain version's
    backward), for the args whose `needs` is True; None for the others and
    for an arg `fn` does not use."""
    with torch.enable_grad():
        leaves = [None if a is None else a.detach().requires_grad_(bool(n))
                  for a, n in zip(args, needs)]
        want = [a for a in leaves if a is not None and a.requires_grad]
        got = iter(torch.autograd.grad(fn(*leaves), want, gy,
                                       allow_unused=True) if want else ())
    return tuple(next(got) if a is not None and a.requires_grad else None
                 for a in leaves)
