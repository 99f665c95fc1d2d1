"""K10: streaming flash attention over (B, S, heads, d) with the lse.
Counterpart of sam2unet_tpu/ops/pallas/flash_attention.py
(`_stream_fwd_impl`, oracle `_xla_attention`); the kernel is
csrc/flash_attention.cu.

q, k and v may be strided views, as the long global-attention blocks pass
them (channel slices of the QKV output, rows of 3c): the kernel reads them
where they lie, so no copy is made.
"""

from __future__ import annotations

import math

import torch

from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.attention import sdpa

MAX_HEAD_DIM = 96  # attention.cuh instantiates head dims up to 6 x 16


def plain_flash_attention(q, k, v, scale: float | None = None,
                          return_lse: bool = False):
    """Plain version: `sdpa` (fp32 scores and softmax, probabilities in the
    working type) and, on request, the logsumexp of the scaled fp32 scores
    as (B*heads, Sq)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o = sdpa(q, k, v, scale)
    if not return_lse:
        return o
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    b, h, sq, _ = s.shape
    return o, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


def _check_view(t: torch.Tensor, what: str) -> None:
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {what} must be (B, S, heads, d) "
                         "with unit stride over d")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {what} needs a 16-byte aligned "
                         "base and strides that are multiples of 8 elements")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, return_lse: bool = False):
    """softmax(q k^T * scale) v over (B, S, heads, d) -> o (B, Sq, heads, d)
    in the working type, and with `return_lse` the (B*heads, Sq) fp32
    log-sum-exp of the scaled scores."""
    if not dispatch.use_kernel(q):
        return plain_flash_attention(q, k, v, scale, return_lse)
    b, sq, nh, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, nh, d) or v.shape != k.shape:
        raise ValueError("flash_attention: q, k, v shapes do not agree")
    if k.stride() != v.stride():
        raise ValueError("flash_attention: k and v need the same strides")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _check_view(t, what)
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernels take bf16 or fp32, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel needs head dim % 8 == 0 and "
                         f"<= {MAX_HEAD_DIM}, got {d}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * nh, sq), dtype=torch.float32, device=q.device)
    p = dispatch.ptr
    err = build.library("flash_attention").k10_flash_attention(
        int(q.dtype == torch.bfloat16), p(q), p(k), p(v), p(o), p(lse), b, sq,
        sk, nh, d, *q.stride()[:3], *k.stride()[:3], scale,
        dispatch.stream_of(q))
    build.check(err, "flash_attention")
    dispatch.count_launch("flash_attention", f"S={sk}")
    return (o, lse) if return_lse else o
