"""K1: fused transformer MLP, `[LN ->] x@W1+b1 -> GELU -> @W2+b2 [-> GELU]
[-> +x]`, the block tail (LN2, 4c hidden, residual) and the PEFT adapter
(no LN, hidden 32, GELU on the output). Counterpart of
sam2unet_tpu/ops/pallas/fused_mlp.py (`fused_mlp`, `_xla_mlp`); the
kernel is csrc/fused_mlp.cu.

Weights are in torch Linear layout (out, in). GELU is exact erf.
"""

from __future__ import annotations

import torch

from sam2unet_torch.nn.layers import gelu, layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch

MAX_LN_WIDTH = 2048  # gemm.cuh LN_MAXV * 256


def plain_mlp(x, w1, b1, w2, b2, ln_w=None, ln_b=None, residual=False,
              gelu_out=False):
    """Plain version (reference `_xla_mlp`): fp32 products, hidden rounded
    to x's dtype after the GELU, output rounded before the residual."""
    y = x if ln_w is None else layer_norm_plain(x, ln_w, ln_b)
    h = gelu(linear_f32(y, w1, b1)).to(x.dtype)
    o = linear_f32(h, w2, b2)
    if gelu_out:
        o = gelu(o)
    o = o.to(x.dtype)
    return x + o if residual else o


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2, ln_w=None, ln_b=None,
              residual: bool = False, gelu_out: bool = False) -> torch.Tensor:
    """x: (..., C) -> (..., Cout)."""
    if not dispatch.use_kernel(x):
        return plain_mlp(x, w1, b1, w2, b2, ln_w, ln_b, residual, gelu_out)
    is_bf16 = dispatch.check_kernel_args(x, w1, b1, w2, b2, ln_w, ln_b)
    c = x.shape[-1]
    hd, cout = w1.shape[0], w2.shape[0]
    if (w1.shape != (hd, c) or w2.shape != (cout, hd) or b1.shape != (hd,)
            or b2.shape != (cout,)):
        raise ValueError("fused_mlp: weight shapes do not match x")
    if (ln_w is None) != (ln_b is None) or (
            ln_w is not None and (ln_w.shape != (c,) or ln_b.shape != (c,))):
        raise ValueError("fused_mlp: LN needs weight and bias of shape (C,)")
    if residual and cout != c:
        raise ValueError("fused_mlp: the residual needs Cout == C")
    if c % 8 or hd % 8 or cout % 8:
        raise ValueError("fused_mlp kernel needs C, hidden, Cout % 8 == 0")
    if ln_w is not None and c > MAX_LN_WIDTH:
        raise ValueError(f"fused_mlp kernel's LayerNorm takes C <= {MAX_LN_WIDTH}")
    m = x.numel() // c
    xn = None if ln_w is None else torch.empty_like(x)
    hidden = torch.empty((m, hd), dtype=x.dtype, device=x.device)
    out = torch.empty((*x.shape[:-1], cout), dtype=x.dtype, device=x.device)
    p = dispatch.ptr
    err = build.library("fused_mlp").k1_fused_mlp(
        is_bf16, p(x), p(w1), p(b1), p(w2), p(b2), p(ln_w), p(ln_b), p(xn),
        p(hidden), p(out), m, c, hd, cout, int(residual), int(gelu_out),
        dispatch.stream_of(x))
    build.check(err, "fused_mlp")
    dispatch.count_launch("fused_mlp", "no_ln" if ln_w is None else "ln")
    return out
