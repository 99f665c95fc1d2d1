"""K1: fused transformer MLP, `[LN ->] x@W1+b1 -> GELU -> @W2+b2 [-> GELU]
[-> +x]`, the block tail (LN2, 4c hidden, residual) and the PEFT adapter
(no LN, hidden 32, GELU on the output), and its backward kernels: K2, dx of
the frozen tail, and K3, dx and the fp32 weight gradients of the adapter.
Counterpart of sam2unet_tpu/ops/pallas/fused_mlp.py (`fused_mlp`,
`_xla_mlp`, `_mlp_bwd_dx`, `_adapter_bwd`); the kernels are
csrc/fused_mlp.cu (K1) and csrc/fused_mlp_bwd.cu (K2, K3).

Weights are in torch Linear layout (out, in). GELU is exact erf. The
kernels compute in x's dtype: fp32 master weights (the trainable adapters
under bf16) are cast to it, and K3's weight gradients come back in fp32.
"""

from __future__ import annotations

import functools

import torch

from sam2unet_torch.nn.layers import gelu, layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch

MAX_LN_WIDTH = 2048  # gemm.cuh LN_MAXV * 256
ADAPTER_MAX_HIDDEN = 128  # K3's hidden width limit (fused_mlp.py:611)
WGRAD_ROWS = 256  # gemm.cuh WG_ROWS: tokens per weight-gradient partial


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


def _check_mlp(x, w1, b1, w2, b2, ln_w, ln_b, residual):
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
    return c, hd, cout


def _mlp_kernel(x, w1, b1, w2, b2, ln_w, ln_b, residual, gelu_out):
    w1, b1, w2, b2, ln_w, ln_b = dispatch.cast(x.dtype, w1, b1, w2, b2, ln_w,
                                               ln_b)
    is_bf16 = dispatch.check_kernel_args(x, w1, b1, w2, b2, ln_w, ln_b)
    c, hd, cout = _check_mlp(x, w1, b1, w2, b2, ln_w, ln_b, residual)
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


def _mlp_backward(saved, gy, needs, residual, gelu_out):
    """The JAX package's backward dispatch (fused_mlp.py:608-640): K3 for
    the adapter form with trainable weights, K2 for a frozen MLP without
    the output GELU, else the plain version's backward, recomputed. K2 is
    ported for the block tail's form (LN and the residual); a frozen MLP
    without them raises."""
    x, w1, b1, w2, b2, ln_w, ln_b = saved
    weight_grads = any(needs[1:])
    if (gelu_out and weight_grads and ln_w is None
            and w1.shape[0] <= ADAPTER_MAX_HIDDEN):
        return (*adapter_bwd(x, gy, w1, b1, w2, b2, residual), None, None)
    if not weight_grads and not gelu_out:
        if ln_w is None or not residual:
            dispatch.not_ported("K2 without LayerNorm or the residual", "1")
        return (mlp_bwd_dx(x, gy, w1, b1, w2, b2, ln_w, ln_b),) + (None,) * 6
    fn = functools.partial(plain_mlp, residual=residual, gelu_out=gelu_out)
    return dispatch.plain_vjp(fn, saved, gy, needs)


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2, ln_w=None, ln_b=None,
              residual: bool = False, gelu_out: bool = False) -> torch.Tensor:
    """x: (..., C) -> (..., Cout). Differentiable: on the card the backward
    is K2 or K3 (or the plain recompute, as in the JAX package)."""
    if not dispatch.use_kernel(x):
        return plain_mlp(x, w1, b1, w2, b2, ln_w, ln_b, residual, gelu_out)
    tensors = (x, w1, b1, w2, b2, ln_w, ln_b)
    if not dispatch.needs_grad(*tensors):
        return _mlp_kernel(*tensors, residual, gelu_out)
    fwd = functools.partial(_mlp_kernel, residual=residual, gelu_out=gelu_out)
    bwd = functools.partial(_mlp_backward, residual=residual, gelu_out=gelu_out)
    return dispatch.with_backward(fwd, bwd, *tensors)


def mlp_bwd_dx(x, gy, w1, b1, w2, b2, ln_w, ln_b) -> torch.Tensor:
    """K2: dx of x + MLP(LN(x)) for a cotangent gy, the weights frozen.
    Plain version: autograd through `plain_mlp`."""
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_mlp, w1=w1, b1=b1, w2=w2, b2=b2,
                               ln_w=ln_w, ln_b=ln_b, residual=True)
        return dispatch.plain_vjp(fn, (x,), gy, (True,))[0]
    w1, b1, w2, b2, ln_w, ln_b = dispatch.cast(x.dtype, w1, b1, w2, b2,
                                               ln_w, ln_b)
    gy = gy.contiguous()
    is_bf16 = dispatch.check_kernel_args(x, gy, w1, b1, w2, ln_w, ln_b)
    c, hd, _ = _check_mlp(x, w1, b1, w2, b2, ln_w, ln_b, True)
    if ln_w is None or gy.shape != x.shape:
        raise ValueError("mlp_bwd_dx: needs the LN tail and gy shaped as x")
    m = x.numel() // c
    xn, dz, dx = (torch.empty_like(x) for _ in range(3))
    hpre = torch.empty((m, hd), dtype=torch.float32, device=x.device)
    dh = torch.empty((m, hd), dtype=x.dtype, device=x.device)
    p = dispatch.ptr
    err = build.library("fused_mlp_bwd").k2_mlp_bwd_dx(
        is_bf16, p(x), p(gy), p(w1), p(b1), p(w2), p(ln_w), p(ln_b), p(xn),
        p(hpre), p(dh), p(dz), p(dx), m, c, hd, dispatch.stream_of(x))
    build.check(err, "mlp_bwd_dx")
    dispatch.count_launch("mlp_bwd_dx", f"C={c}")
    return dx


def adapter_bwd(x, gy, w1, b1, w2, b2, residual: bool = True):
    """K3: (dx, dw1, db1, dw2, db2) of the adapter GELU(GELU(x W1^T + b1)
    W2^T + b2) [+ x] for a cotangent gy. The weight gradients are fp32 on
    the card. Plain version: autograd through `plain_mlp`."""
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_mlp, residual=residual, gelu_out=True)
        return dispatch.plain_vjp(fn, (x, w1, b1, w2, b2), gy, (True,) * 5)
    w1, b1, w2, b2 = dispatch.cast(x.dtype, w1, b1, w2, b2)
    gy = gy.contiguous()
    is_bf16 = dispatch.check_kernel_args(x, gy, w1, b1, w2, b2)
    c, hd, cout = _check_mlp(x, w1, b1, w2, b2, None, None, residual)
    if cout != c or gy.shape != x.shape:
        raise ValueError("adapter_bwd: needs Cout == C and gy shaped as x")
    m = x.numel() // c
    chunks = -(-m // WGRAD_ROWS)
    f32 = dict(dtype=torch.float32, device=x.device)
    y1pre = torch.empty((m, hd), **f32)
    h, dy1 = (torch.empty((m, hd), dtype=x.dtype, device=x.device)
              for _ in range(2))
    dy2, dx = torch.empty_like(x), torch.empty_like(x)
    ws = torch.empty(chunks * (c * hd + max(c, hd)), **f32)
    dw1, db1 = torch.empty((hd, c), **f32), torch.empty(hd, **f32)
    dw2, db2 = torch.empty((c, hd), **f32), torch.empty(c, **f32)
    p = dispatch.ptr
    err = build.library("fused_mlp_bwd").k3_adapter_bwd(
        is_bf16, p(x), p(gy), p(w1), p(b1), p(w2), p(b2), p(y1pre), p(h),
        p(dy2), p(dy1), p(dx), p(ws), p(dw1), p(db1), p(dw2), p(db2), m, c,
        hd, int(residual), dispatch.stream_of(x))
    build.check(err, "adapter_bwd")
    dispatch.count_launch("adapter_bwd", f"C={c}")
    return dx, dw1, db1, dw2, db2
