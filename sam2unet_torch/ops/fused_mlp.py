"""K1: fused transformer MLP, `[LN ->] x@W1+b1 -> GELU -> @W2+b2 [-> GELU]
[-> +x]`, the block tail (LN2, 4c hidden, residual) and the PEFT adapter
(no LN, hidden 32, GELU on the output), and its backward kernels: K2, dx of
a frozen MLP with or without LN and the residual, and K3, dx and the fp32
weight gradients of the adapter; K15, LN -> x@W [+b] (`fused_ln_matmul`),
and K16, the same split into q, k and v (`fused_ln_qkv`). Counterpart of
sam2unet_tpu/ops/pallas/fused_mlp.py (`fused_mlp`, `_xla_mlp`,
`_mlp_bwd_dx`, `_adapter_bwd`, `fused_ln_matmul`, `_xla_ln_matmul`,
`fused_ln_qkv`, `_xla_ln_qkv`, `_f32_weights_overflow`); the kernels are
csrc/fused_mlp.cu (K1, K15, K16) and csrc/fused_mlp_bwd.cu (K2, K3), and
for K1 and K2 in bf16 at widths a TMA tensor map addresses csrc/mlp_sm90.cu
(wgmma fed by TMA; `_mlp_library` decides), for K3 there
csrc/block_bwd_sm90.cu (one streaming pass; `_adapter_bwd_library`).

Weights are in torch Linear layout (out, in). GELU is exact erf. The
kernels compute in x's dtype: fp32 master weights (the trainable adapters
under bf16) are cast to it, and K3's weight gradients come back in fp32.
fp32 calls with more than 12 MiB of weights take the plain versions, as
the JAX package's gate sends them to its XLA forms (`f32_weights_overflow`);
a bf16 call always launches. The kernels take any width C, hidden, Cout
and N and any LN width (csrc/gemm_any.cu past the 16-byte-vector
instances), as the JAX kernels do.
"""

from __future__ import annotations

import functools

import torch

from sam2unet_torch.nn.layers import gelu, layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch

ADAPTER_MAX_HIDDEN = 128  # K3's hidden width limit (fused_mlp.py:611)
WGRAD_ROWS = 256  # gemm.cuh WG_ROWS: tokens per weight-gradient partial
F32_WEIGHT_BYTES = 12 * 1024 * 1024  # the fp32 weight gate (fused_mlp.py:90)
SM90 = "mlp_sm90"   # K1's and K2's Hopper library (csrc/mlp_sm90.cu)
# the widest C of csrc/mlp_sm90.cu's adapter kernel (hidden 32): its 64-row
# x slot beside W1 and two W2 chunks fills shared memory at 18 64-column
# atoms (`adapter_plan`)
SM90_ADAPTER_MAX_C = 1152
SM90_BLOCK_BWD = "block_bwd_sm90"   # K3's and K7's Hopper library
# the widest C of K3's streaming kernel (csrc/block_bwd_sm90.cu, hidden 32):
# W1 and W2 beside two 64 x 64 slots of the ring fill shared memory at 22
# 64-column atoms (`k3_plan`)
SM90_ADAPTER_BWD_MAX_C = 1408
# the fp32 partial sums of one 64-column chunk in one block of that kernel
# (`kPartFloats`): dW2 | db2 and dW1^T in the accumulators' layout
K3_SM90_PART_FLOATS = 36 * 128


def f32_weights_overflow(x: torch.Tensor, *weights: torch.Tensor) -> bool:
    """The JAX package's `_f32_weights_overflow` (fused_mlp.py:76-90): True
    for 4-byte activations whose weights (not the biases) hold more than 12
    MiB as fp32. The JAX package then runs its XLA form (a TPU limit of the
    Pallas kernels' VMEM); the port runs the plain version there, so both
    packages launch the same kernels: the fp32 MLP at c = 768, hidden 3072
    (18.9 MB) takes the plain form, at c = 576, hidden 2304 (10.6 MB) K1."""
    if x.element_size() < 4:
        return False
    return sum(w.numel() for w in weights) * 4 > F32_WEIGHT_BYTES


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
    return c, hd, cout


def _mlp_library(dtype: torch.dtype, c: int, hd: int, cout: int,
                 gelu_out: bool = False, ln: bool = False) -> str | None:
    """The library of a K1 or K2 call whose rows are C, hidden and Cout
    wide: csrc/mlp_sm90.cu for bf16 with all three multiples of 8 elements,
    at any number of rows (16-byte rows: with the contiguous, 16-byte aligned
    tensors that `dispatch.check_kernel_args` demands of every call, what a
    TMA tensor map addresses); None leaves the call to the kernel's own
    library (fp32 on the CUDA-core GEMM, other widths on csrc/gemm_any.cu).
    GELU on K1's output (gelu_out) runs there only in the adapter kernel (no
    LN, hidden 32, Cout = C up to `SM90_ADAPTER_MAX_C`)."""
    ok = dtype == torch.bfloat16 and c % 8 == 0 and hd % 8 == 0 and cout % 8 == 0
    if gelu_out and (ln or hd != 32 or cout != c or c > SM90_ADAPTER_MAX_C):
        ok = False
    return SM90 if ok else None


def _adapter_bwd_library(dtype: torch.dtype, c: int, hd: int) -> str | None:
    """The library of a K3 call on rows of C: csrc/block_bwd_sm90.cu for
    bf16 with C a multiple of 8 elements up to `SM90_ADAPTER_BWD_MAX_C` and
    hidden 32, at any number of rows (contiguous, 16-byte aligned tensors,
    as `dispatch.check_kernel_args` demands: what a TMA tensor map
    addresses); None leaves it to csrc/fused_mlp_bwd.cu (fp32, other widths
    and hiddens)."""
    ok = (dtype == torch.bfloat16 and c % 8 == 0 and hd == 32
          and c <= SM90_ADAPTER_BWD_MAX_C)
    return SM90_BLOCK_BWD if ok else None


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    fn = (build.library(SM90).k1_fused_mlp_sm90
          if _mlp_library(x.dtype, c, hd, cout, gelu_out, ln_w is not None) else
          build.library("fused_mlp").k1_fused_mlp)
    err = fn(is_bf16, p(x), p(w1), p(b1), p(w2), p(b2), p(ln_w), p(ln_b),
             p(xn), p(hidden), p(out), m, c, hd, cout, int(residual),
             int(gelu_out), dispatch.stream_of(x))
    build.check(err, "fused_mlp")
    dispatch.count_launch("fused_mlp", "no_ln" if ln_w is None else "ln")
    return out


def _mlp_backward(saved, gy, needs, residual, gelu_out):
    """The JAX package's backward dispatch (fused_mlp.py:608-640): K3 for
    the adapter form with trainable weights, K2 for a frozen MLP without
    the output GELU (with or without LN and the residual), else the plain
    version's backward, recomputed. (fp32 weights past the gate never get
    here: `fused_mlp` runs them plain.)"""
    x, w1, b1, w2, b2, ln_w, ln_b = saved
    weight_grads = any(needs[1:])
    if (gelu_out and weight_grads and ln_w is None
            and w1.shape[0] <= ADAPTER_MAX_HIDDEN):
        return (*adapter_bwd(x, gy, w1, b1, w2, b2, residual), None, None)
    if not weight_grads and not gelu_out:
        return (mlp_bwd_dx(x, gy, w1, b1, w2, b2, ln_w, ln_b, residual),
                ) + (None,) * 6
    fn = functools.partial(plain_mlp, residual=residual, gelu_out=gelu_out)
    return dispatch.plain_vjp(fn, saved, gy, needs)


def fused_mlp(x: torch.Tensor, w1, b1, w2, b2, ln_w=None, ln_b=None,
              residual: bool = False, gelu_out: bool = False) -> torch.Tensor:
    """x: (..., C) -> (..., Cout). Differentiable: on the card the backward
    is K2 or K3 (or the plain recompute, as in the JAX package). fp32 past
    `f32_weights_overflow` runs the plain version, forward and backward."""
    if not dispatch.use_kernel(x) or f32_weights_overflow(x, w1, w2):
        return plain_mlp(x, w1, b1, w2, b2, ln_w, ln_b, residual, gelu_out)
    tensors = (x, w1, b1, w2, b2, ln_w, ln_b)
    if not dispatch.needs_grad(*tensors):
        return _mlp_kernel(*tensors, residual, gelu_out)
    fwd = functools.partial(_mlp_kernel, residual=residual, gelu_out=gelu_out)
    bwd = functools.partial(_mlp_backward, residual=residual, gelu_out=gelu_out)
    return dispatch.with_backward(fwd, bwd, *tensors)


def mlp_bwd_dx(x, gy, w1, b1, w2, b2, ln_w=None, ln_b=None,
               residual: bool = True) -> torch.Tensor:
    """K2: dx of [x +] MLP([LN](x)) for a cotangent gy (shaped as the
    output), the weights frozen: the block tail (LN and the residual) and
    the frozen `fused_mlp` without LN, without the residual, or without
    both. Plain version: autograd through `plain_mlp`."""
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_mlp, w1=w1, b1=b1, w2=w2, b2=b2,
                               ln_w=ln_w, ln_b=ln_b, residual=residual)
        return dispatch.plain_vjp(fn, (x,), gy, (True,))[0]
    w1, b1, w2, b2, ln_w, ln_b = dispatch.cast(x.dtype, w1, b1, w2, b2,
                                               ln_w, ln_b)
    gy = gy.contiguous()
    is_bf16 = dispatch.check_kernel_args(x, gy, w1, b1, w2, ln_w, ln_b)
    c, hd, cout = _check_mlp(x, w1, b1, w2, b2, ln_w, ln_b, residual)
    if gy.shape != (*x.shape[:-1], cout):
        raise ValueError("mlp_bwd_dx: gy must be shaped as the MLP's output")
    m = x.numel() // c
    xn, dz = ((torch.empty_like(x), torch.empty_like(x)) if ln_w is not None
              else (None, None))
    dx = torch.empty_like(x)
    dh = torch.empty((m, hd), dtype=x.dtype, device=x.device)
    p = dispatch.ptr
    if _mlp_library(x.dtype, c, hd, cout):
        # the pre-activation stays in the registers of the dual tile
        err = build.library(SM90).k2_mlp_bwd_dx_sm90(
            is_bf16, p(x), p(gy), p(w1), p(b1), p(w2), p(ln_w), p(ln_b),
            p(xn), p(dh), p(dz), p(dx), m, c, hd, cout, int(residual),
            dispatch.stream_of(x))
    else:
        hpre = torch.empty((m, hd), dtype=torch.float32, device=x.device)
        err = build.library("fused_mlp_bwd").k2_mlp_bwd_dx(
            is_bf16, p(x), p(gy), p(w1), p(b1), p(w2), p(ln_w), p(ln_b),
            p(xn), p(hpre), p(dh), p(dz), p(dx), m, c, hd, cout,
            int(residual), dispatch.stream_of(x))
    build.check(err, "mlp_bwd_dx")
    variant = (f"C={c}" + (",no_ln" if ln_w is None else "")
               + ("" if residual else ",no_residual"))
    dispatch.count_launch("mlp_bwd_dx", variant)
    return dx


def adapter_bwd(x, gy, w1, b1, w2, b2, residual: bool = True):
    """K3: (dx, dw1, db1, dw2, db2) of the adapter GELU(GELU(x W1^T + b1)
    W2^T + b2) [+ x] for a cotangent gy. The weight gradients are fp32 on
    the card, bit-identical from call to call (the blocks' partials are
    summed in a fixed order). `_adapter_bwd_library` picks the kernel.
    Plain version: autograd through `plain_mlp`."""
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
    f32 = dict(dtype=torch.float32, device=x.device)
    dw1, db1 = torch.empty((hd, c), **f32), torch.empty(hd, **f32)
    dw2, db2 = torch.empty((c, hd), **f32), torch.empty(c, **f32)
    p = dispatch.ptr
    if _adapter_bwd_library(x.dtype, c, hd):
        # one block per SM and per 64-row tile, each with its own partials
        blocks = min(-(-m // 64), _sm_count(x.device))
        part = torch.empty(blocks * (-(-c // 64) * K3_SM90_PART_FLOATS + 32),
                           **f32)
        dx = torch.empty_like(x)
        err = build.library(SM90_BLOCK_BWD).k3_adapter_bwd_sm90(
            is_bf16, p(x), p(gy), p(w1), p(b1), p(w2), p(b2), p(part), p(dx),
            p(dw1), p(db1), p(dw2), p(db2), m, c, hd, int(residual), blocks,
            dispatch.stream_of(x))
        build.check(err, "adapter_bwd")
        dispatch.count_launch("adapter_bwd", f"C={c}")
        return dx, dw1, db1, dw2, db2
    chunks = -(-m // WGRAD_ROWS)
    y1pre = torch.empty((m, hd), **f32)
    h, dy1 = (torch.empty((m, hd), dtype=x.dtype, device=x.device)
              for _ in range(2))
    dy2, dx = torch.empty_like(x), torch.empty_like(x)
    ws = torch.empty(chunks * (c * hd + max(c, hd)), **f32)
    err = build.library("fused_mlp_bwd").k3_adapter_bwd(
        is_bf16, p(x), p(gy), p(w1), p(b1), p(w2), p(b2), p(y1pre), p(h),
        p(dy2), p(dy1), p(dx), p(ws), p(dw1), p(db1), p(dw2), p(db2), m, c,
        hd, int(residual), dispatch.stream_of(x))
    build.check(err, "adapter_bwd")
    dispatch.count_launch("adapter_bwd", f"C={c}")
    return dx, dw1, db1, dw2, db2


# ------------------------------------------------------------ K15, K16


def plain_ln_matmul(x, w, b, ln_w, ln_b, add_bias: bool = True):
    """Plain version (reference `_xla_ln_matmul`, fused_mlp.py:176-187): LN
    in fp32 (eps 1e-6), rounded to x's dtype, the fp32 product [+ b], the
    output in x's dtype."""
    o = linear_f32(layer_norm_plain(x, ln_w, ln_b), w, b if add_bias else None)
    return o.to(x.dtype)


def plain_ln_qkv(x, w, b, ln_w, ln_b, add_bias: bool = True):
    """Plain version (reference `_xla_ln_qkv`): the three column blocks of
    `plain_ln_matmul`."""
    return tuple(plain_ln_matmul(x, w, b, ln_w, ln_b, add_bias).chunk(3, -1))


def _ln_matmul_kernel(x, w, b, ln_w, ln_b, add_bias: bool, split: bool):
    w, b, ln_w, ln_b = dispatch.cast(x.dtype, w, b, ln_w, ln_b)
    b = b if add_bias else None
    is_bf16 = dispatch.check_kernel_args(x, w, b, ln_w, ln_b)
    c, n = x.shape[-1], w.shape[0]
    if (w.shape != (n, c) or (b is not None and b.shape != (n,))
            or ln_w.shape != (c,) or ln_b.shape != (c,)):
        raise ValueError("fused_ln_matmul: weight shapes do not match x")
    if split and n % 3:
        raise ValueError(f"fused_ln_qkv: W's {n} rows do not split into q, k "
                         "and v")
    m = x.numel() // c
    xn = torch.empty_like(x)
    p, lib = dispatch.ptr, build.library("fused_mlp")
    if not split:
        out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
        err = lib.k15_ln_matmul(is_bf16, p(x), p(w), p(b), p(ln_w), p(ln_b),
                                p(xn), p(out), m, c, n, dispatch.stream_of(x))
        build.check(err, "fused_ln_matmul")
        dispatch.count_launch("fused_ln_matmul", f"C={c},N={n}")
        return out
    q, k, v = (torch.empty((*x.shape[:-1], n // 3), dtype=x.dtype,
                           device=x.device) for _ in range(3))
    err = lib.k16_ln_qkv(is_bf16, p(x), p(w), p(b), p(ln_w), p(ln_b), p(xn),
                         p(q), p(k), p(v), m, c, n, dispatch.stream_of(x))
    build.check(err, "fused_ln_qkv")
    dispatch.count_launch("fused_ln_qkv", f"C={c},N={n}")
    return q, k, v


def _ln_matmul(plain, x, w, b, ln_w, ln_b, add_bias, split):
    if not dispatch.use_kernel(x) or f32_weights_overflow(x, w):
        return plain(x, w, b, ln_w, ln_b, add_bias)
    tensors = (x, w, b, ln_w, ln_b)
    fwd = functools.partial(_ln_matmul_kernel, add_bias=add_bias, split=split)
    if not dispatch.needs_grad(*tensors):
        return fwd(*tensors)
    def bwd(saved, gy, needs):
        fn = functools.partial(plain, add_bias=add_bias)
        return dispatch.plain_vjp(fn, saved, gy, needs)

    return dispatch.with_backward(fwd, bwd, *tensors)


def fused_ln_matmul(x: torch.Tensor, w, b, ln_w, ln_b,
                    add_bias: bool = True) -> torch.Tensor:
    """K15: LN(x) (eps 1e-6) @ W^T [+ b], x: (..., C), W (N, C) -> (...,
    N). `add_bias=False` leaves the bias to a later pass. Differentiable:
    the backward is the plain version's, recomputed, as the JAX custom VJP
    differentiates `_xla_ln_matmul` (`_lm_bwd`, fused_mlp.py:330)."""
    return _ln_matmul(plain_ln_matmul, x, w, b, ln_w, ln_b, add_bias, False)


def fused_ln_qkv(x: torch.Tensor, w, b, ln_w, ln_b,
                 add_bias: bool = True) -> tuple:
    """K16: `fused_ln_matmul` with W the (3c, C) QKV weight, returned as
    three separate contiguous (..., c) tensors q, k and v. Backward: the
    plain recompute (`_lq_bwd`, fused_mlp.py:312)."""
    return _ln_matmul(plain_ln_qkv, x, w, b, ln_w, ln_b, add_bias, True)
