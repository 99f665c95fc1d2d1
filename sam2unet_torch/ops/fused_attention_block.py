"""K4, K6 and K12: the Hiera attention block LN1 -> QKV -> window attention
-> proj -> +x, and its long-sequence form over K10 (backward over K11); K5
and K7, the dx-only backward of K4 and K6. Counterpart of
sam2unet_tpu/ops/pallas/fused_attention_block.py (`fused_window_block` /
`_xla_window_block`, `fused_window_block_strips` / `_xla_strips`,
`_fused_strips_rem_fwd_impl` / `_xla_strips_rem`, `_strips_bwd`, `_bwd`);
the kernels are csrc/fused_attention_block.cu, csrc/flash_attention.cu,
csrc/flash_attention_bwd.cu (K11) and csrc/fused_attention_block_bwd.cu
(K5, K7).

Weights are in torch layout: w_qkv (3c, c) with output channels ordered
[3, heads, d], w_proj (c, c). The wrappers are differentiable. The backward
follows the JAX package's dispatch: the dx-only kernel where the block's
weights are frozen and the window fits its live budget (K5 for the strips,
K7 for n_pad = 0 window rows), the long form's backward over K11 for
windows past 1024 tokens, autograd through the plain version, recomputed,
where the JAX package runs its XLA recompute (the pad key, windows over the
budget, weights that need gradients outside K7's weight-gradient mode), and
an error where it runs a kernel not ported yet (K7's weight-gradient mode,
K13).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from sam2unet_torch.nn.layers import layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch
# past MAX_FULL_SEQ keys the XLA recompute's attention is the streaming
# flash attention, whose backward is K11 (flash_attention.py:44, :245-251)
from sam2unet_torch.ops.attention import (
    MAX_FULL_SEQ,
    attention_with_padkey,
    einsum_attention,
)
from sam2unet_torch.ops.flash_attention import (
    MAX_HEAD_DIM,
    flash_attention,
    flash_attention_bwd,
)
from sam2unet_torch.ops.fused_mlp import MAX_LN_WIDTH
from sam2unet_torch.ops.windowing import (
    window_merge_valid,
    window_partition,
    window_partition_valid,
    window_unpartition,
)

# one window's live bytes past which the JAX package leaves the whole-block
# kernel for LN -> QKV -> streaming flash attention -> proj
# (fused_attention_block.py:298-309)
LONG_SEQUENCE_BYTES = 12 * 1024 * 1024
# its backward's live budget for one window, dx only; half of it with the
# weight gradients (fused_attention_block.py:1956-1958, :1901-1905)
BWD_LIVE_BYTES = 8 * 1024 * 1024


def plain_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                       num_heads: int, n_pad: int = 0, residual: bool = True):
    """Plain version (reference `_xla_window_block`) on (nW, S, c)."""
    nw, s, c = x.shape
    d = c // num_heads
    y = layer_norm_plain(x, ln_w, ln_b)
    qkv = linear_f32(y, w_qkv, b_qkv).to(x.dtype).reshape(nw, s, 3,
                                                          num_heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if n_pad:
        b3 = b_qkv.reshape(3, num_heads, d)
        o = attention_with_padkey(q, k, v, b3[1], b3[2], n_pad)
    else:
        o = einsum_attention(q, k, v)
    out = linear_f32(o.reshape(nw, s, c), w_proj, b_proj).to(x.dtype)
    return x + out if residual else out


def plain_strips(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                 num_heads: int, window: int, residual: bool = True):
    """Plain version (reference `_xla_strips`) on (B, H, W, c):
    partition -> block -> unpartition (divisible grids, no pads)."""
    b, hh, wd, c = x.shape
    xw, pad_hw = window_partition(x, window)
    nw_, wh, ww, _ = xw.shape
    o = plain_window_block(xw.reshape(nw_, wh * ww, c), w_qkv, b_qkv, ln_w,
                           ln_b, w_proj, b_proj, num_heads, 0, residual)
    return window_unpartition(o.reshape(nw_, wh, ww, c), window, pad_hw,
                              (hh, wd))


def valid_group_blocks(block, x, *weights, num_heads: int, window: int,
                       residual: bool = True):
    """(B, H, W, c) on a remainder grid as pad-free valid-window groups, each
    through `block` (`plain_window_block` or `fused_window_block`) with the
    synthetic pad key of its n_pad, merged back (reference
    `_xla_strips_rem`)."""
    b, hh, wd, c = x.shape
    outs = []
    for g, n_pad in window_partition_valid(x, window):
        nw_, gh, gw, _ = g.shape
        o = block(g.reshape(nw_, gh * gw, c), *weights, num_heads=num_heads,
                  n_pad=n_pad, residual=residual)
        outs.append(o.reshape(nw_, gh, gw, c))
    return window_merge_valid(outs, b, hh, wd, window)


def plain_strips_rem(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                     num_heads: int, window: int, residual: bool = True):
    """Plain version of K12 (reference `_xla_strips_rem`)."""
    return valid_group_blocks(plain_window_block, x, w_qkv, b_qkv, ln_w, ln_b,
                              w_proj, b_proj, num_heads=num_heads,
                              window=window, residual=residual)


def long_sequence(s: int, c: int) -> bool:
    """The JAX package's live-VMEM gate (fused_attention_block.py:298-309):
    True where one window of S tokens leaves the whole-block kernel (K6) for
    the long form. S = 3600 at c = 384 (hiera_s@960 global blocks) is long;
    S = 484 at c = 576 (hiera_l@352) is not."""
    s16 = s + (-s) % 16
    return 8 * s16 * s16 + 14 * s16 * c > LONG_SEQUENCE_BYTES


def strips_rem_supported(h: int, w: int, window: int,
                         train: bool = False) -> bool:
    """Whether a block on an (h, w) grid takes K12 (the JAX package's
    `strips_rem_supported`, fused_attention_block.py:1485-1519, with the
    caller's remainder test, hiera.py:250-259): not training (K12 is eval
    only there), a window, a grid it does not divide or whose window**2 is
    not 16-aligned, and n_w = ceil(w/window) >= 4 (at n_w < 4, hiera_l@352
    stages 3-4, the valid groups won on the TPU).

    The JAX gate also needs the strip's live set under a VMEM cap, a TPU
    limit the Hopper kernel does not have, so that estimate is left out."""
    if window <= 0 or train:
        return False
    if h % window == 0 and w % window == 0 and (window * window) % 16 == 0:
        return False
    return -(-w // window) >= 4


def window_block_bwd_route(s: int, c: int, n_pad: int,
                           weight_grads: bool) -> str:
    """The backward the JAX package runs for `fused_window_block` on
    windows of S tokens at width c (fused_attention_block.py:1945-1991,
    flash_attention.py:439-464): "K7" (dx only, the weights frozen), "K7
    weight-grad" (its weight-gradient mode), "K11" (the XLA recompute of a
    window past 1024 tokens, whose attention backward is the streaming
    one: `_long_window_block_backward` here), or "plain" (the XLA
    recompute: the pad key, windows over the live budget). At hiera_l@352
    the 484-token global blocks take K7; at hiera_s@960 the 3600-token ones
    take K11."""
    s16 = s + (-s) % 16
    live = 12 * s16 * s16 + 14 * s16 * c
    if n_pad:
        return "plain"
    if not weight_grads and live <= BWD_LIVE_BYTES:
        return "K7"
    if (weight_grads and 16 * c * c <= BWD_LIVE_BYTES
            and live <= BWD_LIVE_BYTES // 2):
        return "K7 weight-grad"
    if s > MAX_FULL_SEQ and s % 16 == 0:
        return "K11"
    return "plain"


def strips_bwd_kernel(window: int, c: int) -> bool:
    """Whether the JAX package's backward of a frozen strip block on a
    divisible grid is K5 (fused_attention_block.py:1896-1911): a 16-aligned
    window whose live set fits the budget; else its XLA recompute."""
    s = window * window
    s16 = s + (-s) % 16
    return s % 16 == 0 and 12 * s16 * s16 + 18 * s16 * c <= BWD_LIVE_BYTES


def _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, num_heads):
    is_bf16 = dispatch.check_kernel_args(x, w_qkv, b_qkv, ln_w, ln_b,
                                         w_proj, b_proj)
    if (w_qkv.shape != (3 * c, c) or b_qkv.shape != (3 * c,)
            or ln_w.shape != (c,) or ln_b.shape != (c,)
            or w_proj.shape != (c, c) or b_proj.shape != (c,)):
        raise ValueError("attention block: weight shapes do not match x")
    d = c // num_heads
    if c % num_heads or d % 8 or d > MAX_HEAD_DIM or c > MAX_LN_WIDTH:
        raise ValueError(f"attention kernel needs head dim % 8 == 0 and "
                         f"<= {MAX_HEAD_DIM}, c <= {MAX_LN_WIDTH}; got c={c}, "
                         f"heads={num_heads}")
    return is_bf16


def _long_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                       num_heads: int, residual: bool):
    """LN -> QKV -> K10 -> proj -> +x with the reference's rounding points.
    The JAX package leaves LN and the two products to XLA; here they are
    plain PyTorch, and q/k/v reach K10 as strided views of the QKV output."""
    nw, s, c = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    y = layer_norm_plain(x, ln_w, ln_b)
    qkv = F.linear(y, w_qkv, b_qkv).reshape(nw, s, 3, num_heads,
                                            c // num_heads)
    o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    out = F.linear(o.reshape(nw, s, c), w_proj, b_proj)
    return x + out if residual else out


def _long_window_block_backward(saved, gy, needs, num_heads: int,
                                residual: bool):
    """Backward of the long form for windows past 1024 tokens, where the
    JAX package differentiates its XLA recompute through the streaming
    attention backward. Nothing of the forward is kept but the inputs: LN,
    the QKV product and K10 (o and lse) run again from x, as `jax.vjp` of
    `_xla_window_block` runs them, so a train step launches K10 twice and
    K11 once per long block. Then dO = gy W_proj, K11 writes dq, dk and dv
    into the three channel blocks of one dqkv buffer, dLN(x) = dqkv W_qkv,
    and the LN backward adds gy for the residual. LN and the products are
    plain PyTorch, as the JAX package leaves them to XLA.

    With frozen weights only dx is computed. Weights that need gradients
    take autograd through `_long_window_block` recomputed, whose
    `flash_attention` node is K11 too."""
    if any(needs[1:]):
        fn = functools.partial(_long_window_block, num_heads=num_heads,
                               residual=residual)
        return dispatch.plain_vjp(fn, saved, gy, needs)
    x = saved[0]
    nw, s, c = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj = dispatch.cast(x.dtype, *saved[1:6])
    with torch.enable_grad():
        x_in = x.detach().requires_grad_(True)
        y = layer_norm_plain(x_in, ln_w, ln_b)
    with torch.no_grad():
        qkv = F.linear(y, w_qkv, b_qkv).reshape(nw, s, 3, num_heads,
                                                c // num_heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        o, lse = flash_attention(q, k, v, return_lse=True)
        dout = (gy.reshape(nw * s, c) @ w_proj).reshape(o.shape)
        dqkv = torch.empty_like(qkv)
        flash_attention_bwd(q, k, v, o, lse, dout,
                            out=(dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2]))
        dy = (dqkv.reshape(nw * s, 3 * c) @ w_qkv).reshape(x.shape)
    dx, = torch.autograd.grad(y, x_in, dy)
    return (dx + gy if residual else dx,) + (None,) * 6


def _differentiable(fwd, bwd, x, weights, **kw):
    """`fwd(x, *weights, **kw)` on the card; as one autograd node whose
    backward is `bwd(saved, gy, needs, **kw)` when autograd records and
    something requires a gradient."""
    if not dispatch.needs_grad(x, *weights):
        return fwd(x, *weights, **kw)
    return dispatch.with_backward(functools.partial(fwd, **kw),
                                  functools.partial(bwd, **kw), x, *weights)


def _plain_backward(plain, saved, gy, needs, **kw):
    return dispatch.plain_vjp(functools.partial(plain, **kw), saved, gy, needs)


def fused_window_block(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                       b_proj, num_heads: int, n_pad: int = 0,
                       residual: bool = True) -> torch.Tensor:
    """x: (nW, S, c) window rows -> (nW, S, c). n_pad > 0 adds the
    synthetic pad key standing for the reference's zero-padded tokens.
    K6, or past `long_sequence` the long form over K10 (the JAX package
    runs plain attention there for S <= 1024; the port runs K10 at any S).
    Backward: `window_block_bwd_route` (K7, the long form's backward over
    K11, or the plain recompute)."""
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    if not dispatch.use_kernel(x):
        return plain_window_block(x, *weights, num_heads, n_pad, residual)
    return _differentiable(_window_block_kernel, _window_block_backward, x,
                           weights, num_heads=num_heads, n_pad=n_pad,
                           residual=residual)


def _window_block_backward(saved, gy, needs, num_heads, n_pad, residual):
    x = saved[0]
    route = window_block_bwd_route(x.shape[1], x.shape[2], n_pad,
                                   any(needs[1:]))
    if route == "K7":
        return (window_block_bwd(x, gy, *saved[1:], num_heads=num_heads,
                                 residual=residual),) + (None,) * 6
    if route == "K11":
        return _long_window_block_backward(saved, gy, needs, num_heads,
                                           residual)
    if route != "plain":
        dispatch.not_ported(route, "1")
    return _plain_backward(plain_window_block, saved, gy, needs,
                           num_heads=num_heads, n_pad=n_pad, residual=residual)


def _window_block_kernel(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                         num_heads: int, n_pad: int, residual: bool):
    nw, s, c = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    is_bf16 = _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                           num_heads)
    if long_sequence(s, c):
        if n_pad:
            raise ValueError(f"no kernel for a pad key over {s} tokens")
        return _long_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                                  num_heads, residual)
    xn = torch.empty_like(x)
    qkv = torch.empty((nw * s, 3 * c), dtype=x.dtype, device=x.device)
    o = torch.empty((nw * s, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    p = dispatch.ptr
    err = build.library("fused_attention_block").k6_window_block(
        is_bf16, p(x), p(w_qkv), p(b_qkv), p(ln_w), p(ln_b), p(w_proj),
        p(b_proj), p(xn), p(qkv), p(o), p(out), nw, s, c, num_heads, n_pad,
        int(residual), dispatch.stream_of(x))
    build.check(err, "fused_window_block")
    dispatch.count_launch("fused_window_block", f"S={s},n_pad={n_pad}")
    return out


def _grid_block(entry: str, x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                num_heads: int, window: int, residual: bool):
    """K4 or K12 on (B, H, W, c): the window partition happens inside the
    kernel's addressing."""
    b, hh, wd, c = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    is_bf16 = _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                           num_heads)
    m = b * hh * wd
    xn = torch.empty_like(x)
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    o = torch.empty((m, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    p = dispatch.ptr
    err = getattr(build.library("fused_attention_block"), entry)(
        is_bf16, p(x), p(w_qkv), p(b_qkv), p(ln_w), p(ln_b), p(w_proj),
        p(b_proj), p(xn), p(qkv), p(o), p(out), b, hh, wd, c, num_heads,
        window, int(residual), dispatch.stream_of(x))
    build.check(err, entry)
    return out


def fused_window_block_strips(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b,
                              w_proj, b_proj, num_heads: int, window: int,
                              residual: bool = True) -> torch.Tensor:
    """K4. x: (B, H, W, c) on a window-divisible grid -> same shape.
    Backward: K5 where the weights are frozen and `strips_bwd_kernel`
    holds, else the plain recompute."""
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    if not dispatch.use_kernel(x):
        return plain_strips(x, *weights, num_heads, window, residual)
    if x.shape[1] % window or x.shape[2] % window:
        raise ValueError(f"strip kernel needs a divisible grid, got "
                         f"{x.shape[1]}x{x.shape[2]} with window {window}")
    return _differentiable(_strips_kernel, _strips_backward, x, weights,
                           num_heads=num_heads, window=window,
                           residual=residual)


def _strips_kernel(x, *weights, num_heads: int, window: int, residual: bool):
    out = _grid_block("k4_window_block_strips", x, *weights, num_heads,
                      window, residual)
    dispatch.count_launch("fused_window_block_strips", f"window={window}")
    return out


def _strips_backward(saved, gy, needs, num_heads, window, residual):
    x = saved[0]
    if not any(needs[1:]) and strips_bwd_kernel(window, x.shape[-1]):
        return (window_block_strips_bwd(x, gy, *saved[1:], num_heads=num_heads,
                                        window=window, residual=residual),
                ) + (None,) * 6
    return _plain_backward(plain_strips, saved, gy, needs, num_heads=num_heads,
                           window=window, residual=residual)


def fused_window_block_strips_rem(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b,
                                  w_proj, b_proj, num_heads: int, window: int,
                                  residual: bool = True) -> torch.Tensor:
    """K12. x: (B, H, W, c) on any grid -> same shape; each edge window
    attends over its tokens inside the grid plus the synthetic pad key of
    the reference's post-LN zero pads, so the result equals the
    valid-group form. Eval only in the model. Backward: the plain recompute
    where the weights need gradients (the JAX package's XLA recompute); for
    frozen weights the JAX package runs K13, not ported yet, so it
    raises."""
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    if not dispatch.use_kernel(x):
        return plain_strips_rem(x, *weights, num_heads, window, residual)
    if window <= 0:
        raise ValueError(f"remainder strip kernel needs a window, got {window}")
    return _differentiable(_strips_rem_kernel, _strips_rem_backward, x,
                           weights, num_heads=num_heads, window=window,
                           residual=residual)


def _strips_rem_kernel(x, *weights, num_heads: int, window: int,
                       residual: bool):
    out = _grid_block("k12_window_block_strips_rem", x, *weights, num_heads,
                      window, residual)
    dispatch.count_launch("fused_window_block_strips_rem", f"window={window}")
    return out


def _strips_rem_backward(saved, gy, needs, **kw):
    if not any(needs[1:]):
        dispatch.not_ported("K13 (the remainder strips' backward)", "2")
    return _plain_backward(plain_strips_rem, saved, gy, needs, **kw)


# ------------------------------------------------------------- backward


def _bwd_buffers(x, c, nh, m, mq, windows, sq):
    """Scratch of the dx-only backward kernels: LN(x), qkv, o, lse, dO, D,
    dqkv, dLN(x), dx."""
    dev, dt = x.device, x.dtype
    rows = lambda n, w: torch.empty((n, w), dtype=dt, device=dev)  # noqa: E731
    return dict(
        xn=torch.empty_like(x), qkv=rows(m, 3 * c), o=rows(mq, c),
        lse=torch.empty((windows * nh, sq), dtype=torch.float32, device=dev),
        dout=rows(mq, c),
        D=torch.empty(mq * nh, dtype=torch.float32, device=dev),
        dqkv=rows(m, 3 * c), dxn=torch.empty_like(x), dx=torch.empty_like(x))


def _block_bwd_args(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                    num_heads):
    c = x.shape[-1]
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    gy = gy.contiguous()
    if gy.shape != x.shape:
        raise ValueError("attention block backward: gy must be shaped as x")
    is_bf16 = _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                           num_heads)
    dispatch.check_kernel_args(x, gy)
    return is_bf16, gy, (w_qkv, b_qkv, ln_w, ln_b, w_proj)


def _launch_bwd(entry, is_bf16, x, gy, weights, buf, *geometry):
    p = dispatch.ptr
    err = getattr(build.library("fused_attention_block_bwd"), entry)(
        is_bf16, p(x), p(gy), *(p(w) for w in weights),
        *(p(buf[k]) for k in ("xn", "qkv", "o", "lse", "dout", "D", "dqkv",
                              "dxn", "dx")),
        *geometry, dispatch.stream_of(x))
    build.check(err, entry)
    return buf["dx"]


def window_block_bwd(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                     num_heads: int, residual: bool = True) -> torch.Tensor:
    """K7: dx of `fused_window_block` on (nW, S, c) without a pad key, for
    a cotangent gy, the weights frozen; recomputed from x. Plain version:
    autograd through `plain_window_block`."""
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_window_block, w_qkv=w_qkv, b_qkv=b_qkv,
                               ln_w=ln_w, ln_b=ln_b, w_proj=w_proj,
                               b_proj=b_proj, num_heads=num_heads,
                               residual=residual)
        return dispatch.plain_vjp(fn, (x,), gy, (True,))[0]
    nw, s, c = x.shape
    is_bf16, gy, weights = _block_bwd_args(x, gy, w_qkv, b_qkv, ln_w, ln_b,
                                           w_proj, b_proj, num_heads)
    buf = _bwd_buffers(x, c, num_heads, nw * s, nw * s, nw, s)
    dx = _launch_bwd("k7_window_block_bwd", is_bf16, x, gy, weights, buf, nw,
                     s, c, num_heads, int(residual))
    dispatch.count_launch("window_block_bwd", f"S={s}")
    return dx


def window_block_strips_bwd(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                            num_heads: int, window: int,
                            residual: bool = True) -> torch.Tensor:
    """K5: dx of `fused_window_block_strips` on (B, H, W, c), a
    window-divisible grid, for a cotangent gy, the weights frozen;
    recomputed from x. Plain version: autograd through `plain_strips`."""
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_strips, w_qkv=w_qkv, b_qkv=b_qkv,
                               ln_w=ln_w, ln_b=ln_b, w_proj=w_proj,
                               b_proj=b_proj, num_heads=num_heads,
                               window=window, residual=residual)
        return dispatch.plain_vjp(fn, (x,), gy, (True,))[0]
    b, hh, wd, c = x.shape
    if window <= 0 or hh % window or wd % window:
        raise ValueError(f"strip backward needs a divisible grid, got "
                         f"{hh}x{wd} with window {window}")
    is_bf16, gy, weights = _block_bwd_args(x, gy, w_qkv, b_qkv, ln_w, ln_b,
                                           w_proj, b_proj, num_heads)
    m, windows = b * hh * wd, b * (hh // window) * (wd // window)
    buf = _bwd_buffers(x, c, num_heads, m, m, windows, window * window)
    dx = _launch_bwd("k5_window_block_strips_bwd", is_bf16, x, gy, weights,
                     buf, b, hh, wd, c, num_heads, window, int(residual))
    dispatch.count_launch("window_block_strips_bwd", f"window={window}")
    return dx
