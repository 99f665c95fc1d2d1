"""K8: the Hiera q-pool transition block, (B, H, W, cin) -> (B, H/2, W/2,
cout): LN -> shortcut Dense + 2x2 max-pool; windowed QKV -> in-window 2x2
q-pool -> attention -> proj -> + shortcut; K9, its dx-only backward.
Counterpart of sam2unet_tpu/ops/pallas/fused_transition.py
(`fused_transition_block`, `_xla_transition`, `_tr_bwd`,
`transition_bwd_supported`); the kernels are csrc/fused_transition.cu (K8)
and csrc/fused_transition_bwd.cu (K9).

Weights in torch layout: w_qkv (3*cout, cin), w_proj (cout, cout),
w_short (cout, cin). The wrapper is differentiable: K9 where the weights
are frozen and the JAX package's gate holds, else autograd through the
plain version, recomputed.
"""

from __future__ import annotations

import functools

import torch

from sam2unet_torch.nn.layers import layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.attention import sdpa
from sam2unet_torch.ops.fused_attention_block import MAX_HEAD_DIM
from sam2unet_torch.ops.fused_mlp import MAX_LN_WIDTH
from sam2unet_torch.ops.pooling import max_pool2d
from sam2unet_torch.ops.windowing import window_partition, window_unpartition


def plain_transition(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short,
                     b_short, num_heads: int, window: int):
    """Plain version (reference `_xla_transition`), divisible even grids."""
    b, hh, wd, _ = x.shape
    cout = w_proj.shape[0]
    d = cout // num_heads
    dt = x.dtype
    xn = layer_norm_plain(x, ln_w, ln_b)
    shortcut = max_pool2d(linear_f32(xn, w_short, b_short).to(dt), 2, 2)
    xw, _ = window_partition(xn, window)
    nw_, wh, ww, _ = xw.shape
    qkv = linear_f32(xw, w_qkv, b_qkv).to(dt)
    q = max_pool2d(qkv[..., :cout], 2, 2)
    k = qkv[..., cout: 2 * cout].reshape(nw_, wh * ww, num_heads, d)
    v = qkv[..., 2 * cout:].reshape(nw_, wh * ww, num_heads, d)
    hq, wq = q.shape[1], q.shape[2]
    o = sdpa(q.reshape(nw_, hq * wq, num_heads, d), k, v)
    o = linear_f32(o.reshape(nw_, hq, wq, cout), w_proj, b_proj).to(dt)
    attn = window_unpartition(o, window // 2, (hh // 2, wd // 2),
                              (hh // 2, wd // 2))
    return shortcut + attn


def transition_bwd_supported(window: int, cout: int, wd: int,
                             cin: int) -> bool:
    """The JAX package's gate for taking the fused transition under train
    (fused_transition.py:199-219, consulted at hiera.py:318-327): a
    16-aligned window and one strip of windows' live set within 8 MiB. At
    hiera_l@352 both divisible transitions pass; at hiera_s@960 the 240x240
    window-8 transition does not and trains through the unfused path."""
    s = window * window
    if s % 16:
        return False
    n_w = wd // window
    strip_live = n_w * (8 * s * s + 22 * s * cout) + 4 * window * wd * cin
    return strip_live <= 8 * 1024 * 1024


def _check_transition(x, window, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                      w_short, b_short, num_heads):
    b, hh, wd, cin = x.shape
    is_bf16 = dispatch.check_kernel_args(x, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                                         b_proj, w_short, b_short)
    cout = w_proj.shape[0]
    if (w_qkv.shape != (3 * cout, cin) or b_qkv.shape != (3 * cout,)
            or ln_w.shape != (cin,) or ln_b.shape != (cin,)
            or w_proj.shape != (cout, cout) or b_proj.shape != (cout,)
            or w_short.shape != (cout, cin) or b_short.shape != (cout,)):
        raise ValueError("transition: weight shapes do not match x")
    d = cout // num_heads
    if (cout % num_heads or d % 8 or d > MAX_HEAD_DIM or cin % 8
            or cin > MAX_LN_WIDTH):
        raise ValueError(f"transition kernel needs cin % 8 == 0, cin <= "
                         f"{MAX_LN_WIDTH} and a head dim % 8 == 0, <= "
                         f"{MAX_HEAD_DIM}")
    return is_bf16, cout


def _check_grid(x, window):
    hh, wd = x.shape[1], x.shape[2]
    if window % 2 or hh % window or wd % window:
        raise ValueError(f"transition needs an even window dividing the grid, "
                         f"got {hh}x{wd} with window {window}")


def _transition_backward(saved, gy, needs, num_heads, window):
    """K9 where the weights are frozen and `transition_bwd_supported`
    holds, else the plain version's backward, as the JAX package's
    (fused_transition.py:541-580)."""
    x, w_proj = saved[0], saved[5]
    if not any(needs[1:]) and transition_bwd_supported(
            window, w_proj.shape[0], x.shape[2], x.shape[3]):
        return (transition_bwd(x, gy, *saved[1:], num_heads=num_heads,
                               window=window),) + (None,) * 8
    fn = functools.partial(plain_transition, num_heads=num_heads, window=window)
    return dispatch.plain_vjp(fn, saved, gy, needs)


def fused_transition_block(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                           b_proj, w_short, b_short, num_heads: int,
                           window: int) -> torch.Tensor:
    """x: (B, H, W, cin), H and W divisible by an even `window`."""
    _check_grid(x, window)
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short, b_short)
    if not dispatch.use_kernel(x):
        return plain_transition(x, *weights, num_heads, window)
    if not dispatch.needs_grad(x, *weights):
        return _transition_kernel(x, *weights, num_heads, window)
    fwd = functools.partial(_transition_kernel, num_heads=num_heads,
                            window=window)
    bwd = functools.partial(_transition_backward, num_heads=num_heads,
                            window=window)
    return dispatch.with_backward(fwd, bwd, x, *weights)


def _transition_kernel(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short,
                       b_short, num_heads: int, window: int):
    b, hh, wd, cin = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short, b_short = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short, b_short)
    is_bf16, cout = _check_transition(x, window, w_qkv, b_qkv, ln_w, ln_b,
                                      w_proj, b_proj, w_short, b_short,
                                      num_heads)
    m = b * hh * wd
    xn = torch.empty_like(x)
    qkv = torch.empty((m, 3 * cout), dtype=x.dtype, device=x.device)
    short = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    o = torch.empty((m // 4, cout), dtype=x.dtype, device=x.device)
    out = torch.empty((b, hh // 2, wd // 2, cout), dtype=x.dtype,
                      device=x.device)
    p = dispatch.ptr
    err = build.library("fused_transition").k8_transition(
        is_bf16, p(x), p(w_qkv), p(b_qkv), p(ln_w), p(ln_b), p(w_proj),
        p(b_proj), p(w_short), p(b_short), p(xn), p(qkv), p(short), p(o),
        p(out), b, hh, wd, cin, cout, num_heads, window, dispatch.stream_of(x))
    build.check(err, "fused_transition_block")
    dispatch.count_launch("fused_transition_block", f"window={window}")
    return out


def transition_bwd(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short,
                   b_short, num_heads: int, window: int) -> torch.Tensor:
    """K9: dx of `fused_transition_block` for a cotangent gy (B, H/2, W/2,
    cout), the weights frozen; recomputed from x. Both 2x2 max-pools (the
    in-window q-pool and the shortcut's) route each pooled gradient to the
    first maximum of its cell, as max_pool2d's backward does. Plain version:
    autograd through `plain_transition`."""
    _check_grid(x, window)
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_transition, w_qkv=w_qkv, b_qkv=b_qkv,
                               ln_w=ln_w, ln_b=ln_b, w_proj=w_proj,
                               b_proj=b_proj, w_short=w_short, b_short=b_short,
                               num_heads=num_heads, window=window)
        return dispatch.plain_vjp(fn, (x,), gy, (True,))[0]
    b, hh, wd, cin = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short, b_short = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, w_short, b_short)
    is_bf16, cout = _check_transition(x, window, w_qkv, b_qkv, ln_w, ln_b,
                                      w_proj, b_proj, w_short, b_short,
                                      num_heads)
    gy = gy.contiguous()
    if gy.shape != (b, hh // 2, wd // 2, cout):
        raise ValueError("transition_bwd: gy must be (B, H/2, W/2, cout)")
    dispatch.check_kernel_args(x, gy)
    m, m2 = b * hh * wd, b * (hh // 2) * (wd // 2)
    dt, dev = x.dtype, x.device
    rows = lambda n, w: torch.empty((n, w), dtype=dt, device=dev)  # noqa: E731
    windows = b * (hh // window) * (wd // window)
    sq = (window // 2) ** 2
    xn, dxn, dx = (torch.empty_like(x) for _ in range(3))
    qkv, short = rows(m, 3 * cout), rows(m, cout)
    o, dout = rows(m2, cout), rows(m2, cout)
    lse = torch.empty((windows * num_heads, sq), dtype=torch.float32, device=dev)
    D = torch.empty(m2 * num_heads, dtype=torch.float32, device=dev)
    dcat = rows(m, 4 * cout)
    p = dispatch.ptr
    err = build.library("fused_transition_bwd").k9_transition_bwd(
        is_bf16, p(x), p(gy), p(w_qkv), p(b_qkv), p(ln_w), p(ln_b), p(w_proj),
        p(w_short), p(b_short), p(xn), p(qkv), p(short), p(o), p(lse),
        p(dout), p(D), p(dcat), p(dxn), p(dx), b, hh, wd, cin, cout, num_heads,
        window, dispatch.stream_of(x))
    build.check(err, "transition_bwd")
    dispatch.count_launch("transition_bwd", f"window={window}")
    return dx
