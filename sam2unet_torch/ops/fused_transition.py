"""K8: the Hiera q-pool transition block, (B, H, W, cin) -> (B, H/2, W/2,
cout): LN -> shortcut Dense + 2x2 max-pool; windowed QKV -> in-window 2x2
q-pool -> attention -> proj -> + shortcut. Counterpart of
sam2unet_tpu/ops/pallas/fused_transition.py (`fused_transition_block`,
`_xla_transition`); the kernel is csrc/fused_transition.cu.

Weights in torch layout: w_qkv (3*cout, cin), w_proj (cout, cout),
w_short (cout, cin).
"""

from __future__ import annotations

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


def fused_transition_block(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                           b_proj, w_short, b_short, num_heads: int,
                           window: int) -> torch.Tensor:
    """x: (B, H, W, cin), H and W divisible by an even `window`."""
    b, hh, wd, cin = x.shape
    if window % 2 or hh % window or wd % window:
        raise ValueError(f"transition needs an even window dividing the grid, "
                         f"got {hh}x{wd} with window {window}")
    if not dispatch.use_kernel(x):
        return plain_transition(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                                w_short, b_short, num_heads, window)
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
