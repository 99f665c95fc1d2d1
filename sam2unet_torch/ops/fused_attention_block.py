"""K4 and K6: the Hiera attention block LN1 -> QKV -> window attention ->
proj -> +x. Counterpart of sam2unet_tpu/ops/pallas/fused_attention_block.py
(`fused_window_block` / `_xla_window_block`, `fused_window_block_strips` /
`_xla_strips`); the kernels are csrc/fused_attention_block.cu.

Weights are in torch layout: w_qkv (3c, c) with output channels ordered
[3, heads, d], w_proj (c, c).
"""

from __future__ import annotations

import torch

from sam2unet_torch.nn.layers import layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.attention import attention_with_padkey, sdpa
from sam2unet_torch.ops.fused_mlp import MAX_LN_WIDTH
from sam2unet_torch.ops.windowing import window_partition, window_unpartition

MAX_HEAD_DIM = 96  # attention.cuh instantiates head dims up to 6 x 16


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
        o = sdpa(q, k, v)
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


def fused_window_block(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                       b_proj, num_heads: int, n_pad: int = 0,
                       residual: bool = True) -> torch.Tensor:
    """K6. x: (nW, S, c) window rows -> (nW, S, c). n_pad > 0 adds the
    synthetic pad key standing for the reference's zero-padded tokens."""
    if not dispatch.use_kernel(x):
        return plain_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                                  num_heads, n_pad, residual)
    nw, s, c = x.shape
    is_bf16 = _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                           num_heads)
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


def fused_window_block_strips(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b,
                              w_proj, b_proj, num_heads: int, window: int,
                              residual: bool = True) -> torch.Tensor:
    """K4. x: (B, H, W, c) on a window-divisible grid -> same shape; the
    window partition happens inside the kernel's addressing."""
    if not dispatch.use_kernel(x):
        return plain_strips(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                            num_heads, window, residual)
    b, hh, wd, c = x.shape
    if hh % window or wd % window:
        raise ValueError(f"strip kernel needs a divisible grid, got "
                         f"{hh}x{wd} with window {window}")
    is_bf16 = _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                           num_heads)
    m = b * hh * wd
    xn = torch.empty_like(x)
    qkv = torch.empty((m, 3 * c), dtype=x.dtype, device=x.device)
    o = torch.empty((m, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    p = dispatch.ptr
    err = build.library("fused_attention_block").k4_window_block_strips(
        is_bf16, p(x), p(w_qkv), p(b_qkv), p(ln_w), p(ln_b), p(w_proj),
        p(b_proj), p(xn), p(qkv), p(o), p(out), b, hh, wd, c, num_heads,
        window, int(residual), dispatch.stream_of(x))
    build.check(err, "fused_window_block_strips")
    dispatch.count_launch("fused_window_block_strips", f"window={window}")
    return out
