"""K4, K6 and K12: the Hiera attention block LN1 -> QKV -> window attention
-> proj -> +x, and its long-sequence form over K10. Counterpart of
sam2unet_tpu/ops/pallas/fused_attention_block.py (`fused_window_block` /
`_xla_window_block`, `fused_window_block_strips` / `_xla_strips`,
`_fused_strips_rem_fwd_impl` / `_xla_strips_rem`); the kernels are
csrc/fused_attention_block.cu and csrc/flash_attention.cu.

Weights are in torch layout: w_qkv (3c, c) with output channels ordered
[3, heads, d], w_proj (c, c).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sam2unet_torch.nn.layers import layer_norm_plain, linear_f32
from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.attention import attention_with_padkey, sdpa
from sam2unet_torch.ops.flash_attention import MAX_HEAD_DIM, flash_attention
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


def strips_rem_supported(h: int, w: int, window: int) -> bool:
    """Whether a block on an (h, w) grid takes K12 (the JAX package's
    `strips_rem_supported`, fused_attention_block.py:1485-1519, with the
    caller's remainder test, hiera.py:250-259): a window, a grid it does not
    divide or whose window**2 is not 16-aligned, and n_w = ceil(w/window) >=
    4 (at n_w < 4, hiera_l@352 stages 3-4, the valid groups won on the TPU).

    The JAX gate also needs the strip's live set under a VMEM cap, a TPU
    limit the Hopper kernel does not have, so that estimate is left out. The
    JAX package takes K12 at eval only; the port has no training path yet,
    and when it gets one `MultiScaleBlock.forward` passes its training flag
    here and a training block takes the valid groups."""
    if window <= 0:
        return False
    if h % window == 0 and w % window == 0 and (window * window) % 16 == 0:
        return False
    return -(-w // window) >= 4


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
    y = layer_norm_plain(x, ln_w, ln_b)
    qkv = F.linear(y, w_qkv, b_qkv).reshape(nw, s, 3, num_heads,
                                            c // num_heads)
    o = flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    out = F.linear(o.reshape(nw, s, c), w_proj, b_proj)
    return x + out if residual else out


def fused_window_block(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                       b_proj, num_heads: int, n_pad: int = 0,
                       residual: bool = True) -> torch.Tensor:
    """x: (nW, S, c) window rows -> (nW, S, c). n_pad > 0 adds the
    synthetic pad key standing for the reference's zero-padded tokens.
    K6, or past `long_sequence` the long form over K10 (the JAX package
    runs plain attention there for S <= 1024; the port runs K10 at any S)."""
    if not dispatch.use_kernel(x):
        return plain_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                                  num_heads, n_pad, residual)
    nw, s, c = x.shape
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
    """K4. x: (B, H, W, c) on a window-divisible grid -> same shape."""
    if not dispatch.use_kernel(x):
        return plain_strips(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                            num_heads, window, residual)
    if x.shape[1] % window or x.shape[2] % window:
        raise ValueError(f"strip kernel needs a divisible grid, got "
                         f"{x.shape[1]}x{x.shape[2]} with window {window}")
    out = _grid_block("k4_window_block_strips", x, w_qkv, b_qkv, ln_w, ln_b,
                      w_proj, b_proj, num_heads, window, residual)
    dispatch.count_launch("fused_window_block_strips", f"window={window}")
    return out


def fused_window_block_strips_rem(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b,
                                  w_proj, b_proj, num_heads: int, window: int,
                                  residual: bool = True) -> torch.Tensor:
    """K12. x: (B, H, W, c) on any grid -> same shape; each edge window
    attends over its tokens inside the grid plus the synthetic pad key of
    the reference's post-LN zero pads, so the result equals the
    valid-group form."""
    if not dispatch.use_kernel(x):
        return plain_strips_rem(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                                num_heads, window, residual)
    if window <= 0:
        raise ValueError(f"remainder strip kernel needs a window, got {window}")
    out = _grid_block("k12_window_block_strips_rem", x, w_qkv, b_qkv, ln_w,
                      ln_b, w_proj, b_proj, num_heads, window, residual)
    dispatch.count_launch("fused_window_block_strips_rem", f"window={window}")
    return out
