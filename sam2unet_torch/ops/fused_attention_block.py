"""K4, K6 and K12: the Hiera attention block LN1 -> QKV -> window attention
-> proj -> +x, and its long-sequence form over K10 (backward over K11); K5,
K7 and K13, the dx-only backward of K4, K6 and K12; K7's weight-gradient
mode, dx and every weight gradient of K6's unmasked, pad-free rows. K6 and
K7 also take the JAX package's masked mode: a whole small grid a row, with
the additive window mask and per-query pad-key log-multiplicity of
`grid_window_mask`. Counterpart of
sam2unet_tpu/ops/pallas/fused_attention_block.py (`fused_window_block` /
`_xla_window_block`, `fused_window_block_strips` / `_xla_strips`,
`_fused_strips_rem_fwd_impl` / `_xla_strips_rem`, `_strips_bwd`, `_bwd`);
the kernels are csrc/fused_attention_block.cu, csrc/flash_attention.cu,
csrc/flash_attention_bwd.cu (K11), csrc/fused_attention_block_bwd.cu (K5,
K7), csrc/block_bwd_sm90.cu (K7's dx-only unmasked mode in bf16 on wgmma
fed by TMA; `_window_bwd_library` decides; K5's bf16 calls on windows of 4
or 8, its projections on the same GEMM and one small-window attention
pass; `_strips_bwd_library` decides),
csrc/fused_attention_block_wgrad.cu (K7's weight-gradient mode) and
csrc/fused_attention_block_rem_bwd.cu (K13).

Weights are in torch layout: w_qkv (3c, c) with output channels ordered
[3, heads, d], w_proj (c, c). The wrappers are differentiable. The backward
follows the JAX package's dispatch: the dx-only kernel where the block's
weights are frozen and the window fits its live budget (K5 for the strips,
K13 for the remainder strips, K7 for n_pad = 0 window rows and for masked
rows), K7's weight-gradient mode where the weights need gradients and the
window and the gradients fit its budget, the long form's backward over K11
for windows past 1024 tokens, and autograd through the plain version,
recomputed, where the JAX package runs its XLA recompute (the pad key,
windows over the budget, masked rows with weights that need gradients,
strips with weights that need gradients).
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
    flash_attention,
    flash_attention_bwd,
    pick_stream_blocks,
)
from sam2unet_torch.ops.fused_mlp import SM90_BLOCK_BWD, WGRAD_ROWS
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
# the widest head dim of K7's Hopper query-side and dk/dv blocks (d padded to
# 64, 96 or 128: K11's block shapes, csrc/flash_attention_bwd_sm90.cuh)
SM90_K7_MAX_HEAD_DIM = 128
# the windows (a side) of K5's and K9's small-window Hopper pass: a tile of
# 64 keys holds one window of 8 x 8 or four of 4 x 4
SM90_SMALL_WINDOWS = (4, 8)


def plain_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                       num_heads: int, n_pad: int = 0, residual: bool = True,
                       attn_mask=None, pad_logmult=None):
    """Plain version (reference `_xla_window_block`) on (nW, S, c); masked
    with `attn_mask` (S, S) and `pad_logmult` (1, S)."""
    nw, s, c = x.shape
    d = c // num_heads
    y = layer_norm_plain(x, ln_w, ln_b)
    qkv = linear_f32(y, w_qkv, b_qkv).to(x.dtype).reshape(nw, s, 3,
                                                          num_heads, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    b3 = b_qkv.reshape(3, num_heads, d)
    if attn_mask is not None:
        o = attention_with_padkey(q, k, v, b3[1], b3[2], attn_mask=attn_mask,
                                  pad_logmult=pad_logmult)
    elif n_pad:
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


def _rup(v: int, q: int) -> int:
    return -(-v // q) * q


def _win_pad_dims(ws: int) -> tuple[int, int]:
    """The JAX gate's `_win_pad_dims` (fused_attention_block.py:1169): the
    smallest (hp, wp) >= (ws, ws) with hp * wp % 16 == 0 (ties: smaller
    hp + wp, then smaller hp)."""
    return min(((hp * wp, hp + wp, hp), (hp, wp))
               for hp in range(ws, ws + 16) for wp in range(ws, ws + 16)
               if (hp * wp) % 16 == 0)[1]


def _rem_weight_bytes(nh: int, c: int, d: int, itemsize: int) -> int:
    """`_pick_layout` (:183) and `_rem_weight_bytes` (:1465) there: the
    all-heads weight stacks as the TPU tiles them when they fit its
    resident cap (11 MiB), else one head, double-buffered."""
    sub = 32 // itemsize
    resident = nh * itemsize * (_rup(c, sub) * _rup(3 * d, 128)
                                + _rup(d, sub) * _rup(c, 128))
    if resident <= 11 * 1024 * 1024:
        return resident
    return 2 * (c * 3 * d + d * c) * itemsize


def _rem_vmem_est(n_w: int, s: int, c: int, d: int, ws: int, wd: int,
                  itemsize: int, wbytes: int, bwd: bool) -> int:
    """`_rem_vmem_est` (:1442) there at one strip per grid step (gb = 1)."""
    est = n_w * s * c * (itemsize + 4)
    est += n_w * s * 3 * d * (4 + itemsize)
    est += n_w * s * s * (8 + itemsize)
    est += n_w * s * c * 4
    est += 2 * (3 if bwd else 2) * ws * wd * c * itemsize
    est += wbytes
    if bwd:
        est += n_w * s * c * itemsize
        est += n_w * s * s * 4
        est += 3 * n_w * s * d * (4 + itemsize)
        est += 2 * ws * _rup(wd, 128) * 4
    return est


def _rem_vmem_est_jw(n_w: int, s: int, c: int, d: int, ws: int, wd: int,
                     itemsize: int, wbytes: int) -> int:
    """`_rem_vmem_est_jw` (:1874) there: the backward with the window on the
    grid, the whole strip's scratch plus one window's transients."""
    est = n_w * s * c * (2 * itemsize + 4)
    est += s * 3 * d * (4 + itemsize)
    est += s * s * (12 + itemsize)
    est += 3 * s * d * (4 + itemsize)
    est += s * c * 4
    est += 2 * 3 * ws * wd * c * itemsize
    est += 2 * ws * _rup(wd, 128) * 4
    return est + wbytes


def strips_rem_supported(hh: int, wd: int, window: int, c: int,
                         num_heads: int, itemsize: int = 2,
                         bwd: bool = False) -> bool:
    """The JAX package's gate for its remainder-strip kernel (K12 forward,
    K13 backward; fused_attention_block.py:1485-1519), chosen in advance to
    match that dispatch: a window, n_w = ceil(wd / window) >= 4 columns of
    windows (at n_w < 4, hiera_l@352 stages 3-4, the valid groups won on
    the TPU), and the strip's live set under the TPU's 13 MiB VMEM cap by
    the JAX package's own estimate (the backward also in its
    window-on-the-grid form). The estimate is a TPU limit the Hopper kernel
    does not have; it is kept so that the two packages take the same route
    (in fp32 it refuses the 64x64 w14 and 32x32 w7 grids at 1024). The
    caller adds the remainder test and keeps K12 out of training
    (hiera.py:250-259 there)."""
    if window <= 0:
        return False
    hp, wp = _win_pad_dims(window)
    s_tok, d, n_w = hp * wp, c // num_heads, -(-wd // window)
    if n_w < 4:
        return False
    wb = _rem_weight_bytes(num_heads, c, d, itemsize)
    cap = 13 * 1024 * 1024
    if _rem_vmem_est(n_w, s_tok, c, d, window, wd, itemsize, wb, bwd) <= cap:
        return True
    return bwd and _rem_vmem_est_jw(n_w, s_tok, c, d, window, wd, itemsize,
                                    wb) <= cap


def strips_rem_bwd_regime(hh: int, wd: int, window: int, c: int,
                          num_heads: int, itemsize: int = 2) -> str:
    """Which of the JAX package's two remainder-strip backward kernels it
    launches where `strips_rem_supported(..., bwd=True)` holds
    (`_fused_strips_rem_bwd_impl`, fused_attention_block.py:1612-1620):
    "K13b" (the window on the grid) where one whole strip's working set
    passes the TPU's 13 MiB of VMEM, else "K13a". One Hopper kernel computes
    both; the label names the launch as the JAX package would."""
    hp, wp = _win_pad_dims(window)
    d, n_w = c // num_heads, -(-wd // window)
    wb = _rem_weight_bytes(num_heads, c, d, itemsize)
    est = _rem_vmem_est(n_w, hp * wp, c, d, window, wd, itemsize, wb, True)
    return "K13b" if est > 13 * 1024 * 1024 else "K13a"


def strips_route(hh: int, wd: int, window: int, c: int, num_heads: int,
                 itemsize: int = 2) -> str:
    """The forward the JAX package runs for `fused_window_block_strips`
    (`_fused_strips_vjp`, fused_attention_block.py:975-997): "K4" on a
    divisible grid with a 16-aligned window whose live set fits, else
    "K12" where `strips_rem_supported` holds, else "plain" (`_xla_strips`
    on divisible grids, `_xla_strips_rem` on the others)."""
    s = window * window
    s16 = s + (-s) % 16
    if (hh % window == 0 and wd % window == 0 and s % 16 == 0
            and 8 * s16 * s16 + 14 * s16 * c <= LONG_SEQUENCE_BYTES):
        return "K4"
    if strips_rem_supported(hh, wd, window, c, num_heads, itemsize):
        return "K12"
    return "plain"


def strips_bwd_route(hh: int, wd: int, window: int, c: int, num_heads: int,
                     itemsize: int = 2, weight_grads: bool = False) -> str:
    """The backward the JAX package runs for `fused_window_block_strips`
    (`_strips_bwd`, fused_attention_block.py:1896-1929), whatever its
    forward ran: with frozen weights "K5" on a divisible grid where
    `strips_bwd_kernel` holds, else "K13a" / "K13b" where
    `strips_rem_supported(..., bwd=True)` holds; else, and always with
    weights that need gradients, "plain" (the XLA recompute of the form the
    divisibility picks)."""
    if weight_grads:
        return "plain"
    if hh % window == 0 and wd % window == 0 and strips_bwd_kernel(window, c):
        return "K5"
    if strips_rem_supported(hh, wd, window, c, num_heads, itemsize, bwd=True):
        return strips_rem_bwd_regime(hh, wd, window, c, num_heads, itemsize)
    return "plain"


def long_form_kernel(s: int) -> bool:
    """Whether a window of S tokens past `long_sequence` runs the long form
    over K10, as the JAX package's `_xla_window_block` runs its streaming
    kernel (fused_attention_block.py:245-253, flash_attention.py:432-443):
    past 1024 tokens where a 16-aligned block divides S. Else it runs the
    window block's plain form, `_xla_attention` there (S <= 1024: the
    1024-token global blocks of hiera_t and hiera_s at 512 px)."""
    return s > MAX_FULL_SEQ and pick_stream_blocks(s, s) is not None


def window_block_bwd_route(s: int, c: int, n_pad: int, weight_grads: bool,
                           masked: bool = False) -> str:
    """The backward the JAX package runs for `fused_window_block` on
    windows of S tokens at width c (fused_attention_block.py:1945-1991,
    flash_attention.py:439-464): "K7" (dx only, the weights frozen), "K7
    masked" (its masked dx-only mode), "K7 weight-grad" (its
    weight-gradient mode), "K11" (the XLA recompute of a window past 1024
    tokens, whose attention backward is the streaming one:
    `_long_window_block_backward` here), or "plain" (the XLA recompute: the
    pad key, windows over the live budget, masked rows with weights that
    need gradients). At hiera_l@352 the 484-token global blocks take K7; at
    hiera_s@960 the 3600-token ones take K11."""
    s16 = s + (-s) % 16
    live = 12 * s16 * s16 + 14 * s16 * c
    if masked:
        return ("K7 masked" if not weight_grads and live <= BWD_LIVE_BYTES
                else "plain")
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


def _window_bwd_library(dtype: torch.dtype, c: int,
                        num_heads: int) -> str | None:
    """The library of K7's dx-only unmasked call on rows of width c over
    `num_heads` heads: csrc/block_bwd_sm90.cu for bf16 with c and the head
    dim multiples of 8 elements and the head dim up to
    `SM90_K7_MAX_HEAD_DIM`, at any window length and number of windows
    (contiguous, 16-byte aligned tensors, as `dispatch.check_kernel_args`
    demands, whose (windows, S, heads, d) views TMA tensor maps address);
    None leaves it to csrc/fused_attention_block_bwd.cu (fp32, other widths
    and head dims). The masked and weight-gradient modes keep their own
    sources."""
    d = c // num_heads if num_heads > 0 and c % num_heads == 0 else 0
    ok = (dtype == torch.bfloat16 and c % 8 == 0 and d > 0 and d % 8 == 0
          and d <= SM90_K7_MAX_HEAD_DIM)
    return SM90_BLOCK_BWD if ok else None


def small_window_sm90(dtype: torch.dtype, c: int, num_heads: int,
                      window: int) -> bool:
    """Whether K5's or K9's call, its attention of width c over `num_heads`
    heads on `window`-wide windows, takes csrc/block_bwd_sm90.cu's
    small-window route: K7's terms (`_window_bwd_library`: bf16, c and the
    head dim multiples of 8 elements, the head dim up to
    `SM90_K7_MAX_HEAD_DIM`) and windows of 16 or 64 tokens (window 4 or 8:
    window**2 at most 64, and the 16-aligned windows the JAX package's K5
    and K9 take), whose pass holds a window's whole score tile."""
    return (_window_bwd_library(dtype, c, num_heads) is not None
            and window in SM90_SMALL_WINDOWS)


def _strips_bwd_library(dtype: torch.dtype, c: int, num_heads: int,
                        window: int) -> str | None:
    """The library of K5's call on a (B, H, W, c) grid of `window`-wide
    windows over `num_heads` heads: csrc/block_bwd_sm90.cu where
    `small_window_sm90` holds; None leaves it to
    csrc/fused_attention_block_bwd.cu (fp32, other widths, head dims and
    windows)."""
    return SM90_BLOCK_BWD if small_window_sm90(dtype, c, num_heads, window) else None


def _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj, num_heads):
    is_bf16 = dispatch.check_kernel_args(x, w_qkv, b_qkv, ln_w, ln_b,
                                         w_proj, b_proj)
    if (w_qkv.shape != (3 * c, c) or b_qkv.shape != (3 * c,)
            or ln_w.shape != (c,) or ln_b.shape != (c,)
            or w_proj.shape != (c, c) or b_proj.shape != (c,)):
        raise ValueError("attention block: weight shapes do not match x")
    if c % num_heads:
        raise ValueError(f"attention block: c={c} is not a multiple of "
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


def _mask_args(x, attn_mask, pad_logmult):
    """The masked mode's mask (S, S) and log-multiplicity (S,) as the
    kernels read them: fp32, contiguous, on x's device; (None, None)
    unmasked."""
    if attn_mask is None:
        return None, None
    s = x.shape[1]
    mask = attn_mask.to(x.device, torch.float32).contiguous()
    logmult = pad_logmult.to(x.device, torch.float32).reshape(-1).contiguous()
    if mask.shape != (s, s) or logmult.shape != (s,):
        raise ValueError(f"masked mode needs attn_mask ({s}, {s}) and "
                         f"pad_logmult (1, {s}) for rows of {s} tokens")
    return mask, logmult


def fused_window_block(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                       b_proj, num_heads: int, n_pad: int = 0,
                       residual: bool = True, attn_mask=None,
                       pad_logmult=None) -> torch.Tensor:
    """x: (nW, S, c) window rows -> (nW, S, c). n_pad > 0 adds the
    synthetic pad key standing for the reference's zero-padded tokens.
    `attn_mask` (S, S) and `pad_logmult` (1, S) (`grid_window_mask`) select
    the masked mode: each row a whole small grid of S = H*W tokens, the
    pad key at each query's own log-multiplicity; exactly one of n_pad and
    pad_logmult carries the pad key, and the two get no gradient. K6, or
    past `long_sequence` the long form over K10 where `long_form_kernel`
    holds (unmasked, no pad key) and the plain form elsewhere, as the JAX
    package routes it. Backward: `window_block_bwd_route` (K7, K7's masked
    mode, the long form's backward over K11, or the plain recompute)."""
    if (attn_mask is None) != (pad_logmult is None) or (
            attn_mask is not None and n_pad):
        raise ValueError("the masked mode takes attn_mask and pad_logmult "
                         "together, and no n_pad")
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    if not dispatch.use_kernel(x):
        return plain_window_block(x, *weights, num_heads, n_pad, residual,
                                  attn_mask, pad_logmult)
    return _differentiable(_window_block_kernel, _window_block_backward, x,
                           weights, num_heads=num_heads, n_pad=n_pad,
                           residual=residual, attn_mask=attn_mask,
                           pad_logmult=pad_logmult)


def _window_block_backward(saved, gy, needs, num_heads, n_pad, residual,
                           attn_mask=None, pad_logmult=None):
    x = saved[0]
    route = window_block_bwd_route(x.shape[1], x.shape[2], n_pad,
                                   any(needs[1:]), attn_mask is not None)
    if route in ("K7", "K7 masked"):
        return (window_block_bwd(x, gy, *saved[1:], num_heads=num_heads,
                                 residual=residual, attn_mask=attn_mask,
                                 pad_logmult=pad_logmult),) + (None,) * 6
    if route == "K7 weight-grad":
        # the fp32 gradients in each input's own dtype, as the JAX package
        # casts them (fused_attention_block.py:705-712)
        grads = window_block_bwd(x, gy, *saved[1:], num_heads=num_heads,
                                 residual=residual, weight_grads=True)
        return tuple(g.to(t.dtype) if need else None
                     for g, t, need in zip(grads, saved, needs))
    if route == "K11":
        return _long_window_block_backward(saved, gy, needs, num_heads,
                                           residual)
    return _plain_backward(plain_window_block, saved, gy, needs,
                           num_heads=num_heads, n_pad=n_pad, residual=residual,
                           attn_mask=attn_mask, pad_logmult=pad_logmult)


def _window_block_kernel(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                         num_heads: int, n_pad: int, residual: bool,
                         attn_mask=None, pad_logmult=None):
    nw, s, c = x.shape
    w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj = dispatch.cast(
        x.dtype, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    is_bf16 = _check_block(x, c, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                           num_heads)
    if long_sequence(s, c):
        # the pad key and the masked mode past the gate: the JAX package's
        # `_xla_window_block` runs `attention_with_padkey`, the plain form
        if n_pad or attn_mask is not None or not long_form_kernel(s):
            return plain_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                                      b_proj, num_heads, n_pad, residual,
                                      attn_mask, pad_logmult)
        return _long_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                                  num_heads, residual)
    return _k6_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                            num_heads, n_pad, residual, is_bf16,
                            *_mask_args(x, attn_mask, pad_logmult))


def _k6_window_block(x, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                     num_heads: int, n_pad: int, residual: bool,
                     is_bf16: int, mask=None, logmult=None):
    nw, s, c = x.shape
    xn = torch.empty_like(x)
    qkv = torch.empty((nw * s, 3 * c), dtype=x.dtype, device=x.device)
    o = torch.empty((nw * s, c), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    p = dispatch.ptr
    args = (is_bf16, p(x), p(w_qkv), p(b_qkv), p(ln_w), p(ln_b), p(w_proj),
            p(b_proj))
    geometry = (nw, s, c, num_heads)
    if mask is None:
        err = build.library("fused_attention_block").k6_window_block(
            *args, p(xn), p(qkv), p(o), p(out), *geometry, n_pad,
            int(residual), dispatch.stream_of(x))
        variant = f"S={s},n_pad={n_pad}"
    else:
        lib = build.library("fused_attention_block_masked")
        err = lib.k6_window_block_masked(
            *args, p(mask), p(logmult), p(xn), p(qkv), p(o), p(out), *geometry,
            int(residual), dispatch.stream_of(x))
        variant = f"S={s},masked"
    build.check(err, "fused_window_block")
    dispatch.count_launch("fused_window_block", variant)
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


def _strips_plain(x, *weights, num_heads: int, window: int, residual: bool):
    """The JAX package's XLA form of the strips: `_xla_strips` on a
    divisible grid, the valid groups with the pad key (`_xla_strips_rem`)
    on the others."""
    divisible = x.shape[1] % window == 0 and x.shape[2] % window == 0
    plain = plain_strips if divisible else plain_strips_rem
    return plain(x, *weights, num_heads, window, residual)


def fused_window_block_strips(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b,
                              w_proj, b_proj, num_heads: int, window: int,
                              residual: bool = True) -> torch.Tensor:
    """x: (B, H, W, c) on any grid -> same shape, the JAX function's
    dispatch (`strips_route`): K4, K12, or the plain form of the grid. Its
    backward, whatever the forward ran (`strips_bwd_route`): K5 or K13
    where the weights are frozen and the gates hold, else the plain
    recompute."""
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    if window <= 0:
        raise ValueError(f"strip blocks need a window, got {window}")
    if not dispatch.use_kernel(x):
        return _strips_plain(x, *weights, num_heads=num_heads, window=window,
                             residual=residual)
    route = strips_route(x.shape[1], x.shape[2], window, x.shape[3],
                         num_heads, x.dtype.itemsize)
    fwd = {"K4": _strips_kernel, "K12": _strips_rem_kernel}.get(route,
                                                                _strips_plain)
    return _differentiable(fwd, _strips_backward, x, weights,
                           num_heads=num_heads, window=window,
                           residual=residual)


def _strips_kernel(x, *weights, num_heads: int, window: int, residual: bool):
    out = _grid_block("k4_window_block_strips", x, *weights, num_heads,
                      window, residual)
    dispatch.count_launch("fused_window_block_strips", f"window={window}")
    return out


def _strips_backward(saved, gy, needs, num_heads, window, residual):
    x = saved[0]
    _, hh, wd, c = x.shape
    route = strips_bwd_route(hh, wd, window, c, num_heads, x.dtype.itemsize,
                             any(needs[1:]))
    if route == "plain":
        return _plain_backward(_strips_plain, saved, gy, needs,
                               num_heads=num_heads, window=window,
                               residual=residual)
    bwd = window_block_strips_bwd if route == "K5" else \
        window_block_strips_rem_bwd
    return (bwd(x, gy, *saved[1:], num_heads=num_heads, window=window,
                residual=residual),) + (None,) * 6


def fused_window_block_strips_rem(x: torch.Tensor, w_qkv, b_qkv, ln_w, ln_b,
                                  w_proj, b_proj, num_heads: int, window: int,
                                  residual: bool = True) -> torch.Tensor:
    """K12. x: (B, H, W, c) on any grid -> same shape; each edge window
    attends over its tokens inside the grid plus the synthetic pad key of
    the reference's post-LN zero pads, so the result equals the
    valid-group form. Eval only in the model. Backward: the JAX package's
    `_strips_bwd` (`strips_bwd_route`), K13 for frozen weights where its
    gate holds, else the plain recompute."""
    weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
    if not dispatch.use_kernel(x):
        return plain_strips_rem(x, *weights, num_heads, window, residual)
    if window <= 0:
        raise ValueError(f"remainder strip kernel needs a window, got {window}")
    return _differentiable(_strips_rem_kernel, _strips_backward, x,
                           weights, num_heads=num_heads, window=window,
                           residual=residual)


def _strips_rem_kernel(x, *weights, num_heads: int, window: int,
                       residual: bool):
    out = _grid_block("k12_window_block_strips_rem", x, *weights, num_heads,
                      window, residual)
    dispatch.count_launch("fused_window_block_strips_rem", f"window={window}")
    return out


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


def _launch_bwd(entry, is_bf16, x, gy, weights, buf, *geometry, masks=(),
                lib="fused_attention_block_bwd"):
    p = dispatch.ptr
    err = getattr(build.library(lib), entry)(
        is_bf16, p(x), p(gy), *(p(w) for w in weights), *(p(m) for m in masks),
        *(p(buf[k]) for k in ("xn", "qkv", "o", "lse", "dout", "D", "dqkv",
                              "dxn", "dx")),
        *geometry, dispatch.stream_of(x))
    build.check(err, entry)
    return buf["dx"]


def window_block_bwd(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                     num_heads: int, residual: bool = True, attn_mask=None,
                     pad_logmult=None, weight_grads: bool = False):
    """K7: dx of `fused_window_block` on (nW, S, c) without a pad key, or in
    its masked mode (`attn_mask`, `pad_logmult`), for a cotangent gy, the
    weights frozen; recomputed from x. The unmasked mode runs
    csrc/block_bwd_sm90.cu where `_window_bwd_library` takes the call. With
    `weight_grads` (unmasked only), K7's weight-gradient mode: (dx, dW_qkv, db_qkv, dln_w, dln_b, dW_proj,
    db_proj), the weight gradients fp32 in the torch layouts, as
    `_fused_window_block_bwd_impl(weight_grads=True)` returns them before
    its cast. Plain version: autograd through `plain_window_block`, with
    respect to x or to all seven."""
    if weight_grads and attn_mask is not None:
        raise ValueError("K7's weight-gradient mode takes no mask")
    if not dispatch.use_kernel(x):
        weights = (w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj)
        fn = functools.partial(plain_window_block, num_heads=num_heads,
                               residual=residual, attn_mask=attn_mask,
                               pad_logmult=pad_logmult)
        needs = (True,) + (weight_grads,) * 6
        grads = dispatch.plain_vjp(fn, (x, *weights), gy, needs)
        if not weight_grads:
            return grads[0]
        return (grads[0],) + tuple(g.float() for g in grads[1:])
    nw, s, c = x.shape
    is_bf16, gy, weights = _block_bwd_args(x, gy, w_qkv, b_qkv, ln_w, ln_b,
                                           w_proj, b_proj, num_heads)
    geometry = (nw, s, c, num_heads, int(residual))
    if (not weight_grads and attn_mask is None
            and _window_bwd_library(x.dtype, c, num_heads)):
        dx = _launch_bwd_sm90(is_bf16, x, gy, weights, geometry)
        dispatch.count_launch("window_block_bwd", f"S={s}")
        return dx
    buf = _bwd_buffers(x, c, num_heads, nw * s, nw * s, nw, s)
    if weight_grads:
        return _window_block_bwd_wgrad(is_bf16, x, gy, weights, buf, geometry)
    if attn_mask is None:
        dx = _launch_bwd("k7_window_block_bwd", is_bf16, x, gy, weights, buf,
                         *geometry)
        variant = f"S={s}"
    else:
        dx = _launch_bwd("k7_window_block_bwd_masked", is_bf16, x, gy, weights,
                         buf, *geometry,
                         masks=_mask_args(x, attn_mask, pad_logmult),
                         lib="fused_attention_block_masked")
        variant = f"S={s},masked"
    dispatch.count_launch("window_block_bwd", variant)
    return dx


def _launch_bwd_sm90(is_bf16, x, gy, weights, geometry):
    """K7's dx-only unmasked mode on csrc/block_bwd_sm90.cu. Its scratch,
    LN(x), qkv, dO, dqkv and dLN(x) in x's dtype and lse and D in fp32 (no
    O: the query side keeps it in registers), is one workspace."""
    nw, s, c, nh = geometry[:4]
    m, es = nw * s, x.element_size()
    xn, qkv, dout, dqkv, dxn, lse, d_rows = dispatch.workspace(
        x.device, *(w * m * c * es for w in (1, 3, 1, 3, 1)), nw * nh * s * 4,
        nw * nh * s * 4)
    dx = torch.empty_like(x)
    p = dispatch.ptr
    err = build.library(SM90_BLOCK_BWD).k7_window_block_bwd_sm90(
        is_bf16, p(x), p(gy), *(p(w) for w in weights), xn, qkv, lse, dout,
        d_rows, dqkv, dxn, p(dx), *geometry, dispatch.stream_of(x))
    build.check(err, "k7_window_block_bwd_sm90")
    return dx


def _window_block_bwd_wgrad(is_bf16, x, gy, weights, buf, geometry):
    """K7's weight-gradient mode: the dx-only pipeline's buffers, then the
    fp32 reductions over all rows (fused_attention_block_wgrad.cu)."""
    nw, s, c = x.shape
    m = nw * s
    f32 = dict(dtype=torch.float32, device=x.device)
    chunks = -(-m // WGRAD_ROWS)
    ws = torch.empty(max(chunks * (3 * c * c + 3 * c), 2 * m + 2 * chunks * c),
                     **f32)
    grads = (torch.empty(3 * c, c, **f32), torch.empty(3 * c, **f32),
             torch.empty(c, **f32), torch.empty(c, **f32),
             torch.empty(c, c, **f32), torch.empty(c, **f32))
    p = dispatch.ptr
    err = build.library("fused_attention_block_wgrad").k7_window_block_bwd_wgrad(
        is_bf16, p(x), p(gy), *(p(w) for w in weights),
        *(p(buf[k]) for k in ("xn", "qkv", "o", "lse", "dout", "D", "dqkv",
                              "dxn", "dx")),
        p(ws), *(p(g) for g in grads), *geometry, dispatch.stream_of(x))
    build.check(err, "k7_window_block_bwd_wgrad")
    dispatch.count_launch("window_block_bwd", f"S={s},wgrad")
    return (buf["dx"],) + grads


def window_block_strips_bwd(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj, b_proj,
                            num_heads: int, window: int,
                            residual: bool = True) -> torch.Tensor:
    """K5: dx of `fused_window_block_strips` on (B, H, W, c), a
    window-divisible grid, for a cotangent gy, the weights frozen;
    recomputed from x. bf16 calls that `_strips_bwd_library` takes run
    csrc/block_bwd_sm90.cu: the LN pass and the three projections as K7's
    there, and one small-window attention pass over the grid's windows (no
    o, lse or D buffer). Plain version: autograd through `plain_strips`."""
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
    if _strips_bwd_library(x.dtype, c, num_heads, window):
        dx = torch.empty_like(x)
        ws = dispatch.workspace(
            x.device, *(w * m * c * x.element_size() for w in (1, 3, 1, 3, 1)))
        p = dispatch.ptr
        err = build.library(SM90_BLOCK_BWD).k5_window_block_strips_bwd_sm90(
            is_bf16, p(x), p(gy), *(p(w) for w in weights), *ws, p(dx), b, hh,
            wd, c, num_heads, window, int(residual), dispatch.stream_of(x))
        build.check(err, "k5_window_block_strips_bwd_sm90")
        dispatch.count_launch("window_block_strips_bwd", f"window={window}")
        return dx
    buf = _bwd_buffers(x, c, num_heads, m, m, windows, window * window)
    dx = _launch_bwd("k5_window_block_strips_bwd", is_bf16, x, gy, weights,
                     buf, b, hh, wd, c, num_heads, window, int(residual))
    dispatch.count_launch("window_block_strips_bwd", f"window={window}")
    return dx


def window_block_strips_rem_bwd(x, gy, w_qkv, b_qkv, ln_w, ln_b, w_proj,
                                b_proj, num_heads: int, window: int,
                                residual: bool = True) -> torch.Tensor:
    """K13: dx of `fused_window_block_strips_rem` (K12) on (B, H, W, c), any
    grid, for a cotangent gy, the weights frozen; recomputed from x. Counted
    under the JAX package's kernel for the geometry (`strips_rem_bwd_regime`:
    K13a or K13b). Plain version: autograd through `plain_strips_rem`."""
    if not dispatch.use_kernel(x):
        fn = functools.partial(plain_strips_rem, w_qkv=w_qkv, b_qkv=b_qkv,
                               ln_w=ln_w, ln_b=ln_b, w_proj=w_proj,
                               b_proj=b_proj, num_heads=num_heads,
                               window=window, residual=residual)
        return dispatch.plain_vjp(fn, (x,), gy, (True,))[0]
    b, hh, wd, c = x.shape
    if window <= 0:
        raise ValueError(f"remainder strip backward needs a window, got "
                         f"{window}")
    is_bf16, gy, weights = _block_bwd_args(x, gy, w_qkv, b_qkv, ln_w, ln_b,
                                           w_proj, b_proj, num_heads)
    windows = b * -(-hh // window) * -(-wd // window)
    m = b * hh * wd
    buf = _bwd_buffers(x, c, num_heads, m, m, windows, window * window)
    dx = _launch_bwd("k13_window_block_strips_rem_bwd", is_bf16, x, gy,
                     weights, buf, b, hh, wd, c, num_heads, window,
                     int(residual), lib="fused_attention_block_rem_bwd")
    regime = strips_rem_bwd_regime(hh, wd, window, c, num_heads,
                                   x.dtype.itemsize)
    dispatch.count_launch("window_block_strips_rem_bwd",
                          f"window={window},{regime}")
    return dx
