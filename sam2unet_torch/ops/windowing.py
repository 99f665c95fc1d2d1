"""Window partition/unpartition on NHWC tensors (sam2/modeling/backbones/
utils.py:16-55 padding rules), plus the pad-free valid-group partition and
the whole-grid window mask."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window: int
                     ) -> tuple[torch.Tensor, tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, win, win, C), plus padded (Hp, Wp)."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(windows: torch.Tensor, window: int,
                       pad_hw: tuple[int, int], hw: tuple[int, int]
                       ) -> torch.Tensor:
    """(B*nW, win, win, C) -> (B, H, W, C), cropping the partition pad."""
    hp, wp = pad_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((hp // window) * (wp // window))
    x = windows.reshape(b, hp // window, wp // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    if hp != h or wp != w:
        x = x[:, :h, :w]
    return x.contiguous()


def window_partition_valid(x: torch.Tensor, window: int
                           ) -> list[tuple[torch.Tensor, int]]:
    """Pad-free window partition into up to 4 exact-shape groups.

    Returns [(windows (B*nW, gh, gw, C), n_pad)] in the order ff, fr, rf,
    rr, where n_pad = window**2 - gh*gw is how many identical pad tokens
    the padded partition would have added to each window (the synthetic
    pad key of the attention reproduces them exactly). Sizes are taken as
    ints: the ONNX exporter's tracer hands out tensor sizes."""
    b, h, w, c = (int(s) for s in x.shape)
    nh, rh = divmod(h, window)
    nw, rw = divmod(w, window)

    def part(sub: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
        s = sub.reshape(b, sub.shape[1] // gh, gh, sub.shape[2] // gw, gw, c)
        return s.permute(0, 1, 3, 2, 4, 5).reshape(-1, gh, gw, c).contiguous()

    groups = []
    if nh and nw:
        groups.append((part(x[:, : nh * window, : nw * window], window,
                            window), 0))
    if nh and rw:
        groups.append((part(x[:, : nh * window, nw * window:], window, rw),
                       window * (window - rw)))
    if rh and nw:
        groups.append((part(x[:, nh * window:, : nw * window], rh, window),
                       (window - rh) * window))
    if rh and rw:
        groups.append((part(x[:, nh * window:, nw * window:], rh, rw),
                       window * window - rh * rw))
    return groups


def window_merge_valid(outs: list[torch.Tensor], b: int, h: int, w: int,
                       window: int) -> torch.Tensor:
    """Inverse of window_partition_valid (same group order)."""
    b, h, w = int(b), int(h), int(w)
    nh, rh = divmod(h, window)
    nw, rw = divmod(w, window)
    it = iter(outs)

    def unpart(wins, gr_h, gr_w, gh, gw):
        c = wins.shape[-1]
        x = wins.reshape(b, gr_h // gh, gr_w // gw, gh, gw, c)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gr_h, gr_w, c)

    rows = []
    top = []
    if nh and nw:
        top.append(unpart(next(it), nh * window, nw * window, window, window))
    if nh and rw:
        top.append(unpart(next(it), nh * window, rw, window, rw))
    if top:
        rows.append(torch.cat(top, dim=2))
    bot = []
    if rh and nw:
        bot.append(unpart(next(it), rh, nw * window, rh, window))
    if rh and rw:
        bot.append(unpart(next(it), rh, rw, rh, rw))
    if bot:
        rows.append(torch.cat(bot, dim=2))
    return torch.cat(rows, dim=1).contiguous()


@functools.lru_cache(maxsize=64)
def grid_window_mask(h: int, w: int, window: int
                     ) -> tuple[np.ndarray, np.ndarray]:
    """The additive mask and pad-key log-multiplicity of whole-grid masked
    window attention over a small (H*W <= ~512 tokens) grid, the JAX
    package's `grid_window_mask` (ops/windowing.py:106-130 there): mask
    (S, S) fp32, 0 within a window and -1e30 across; logmult (1, S) fp32,
    ln(n_pad) of the query's window, -1e30 where the window has no pads.
    The n_pad identical bias-valued pad tokens of each window of the
    reference's zero-padded partition (utils.py:16-35) collapse to one
    synthetic key with that log-multiplicity. numpy arrays, cached and
    shared by every caller: copy before writing."""
    rows = np.arange(h)[:, None].repeat(w, 1).reshape(-1)
    cols = np.arange(w)[None, :].repeat(h, 0).reshape(-1)
    nw_cols = -(-w // window)
    win_id = (rows // window) * nw_cols + (cols // window)
    mask = np.where(win_id[:, None] == win_id[None, :], 0.0, -1e30)
    counts = np.bincount(win_id, minlength=win_id.max() + 1)
    n_pad = window * window - counts
    logmult = np.where(n_pad[win_id] > 0,
                       np.log(np.maximum(n_pad[win_id], 1)), -1e30)
    return (mask.astype(np.float32),
            logmult.astype(np.float32).reshape(1, -1))
