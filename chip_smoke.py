#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sam2unet_torch): inference at
hiera_l @ 352 and hiera_s @ 960 (the test CLI's defaults), and training at
hiera_l @ 352.

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases build,kernels --batch 2 --batch960 2 --batch_train 2
    python3 chip_smoke.py --phases build,profile   # device time by kernel
    python3 chip_smoke.py --paths l352train        # one path

Phases, one line each, for each path of --paths (l352, s960, then
l352train; the training path's are listed after these):
  1. the card (nvidia-smi name and power limit); build the CUDA kernels
     from csrc/ with nvcc (one process per source, all at once) and print
     the build time.
  2. every kernel of the path against its plain PyTorch version on the
     card at the path's main-path shapes: at 352 K1 tail, K1 adapter, K4,
     K6 n_pad=0, K6 n_pad>0, K6 global S=484, K8; at 960 K1 tail, K1
     adapter, K4, K8, K10 (o and lse) and K12. bf16 at every shape (timed
     at one representative shape each, with the bound from the call's
     bytes and operations, and SDPA's time beside K10), and fp32 once at a
     batch of at most 2. TF32 is off.
  3. the main path: the test CLI (sam2unet_torch.cli.test_cli.main) on a
     synthetic 4-image dataset with a seeded random SAM2UNet checkpoint of
     the path's trunk, --size 352 --model_cfg sam2_hiera_l, or the CLI's
     defaults (--size 960 --model_cfg sam2_hiera_s), --bf16 --batch_size 4;
     PNG checks; launch counts per forward (counters set to 0 just before
     the run and read just after); the same batch under force_plain() on
     the card.
  4. forward throughput, bf16, CUDA events after warm-up: hiera_l@352 at
     --batch (32), hiera_s@960 at --batch960 (16, the fork's batch at 960).
The training path, l352train (hiera_l@352, bf16 over fp32 master
parameters, the trunk frozen):
  2. every backward kernel (K2, K3, K5, K7, K9) against autograd through
     its plain version on the card at the training step's shapes at
     --batch_train (16), bf16 (K9 also on a case of exact ties; K9's
     max-pool routing may send a near-tie elsewhere than the plain
     version's recomputed forward does, so up to 1e-3 of its tokens may
     differ in bf16, each within 0.1 of max |plain|) and fp32 once (K9's
     at the full batch, on an input without near-ties); timed with the
     bound counting the recomputed forward.
  3. the main path: the train CLI (sam2unet_torch.cli.train_cli.main) on a
     synthetic set of 16 train and 4 test images from the seeded random
     checkpoint, --size 352 --model_cfg sam2_hiera_l --bf16 --batch_size 8
     --epoch 2: finite losses, every trainable parameter moved, every frozen
     one bit-identical, the epoch reports in log.txt, a checkpoint that the
     test CLI loads strictly and runs; launches per train step of every
     wrapper (counters set to 0 just before, read just after); then one
     step's loss and trainable gradients, kernels against plain versions
     on the same parameters and batch (batch 4, --step_seeds): in fp32
     every leaf to correlation 0.9999 and 1e-2 of max |plain|; in bf16 the
     loss to 1e-2 and each leaf's gradient about as close to the fp32 one
     as the plain bf16 version's of the same leaf (rounding alone
     decorrelates the deepest leaves, plain and kernels alike).
  4. train-step throughput, bf16, batch --batch_train, CUDA events over 5
     steps after 2 warm-up steps, and peak memory.
Then a JSON line of per-kernel numbers, the card line, and last the result
line. Any failed phase exits non-zero before the result line. Without a
CUDA device, or without the sam2unet_torch package beside this script, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
BF16_REL_TOL = 2e-2         # max|kernel - plain| / max|plain| in bf16
FP32_REL_TOL = 1e-4         # the same in fp32 (TF32 off)
# K9 in bf16: its two 2x2 max-pools route each pooled gradient to one
# position, and where the kernel's and the plain version's recomputed
# forwards round a near-tie differently, that channel's gradient lands on
# another token of the cell. Measured at the two train shapes (batch 16):
# up to 9.7e-5 of the tokens past the bf16 tolerance, at most 0.044 of
# max |plain|. Allowed: 1e-3 of the tokens, each within 0.1 of max |plain|.
# fp32 rounding makes such near-ties too, at the full batch: K9's fp32
# comparison runs there on an input redrawn until no 2x2 cell has one
# (`_without_near_ties`), and allows no token past the tolerance.
K9_BF16_TOKEN_SHARE = 1e-3
K9_BF16_OUTLIER_REL = 0.1
# the test CLI's logits, kernels vs plain versions, same bf16 weights; one
# train step's trainable gradients in fp32 likewise; the train step's bf16
# loss
MAIN_CORR_MIN = 0.99
MAIN_REL_TOL = 0.1
STEP_LOSS_RTOL = 1e-2
# one bf16 train step, each trainable leaf: its gap 1 - corr(kernels,
# fp32) <= STEP_GAP_RATIO * the plain bf16 version's gap of the same leaf +
# STEP_GAP_MARGIN, and the mean gap over the leaves <= STEP_GAP_MEAN_RATIO *
# the plain's. Set from six batches (seeds 2-7; PERF.md, PR 3): the worst
# leaf exceeded 2x the plain's gap by 0.0051 (a 32-element adapter bias,
# kernels 0.0142 vs plain 0.0046), the mean ratio was 0.90-1.14.
STEP_GAP_RATIO = 2.0
STEP_GAP_MARGIN = 1e-2
STEP_GAP_MEAN_RATIO = 1.25
# the operating points: trunk, input size, per-forward launches of each
# kernel wrapper (a wrapper not listed must not launch)
PATHS = {
    "l352": dict(label="hiera_l@352", cfg="sam2_hiera_l", size=352,
                 per_forward={"fused_mlp": 96, "fused_window_block_strips": 7,
                              "fused_window_block": 143,
                              "fused_transition_block": 2}),
    "s960": dict(label="hiera_s@960", cfg="sam2_hiera_s", size=960,
                 per_forward={"fused_mlp": 32, "fused_window_block_strips": 2,
                              "fused_transition_block": 2,
                              "fused_window_block_strips_rem": 8,
                              "flash_attention": 3}),
    # per train step: the forward's launches and the backward kernels'
    "l352train": dict(label="hiera_l@352 train", cfg="sam2_hiera_l", size=352,
                      train=True,
                      per_step={"fused_mlp": 96, "fused_window_block_strips": 7,
                                "fused_window_block": 143,
                                "fused_transition_block": 2,
                                "adapter_bwd": 48, "mlp_bwd_dx": 48,
                                "window_block_strips_bwd": 7,
                                "window_block_bwd": 38, "transition_bwd": 2}),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------- cases


def make_case(kind: str, dtype, gen, **g):
    """(kernel call, operations, bytes, library call or None) for one kernel
    at one shape. Weights ~ lecun-normal, biases and LN params small noise
    around the identity, activations ~ N(0, 1). Bytes count each input read
    once and each output written once; operations count the work this
    call's data needs."""
    import torch
    import torch.nn.functional as F

    from sam2unet_torch.ops.flash_attention import flash_attention
    from sam2unet_torch.ops.fused_attention_block import (
        fused_window_block,
        fused_window_block_strips,
        fused_window_block_strips_rem,
        window_block_bwd,
        window_block_strips_bwd,
    )
    from sam2unet_torch.ops.fused_mlp import adapter_bwd, fused_mlp, mlp_bwd_dx
    from sam2unet_torch.ops.fused_transition import (
        fused_transition_block,
        transition_bwd,
    )

    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device=DEV) * scale + shift
        return t.to(dtype).contiguous()

    def lin(o, i):
        return rnd(o, i, scale=1.0 / math.sqrt(i)), rnd(o, scale=0.1)

    if kind in ("mlp_tail", "mlp_adapter"):
        m, c = g["tokens"], g["c"]
        hd = 4 * c if kind == "mlp_tail" else 32
        x = rnd(m, c)
        w1, b1 = lin(hd, c)
        w2, b2 = lin(c, hd)
        if kind == "mlp_tail":
            lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
            call = lambda: fused_mlp(x, w1, b1, w2, b2, ln_w=lw, ln_b=lb,
                                     residual=True)
        else:
            call = lambda: fused_mlp(x, w1, b1, w2, b2, residual=True,
                                     gelu_out=True)
        flops = 4 * m * c * hd
        nbytes = 2 * m * c + 2 * c * hd + hd + 3 * c
        return call, flops, nbytes * x.element_size(), None

    if kind == "flash":
        # q/k/v as the long-form blocks pass them: slices of the QKV output
        b, s, nh, d = g["batch"], g["S"], g["heads"], g["d"]
        qkv = rnd(b, s, 3, nh, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        call = lambda: flash_attention(q, k, v, return_lse=True)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        flops = 4 * b * nh * s * s * d
        nbytes = 4 * b * s * nh * d * qkv.element_size() + 4 * b * nh * s
        return call, flops, nbytes, library

    if kind in ("strips", "strips_rem", "window", "transition"):
        c, nh = g["c"], g["heads"]
        cin = g.get("cin", c)
        cout = c
        lw, lb = rnd(cin, scale=0.1, shift=1.0), rnd(cin, scale=0.1)
        wq, bq = lin(3 * cout, cin)
        wp, bp = lin(cout, cout)
        if kind in ("strips", "strips_rem"):
            b, hh, win = g["batch"], g["grid"], g["window"]
            x = rnd(b, hh, hh, c)
            fn = (fused_window_block_strips if kind == "strips"
                  else fused_window_block_strips_rem)
            call = lambda: fn(x, wq, bq, lw, lb, wp, bp, num_heads=nh,
                              window=win)
            m, mq = b * hh * hh, b * hh * hh
            # query-key pairs: each window's tokens inside the grid, plus
            # the pad key of an edge window
            edges = [min(win, hh - i) for i in range(0, hh, win)]
            pairs = b * sum(vh * vw * (vh * vw + (vh * vw < win * win))
                            for vh in edges for vw in edges)
        elif kind == "window":
            nw, s, n_pad = g["windows"], g["S"], g.get("n_pad", 0)
            x = rnd(nw, s, c)
            call = lambda: fused_window_block(x, wq, bq, lw, lb, wp, bp,
                                              num_heads=nh, n_pad=n_pad)
            m, mq, pairs = nw * s, nw * s, nw * s * (s + (n_pad > 0))
        else:
            b, hh, win = g["batch"], g["grid"], g["window"]
            x = rnd(b, hh, hh, cin)
            ws, bs = lin(cout, cin)
            call = lambda: fused_transition_block(x, wq, bq, lw, lb, wp, bp,
                                                  ws, bs, num_heads=nh,
                                                  window=win)
            m, mq = b * hh * hh, b * hh * hh // 4
            pairs = mq * win * win
        # QKV (+ shortcut) products at full resolution, attention and proj
        # per query
        flops = 2 * m * cin * 3 * cout + 4 * pairs * cout + 2 * mq * cout * cout
        nel = m * cin + mq * cout + 3 * cout * cin + cout * cout + 4 * cout + 2 * cin
        if kind == "transition":
            flops += 2 * m * cin * cout
            nel += cout * cin + cout
        return call, flops, nel * x.element_size(), None

    # backward kernels: dx (and K3's fp32 weight gradients) for a cotangent
    # gy; operations count the recomputed forward the kernel needs
    if kind in ("mlp_tail_bwd", "mlp_adapter_bwd"):
        m, c = g["tokens"], g["c"]
        hd = 4 * c if kind == "mlp_tail_bwd" else 32
        x, gy = rnd(m, c), rnd(m, c)
        w1, b1 = lin(hd, c)
        w2, b2 = lin(c, hd)
        es = x.element_size()
        if kind == "mlp_tail_bwd":
            lw, lb = rnd(c, scale=0.1, shift=1.0), rnd(c, scale=0.1)
            call = lambda: mlp_bwd_dx(x, gy, w1, b1, w2, b2, lw, lb)
            return (call, 6 * m * c * hd,
                    (3 * m * c + 2 * c * hd + hd + 2 * c) * es, None)
        call = lambda: adapter_bwd(x, gy, w1, b1, w2, b2)
        return (call, 12 * m * c * hd,
                (3 * m * c + 2 * c * hd + hd + c) * es + (2 * c * hd + hd + c) * 4,
                None)

    if kind in ("strips_bwd", "window_bwd", "transition_bwd"):
        c, nh = g["c"], g["heads"]
        cin = g.get("cin", c)
        lw, lb = rnd(cin, scale=0.1, shift=1.0), rnd(cin, scale=0.1)
        wq, bq = lin(3 * c, cin)
        wp, bp = lin(c, c)
        if kind == "strips_bwd":
            b, hh, win = g["batch"], g["grid"], g["window"]
            x, gy = rnd(b, hh, hh, c), rnd(b, hh, hh, c)
            call = lambda: window_block_strips_bwd(x, gy, wq, bq, lw, lb, wp, bp,
                                                   num_heads=nh, window=win)
            m = mq = b * hh * hh
            pairs = m * win * win
        elif kind == "window_bwd":
            nw, s_ = g["windows"], g["S"]
            x, gy = rnd(nw, s_, c), rnd(nw, s_, c)
            call = lambda: window_block_bwd(x, gy, wq, bq, lw, lb, wp, bp,
                                            num_heads=nh)
            m = mq = nw * s_
            pairs = m * s_
        else:
            b, hh, win = g["batch"], g["grid"], g["window"]
            if g.get("ties"):
                # every 2x2 cell of four equal tokens: exact ties in the
                # projected q and the shortcut, in both versions
                x = rnd(b, hh // 2, hh // 2, cin)
                x = x.repeat_interleave(2, 1).repeat_interleave(2, 2).contiguous()
            else:
                x = rnd(b, hh, hh, cin)
            gy = rnd(b, hh // 2, hh // 2, c)
            ws, bs = lin(c, cin)
            if g.get("no_near_ties"):
                x = _without_near_ties(x, rnd, lw, lb, wq[:c], bq[:c], ws, bs)
            call = lambda: transition_bwd(x, gy, wq, bq, lw, lb, wp, bp, ws, bs,
                                          num_heads=nh, window=win)
            m, mq = b * hh * hh, b * hh * hh // 4
            pairs = mq * win * win
        # forward again (QKV [+ shortcut], attention), then dO = gy Wp, the
        # attention backward (dV, dP, dQ, dK) and dLN = dqkv W_qkv [+ dshort]
        extra = cin * c if kind == "transition_bwd" else 0
        flops = (2 * 2 * m * (cin * 3 * c + extra) + 4 * pairs * c
                 + 2 * mq * c * c + 8 * pairs * c)
        nel = 2 * m * cin + mq * c + 4 * c * cin + c * c + 4 * c + 2 * cin
        return call, flops, nel * x.element_size(), None
    raise ValueError(kind)


def _without_near_ties(x, rnd, ln_w, ln_b, w_q, b_q, w_short, b_short,
                       gap: float = 1e-4):
    """x (B, H, W, cin) with the tokens of every 2x2 cell where the
    projected q or the shortcut has a near-tie (its two largest values
    within `gap` in some channel) drawn anew, until no cell has one. There
    the kernel's and the plain version's recomputed forwards, which differ
    by rounding, may route a max-pool's gradient to different tokens; fp32
    rounding moves these projections by ~1e-6."""
    import torch

    from sam2unet_torch.nn.layers import layer_norm_plain, linear_f32

    b, hh, wd, cin = x.shape
    for _ in range(20):
        xn = layer_norm_plain(x, ln_w, ln_b)
        proj = torch.cat([linear_f32(xn, w_q, b_q),
                          linear_f32(xn, w_short, b_short)], -1)
        cells = proj.reshape(b, hh // 2, 2, wd // 2, 2, -1).permute(
            0, 1, 3, 5, 2, 4).reshape(b, hh // 2, wd // 2, -1, 4)
        top = cells.topk(2, dim=-1).values
        near = ((top[..., 0] - top[..., 1]) < gap).any(-1)
        if not near.any():
            return x
        near = near.repeat_interleave(2, 1).repeat_interleave(2, 2)[..., None]
        x = torch.where(near, rnd(b, hh, wd, cin), x).contiguous()
        del xn, proj, cells, top
    fail("K9 fp32 input: near-ties remain after 20 redraws")


def kernel_specs(path: str, b: int) -> list[tuple]:
    """(name, kind, replaces, source, counted launches (wrapper, variant),
    main-path shapes, index of the timed shape) of each kernel of a path."""
    fab = "sam2unet_tpu/ops/pallas/fused_attention_block.py"
    src_ab = "sam2unet_torch/csrc/fused_attention_block.cu"
    src_ab_bwd = "sam2unet_torch/csrc/fused_attention_block_bwd.cu"
    src_mlp_bwd = "sam2unet_torch/csrc/fused_mlp_bwd.cu"
    mlp = ("sam2unet_tpu/ops/pallas/fused_mlp.py:135",
           "sam2unet_torch/csrc/fused_mlp.cu")
    tra = ("sam2unet_tpu/ops/pallas/fused_transition.py:256",
           "sam2unet_torch/csrc/fused_transition.cu")

    def npad(v: str) -> int:
        return int(v.split("n_pad=")[1])

    if path == "l352train":
        grids, cs = (88, 44, 22, 11), (144, 288, 576, 1152)
        tokens = [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)]
        tra_shapes = [dict(batch=b, grid=88, cin=144, c=288, heads=4, window=8),
                      dict(batch=b, grid=44, cin=288, c=576, heads=8, window=4)]
        return [
            ("K2 mlp_bwd_dx", "mlp_tail_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:432", src_mlp_bwd,
             lambda w, v: w == "mlp_bwd_dx", tokens, 2),
            ("K3 adapter_bwd", "mlp_adapter_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:551", src_mlp_bwd,
             lambda w, v: w == "adapter_bwd", tokens, 2),
            ("K5 window_block_strips_bwd", "strips_bwd", f"{fab}:1082",
             src_ab_bwd,
             lambda w, v: w == "window_block_strips_bwd",
             [dict(batch=b, grid=88, c=144, heads=2, window=8),
              dict(batch=b, grid=44, c=288, heads=4, window=4)], 0),
            ("K7 window_block_bwd", "window_bwd", f"{fab}:669", src_ab_bwd,
             lambda w, v: w == "window_block_bwd",
             [dict(windows=b, S=256, c=576, heads=8),
              dict(windows=b, S=64, c=1152, heads=16),
              dict(windows=b, S=484, c=576, heads=8)], 0),
            ("K9 transition_bwd", "transition_bwd",
             "sam2unet_tpu/ops/pallas/fused_transition.py:483",
             "sam2unet_torch/csrc/fused_transition_bwd.cu",
             lambda w, v: w == "transition_bwd",
             tra_shapes + [dict(tra_shapes[1], ties=True)], 0),
        ]
    if path == "l352":
        grids, cs = (88, 44, 22, 11), (144, 288, 576, 1152)
        return [
            ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
             lambda w, v: w == "fused_mlp" and v == "ln",
             [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
            ("K1 fused_mlp (adapter)", "mlp_adapter", *mlp,
             lambda w, v: w == "fused_mlp" and v == "no_ln",
             [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
            ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
             lambda w, v: w == "fused_window_block_strips",
             [dict(batch=b, grid=88, c=144, heads=2, window=8),
              dict(batch=b, grid=44, c=288, heads=4, window=4)], 0),
            ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354", src_ab,
             lambda w, v: (w == "fused_window_block" and npad(v) == 0
                           and not v.startswith("S=484,")),
             [dict(windows=b, S=256, c=576, heads=8),
              dict(windows=b, S=64, c=1152, heads=16)], 0),
            ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354", src_ab,
             lambda w, v: w == "fused_window_block" and npad(v) > 0,
             [dict(windows=b, S=96, c=576, heads=8, n_pad=160),
              dict(windows=b, S=36, c=576, heads=8, n_pad=220),
              dict(windows=b, S=24, c=1152, heads=16, n_pad=40),
              dict(windows=b, S=9, c=1152, heads=16, n_pad=55)], 0),
            ("K6 fused_window_block (global S=484)", "window", f"{fab}:354",
             src_ab,
             lambda w, v: w == "fused_window_block" and v.startswith("S=484,"),
             [dict(windows=b, S=484, c=576, heads=8)], 0),
            ("K8 fused_transition_block", "transition", *tra,
             lambda w, v: w == "fused_transition_block",
             [dict(batch=b, grid=88, cin=144, c=288, heads=4, window=8),
              dict(batch=b, grid=44, cin=288, c=576, heads=8, window=4)], 0),
        ]
    grids, cs = (240, 120, 60, 30), (96, 192, 384, 768)
    return [
        ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
         lambda w, v: w == "fused_mlp" and v == "ln",
         [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
        ("K1 fused_mlp (adapter)", "mlp_adapter", *mlp,
         lambda w, v: w == "fused_mlp" and v == "no_ln",
         [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
        ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
         lambda w, v: w == "fused_window_block_strips",
         [dict(batch=b, grid=240, c=96, heads=1, window=8),
          dict(batch=b, grid=120, c=192, heads=2, window=4)], 0),
        ("K8 fused_transition_block", "transition", *tra,
         lambda w, v: w == "fused_transition_block",
         [dict(batch=b, grid=240, cin=96, c=192, heads=2, window=8),
          dict(batch=b, grid=120, cin=192, c=384, heads=4, window=4)], 0),
        ("K10 flash_attention", "flash",
         "sam2unet_tpu/ops/pallas/flash_attention.py:190",
         "sam2unet_torch/csrc/flash_attention.cu",
         lambda w, v: w == "flash_attention",
         [dict(batch=b, S=3600, heads=4, d=96)], 0),
        ("K12 fused_window_block_strips_rem", "strips_rem", f"{fab}:1566",
         src_ab, lambda w, v: w == "fused_window_block_strips_rem",
         [dict(batch=b, grid=60, c=384, heads=4, window=14),
          dict(batch=b, grid=30, c=768, heads=8, window=7)], 0),
    ]


def compare(call, tol: float) -> tuple[float, float, float]:
    """Max |kernel - plain| over the call's outputs, that over max |plain|
    (the worst of the outputs), and the largest share of an output's tokens
    (rows of its last axis) past tol * max |plain| (1 if not finite)."""
    import torch

    from sam2unet_torch.ops import dispatch

    def outs(r):
        return [t.float() for t in (r if isinstance(r, tuple) else (r,))]

    got = outs(call())
    with dispatch.force_plain():
        want = outs(call())
    torch.cuda.synchronize()
    worst_abs = worst_rel = worst_share = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs()
        err, scale = diff.max().item(), max(w.abs().max().item(), 1e-30)
        rel = err / scale
        share = (diff.reshape(-1, diff.shape[-1]).amax(-1) > tol * scale
                 ).float().mean().item()
        if not math.isfinite(err):
            rel = share = math.inf
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        worst_share = max(worst_share, share)
    return worst_abs, worst_rel, worst_share


def kernel_phase(path: str, batch: int, gen) -> list[dict]:
    """Phase 2 for one path. Returns the JSON entries (without launches)."""
    import torch

    from sam2unet_torch.ops import dispatch

    label = PATHS[path]["label"]
    entries = []
    for name, kind, replaces, source, select, shapes, timed in kernel_specs(
            path, batch):
        worst_abs = worst_rel = 0.0
        for i, g in enumerate(shapes):
            call, flops, nbytes, library = make_case(kind, torch.bfloat16, gen,
                                                     **g)
            err, rel, share = compare(call, BF16_REL_TOL)
            near_ties = kind == "transition_bwd" and not g.get("ties")
            ok = (share <= K9_BF16_TOKEN_SHARE and rel <= K9_BF16_OUTLIER_REL
                  if near_ties else share == 0.0)
            line = (f"[kernel] {name} {label} bf16 {g}: max_abs_err {err:.4g} "
                    f"max_rel_err {rel:.4g} (tol {BF16_REL_TOL})")
            if near_ties:
                line += (f", tokens past the tolerance {share:.3g} (at most "
                         f"{K9_BF16_TOKEN_SHARE}, each within "
                         f"{K9_BF16_OUTLIER_REL})")
            if i == timed:
                ms = time_ms(call)
                with dispatch.force_plain():
                    plain_ms = time_ms(call)
                library_ms = time_ms(library) if library else None
                t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
                bound_ms = 1e3 * max(t_bytes, t_ops)
                bound_by = "bytes" if t_bytes > t_ops else "operations"
                line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms ({bound_by})")
                if library:
                    line += f", library {library_ms:.4f} ms"
                entry = dict(name=f"{name} [{label}]", route="cuda",
                             source=source, select=select, path=path,
                             replaces=replaces, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
            print(line + ("" if ok else "  <-- FAIL"), flush=True)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if not ok:
                fail(f"{name} disagrees with its plain version at {g}")
            del call, library
        # fp32 once, at the smallest main-path shape of the kernel; K9's at
        # its timed shape, full batch, on an input without near-ties
        g = dict(shapes[-1])
        if kind == "transition_bwd":
            g = dict(shapes[timed], no_near_ties=True)
        for key in ("batch", "windows"):
            if key in g and kind != "transition_bwd":
                g[key] = min(g[key], 2)
        if "tokens" in g:
            g["tokens"] = min(g["tokens"], 2 * 484)
        err, rel, share = compare(make_case(kind, torch.float32, gen, **g)[0],
                                  FP32_REL_TOL)
        ok = share == 0.0
        print(f"[kernel] {name} {label} fp32 {g}: max_abs_err {err:.4g} "
              f"max_rel_err {rel:.4g} (tol {FP32_REL_TOL})"
              + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            fail(f"{name} fp32 disagrees with its plain version at {g}")
        entry["max_abs_err"] = worst_abs
        entries.append(entry)
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------- main path


def write_dataset(root: Path, n: int = 4, seed: int = 0) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(n):
        h, w = int(rng.integers(200, 400)), int(rng.integers(200, 400))
        img = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        yy, xx = np.mgrid[:h, :w]
        cy, cx = rng.integers(h // 4, 3 * h // 4), rng.integers(w // 4, 3 * w // 4)
        mask = ((yy - cy) ** 2 + (xx - cx) ** 2 < (min(h, w) // 4) ** 2)
        mask = mask.astype(np.uint8) * 255
        img[mask > 0] = (img[mask > 0] * 0.3 + 170).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"s{i}.jpg")
        Image.fromarray(mask).save(root / "masks" / f"s{i}.png")


def random_checkpoint(path: Path, cfg: str, seed: int) -> None:
    """Seeded random SAM2UNet state dict of trunk `cfg`; the
    zero-initialised pos-embeds get noise so they take part."""
    import torch

    from sam2unet_torch.cli.common import build_model

    torch.manual_seed(seed)
    model = build_model(cfg, torch.device("cpu"))
    with torch.no_grad():
        model.encoder.pos_embed.normal_(0.0, 0.02)
        model.encoder.pos_embed_window.normal_(0.0, 0.02)
    torch.save(model.state_dict(), path)


def main_path_phase(path: str, tmp: Path) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from sam2unet_torch.cli import test_cli
    from sam2unet_torch.cli.common import build_model, load_checkpoint
    from sam2unet_torch.data.dataset import EvalDataset
    from sam2unet_torch.ops import dispatch

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    data, ckpt, preds = tmp / "data", tmp / f"{cfg}.pth", tmp / f"preds_{path}"
    if not data.exists():
        write_dataset(data)
    random_checkpoint(ckpt, cfg, seed=0)
    argv = ["--checkpoint", str(ckpt), "--test_image_path", str(data / "images"),
            "--test_gt_path", str(data / "masks"), "--save_path", str(preds),
            "--bf16", "--batch_size", "4", "--device", DEV]
    defaults = test_cli.build_parser().parse_args(argv)
    at_defaults = (defaults.size, defaults.model_cfg) == (size, cfg)
    if not at_defaults:
        argv += ["--size", str(size), "--model_cfg", cfg]
    args = test_cli.build_parser().parse_args(argv)
    dispatch.reset_launches()
    stats = test_cli.main(args)
    torch.cuda.synchronize()
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    print(f"[main] {label} test_cli --size {args.size} --model_cfg "
          f"{args.model_cfg} ({'the CLI defaults' if at_defaults else 'passed'}): "
          f"{stats['forwards']} forward(s) over {stats['images']} images, "
          f"mean_test_time {stats['mean_test_time']:.4f} s/image; launches "
          f"{counts}; by variant "
          f"{ {f'{w}[{v}]': n for (w, v), n in variants.items()} }", flush=True)
    per_forward = spec["per_forward"]
    for name in set(per_forward) | set(counts):
        want = per_forward.get(name, 0) * stats["forwards"]
        if counts.get(name, 0) != want:
            fail(f"{label}: {name} launched {counts.get(name, 0)} times, "
                 f"expected {want}")
    for i in range(4):
        png = np.asarray(Image.open(preds / f"s{i}.png"))
        gt = np.asarray(Image.open(data / "masks" / f"s{i}.png"))
        if png.shape != gt.shape or png.dtype != np.uint8 or png.min() == png.max():
            fail(f"{label} s{i}.png: shape {png.shape} vs GT {gt.shape}, range "
                 f"{png.min()}..{png.max()}")
    print(f"[main] {label} 4 PNGs: GT shapes, uint8, more than one value",
          flush=True)

    # the same batch through the plain versions on the card
    model = build_model(cfg, torch.device("cpu"))
    load_checkpoint(model, str(ckpt))
    model = model.to(device=DEV, dtype=torch.bfloat16)
    batch = next(EvalDataset(str(data / "images"), str(data / "masks"),
                             size).batches(4))
    x = torch.from_numpy(batch["image"]).to(DEV)
    with torch.inference_mode():
        got = model(x)[0].float()
        with dispatch.force_plain():
            want = model(x)[0].float()
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1].item()
    ok = math.isfinite(err) and corr >= MAIN_CORR_MIN and rel <= MAIN_REL_TOL
    print(f"[main] {label} logits kernels vs plain (bf16, batch 4): "
          f"max_abs_err {err:.4g} max_rel_err {rel:.4g} (tol {MAIN_REL_TOL}) "
          f"corr {corr:.6f} (min {MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"),
          flush=True)
    if not ok:
        fail(f"{label} main path logits disagree with the plain versions")
    del model, got, want
    torch.cuda.empty_cache()
    return variants


def train_main_phase(path: str, tmp: Path, step_seeds: list[int],
                     step_report: str = "") -> dict:
    """The train CLI end to end, its checkpoint through the test CLI, and
    one train step's loss and gradients, kernels against plain versions."""
    import torch

    from sam2unet_torch.cli import test_cli, train_cli
    from sam2unet_torch.cli.common import build_model
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.optim import is_trainable

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    data, train_data = tmp / "data", tmp / "train"
    ckpt, out = tmp / f"{cfg}.pth", tmp / "train_run"
    if not data.exists():
        write_dataset(data)
    write_dataset(train_data, n=16, seed=1)
    if not ckpt.exists():
        random_checkpoint(ckpt, cfg, seed=0)
    argv = ["--save_path", str(out), "--checkpoint", str(ckpt),
            "--train_image_path", str(train_data / "images"),
            "--train_mask_path", str(train_data / "masks"),
            "--test_image_path", str(data / "images"),
            "--test_gt_path", str(data / "masks"), "--size", str(size),
            "--model_cfg", cfg, "--bf16", "--batch_size", "8", "--epoch", "2",
            "--num_workers", "4", "--device", DEV]
    args = train_cli.build_parser().parse_args(argv)
    dispatch.reset_launches()
    t0 = time.perf_counter()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    steps, evals = stats["steps"], stats["eval_forwards"]
    print(f"[main] {label} train_cli --size {size} --model_cfg {cfg} --bf16 "
          f"--batch_size 8 --epoch 2: {steps} steps, {evals} eval forwards in "
          f"{seconds:.1f} s (host clock, kernel build excluded); losses "
          f"{[round(v, 4) for v in stats['losses']]}; launches {counts}",
          flush=True)
    if not stats["losses"] or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"{label}: a logged loss is not finite: {stats['losses']}")
    per_forward = PATHS["l352"]["per_forward"]
    per_step = spec["per_step"]
    for name in set(per_step) | set(counts):
        want = per_step.get(name, 0) * steps + per_forward.get(name, 0) * evals
        got = counts.get(name, 0)
        print(f"[main] {label} {name}: {got} launches = "
              f"{(got - per_forward.get(name, 0) * evals) / max(steps, 1):g} per "
              f"train step (table {per_step.get(name, 0)}) over {steps} steps "
              f"+ {per_forward.get(name, 0)} per eval forward", flush=True)
        if got != want:
            fail(f"{label}: {name} launched {got} times, expected {want}")

    log = Path(stats["log"]).read_text()
    if log.count("epoch-") < 2 or log.count("mIoU") != 2:
        fail(f"{label}: log.txt lacks the two epoch reports:\n{log}")
    if not stats["saved"]:
        fail(f"{label}: no checkpoint was written")
    start = torch.load(ckpt, map_location="cpu", weights_only=True)
    saved = torch.load(stats["saved"][-1], map_location="cpu", weights_only=True)
    names = [n for n, _ in build_model(cfg, torch.device("cpu")).named_parameters()]
    moved = [n for n in names if not torch.equal(saved[n], start[n])]
    trainable = [n for n in names if is_trainable(n)]
    frozen_moved = sorted(set(moved) - set(trainable))
    still = sorted(set(trainable) - set(moved))
    print(f"[main] {label} checkpoint {Path(stats['saved'][-1]).name}: "
          f"{len(trainable)} trainable parameters, {len(moved)} moved; frozen "
          f"moved {len(frozen_moved)}; log.txt holds the 2 epoch reports",
          flush=True)
    if frozen_moved or still:
        fail(f"{label}: frozen parameters moved {frozen_moved[:5]}, trainable "
             f"ones did not {still[:5]}")
    preds = tmp / "train_preds"
    targs = test_cli.build_parser().parse_args([
        "--checkpoint", stats["saved"][-1], "--test_image_path",
        str(data / "images"), "--test_gt_path", str(data / "masks"),
        "--save_path", str(preds), "--size", str(size), "--model_cfg", cfg,
        "--bf16", "--batch_size", "4", "--device", DEV])
    tstats = test_cli.main(targs)
    if len(list(preds.glob("*.png"))) != 4:
        fail(f"{label}: the test CLI did not write 4 PNGs from the checkpoint")
    print(f"[main] {label} test_cli loaded the checkpoint strictly: "
          f"{tstats['forwards']} forward(s), mean_test_time "
          f"{tstats['mean_test_time']:.4f} s/image", flush=True)
    del start, saved
    step_compare(path, ckpt, step_seeds, step_report)
    return variants


def _train_model(cfg: str, ckpt: Path | None = None, bf16: bool = True):
    """A model for training on the card: with bf16, the frozen trunk in
    bf16 and the rest fp32; else all fp32."""
    import torch

    from sam2unet_torch.cli.common import build_model, load_checkpoint
    from sam2unet_torch.models.sam2unet import cast_frozen

    torch.manual_seed(1)
    model = build_model(cfg, torch.device("cpu"))
    if ckpt is not None:
        load_checkpoint(model, str(ckpt))
    model = model.to(DEV)
    if bf16:
        cast_frozen(model, torch.bfloat16)
    return model


def _train_batch(batch: int, size: int, seed: int):
    import torch

    g = torch.Generator(device=DEV)
    g.manual_seed(seed)
    x = torch.randn(batch, size, size, 3, device=DEV, generator=g)
    yy, xx = torch.meshgrid(torch.arange(size, device=DEV),
                            torch.arange(size, device=DEV), indexing="ij")
    r = size // 4
    y = ((yy - size // 2) ** 2 + (xx - size // 3) ** 2 < r * r).float()
    return x, y[None, :, :, None].expand(batch, size, size, 1).contiguous()


def _leaf_agreement(got: dict, want: dict) -> dict:
    """Per trainable leaf: (correlation, max |got - want| / max |want|)."""
    import torch

    out = {}
    for n, b in want.items():
        a, b = got[n].flatten().double(), b.flatten().double()
        rel = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        corr = (torch.corrcoef(torch.stack([a, b]))[0, 1].item()
                if a.numel() > 1 else 1.0)
        if not (math.isfinite(rel) and math.isfinite(corr)):
            corr, rel = -1.0, math.inf
        out[n] = (corr, rel)
    return out


def step_compare(path: str, ckpt: Path, seeds: list[int],
                 report: str = "") -> None:
    """One train step's loss and trainable gradients, the kernels against
    the plain versions, same parameters and batch (batch 4, one batch per
    seed), in fp32 and in bf16. fp32 holds every leaf to MAIN_CORR_MIN and
    MAIN_REL_TOL and tighter (correlation >= 0.9999, max error <= 1e-2 of
    max |plain|). In bf16 the deep gradients decorrelate from the fp32 ones
    by rounding alone, in the plain version as in the kernels; each leaf's
    gap to the fp32 gradient, 1 - corr(kernel bf16, fp32), is held to the
    same leaf's plain bf16 gap (STEP_GAP_RATIO, STEP_GAP_MARGIN), and their
    mean to the plain's (STEP_GAP_MEAN_RATIO). `report` names a JSON file
    for every leaf's two gaps per seed."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.loss import multi_head_loss
    from sam2unet_torch.train.optim import trainable_parameters

    spec = PATHS[path]
    label = spec["label"]
    runs = {}
    for bf16 in (True, False):
        model = _train_model(spec["cfg"], ckpt, bf16)
        model.train()
        for seed in seeds:
            x, y = _train_batch(4, spec["size"], seed=seed)
            for plain in (False, True):
                model.zero_grad(set_to_none=True)
                with dispatch.force_plain() if plain else contextlib.nullcontext():
                    loss = multi_head_loss(model(x), y)
                    loss.backward()
                runs[seed, bf16, plain] = (loss.item(), {
                    n: p.grad.float().clone()
                    for n, p in trainable_parameters(model) if p.grad is not None})
        del model
        torch.cuda.empty_cache()
    ok, gaps = True, {}
    for seed in seeds:
        for bf16 in (False, True):
            (lk, gk), (lp, gp) = runs[seed, bf16, False], runs[seed, bf16, True]
            if gk.keys() != gp.keys() or not gk:
                fail(f"{label}: kernels and plain versions give gradients to "
                     "different parameters")
            agree = _leaf_agreement(gk, gp)
            loss_rel = abs(lk - lp) / abs(lp)
            corr_n, (corr, _) = min(agree.items(), key=lambda kv: kv[1][0])
            rel_n, (_, rel) = max(agree.items(), key=lambda kv: kv[1][1])
            line = (f"[main] {label} one step, seed {seed}, kernels vs plain "
                    f"({'bf16' if bf16 else 'fp32'}, batch 4): loss {lk:.6f} vs "
                    f"{lp:.6f} (rel {loss_rel:.3g}); {len(gp)} trainable "
                    f"gradients: worst correlation {corr:.6f} ({corr_n}), worst "
                    f"max_rel_err {rel:.4g} ({rel_n})")
            if not bf16:
                good = (loss_rel <= 1e-5 and corr >= max(MAIN_CORR_MIN, 0.9999)
                        and rel <= min(MAIN_REL_TOL, 1e-2))
                line += " (tol: loss 1e-5, correlation 0.9999, max_rel_err 0.01)"
            else:
                ref = runs[seed, False, True][1]
                k_ref, p_ref = _leaf_agreement(gk, ref), _leaf_agreement(gp, ref)
                leaf = {n: (1 - k_ref[n][0], 1 - p_ref[n][0]) for n in ref}
                gaps[seed] = leaf
                over = {n: k - (STEP_GAP_RATIO * p + STEP_GAP_MARGIN)
                        for n, (k, p) in leaf.items()}
                worst = max(over, key=over.get)
                ratio_n = max(leaf, key=lambda n: leaf[n][0] / max(leaf[n][1], 1e-12))
                k_mean = sum(k for k, _ in leaf.values()) / len(leaf)
                p_mean = sum(p for _, p in leaf.values()) / len(leaf)
                good = (loss_rel <= STEP_LOSS_RTOL and over[worst] <= 0
                        and k_mean <= STEP_GAP_MEAN_RATIO * p_mean)
                line += (f"; 1 - correlation with the fp32 gradient, kernels vs "
                         f"plain bf16: mean over the leaves {k_mean:.4g} vs "
                         f"{p_mean:.4g}; closest to the limit {worst} "
                         f"{leaf[worst][0]:.4g} vs {leaf[worst][1]:.4g}; largest "
                         f"ratio {ratio_n} {leaf[ratio_n][0]:.4g} vs "
                         f"{leaf[ratio_n][1]:.4g} (tol: loss {STEP_LOSS_RTOL}; "
                         f"each leaf <= {STEP_GAP_RATIO} x plain's + "
                         f"{STEP_GAP_MARGIN}; mean <= {STEP_GAP_MEAN_RATIO} x "
                         f"plain's)")
            print(line + ("" if good else "  <-- FAIL"), flush=True)
            ok = ok and good
    if report:
        Path(report).parent.mkdir(parents=True, exist_ok=True)
        Path(report).write_text(json.dumps(
            {str(s): {n: list(v) for n, v in g.items()} for s, g in gaps.items()}))
    if not ok:
        fail(f"{label}: one train step's kernels disagree with the plain "
             "versions")
    del runs
    torch.cuda.empty_cache()


def _model_and_input(path: str, batch: int):
    import torch

    from sam2unet_torch.cli.common import build_model

    size = PATHS[path]["size"]
    torch.manual_seed(1)
    model = build_model(PATHS[path]["cfg"], torch.device(DEV), torch.bfloat16)
    x = torch.randn(batch, size, size, 3, device=DEV, dtype=torch.bfloat16)
    return model, x


def _runner(path: str, batch: int):
    """(one step of the path: a forward, or a train step, its output)."""
    import torch

    spec = PATHS[path]
    if not spec.get("train"):
        model, x = _model_and_input(path, batch)

        def forward():
            with torch.inference_mode():
                return model(x)[0]
        return forward, "forward"
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.optim import make_optimizer

    model = _train_model(spec["cfg"])
    optimizer, _ = make_optimizer(model)
    x, y = _train_batch(batch, spec["size"], seed=3)
    return (lambda: train_step(model, optimizer, x, y)), "train step"


def throughput_phase(path: str, batch: int, card: str) -> float:
    import torch

    run, what = _runner(path, batch)
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = run()
    end.record()
    end.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{PATHS[path]['label']} throughput {what} produced non-finite "
             "values")
    ms = start.elapsed_time(end) / reps
    ips = batch / (ms / 1e3)
    print(f"[throughput] {PATHS[path]['label']} bf16 batch {batch}: {ms:.2f} "
          f"ms/{what}, {ips:.1f} img/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del run, out
    torch.cuda.empty_cache()
    return ips


def profile_phase(path: str, batch: int, card: str) -> None:
    """Optional: device time by kernel over one forward or train step
    (torch.profiler), and the device's idle share of its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run, what = _runner(path, batch)
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    # device-side kernel events only (one stream: they do not overlap)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("the profiler recorded no device time")
    by_name: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    busy_ms = sum(t for t, _ in by_name.values()) / 1e3
    span_ms = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels)) / 1e3
    print(f"[profile] {PATHS[path]['label']} bf16 batch {batch}, one {what}, "
          f"on {card}: host wall {wall_ms:.2f} ms (profiler on), device span "
          f"{span_ms:.2f} ms, kernels busy {busy_ms:.2f} ms, idle share of "
          f"the span {1 - busy_ms / span_ms:.3f}, {len(kernels)} device "
          f"kernels", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"{n:5d} calls  {name[:100]}", flush=True)
    # where the host's time goes: operators by their own CPU time
    host = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        print(f"[profile] host {e.self_cpu_time_total / 1e3:9.3f} ms "
              f"{e.count:6d} calls  {e.key[:80]}", flush=True)
    del run
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,main,throughput")
    ap.add_argument("--paths", default="l352,s960,l352train")
    ap.add_argument("--batch", type=int, default=32,
                    help="kernel, throughput and profile batch at hiera_l@352")
    ap.add_argument("--batch960", type=int, default=16,
                    help="the same at hiera_s@960")
    ap.add_argument("--batch_train", type=int, default=16,
                    help="the same for the hiera_l@352 training path")
    ap.add_argument("--step_seeds", default="2",
                    help="batches (by seed) of the one-step kernels-vs-plain "
                         "comparison")
    ap.add_argument("--step_report", default="",
                    help="JSON file for that comparison's per-leaf gaps")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    paths = args.paths.split(",")
    if not set(paths) <= set(PATHS):
        print(f"chip_smoke: unknown path in {paths} (have {sorted(PATHS)})")
        sys.exit(2)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", flush=True)
        sys.exit(2)
    if not (REPO / "sam2unet_torch" / "ops" / "build.py").is_file():
        print("chip_smoke: the sam2unet_torch package is not beside this "
              "script", flush=True)
        sys.exit(2)
    sys.path.insert(0, str(REPO))
    from sam2unet_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    out_dir = build.build_all()
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s into "
          f"{out_dir.relative_to(REPO)}", flush=True)
    for line in build.ptxas_summary(out_dir):
        print(f"[ptxas] {line}", flush=True)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    entries, variants = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in paths:
            batch = {"l352": args.batch, "s960": args.batch960,
                     "l352train": args.batch_train}[path]
            if "kernels" in phases:
                entries += kernel_phase(path, batch, gen)
            if "main" in phases:
                if PATHS[path].get("train"):
                    variants[path] = train_main_phase(
                        path, Path(tmp), [int(s) for s in args.step_seeds.split(",")],
                        args.step_report)
                else:
                    variants[path] = main_path_phase(path, Path(tmp))
            if "throughput" in phases:
                throughput_phase(path, batch, card)
            if "profile" in phases:
                profile_phase(path, batch, card)

    for e in entries:
        select, path = e.pop("select"), e.pop("path")
        e["launches"] = sum(n for (w, v), n in variants.get(path, {}).items()
                            if select(w, v))
        if path in variants and not e["launches"]:
            fail(f"{e['name']} was not launched on its main path")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
