#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sam2unet_torch): inference at
hiera_l @ 352 and hiera_s @ 960 (the test CLI's defaults), training at
hiera_l @ 352 and at hiera_s @ 960 (the train CLI's defaults), and the SAM2
image predictor at sam2_hiera_s @ 1024 (build_sam2's defaults).

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases build,kernels --batch 2 --batch960 2 \
        --batch_train 2 --batch_train960 2
    python3 chip_smoke.py --phases build,profile   # device time by kernel
    python3 chip_smoke.py --paths s960train        # one path
    python3 chip_smoke.py --paths s1024sam2        # the SAM2 predictor

Phases, one line each, for each path of --paths (l352, s960, then the
training paths l352train and s960train, listed after these):
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
The training paths, l352train (hiera_l@352) and s960train (hiera_s@960),
bf16 over fp32 master parameters, the trunk frozen:
  2. every backward kernel (K2, K3, K5, K7, K9, and at 960 the forward of
     the valid groups, K6 at head dim 96 with and without the pad key, and
     K11: the delta pass, the dq pass, the dk/dv pass and the three
     together, on strided views of one (rows, 3c) buffer at (16, 3600, 4,
     96) and on a pair of ragged lengths, against
     `plain_flash_attention_bwd`, with the backward of SDPA as the
     library's time) against autograd through its plain
     version on the card at the training step's shapes at --batch_train /
     --batch_train960 (16), bf16 (K9 also on a case of exact ties; K9's
     max-pool routing may send a near-tie elsewhere than the plain
     version's recomputed forward does, so up to 1e-3 of its tokens may
     differ in bf16, each within 0.1 of max |plain|) and fp32 once (K9's
     at the full batch, on an input without near-ties); timed with the
     bound counting the recomputed forward.
  3. the main path: the train CLI (sam2unet_torch.cli.train_cli.main) on a
     synthetic set of 16 train and 4 test images from the seeded random
     checkpoint, --size 352 --model_cfg sam2_hiera_l --bf16 --batch_size 8
     --epoch 2, or for s960train the CLI's defaults (hiera_s, 960, batch
     16) with --bf16 --epoch 2 --save_train_state and then --resume from
     the saved state for a third epoch: finite losses that fall, every trainable parameter moved, every frozen
     one bit-identical, the epoch reports in log.txt, a checkpoint that the
     test CLI loads strictly and runs; launches per train step of every
     wrapper (counters set to 0 just before, read just after); then one
     step's loss and trainable gradients, kernels against plain versions
     on the same parameters and batch (batch 4, at 960 batch 2;
     --step_seeds): in fp32
     every leaf to correlation 0.9999 and 1e-2 of max |plain|; in bf16 the
     loss to 1e-2 and each leaf's gradient about as close to the fp32 one
     as the plain bf16 version's of the same leaf (rounding alone
     decorrelates the deepest leaves, plain and kernels alike). At 960 also
     --remat's block checkpointing against the model without it: the same
     loss and the same trainable gradients (under deterministic algorithms,
     where two identical steps agree), and its launch counts.
  4. train-step throughput, bf16, batch --batch_train / --batch_train960,
     CUDA events over 5 steps after 2 warm-up steps, and peak memory; at
     960 also with --remat. A batch that does not fit the card's memory is
     reported with its size and halved.
The SAM2 predictor path, s1024sam2 (sam2_hiera_s @ 1024 through
build_sam2_image_predictor, bf16, seeded random weights):
  2. its kernels at the predictor's shapes (one image a set_image): K1 on
     the block tails, K4, K8, K10 on the 4096-token global blocks and on the
     mask decoder's 16 tokens x 4096 keys at head dim 16, K12 on 64x64 w14
     and 32x32 w7; and K14 at every shape its paths give it under the
     "pallas" attention backend (this trunk's and SAM2-UNet's stage 3->4
     transitions, the decoder's 8-token attentions), timed at SAM2-UNet's
     960 transition beside SDPA.
  3. set_image on a seeded 720x960 image, predict with one point, a box,
     points and a box, 9 points (16 tokens: the decoder's K10), multimask
     on and off, a mask input, set_image_batch + predict_batch over 2
     images: shapes, ious in [0, 1], masks not empty, the launches of each
     call against the table in PATHS; the embedding and low-res logits
     against force_plain(); then under set_attention_impl("pallas"): K14's
     launches per set_image and per predict, the same outputs against the
     default backend, and SAM2-UNet's hiera_s@960 forward (batch 16) with
     K14 at its stage 3->4 transition against the default backend.
  4. set_image ms (host clock) and its forward alone, steady-state
     one-point predict ms (device and host postprocess), peak memory.
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
                      train=True, eval_path="l352", cli_batch=8, step_batch=4,
                      per_step={"fused_mlp": 96, "fused_window_block_strips": 7,
                                "fused_window_block": 143,
                                "fused_transition_block": 2,
                                "adapter_bwd": 48, "mlp_bwd_dx": 48,
                                "window_block_strips_bwd": 7,
                                "window_block_bwd": 38, "transition_bwd": 2}),
    # the train CLI's defaults. Per step, from the routes under train
    # (tests/test_torch_model_960_cpu.py): K4 at blocks 0 and 2, the 240x240
    # transition unfused, K8 at block 3, eight valid-group blocks of four
    # groups each (K6: 32, one n_pad = 0 group per block for K7: 8), three
    # long blocks (K10 in the forward and again in the backward's recompute:
    # 6; K11: 3, counted as its delta, dq and dk/dv passes), 16 tails and 16
    # adapters. With --remat every trunk block's forward runs twice.
    "s960train": dict(label="hiera_s@960 train", cfg="sam2_hiera_s", size=960,
                      train=True, eval_path="s960", cli_batch=16, step_batch=2,
                      remat=True, resume=True,
                      per_step={"fused_mlp": 32, "fused_window_block_strips": 2,
                                "fused_window_block": 32,
                                "fused_transition_block": 1,
                                "flash_attention": 6,
                                "adapter_bwd": 16, "mlp_bwd_dx": 16,
                                "window_block_strips_bwd": 2,
                                "window_block_bwd": 8, "transition_bwd": 1,
                                "flash_attention_bwd_delta": 3,
                                "flash_attention_bwd_dq": 3,
                                "flash_attention_bwd_dkv": 3},
                      per_step_remat={"fused_mlp": 64,
                                      "fused_window_block_strips": 4,
                                      "fused_window_block": 64,
                                      "fused_transition_block": 2,
                                      "flash_attention": 9}),
    # the SAM2 image predictor at build_sam2's default config. Per
    # set_image, from the routes (tests/test_torch_sam2_cpu.py): K1 on the 16
    # block tails (no adapters), K4 at blocks 0 and 2, K8 at blocks 1 and 3,
    # K12 on the 8 remainder-grid blocks of stages 3-4, K10 in the three
    # 4096-token global blocks; the stage 3->4 transition is plain. A
    # prompt of up to 10 tokens' predict launches nothing (the decoder's
    # attentions take the einsum form); one of 16 (9 points) runs its three
    # token->image attentions on K10. Under the "pallas" backend K14 adds 1
    # per set_image (the transition) and 4 per 8-token predict (2 token
    # self-attentions, 2 image->token attentions). set_image embeds one
    # image, so its kernels are held and profiled at batch 1.
    "s1024sam2": dict(label="sam2_hiera_s@1024 predictor", cfg="sam2_hiera_s",
                      size=1024, sam2=True, batch=1,
                      per_set_image={"fused_mlp": 16,
                                     "fused_window_block_strips": 2,
                                     "fused_transition_block": 2,
                                     "fused_window_block_strips_rem": 8,
                                     "flash_attention": 3},
                      per_predict_16={"flash_attention": 3},
                      pallas_set_image={"full_attention": 1},
                      pallas_predict_8={"full_attention": 4}),
}
BATCH_FLAG = {"l352": "batch", "s960": "batch960", "l352train": "batch_train",
              "s960train": "batch_train960"}


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

    from sam2unet_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_delta,
        flash_attention_bwd_dkv,
        flash_attention_bwd_dq,
        full_attention,
    )
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

    if kind in ("flash", "full"):
        # q/k/v as the long-form blocks pass them: slices of the QKV output;
        # with Sk, as the mask decoder passes them: q of one length, k and v
        # slices of one buffer of another. K10 also returns the lse; K14
        # (`full`) takes at most 1024 keys.
        b, sq, nh, d = g["batch"], g["S"], g["heads"], g["d"]
        sk = g.get("Sk", sq)
        if sk == sq:
            qkv = rnd(b, sq, 3, nh, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        else:
            q, kv = rnd(b, sq, nh, d), rnd(b, sk, 2, nh, d)
            k, v = kv[:, :, 0], kv[:, :, 1]
        if kind == "flash":
            call = lambda: flash_attention(q, k, v, return_lse=True)
        else:
            call = lambda: full_attention(q, k, v)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        flops = 4 * b * nh * sq * sk * d
        nbytes = (2 * sq + 2 * sk) * b * nh * d * q.element_size()
        if kind == "flash":
            nbytes += 4 * b * nh * sq
        return call, flops, nbytes, library

    if kind.startswith("flash_bwd"):
        # K11 over K10's interface. With one length, q/k/v are the channel
        # blocks of a (B*S, 3c) QKV buffer and dq/dk/dv land in those of a
        # dqkv buffer, as the long block's backward passes them; with Sk
        # given, separate tensors of two lengths. o and lse come from K10.
        b, sq, nh, d = g["batch"], g["S"], g["heads"], g["d"]
        sk = g.get("Sk", sq)
        if sk == sq:
            qkv = rnd(b, sq, 3, nh, d)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            dqkv = torch.empty_like(qkv)
            outs = (dqkv[:, :, 0], dqkv[:, :, 1], dqkv[:, :, 2])
        else:
            q, k, v = rnd(b, sq, nh, d), rnd(b, sk, nh, d), rnd(b, sk, nh, d)
            outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        dout = rnd(b, sq, nh, d)
        o, lse = flash_attention(q, k, v, return_lse=True)
        delta = flash_attention_bwd_delta(o, dout)
        scale = 1.0 / math.sqrt(d)
        es, pairs = q.element_size(), b * nh * sq * sk
        nq, nk, rows = b * sq * nh * d, b * sk * nh * d, 4 * b * nh * sq
        if kind == "flash_bwd_delta":
            call = lambda: flash_attention_bwd_delta(o, dout)
            library = lambda: torch.einsum("bqhd,bqhd->bhq", dout, o)
            return call, 2 * nq, 2 * nq * es + rows, library
        if kind == "flash_bwd_dq":      # scores, dP, dQ
            call = lambda: flash_attention_bwd_dq(q, k, v, dout, lse, delta,
                                                  scale, out=outs[0])
            flops, nbytes = 6 * pairs * d, (3 * nq + 2 * nk) * es + 2 * rows
        elif kind == "flash_bwd_dkv":   # scores, dV, dP, dK
            call = lambda: flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                                   scale, out=outs[1:])
            flops, nbytes = 8 * pairs * d, (2 * nq + 4 * nk) * es + 2 * rows
        else:                           # the delta pass and both passes
            call = lambda: flash_attention_bwd(q, k, v, o, lse, dout, out=outs)
            flops, nbytes = 14 * pairs * d, (4 * nq + 4 * nk) * es + rows
        graph = []

        def library():
            # the backward of SDPA (dq, dk and dv together) at this shape
            if not graph:
                leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                          for t in (q, k, v)]
                graph.append((F.scaled_dot_product_attention(*leaves), leaves))
            out, leaves = graph[0]
            return torch.autograd.grad(out, leaves, dout.transpose(1, 2),
                                       retain_graph=True)
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

    def k6_held(shapes):
        """(select, shapes) of a K6 entry: the launches of exactly these
        shapes' variants, so that a shape the main path gives K6 and no
        entry holds against the plain version is found (`main`)."""
        held = {f"S={g['S']},n_pad={g.get('n_pad', 0)}" for g in shapes}
        return lambda w, v: w == "fused_window_block" and v in held, shapes

    def k7_held(shapes):
        held = {f"S={g['S']}" for g in shapes}
        return lambda w, v: w == "window_block_bwd" and v in held, shapes

    if PATHS[path].get("train"):
        fa = "sam2unet_tpu/ops/pallas/flash_attention.py"
        src_k11 = "sam2unet_torch/csrc/flash_attention_bwd.cu"
        if path == "l352train":
            grids, cs = (88, 44, 22, 11), (144, 288, 576, 1152)
            k5 = [dict(batch=b, grid=88, c=144, heads=2, window=8),
                  dict(batch=b, grid=44, c=288, heads=4, window=4)]
            # the 16-window groups of stages 3 and 4; the 484-token global
            # blocks are timed as an entry of their own
            k7 = [dict(windows=b, S=256, c=576, heads=8),
                  dict(windows=b, S=64, c=1152, heads=16)]
            k7_global = [dict(windows=b, S=484, c=576, heads=8)]
            tra_shapes = [dict(batch=b, grid=88, cin=144, c=288, heads=4, window=8),
                          dict(batch=b, grid=44, cin=288, c=576, heads=8, window=4)]
        else:
            grids, cs = (240, 120, 60, 30), (96, 192, 384, 768)
            k5 = [dict(batch=b, grid=240, c=96, heads=1, window=8),
                  dict(batch=b, grid=120, c=192, heads=2, window=4)]
            # the n_pad = 0 groups: 4x4 windows of 14x14 on 60x60, of 7x7 on
            # 30x30, head dim 96
            k7 = [dict(windows=16 * b, S=196, c=384, heads=4),
                  dict(windows=16 * b, S=49, c=768, heads=8)]
            k7_global = []   # the 3600-token global blocks take K11
            # the forward of the valid groups under train (K12 is eval only):
            # on 60x60 16 windows of 14x14, 4 + 4 of 14x4 / 4x14 and one of
            # 4x4 per image, on 30x30 the same of 7x7, 7x2 / 2x7 and 2x2
            k6_full = [dict(windows=16 * b, S=196, c=384, heads=4),
                       dict(windows=16 * b, S=49, c=768, heads=8)]
            k6_pad = [dict(windows=4 * b, S=56, c=384, heads=4, n_pad=140),
                      dict(windows=b, S=16, c=384, heads=4, n_pad=180),
                      dict(windows=4 * b, S=14, c=768, heads=8, n_pad=35),
                      dict(windows=b, S=4, c=768, heads=8, n_pad=45)]
            tra_shapes = [dict(batch=b, grid=120, cin=192, c=384, heads=4,
                               window=4)]
        tokens = [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)]
        specs = [
            ("K2 mlp_bwd_dx", "mlp_tail_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:432", src_mlp_bwd,
             lambda w, v: w == "mlp_bwd_dx", tokens, 2),
            ("K3 adapter_bwd", "mlp_adapter_bwd",
             "sam2unet_tpu/ops/pallas/fused_mlp.py:551", src_mlp_bwd,
             lambda w, v: w == "adapter_bwd", tokens, 2),
            ("K5 window_block_strips_bwd", "strips_bwd", f"{fab}:1082",
             src_ab_bwd,
             lambda w, v: w == "window_block_strips_bwd", k5, 0),
        ]
        specs.append(
            ("K7 window_block_bwd", "window_bwd", f"{fab}:669", src_ab_bwd,
             *k7_held(k7), 0))
        if k7_global:
            specs.append(
                ("K7 window_block_bwd (global S=484)", "window_bwd",
                 f"{fab}:669", src_ab_bwd, *k7_held(k7_global), 0))
        specs.append(
            ("K9 transition_bwd", "transition_bwd",
             "sam2unet_tpu/ops/pallas/fused_transition.py:483",
             "sam2unet_torch/csrc/fused_transition_bwd.cu",
             lambda w, v: w == "transition_bwd",
             tra_shapes + [dict(tra_shapes[-1], ties=True)], 0))
        if path == "s960train":
            specs += [
                ("K6 fused_window_block (n_pad=0)", "window", f"{fab}:354",
                 src_ab, *k6_held(k6_full), 0),
                ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354",
                 src_ab, *k6_held(k6_pad), 0)]
            # ragged lengths first, so that the fp32 comparison takes the
            # 3600-token shape
            k11 = [dict(batch=2, S=1000, Sk=1337, heads=4, d=96),
                   dict(batch=b, S=3600, heads=4, d=96)]
            specs += [
                ("K11 flash_attention_bwd (delta pass)", "flash_bwd_delta",
                 f"{fa}:306", src_k11,
                 lambda w, v: w == "flash_attention_bwd_delta", k11, 1),
                ("K11a flash_attention_bwd_dq", "flash_bwd_dq", f"{fa}:314",
                 src_k11, lambda w, v: w == "flash_attention_bwd_dq", k11, 1),
                ("K11b flash_attention_bwd_dkv", "flash_bwd_dkv", f"{fa}:336",
                 src_k11, lambda w, v: w == "flash_attention_bwd_dkv", k11, 1),
                # the three passes through `flash_attention_bwd`, which
                # launches nothing itself: one dq pass per call
                ("K11 flash_attention_bwd (delta, dq, dk/dv)", "flash_bwd",
                 f"{fa}:297", src_k11,
                 lambda w, v: w == "flash_attention_bwd_dq", k11, 1),
            ]
        return specs
    if path == "s1024sam2":
        # SAM2's trunk at 1024 (no adapters): grids 256/128/64/32; the mask
        # decoder's token->image attention with 16 tokens (9 points) on K10
        # at head dim 16; K14 at every shape its paths give it (the
        # "pallas" backend): this trunk's stage 3->4 transition, the
        # decoder's token self-attention and image->token attention with 8
        # tokens, SAM2-UNet's transitions at 960 (batch 16, timed) and 352
        # (batch 32)
        grids, cs = (256, 128, 64, 32), (96, 192, 384, 768)
        k14 = [dict(batch=25 * b, S=49, Sk=196, heads=8, d=96),
               dict(batch=b, S=8, Sk=8, heads=8, d=32),
               dict(batch=b, S=4096, Sk=8, heads=8, d=16),
               dict(batch=400, S=49, Sk=196, heads=8, d=96),
               dict(batch=128, S=64, Sk=256, heads=16, d=72)]
        k14_held = {f"Sq={g['S']},Sk={g['Sk']},d={g['d']}" for g in k14}
        return [
            ("K1 fused_mlp (tail)", "mlp_tail", *mlp,
             lambda w, v: w == "fused_mlp" and v == "ln",
             [dict(tokens=b * hh * hh, c=c) for hh, c in zip(grids, cs)], 2),
            ("K4 fused_window_block_strips", "strips", f"{fab}:1021", src_ab,
             lambda w, v: w == "fused_window_block_strips",
             [dict(batch=b, grid=256, c=96, heads=1, window=8),
              dict(batch=b, grid=128, c=192, heads=2, window=4)], 0),
            ("K8 fused_transition_block", "transition", *tra,
             lambda w, v: w == "fused_transition_block",
             [dict(batch=b, grid=256, cin=96, c=192, heads=2, window=8),
              dict(batch=b, grid=128, cin=192, c=384, heads=4, window=4)], 0),
            ("K10 flash_attention", "flash",
             "sam2unet_tpu/ops/pallas/flash_attention.py:190",
             "sam2unet_torch/csrc/flash_attention.cu",
             lambda w, v: w == "flash_attention",
             [dict(batch=b, S=4096, heads=4, d=96),
              dict(batch=b, S=16, Sk=4096, heads=8, d=16)], 0),
            ("K12 fused_window_block_strips_rem", "strips_rem", f"{fab}:1566",
             src_ab, lambda w, v: w == "fused_window_block_strips_rem",
             [dict(batch=b, grid=64, c=384, heads=4, window=14),
              dict(batch=b, grid=32, c=768, heads=8, window=7)], 0),
            ("K14 full_attention", "full",
             "sam2unet_tpu/ops/pallas/flash_attention.py:93",
             "sam2unet_torch/csrc/full_attention.cu",
             lambda w, v: w == "full_attention" and v in k14_held, k14, 3),
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
             *k6_held([dict(windows=b, S=256, c=576, heads=8),
                  dict(windows=b, S=64, c=1152, heads=16)]), 0),
            ("K6 fused_window_block (n_pad>0)", "window", f"{fab}:354", src_ab,
             *k6_held([dict(windows=b, S=96, c=576, heads=8, n_pad=160),
                  dict(windows=b, S=36, c=576, heads=8, n_pad=220),
                  dict(windows=b, S=24, c=1152, heads=16, n_pad=40),
                  dict(windows=b, S=9, c=1152, heads=16, n_pad=55)]), 0),
            ("K6 fused_window_block (global S=484)", "window", f"{fab}:354",
             src_ab, *k6_held([dict(windows=b, S=484, c=576, heads=8)]), 0),
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


def _agree(got, want) -> tuple[float, float, bool]:
    """(max |got - want| / max |want|, correlation, within MAIN_* limits)."""
    import torch

    got, want = got.flatten().double(), want.flatten().double()
    rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()
    corr = torch.corrcoef(torch.stack([got, want]))[0, 1].item()
    ok = math.isfinite(rel) and corr >= MAIN_CORR_MIN and rel <= MAIN_REL_TOL
    return rel, corr, ok


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
    rel, corr, ok = _agree(got, want)
    print(f"[main] {label} logits kernels vs plain (bf16, batch 4): "
          f"max_rel_err {rel:.4g} (tol {MAIN_REL_TOL}) corr {corr:.6f} (min "
          f"{MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        fail(f"{label} main path logits disagree with the plain versions")
    del model, got, want
    torch.cuda.empty_cache()
    return variants


def sam2_predictor():
    """The SAM2 image predictor through `build_sam2_image_predictor` at its
    defaults (sam2_hiera_s, 1024 px) on the card in bf16, seeded random
    weights (the zero-initialised pos-embeds get noise)."""
    import torch

    from sam2unet_torch.build_sam import build_sam2_image_predictor

    torch.manual_seed(0)
    pred = build_sam2_image_predictor(device=DEV, dtype=torch.bfloat16)
    trunk = pred.model.image_encoder.trunk
    with torch.no_grad():
        trunk.pos_embed.normal_(0.0, 0.02)
        trunk.pos_embed_window.normal_(0.0, 0.02)
    return pred


def sam2_image(seed: int = 0, hw: tuple[int, int] = (720, 960)):
    import numpy as np

    return (np.random.default_rng(seed).random((*hw, 3)) * 255).astype(
        np.uint8)


SAM2_PROMPTS = {
    "one point": dict(point_coords=[[480.0, 360.0]], point_labels=[1]),
    "a box": dict(box=[300.0, 200.0, 700.0, 560.0]),
    "points and a box": dict(point_coords=[[480.0, 360.0], [350.0, 250.0]],
                             point_labels=[1, 0],
                             box=[300.0, 200.0, 700.0, 560.0]),
    "9 points (16 tokens)": dict(
        point_coords=[[100.0 + 90 * i, 80.0 + 60 * i] for i in range(9)],
        point_labels=[1, 0, 1, 1, 0, 1, 0, 1, 1]),
}


def sam2_main_phase(path: str) -> dict:
    """The SAM2 image predictor end to end: set_image on a seeded 720x960
    image and predict with each prompt type, multimask on and off, a mask
    input, set_image_batch + predict_batch over 2 images; the outputs'
    shapes and ranges; launches per set_image and per predict (counters set
    to 0 just before each call, read just after); the embedding and the
    low-res logits against force_plain(); then the same under the "pallas"
    attention backend (K14), with the SAM2-UNet hiera_s@960 forward at
    batch 16 besides, each against the default backend."""
    import numpy as np
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.ops.attention import set_attention_impl

    spec = PATHS[path]
    label = spec["label"]
    pred = sam2_predictor()
    image = sam2_image()
    variants: collections.Counter = collections.Counter()

    def counted(fn, want: dict, what: str):
        dispatch.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        counts = dict(dispatch.launches)
        variants.update(dispatch.variants)
        print(f"[main] {label} {what}: launches {counts}", flush=True)
        if counts != want:
            fail(f"{label} {what}: launches {counts}, expected {want}")
        return out

    def check(masks, ious, low, n_out: int, hw, what: str):
        ok = (masks.shape == (n_out, *hw) and masks.dtype == np.bool_
              and ious.shape == (n_out,) and low.shape == (n_out, 256, 256)
              and np.isfinite(ious).all() and (ious >= 0).all()
              and (ious <= 1).all() and np.isfinite(low).all()
              and all(m.any() for m in masks))
        print(f"[main] {label} {what}: masks {masks.shape} {masks.dtype}, "
              f"foreground share {[round(float(m.mean()), 3) for m in masks]}, "
              f"ious {np.round(ious, 4).tolist()}, low-res {low.shape}"
              + ("" if ok else "  <-- FAIL"), flush=True)
        if not ok:
            fail(f"{label} {what}: bad outputs")

    hw = image.shape[:2]
    counted(lambda: pred.set_image(image), spec["per_set_image"],
            f"set_image {hw[0]}x{hw[1]}")
    first = None
    for name, prompt in SAM2_PROMPTS.items():
        for multimask in (True, False):
            want = spec["per_predict_16"] if "16 tokens" in name else {}
            masks, ious, low = counted(
                lambda: pred.predict(**{k: np.asarray(v) for k, v in
                                        prompt.items()},
                                     multimask_output=multimask),
                want, f"predict {name}, multimask {multimask}")
            check(masks, ious, low, 3 if multimask else 1, hw,
                  f"predict {name}, multimask {multimask}")
            if first is None:
                first = (masks, ious, low)
    pt = SAM2_PROMPTS["one point"]
    best = first[2][int(np.argmax(first[1]))][None]
    masks, ious, low = counted(
        lambda: pred.predict(np.asarray(pt["point_coords"]),
                             np.asarray(pt["point_labels"]), mask_input=best,
                             multimask_output=False),
        {}, "predict one point with a mask input")
    check(masks, ious, low, 1, hw, "predict one point with a mask input")

    images = [image, sam2_image(1, (600, 800))]
    counted(lambda: pred.set_image_batch(images), spec["per_set_image"],
            "set_image_batch of 2 images (one forward)")
    ms, ious_b, lows = counted(
        lambda: pred.predict_batch(
            [np.asarray(pt["point_coords"])] * 2,
            [np.asarray(pt["point_labels"])] * 2), {}, "predict_batch")
    for m, i, lo, im in zip(ms, ious_b, lows, images):
        check(m, i, lo, 3, im.shape[:2], "predict_batch")

    def run(plain: bool = False):
        with dispatch.force_plain() if plain else contextlib.nullcontext():
            pred.set_image(image)
            low = pred.predict(np.asarray(pt["point_coords"]),
                               np.asarray(pt["point_labels"]))[2]
            emb = pred.get_image_embedding().float().clone()
        return emb, torch.from_numpy(low)

    def compare_runs(got, want, what):
        for name, g, w in zip(("image embedding", "low-res logits"), got, want):
            rel, corr, ok = _agree(g, w)
            print(f"[main] {label} {name}, {what} (bf16): max_rel_err "
                  f"{rel:.4g} (tol {MAIN_REL_TOL}) corr {corr:.6f} (min "
                  f"{MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"), flush=True)
            if not ok:
                fail(f"{label}: {name} {what} disagree")

    auto = run()
    compare_runs(auto, run(plain=True), "kernels vs plain")

    # the "pallas" attention backend: K14 on every attention over at most
    # 1024 keys, as the JAX package's switch
    set_attention_impl("pallas")
    try:
        counted(lambda: pred.set_image(image),
                {**spec["per_set_image"], **spec["pallas_set_image"]},
                'set_image under set_attention_impl("pallas")')
        counted(lambda: pred.predict(np.asarray(pt["point_coords"]),
                                     np.asarray(pt["point_labels"])),
                spec["pallas_predict_8"],
                'predict one point (8 tokens) under "pallas"')
        compare_runs(run(), auto, '"pallas" backend vs the default')
        model, x = _model_and_input("s960", 16)
        dispatch.reset_launches()
        with torch.inference_mode():
            got = model(x)[0].float()
        torch.cuda.synchronize()
        counts = dict(dispatch.launches)
        # only K14's launches are this path's; the forward's others are the
        # s960 path's, held there
        variants.update({wv: n for wv, n in dispatch.variants.items()
                         if wv[0] == "full_attention"})
    finally:
        set_attention_impl(None)
    want = {**PATHS["s960"]["per_forward"], "full_attention": 1}
    print(f"[main] {label} SAM2-UNet hiera_s@960 forward, batch 16, under "
          f'"pallas": launches {counts}', flush=True)
    if counts != want:
        fail(f"{label}: SAM2-UNet@960 under pallas launched {counts}, "
             f"expected {want}")
    with torch.inference_mode():
        base = model(x)[0].float()
    rel, corr, ok = _agree(got, base)
    print(f"[main] {label} SAM2-UNet hiera_s@960 logits, \"pallas\" vs the "
          f"default backend (bf16, batch 16): max_rel_err {rel:.4g} corr "
          f"{corr:.6f}" + ("" if ok else "  <-- FAIL"), flush=True)
    if not ok:
        fail(f"{label}: SAM2-UNet@960 under pallas disagrees")
    del model, x, pred
    torch.cuda.empty_cache()
    return dict(variants)


def sam2_throughput_phase(path: str, card: str, n: int = 20) -> None:
    """As scripts/bench_sam2.py measures it: set_image (host clock: the
    numpy transform, the copy, the forward) and its device forward alone
    (CUDA events), then steady-state one-point predict ms (CUDA events
    around n calls after a warm-up; the device postprocess, and the host
    one), with peak memory."""
    import numpy as np
    import torch

    label = PATHS[path]["label"]
    pred = sam2_predictor()
    image = sam2_image()
    for _ in range(2):
        pred.set_image(image)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reps = 5
    for _ in range(reps):
        pred.set_image(image)
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3 / reps
    x = torch.from_numpy(pred._transforms(image)[None]).to(DEV)

    def forward():
        with torch.inference_mode():
            return pred.model.forward_image(x)["backbone_fpn"][-1]
    fwd_ms = time_ms(forward, reps=10)
    pred.set_image(image)
    pt = np.array([[480.0, 360.0]])

    def predict_ms():
        pred.predict(pt, np.array([1]))
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n):
            pred.predict(pt + i, np.array([1]))
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    dev_ms = predict_ms()
    pred._transforms.max_hole_area = -1.0   # the host postprocess
    host_ms = predict_ms()
    pred._transforms.max_hole_area = 0.0
    print(f"[throughput] {label} bf16 720x960 image on {card}: set_image "
          f"{set_ms:.2f} ms (host clock; forward_image alone {fwd_ms:.2f} ms, "
          f"CUDA events), predict one point {dev_ms:.2f} ms "
          f"({1e3 / dev_ms:.1f} prompts/s steady state; device "
          f"postprocess), {host_ms:.2f} ms with the host postprocess; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    del pred, x
    torch.cuda.empty_cache()


def train_main_phase(path: str, tmp: Path, step_seeds: list[int],
                     step_report: str = "") -> dict:
    """The train CLI end to end (with `resume`, once more from its saved
    train state), its checkpoint through the test CLI, and one train step's
    loss and gradients, kernels against plain versions."""
    import torch

    from sam2unet_torch.cli import test_cli, train_cli
    from sam2unet_torch.cli.common import build_model
    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.optim import is_trainable

    spec = PATHS[path]
    label, cfg, size = spec["label"], spec["cfg"], spec["size"]
    data, train_data = tmp / "data", tmp / "train"
    ckpt, out = tmp / f"{cfg}.pth", tmp / f"train_run_{path}"
    if not data.exists():
        write_dataset(data)
    if not train_data.exists():
        write_dataset(train_data, n=16, seed=1)
    if not ckpt.exists():
        random_checkpoint(ckpt, cfg, seed=0)
    common = ["--save_path", str(out), "--checkpoint", str(ckpt),
              "--train_image_path", str(train_data / "images"),
              "--train_mask_path", str(train_data / "masks"),
              "--test_image_path", str(data / "images"),
              "--test_gt_path", str(data / "masks"), "--bf16",
              "--num_workers", "4", "--device", DEV]
    defaults = train_cli.build_parser().parse_args(common)
    at_defaults = ((defaults.size, defaults.model_cfg, defaults.batch_size)
                   == (size, cfg, spec["cli_batch"]))
    point = [] if at_defaults else ["--size", str(size), "--model_cfg", cfg,
                                    "--batch_size", str(spec["cli_batch"])]
    extra = ["--save_train_state"] if spec.get("resume") else []
    shown = " ".join(point + extra) or "no other flag"
    args = train_cli.build_parser().parse_args(
        common + point + extra + ["--epoch", "2"])
    dispatch.reset_launches()
    t0 = time.perf_counter()
    stats = train_cli.main(args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    steps, evals = stats["steps"], stats["eval_forwards"]
    print(f"[main] {label} train_cli --bf16 --epoch 2 {shown} "
          f"({'the CLI defaults' if at_defaults else 'passed'}: --size "
          f"{args.size} --model_cfg {args.model_cfg} --batch_size "
          f"{args.batch_size}): {steps} steps, {evals} eval forwards in "
          f"{seconds:.1f} s (host clock, kernel build excluded); losses "
          f"{[round(v, 4) for v in stats['losses']]}; launches {counts}",
          flush=True)
    if not stats["losses"] or not all(math.isfinite(v) for v in stats["losses"]):
        fail(f"{label}: a logged loss is not finite: {stats['losses']}")
    per_forward = PATHS[spec["eval_path"]]["per_forward"]
    per_step = spec["per_step"]
    for name in sorted(set(per_step) | set(counts)):
        want = per_step.get(name, 0) * steps + per_forward.get(name, 0) * evals
        got = counts.get(name, 0)
        print(f"[main] {label} {name}: {got} launches = "
              f"{(got - per_forward.get(name, 0) * evals) / max(steps, 1):g} per "
              f"train step (table {per_step.get(name, 0)}) over {steps} steps "
              f"+ {per_forward.get(name, 0)} per eval forward", flush=True)
        if got != want:
            fail(f"{label}: {name} launched {got} times, expected {want}")
    if "flash_attention_bwd_dq" in per_step:
        print(f"[main] {label} flash_attention_bwd (K11, counted by its "
              f"delta, dq and dk/dv passes): "
              f"{counts['flash_attention_bwd_dq'] / max(steps, 1):g} per train "
              f"step", flush=True)

    log = Path(stats["log"]).read_text()
    if log.count("epoch-") < 2 or log.count("mIoU") != 2:
        fail(f"{label}: log.txt lacks the two epoch reports:\n{log}")
    if not stats["saved"]:
        fail(f"{label}: no checkpoint was written")
    start = torch.load(ckpt, map_location="cpu", weights_only=True)
    saved = torch.load(stats["saved"][-1], map_location="cpu", weights_only=True)
    names = [n for n, _ in build_model(cfg, torch.device("cpu")).named_parameters()]
    trainable = [n for n in names if is_trainable(n)]

    def check_moved(new, old, what):
        moved = [n for n in names if not torch.equal(new[n], old[n])]
        frozen_moved = sorted(set(moved) - set(trainable))
        still = sorted(set(trainable) - set(moved))
        print(f"[main] {label} {what}: {len(trainable)} trainable parameters, "
              f"{len(moved)} moved; frozen moved {len(frozen_moved)}", flush=True)
        if frozen_moved or still:
            fail(f"{label} {what}: frozen parameters moved {frozen_moved[:5]}, "
                 f"trainable ones did not {still[:5]}")

    check_moved(saved, start, f"checkpoint {Path(stats['saved'][-1]).name} "
                              "(log.txt holds the 2 epoch reports)")
    preds = tmp / f"train_preds_{path}"
    targs = test_cli.build_parser().parse_args([
        "--checkpoint", stats["saved"][-1], "--test_image_path",
        str(data / "images"), "--test_gt_path", str(data / "masks"),
        "--save_path", str(preds), "--bf16", "--batch_size", "4",
        "--device", DEV] + point[:4])
    tstats = test_cli.main(targs)
    if len(list(preds.glob("*.png"))) != 4:
        fail(f"{label}: the test CLI did not write 4 PNGs from the checkpoint")
    print(f"[main] {label} test_cli loaded the checkpoint strictly: "
          f"{tstats['forwards']} forward(s), mean_test_time "
          f"{tstats['mean_test_time']:.4f} s/image", flush=True)

    losses = list(stats["losses"])
    if spec.get("resume"):
        state = stats["saved"][-1] + "_train_state"
        if not Path(state).is_file():
            fail(f"{label}: --save_train_state wrote no {state}")
        again = train_cli.main(train_cli.build_parser().parse_args(
            common + point + ["--epoch", "3", "--resume", state]))
        torch.cuda.synchronize()
        print(f"[main] {label} train_cli --resume {Path(state).name} --epoch 3: "
              f"resumed at epoch {again['start_epoch']}, {again['steps']} "
              f"step(s), global step {again['global_step']}, losses "
              f"{[round(v, 4) for v in again['losses']]}", flush=True)
        if ((again["start_epoch"], again["steps"], again["global_step"])
                != (2, steps // 2, steps + steps // 2) or not again["saved"]
                or not all(math.isfinite(v) for v in again["losses"])):
            fail(f"{label}: the resumed run did not continue from epoch 2: "
                 f"{again}")
        check_moved(torch.load(again["saved"][-1], map_location="cpu",
                               weights_only=True), saved,
                    "resumed run's checkpoint against the 2-epoch one")
        losses += again["losses"]
        if min(losses[1:]) >= losses[0]:
            fail(f"{label}: the loss did not fall: {losses}")
        print(f"[main] {label} loss fell from {losses[0]:.4f} to "
              f"{min(losses[1:]):.4f} over {len(losses)} steps", flush=True)
    del start, saved
    step_compare(path, ckpt, step_seeds, step_report)
    if spec.get("remat"):
        remat_compare(path, ckpt)
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
    the plain versions, same parameters and batch (the path's `step_batch`,
    one batch per seed), in fp32 and in bf16. fp32 holds every leaf to MAIN_CORR_MIN and
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
    label, batch = spec["label"], spec["step_batch"]
    runs = {}
    for bf16 in (True, False):
        model = _train_model(spec["cfg"], ckpt, bf16)
        model.train()
        for seed in seeds:
            x, y = _train_batch(batch, spec["size"], seed=seed)
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
                    f"({'bf16' if bf16 else 'fp32'}, batch {batch}): loss {lk:.6f} vs "
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


def remat_compare(path: str, ckpt: Path) -> None:
    """Each trunk block under `torch.utils.checkpoint` (the train CLI's
    --remat) against the same bf16 model without it: the same kernels on the
    same inputs, so one train step's loss and every trainable gradient are
    held to 1e-6 of the leaf's max (in practice bitwise). PyTorch's
    convolution, BatchNorm and interpolation backwards in the neck and
    decoder use atomics, so two identical steps already differ there: the
    comparison runs under `torch.use_deterministic_algorithms`, where a
    repeat of the step without remat must come out equal too, and the gaps
    without that mode are printed beside it. Also checks the launches of the
    step with remat, which runs every trunk block's forward twice."""
    import torch

    from sam2unet_torch.ops import dispatch
    from sam2unet_torch.train.loss import multi_head_loss
    from sam2unet_torch.train.optim import trainable_parameters

    spec = PATHS[path]
    label, batch = spec["label"], spec["step_batch"]
    model = _train_model(spec["cfg"], ckpt, bf16=True)
    model.train()
    x, y = _train_batch(batch, spec["size"], seed=2)

    def step(remat: bool):
        model.encoder.remat = remat
        model.zero_grad(set_to_none=True)
        dispatch.reset_launches()
        loss = multi_head_loss(model(x), y)
        loss.backward()
        torch.cuda.synchronize()
        grads = {n: p.grad.float().clone()
                 for n, p in trainable_parameters(model) if p.grad is not None}
        return loss.item(), grads, dict(dispatch.launches)

    def worst(got, want):
        if got.keys() != want.keys() or not want:
            fail(f"{label}: remat gives gradients to other parameters")
        return max(((got[n] - want[n]).abs().max().item()
                    / max(want[n].abs().max().item(), 1e-30), n) for n in want)

    def three():
        (l0, g0, c0), (l0b, g0b, _), (l1, g1, c1) = (step(False), step(False),
                                                     step(True))
        return (l0, l0b, l1), worst(g0b, g0), worst(g1, g0), len(g0), c0, c1

    _, loose_noise, loose_diff, _, _, _ = three()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        (l0, l0b, l1), noise, diff, leaves, c0, c1 = three()
    finally:
        torch.use_deterministic_algorithms(False)
    ok = (l0 == l0b and abs(l1 - l0) <= 1e-6 * abs(l0) and noise[0] <= 1e-6
          and diff[0] <= 1e-6)
    print(f"[main] {label} with remat vs without (bf16, batch {batch}, "
          f"deterministic algorithms): one step's loss {l1:.6f} vs {l0:.6f}; "
          f"all {leaves} trainable gradients: worst max_rel_err {diff[0]:.3g} "
          f"({diff[1]}), between two steps without remat {noise[0]:.3g} (tol "
          f"1e-6 each); without deterministic algorithms {loose_diff[0]:.3g} "
          f"({loose_diff[1]}) against {loose_noise[0]:.3g} ({loose_noise[1]}) "
          f"between two steps without remat; launches with remat {c1}"
          + ("" if ok else "  <-- FAIL"), flush=True)
    want0 = spec["per_step"]
    want1 = {**want0, **spec["per_step_remat"]}
    if c0 != want0 or c1 != want1:
        fail(f"{label}: launches of one step {c0} (expected {want0}), with "
             f"remat {c1} (expected {want1})")
    if not ok:
        fail(f"{label}: remat changes one train step's loss or gradients")
    del model
    torch.cuda.empty_cache()


def _model_and_input(path: str, batch: int):
    import torch

    from sam2unet_torch.cli.common import build_model

    size = PATHS[path]["size"]
    torch.manual_seed(1)
    model = build_model(PATHS[path]["cfg"], torch.device(DEV), torch.bfloat16)
    x = torch.randn(batch, size, size, 3, device=DEV, dtype=torch.bfloat16)
    return model, x


def _runner(path: str, batch: int, remat: bool = False,
            predict: bool = False):
    """(one step of the path: a forward, a train step, or for the SAM2
    predictor a set_image or, with `predict`, a one-point predict on the
    set image; its output); `remat` puts each trunk block of a training path
    under checkpointing."""
    import numpy as np
    import torch

    spec = PATHS[path]
    if spec.get("sam2"):
        pred, image = sam2_predictor(), sam2_image()
        pred.set_image(image)
        if predict:
            pt, lab = np.array([[480.0, 360.0]]), np.array([1])
            return (lambda: torch.from_numpy(pred.predict(pt, lab)[2])), "predict"

        def set_image():
            pred.set_image(image)
            return pred.get_image_embedding()
        return set_image, "set_image"
    if not spec.get("train"):
        model, x = _model_and_input(path, batch)

        def forward():
            with torch.inference_mode():
                return model(x)[0]
        return forward, "forward"
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.optim import make_optimizer

    model = _train_model(spec["cfg"])
    model.encoder.remat = remat
    optimizer = make_optimizer(model)
    x, y = _train_batch(batch, spec["size"], seed=3)
    return (lambda: train_step(model, optimizer, x, y)), "train step"


def throughput_phase(path: str, batch: int, card: str,
                     remat: bool = False) -> float:
    """img/s of the path's step at `batch`; a batch that does not fit the
    card's memory is reported with its size and halved."""
    import torch

    label = PATHS[path]["label"] + (" with remat" if remat else "")
    reps = 5
    while True:
        run, what = _runner(path, batch, remat)
        torch.cuda.reset_peak_memory_stats()
        try:
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
            break
        except torch.cuda.OutOfMemoryError:
            peak = torch.cuda.max_memory_allocated() / 2**30
            total = torch.cuda.get_device_properties(0).total_memory / 2**30
            print(f"[throughput] {label} bf16 batch {batch} does NOT fit the "
                  f"card's memory ({peak:.2f} GiB allocated of {total:.2f} "
                  f"GiB when it ran out): running batch {batch // 2}",
                  flush=True)
            del run
            torch.cuda.empty_cache()
            batch //= 2
            if batch < 1:
                fail(f"{label}: no batch fits the card's memory")
    if not torch.isfinite(out).all():
        fail(f"{label} throughput {what} produced non-finite values")
    ms = start.elapsed_time(end) / reps
    ips = batch / (ms / 1e3)
    print(f"[throughput] {label} bf16 batch {batch}: {ms:.2f} "
          f"ms/{what}, {ips:.1f} img/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del run, out
    torch.cuda.empty_cache()
    return ips


def profile_phase(path: str, batch: int, card: str,
                  predict: bool = False) -> None:
    """Optional: device time by kernel over one forward, train step,
    set_image or predict (torch.profiler), and the device's idle share of
    its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run, what = _runner(path, batch, predict=predict)
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
    ap.add_argument("--paths",
                    default="l352,s960,l352train,s960train,s1024sam2")
    ap.add_argument("--batch", type=int, default=32,
                    help="kernel, throughput and profile batch at hiera_l@352")
    ap.add_argument("--batch960", type=int, default=16,
                    help="the same at hiera_s@960")
    ap.add_argument("--batch_train", type=int, default=16,
                    help="the same for the hiera_l@352 training path")
    ap.add_argument("--batch_train960", type=int, default=16,
                    help="the same for the hiera_s@960 training path (the "
                         "train CLI's default batch)")
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
          f"{out_dir.relative_to(REPO)}; nvcc seconds by source "
          f"{ {k: round(v, 1) for k, v in build.build_seconds.items()} }",
          flush=True)
    for line in build.ptxas_summary(out_dir):
        print(f"[ptxas] {line}", flush=True)

    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    entries, variants = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        for path in paths:
            batch = PATHS[path].get("batch") or getattr(args, BATCH_FLAG[path])
            if "kernels" in phases:
                entries += kernel_phase(path, batch, gen)
            if "main" in phases:
                if PATHS[path].get("sam2"):
                    variants[path] = sam2_main_phase(path)
                elif PATHS[path].get("train"):
                    variants[path] = train_main_phase(
                        path, Path(tmp), [int(s) for s in args.step_seeds.split(",")],
                        args.step_report)
                else:
                    variants[path] = main_path_phase(path, Path(tmp))
            if "throughput" in phases and PATHS[path].get("sam2"):
                sam2_throughput_phase(path, card)
            elif "throughput" in phases:
                throughput_phase(path, batch, card)
                if PATHS[path].get("remat"):
                    throughput_phase(path, batch, card, remat=True)
            if "profile" in phases:
                profile_phase(path, batch, card)
                if PATHS[path].get("sam2"):
                    profile_phase(path, batch, card, predict=True)

    # a wrapper that a path's entries hold against the plain version is held
    # at every shape (variant) that path's run gave it
    for path, seen in variants.items():
        selects = [e["select"] for e in entries if e["path"] == path]
        held = {w for w, v in seen if any(sel(w, v) for sel in selects)}
        loose = sorted(f"{w}[{v}]" for w, v in seen
                       if w in held and not any(sel(w, v) for sel in selects))
        if loose:
            fail(f"{PATHS[path]['label']}: launched on the main path at shapes "
                 f"no kernel check holds against the plain version: {loose}")
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
