#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sam2unet_torch): hiera_l @ 352
and hiera_s @ 960 (the test CLI's defaults).

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases build,kernels --batch 2 --batch960 2
    python3 chip_smoke.py --phases build,profile   # device time by kernel
    python3 chip_smoke.py --paths s960             # one operating point

Phases, one line each, for each path of --paths (l352, then s960):
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
Then a JSON line of per-kernel numbers, the card line, and last the result
line. Any failed phase exits non-zero before the result line. Without a
CUDA device, or without the sam2unet_torch package beside this script, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import collections
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
# the test CLI's logits, kernels vs plain versions, same bf16 weights
MAIN_CORR_MIN = 0.99
MAIN_REL_TOL = 0.1
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
    )
    from sam2unet_torch.ops.fused_mlp import fused_mlp
    from sam2unet_torch.ops.fused_transition import fused_transition_block

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
    raise ValueError(kind)


def kernel_specs(path: str, b: int) -> list[tuple]:
    """(name, kind, replaces, source, counted launches (wrapper, variant),
    main-path shapes, index of the timed shape) of each kernel of a path."""
    fab = "sam2unet_tpu/ops/pallas/fused_attention_block.py"
    src_ab = "sam2unet_torch/csrc/fused_attention_block.cu"
    mlp = ("sam2unet_tpu/ops/pallas/fused_mlp.py:135",
           "sam2unet_torch/csrc/fused_mlp.cu")
    tra = ("sam2unet_tpu/ops/pallas/fused_transition.py:256",
           "sam2unet_torch/csrc/fused_transition.cu")

    def npad(v: str) -> int:
        return int(v.split("n_pad=")[1])

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


def compare(call) -> tuple[float, float]:
    """Max |kernel - plain| over the call's outputs, and that over
    max |plain| (the worst of the outputs)."""
    import torch

    from sam2unet_torch.ops import dispatch

    def outs(r):
        return [t.float() for t in (r if isinstance(r, tuple) else (r,))]

    got = outs(call())
    with dispatch.force_plain():
        want = outs(call())
    torch.cuda.synchronize()
    worst_abs = worst_rel = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        rel = err / max(w.abs().max().item(), 1e-30)
        if not math.isfinite(err):
            rel = math.inf
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    return worst_abs, worst_rel


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
            err, rel = compare(call)
            ok = rel <= BF16_REL_TOL
            line = (f"[kernel] {name} {label} bf16 {g}: max_abs_err {err:.4g} "
                    f"max_rel_err {rel:.4g} (tol {BF16_REL_TOL})")
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
        # fp32 once, at the smallest main-path shape of the kernel
        g = dict(shapes[-1])
        for key in ("batch", "windows"):
            if key in g:
                g[key] = min(g[key], 2)
        if "tokens" in g:
            g["tokens"] = min(g["tokens"], 2 * 484)
        err, rel = compare(make_case(kind, torch.float32, gen, **g)[0])
        ok = rel <= FP32_REL_TOL
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


def write_dataset(root: Path) -> None:
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    (root / "images").mkdir(parents=True)
    (root / "masks").mkdir(parents=True)
    for i in range(4):
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


def _model_and_input(path: str, batch: int):
    import torch

    from sam2unet_torch.cli.common import build_model

    size = PATHS[path]["size"]
    torch.manual_seed(1)
    model = build_model(PATHS[path]["cfg"], torch.device(DEV), torch.bfloat16)
    x = torch.randn(batch, size, size, 3, device=DEV, dtype=torch.bfloat16)
    return model, x


def throughput_phase(path: str, batch: int, card: str) -> float:
    import torch

    model, x = _model_and_input(path, batch)
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = model(x)[0]
        end.record()
        end.synchronize()
    if not torch.isfinite(out).all():
        fail(f"{PATHS[path]['label']} throughput forward produced non-finite "
             "logits")
    ms = start.elapsed_time(end) / reps
    ips = batch / (ms / 1e3)
    print(f"[throughput] {PATHS[path]['label']} bf16 batch {batch}: {ms:.2f} "
          f"ms/forward, {ips:.1f} img/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del model, x, out
    torch.cuda.empty_cache()
    return ips


def profile_phase(path: str, batch: int, card: str) -> None:
    """Optional: device time by kernel over one forward (torch.profiler),
    and the device's idle share of that forward's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, x = _model_and_input(path, batch)
    with torch.inference_mode():
        for _ in range(2):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
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
    print(f"[profile] {PATHS[path]['label']} bf16 batch {batch} on {card}: "
          f"host wall {wall_ms:.2f} ms (profiler on), device span "
          f"{span_ms:.2f} ms, kernels busy {busy_ms:.2f} ms, idle share of "
          f"the span {1 - busy_ms / span_ms:.3f}", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"{n:5d} calls  {name[:100]}", flush=True)
    del model, x
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,main,throughput")
    ap.add_argument("--paths", default="l352,s960")
    ap.add_argument("--batch", type=int, default=32,
                    help="kernel, throughput and profile batch at hiera_l@352")
    ap.add_argument("--batch960", type=int, default=16,
                    help="the same at hiera_s@960")
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
            batch = args.batch if path == "l352" else args.batch960
            if "kernels" in phases:
                entries += kernel_phase(path, batch, gen)
            if "main" in phases:
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
