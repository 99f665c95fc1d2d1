#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (sam2unet_torch), hiera_l @ 352.

    python3 chip_smoke.py            # every phase, as the acceptance run does
    python3 chip_smoke.py --phases build,kernels --batch 2   # quick check
    python3 chip_smoke.py --phases build,profile   # device time by kernel

Phases, one line each:
  1. the card (nvidia-smi name and power limit); build the CUDA kernels
     from csrc/ with nvcc and print the build time.
  2. every kernel (K1 tail, K1 adapter, K4, K6 n_pad=0, K6 n_pad>0,
     K6 global S=484, K8) against its plain PyTorch version on the card at
     the hiera_l@352 shapes of the main path: bf16 at every shape (timed
     at one representative shape each), and fp32 once. TF32 is off.
  3. the main path: the test CLI (sam2unet_torch.cli.test_cli.main) on a
     synthetic 4-image dataset with a seeded random SAM2UNet(hiera_l)
     checkpoint, --size 352 --bf16 --batch_size 4; PNG checks; launch
     counts per forward; the same batch under force_plain() on the card.
  4. forward throughput at batch 32, bf16 (CUDA events, after warm-up).
Then a JSON line of per-kernel numbers, and last the result line. Any
failed phase exits non-zero before the result line. Without a CUDA
device, or without the sam2unet_torch package beside this script, it
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
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
BF16_REL_TOL = 2e-2         # max|kernel - plain| / max|plain| in bf16
FP32_REL_TOL = 1e-4         # the same in fp32 (TF32 off)
# the test CLI's logits, kernels vs plain versions, same bf16 weights
MAIN_CORR_MIN = 0.99
MAIN_REL_TOL = 0.1
# per-forward launches of each wrapper at hiera_l@352
PER_FORWARD = {"fused_mlp": 96, "fused_window_block_strips": 7,
               "fused_window_block": 143, "fused_transition_block": 2}


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
    """(kernel call, input description) for one kernel at one shape.
    Weights ~ lecun-normal, biases and LN params small noise around the
    identity, activations ~ N(0, 1)."""
    import torch

    from sam2unet_torch.ops.fused_attention_block import (
        fused_window_block,
        fused_window_block_strips,
    )
    from sam2unet_torch.ops.fused_mlp import fused_mlp
    from sam2unet_torch.ops.fused_transition import fused_transition_block

    dev = "cuda"

    def rnd(*shape, scale=1.0, shift=0.0):
        t = torch.randn(*shape, generator=gen, device=dev) * scale + shift
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
        return call, flops, nbytes * x.element_size()

    if kind in ("strips", "window", "transition"):
        c, nh = g["c"], g["heads"]
        cin = g.get("cin", c)
        cout = c
        lw, lb = rnd(cin, scale=0.1, shift=1.0), rnd(cin, scale=0.1)
        wq, bq = lin(3 * cout, cin)
        wp, bp = lin(cout, cout)
        if kind == "strips":
            b, hh, win = g["batch"], g["grid"], g["window"]
            x = rnd(b, hh, hh, c)
            call = lambda: fused_window_block_strips(x, wq, bq, lw, lb, wp, bp,
                                                     num_heads=nh, window=win)
            m, keys, mq = b * hh * hh, win * win, b * hh * hh
        elif kind == "window":
            nw, s, n_pad = g["windows"], g["S"], g.get("n_pad", 0)
            x = rnd(nw, s, c)
            call = lambda: fused_window_block(x, wq, bq, lw, lb, wp, bp,
                                              num_heads=nh, n_pad=n_pad)
            m, keys, mq = nw * s, s, nw * s
        else:
            b, hh, win = g["batch"], g["grid"], g["window"]
            x = rnd(b, hh, hh, cin)
            ws, bs = lin(cout, cin)
            call = lambda: fused_transition_block(x, wq, bq, lw, lb, wp, bp,
                                                  ws, bs, num_heads=nh,
                                                  window=win)
            m, keys, mq = b * hh * hh, win * win, b * hh * hh // 4
        # QKV (+ shortcut) products at full resolution, attention and proj
        # per query
        flops = (2 * m * cin * 3 * cout + 4 * mq * keys * cout
                 + 2 * mq * cout * cout)
        nel = m * cin + mq * cout + 3 * cout * cin + cout * cout + 4 * cout + 2 * cin
        if kind == "transition":
            flops += 2 * m * cin * cout
            nel += cout * cin + cout
        return call, flops, nel * x.element_size()
    raise ValueError(kind)


def kernel_phase(batch: int, gen) -> list[dict]:
    """Phase 2. Returns the JSON entries (without launches)."""
    import torch

    from sam2unet_torch.ops import dispatch

    b = batch
    fab = "sam2unet_tpu/ops/pallas/fused_attention_block.py"
    src_ab = "sam2unet_torch/csrc/fused_attention_block.cu"

    def npad(v: str) -> int:
        return int(v.split("n_pad=")[1])

    # (name, kind, replaces, source, counted launches (wrapper, variant),
    #  main-path shapes, index of the timed shape)
    specs = [
        ("K1 fused_mlp (tail)", "mlp_tail",
         "sam2unet_tpu/ops/pallas/fused_mlp.py:135",
         "sam2unet_torch/csrc/fused_mlp.cu",
         lambda w, v: w == "fused_mlp" and v == "ln",
         [dict(tokens=b * 88 * 88, c=144), dict(tokens=b * 44 * 44, c=288),
          dict(tokens=b * 22 * 22, c=576), dict(tokens=b * 11 * 11, c=1152)], 2),
        ("K1 fused_mlp (adapter)", "mlp_adapter",
         "sam2unet_tpu/ops/pallas/fused_mlp.py:135",
         "sam2unet_torch/csrc/fused_mlp.cu",
         lambda w, v: w == "fused_mlp" and v == "no_ln",
         [dict(tokens=b * 88 * 88, c=144), dict(tokens=b * 44 * 44, c=288),
          dict(tokens=b * 22 * 22, c=576), dict(tokens=b * 11 * 11, c=1152)], 2),
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
        ("K6 fused_window_block (global S=484)", "window", f"{fab}:354", src_ab,
         lambda w, v: w == "fused_window_block" and v.startswith("S=484,"),
         [dict(windows=b, S=484, c=576, heads=8)], 0),
        ("K8 fused_transition_block", "transition",
         "sam2unet_tpu/ops/pallas/fused_transition.py:256",
         "sam2unet_torch/csrc/fused_transition.cu",
         lambda w, v: w == "fused_transition_block",
         [dict(batch=b, grid=88, cin=144, c=288, heads=4, window=8),
          dict(batch=b, grid=44, cin=288, c=576, heads=8, window=4)], 0),
    ]
    entries = []
    for name, kind, replaces, source, select, shapes, timed in specs:
        worst_abs = worst_rel = 0.0
        for i, g in enumerate(shapes):
            call, flops, nbytes = make_case(kind, torch.bfloat16, gen, **g)
            got = call().float()
            with dispatch.force_plain():
                want = call().float()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            rel = err / max(want.abs().max().item(), 1e-30)
            ok = math.isfinite(err) and rel <= BF16_REL_TOL
            line = (f"[kernel] {name} bf16 {g}: max_abs_err {err:.4g} "
                    f"max_rel_err {rel:.4g} (tol {BF16_REL_TOL})")
            if i == timed:
                ms = time_ms(call)
                with dispatch.force_plain():
                    plain_ms = time_ms(call)
                bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
                line += (f" | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                         f"bound {bound_ms:.4f} ms "
                         f"({'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'})")
                entry = dict(name=name, route="cuda", source=source,
                             select=select,
                             replaces=replaces, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms,
                             bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                             > flops / BF16_FLOPS else "operations",
                             library_ms=None)
            print(line + ("" if ok else "  <-- FAIL"), flush=True)
            worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
            if not ok:
                fail(f"{name} disagrees with its plain version at {g}")
            del got, want
        # fp32 once, at the smallest main-path shape of the kernel
        g = dict(shapes[-1])
        for key in ("batch", "windows"):
            if key in g:
                g[key] = min(g[key], 2)
        if "tokens" in g:
            g["tokens"] = min(g["tokens"], 2 * 484)
        call, _, _ = make_case(kind, torch.float32, gen, **g)
        got = call()
        with dispatch.force_plain():
            want = call()
        err = (got - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        ok = math.isfinite(err) and rel <= FP32_REL_TOL
        print(f"[kernel] {name} fp32 {g}: max_abs_err {err:.4g} max_rel_err "
              f"{rel:.4g} (tol {FP32_REL_TOL})" + ("" if ok else "  <-- FAIL"),
              flush=True)
        if not ok:
            fail(f"{name} fp32 disagrees with its plain version at {g}")
        entry["max_abs_err"] = worst_abs
        entries.append(entry)
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


def random_checkpoint(path: Path, seed: int) -> None:
    """Seeded random SAM2UNet(hiera_l) state dict; the zero-initialised
    pos-embeds get noise so they take part."""
    import torch

    from sam2unet_torch.cli.common import build_model

    torch.manual_seed(seed)
    model = build_model("sam2_hiera_l", torch.device("cpu"))
    with torch.no_grad():
        model.encoder.pos_embed.normal_(0.0, 0.02)
        model.encoder.pos_embed_window.normal_(0.0, 0.02)
    torch.save(model.state_dict(), path)


def main_path_phase(tmp: Path) -> dict:
    import numpy as np
    import torch
    from PIL import Image

    from sam2unet_torch.cli import test_cli
    from sam2unet_torch.cli.common import build_model, load_checkpoint
    from sam2unet_torch.data.dataset import EvalDataset
    from sam2unet_torch.ops import dispatch

    data, ckpt, preds = tmp / "data", tmp / "model.pth", tmp / "preds"
    write_dataset(data)
    random_checkpoint(ckpt, seed=0)
    args = test_cli.build_parser().parse_args([
        "--checkpoint", str(ckpt), "--test_image_path", str(data / "images"),
        "--test_gt_path", str(data / "masks"), "--save_path", str(preds),
        "--size", "352", "--model_cfg", "sam2_hiera_l", "--bf16",
        "--batch_size", "4", "--device", "cuda"])
    dispatch.reset_launches()
    stats = test_cli.main(args)
    torch.cuda.synchronize()
    counts, variants = dict(dispatch.launches), dict(dispatch.variants)
    print(f"[main] test_cli: {stats['forwards']} forward(s) over "
          f"{stats['images']} images, mean_test_time "
          f"{stats['mean_test_time']:.4f} s/image; launches {counts}; by "
          f"variant { {f'{w}[{v}]': n for (w, v), n in variants.items()} }",
          flush=True)
    for name, per in PER_FORWARD.items():
        want = per * stats["forwards"]
        if counts.get(name, 0) != want:
            fail(f"{name} launched {counts.get(name, 0)} times, expected {want}")
    for i in range(4):
        png = np.asarray(Image.open(preds / f"s{i}.png"))
        gt = np.asarray(Image.open(data / "masks" / f"s{i}.png"))
        if png.shape != gt.shape or png.dtype != np.uint8 or png.min() == png.max():
            fail(f"s{i}.png: shape {png.shape} vs GT {gt.shape}, range "
                  f"{png.min()}..{png.max()}")
    print("[main] 4 PNGs: GT shapes, uint8, more than one value", flush=True)

    # the same batch through the plain versions on the card
    model = build_model("sam2_hiera_l", torch.device("cpu"))
    load_checkpoint(model, str(ckpt))
    model = model.to(device="cuda", dtype=torch.bfloat16)
    batch = next(EvalDataset(str(data / "images"), str(data / "masks"),
                             352).batches(4))
    x = torch.from_numpy(batch["image"]).cuda()
    with torch.inference_mode():
        got = model(x)[0].float()
        with dispatch.force_plain():
            want = model(x)[0].float()
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    corr = torch.corrcoef(torch.stack([got.flatten(), want.flatten()]))[0, 1].item()
    ok = math.isfinite(err) and corr >= MAIN_CORR_MIN and rel <= MAIN_REL_TOL
    print(f"[main] logits kernels vs plain (bf16, batch 4): max_abs_err "
          f"{err:.4g} max_rel_err {rel:.4g} (tol {MAIN_REL_TOL}) corr "
          f"{corr:.6f} (min {MAIN_CORR_MIN})" + ("" if ok else "  <-- FAIL"),
          flush=True)
    if not ok:
        fail("main path logits disagree with the plain versions")
    return variants


def throughput_phase(batch: int, card: str) -> float:
    import torch

    from sam2unet_torch.cli.common import build_model

    torch.manual_seed(1)
    model = build_model("sam2_hiera_l", torch.device("cuda"), torch.bfloat16)
    x = torch.randn(batch, 352, 352, 3, device="cuda", dtype=torch.bfloat16)
    reps = 5
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
        fail("throughput forward produced non-finite logits")
    ms = start.elapsed_time(end) / reps
    ips = batch / (ms / 1e3)
    print(f"[throughput] hiera_l@352 bf16 batch {batch}: {ms:.2f} ms/forward, "
          f"{ips:.1f} img/s on {card}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return ips


def profile_phase(batch: int, card: str) -> None:
    """Optional: device time by kernel over one forward (torch.profiler),
    and the device's idle share of that forward's wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sam2unet_torch.cli.common import build_model

    torch.manual_seed(1)
    model = build_model("sam2_hiera_l", torch.device("cuda"), torch.bfloat16)
    x = torch.randn(batch, 352, 352, 3, device="cuda", dtype=torch.bfloat16)
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
    print(f"[profile] hiera_l@352 bf16 batch {batch} on {card}: host wall "
          f"{wall_ms:.2f} ms (profiler on), device span {span_ms:.2f} ms, "
          f"kernels busy {busy_ms:.2f} ms, idle share of the span "
          f"{1 - busy_ms / span_ms:.3f}", flush=True)
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:20]:
        print(f"[profile] {us / 1e3:9.3f} ms {100 * us / 1e3 / busy_ms:5.1f}% "
              f"{n:5d} calls  {name[:100]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="build,kernels,main,throughput")
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    phases = set(args.phases.split(","))

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

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entries = kernel_phase(args.batch, gen) if "kernels" in phases else []
    variants = {}
    if "main" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            variants = main_path_phase(Path(tmp))
    if "throughput" in phases:
        throughput_phase(args.batch, card)
    if "profile" in phases:
        profile_phase(args.batch, card)

    for e in entries:
        select = e.pop("select")
        e["launches"] = sum(n for (w, v), n in variants.items() if select(w, v))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
