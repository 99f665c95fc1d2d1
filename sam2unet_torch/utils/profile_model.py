"""Profile the SAM2-UNet forward or train step and print the top kernels by
device time per step: the port's counterpart of the JAX package's
scripts/profile_model.py (top HLO ops by device time), over torch.profiler.

    python -m sam2unet_torch.utils.profile_model [--mode infer|train] \
        [--batch 32] [--size 352] [--model_cfg sam2_hiera_l] [--top 25] \
        [--steps 3] [--device cuda]

The model has seeded random weights and runs in bf16 (a train step: the
frozen trunk in bf16 over fp32 trainable parameters, as the train CLI's
--bf16) on zero inputs, as the JAX script's.
One step runs as a warm-up, then --steps steps under the profiler. On the
card the table is the device kernels by time (a hand-written kernel's
device kernels counted under its C entry point's profiler annotation,
`ops/build.py`, so a shared GEMM kernel is named by its caller), with each
entry point's calls per step; on the CPU, where no kernel launches, it is
the operators by their own CPU time.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from sam2unet_torch.cli.common import build_model, resolve_device
from sam2unet_torch.models.sam2unet import cast_frozen
from sam2unet_torch.train.engine import train_step
from sam2unet_torch.train.optim import make_optimizer

# the dispatch wrapper (`ops/*.py`, its `dispatch.launches` name) of each C
# entry point: a wrapper call is one entry-point call
ENTRY_WRAPPER = {
    "k1_fused_mlp": "fused_mlp", "k2_mlp_bwd_dx": "mlp_bwd_dx",
    "k3_adapter_bwd": "adapter_bwd",
    "k4_window_block_strips": "fused_window_block_strips",
    "k5_window_block_strips_bwd": "window_block_strips_bwd",
    "k6_window_block": "fused_window_block",
    "k6_window_block_masked": "fused_window_block",
    "k7_window_block_bwd": "window_block_bwd",
    "k7_window_block_bwd_masked": "window_block_bwd",
    "k7_window_block_bwd_wgrad": "window_block_bwd",
    "k8_transition": "fused_transition_block",
    "k9_transition_bwd": "transition_bwd",
    "k10_flash_attention": "flash_attention",
    "k10_flash_attention_d256": "flash_attention",
    "k11_flash_attention_bwd_delta": "flash_attention_bwd_delta",
    "k11_flash_attention_bwd_dq": "flash_attention_bwd_dq",
    "k11_flash_attention_bwd_dkv": "flash_attention_bwd_dkv",
    "k12_window_block_strips_rem": "fused_window_block_strips_rem",
    "k13_window_block_strips_rem_bwd": "window_block_strips_rem_bwd",
    "k14_full_attention": "full_attention",
    "k14_full_attention_d256": "full_attention",
    "k15_ln_matmul": "fused_ln_matmul",
    "k16_ln_qkv": "fused_ln_qkv",
}


def _entry_spans(events: list) -> dict[tuple, list]:
    """(pid, tid) -> sorted (start, end, entry point) of the C entry points'
    profiler annotations."""
    spans = collections.defaultdict(list)
    for e in events:
        if (e.get("cat") == "user_annotation"
                and e.get("name") in ENTRY_WRAPPER):
            spans[(e["pid"], e["tid"])].append((e["ts"], e["ts"] + e["dur"],
                                                e["name"]))
    for v in spans.values():
        v.sort()
    return spans


def trace_device_time(path: str) -> dict[str, list]:
    """Device time (us) and count by kernel of a torch.profiler Chrome
    trace: a device kernel launched inside a C entry point's annotation is
    counted under the entry point's name (its launch is the runtime call of
    the same correlation id, inside the annotation's span on its thread),
    any other under its own name."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    spans = _entry_spans(events)
    starts = {k: [t0 for t0, _, _ in v] for k, v in spans.items()}
    out: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for k in kernels:
        name = k["name"]
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is not None:
            key = (launch["pid"], launch["tid"])
            i = bisect.bisect_right(starts.get(key, []), launch["ts"]) - 1
            if i >= 0 and spans[key][i][1] >= launch["ts"]:
                name = spans[key][i][2]
        out[name][0] += k["dur"]
        out[name][1] += 1
    return out


def entry_calls(path: str) -> collections.Counter:
    """Calls of each C entry point in a torch.profiler Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return collections.Counter(name for v in _entry_spans(events).values()
                               for _, _, name in v)


def make_step(mode: str, model_cfg: str, size: int, batch: int,
              device: torch.device):
    """One forward (eval mode, no autograd) or one train step of a seeded
    random model on zero inputs, bf16."""
    torch.manual_seed(0)
    x = torch.zeros((batch, size, size, 3), device=device)
    if mode == "infer":
        model = build_model(model_cfg, device, torch.bfloat16)
        x = x.to(torch.bfloat16)

        def forward():
            with torch.inference_mode():
                return model(x)[0]
        return forward
    model = build_model(model_cfg, device)
    cast_frozen(model, torch.bfloat16)
    optimizer = make_optimizer(model)
    y = torch.zeros((batch, size, size, 1), device=device)
    return lambda: train_step(model, optimizer, x, y)


def run(mode: str = "infer", batch: int = 32, size: int = 352,
        model_cfg: str = "sam2_hiera_l", top: int = 25, steps: int = 3,
        device: str | torch.device = "cuda") -> dict:
    """Profile `steps` steps after one warm-up and print the table. Returns
    {"device", "rows": [(name, ms per step, calls per step)], "calls":
    each C entry point's calls over the steps, "wall_ms": per step (host
    clock, the profiler on), "busy_ms": device kernel time per step}."""
    dev = resolve_device(device)
    step = make_step(mode, model_cfg, size, batch, dev)
    cuda = dev.type == "cuda"
    step()
    if cuda:
        torch.cuda.synchronize(dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                out = step()
            float(out.float().sum())
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        trace = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(trace)
        calls = entry_calls(trace)
        if cuda:
            by_name = trace_device_time(trace)
            if not by_name:
                raise RuntimeError("the profiler recorded no device kernel")
        else:
            by_name = {e.key: [e.self_cpu_time_total, e.count]
                       for e in prof.key_averages()}
    busy = sum(us for us, _ in by_name.values()) / 1e3 / steps
    rows = [(name, us / 1e3 / steps, n / steps) for name, (us, n) in
            sorted(by_name.items(), key=lambda kv: -kv[1][0])]
    where = (torch.cuda.get_device_name(dev) if cuda else "the CPU")
    what = "device kernels" if cuda else "CPU operators (own time)"
    print(f"{model_cfg}@{size} {mode} batch {batch} bf16 on {where}: "
          f"{wall_ms:.3f} ms a step (host clock, profiler on), {what} "
          f"{busy:.3f} ms a step")
    print(f"top {top} {what} (avg per step over {steps}):")
    for name, ms, n in rows[:top]:
        print(f"{ms:9.3f} ms  n={n:7.1f}  {name[:100]}")
    if calls:
        print("hand-written kernels, calls per step: " + ", ".join(
            f"{k} {v / steps:g}" for k, v in sorted(calls.items())))
    return {"device": where, "rows": rows, "calls": dict(calls),
            "wall_ms": wall_ms, "busy_ms": busy, "steps": steps}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--mode", choices=["infer", "train"], default="infer")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--size", type=int, default=352)
    p.add_argument("--model_cfg", type=str, default="sam2_hiera_l")
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    return run(a.mode, a.batch, a.size, a.model_cfg, a.top, a.steps,
               a.device)


if __name__ == "__main__":
    main()
