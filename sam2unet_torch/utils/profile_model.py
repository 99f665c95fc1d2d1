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
    "k1_fused_mlp_sm90": "fused_mlp", "k2_mlp_bwd_dx_sm90": "mlp_bwd_dx",
    "k3_adapter_bwd": "adapter_bwd", "k3_adapter_bwd_sm90": "adapter_bwd",
    "k4_window_block_strips": "fused_window_block_strips",
    "k5_window_block_strips_bwd": "window_block_strips_bwd",
    "k5_window_block_strips_bwd_sm90": "window_block_strips_bwd",
    "k6_window_block": "fused_window_block",
    "k6_window_block_masked": "fused_window_block",
    "k7_window_block_bwd": "window_block_bwd",
    "k7_window_block_bwd_sm90": "window_block_bwd",
    "k7_window_block_bwd_masked": "window_block_bwd",
    "k7_window_block_bwd_wgrad": "window_block_bwd",
    "k8_transition": "fused_transition_block",
    "k9_transition_bwd": "transition_bwd",
    "k9_transition_bwd_sm90": "transition_bwd",
    "k10_flash_attention": "flash_attention",
    "k10_flash_attention_d256": "flash_attention",
    "k10_flash_attention_sm90": "flash_attention",
    "k11_flash_attention_bwd_delta": "flash_attention_bwd_delta",
    "k11_flash_attention_bwd_dq": "flash_attention_bwd_dq",
    "k11_flash_attention_bwd_dkv": "flash_attention_bwd_dkv",
    "k11_flash_attention_bwd_dq_sm90": "flash_attention_bwd_dq",
    "k11_flash_attention_bwd_dkv_sm90": "flash_attention_bwd_dkv",
    "k12_window_block_strips_rem": "fused_window_block_strips_rem",
    "k13_window_block_strips_rem_bwd": "window_block_strips_rem_bwd",
    "k14_full_attention": "full_attention",
    "k14_full_attention_d256": "full_attention",
    "k14_full_attention_sm90": "full_attention",
    "k15_ln_matmul": "fused_ln_matmul",
    "k16_ln_qkv": "fused_ln_qkv",
}


def device_kernels(events: list) -> list:
    """The device kernels among a torch.profiler run's events
    (`prof.events()`): device events that are neither a GPU user annotation
    (a `record_function` range, as each C entry point's is: it spans the
    kernels it launches, so counting it beside them counts their time
    twice) nor a copy or fill."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in ENTRY_WRAPPER
            and not e.name.startswith(("Memcpy", "Memset"))]


def busy_span_us(kernels: list) -> tuple[float, float]:
    """(busy, span) in us of device kernels: the time at least one of them
    ran (their intervals' union) and the time from the first start to the
    last end, so that 1 - busy / span, the device's idle share, lies in
    [0, 1]."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    if not spans:
        return 0.0, 0.0
    busy, end = 0.0, spans[0][0]
    for t0, t1 in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    return busy, end - spans[0][0]


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


def _kernels_by_entry(path: str):
    """(entry point or None, kernel name, duration in us) of each device
    kernel of a torch.profiler Chrome trace: a kernel launched inside a C
    entry point's annotation (its launch is the runtime call of the same
    correlation id, inside the annotation's span on its thread) names it."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    spans = _entry_spans(events)
    starts = {k: [t0 for t0, _, _ in v] for k, v in spans.items()}
    for k in kernels:
        entry = None
        launch = launches.get(k.get("args", {}).get("correlation"))
        if launch is not None:
            key = (launch["pid"], launch["tid"])
            i = bisect.bisect_right(starts.get(key, []), launch["ts"]) - 1
            if i >= 0 and spans[key][i][1] >= launch["ts"]:
                entry = spans[key][i][2]
        yield entry, k["name"], k["dur"]


def trace_device_time(path: str) -> dict[str, list]:
    """Device time (us) and count by kernel of a torch.profiler Chrome
    trace: a device kernel launched inside a C entry point's annotation is
    counted under the entry point's name, any other under its own name."""
    out: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for entry, name, dur in _kernels_by_entry(path):
        out[entry or name][0] += dur
        out[entry or name][1] += 1
    return out


def trace_entry_kernels(path: str) -> dict[str, dict[str, list]]:
    """Each C entry point's device kernels in a torch.profiler Chrome
    trace: entry point -> kernel name -> [device time (us), count]."""
    out: dict[str, dict[str, list]] = collections.defaultdict(
        lambda: collections.defaultdict(lambda: [0.0, 0]))
    for entry, name, dur in _kernels_by_entry(path):
        if entry is not None:
            out[entry][name][0] += dur
            out[entry][name][1] += 1
    return out


def _is_launch(e: dict) -> bool:
    """A host-side kernel launch (cudaLaunchKernel, cudaLaunchKernelExC,
    cuLaunchKernel, ...) in a Chrome trace."""
    name = e.get("name", "")
    return (e.get("cat") in ("cuda_runtime", "cuda_driver")
            and ("LaunchKernel" in name or "LaunchCooperativeKernel" in name))


def trace_call_kernels(path: str, calls: int, within: str | None = None
                       ) -> tuple[dict[str, list], list[str]]:
    """The device kernels of `calls` repeats of one call in a torch.profiler
    Chrome trace, kernel name -> [device time (us), count], and what the
    trace misses of them: a launch whose kernel it lacks, a kernel whose
    launch it lacks, an entry point whose annotations are not a multiple of
    `calls`, or whose calls launched unequal counts of kernels (the
    profiler's device records of a short call can come back in part). With
    `within`, only the launches inside that annotation on its thread count,
    with their kernels and entry-point calls: calls made before it in the
    same profile take the profiler's first records, which can come back
    without their kernels."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if _is_launch(e)]
    corr = lambda e: e.get("args", {}).get("correlation")  # noqa: E731
    inside = lambda key, t: True  # noqa: E731
    if within is not None:
        window = [((e["pid"], e["tid"]), e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == within]
        inside = lambda key, t: any(k == key and t0 <= t <= t1  # noqa: E731
                                    for k, t0, t1 in window)
        launches = [e for e in launches if inside((e["pid"], e["tid"]), e["ts"])]
        ours = {corr(e) for e in launches}
        kernels = [e for e in kernels if corr(e) in ours]
    by_corr = {corr(e) for e in kernels}
    launched = {corr(e) for e in launches}
    faults = []
    launches.sort(key=lambda e: e["ts"])
    lost = [i for i, e in enumerate(launches, 1) if corr(e) not in by_corr]
    if lost:
        faults.append(f"launches {lost} of {len(launches)} without their kernel")
    orphans = sum(corr(e) not in launched for e in kernels)
    if orphans:
        faults.append(f"{orphans} of {len(kernels)} kernels without their launch")
    per_call = collections.defaultdict(list)
    for key, spans in _entry_spans(events).items():
        at = sorted(e["ts"] for e in launches if (e["pid"], e["tid"]) == key)
        for t0, t1, name in spans:
            if inside(key, t0):
                per_call[name].append(bisect.bisect_right(at, t1) - bisect.bisect_left(at, t0))
    for name, counts in sorted(per_call.items()):
        if len(counts) % calls or len(set(counts)) != 1 or counts[0] == 0:
            faults.append(f"{name}: {len(counts)} calls launching {counts} kernels")
    out: dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
    for e in kernels:
        out[e["name"]][0] += e["dur"]
        out[e["name"]][1] += 1
    return dict(out), faults


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
