"""The port's counterparts of the JAX package's driver entry points
(`__graft_entry__.py`): `entry()`, the flagship forward and its example
inputs, and `dryrun_multichip(n)`, one full train step at each phase on a
mesh of n ranks.

`dryrun_multichip(n_devices)` runs the JAX function's five phases, under
its names, in its order, at its shapes and on its meshes (a data mesh of n
ranks, and a (n / mp, mp) data x model mesh, mp = 2 where n is even and at
least 4):

  1. tiny dp x tp: HIERA_TEST with rfb_out 8 at 64 px, the tensor-parallel
     step (`create_sharded_train_state(min_shard_size=128)`);
  2. hiera_s@352 dp: the flagship's step on the data mesh;
  3. hiera_s@352 shard_map+SyncBN: the same step (the port's data-parallel
     step is the JAX package's shard_map form; the JAX GSPMD form of phase 2
     computes the same numbers);
  4. hiera_l@256 shard_map+SyncBN;
  5. hiera_s@352 ring-attention SP: the flagship's eval forward with its
     global blocks' attention split over the model axis by `ring_sdpa`, the
     batch of n / mp rows over the data axis.

The train phases take a global batch of n rows, one AdamW step at the rate
1e-3; phases 4 and 5 run only with DRYRUN_FULL=1, and once DRYRUN_BUDGET_S
seconds (default 600) have passed, each remaining phase is skipped with a
notice: the JAX function's knobs, with its flushed `[dryrun] phase i/n`
lines (from rank 0). Parameters are made by torch's default initialisation
from seed 0 on every rank, the same on each; the batch is seeded noise
with a disc mask per row (the JAX dry run feeds zeros, which would leave
nothing for `record` to compare).

The ranks: under a torchrun whose world is n the function runs in place;
otherwise it starts n processes of this module on localhost (torchrun's
environment, a free port), rank 0's output on this process's, and fails
when any rank fails (the others are then ended). `make_mesh` picks the
backend: gloo on the CPU and where ranks share a card, NCCL where each has
its own. `device`: the ranks' device type, "cuda" by default; "cpu" on
request.

`record`, a directory: each rank writes there, per phase, what the phase
computed (the loss; rank 0 also the trainable parameters and their
gradients whole, the BatchNorm statistics, the SP forward's outputs of its
rows), this rank's bytes of the split parameters and moments against
theirs whole, its kernel launches (counters set to 0 just before the
phase, read just after), the `ring_sdpa` calls, and the phase's seconds.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ENTRY_SIZE = 352
# (name, key, model config, rfb_out, input px, mesh, min_shard_size)
PHASES = [
    ("tiny dp x tp", "tiny", "hiera_test", 8, 64, "tp", 128),
    ("hiera_s@352 dp", "s352dp", "sam2_hiera_s", None, 352, "dp", None),
    ("hiera_s@352 shard_map+SyncBN", "s352sm", "sam2_hiera_s", None, 352,
     "dp", None),
]
HEAVY = [
    ("hiera_l@256 shard_map+SyncBN", "l256", "sam2_hiera_l", None, 256, "dp",
     None),
    ("hiera_s@352 ring-attention SP", "sp", "sam2_hiera_s", None, 352, "tp",
     None),
]
LR = 1e-3


def model_parallel(n_devices: int) -> int:
    """The JAX dry run's model axis: 2 where n is even and at least 4."""
    return 2 if n_devices % 2 == 0 and n_devices >= 4 else 1


def phase_seed(key: str) -> int:
    """The seed of a phase's batch: its place in the phase list."""
    return [p[1] for p in PHASES + HEAVY].index(key)


def phase_model(cfg: str, rfb_out: int | None = None,
                **kw) -> torch.nn.Module:
    """A phase's SAM2UNet from torch's default initialisation at seed 0, on
    the CPU (every rank makes the same one); `kw` goes to SAM2UNet."""
    from sam2unet_torch.configs import SAM2UNetConfig, hiera_config
    from sam2unet_torch.models.sam2unet import SAM2UNet

    extra = {} if rfb_out is None else {"rfb_out": rfb_out}
    torch.manual_seed(0)
    return SAM2UNet(SAM2UNetConfig(trunk=hiera_config(cfg), **extra), **kw)


def phase_batch(n: int, size: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(images (n, size, size, 3) ~ N(0, 1), labels (n, size, size, 1), a
    disc of 1s per row), fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, size, size, 3)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    y = np.stack([((yy - rng.uniform(0.3, 0.7) * size) ** 2
                   + (xx - rng.uniform(0.3, 0.7) * size) ** 2
                   < (rng.uniform(0.15, 0.3) * size) ** 2) for _ in range(n)])
    return x, y[..., None].astype(np.float32)


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): the flagship SAM2-UNet's forward (the reference
    default config sam2_hiera_s at SAM2UNet.py:131) on a 352x352 image, in
    eval mode; bf16 on the card, fp32 on the CPU (the JAX entry's `on_tpu`
    rule). `fn(model, x)` returns the three heads' logits."""
    device = torch.device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = phase_model("sam2_hiera_s").to(device=device, dtype=dtype).eval()
    x = torch.zeros(1, ENTRY_SIZE, ENTRY_SIZE, 3, device=device)

    def fn(model, x):
        with torch.inference_mode():
            return model(x)

    return fn, (model, x)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     record: str | None = None) -> None:
    """Run the dry run's phases on n ranks (module docstring)."""
    env = os.environ
    if "RANK" in env and int(env.get("WORLD_SIZE", "0")) == n_devices:
        _run(n_devices, torch.device(device), record)
        return
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass "
                           "device='cpu' to run on the CPU")
    port = _free_port()
    root = str(Path(__file__).resolve().parents[2])
    procs = []
    for r in range(n_devices):
        child = dict(env, RANK=str(r), WORLD_SIZE=str(n_devices),
                     LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n_devices),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                     PYTHONPATH=os.pathsep.join(
                         [root] + [p for p in [env.get("PYTHONPATH")] if p]))
        cmd = [sys.executable, "-m", "sam2unet_torch.parallel.dryrun",
               str(n_devices), "--device", str(device)]
        if record:
            cmd += ["--record", str(record)]
        procs.append(subprocess.Popen(
            cmd, env=child, stdout=None if r == 0 else subprocess.DEVNULL))
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes) or all(c == 0 for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    failed = {r: p.returncode for r, p in enumerate(procs) if p.returncode}
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks failed "
                           f"(rank: exit code) {failed}")


def _run(n: int, device: torch.device, record: str | None) -> None:
    """The phases on this rank of n (a process group of n ranks)."""
    from sam2unet_torch.ops import dispatch, sp_attention
    from sam2unet_torch.parallel.mesh import all_sum, make_mesh, shard_batch
    from sam2unet_torch.train.engine import (
        ShardedState,
        create_sharded_train_state,
        train_step,
    )
    from sam2unet_torch.train.optim import make_optimizer, trainable_parameters

    full = os.environ.get("DRYRUN_FULL", "") == "1"
    budget_s = float(os.environ.get("DRYRUN_BUDGET_S", "600"))
    t0 = time.monotonic()
    dp_mesh = make_mesh(device)
    mp = model_parallel(n)
    tp_mesh = make_mesh(device, model_parallel=mp)
    lead = dp_mesh.rank == 0
    meshes = {"dp": dp_mesh, "tp": tp_mesh}
    rec: dict = {}

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    def one_step(key, cfg, rfb_out, size, mesh, min_shard):
        model = phase_model(cfg, rfb_out).to(mesh.device)
        opt = make_optimizer(model, lr=LR)
        state = (create_sharded_train_state(model, opt, mesh, min_shard)
                 if mesh.model_parallel > 1 else None)
        x, y = phase_batch(n, size, seed=phase_seed(key))
        loss = float(train_step(model, opt, shard_batch(mesh, x),
                                shard_batch(mesh, y), sharded=state))
        assert loss == loss, "loss is NaN"
        if record:
            state = state or ShardedState(model, opt, mesh, {})
            rec["held_bytes"], rec["full_bytes"] = state.held_bytes()
            rec["loss"] = loss
            tensors = {f"params/{k}": state.full(k, p.data)
                       for k, p in trainable_parameters(model)}
            tensors.update({f"grads/{k}": state.full(k, p.grad)
                            for k, p in trainable_parameters(model)})
            tensors.update({f"stats/{k}": v for k, v in model.state_dict().items()
                            if k.endswith(("running_mean", "running_var"))})
            if lead:
                rec["tensors"] = {k: v.detach().cpu() for k, v in tensors.items()}
        return loss

    def sp_forward(key, cfg, rfb_out, size, mesh, min_shard):
        if mesh.model_parallel < 2:
            return "skipped (no model axis)"
        model = phase_model(cfg, rfb_out, sp_group=mesh.model_group,
                            sp_degree=mesh.model_parallel)
        model = model.to(mesh.device).eval()
        xs, _ = phase_batch(mesh.data_size, size, seed=phase_seed(key))
        with torch.inference_mode():
            outs = model(shard_batch(mesh, xs))
        total = all_sum(outs[0].abs().sum().reshape(1).float(),
                        mesh.data_group)
        val = float(total) / (outs[0].numel() * mesh.data_size)
        assert val == val, "SP forward produced NaN"
        if record and mesh.model_index == 0:
            rec["outs"] = [o.detach().cpu() for o in outs]
            rec["rows"] = [mesh.data_index * len(outs[0]),
                           (mesh.data_index + 1) * len(outs[0])]
        return f"|out|={val:.4f}"

    phases = list(PHASES)
    if full:
        phases += HEAVY
    else:
        say(f"[dryrun] heavy phases ({', '.join(p[0] for p in HEAVY)}) "
            "skipped; set DRYRUN_FULL=1 to run them")
    results = []
    count = len(phases)
    for i, (name, key, cfg, rfb_out, size, mesh_kind, min_shard) in enumerate(
            phases, 1):
        elapsed = time.monotonic() - t0
        # rank 0's clock decides, so that every rank skips alike
        skip = [elapsed > budget_s]
        dist.broadcast_object_list(skip, src=0)
        if skip[0]:
            say(f"[dryrun] phase {i}/{count} {name}: SKIPPED — wall-clock "
                f"budget exceeded ({elapsed:.0f}s > DRYRUN_BUDGET_S="
                f"{budget_s:.0f}s)")
            continue
        say(f"[dryrun] phase {i}/{count} {name}: running...")
        mesh = meshes[mesh_kind]
        rec.clear()
        if record:
            dispatch.reset_launches()
        sp_attention.calls.clear()
        t_phase = time.monotonic()
        if key == "sp":
            detail = sp_forward(key, cfg, rfb_out, size, mesh, min_shard)
        else:
            loss = one_step(key, cfg, rfb_out, size, mesh, min_shard)
            detail = f"loss={loss:.4f}"
            if mesh_kind == "tp" or key == "s352dp":
                detail += (f" mesh={{'data': {mesh.data_size}, "
                           f"'model': {mesh.model_parallel}}}")
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.monotonic() - t_phase
        say(f"[dryrun] phase {i}/{count} {name}: ok ({dt:.1f}s) {detail}")
        results.append(f"{name} {detail}")
        if record:
            rec.update(seconds=dt, launches=dict(dispatch.launches),
                       variants=[[w, v, c] for (w, v), c in
                                 dispatch.variants.items()],
                       ring_calls=sp_attention.calls["ring_sdpa"],
                       rank=mesh.rank, data_index=mesh.data_index,
                       model_index=mesh.model_index)
            os.makedirs(record, exist_ok=True)
            torch.save(rec, os.path.join(record, f"{key}_rank{mesh.rank}.pt"))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    say(f"dryrun_multichip({n}) ok ({time.monotonic() - t0:.1f}s): "
        + "; ".join(results))


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="one rank of dryrun_multichip")
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--record", default=None)
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.n_devices))
    try:
        dryrun_multichip(args.n_devices, device, args.record)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
