"""Ranks of a data-, tensor- or sequence-parallel port run on the CPU, for
the tests: each rank is a process of its own (`python
tests/torch_dist_worker.py KIND SPEC OUT`) with torchrun's environment, on
gloo over localhost with one torch thread, and imports no JAX. `run_ranks` starts them and joins them under
one deadline; a rank that fails or outlives it fails the test with the
ranks' output.

    KIND   what each rank runs (WORKERS); SPEC, a torch.save'd dict of its
           inputs; OUT, where the rank torch.saves its result
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(kind: str, spec: dict, out_dir: Path, world: int = 2,
              timeout: float = 120.0) -> list:
    """Run `kind` on `world` ranks; returns each rank's result."""
    out_dir.mkdir(parents=True, exist_ok=True)
    spec_path = out_dir / f"{kind}_spec.pt"
    torch.save(spec, spec_path)
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        log = open(out_dir / f"{kind}_rank{r}.log", "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, __file__, kind, str(spec_path),
             str(out_dir / f"{kind}_rank{r}.pt")],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(out_dir)))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(p.returncode for p in procs):
        tails = "\n".join(
            f"--- rank {r} (exit {p.returncode}):\n"
            + (out_dir / f"{kind}_rank{r}.log").read_text(errors="replace")[-3000:]
            for r, p in enumerate(procs))
        raise AssertionError(f"{kind} on {world} ranks failed:\n{tails}")
    return [torch.load(out_dir / f"{kind}_rank{r}.pt", weights_only=True)
            for r in range(world)]


# ------------------------------------------------------------- the workers


def _syncbn(spec: dict) -> dict:
    """A SyncBatchNorm2d's train-mode forward and backward on this rank's
    rows of the global input, for the loss sum(y * w_out) over the global
    batch."""
    from sam2unet_torch.nn.layers import SyncBatchNorm2d
    from sam2unet_torch.parallel.mesh import make_mesh, rows

    mesh = make_mesh("cpu")
    bn = SyncBatchNorm2d(spec["x"].shape[1])
    bn.load_state_dict(spec["state"])
    own = rows(len(spec["x"]), mesh)
    x = spec["x"][own].clone().requires_grad_(True)
    y = bn.train()(x)
    (y * spec["w_out"][own]).sum().backward()
    torch.distributed.destroy_process_group()
    return {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad, "state": bn.state_dict()}


def _bn_counts(model) -> dict:
    """Each BatchNorm's elements per channel on this rank (filled by the
    forward)."""
    counts = {}
    for name, mod in model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            mod.register_forward_hook(
                lambda m, a, o, name=name: counts.__setitem__(
                    name, a[0].numel() // a[0].shape[1]))
    return counts


def _step(spec: dict) -> dict:
    """One SGD train step of the hiera_test SAM2-UNet with SyncBN on this
    rank's rows of the global batch."""
    from sam2unet_torch.configs import HIERA_TEST, SAM2UNetConfig
    from sam2unet_torch.models.sam2unet import SAM2UNet
    from sam2unet_torch.parallel.mesh import make_mesh, shard_batch
    from sam2unet_torch.train.engine import train_step
    from sam2unet_torch.train.optim import trainable_parameters

    mesh = make_mesh("cpu")
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST))
    model.load_state_dict(spec["state"], strict=True)
    counts = _bn_counts(model)
    opt = torch.optim.SGD([p for _, p in trainable_parameters(model)],
                          lr=spec["lr"])
    loss = train_step(model, opt, shard_batch(mesh, spec["x"]),
                      shard_batch(mesh, spec["y"]))
    torch.distributed.destroy_process_group()
    return {"loss": float(loss), "state": model.state_dict(),
            "bn_n": {k: v * mesh.world for k, v in counts.items()}}


def _cli(spec: dict) -> dict:
    """The train CLI on this rank, recording every write this process makes
    under the save path."""
    from sam2unet_torch.cli import train_cli

    root = os.path.realpath(spec["save_path"])
    writes = []

    def audit(event, args):
        if event == "open" and args[0] is not None and not isinstance(args[0], int):
            mode, flags = args[1] or "", args[2] or 0
            writing = any(c in mode for c in "wax+") or flags & (
                os.O_WRONLY | os.O_RDWR | os.O_CREAT)
            path = os.path.realpath(os.fsdecode(args[0]))
        elif event in ("os.mkdir", "os.rename", "os.replace", "os.remove",
                       "shutil.rmtree", "os.rmdir"):
            writing, path = True, os.path.realpath(os.fsdecode(args[0]))
        else:
            return
        if writing and path.startswith(root):
            writes.append(f"{event} {os.path.relpath(path, root)}")

    sys.addaudithook(audit)
    real_save = torch.save   # writes from C++: no audit event

    def save(obj, f, *a, **k):
        path = os.path.realpath(os.fsdecode(f))
        if path.startswith(root):
            writes.append(f"torch.save {os.path.relpath(path, root)}")
        return real_save(obj, f, *a, **k)

    torch.save = save
    stats = train_cli.main(train_cli.build_parser().parse_args(spec["argv"]))
    return {"stats": stats, "writes": writes}


def _dual(spec: dict) -> dict:
    """The port's half of the dual-train proxy: the hiera_test SAM2-UNet
    with SyncBN over this rank's rows, epoch 0 from the shared init, then
    the JAX-written train state after that epoch restored and the other
    epochs from it, each step at the schedule's rate at the global step;
    then rank 0's eval logits of every test image."""
    from sam2unet_torch.configs import HIERA_TEST, SAM2UNetConfig
    from sam2unet_torch.models.sam2unet import SAM2UNet
    from sam2unet_torch.parallel.mesh import make_mesh, shard_batch
    from sam2unet_torch.train.checkpoints import restore_train_state
    from sam2unet_torch.train.engine import eval_logits, train_step
    from sam2unet_torch.train.optim import cosine_step_lr, make_optimizer, set_lr

    mesh = make_mesh("cpu")
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST))
    model.load_state_dict(spec["state"], strict=True)
    opt = make_optimizer(model, spec["lr"], spec["wd"])
    x, y, batch = spec["x"], spec["y"], spec["batch"]
    spe = len(x) // batch
    losses, step = [], 0
    for epoch in range(spec["epochs"]):
        if epoch == spec["resume_epoch"]:
            step = restore_train_state(spec["resume"], model, opt)
        for b in range(0, len(x), batch):
            set_lr(opt, cosine_step_lr(spec["lr"], step, spec["epochs"], spe))
            losses.append(float(train_step(model, opt,
                                           shard_batch(mesh, x[b: b + batch]),
                                           shard_batch(mesh, y[b: b + batch]))))
            step += 1
    logits = [eval_logits(model, t[None])[0, ..., 0] for t in spec["x_test"]]
    torch.distributed.destroy_process_group()
    return {"losses": losses, "logits": torch.stack(logits), "step": step}


def _eval(spec: dict) -> dict:
    """Both evaluators of the train CLI on this rank's rows of each global
    eval batch: the device one and the host one (--full_eval)."""
    from sam2unet_torch.cli.train_cli import full_evaluate
    from sam2unet_torch.configs import HIERA_TEST, SAM2UNetConfig
    from sam2unet_torch.data.dataset import EvalDataset
    from sam2unet_torch.models.sam2unet import SAM2UNet
    from sam2unet_torch.parallel.mesh import make_mesh
    from sam2unet_torch.train.engine import evaluate

    mesh = make_mesh("cpu")
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST))
    model.load_state_dict(spec["state"], strict=True)
    data = EvalDataset(spec["images"], spec["gts"], spec["size"])
    out = {name: fn(model, data, spec["batch"], spec["size"], mesh.device)
           for name, fn in (("device", evaluate), ("host", full_evaluate))}
    torch.distributed.destroy_process_group()
    return out


def _sp_attention(spec: dict) -> dict:
    """Each case's sequence-parallel attention over the ranks (the default
    group) on this rank's slice of the tokens, and its gradients for the
    loss sum(out * cot)."""
    import torch.distributed as dist

    from sam2unet_torch.ops import sp_attention
    from sam2unet_torch.parallel.mesh import make_mesh

    mesh = make_mesh("cpu")
    out = []
    for case in spec["cases"]:
        sl = case["q"].shape[1] // mesh.world
        own = slice(mesh.rank * sl, (mesh.rank + 1) * sl)
        q, k, v = (case[n][:, own].clone().requires_grad_(True)
                   for n in ("q", "k", "v"))
        fn = getattr(sp_attention, case["fn"])
        o = fn(q, k, v, dist.group.WORLD)
        (o * case["cot"][:, own]).sum().backward()
        out.append({"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad})
    dist.destroy_process_group()
    return {"cases": out, "calls": dict(sp_attention.calls)}


def _sp_hiera(spec: dict) -> dict:
    """The Hiera trunk with its global block sequence-parallel over the
    ranks, eval forward on the whole input (every rank holds it)."""
    import torch.distributed as dist

    from sam2unet_torch.configs import HieraConfig
    from sam2unet_torch.models.hiera import Hiera
    from sam2unet_torch.ops import sp_attention
    from sam2unet_torch.parallel.mesh import make_mesh

    mesh = make_mesh("cpu")
    model = Hiera(HieraConfig(**spec["cfg"]), sp_group=dist.group.WORLD,
                  sp_degree=mesh.world)
    model.load_state_dict(spec["state"], strict=True)
    with torch.no_grad():
        outs = model.eval()(spec["x"])
    dist.destroy_process_group()
    return {"outs": outs, "calls": dict(sp_attention.calls)}


def _tp_step(spec: dict) -> dict:
    """One tensor-parallel AdamW step of the hiera_test SAM2-UNet (rfb_out
    8) on a (world / 2, 2) mesh: this rank's rows of the global batch, the
    large leaves split over the model axis (`min_shard`). With
    `world_reduce`, the gradient mean and SyncBN reduce over every rank
    instead of the data group (the fault the tests must catch). Returns the
    loss, the trainable parameters and gradients whole, the statistics,
    each split leaf's bytes held and whole (parameter and moments), and
    each BatchNorm's elements per channel over the global batch."""
    import torch.distributed as dist

    from sam2unet_torch.configs import HIERA_TEST, SAM2UNetConfig
    from sam2unet_torch.models.sam2unet import SAM2UNet
    from sam2unet_torch.parallel.mesh import make_mesh, shard_batch
    from sam2unet_torch.train.engine import create_sharded_train_state, train_step
    from sam2unet_torch.train.optim import make_optimizer, trainable_parameters

    mesh = make_mesh("cpu", model_parallel=2)
    if spec.get("world_reduce"):
        mesh = mesh._replace(data_group=None)
    model = SAM2UNet(SAM2UNetConfig(trunk=HIERA_TEST, rfb_out=8))
    model.load_state_dict(spec["state"], strict=True)
    counts = _bn_counts(model)
    opt = make_optimizer(model, spec["lr"], spec["wd"])
    state = create_sharded_train_state(model, opt, mesh, spec["min_shard"])
    loss = train_step(model, opt, shard_batch(mesh, spec["x"]),
                      shard_batch(mesh, spec["y"]), sharded=state)
    held = {}
    for name, p in state.params.items():
        moments = [v for v in opt.state.get(p, {}).values()
                   if torch.is_tensor(v) and v.dim() > 0]
        held[name] = ([p.numel()] + [m.numel() for m in moments],
                      state.full(name, p.data).numel(), state.dims[name])
    out = {"loss": float(loss),
           "params": {k: state.full(k, p.data) for k, p in trainable_parameters(model)},
           "grads": {k: state.full(k, p.grad) for k, p in trainable_parameters(model)},
           "stats": {k: v for k, v in model.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))},
           "held": held, "bytes": state.held_bytes(),
           "bn_n": {k: v * mesh.data_size for k, v in counts.items()}}
    dist.destroy_process_group()
    return out


WORKERS = {"syncbn": _syncbn, "step": _step, "cli": _cli, "dual": _dual,
           "eval": _eval, "sp_attention": _sp_attention, "sp_hiera": _sp_hiera,
           "tp_step": _tp_step}


if __name__ == "__main__":
    kind, spec_path, out_path = sys.argv[1:4]
    torch.set_num_threads(1)
    result = WORKERS[kind](torch.load(spec_path, weights_only=True))
    torch.save(result, out_path)
