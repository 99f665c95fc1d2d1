"""Ranks as a (data, model) mesh, the port's counterpart of
sam2unet_tpu/parallel/mesh.py: one process per rank (what `torchrun
--nproc_per_node N` starts), the global batch split over the data axis by
rows, parameters replicated or, under tensor parallelism
(`parallel/sharding.py`), split over the model axis.

`make_mesh` starts the process group from torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), at any world
size; without that environment it is world 1 and starts none. The backend is NCCL when every
rank of the host has a card of its own, gloo on the CPU and where ranks
share a card (NCCL refuses two ranks on one device). gloo carries CUDA
tensors for `all_reduce`, `broadcast` and `all_gather` through the host;
its `send` and `recv` take host tensors only (given a CUDA tensor, gloo's
TCP transport writes from the device address and the process aborts,
`writev ... Bad address`, torch 2.11), so `exchange` stages a hop through
host copies there. A group the caller started already is used as it is.

The layout is the JAX mesh's: `make_mesh(device, model_parallel=mp)` puts
rank r = d * mp + m at data index d and model index m, a (world / mp, mp)
grid as `np.array(devices).reshape(n // mp, mp)` lays out the JAX devices.
With mp > 1 the mesh holds one process group per data row (the mp ranks
of one data index: the model group, over which tensor- and
sequence-parallel work is split) and one per model column (the ranks of
one model index: the data group, over which gradients and SyncBN's
moments are reduced); every rank makes every group, in one order, as
`torch.distributed.new_group` requires. With mp = 1 the data group is the
default group.

The names are the JAX package's: `DATA_AXIS` and `MODEL_AXIS` name the
axes, `shard_batch` gives data index d the rows [d*B/D, (d+1)*B/D) of a
global batch of B (a batch is replicated over the model axis, as
`P(DATA_AXIS)` is on a 2-D mesh), `replicate` gives every rank rank 0's
parameters and buffers.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh(NamedTuple):
    rank: int
    world: int
    device: torch.device
    model_parallel: int = 1
    # None: the default group (all ranks)
    data_group: object = None
    model_group: object = None

    @property
    def data_size(self) -> int:
        return self.world // self.model_parallel

    @property
    def data_index(self) -> int:
        return self.rank // self.model_parallel

    @property
    def model_index(self) -> int:
        return self.rank % self.model_parallel


def rank_and_world() -> tuple[int, int]:
    """This process's rank and the world size of the started group; (0, 1)
    with none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(device: torch.device | str = "cuda",
              model_parallel: int = 1) -> Mesh:
    """The (data, model) mesh of this process. Under torchrun the device is
    `cuda:LOCAL_RANK` on the card (modulo the cards present, so that ranks
    may share one) and the process group is started from its environment
    unless one is started already; without torchrun the device is `device`
    as given (the current card where it names none). Every rank must call
    it with the same `model_parallel`, which must divide the world."""
    device = torch.device(device)
    env = os.environ
    torchrun = "RANK" in env and "WORLD_SIZE" in env
    world = int(env.get("WORLD_SIZE", "1"))
    if device.type == "cuda":
        if torchrun:
            local = int(env.get("LOCAL_RANK", "0"))
            device = torch.device("cuda", local % torch.cuda.device_count())
        elif device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if torchrun and not dist.is_initialized():
        # NCCL where each rank of the host has a card of its own
        own_card = (device.type == "cuda" and int(
            env.get("LOCAL_WORLD_SIZE", world)) <= torch.cuda.device_count())
        dist.init_process_group("nccl" if own_card else "gloo",
                                init_method="env://", rank=int(env["RANK"]),
                                world_size=world)
    rank, world = rank_and_world()
    mp = model_parallel
    if mp < 1 or world % mp:
        raise ValueError(f"{world} ranks not divisible by "
                         f"model_parallel={mp}")
    if mp == 1:
        return Mesh(rank, world, device)
    grid = np.arange(world).reshape(world // mp, mp)
    data_group = model_group = None
    # every rank creates every group, rows first, in one order
    for row in grid:
        g = dist.new_group(row.tolist())
        if rank in row:
            model_group = g
    for col in grid.T:
        g = dist.new_group(col.tolist())
        if rank in col:
            data_group = g
    return Mesh(rank, world, device, mp, data_group, model_group)


def rows(n: int, mesh: Mesh) -> slice:
    """The rows of a global batch of `n` that `mesh.rank` holds: its data
    index's."""
    if n % mesh.data_size:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{mesh.data_size} ranks")
    per = n // mesh.data_size
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def shard_batch(mesh: Mesh, batch: np.ndarray | torch.Tensor) -> torch.Tensor:
    """This rank's rows of the global `batch`, on its device."""
    part = batch[rows(len(batch), mesh)]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(mesh.device)


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place."""
    if mesh.world > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def group_size(group=None) -> int:
    """The ranks of `group` (None: the default group); 1 with no process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(group)
    return 1


def all_mean_(tensors: list[torch.Tensor], group=None) -> None:
    """Replace each tensor by its mean over the ranks of `group` (one
    all-reduce over their concatenation, of one dtype), in place: the JAX
    step's `pmean` over the data axis. Nothing to do for one rank."""
    n = group_size(group)
    if n == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= n
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_sum(values: torch.Tensor, group=None) -> torch.Tensor:
    """`values` summed over the ranks of `group` (a new tensor)."""
    out = values.clone()
    if group_size(group) > 1:
        dist.all_reduce(out, group=group)
    return out


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' `t` of `group`, concatenated along `dim` in rank order (a
    new tensor; no gradient)."""
    n = group_size(group)
    src = t.detach().contiguous()
    if n == 1:
        return src.clone()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def exchange(t: torch.Tensor, group) -> torch.Tensor:
    """One hop of a ring over `group`: send `t` to the next rank of the
    group ((i + 1) mod n) and return what the previous one sent (a new
    tensor on t's device; no gradient). Over gloo a CUDA tensor goes
    through a host copy each way (module docstring)."""
    n = group_size(group)
    i = dist.get_rank(group)
    src = t.detach().contiguous()
    if src.device.type == "cuda" and dist.get_backend(group) == "gloo":
        src = src.cpu()
    out = torch.empty_like(src)
    nxt, prv = (i + 1) % n, (i - 1) % n
    if group is not None:   # the peers' ranks in the default group
        nxt, prv = (dist.get_global_rank(group, nxt),
                    dist.get_global_rank(group, prv))
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, out, prv, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(t.device)
