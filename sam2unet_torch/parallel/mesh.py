"""Data parallelism over processes, the port's counterpart of
sam2unet_tpu/parallel/mesh.py: one process per rank (what `torchrun
--nproc_per_node N` starts), the global batch split over the ranks by
rows, parameters replicated.

`make_mesh` starts the process group from torchrun's environment (`RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), at any world
size; without that environment it is world 1 and starts none. The backend is NCCL when every
rank of the host has a card of its own, gloo on the CPU and where ranks
share a card (NCCL refuses two ranks on one device; gloo carries CUDA
tensors for `all_reduce` and `broadcast` through the host). A group the
caller started already is used as it is.

The names are the JAX package's: `DATA_AXIS` names the axis the batch is
split over (the JAX package's SyncBN axis, `bn_axis`), `shard_batch` gives
rank r the rows [r*B/n, (r+1)*B/n) of a global batch of B, `replicate`
gives every rank rank 0's parameters and buffers.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"


class Mesh(NamedTuple):
    rank: int
    world: int
    device: torch.device


def rank_and_world() -> tuple[int, int]:
    """This process's rank and the world size of the started group; (0, 1)
    with none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(device: torch.device | str = "cuda") -> Mesh:
    """The data-parallel mesh of this process: (rank, world, device). Under
    torchrun the device is `cuda:LOCAL_RANK` on the card (modulo the cards
    present, so that ranks may share one) and the process group is started
    from its environment unless one is started already; without torchrun
    the device is `device` as given (the current card where it names
    none)."""
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
    return Mesh(rank, world, device)


def rows(n: int, mesh: Mesh) -> slice:
    """Rank `mesh.rank`'s rows of a global batch of `n`."""
    if n % mesh.world:
        raise ValueError(f"a batch of {n} does not split over {mesh.world} "
                         "ranks")
    per = n // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


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


def all_mean_(tensors: list[torch.Tensor]) -> None:
    """Replace each tensor by its mean over the ranks (one all-reduce over
    their concatenation, of one dtype), in place: the JAX step's `pmean`.
    Nothing to do at world 1."""
    world = rank_and_world()[1]
    if world == 1 or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def all_sum(values: torch.Tensor) -> torch.Tensor:
    """`values` summed over the ranks (a new tensor)."""
    out = values.clone()
    if rank_and_world()[1] > 1:
        dist.all_reduce(out)
    return out
