"""The train and eval steps, after sam2unet_tpu/train/engine.py (reference
train.py:66-123): forward through the three heads, the summed structure
loss, backward into the trainable set (the trunk is frozen: its blocks'
backward computes dx only), one AdamW step; train-mode BatchNorm updates
its running statistics (torch's convention: the running variance is the
unbiased one, as in the reference; the JAX package stores the biased one).
Evaluation runs the model in eval mode and reduces IoU and Dice on the
device.

Across ranks (a process group of world > 1, `parallel/mesh.py`) both are
the JAX package's shard_map forms (sam2unet_tpu/train/engine.py:127-176):
each rank holds its rows of the global batch, computes its local structure
loss (its `SyncBatchNorm2d`s normalise over the global batch), and the
trainable gradients are averaged over the ranks by one explicit all-reduce
before AdamW (the JAX step's pmean'd loss, whose gradient is the mean of
the ranks' gradients), which carries the loss too: the loss returned is
the global mean. `evaluate` scores each rank's rows and sums the metrics
over the ranks, so every rank reads the global mIoU.

On a (data, model) mesh, `create_sharded_train_state` places the state as
the JAX package's does (sam2unet_tpu/train/engine.py:57-68,
`parallel/sharding.py`): between steps a rank holds only its column shard
of each split parameter, trainable or frozen, and of its AdamW moments.
The step (`train_step` with the state) gathers the full parameters over
the model group, runs the forward and backward as the replicated step does,
averages the gradients over the data group, and AdamW updates the rank's
shards with the matching slices of the gradients. AdamW is elementwise, so
each shard's update is that slice of the full update: the step computes
what the JAX package's placement-only GSPMD step does, the one-process
step."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from sam2unet_torch.eval.metrics import MIOU
from sam2unet_torch.eval.metrics_device import batched_semantic_metrics
from sam2unet_torch.parallel.mesh import (
    Mesh,
    all_gather_cat,
    all_mean_,
    all_sum,
    rank_and_world,
    shard_batch,
)
from sam2unet_torch.parallel.sharding import shard, shard_tree
from sam2unet_torch.train.loss import multi_head_loss


class ShardedState:
    """The placement of a model's train state on a mesh: `dims`, the split
    dim of each parameter the policy splits over the model axis (empty
    with a 1-sized model axis: plain replication). Between steps those
    parameters, and their AdamW moments, hold this rank's shard."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 mesh: Mesh, dims: dict[str, int]):
        self.mesh, self.dims = mesh, dims
        self.params = {n: p for n, p in model.named_parameters() if n in dims}
        self.optimizer = optimizer
        self._shards: dict[str, torch.Tensor] = {}

    def gather(self) -> None:
        """Every split parameter whole, for the forward and backward."""
        for name, p in self.params.items():
            self._shards[name] = p.data
            p.data = all_gather_cat(p.data, self.dims[name],
                                    self.mesh.model_group)

    def scatter(self) -> None:
        """Back to this rank's shards, each gradient cut to its slice."""
        for name, p in self.params.items():
            grad, p.grad = p.grad, None
            p.data = self._shards.pop(name)
            if grad is not None:
                p.grad = shard(grad, self.dims[name], self.mesh)

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Parameter `name`'s shard (or a tensor of its shape: its gradient
        or a moment) `t` gathered whole; replicated ones as they are."""
        if name not in self.dims:
            return t
        return all_gather_cat(t, self.dims[name], self.mesh.model_group)

    def held_bytes(self) -> tuple[int, int]:
        """(bytes this rank holds, bytes whole) of the split parameters and
        their AdamW moments."""
        held = full = 0
        mp = self.mesh.model_parallel
        for p in self.params.values():
            slots = [p] + [v for v in self.optimizer.state.get(p, {}).values()
                           if torch.is_tensor(v) and v.shape == p.shape]
            n = sum(t.numel() * t.element_size() for t in slots)
            held, full = held + n, full + n * mp
        return held, full


def create_sharded_train_state(model: nn.Module,
                               optimizer: torch.optim.Optimizer, mesh: Mesh,
                               min_shard_size: int | None = None
                               ) -> ShardedState:
    """Place the model's parameters (and any AdamW moments the optimizer
    holds already) by the tensor-parallel policy, in place: large matmul
    weights split over the model axis, the rest replicated (the JAX
    package's `create_sharded_train_state`). The neck's and decoder's
    SyncBatchNorm2d's reduce over the data group."""
    from sam2unet_torch.nn.layers import SyncBatchNorm2d

    kw = {} if min_shard_size is None else {"min_size": min_shard_size}
    dims = shard_tree(model, mesh, **kw)
    state = ShardedState(model, optimizer, mesh, dims)
    with torch.no_grad():
        for name, p in state.params.items():
            moments = optimizer.state.get(p, {})
            for k, v in moments.items():
                if torch.is_tensor(v) and v.dim() == p.dim() and v.shape != p.shape:
                    moments[k] = shard(v, dims[name], mesh)
    for m in model.modules():
        if isinstance(m, SyncBatchNorm2d):
            m.group = mesh.data_group
    return state


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               images: torch.Tensor, labels: torch.Tensor,
               weighted_bce: bool = False,
               sharded: ShardedState | None = None) -> torch.Tensor:
    """One step on (B, H, W, 3) normalized images and (B, H, W, 1) {0, 1}
    labels, this rank's rows of the global batch; with `sharded`, the
    tensor-parallel step on its mesh. Returns the global batch's loss (a
    device scalar, not synchronised for one rank)."""
    model.train()
    if sharded is not None:
        sharded.gather()
    loss = multi_head_loss(model(images), labels, weighted_bce)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    loss = loss.detach()
    # one all-reduce: the gradients' and the loss's means over the data axis
    all_mean_([p.grad for group in optimizer.param_groups
               for p in group["params"] if p.grad is not None] + [loss],
              None if sharded is None else sharded.mesh.data_group)
    if sharded is not None:
        sharded.scatter()
    optimizer.step()
    return loss


def eval_logits(model: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """The main head's logits in eval mode, (B, H, W, 1)."""
    model.eval()
    with torch.inference_mode():
        return model(images)[0]


def letterbox_valid_mask(paddings: torch.Tensor, size: int, h: int,
                         w: int) -> torch.Tensor:
    """(B, h, w, 1) bool, True inside the un-padded letterbox content;
    paddings (B, 4) [left, top, right, bottom]."""
    dev = paddings.device
    rows = torch.arange(h, device=dev)[None, :, None, None]
    cols = torch.arange(w, device=dev)[None, None, :, None]
    left, top, right, bottom = (paddings[:, i][:, None, None, None]
                                for i in range(4))
    return ((rows >= top) & (rows < size - bottom)
            & (cols >= left) & (cols < size - right))


def postprocess_logits(logits: torch.Tensor, paddings: torch.Tensor,
                       size: int) -> torch.Tensor:
    """The reference eval postprocess on the device (train.py:103-112):
    sigmoid inside the letterbox content, 0 outside."""
    _, h, w, _ = logits.shape
    valid = letterbox_valid_mask(paddings, size, h, w)
    probs = torch.sigmoid(logits.float())
    return torch.where(valid, probs, torch.zeros_like(probs))


def evaluate(model: nn.Module, test_data, batch_size: int, size: int,
             device: torch.device) -> tuple[dict, int]:
    """Device evaluation over `test_data` (an EvalDataset): mean IoU and
    Dice at model resolution against the letterboxed GT, with the
    reference's binarization; `batch_size` is the global eval batch, of
    which each rank scores its rows. Returns (report dict, forwards run)."""
    mesh = Mesh(*rank_and_world(), device)
    ious, dices, count, forwards = [], [], 0, 0
    for eb in test_data.batches(batch_size, letterbox_gt=True):
        logits = eval_logits(model, shard_batch(mesh, eb["image"]))
        forwards += 1
        pad = np.zeros((batch_size, 4), np.int64)
        pad[: eb["valid"]] = np.asarray(eb["padding"], np.int64)
        paddings = shard_batch(mesh, pad)
        probs = postprocess_logits(logits, paddings, size)[..., 0]
        valid = shard_batch(mesh, np.arange(batch_size) < eb["valid"])
        pix = letterbox_valid_mask(paddings, size, probs.shape[1],
                                   probs.shape[2])[..., 0]
        gt = shard_batch(mesh, eb["gt_letterboxed"])
        iou, dice = batched_semantic_metrics(probs, gt, valid, pix)
        ious.append(iou.cpu())
        dices.append(dice.cpu())
        count += eb["valid"]
        print(".", end="", flush=True)
    sums = torch.stack([torch.cat(ious).sum(), torch.cat(dices).sum()])
    if mesh.world > 1:
        sums = all_sum(sums.to(device)).cpu()
    return ({MIOU: float(sums[0]) / count, "mDice": float(sums[1]) / count,
             "images_count": count}, forwards)


def fp32_state_dict(model: nn.Module,
                    masters: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The model's state dict on the CPU in fp32; parameters named in
    `masters` (the frozen fp32 weights kept before the bf16 cast) are taken
    from there, so a saved checkpoint carries them unchanged."""
    out = {}
    for k, v in model.state_dict().items():
        v = masters.get(k, v).detach().cpu()
        out[k] = v.float() if v.is_floating_point() else v
    return out
