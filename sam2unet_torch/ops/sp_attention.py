"""Sequence-parallel attention over a process group, the port's
counterpart of sam2unet_tpu/ops/sp_attention.py. The tokens of a
(B, S, H, D) attention are split over the ranks of `group` in rank order:
each rank holds q, k and v of its S / n tokens and returns its tokens'
outputs. Two interchangeable schedules:

- `ring_sdpa`: ring attention. The resident K/V block is folded in first,
  then n - 1 hops: each hop every rank hands its current K/V block to the
  next rank of the group ((i + 1) mod n) and folds in the one it received,
  by an online softmax in fp32 (running max, normaliser and output), as
  the JAX form's `lax.scan` over `lax.ppermute` does. Its backward (the
  JAX form's is `jax.grad` through that scan) gathers K and V, recomputes
  the probabilities from the forward's log-sum-exp, and sums each rank's
  dK and dV contributions back over the group.
- `allgather_sdpa`: K and V gathered once, then one softmax over the full
  key axis (`ops/attention.py::sdpa`); its backward sums the gathered
  blocks' gradients back over the group.

In the JAX package these are XLA ops, not Pallas kernels, and so they are
plain PyTorch here: einsum products in fp32 on whatever device the tensors
are on. The collectives go through `parallel/mesh.py`: over NCCL directly;
over gloo (ranks that share a card), whose send and recv refuse CUDA
tensors, each ring hop is staged through host memory (a device-to-host
copy, the exchange, a copy back), and gloo itself carries the gathers and
sums through the host, while the arithmetic stays on the card.

`calls` counts the calls of each schedule (not kernel launches).
"""

from __future__ import annotations

import collections

import torch

from sam2unet_torch.parallel.mesh import all_gather_cat, all_sum, exchange

calls: collections.Counter = collections.Counter()


def group_index(group) -> int:
    """This rank's index in `group`, which orders the token blocks."""
    import torch.distributed as dist

    return dist.get_rank(group)


class _Gather(torch.autograd.Function):
    """The ranks' blocks of `group` concatenated along `dim`; the backward
    sums the cotangent over the group and returns this rank's slice."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, t.shape[dim]
        return all_gather_cat(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        g = all_sum(g.contiguous(), ctx.group)
        i = group_index(ctx.group)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


def gather_tokens(t: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every rank's tokens of `group` along `dim`, differentiable."""
    return _Gather.apply(t, dim, group)


def allgather_sdpa(q, k, v, group, scale: float | None = None):
    """Sequence-parallel attention with gathered keys/values."""
    from sam2unet_torch.ops.attention import sdpa

    calls["allgather_sdpa"] += 1
    return sdpa(q, gather_tokens(k, group), gather_tokens(v, group),
                scale=scale)


def _fold(qf, k_blk, v_blk, m, l, o, scale):
    s = torch.einsum("bqhd,bkhd->bqhk", qf, k_blk.float()) * scale
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    o = o * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, v_blk.float())
    return m_new, l, o


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        n = torch.distributed.get_world_size(group)
        qf = q.float()
        b, s, h, _ = q.shape
        m = qf.new_full((b, s, h), -torch.inf)
        l = qf.new_zeros((b, s, h))
        o = torch.zeros_like(qf)
        m, l, o = _fold(qf, k, v, m, l, o, scale)
        k_blk, v_blk = k, v
        for _ in range(n - 1):
            k_blk, v_blk = exchange(k_blk, group), exchange(v_blk, group)
            m, l, o = _fold(qf, k_blk, v_blk, m, l, o, scale)
        out = o / l[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.group, ctx.scale = group, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        kf = all_gather_cat(k, 1, group).float()
        vf = all_gather_cat(v, 1, group).float()
        qf, gf = q.float(), g.float()
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kf) * scale
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bqhd,bkhd->bqhk", gf, vf)
        delta = (gf * out).sum(-1)
        ds = p * (dp - delta[..., None]) * scale
        dq = torch.einsum("bqhk,bkhd->bqhd", ds, kf)
        # each rank's contribution to every key, summed over the group
        dkv = all_sum(torch.stack([torch.einsum("bqhk,bqhd->bkhd", ds, qf),
                                   torch.einsum("bqhk,bqhd->bkhd", p, gf)]),
                      group)
        i, sl = group_index(group), k.shape[1]
        dk, dv = dkv.narrow(2, i * sl, sl)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


def ring_sdpa(q, k, v, group, scale: float | None = None):
    """Ring attention: rotate K/V blocks around `group`, folding each into
    an online softmax. q, k, v: (B, S_local, H, D); returns (B, S_local, H,
    D) in q's dtype."""
    calls["ring_sdpa"] += 1
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    return _Ring.apply(q, k, v, group, scale)
