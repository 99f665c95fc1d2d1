"""K10 and K11: streaming flash attention over (B, S, heads, d) with the
lse, and its backward; K14: attention over the whole key row (at most 1024
keys); and `dispatch_attention`, which picks among them. Counterpart of
sam2unet_tpu/ops/pallas/flash_attention.py (`_stream_fwd_impl`,
`_stream_bwd_impl`, `_fused_full`, `_dispatch_fwd`, oracle
`_xla_attention`); the kernels are csrc/flash_attention.cu (K10),
csrc/flash_attention_bwd.cu (K11: the delta pass, the dq pass and the dk/dv
pass) and csrc/full_attention.cu (K14).

q, k and v may be strided views, as the long global-attention blocks pass
them (channel slices of the QKV output, rows of 3c): the kernels read them
where they lie, so no copy is made, and the backward writes dq, dk and dv
through strided views too (the channel blocks of one dqkv buffer).
`flash_attention` is differentiable: on the card it is one autograd node
that keeps q, k, v, o and lse, and its backward is `flash_attention_bwd`.
"""

from __future__ import annotations

import functools
import math

import torch

from sam2unet_torch.ops import build, dispatch
from sam2unet_torch.ops.attention import MAX_FULL_SEQ, einsum_attention

MAX_HEAD_DIM = 96  # attention.cuh instantiates head dims up to 6 x 16


def plain_flash_attention(q, k, v, scale: float | None = None,
                          return_lse: bool = False):
    """Plain version: `einsum_attention` (fp32 scores and softmax,
    probabilities in the working type) and, on request, the logsumexp of the scaled fp32 scores
    as (B*heads, Sq)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o = einsum_attention(q, k, v, scale)
    if not return_lse:
        return o
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    b, h, sq, _ = s.shape
    return o, torch.logsumexp(s, dim=-1).reshape(b * h, sq)


def plain_flash_attention_delta(o, dout):
    """Plain delta pass: D = rowsum(dO * o) in fp32 as (B*heads, Sq), from
    the forward's rounded o (flash_attention.py:306 of the JAX package)."""
    b, sq, nh, _ = o.shape
    return torch.einsum("bqhd,bqhd->bhq", dout.float(),
                        o.float()).reshape(b * nh, sq)


def _plain_p_ds(q, k, v, lse, dout, delta, scale):
    """P = exp(q k^T * scale - lse) and dS = P (dO v^T - D), fp32,
    (B, heads, Sq, Sk): what both backward kernels re-form tile by tile."""
    b, sq, nh, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.exp(s - lse.reshape(b, nh, sq, 1))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    return p, p * (dp - delta.reshape(b, nh, sq, 1))


def plain_flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale: float):
    """Plain dq pass (`_stream_bwd_dq_kernel`): dq = dS k * scale, dS
    rounded to the working type before the product."""
    _, ds = _plain_p_ds(q, k, v, lse, dout, delta, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(q.dtype).float(), k.float())
    return (dq * scale).to(q.dtype)


def plain_flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale: float):
    """Plain dk/dv pass (`_stream_bwd_dkv_kernel`): dv = P^T dO and
    dk = dS^T q * scale, P and dS rounded to the working type first."""
    p, ds = _plain_p_ds(q, k, v, lse, dout, delta, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def plain_flash_attention_bwd(q, k, v, o, lse, dout,
                              scale: float | None = None):
    """Plain version of K11, the arithmetic of `_stream_bwd_impl`: (dq, dk,
    dv) from q, k, v, the forward's o and lse, and dO (no autograd)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    delta = plain_flash_attention_delta(o, dout)
    dq = plain_flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale)
    dk, dv = plain_flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale)
    return dq, dk, dv


def _check_view(t: torch.Tensor, what: str) -> None:
    if t.dim() != 4 or t.stride(-1) != 1:
        raise ValueError(f"flash_attention: {what} must be (B, S, heads, d) "
                         "with unit stride over d")
    if t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3]):
        raise ValueError(f"flash_attention: {what} needs a 16-byte aligned "
                         "base and strides that are multiples of 8 elements")


def _check_args(q, k, v, **more) -> tuple[int, int, int, int, int]:
    """What K10 and K11 take: q (B, Sq, heads, d), k and v (B, Sk, heads, d)
    with the same strides, `more` tensors shaped like q or like k (by
    name: dk, dv like k), bf16 or fp32, one device, d % 8 == 0 and
    d <= MAX_HEAD_DIM, every view addressable (`_check_view`). Returns
    (B, Sq, Sk, heads, d)."""
    b, sq, nh, d = q.shape
    sk = k.shape[1]
    if k.shape != (b, sk, nh, d) or v.shape != k.shape:
        raise ValueError("flash_attention: q, k, v shapes do not agree")
    if k.stride() != v.stride():
        raise ValueError("flash_attention: k and v need the same strides")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernels take bf16 or fp32, got {q.dtype}")
    for what, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if t.shape != (k.shape if what in ("k", "v", "dk", "dv") else q.shape):
            raise ValueError(f"flash_attention: {what} has shape "
                             f"{tuple(t.shape)}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {what} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {what} is on {t.device}, q on "
                             f"{q.device}")
        _check_view(t, what)
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel needs head dim % 8 == 0 and "
                         f"<= {MAX_HEAD_DIM}, got {d}")
    return b, sq, sk, nh, d


def _check_rows(t: torch.Tensor, what: str, q: torch.Tensor) -> None:
    """lse and D: contiguous fp32 (B*heads, Sq) on q's device."""
    b, sq, nh, _ = q.shape
    if (t.shape != (b * nh, sq) or t.dtype != torch.float32
            or not t.is_contiguous() or t.device != q.device):
        raise ValueError(f"flash_attention: {what} must be contiguous fp32 "
                         f"({b * nh}, {sq}) on {q.device}")


def _flash_attention_kernel(q, k, v, scale: float):
    """K10 on the card: (o, lse)."""
    b, sq, sk, nh, d = _check_args(q, k, v)
    o = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * nh, sq), dtype=torch.float32, device=q.device)
    p = dispatch.ptr
    err = build.library("flash_attention").k10_flash_attention(
        int(q.dtype == torch.bfloat16), p(q), p(k), p(v), p(o), p(lse), b, sq,
        sk, nh, d, *q.stride()[:3], *k.stride()[:3], scale,
        dispatch.stream_of(q))
    build.check(err, "flash_attention")
    dispatch.count_launch("flash_attention", f"S={sk}")
    return o, lse


class _FlashAttention(torch.autograd.Function):
    """K10 as one autograd node that keeps q, k, v, o and lse; its
    backward is K11."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = _flash_attention_kernel(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, go, _glse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, go.contiguous(),
                                     ctx.scale), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, return_lse: bool = False):
    """softmax(q k^T * scale) v over (B, S, heads, d) -> o (B, Sq, heads, d)
    in the working type, and with `return_lse` the (B*heads, Sq) fp32
    log-sum-exp of the scaled scores. Differentiable in q, k and v (the lse
    is not)."""
    if not dispatch.use_kernel(q):
        return plain_flash_attention(q, k, v, scale, return_lse)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dispatch.needs_grad(q, k, v):
        o, lse = _FlashAttention.apply(q, k, v, scale)
    else:
        o, lse = _flash_attention_kernel(q, k, v, scale)
    return (o, lse) if return_lse else o


# ------------------------------------------------------------- backward


def flash_attention_bwd_delta(o: torch.Tensor, dout: torch.Tensor):
    """D = rowsum(dO * o) per (batch, head, query), fp32 (B*heads, Sq)."""
    if not dispatch.use_kernel(o):
        return plain_flash_attention_delta(o, dout)
    b, sq, _, nh, d = _check_args(o, o, o, dout=dout)
    delta = torch.empty((b * nh, sq), dtype=torch.float32, device=o.device)
    p = dispatch.ptr
    err = build.library("flash_attention_bwd").k11_flash_attention_bwd_delta(
        int(o.dtype == torch.bfloat16), p(o), p(dout), p(delta), b, sq, nh, d,
        *o.stride()[:3], *dout.stride()[:3], dispatch.stream_of(o))
    build.check(err, "flash_attention_bwd_delta")
    dispatch.count_launch("flash_attention_bwd_delta", f"S={sq}")
    return delta


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale: float,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """K11's dq pass: dq (B, Sq, heads, d), written into `out` (any view
    `_check_view` passes) when given."""
    if not dispatch.use_kernel(q):
        dq = plain_flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale)
        return dq if out is None else out.copy_(dq)
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    b, sq, sk, nh, d = _check_args(q, k, v, dout=dout, dq=out)
    _check_rows(lse, "lse", q)
    _check_rows(delta, "D", q)
    p = dispatch.ptr
    err = build.library("flash_attention_bwd").k11_flash_attention_bwd_dq(
        int(q.dtype == torch.bfloat16), p(q), p(k), p(v), p(dout), p(lse),
        p(delta), p(out), b, sq, sk, nh, d, *q.stride()[:3], *k.stride()[:3],
        *dout.stride()[:3], *out.stride()[:3], scale, dispatch.stream_of(q))
    build.check(err, "flash_attention_bwd_dq")
    dispatch.count_launch("flash_attention_bwd_dq", f"S={sk}")
    return out


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale: float,
                            out: tuple[torch.Tensor, ...] | None = None):
    """K11's dk/dv pass: (dk, dv), each (B, Sk, heads, d), written into the
    two views of `out` (of equal strides) when given."""
    if not dispatch.use_kernel(q):
        dk, dv = plain_flash_attention_bwd_dkv(q, k, v, dout, lse, delta,
                                               scale)
        if out is None:
            return dk, dv
        return out[0].copy_(dk), out[1].copy_(dv)
    if out is None:
        out = (torch.empty(k.shape, dtype=k.dtype, device=k.device),
               torch.empty(k.shape, dtype=k.dtype, device=k.device))
    dk, dv = out
    b, sq, sk, nh, d = _check_args(q, k, v, dout=dout, dk=dk, dv=dv)
    if dk.stride() != dv.stride():
        raise ValueError("flash_attention: dk and dv need the same strides")
    _check_rows(lse, "lse", q)
    _check_rows(delta, "D", q)
    p = dispatch.ptr
    err = build.library("flash_attention_bwd").k11_flash_attention_bwd_dkv(
        int(q.dtype == torch.bfloat16), p(q), p(k), p(v), p(dout), p(lse),
        p(delta), p(dk), p(dv), b, sq, sk, nh, d, *q.stride()[:3],
        *k.stride()[:3], *dout.stride()[:3], *dk.stride()[:3], scale,
        dispatch.stream_of(q))
    build.check(err, "flash_attention_bwd_dkv")
    dispatch.count_launch("flash_attention_bwd_dkv", f"S={sk}")
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, dout, scale: float | None = None,
                        out: tuple[torch.Tensor, ...] | None = None):
    """K11: (dq, dk, dv) of `flash_attention` for the cotangent dO, from
    the forward's o and lse: the delta pass, the dq pass and the dk/dv pass,
    each counted where it launches (`flash_attention_bwd_delta`, `_dq`,
    `_dkv`); this function launches nothing itself.
    `out` names three views to write them into (the channel blocks of one
    dqkv buffer in the long attention block). Plain version:
    `plain_flash_attention_bwd`."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dq_out, dkv_out = (None, None) if out is None else (out[0], tuple(out[1:]))
    delta = flash_attention_bwd_delta(o, dout)
    dq = flash_attention_bwd_dq(q, k, v, dout, lse, delta, scale, dq_out)
    dk, dv = flash_attention_bwd_dkv(q, k, v, dout, lse, delta, scale, dkv_out)
    return dq, dk, dv


# ------------------------------------------------- K14 and the dispatch

# 16-aligned block sizes the JAX package's streaming kernels take
# (flash_attention.py:116-117)
_STREAM_BLOCKS = (768, 720, 640, 576, 512, 448, 400, 384, 320, 288, 256,
                  240, 224, 192, 160, 128, 96, 64, 32, 16)


def pick_stream_blocks(sq: int, sk: int) -> tuple[int, int] | None:
    """The JAX package's `_pick_stream_blocks` (flash_attention.py:120-133):
    the largest block of `_STREAM_BLOCKS` dividing each length, or None
    where one length has none (there it runs the einsum form). K10 needs no
    such blocks (it masks a ragged tile); the dispatch asks only to launch
    where the JAX package does."""

    def pick(n: int) -> int | None:
        return next((b for b in _STREAM_BLOCKS if b <= n and n % b == 0), None)

    bq, bk = pick(sq), pick(sk)
    return None if bq is None or bk is None else (bq, bk)


def plain_full_attention(q, k, v, scale: float | None = None):
    """Plain version of K14, the arithmetic of the JAX package's `_kernel`
    (flash_attention.py:47-65): fp32 scores times the scale, p = e / sum(e)
    with e = exp(s - max) in fp32, p cast to v's dtype, the product with v
    accumulated in fp32, the output in q's dtype."""
    return einsum_attention(q, k, v, scale).to(q.dtype)


def _full_attention_kernel(q, k, v, scale: float):
    b, sq, sk, nh, d = _check_args(q, k, v)
    if sk > MAX_FULL_SEQ:
        raise ValueError(f"full_attention takes at most {MAX_FULL_SEQ} keys, "
                         f"got {sk}")
    o = torch.empty((b, sq, nh, d), dtype=q.dtype, device=q.device)
    p = dispatch.ptr
    err = build.library("full_attention").k14_full_attention(
        int(q.dtype == torch.bfloat16), p(q), p(k), p(v), p(o), b, sq, sk, nh,
        d, *q.stride()[:3], *k.stride()[:3], scale, dispatch.stream_of(q))
    build.check(err, "full_attention")
    dispatch.count_launch("full_attention", f"Sq={sq},Sk={sk},d={d}")
    return o


def plain_full_attention_bwd(q, k, v, g, scale: float | None = None):
    """(dq, dk, dv) of K14 for the cotangent g: the JAX package's einsum
    recompute in this regime (`_bwd`, flash_attention.py:465-474). p is the
    fp32 softmax, never rounded to v's dtype; dv, dp and ds are fp32, each
    gradient is cast to its input's dtype at the end."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(
        torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale, dim=-1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g32).to(v.dtype)
    dp = torch.einsum("bqhd,bkhd->bhqk", g32, v32)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale).to(q.dtype)
    dk = (torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale).to(k.dtype)
    return dq, dk, dv


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float | None = None) -> torch.Tensor:
    """K14: softmax(q k^T * scale) v over (B, S, heads, d), at most 1024
    keys, o (B, Sq, heads, d) in q's dtype. q, k and v may be strided views
    (unit stride over d, 16-byte aligned, strides multiples of 8 elements),
    read where they lie. Differentiable: the backward is
    `plain_full_attention_bwd`, the JAX package's einsum recompute in this
    regime, on the card and on CPU tensors alike."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dispatch.use_kernel(q):
        fwd = functools.partial(_full_attention_kernel, scale=scale)
    else:
        fwd = functools.partial(plain_full_attention, scale=scale)
    if not dispatch.needs_grad(q, k, v):
        return fwd(q, k, v)
    return dispatch.with_backward(
        fwd, lambda saved, gy, needs: tuple(
            gr if n else None for gr, n in zip(
                plain_full_attention_bwd(*saved, gy, scale), needs)),
        q, k, v)


def dispatch_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float | None = None) -> torch.Tensor:
    """The JAX package's `_dispatch_fwd` (flash_attention.py:432-443): K14
    up to 1024 keys; past that K10 where 16-aligned blocks divide both
    lengths (`pick_stream_blocks`), else the einsum form (8 decoder tokens
    against 4096 image tokens, say). A kernel launches exactly where the
    JAX package launches one."""
    if k.shape[1] <= MAX_FULL_SEQ:
        return full_attention(q, k, v, scale)
    if pick_stream_blocks(q.shape[1], k.shape[1]) is None:
        return einsum_attention(q, k, v, scale)
    return flash_attention(q, k, v, scale)
