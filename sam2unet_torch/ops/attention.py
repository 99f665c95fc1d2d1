"""Plain scaled dot-product attention over (B, S, heads, head_dim).

fp32 scores and softmax, probabilities cast to the value dtype for the
output product (accumulated in fp32), as the reference's einsum form
(`_xla_attention`, `attention_with_padkey`)."""

from __future__ import annotations

import math

import torch


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         scale: float | None = None) -> torch.Tensor:
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def attention_with_padkey(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_pad: torch.Tensor, v_pad: torch.Tensor,
                          n_pad: int, scale: float | None = None
                          ) -> torch.Tensor:
    """Attention over valid tokens plus ONE synthetic pad key per head.

    The reference zero-pads windows; every pad token projects to the qkv
    bias, so the n_pad identical pad keys collapse under softmax to one key
    with logit q.k_pad*scale + ln(n_pad) and value v_pad. k_pad/v_pad:
    (heads, head_dim), rounded to the working dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    s_pad = torch.einsum("bqhd,hd->bqh", q.float(),
                         k_pad.to(q.dtype).float()) * scale
    s_pad = s_pad + math.log(n_pad)
    p = torch.softmax(torch.cat([s, s_pad[..., None]], dim=-1), dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p[..., :-1].to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out + p[..., -1:].to(v.dtype) * v_pad.to(v.dtype)
