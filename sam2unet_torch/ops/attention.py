"""Scaled dot-product attention over (B, S, heads, head_dim): the backend
switch of the JAX package's `ops/attention.py` and its einsum form.

`sdpa(q, k, v, impl="auto", scale=None, key_valid=None)` routes as the JAX
package's `sdpa` does (ops/attention.py:31-70 there):
  - "auto": the einsum form, except unmasked attention over more than 1024
    keys, which goes to "pallas";
  - "pallas": `flash_attention.dispatch_attention`, the port's copy of the
    JAX package's `_dispatch_fwd`: K14 (`full_attention`) up to 1024 keys,
    K10 (`flash_attention`) past that where 16-aligned blocks divide both
    lengths, else the einsum form;
  - "einsum": `einsum_attention`, plain PyTorch;
  - "xla": the JAX package calls `jax.nn.dot_product_attention`, which runs
    no Pallas kernel; the port computes the einsum form there.
A `key_valid` mask forces the einsum form, the only one that carries it.
`set_attention_impl` forces a backend for every call (None for the
callers' own), as the JAX package's does.

The einsum form: fp32 scores and softmax, probabilities cast to the value
dtype for the output product (accumulated in fp32), as the reference's
`_xla_attention` and `attention_with_padkey`.
"""

from __future__ import annotations

import math

import torch

_FORCE_IMPL: str | None = None
IMPLS = ("auto", "einsum", "xla", "pallas")
MAX_FULL_SEQ = 1024   # keys past which "auto" leaves the einsum form


def set_attention_impl(impl: str | None) -> None:
    """Force a backend globally ("einsum" | "xla" | "pallas" | None)."""
    global _FORCE_IMPL
    if impl is not None and impl not in IMPLS:
        raise ValueError(f"unknown attention backend {impl!r} (have {IMPLS})")
    _FORCE_IMPL = impl


def einsum_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float | None = None,
                     key_valid: torch.Tensor | None = None) -> torch.Tensor:
    """The einsum form; `key_valid` (B, Sk) bool drops the keys it marks
    False (logit -1e9, flash_attention.py:377-379 of the JAX package)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if key_valid is not None:
        s = torch.where(key_valid[:, None, None, :], s, -1e9)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         impl: str = "auto", scale: float | None = None,
         key_valid: torch.Tensor | None = None) -> torch.Tensor:
    if _FORCE_IMPL is not None:
        impl = _FORCE_IMPL
    if impl not in IMPLS:
        raise ValueError(f"unknown attention backend {impl!r} (have {IMPLS})")
    if impl == "auto":
        impl = ("pallas" if key_valid is None and k.shape[1] > MAX_FULL_SEQ
                else "einsum")
    if key_valid is not None:
        impl = "einsum"
    if impl == "pallas":
        from sam2unet_torch.ops.flash_attention import dispatch_attention

        return dispatch_attention(q, k, v, scale)
    return einsum_attention(q, k, v, scale, key_valid)


def attention_with_padkey(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          k_pad: torch.Tensor, v_pad: torch.Tensor,
                          n_pad: int | None = None, scale: float | None = None,
                          attn_mask: torch.Tensor | None = None,
                          pad_logmult: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Attention over valid tokens plus ONE synthetic pad key per head (the
    JAX package's `attention_with_padkey`, flash_attention.py:390-429).

    The reference zero-pads windows; every pad token projects to the qkv
    bias, so the n_pad identical pad keys collapse under softmax to one key
    with logit q.k_pad*scale + ln(n_pad) and value v_pad. k_pad/v_pad:
    (heads, head_dim), rounded to the working dtype. Exactly one of
    `n_pad` (shared multiplicity) and `pad_logmult` ((1, S) additive
    per-query log-multiplicity, -1e30 where a query's window has no pads)
    is given; `attn_mask` ((S, S) additive, the whole-grid window mask of
    `grid_window_mask`) applies to the real keys."""
    if (n_pad is None) == (pad_logmult is None):
        raise ValueError("pass exactly one of n_pad and pad_logmult")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    if attn_mask is not None:
        s = s + attn_mask.float()[None, :, None, :]
    s_pad = torch.einsum("bqhd,hd->bqh", q.float(),
                         k_pad.to(q.dtype).float()) * scale
    if pad_logmult is not None:
        s_pad = s_pad + pad_logmult.float().reshape(-1)[None, :, None]
    else:
        s_pad = s_pad + math.log(n_pad)
    p = torch.softmax(torch.cat([s, s_pad[..., None]], dim=-1), dim=-1)
    out = torch.einsum("bqhk,bkhd->bqhd", p[..., :-1].to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out + p[..., -1:].to(v.dtype) * v_pad.to(v.dtype)
