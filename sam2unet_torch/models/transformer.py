"""SAM's two-way transformer and the memory attention's RoPE attention
(sam2/modeling/sam/transformer.py:30-332; the JAX package's
`models/transformer.py`), attention in the (B, S, heads, d)
layout through the port's `sdpa`, so its backend switch applies here as in
the JAX package: under "auto" the token attentions run the einsum form and
the token-to-image attentions (4096 keys at 1024 px) K10 where 16-aligned
blocks divide both lengths (16 tokens), the einsum form otherwise; under
"pallas" every attention over at most 1024 keys runs K14.

`RoPEAttention` routes the same way: the memory attention's
self-attention (one head of 256 over the 4096 tokens of a 1024-px frame)
runs K10; its cross-attention to the memory bank carries `key_valid`, which
only the einsum form takes.

LayerNorm eps is 1e-6, as in the JAX package (flax's default).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from sam2unet_torch.models.position_encoding import (
    apply_rotary_enc,
    axial_rope_cos_sin,
)
from sam2unet_torch.nn.layers import LN_EPS, MLP
from sam2unet_torch.ops.attention import sdpa


class Attention(nn.Module):
    """Multi-head attention with an optional internal downsampling of the
    width (transformer.py:201-265)."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 downsample_rate: int = 1):
        super().__init__()
        internal = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embedding_dim, internal)
        self.k_proj = nn.Linear(embedding_dim, internal)
        self.v_proj = nn.Linear(embedding_dim, internal)
        self.out_proj = nn.Linear(internal, embedding_dim)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.reshape(b, n, self.num_heads, c // self.num_heads)

    def forward(self, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
        o = sdpa(self._heads(self.q_proj(q)), self._heads(self.k_proj(k)),
                 self._heads(self.v_proj(v)))
        b, n, h, d = o.shape
        return self.out_proj(o.reshape(b, n, h * d))


class RoPEAttention(nn.Module):
    """Attention with the axial 2-D rotary embedding of a square query grid
    (transformer.py:268-332), theta 10000. The angles follow the runtime
    token count, as the reference recomputes them when its cached
    `feat_sizes` table does not match; they are built once per grid and
    kept on the device. The last `num_k_exclude_rope` keys (the object
    pointers) are not rotated; with `rope_k_repeat` the angles tile the
    memory's grids."""

    def __init__(self, embedding_dim: int, num_heads: int,
                 kv_in_dim: int | None = None, rope_k_repeat: bool = False):
        super().__init__()
        kv = kv_in_dim or embedding_dim
        self.num_heads, self.rope_k_repeat = num_heads, rope_k_repeat
        self.q_proj = nn.Linear(embedding_dim, embedding_dim)
        self.k_proj = nn.Linear(kv, embedding_dim)
        self.v_proj = nn.Linear(kv, embedding_dim)
        self.out_proj = nn.Linear(embedding_dim, embedding_dim)
        self._rope: dict[tuple, tuple[torch.Tensor, torch.Tensor]] = {}

    def _rope_table(self, dim: int, side: int, device: torch.device):
        key = (dim, side, device)
        if key not in self._rope:
            with torch.inference_mode(False):   # usable outside it too
                self._rope[key] = tuple(
                    torch.from_numpy(t).to(device)
                    for t in axial_rope_cos_sin(dim, side, side))
        return self._rope[key]

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                num_k_exclude_rope: int = 0,
                key_valid: torch.Tensor | None = None) -> torch.Tensor:
        b, nq, _ = q.shape
        nk, h = k.shape[1], self.num_heads
        q = self.q_proj(q).reshape(b, nq, h, -1)
        k = self.k_proj(k).reshape(b, nk, h, -1)
        v = self.v_proj(v).reshape(b, nk, h, -1)
        side = math.isqrt(nq)
        if side * side != nq:
            raise ValueError(f"RoPE needs a square token grid, got {nq}")
        cos, sin = self._rope_table(q.shape[-1], side, q.device)
        n_rope = nk - num_k_exclude_rope
        q, k_rot = apply_rotary_enc(q, k[:, :n_rope], cos, sin,
                                    self.rope_k_repeat)
        k = torch.cat([k_rot, k[:, n_rope:]], 1) if num_k_exclude_rope else k_rot
        o = sdpa(q, k, v, key_valid=key_valid)
        return self.out_proj(o.reshape(b, nq, -1))


class TwoWayAttentionBlock(nn.Module):
    """(transformer.py:123-198)."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int = 2048,
                 attention_downsample_rate: int = 2,
                 skip_first_layer_pe: bool = False):
        super().__init__()
        d, r = embedding_dim, attention_downsample_rate
        self.self_attn = Attention(d, num_heads)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn_token_to_image = Attention(d, num_heads, r)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.mlp = MLP(d, mlp_dim, d, num_layers=2)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.norm4 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn_image_to_token = Attention(d, num_heads, r)
        self.skip_first_layer_pe = skip_first_layer_pe

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    """(transformer.py:30-120). image_embedding (B, H, W, C), image_pe
    (1 or B, H, W, C), point_embedding (B, N, C)."""

    def __init__(self, depth: int, embedding_dim: int, num_heads: int,
                 mlp_dim: int, attention_downsample_rate: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(depth))
        self.final_attn_token_to_image = Attention(
            embedding_dim, num_heads, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_dim, eps=LN_EPS)

    def forward(self, image_embedding, image_pe, point_embedding):
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
