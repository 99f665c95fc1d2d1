"""SAM's two-way transformer (sam2/modeling/sam/transformer.py:30-265; the
JAX package's `models/transformer.py`), attention in the (B, S, heads, d)
layout through the port's `sdpa`, so its backend switch applies here as in
the JAX package: under "auto" the token attentions run the einsum form and
the token-to-image attentions (4096 keys at 1024 px) K10 where 16-aligned
blocks divide both lengths (16 tokens), the einsum form otherwise; under
"pallas" every attention over at most 1024 keys runs K14.

LayerNorm eps is 1e-6, as in the JAX package (flax's default). The
memory attention's `RoPEAttention` comes with the video predictor.
"""

from __future__ import annotations

import torch
from torch import nn

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
