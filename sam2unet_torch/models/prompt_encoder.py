"""SAM prompt encoder: points and masks -> sparse and dense embeddings
(sam2/modeling/sam/prompt_encoder.py:17-182; the JAX package's
`models/prompt_encoder.py`). NHWC. Point labels: -1 pad, 0 negative,
1 positive, 2 and 3 box corners; the image predictor merges a box into its
two corner points and appends the pad point itself, so boxes never reach
the encoder as boxes (sam2_image_predictor.py:380-388).
"""

from __future__ import annotations

import torch
from torch import nn

from sam2unet_torch.models.position_encoding import PositionEmbeddingRandom
from sam2unet_torch.nn.layers import LayerNorm2d


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int, image_embedding_size: tuple[int, int],
                 input_image_size: tuple[int, int], mask_in_chans: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim)
                                              for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        h, w = self.image_embedding_size
        self.mask_input_size = (4 * h, 4 * w)
        c4 = mask_in_chans // 4
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, c4, 2, stride=2), LayerNorm2d(c4), nn.GELU(),
            nn.Conv2d(c4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans), nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1))
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, H, W, C) encoding of the embedding grid, fp32."""
        return self.pe_layer.grid(*self.image_embedding_size)[None]

    def embed_points(self, points: torch.Tensor, labels: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
        """points (B, N, 2) pixel coordinates at the model's resolution,
        labels (B, N) -> (B, N, C)."""
        h, w = self.input_image_size
        size = torch.tensor([w, h], dtype=torch.float32, device=points.device)
        pe = self.pe_layer.encode((points.float() + 0.5) / size)
        lab = labels[..., None]
        out = torch.where(lab == -1, self.not_a_point_embed.weight.float(), pe)
        for i, emb in enumerate(self.point_embeddings):
            out = out + torch.where(lab == i, emb.weight.float(), 0.0)
        return out.to(dtype)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks (B, 4H, 4W, 1) -> (B, H, W, C)."""
        return self.mask_downscaling(masks.permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)

    def forward(self, points: torch.Tensor, labels: torch.Tensor,
                masks: torch.Tensor | None = None):
        """(sparse (B, N, C), dense (B, H, W, C)), in the working dtype (the
        mask convolutions')."""
        dtype = self.no_mask_embed.weight.dtype
        sparse = self.embed_points(points, labels, dtype)
        if masks is not None:
            return sparse, self.embed_masks(masks.to(dtype))
        h, w = self.image_embedding_size
        dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            points.shape[0], h, w, self.embed_dim)
        return sparse, dense

