"""The memory encoder and the memory attention of SAM2's video tracker
(sam2/modeling/memory_encoder.py:17-181, memory_attention.py:17-169; the JAX
package's `models/memory.py`), with the reference's state-dict names.

Image features and memories are NHWC, tokens batch-first (B, S, C); the
convolutions run in NCHW views of them. LayerNorm eps is 1e-6 throughout,
as in the JAX package (flax's default), and GELU is the exact erf form.
The memory encoder's sine encoding is computed once per grid and kept on
the device (`PositionEmbeddingSine`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sam2unet_torch.models.position_encoding import PositionEmbeddingSine
from sam2unet_torch.models.transformer import RoPEAttention
from sam2unet_torch.nn.layers import LN_EPS, Conv2d, LayerNorm2d, gelu


class MaskDownSampler(nn.Module):
    """Strided conv, channel LayerNorm and GELU, repeated to a total stride
    of `total_stride`, then a 1x1 conv to `embed_dim`
    (memory_encoder.py:17-58); `encoder` keeps the reference's indices."""

    def __init__(self, embed_dim: int = 256, kernel_size: int = 4,
                 stride: int = 4, padding: int = 0, total_stride: int = 16):
        super().__init__()
        n = int(math.log2(total_stride) // math.log2(stride))
        layers, cin = [], 1
        for _ in range(n):
            cout = cin * stride ** 2
            layers += [Conv2d(cin, cout, kernel_size, stride=stride,
                              padding=padding), LayerNorm2d(cout), nn.GELU()]
            cin = cout
        layers.append(Conv2d(cin, embed_dim, 1))
        self.encoder = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 1) -> (B, H / total_stride, W / total_stride, embed_dim)."""
        return self.encoder(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class CXBlock(nn.Module):
    """ConvNeXt block (memory_encoder.py:62-117) as the SAM2 configs build
    it: a 7x7 depthwise conv, LayerNorm, the pointwise MLP, the layer scale
    `gamma` (initialised to 1e-6), the residual."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm2d(dim)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C)."""
        y = self.norm(self.dwconv(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
        return x + self.gamma * self.pwconv2(gelu(self.pwconv1(y)))


class Fuser(nn.Module):
    """(memory_encoder.py:120-135), without the input projection no SAM2
    config turns on."""

    def __init__(self, dim: int, num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(CXBlock(dim) for _ in range(num_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


def _conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution of NHWC x, as a product over the channels."""
    return F.linear(x, conv.weight.flatten(1).to(x.dtype),
                    conv.bias.to(x.dtype))


class MemoryEncoder(nn.Module):
    """(memory_encoder.py:138-181): the downsampled mask added to the
    projected pixel features, fused, projected to `out_dim`, with its sine
    encoding. As sam2_hiera_*.yaml builds it: the mask downsampler with
    kernel 3, stride 2, padding 1 and embed_dim = in_dim, two fuser
    blocks."""

    def __init__(self, out_dim: int = 64, in_dim: int = 256):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(in_dim, kernel_size=3,
                                                stride=2, padding=1)
        self.pix_feat_proj = nn.Conv2d(in_dim, in_dim, 1)
        self.fuser = Fuser(in_dim, num_layers=2)
        self.position_encoding = PositionEmbeddingSine(out_dim)
        self.out_proj = (nn.Conv2d(in_dim, out_dim, 1) if out_dim != in_dim
                         else None)

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_mask_sigmoid: bool = False) -> dict:
        """pix_feat (B, H, W, in_dim); masks (B, 16H, 16W, 1) logits (or
        already squashed with `skip_mask_sigmoid`)."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks.float())
        masks = masks.to(pix_feat.dtype)
        x = _conv1x1(self.pix_feat_proj, pix_feat) + self.mask_downsampler(masks)
        x = self.fuser(x)
        if self.out_proj is not None:
            x = _conv1x1(self.out_proj, x)
        return {"vision_features": x,
                "vision_pos_enc": [self.position_encoding(x[:1])]}


class MemoryAttentionLayer(nn.Module):
    """RoPE self-attention, RoPE cross-attention to the memory, the FFN
    (memory_attention.py:17-99); pre-norm, batch-first (B, S, C). As the
    SAM2 configs build it: one head, the position encoding added to the
    memory's keys only."""

    def __init__(self, d_model: int = 256, dim_feedforward: int = 2048,
                 kv_in_dim: int = 64):
        super().__init__()
        self.self_attn = RoPEAttention(d_model, 1)
        self.cross_attn_image = RoPEAttention(d_model, 1, kv_in_dim=kv_in_dim,
                                              rope_k_repeat=True)
        self.linear1 = nn.Linear(d_model, dim_feedforward)
        self.linear2 = nn.Linear(dim_feedforward, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, memory, pos=None, num_k_exclude_rope: int = 0,
                memory_valid=None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        t2 = self.norm2(tgt)
        kk = memory if pos is None else memory + pos
        tgt = tgt + self.cross_attn_image(
            t2, kk, memory, num_k_exclude_rope=num_k_exclude_rope,
            key_valid=memory_valid)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    """(memory_attention.py:102-169), batch-first (B, S, C); 0.1 times the
    position encoding is added to the input (pos_enc_at_input)."""

    def __init__(self, d_model: int = 256, num_layers: int = 4,
                 dim_feedforward: int = 2048, kv_in_dim: int = 64):
        super().__init__()
        self.layers = nn.ModuleList(
            MemoryAttentionLayer(d_model, dim_feedforward, kv_in_dim)
            for _ in range(num_layers))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, curr, memory, curr_pos=None, memory_pos=None,
                num_obj_ptr_tokens: int = 0, memory_valid=None):
        output = curr
        if curr_pos is not None:
            output = output + 0.1 * curr_pos
        for layer in self.layers:
            output = layer(output, memory, pos=memory_pos,
                           num_k_exclude_rope=num_obj_ptr_tokens,
                           memory_valid=memory_valid)
        return self.norm(output)
