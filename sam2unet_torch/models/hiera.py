"""Hiera trunk (sam2/modeling/backbones/hieradet.py:170-292) with the
SAM2-UNet PEFT adapters, NHWC between blocks.

Each block picks its path from the static grid geometry, in the JAX
package's order (sam2unet_tpu/models/hiera.py:210-310):
  - dim-preserving, remainder or 16-unaligned grid with n_w >= 4 columns of
    windows (`strips_rem_supported`; hiera_s@960 stages 3-4) -> K12;
  - dim-preserving, other remainder grids (hiera_l@352 stages 3-4) -> K6
    per valid window group, with the synthetic pad key for the reference's
    zero pads;
  - dim-preserving, window-divisible 16-aligned grid -> K4 (strip kernel);
  - dim-preserving, divisible but unaligned window -> K6 on the partition;
  - global -> `fused_window_block`: K6 (S = 484 at 352), or LN -> QKV ->
    K10 -> proj where one window's scores pass the JAX package's live-VMEM
    gate (S = 3600 at 960);
  - q-pool transition on a divisible even grid -> K8 (in training only
    where the copied `transition_bwd_supported` holds and the block is
    frozen, hiera.py:318-327 there);
  - any other transition (stage 3->4 at 352 and 960) -> plain tensor code;
  - every block's LN2 -> MLP -> residual tail and every adapter -> K1.
In training (`module.training`) the remainder strips (K12) are left for the
valid groups, as the JAX package keeps them eval-only. The kernel wrappers
are differentiable: the frozen blocks' backward is K5 (strips), K7 (valid
groups with n_pad = 0, global blocks), K9 (transitions) and K2 (tails), the
adapters' is K3, and the remainder groups' pad-key blocks and the plain
transition go through autograd of the plain versions; where the JAX package
runs a backward kernel not ported yet (K11 for the 3600-token global blocks
of hiera_s@960, `unported_train_backward`) the backward raises on the card.
The trunk is frozen
as in the reference (SAM2UNet.py:146-147): every parameter but the
adapters' has requires_grad False. The drop-path rate is 0 in every SAM2
config, so drop path is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sam2unet_torch.configs import HieraConfig
from sam2unet_torch.nn.layers import LN_EPS, MLP
from sam2unet_torch.ops.attention import sdpa
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    strips_rem_supported,
    valid_group_blocks,
    window_block_bwd_route,
)
from sam2unet_torch.ops.fused_mlp import fused_mlp
from sam2unet_torch.ops.fused_transition import (
    fused_transition_block,
    transition_bwd_supported,
)
from sam2unet_torch.ops.pooling import max_pool2d
from sam2unet_torch.ops.windowing import window_partition, window_unpartition


class MultiScaleAttention(nn.Module):
    """Attention with optional 2x2 max q-pool (hieradet.py:35-81)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_stride: tuple[int, int] | None = None):
        super().__init__()
        self.dim_out, self.num_heads, self.q_stride = dim_out, num_heads, q_stride
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B', h, w, dim) windows or full grid."""
        b, h, w, _ = x.shape
        c, nh = self.dim_out, self.num_heads
        qkv = self.qkv(x)
        # channel order [3, heads, d]: q/k/v are contiguous channel blocks
        q = qkv[..., :c]
        k = qkv[..., c: 2 * c].reshape(b, h * w, nh, -1)
        v = qkv[..., 2 * c:].reshape(b, h * w, nh, -1)
        if self.q_stride is not None:
            q = max_pool2d(q, self.q_stride[0], self.q_stride[0])
            h, w = q.shape[1], q.shape[2]
        o = sdpa(q.reshape(b, h * w, nh, -1), k, v)
        return self.proj(o.reshape(b, h, w, c))


class MultiScaleBlock(nn.Module):
    """Pre-norm windowed attention block (hieradet.py:84-167)."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 window_size: int, q_stride: tuple[int, int] | None = None,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.dim, self.dim_out, self.num_heads = dim, dim_out, num_heads
        self.window_size, self.q_stride = window_size, q_stride
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(dim, dim_out, num_heads, q_stride)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.norm2 = nn.LayerNorm(dim_out, eps=LN_EPS)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out)

    def _attn_args(self):
        a = self.attn
        return (a.qkv.weight, a.qkv.bias, self.norm1.weight, self.norm1.bias,
                a.proj.weight, a.proj.bias)

    def frozen(self) -> bool:
        return not any(p.requires_grad for p in self.parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        window = self.window_size
        train = self.training
        if self.dim == self.dim_out:
            args = self._attn_args()
            nh = self.num_heads
            if strips_rem_supported(h, w, window, train):
                x = fused_window_block_strips_rem(x, *args, num_heads=nh,
                                                  window=window)
            elif window > 0 and (h % window or w % window):
                x = valid_group_blocks(fused_window_block, x, *args,
                                       num_heads=nh, window=window)
            elif window > 0 and (window * window) % 16 == 0:
                x = fused_window_block_strips(x, *args, num_heads=nh,
                                              window=window)
            elif window > 0:
                xw, pad_hw = window_partition(x, window)
                nw_ = xw.shape[0]
                o = fused_window_block(xw.reshape(nw_, window * window, c),
                                       *args, num_heads=nh)
                x = window_unpartition(o.reshape(nw_, window, window, c),
                                       window, pad_hw, (h, w))
            else:
                x = fused_window_block(x.reshape(b, h * w, c), *args,
                                       num_heads=nh).reshape(b, h, w, c)
        elif (self.q_stride == (2, 2) and window > 0 and window % 2 == 0
              and (window * window) % 16 == 0
              and h % window == 0 and w % window == 0
              and (not train or (self.frozen() and transition_bwd_supported(
                  window, self.dim_out, w, self.dim)))):
            x = fused_transition_block(
                x, *self._attn_args(), self.proj.weight, self.proj.bias,
                num_heads=self.num_heads, window=window)
        else:
            x = self._unfused(x)
        m = self.mlp.layers
        return fused_mlp(x, m[0].weight, m[0].bias, m[1].weight, m[1].bias,
                         ln_w=self.norm2.weight, ln_b=self.norm2.bias,
                         residual=True)

    def _unfused(self, x: torch.Tensor) -> torch.Tensor:
        """Plain q-pool / dim-change branch (hiera.py:361-383)."""
        h, w = x.shape[1], x.shape[2]
        window = self.window_size
        xn = self.norm1(x)
        shortcut = self.proj(xn)
        if self.q_stride is not None:
            shortcut = max_pool2d(shortcut, self.q_stride[0], self.q_stride[0])
        if window > 0:
            xn, pad_hw = window_partition(xn, window)
        y = self.attn(xn)
        if self.q_stride is not None:
            if window > 0:
                window = window // self.q_stride[0]
                h2, w2 = shortcut.shape[1], shortcut.shape[2]
                pad_h = (window - h2 % window) % window
                pad_w = (window - w2 % window) % window
                y = window_unpartition(y, window, (h2 + pad_h, w2 + pad_w),
                                       (h2, w2))
        elif window > 0:
            y = window_unpartition(y, window, pad_hw, (h, w))
        return (shortcut + y).contiguous()


class AdapterBlock(nn.Module):
    """PEFT wrapper: x + prompt_learn(x) fed to the frozen block
    (SAM2UNet.py:52-65; keys `blocks.N.prompt_learn.*`, `blocks.N.block.*`)."""

    def __init__(self, block: MultiScaleBlock, adapter_dim: int = 32):
        super().__init__()
        dim = block.dim
        self.prompt_learn = nn.Sequential(
            nn.Linear(dim, adapter_dim), nn.GELU(),
            nn.Linear(adapter_dim, dim), nn.GELU())
        self.block = block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.prompt_learn
        xa = fused_mlp(x, p[0].weight, p[0].bias, p[2].weight, p[2].bias,
                       residual=True, gelu_out=True)
        return self.block(xa)


def _block_plan(cfg: HieraConfig) -> list[dict]:
    """Static per-block hyperparameters (hieradet.py:232-260). A stage's
    first block uses the PREVIOUS stage's window: the window is read before
    the stage counter moves."""
    plan = []
    embed_dim, num_heads, cur_stage = cfg.embed_dim, cfg.num_heads, 1
    for i in range(cfg.depth):
        dim_out = embed_dim
        window_size = cfg.window_spec[cur_stage - 1]
        if cfg.global_att_blocks and i in cfg.global_att_blocks:
            window_size = 0
        if i - 1 in cfg.stage_ends:
            dim_out = int(embed_dim * cfg.dim_mul)
            num_heads = int(num_heads * cfg.head_mul)
            cur_stage += 1
        plan.append(dict(
            dim=embed_dim, dim_out=dim_out, num_heads=num_heads,
            window_size=window_size,
            q_stride=cfg.q_stride if i in cfg.q_pool_blocks else None,
            mlp_ratio=cfg.mlp_ratio))
        embed_dim = dim_out
    return plan


def unported_train_backward(cfg: HieraConfig, size: int) -> list[str]:
    """The global blocks whose backward, with the trunk frozen and input
    `size`, the JAX package runs through a kernel the port has not ported
    yet (K11 past 1024 tokens: hiera_s@960's three 3600-token blocks), one
    line each; empty where training runs on the port's kernels (hiera_l@352)."""
    h = w = -(-size // 4)
    out = []
    for i, bk in enumerate(_block_plan(cfg)):
        if bk["window_size"] == 0 and bk["dim"] == bk["dim_out"]:
            route = window_block_bwd_route(h * w, bk["dim"], 0, False)
            if route not in ("K7", "plain"):
                out.append(f"block {i}: global attention over {h * w} "
                           f"tokens at width {bk['dim']} needs {route}")
        if bk["q_stride"] is not None:
            h, w = h // bk["q_stride"][0], w // bk["q_stride"][1]
    return out


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 7, stride=4, padding=3)


class Hiera(nn.Module):
    """The trunk: NHWC image -> the 4 stage-end maps (strides 4/8/16/32),
    NHWC, fine to coarse."""

    def __init__(self, cfg: HieraConfig, adapter_dim: int = 32):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.embed_dim)
        bh, bw = cfg.window_pos_embed_bkg_spatial_size
        win0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, bh, bw))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, cfg.embed_dim, win0, win0))
        self.blocks = nn.ModuleList(
            AdapterBlock(MultiScaleBlock(**bk), adapter_dim)
            for bk in _block_plan(cfg))
        # adapters imply the reference's hard trunk freeze
        for name, p in self.named_parameters():
            if "prompt_learn" not in name.split("."):
                p.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        h, w = x.shape[2], x.shape[3]
        pe = F.interpolate(self.pos_embed, size=(h, w), mode="bicubic",
                           align_corners=False)
        win = self.pos_embed_window
        pe = pe + win.tile(1, 1, h // win.shape[2], w // win.shape[3])
        x = (x + pe).permute(0, 2, 3, 1).contiguous()
        outputs = []
        ends = self.cfg.stage_ends
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in ends:
                outputs.append(x)
        return outputs
