"""Hiera trunk (sam2/modeling/backbones/hieradet.py:170-292) with the
SAM2-UNet PEFT adapters, NHWC between blocks.

Each block picks its path from the static grid geometry, in the JAX
package's order (sam2unet_tpu/models/hiera.py:210-466):
  - dim-preserving, remainder or 16-unaligned grid that passes the JAX
    package's remainder-strip gate (`strips_rem_supported`: n_w >= 4 columns
    of windows and its VMEM estimate; hiera_s@960 stages 3-4 in eval) ->
    K12, outside training only;
  - dim-preserving, other remainder grids (hiera_l@352 stages 3-4, every
    remainder grid in training) -> the persistent valid-group layout
    (`ops/grouped.py`, `_groupable_block`): the Hiera loop partitions the
    tokens into pad-free window groups once at the start of a run of such
    blocks and merges them once at its end; inside the run each block runs
    K6 once per group (with the synthetic pad key of the group's n_pad), a
    global block joins the run over the concatenated tokens, and the block
    tail and the adapter run K1 once per group;
  - dim-preserving, window-divisible 16-aligned grid -> K4 (strip kernel);
  - dim-preserving, divisible but unaligned window, with the layout off ->
    K6 on the partition;
  - global -> `fused_window_block`: K6 (S = 484 at 352), or where one
    window's scores pass the JAX package's live-VMEM gate LN -> QKV -> K10
    -> proj past 1024 tokens (S = 3600 at 960) and the plain form up to
    1024 (S = 1024 at 512);
  - q-pool transition on a divisible even grid -> K8 (in training only
    where the copied `transition_bwd_supported` holds and the block is
    frozen, hiera.py:318-327 there);
  - any other transition (stage 3->4 at 352 and 960) -> plain tensor code;
  - every other block's LN2 -> MLP -> residual tail and adapter -> K1.
SAM2UNET_DISABLE_GROUPED=1 (the JAX package's switch, same name and
meaning) partitions and merges around each block instead, for A/Bs. The
kernel wrappers are differentiable: the frozen blocks' backward is K5
(strips), K7 (window groups with n_pad = 0, global blocks up to 1024
tokens), the long form's backward over K11 (the 3600-token global blocks of
hiera_s@960), K9 (transitions) and K2 (tails), the adapters' is K3, all per
group inside a grouped run, and the pad-key groups and the plain transition
go through autograd of the plain versions; where the JAX package runs a
backward kernel not ported yet (K7's weight-gradient mode,
`unported_train_backward`) the backward raises on the card. With adapters
the trunk is frozen as in the reference (SAM2UNet.py:146-147): every
parameter but the adapters' has requires_grad False. The drop-path rate is
0 in every SAM2 config, so drop path is the identity. `remat=True` runs each
block under `torch.utils.checkpoint`, the counterpart of the JAX package's
`nn.remat` per block: the block's activations are recomputed in the
backward instead of kept. SAM2's own trunk (`use_adapters=False`) has the
same blocks without the adapters and is not frozen.

Sequence parallelism (the JAX package's `sp_axis` / `sp_degree`,
hiera.py:164-205 there): `Hiera(sp_group=group, sp_degree=n)`, inside a
process group of n ranks that hold the same rows, runs each global block
whose grid splits over the n ranks (dim-preserving, h * w divisible by n)
as plain LN in fp32 -> QKV -> `ops/sp_attention.ring_sdpa` on this rank's
slice of the tokens -> the slices gathered along the tokens -> proj ->
residual, then the block's tail. With it the persistent window-group layout
is off, as in the JAX package, so the window blocks take their per-block
routes. The state-dict keys do not change.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sam2unet_torch.configs import HieraConfig
from sam2unet_torch.nn.layers import LN_EPS, MLP, gelu, layer_norm_plain
from sam2unet_torch.ops import sp_attention
from sam2unet_torch.ops.attention import sdpa
from sam2unet_torch.ops.fused_attention_block import (
    fused_window_block,
    fused_window_block_strips,
    fused_window_block_strips_rem,
    strips_rem_supported,
    valid_group_blocks,
    window_block_bwd_route,
)
from sam2unet_torch.ops.fused_mlp import fused_ln_matmul, fused_mlp
from sam2unet_torch.ops.fused_transition import (
    fused_transition_block,
    transition_bwd_supported,
)
from sam2unet_torch.ops.grouped import GroupedTokens
from sam2unet_torch.ops.pooling import max_pool2d
from sam2unet_torch.ops.windowing import window_partition, window_unpartition


class MultiScaleAttention(nn.Module):
    """Attention with optional 2x2 max q-pool (hieradet.py:35-81), split as
    the JAX module is (sam2unet_tpu/models/hiera.py:34-117): `project_qkv`
    (with the block's pre-norm fused in, K15, where its LN parameters are
    given), `attend` (q-pool, attention, `project_out`). No model passes
    the LN: the blocks run their own fused routes."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_stride: tuple[int, int] | None = None):
        super().__init__()
        self.dim_out, self.num_heads, self.q_stride = dim_out, num_heads, q_stride
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def project_qkv(self, x: torch.Tensor, ln_w=None, ln_b=None,
                    add_bias: bool = True) -> torch.Tensor:
        """x: (..., dim) -> (..., 3 * dim_out); with `ln_w` / `ln_b` the
        pre-norm LN(x) first, through `fused_ln_matmul` (K15).
        `add_bias=False` leaves the projection's bias to `attend`."""
        if ln_w is not None:
            return fused_ln_matmul(x, self.qkv.weight, self.qkv.bias, ln_w,
                                   ln_b, add_bias)
        return F.linear(x, self.qkv.weight,
                        self.qkv.bias if add_bias else None)

    def attend(self, qkv: torch.Tensor, bias=None) -> torch.Tensor:
        """qkv: (B', h, w, 3 * dim_out), windows or full grid; `bias` the
        projection's bias where `project_qkv` left it out."""
        b, h, w, _ = qkv.shape
        c, nh = self.dim_out, self.num_heads
        if bias is not None:
            qkv = qkv + bias.to(qkv.dtype)
        # channel order [3, heads, d]: q/k/v are contiguous channel blocks
        q = qkv[..., :c]
        k = qkv[..., c: 2 * c].reshape(b, h * w, nh, -1)
        v = qkv[..., 2 * c:].reshape(b, h * w, nh, -1)
        if self.q_stride is not None:
            q = max_pool2d(q, self.q_stride[0], self.q_stride[0])
            h, w = q.shape[1], q.shape[2]
        o = sdpa(q.reshape(b, h * w, nh, -1), k, v)
        return self.project_out(o.reshape(b, h, w, c))

    def project_out(self, o: torch.Tensor) -> torch.Tensor:
        return self.proj(o)

    def forward(self, x: torch.Tensor, ln_w=None, ln_b=None) -> torch.Tensor:
        """x: (B', h, w, dim) windows or full grid; with `ln_w` / `ln_b`
        the block's pre-norm applied first (K15)."""
        return self.attend(self.project_qkv(x, ln_w, ln_b))


class MultiScaleBlock(nn.Module):
    """Pre-norm windowed attention block (hieradet.py:84-167)."""

    # the sequence-parallel group and its size (`Hiera`, global blocks)
    sp_group = None
    sp_degree = 1

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
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out,
                       activation=gelu)

    def _attn_args(self):
        a = self.attn
        return (a.qkv.weight, a.qkv.bias, self.norm1.weight, self.norm1.bias,
                a.proj.weight, a.proj.bias)

    def frozen(self) -> bool:
        return not any(p.requires_grad for p in self.parameters())

    def forward(self, x):
        if isinstance(x, GroupedTokens):
            return self._grouped(x)
        b, h, w, c = x.shape
        window = self.window_size
        train = self.training
        if (self.sp_group is not None and window == 0
                and self.dim == self.dim_out and (h * w) % self.sp_degree == 0):
            x = self._sequence_parallel(x)
        elif self.dim == self.dim_out:
            args = self._attn_args()
            nh = self.num_heads
            rem_grid = window > 0 and (h % window or w % window
                                       or (window * window) % 16)
            if rem_grid and not train and strips_rem_supported(
                    h, w, window, c, nh, x.dtype.itemsize):
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
        return self._tail(x)

    def _sequence_parallel(self, x: torch.Tensor) -> torch.Tensor:
        """The global attention with its tokens split over `sp_group`
        (hiera.py:170-205 there): LN in fp32 -> QKV -> ring attention of
        this rank's token slice -> every rank's slice gathered -> proj ->
        + x, in x's dtype."""
        b, h, w, c = x.shape
        a, nh, group = self.attn, self.num_heads, self.sp_group
        xn = layer_norm_plain(x, self.norm1.weight, self.norm1.bias)
        qkv = F.linear(xn, a.qkv.weight.to(x.dtype), a.qkv.bias.to(x.dtype))
        sl = h * w // self.sp_degree
        i0 = sp_attention.group_index(group) * sl
        q, k, v = (qkv[..., j * c: (j + 1) * c].reshape(b, h * w, nh, -1)
                   [:, i0: i0 + sl] for j in range(3))
        o = sp_attention.gather_tokens(
            sp_attention.ring_sdpa(q, k, v, group), group)
        y = F.linear(o.reshape(b, h, w, c), a.proj.weight.to(x.dtype),
                     a.proj.bias.to(x.dtype))
        return x + y

    def _tail(self, x: torch.Tensor) -> torch.Tensor:
        m = self.mlp.layers
        return fused_mlp(x, m[0].weight, m[0].bias, m[1].weight, m[1].bias,
                         ln_w=self.norm2.weight, ln_b=self.norm2.bias,
                         residual=True)

    def _grouped(self, x: GroupedTokens) -> GroupedTokens:
        """The dim-preserving block over the persistent window groups
        (hiera.py:415-466 there): K6 once per group with its n_pad; a global
        block over the concatenated tokens (attention is equivariant under
        their order), split back; the tail once per group."""
        args, nh = self._attn_args(), self.num_heads
        if self.window_size == 0:
            x = x.split_tokens(fused_window_block(x.concat_tokens(), *args,
                                                  num_heads=nh))
        else:
            x = x.with_groups(
                fused_window_block(g, *args, num_heads=nh, n_pad=n_pad)
                for g, n_pad in zip(x.groups, x.n_pads))
        return x.with_groups(self._tail(g) for g in x.groups)

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

    def forward(self, x):
        p = self.prompt_learn

        def adapter(t):
            return fused_mlp(t, p[0].weight, p[0].bias, p[2].weight,
                             p[2].bias, residual=True, gelu_out=True)
        if isinstance(x, GroupedTokens):
            # per token: once per window group, the layout kept
            return self.block(x.with_groups(adapter(g) for g in x.groups))
        return self.block(adapter(x))


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


def _groupable_block(bk: dict, h: int, w: int, itemsize: int,
                     train: bool) -> bool:
    """Whether a block runs on the persistent `GroupedTokens` layout (the
    JAX package's `_groupable_block`, hiera.py:509-537): dim-preserving, no
    active drop path in training, and a window geometry that neither the
    strip kernel (a divisible 16-aligned grid) nor, outside training, the
    remainder strips take. Global blocks join any run."""
    if bk["dim"] != bk["dim_out"] or bk["q_stride"] is not None:
        return False
    if train and bk.get("drop_path", 0.0) > 0.0:
        return False
    window = bk["window_size"]
    if window == 0:
        return True
    if h % window == 0 and w % window == 0 and (window * window) % 16 == 0:
        return False
    return train or not strips_rem_supported(h, w, window, bk["dim"],
                                             bk["num_heads"], itemsize)


def _checkpointed(blk: nn.Module, x):
    """`blk(x)` under `torch.utils.checkpoint`. A `GroupedTokens` crosses
    as its group tensors, so autograd reaches the adapters through each."""
    if not isinstance(x, GroupedTokens):
        return checkpoint(blk, x, use_reentrant=False)
    out = {}

    def run(*groups):
        y = blk(x.with_groups(groups))
        out["layout"] = y
        return y.groups
    groups = checkpoint(run, *x.groups, use_reentrant=False)
    return out["layout"].with_groups(groups)


def unported_train_backward(cfg: HieraConfig, size: int,
                            frozen: bool = True) -> list[str]:
    """The global blocks whose backward, at input `size`, the JAX package
    runs through a kernel the port has not ported yet (K7's weight-gradient
    mode, for a trunk that is not frozen), one line each; empty where
    training runs on the port's kernels (hiera_l@352 and, through K11,
    hiera_s@960, with the trunk frozen)."""
    h = w = -(-size // 4)
    out = []
    for i, bk in enumerate(_block_plan(cfg)):
        if bk["window_size"] == 0 and bk["dim"] == bk["dim_out"]:
            route = window_block_bwd_route(h * w, bk["dim"], 0, not frozen)
            if route not in ("K7", "K11", "plain"):
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
    NHWC, fine to coarse.

    `use_adapters` (the JAX package's Hiera, hiera.py:578,640-650 there)
    wraps each block in an `AdapterBlock` (keys `blocks.N.block.*` and
    `blocks.N.prompt_learn.*`) and freezes every parameter but the
    adapters', as SAM2-UNet does; without it the blocks are plain
    `MultiScaleBlock`s (keys `blocks.N.*`, SAM2's own trunk) and nothing is
    frozen. `sp_group` / `sp_degree`: sequence parallelism of the global
    blocks over a process group of that size (module docstring)."""

    def __init__(self, cfg: HieraConfig, use_adapters: bool = False,
                 adapter_dim: int = 32, remat: bool = False,
                 sp_group=None, sp_degree: int = 1):
        super().__init__()
        self.cfg = cfg
        self.remat = remat
        self.sp_group = sp_group
        self.patch_embed = PatchEmbed(cfg.embed_dim)
        bh, bw = cfg.window_pos_embed_bkg_spatial_size
        win0 = cfg.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.embed_dim, bh, bw))
        self.pos_embed_window = nn.Parameter(
            torch.zeros(1, cfg.embed_dim, win0, win0))
        self.plan = _block_plan(cfg)
        blocks = [MultiScaleBlock(**bk) for bk in self.plan]
        if sp_group is not None:
            for blk in blocks:
                if blk.window_size == 0:
                    blk.sp_group, blk.sp_degree = sp_group, sp_degree
        self.blocks = nn.ModuleList(
            AdapterBlock(blk, adapter_dim) if use_adapters else blk
            for blk in blocks)
        if use_adapters:
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
        remat = self.remat and torch.is_grad_enabled()
        # the persistent window-group layout (hiera.py:611-657 there): enter
        # it at a groupable windowed block, keep it while the blocks are
        # groupable at its window (or global), leave it at a stage end
        grouping = (self.sp_group is None
                    and not os.environ.get("SAM2UNET_DISABLE_GROUPED"))
        itemsize, train = x.dtype.itemsize, self.training
        for i, (bk, blk) in enumerate(zip(self.plan, self.blocks)):
            grouped = isinstance(x, GroupedTokens)
            h, w = (x.h, x.w) if grouped else (x.shape[1], x.shape[2])
            g_ok = grouping and _groupable_block(bk, h, w, itemsize, train)
            if grouped and not (g_ok and bk["window_size"] in (0, x.window)):
                x = x.to_dense()
            elif not grouped and g_ok and bk["window_size"] > 0:
                x = GroupedTokens.from_dense(x, bk["window_size"])
            x = _checkpointed(blk, x) if remat else blk(x)
            if i in ends:
                if isinstance(x, GroupedTokens):
                    x = x.to_dense()
                outputs.append(x)
        return outputs
