"""Model configuration registry (Hiera trunk variants + SAM2-UNet assembly).

Variant table (sam2_configs/sam2_hiera_{t,s,b+,l}.yaml):
  t : embed 96,  stages (1,2,7,2),  global_att (5,7,9)
  s : embed 96,  stages (1,2,11,2), global_att (7,10,13)
  b+: embed 112, heads 2, stages (2,3,16,3), global_att (12,16,20), bkg 14x14
  l : embed 144, heads 2, stages (2,6,36,4), global_att (23,33,43),
      window_spec (8,4,16,8)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 96
    num_heads: int = 1
    stages: tuple[int, ...] = (2, 3, 16, 3)
    global_att_blocks: tuple[int, ...] = (12, 16, 20)
    window_pos_embed_bkg_spatial_size: tuple[int, int] = (14, 14)
    window_spec: tuple[int, ...] = (8, 4, 14, 7)
    q_pool: int = 3
    q_stride: tuple[int, int] = (2, 2)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> tuple[int, ...]:
        ends, acc = [], 0
        for s in self.stages:
            acc += s
            ends.append(acc - 1)
        return tuple(ends)

    @property
    def q_pool_blocks(self) -> tuple[int, ...]:
        return tuple(e + 1 for e in self.stage_ends[:-1])[: self.q_pool]

    @property
    def channel_list(self) -> tuple[int, ...]:
        """Per-stage output channels, stage order (embed_dim first)."""
        return tuple(int(self.embed_dim * self.dim_mul**i)
                     for i in range(len(self.stages)))


@dataclasses.dataclass(frozen=True)
class SAM2UNetConfig:
    """Frozen adapter-wrapped trunk + RFB neck + decoder
    (SAM2UNet.py:128-173)."""

    trunk: HieraConfig = HieraConfig()
    adapter_dim: int = 32
    rfb_out: int = 64


HIERA_T = HieraConfig(stages=(1, 2, 7, 2), global_att_blocks=(5, 7, 9),
                      window_pos_embed_bkg_spatial_size=(7, 7))
HIERA_S = HieraConfig(stages=(1, 2, 11, 2), global_att_blocks=(7, 10, 13),
                      window_pos_embed_bkg_spatial_size=(7, 7))
HIERA_BPLUS = HieraConfig(embed_dim=112, num_heads=2)
HIERA_L = HieraConfig(embed_dim=144, num_heads=2, stages=(2, 6, 36, 4),
                      global_att_blocks=(23, 33, 43), window_spec=(8, 4, 16, 8))

# minimal trunk for integration tests / smoke runs
HIERA_TEST = HieraConfig(embed_dim=8, stages=(1, 1, 1, 1), global_att_blocks=(2,),
                         window_spec=(4, 2, 2, 2),
                         window_pos_embed_bkg_spatial_size=(7, 7))

registry: dict[str, HieraConfig] = {
    "sam2_hiera_t": HIERA_T,
    "sam2_hiera_s": HIERA_S,
    "sam2_hiera_b+": HIERA_BPLUS,
    "sam2_hiera_l": HIERA_L,
    "hiera_test": HIERA_TEST,
}


def hiera_config(name: str) -> HieraConfig:
    key = name.removesuffix(".yaml")
    if key not in registry:
        raise KeyError(f"unknown hiera config '{name}' (have {sorted(registry)})")
    return registry[key]
