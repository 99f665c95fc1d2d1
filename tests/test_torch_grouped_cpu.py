"""The persistent valid-window-group layout of the port's trunk
(`sam2unet_torch/ops/grouped.py`, the grouped route of
`sam2unet_torch/models/hiera.py`) against the JAX package's, on the CPU.

  - `GroupedTokens`: the same groups, pad counts and token order as the JAX
    package's on the same numpy input; `to_dense` and `split_tokens` invert
    exactly.
  - The remainder-strip gate: the port's `strips_rem_supported` equals the
    JAX function over a sweep of grids, windows, widths, both dtypes and
    both directions.
  - Launch spies on both packages: per forward (and in training per step:
    each forward call is one autograd node whose backward runs once) the
    calls of `fused_mlp` split into tails (with LN) and adapters, of
    `fused_window_block` by (S, n_pad), and of the strip, remainder-strip and
    transition kernels, at full depth and narrow width, with the layout on
    and off (SAM2UNET_DISABLE_GROUPED). The JAX side is traced by
    `jax.eval_shape` with its kernels replaced by spies and its dispatch as
    on the TPU (`xla_only` False: on the CPU the JAX `_groupable_block`
    skips its remainder-strip test), so nothing compiles; the port's
    wrappers are replaced by stubs of the right shape.
  - Numerics: hiera_t's windows at 288 px (grids 72/36/18/9, so stages 3
    and 4 lie on remainder grids and run grouped in eval and in training;
    depth cut to 8 blocks), the trunk's outputs and the adapters' gradients
    of one backward in training against the JAX package in fp32 at 2e-5 of
    the largest magnitude, with and without remat.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sam2unet_torch.models.hiera as port_hiera
import sam2unet_tpu.models.hiera as jax_hiera
import sam2unet_tpu.ops.pallas.dispatch as jax_dispatch
import sam2unet_tpu.ops.pallas.fused_attention_block as jax_fab
import sam2unet_tpu.ops.pallas.fused_mlp as jax_mlp
import sam2unet_tpu.ops.pallas.fused_transition as jax_tra
from sam2unet_torch.configs import HieraConfig as PortHieraConfig
from sam2unet_torch.interop.from_jax import jax_to_state_dict
from sam2unet_torch.ops.fused_attention_block import strips_rem_supported
from sam2unet_torch.ops.grouped import GroupedTokens
from sam2unet_tpu.configs import HIERA_L, HIERA_S, HIERA_T, HieraConfig
from sam2unet_tpu.ops.grouped import GroupedTokens as JaxGroupedTokens

# ------------------------------------------------------------ the layout


@pytest.mark.parametrize("b,h,w,window", [(2, 22, 22, 16), (1, 60, 60, 14),
                                          (2, 11, 11, 8), (1, 18, 30, 14),
                                          (2, 14, 14, 7), (1, 9, 9, 7)])
def test_grouped_tokens_match_the_jax_layout(b, h, w, window):
    x = np.random.default_rng(h * w + window).standard_normal(
        (b, h, w, 8)).astype(np.float32)
    got = GroupedTokens.from_dense(torch.from_numpy(x), window)
    want = JaxGroupedTokens.from_dense(jnp.asarray(x), window)
    assert (got.n_pads, got.geoms) == (want.n_pads, want.geoms)
    assert got.shape == want.shape == (b, h, w, 8)
    for g, wg in zip(got.groups, want.groups, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wg))
    np.testing.assert_array_equal(got.to_dense().numpy(), x)
    tokens = got.concat_tokens()
    np.testing.assert_array_equal(tokens.numpy(),
                                  np.asarray(want.concat_tokens()))
    back = got.split_tokens(tokens)
    for g, g0 in zip(back.groups, got.groups, strict=True):
        assert torch.equal(g, g0)
        assert g.is_contiguous() and g0.is_contiguous()  # as kernels take them
    np.testing.assert_array_equal(back.to_dense().numpy(), x)


# --------------------------------------------------------------- the gate

GRIDS = (9, 11, 16, 18, 22, 30, 32, 36, 60, 64, 72, 100, 128, 256)
WINDOWS = (4, 7, 8, 14, 16)
WIDTHS = ((96, 1), (144, 2), (192, 2), (288, 4), (384, 4), (576, 8),
          (768, 8), (1152, 16), (112, 2), (896, 16))


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("bwd", [False, True])
def test_rem_strip_gate_equals_the_jax_gate(itemsize, bwd):
    got, want = [], []
    for hh in GRIDS:
        for wd in (hh, hh + 5):
            for win in WINDOWS:
                for c, nh in WIDTHS:
                    args = (hh, wd, win, c, nh, itemsize, bwd)
                    got.append(strips_rem_supported(*args))
                    want.append(jax_fab.strips_rem_supported(*args))
    assert got == want
    assert any(want) and not all(want)


def test_the_gate_refuses_the_64x64_grid_in_fp32_only():
    """The estimate's one visible effect at the shipped points: in bf16
    sam2_hiera_s@1024's 64x64 w14 grid takes the remainder strips, in fp32
    the valid groups (as in the JAX package); its 32x32 w7 grid takes them
    in both."""
    assert strips_rem_supported(64, 64, 14, 384, 4, 2)
    assert not strips_rem_supported(64, 64, 14, 384, 4, 4)
    assert strips_rem_supported(32, 32, 7, 768, 8, 2)
    assert strips_rem_supported(32, 32, 7, 768, 8, 4)


# ------------------------------------------------------------ launch spies

# (trunk, size, train, K1 tails per forward with the layout on): hiera_l at
# 352 (stage 3: 22x22 w16, 4 groups x 35 blocks; stage 4: 11x11 w8, 4 x 3),
# hiera_s at 960 in training (stage 3's 10 blocks x 4 groups, block 15 x 4)
# and hiera_t at 512 (the t512video trunk, no adapters)
SPY_POINTS = {
    "hiera_l@352": (HIERA_L, 352, False, 162, True),
    "hiera_l@352 train": (HIERA_L, 352, True, 162, True),
    "hiera_s@960 train": (HIERA_S, 960, True, 49, True),
    "hiera_t@512": (HIERA_T, 512, False, 33, False),
}
NARROW = 16


def _narrow(cfg):
    return dict(dataclasses.asdict(cfg), embed_dim=NARROW)


def _jax_counts(cfg: HieraConfig, size: int, train: bool, adapters: bool,
                monkeypatch) -> collections.Counter:
    counts = collections.Counter()

    def mlp(x, *a, ln_scale=None, **k):
        counts["K1 tail" if ln_scale is not None else "K1 adapter"] += 1
        return x

    def window_block(x, *a, n_pad=0, **k):
        counts[("K6", x.shape[1], n_pad)] += 1
        return x

    def strips(x, *a, window, **k):
        h, w = x.shape[1], x.shape[2]
        rem = h % window or w % window or (window * window) % 16
        counts["K12" if rem else "K4"] += 1
        return x

    def transition(x, *a, window, **k):
        counts["K8"] += 1
        b, h, w, _ = x.shape
        return jnp.zeros((b, h // 2, w // 2, a[4].shape[-1]), x.dtype)

    def plain_attention(q, k, v, **kw):
        counts["plain attention"] += 1
        return jnp.zeros_like(q)

    monkeypatch.setattr(jax_dispatch, "xla_only", lambda: False)
    monkeypatch.setattr(jax_mlp, "fused_mlp", mlp)
    monkeypatch.setattr(jax_fab, "fused_window_block", window_block)
    monkeypatch.setattr(jax_fab, "fused_window_block_strips", strips)
    monkeypatch.setattr(jax_tra, "fused_transition_block", transition)
    monkeypatch.setattr(jax_hiera, "sdpa", plain_attention)
    model = jax_hiera.Hiera(HieraConfig(**_narrow(cfg)),
                            use_adapters=adapters, dtype=jnp.bfloat16)
    jax.eval_shape(functools.partial(model.init, train=train),
                   jax.random.PRNGKey(0),
                   jax.ShapeDtypeStruct((1, size, size, 3), jnp.bfloat16))
    return counts


def _port_counts(cfg: HieraConfig, size: int, train: bool, adapters: bool,
                 monkeypatch) -> collections.Counter:
    counts = collections.Counter()

    def mlp(x, *a, ln_w=None, **k):
        counts["K1 tail" if ln_w is not None else "K1 adapter"] += 1
        return x

    def window_block(x, *a, n_pad=0, **k):
        counts[("K6", x.shape[1], n_pad)] += 1
        return x

    def named(name):
        def call(x, *a, **k):
            counts[name] += 1
            return x
        return call

    def transition(x, *a, **k):
        counts["K8"] += 1
        b, h, w, _ = x.shape
        return x.new_zeros(b, h // 2, w // 2, a[6].shape[0])

    def unfused(blk, x):
        counts["plain attention"] += 1
        b, h, w, _ = x.shape
        return x.new_zeros(b, -(-h // 2), -(-w // 2), blk.dim_out)

    for attr, fn in (("fused_mlp", mlp), ("fused_window_block", window_block),
                     ("fused_window_block_strips", named("K4")),
                     ("fused_window_block_strips_rem", named("K12")),
                     ("fused_transition_block", transition)):
        monkeypatch.setattr(port_hiera, attr, fn)
    monkeypatch.setattr(port_hiera.MultiScaleBlock, "_unfused", unfused)
    fields = {f.name for f in dataclasses.fields(PortHieraConfig)}
    trunk = {k: v for k, v in _narrow(cfg).items() if k in fields}
    model = port_hiera.Hiera(PortHieraConfig(**trunk),
                             use_adapters=adapters).to(torch.bfloat16)
    model.train(train)
    with torch.no_grad():
        model(torch.zeros(1, size, size, 3, dtype=torch.bfloat16))
    return counts


@pytest.mark.parametrize("grouping", [True, False], ids=["grouped", "per-block"])
@pytest.mark.parametrize("point", sorted(SPY_POINTS))
def test_launches_equal_the_jax_package(point, grouping, monkeypatch):
    cfg, size, train, tails, adapters = SPY_POINTS[point]
    if not grouping:
        monkeypatch.setenv("SAM2UNET_DISABLE_GROUPED", "1")
    with monkeypatch.context() as mp:
        want = _jax_counts(cfg, size, train, adapters, mp)
    with monkeypatch.context() as mp:
        got = _port_counts(cfg, size, train, adapters, mp)
    assert got == want
    if grouping:
        assert want["K1 tail"] == tails
    else:
        assert want["K1 tail"] == cfg.depth
    assert want["K1 adapter"] == (want["K1 tail"] if adapters else 0)


def test_the_layout_keeps_the_kernel_launches_of_the_window_blocks(monkeypatch):
    """The K6 launches (by S and n_pad) at hiera_l@352 are the same with and
    without the layout, 143 per forward: only K1 moves, 96 -> 324."""
    counts = {}
    for grouping in (True, False):
        with monkeypatch.context() as mp:
            if not grouping:
                mp.setenv("SAM2UNET_DISABLE_GROUPED", "1")
            counts[grouping] = _port_counts(HIERA_L, 352, False, True, mp)
    k6 = {k: v for k, v in counts[True].items() if k[0] == "K6"}
    assert k6 == {k: v for k, v in counts[False].items() if k[0] == "K6"}
    assert sum(k6.values()) == 143
    assert counts[True]["K1 tail"] + counts[True]["K1 adapter"] == 324
    assert counts[False]["K1 tail"] + counts[False]["K1 adapter"] == 96


# ---------------------------------------------------------------- numerics

# hiera_t's windows, depth cut to 8 blocks: stage 3 holds a grouped run of
# a windowed, a global and a windowed block (18x18 w14), stage 4 one
# windowed block (9x9 w7), each after a plain-path transition
T288 = dict(embed_dim=16, num_heads=1, stages=(1, 1, 4, 2),
            global_att_blocks=(4,), window_spec=(8, 4, 14, 7),
            window_pos_embed_bkg_spatial_size=(7, 7))
SIZE, BATCH = 288, 2
REL_TOL = 2e-5


def _seeded(shapes, rng):
    """Seeded parameters for the JAX variable shapes: LN gains about 1,
    biases and position embeddings about 0.1, kernels of unit fan-in
    variance."""
    def leaf(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * n
        if name == "kernel":
            return n / np.sqrt(np.prod(s.shape[:-1]))
        return 0.1 * n
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def t288():
    """Parameters, input, cotangents, and the JAX trunk's outputs and
    gradients of sum(outputs * cotangents) in training."""
    model = jax_hiera.Hiera(HieraConfig(**T288), use_adapters=True)
    x = np.random.default_rng(5).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), x)["params"]
    params = _seeded(shapes, np.random.default_rng(6))
    cot = [np.random.default_rng(7 + i).standard_normal(
        (BATCH, SIZE // 4 >> i, SIZE // 4 >> i, 16 << i)).astype(np.float32)
        for i in range(4)]

    def loss(p):
        outs = model.apply({"params": p}, x, train=True)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    (_, outs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return params, x, cot, [np.asarray(o) for o in outs], grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_trunk_at_288_matches_jax_with_the_layout(t288, remat):
    """Remat recomputes the same arithmetic: the port with and without it
    against the JAX trunk's one result."""
    params, x, cot, want, jgrads = t288
    port = port_hiera.Hiera(PortHieraConfig(**T288), use_adapters=True,
                            remat=remat).train()
    port.load_state_dict(jax_to_state_dict({"params": params},
                                           port.state_dict().keys()),
                         strict=True)
    outs = port(torch.from_numpy(x))
    for o, w in zip(outs, want, strict=True):
        scale = float(np.abs(w).max())
        assert float(np.abs(o.detach().numpy() - w).max()) <= REL_TOL * scale
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cot)).backward()
    want_grads = jax_to_state_dict({"params": jgrads},
                                   port.state_dict().keys())
    trainable = [(n, p) for n, p in port.named_parameters() if p.requires_grad]
    assert len(trainable) == 4 * 8
    for name, p in trainable:
        w = want_grads[name].numpy()
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= REL_TOL * scale, (name, err, scale)

